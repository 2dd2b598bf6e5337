"""ntcard-tpu: a JAX k-mer cardinality estimation framework for NVIDIA GPUs.

Capability parity with bcgsc/ntCard v1.2.2 (ntcard + nthll), redesigned for
an accelerator: batched rolling-hash kernels over a packed base stream, pure
functional sketch state merged with collectives, and a host C++/Python I/O
layer. See SURVEY.md for the full blueprint.
"""

# The package root is deliberately jax-FREE: the host-engine CLI paths never
# import jax (its import alone costs seconds of pure-Python time — material
# next to a sub-second host run). Every module that imports jax imports
# ntcard_tpu._jax_config first, which applies the compile-cache config
# before any backend init.

__version__ = "1.0.0"
