"""nthll's HyperLogLog F0 estimator as a device-resident model.

Reference: nthll.cpp:92-97 (register update), :218-245 (thread-private
sketches merged by elementwise max under a critical section), :247-254
(harmonic-mean estimate, no small/large-range corrections).

On the device the registers are a [2^nBits] int32 array updated by scatter-max
(the fused hash+clz kernel ops/nthash.hll_scan feeds it); max commutes, so
any batching/sharding is bit-exact, and the multi-shard merge is
``jax.lax.pmax`` / elementwise max — the collective lift of the reference's
critical-section merge.
"""

from __future__ import annotations

from functools import partial

from ntcard_tpu import _jax_config  # noqa: F401  (platform/cache config before backend init)
import jax
import jax.numpy as jnp
import numpy as np

from ntcard_tpu.ops.nthash import hll_scan
from ntcard_tpu.utils.aot import aot_jit, check_trace_verifications


@partial(aot_jit, static_argnames=("k", "stride", "n_bits", "packed"), donate_argnums=(0,))
def _update(regs, codes, k, stride, n_bits, packed=False):
    reg_idx, run0 = hll_scan(codes, k, stride, n_bits, packed=packed)
    return regs.at[reg_idx].max(run0)


class HllSketch:
    def __init__(self, k: int, n_bits: int, stride: int):
        if stride % 8 or stride < 8:
            raise ValueError(
                f"stride ({stride}) must be a positive multiple of 8 — use "
                "io.packing.aligned_stride(chunk_len, kmax) so the sketch and "
                "packer agree on window ownership"
            )
        self.k = k
        self.n_bits = n_bits
        self.n_buck = 1 << n_bits
        self.stride = stride
        self.regs = jnp.zeros((self.n_buck,), jnp.int32)

    def update(self, codes: np.ndarray, packed: bool = False) -> None:
        self.regs = _update(self.regs, codes, self.k, self.stride, self.n_bits, packed)

    def registers(self) -> np.ndarray:
        # fast-key AOT loads (utils/aot.py) must verify before results
        # leave the process — this is the HLL path's exposure point
        check_trace_verifications()
        return np.asarray(self.regs).astype(np.uint8)


# estimate_f0 lives in models/estimate.py (jax-free) so the host-engine
# nthll path never imports jax; re-exported here for compatibility.
from ntcard_tpu.models.estimate import estimate_f0  # noqa: F401,E402
