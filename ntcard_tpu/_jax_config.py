"""Process-level JAX configuration, applied on first import — before any
backend init.

Every module that imports ``jax`` imports this module first. The package
``__init__`` deliberately does NOT: the host-engine paths (cli's
NTCARD_ENGINE=host/auto small-input route, cli_hll's host route) never touch
jax, and importing it costs seconds of pure-Python time — material next to a
sub-second host run.
"""

from __future__ import annotations

import os

import jax

from ntcard_tpu.accel import accelerator_requested, cache_root

# Global x64 mode stays OFF. The device kernels carry every 64-bit hash as a
# (hi, lo) uint32 pair (utils/u64.py) whose arithmetic must wrap mod 2^32;
# x64 makes jnp's default integer 64 bits wide, so default-typed
# intermediates (iotas, untyped sums, scalar promotion) would stop wrapping
# where the emulation needs them to. Exact F1 totals accumulate as (hi, lo)
# uint32 pairs on device and become Python ints on the host
# (models/sketch.py).

# Persistent compilation cache: the CLI is a short-lived batch tool, so cold
# jit compiles would otherwise dominate small runs. JAX reads
# JAX_COMPILATION_CACHE_DIR itself; only when it is unset does the package
# pick its fixed path (accel.cache_root).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", cache_root())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def check_backend() -> None:
    """No hidden CPU fallback: a run that targets a GPU
    (accel.accelerator_requested) must find one, or it stops with a
    message instead of silently running the device path on the CPU."""
    if not accelerator_requested():
        return
    plat = jax.devices()[0].platform
    if plat != "gpu":
        raise SystemExit(
            f"ntcard: this run targets a GPU (JAX_PLATFORMS="
            f"{os.environ.get('JAX_PLATFORMS', '<unset>')!r}, NVIDIA device "
            f"files present) but JAX's default backend is {plat!r}; install "
            "JAX's CUDA plugin or set JAX_PLATFORMS=cpu"
        )
