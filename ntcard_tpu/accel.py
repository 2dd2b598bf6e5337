"""Jax-free facts about the machine a run targets, read before jax loads.

The CLIs decide between the jax-free host engine and the device path, and
the daemon decides whether a client may open the card itself, before
importing jax (the import alone costs seconds). Both need to know whether
this run targets a GPU, and every compiled artefact needs one place to live.
"""

from __future__ import annotations

import glob
import os


def _nvidia_device_visible() -> bool:
    """True when the NVIDIA driver exposes at least one card to this
    process (its character devices, /dev/nvidia0, /dev/nvidia1, ...)."""
    return bool(glob.glob("/dev/nvidia[0-9]*"))


def accelerator_requested() -> bool:
    """Does this run target a GPU?

    True when JAX_PLATFORMS names ``cuda`` or ``gpu``; False when it names
    only other platforms (``cpu`` in the tests); with the variable unset,
    True exactly when an NVIDIA card is visible — JAX then picks the GPU by
    default, so the CLI must take the same path as with JAX_PLATFORMS=cuda.
    """
    plats = os.environ.get("JAX_PLATFORMS", "").strip().lower()
    if plats:
        return any(p.strip() in ("cuda", "gpu") for p in plats.split(","))
    return _nvidia_device_visible()


def cache_root() -> str:
    """Root of every compiled artefact of this package: JAX's persistent
    compilation cache, the AOT executable store (``ntcard_aot``) and the
    native host library (``ntcard_native``).

    JAX_COMPILATION_CACHE_DIR when set; otherwise the fixed directory
    ``.jax_cache`` beside the package (the checkout root, git-ignored). The
    path is part of the cache key, so it must not move between runs.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(checkout, ".jax_cache")
