"""Test configuration: force the JAX CPU backend with 8 virtual devices so
sharding/collective tests run anywhere (the GPU path is exercised by
chip_smoke.py on the card, and by tests marked ``gpu``, which skip here).
The environment may pre-set JAX_PLATFORMS — override it unconditionally."""

import os

import pytest

# NTCARD_TEST_GPU=1 leaves the platform to JAX so tests marked ``gpu`` can
# run on the card (python -m pytest -m gpu tests/); everything else forces
# the CPU backend
_ON_CARD = os.environ.get("NTCARD_TEST_GPU") == "1"
if not _ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"

# The CLIs now use an already-serving warm-pool daemon by DEFAULT
# (daemon.py probe mode). Tests must never route through a stray daemon on
# the machine's default socket path; the daemon tests opt back in with
# explicit NTCARD_DAEMON=1 + a private NTCARD_DAEMON_SOCK.
os.environ.setdefault("NTCARD_DAEMON", "0")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not _ON_CARD:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked ``gpu``; decided here, at run time,
    never at import (workers must collect identical test lists)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX backend is {dev.platform}); run with NTCARD_TEST_GPU=1 on the card")
    return dev
