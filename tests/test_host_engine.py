"""Host-engine parity: the native C host sketch engine (packer.cpp
ntcard_host_update / ntcard_host_hll_update, models/host_engine.py) must be
bit-identical to the device path — it consumes the same packed batches, so
tables, F1, histograms, registers and CLI outputs all byte-match."""

import random
from pathlib import Path

import numpy as np
import pytest

from ntcard_tpu import cli, cli_hll
from ntcard_tpu.io.packing import aligned_stride, pack_records
from ntcard_tpu.models.host_engine import (
    HostCountTableSketch,
    HostHllSketch,
    host_engine_available,
)

pytestmark = pytest.mark.skipif(
    not host_engine_available(), reason="native toolchain unavailable"
)

DATA = Path(__file__).parent / "data"
GOLD = Path(__file__).parent / "golden"


def _reads(n=400, seed=11):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        m = rng.randint(1, 300)
        out.append("".join(rng.choice("ACGTNacgtu") for _ in range(m)).encode())
    return out


def test_host_vs_device_tables_multi_k():
    from ntcard_tpu.models.sketch import CountTableSketch

    ks = (12, 31, 64)
    chunk_len, rows = 256, 128
    stride = aligned_stride(chunk_len, max(ks))
    dev = CountTableSketch(ks, 7, 12, stride)
    host = HostCountTableSketch(ks, 7, 12, stride)
    for b in pack_records(_reads(), chunk_len, rows, max(ks)):
        dev.update(b)
        host.update(b)
    sd = dev.finalize(return_table=True, cov_max=64)
    sh = host.finalize(return_table=True, cov_max=64)
    for k in ks:
        assert sd[k]["f1"] == sh[k]["f1"]
        assert np.array_equal(sd[k]["hist"], sh[k]["hist"])
        assert np.array_equal(sd[k]["table"], sh[k]["table"])


def test_host_vs_device_gap_seed():
    from ntcard_tpu.models.sketch import CountTableSketch

    k, g = 13, 3
    half = (k - g) // 2
    gaps = tuple(range(half, half + g))
    chunk_len, rows = 256, 128
    stride = aligned_stride(chunk_len, k)
    dev = CountTableSketch((k,), 7, 12, stride, gap_positions=gaps)
    host = HostCountTableSketch((k,), 7, 12, stride, gap_positions=gaps)
    for b in pack_records(_reads(seed=12), chunk_len, rows, k):
        dev.update(b)
        host.update(b)
    sd = dev.finalize(return_table=True, cov_max=64)
    sh = host.finalize(return_table=True, cov_max=64)
    assert sd[k]["f1"] == sh[k]["f1"]
    assert np.array_equal(sd[k]["table"], sh[k]["table"])


def test_host_vs_device_hll():
    from ntcard_tpu.models.hll import HllSketch

    k = 25
    chunk_len, rows = 256, 128
    stride = aligned_stride(chunk_len, k)
    dev = HllSketch(k, 16, stride)
    host = HostHllSketch(k, 16, stride)
    for b in pack_records(_reads(seed=13), chunk_len, rows, k):
        dev.update(b)
        host.update(b)
    assert np.array_equal(dev.registers(), host.registers())


def test_host_cli_goldens(tmp_path, monkeypatch):
    monkeypatch.setenv("NTCARD_ENGINE", "host")
    rc = cli.main(
        ["-k12", "-c1000", "-r16", "-p", str(tmp_path / "t"), str(DATA / "reads.fq")]
    )
    assert rc == 0
    assert (tmp_path / "t_k12.hist").read_bytes() == (
        GOLD / "reads_k12.hist.good"
    ).read_bytes()
    rc = cli.main(
        ["-k12", "-g2", "-c1000", "-r16", "-p", str(tmp_path / "g"), str(DATA / "reads.fq")]
    )
    assert rc == 0
    assert (tmp_path / "g_k12.hist").read_bytes() == (
        GOLD / "reads-gap_k12.hist.good"
    ).read_bytes()


def test_host_cli_nthll_golden(capsys, monkeypatch):
    monkeypatch.setenv("NTCARD_ENGINE", "host")
    rc = cli_hll.main(["-k25", str(DATA / "reads.fq")])
    assert rc == 0
    assert capsys.readouterr().out == (GOLD / "nthll_k25.out.good").read_text()


def test_auto_stays_on_device_for_cpu_platform(monkeypatch):
    """On the CPU platform (this test env) auto must NOT pick the host
    engine — the XLA path is already host execution and is what the rest of
    the suite covers."""
    monkeypatch.setenv("NTCARD_ENGINE", "auto")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    opt, _ = cli.parse_args(["-k12", "-p", "x", "f.fq"])
    assert not cli._use_host_engine(opt, 1000)


def test_auto_picks_host_for_small_inputs_on_accelerator(monkeypatch):
    monkeypatch.setenv("NTCARD_ENGINE", "auto")
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    opt, _ = cli.parse_args(["-k12", "-r16", "-p", "x", "f.fq"])
    assert cli._use_host_engine(opt, 1000)
    # large input at small r -> device
    assert not cli._use_host_engine(opt, 1 << 40)
    # big tables (default rBits=27): device since round 3 (the per-k-table
    # sparse update beats the reference at the default config); the round-2
    # host routing survives behind NTCARD_HOST_MIN_RBITS
    opt27, _ = cli.parse_args(["-k12", "-p", "x", "f.fq"])
    assert opt27.r_bits == 27
    assert not cli._use_host_engine(opt27, 1 << 40)
    monkeypatch.setenv("NTCARD_HOST_MIN_RBITS", "20")
    assert cli._use_host_engine(opt27, 1 << 40)
    monkeypatch.delenv("NTCARD_HOST_MIN_RBITS")
    # explicit multi-host -> device
    opt.coordinator = "host:1234"
    assert not cli._use_host_engine(opt, 1000)
    opt27.coordinator = "host:1234"
    assert not cli._use_host_engine(opt27, 1000)


def test_host_sketch_checkpoint_merges_with_device(tmp_path):
    """A host-engine partial sketch saved to disk must merge with a
    device-path partial sketch (tools/merge_sketches workflow) — summing
    uint16-wrapped counts mod 2^16 equals the reference's shared-table
    semantics."""
    from ntcard_tpu.models.sketch import CountTableSketch

    ks = (12,)
    chunk_len, rows = 256, 128
    stride = aligned_stride(chunk_len, 12)
    reads = _reads(seed=14)
    half = len(reads) // 2

    full = CountTableSketch(ks, 7, 10, stride)
    for b in pack_records(reads, chunk_len, rows, 12):
        full.update(b)

    dev = CountTableSketch(ks, 7, 10, stride)
    for b in pack_records(reads[:half], chunk_len, rows, 12):
        dev.update(b)
    host = HostCountTableSketch(ks, 7, 10, stride)
    for b in pack_records(reads[half:], chunk_len, rows, 12):
        host.update(b)
    host.save(str(tmp_path / "h.npz"))
    dev.merge_(CountTableSketch.load(str(tmp_path / "h.npz")))

    sf = full.finalize(return_table=True, cov_max=64)
    sm = dev.finalize(return_table=True, cov_max=64)
    assert sf[12]["f1"] == sm[12]["f1"]
    assert np.array_equal(sf[12]["table"], sm[12]["table"])


@pytest.mark.parametrize("rows", [1, 5, 8, 9, 23])
def test_host_vs_device_odd_row_counts(rows):
    """Row counts around the 8-lane block size exercise the vector path's
    remainder handoff (AVX-512 blocks + scalar tail) and per-thread row
    splits; results must stay bit-identical to the device path."""
    from ntcard_tpu.models.sketch import CountTableSketch

    ks = (12, 61)
    chunk_len = 128
    stride = aligned_stride(chunk_len, max(ks))
    rng = np.random.default_rng(rows)
    codes = rng.choice(
        np.arange(5, dtype=np.uint8), size=(rows, chunk_len), p=[0.23] * 4 + [0.08]
    )
    dev = CountTableSketch(ks, 7, 10, stride)
    dev.update(codes)
    sd = dev.finalize(return_table=True, cov_max=64)
    for nt in (1, 4):
        host = HostCountTableSketch(ks, 7, 10, stride, n_threads=nt)
        host.update(codes)
        sh = host.finalize(return_table=True, cov_max=64)
        for k in ks:
            assert sd[k]["f1"] == sh[k]["f1"], (rows, nt, k)
            assert np.array_equal(sd[k]["table"], sh[k]["table"]), (rows, nt, k)


@pytest.mark.parametrize("rows", [3, 9, 16])
def test_host_vs_device_hll_odd_row_counts(rows):
    from ntcard_tpu.models.hll import HllSketch

    k = 25
    chunk_len = 128
    stride = aligned_stride(chunk_len, k)
    rng = np.random.default_rng(100 + rows)
    codes = rng.choice(
        np.arange(5, dtype=np.uint8), size=(rows, chunk_len), p=[0.23] * 4 + [0.08]
    )
    dev = HllSketch(k, 16, stride)
    dev.update(codes)
    for nt in (1, 4):
        host = HostHllSketch(k, 16, stride, n_threads=nt)
        host.update(codes)
        assert np.array_equal(dev.registers(), host.registers()), (rows, nt)
