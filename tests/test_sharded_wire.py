"""Sharded per-shard wire packing + superbatch stacks (round 3, VERDICT #2):
the N-device sketch must consume quad/quad2 wires packed PER SHARD
(io/packing.pack_shard_wires) and [D, n, rows, width] superbatch stacks, and
stay bit-identical to the single-device run — every single-chip optimization
now rides inside shard_map (parallel/data_parallel._sketch_update_sharded).
"""

import numpy as np
import pytest

from ntcard_tpu.io.packing import (
    aligned_stride,
    pack_records,
    pack_shard_wires,
    quad2_ok,
    wire_mode_of,
)
from ntcard_tpu.models.sketch import CountTableSketch
from ntcard_tpu.parallel.data_parallel import ShardedCountTableSketch
from tests.test_kernel_vs_oracle import random_records

CHUNK, KMAX = 160, 32
STRIDE = aligned_stride(CHUNK, KMAX)  # 128: quad2-admissible per shard
ROWS = 2048  # per batch; 256 per shard on the 8-device mesh


@pytest.fixture(scope="module")
def records():
    return random_records(seed=21, n=500, maxlen=300)


def _single_ref(records, ks):
    ref = CountTableSketch(ks, 7, 12, STRIDE)
    for b in pack_records(records, CHUNK, ROWS, KMAX):
        ref.update(b)
    return ref.finalize(return_table=True)


@pytest.mark.parametrize("wire", ["quad2", "quad", "nibble"])
def test_shard_wires_bitexact(records, wire):
    ks = (12, 32)
    want = _single_ref(records, ks)
    sh = ShardedCountTableSketch(ks, 7, 12, STRIDE)
    rows_ps = ROWS // sh.n_dev
    if wire == "quad2":
        assert quad2_ok(rows_ps, STRIDE)
    halo = CHUNK - STRIDE
    for b in pack_records(records, CHUNK, ROWS, KMAX):
        shards = pack_shard_wires(b, sh.n_dev, wire if wire != "nibble" else True, STRIDE)
        mode = wire_mode_of(shards[0], rows_ps, halo)
        sh.update_shards(shards, packed=mode)
    got = sh.finalize(return_table=True)
    for k in ks:
        assert got[k]["f1"] == want[k]["f1"]
        np.testing.assert_array_equal(got[k]["table"], want[k]["table"])


def test_shard_superbatch_stack_bitexact(records):
    """[D, n, rows, width] stacks (pipeline.superbatch axis=1) fold with the
    per-shard on-device scan, bit-identical to unstacked updates."""
    ks = (12,)
    want = _single_ref(records, ks)
    sh = ShardedCountTableSketch(ks, 7, 12, STRIDE)
    rows_ps = ROWS // sh.n_dev
    halo = CHUNK - STRIDE
    wires = [
        pack_shard_wires(b, sh.n_dev, "quad2", STRIDE)
        for b in pack_records(records, CHUNK, ROWS, KMAX)
    ]
    mode = wire_mode_of(wires[0][0], rows_ps, halo)
    i = 0
    while i < len(wires):
        group = [w for w in wires[i : i + 2] if w.shape == wires[i].shape]
        if len(group) == 2:
            sh.update_shards(np.stack(group, axis=1), packed=mode)
        else:
            sh.update_shards(wires[i], packed=wire_mode_of(wires[i][0], rows_ps, halo))
        i += len(group)
    got = sh.finalize(return_table=True)
    assert got[12]["f1"] == want[12]["f1"]
    np.testing.assert_array_equal(got[12]["table"], want[12]["table"])


def test_pack_shard_wires_homogenizes_on_overflow():
    """If any shard's quad pack overflows its sidecar, the WHOLE batch must
    fall back to per-shard nibble (a [D, ...] stack needs one jit
    signature)."""
    rng = np.random.default_rng(3)
    B, L = 256, CHUNK
    batch = rng.integers(0, 4, (B, L), dtype=np.uint8).astype(np.uint8)
    # make shard 1's slice N-dense enough to overflow the quad sidecar
    batch[128:, :] = 4
    shards = pack_shard_wires(batch, 2, "quad", STRIDE)
    assert shards.shape == (2, 64, L)  # nibble rows = 128/2


def test_chains_engine_bitexact(records, monkeypatch):
    """The per-device-chains multi-device engine (NTCARD_SHARDED=chains,
    the default on GPUs) must be bit-identical to both the
    single-device run and the shard_map engine, through per-shard quad2
    wires and superbatch stacks."""
    from ntcard_tpu.parallel.data_parallel import PerDeviceCountTableSketch

    ks = (12, 32)
    want = _single_ref(records, ks)
    pd = PerDeviceCountTableSketch(ks, 7, 12, STRIDE)
    rows_ps = ROWS // pd.n_dev
    halo = CHUNK - STRIDE
    wires = [
        pack_shard_wires(b, pd.n_dev, "quad2", STRIDE)
        for b in pack_records(records, CHUNK, ROWS, KMAX)
    ]
    i = 0
    while i < len(wires):
        grp = [w for w in wires[i : i + 2] if w.shape == wires[i].shape]
        stack = np.stack(grp, axis=1) if len(grp) == 2 else wires[i]
        mode = wire_mode_of(wires[i][0], rows_ps, halo)
        pd.update_shards(stack, packed=mode)
        i += len(grp)
    got = pd.finalize(return_table=True)
    for k in ks:
        assert got[k]["f1"] == want[k]["f1"]
        np.testing.assert_array_equal(got[k]["table"], want[k]["table"])


def test_chains_hll_bitexact(records):
    from ntcard_tpu.models.hll import HllSketch
    from ntcard_tpu.parallel.data_parallel import PerDeviceHllSketch

    ref = HllSketch(25, 10, STRIDE)
    for b in pack_records(records, CHUNK, ROWS, KMAX):
        ref.update(b)
    pd = PerDeviceHllSketch(25, 10, STRIDE)
    rows_ps = ROWS // pd.n_dev
    halo = CHUNK - STRIDE
    for b in pack_records(records, CHUNK, ROWS, KMAX):
        shards = pack_shard_wires(b, pd.n_dev, "quad2", STRIDE)
        pd.update_shards(shards, packed=wire_mode_of(shards[0], rows_ps, halo))
    np.testing.assert_array_equal(pd.registers(), ref.registers())


def test_sharded_hll_wire_bitexact(records):
    """ShardedHllSketch with per-shard quad2 wires (the shard_map HLL
    engine's new update_shards surface)."""
    from ntcard_tpu.models.hll import HllSketch
    from ntcard_tpu.parallel.data_parallel import ShardedHllSketch

    ref = HllSketch(25, 10, STRIDE)
    for b in pack_records(records, CHUNK, ROWS, KMAX):
        ref.update(b)
    sh = ShardedHllSketch(25, 10, STRIDE)
    rows_ps = ROWS // sh.n_dev
    halo = CHUNK - STRIDE
    for b in pack_records(records, CHUNK, ROWS, KMAX):
        shards = pack_shard_wires(b, sh.n_dev, "quad2", STRIDE)
        sh.update_shards(shards, packed=wire_mode_of(shards[0], rows_ps, halo))
    np.testing.assert_array_equal(sh.registers(), ref.registers())


def test_cli_chains_engine_golden(tmp_path):
    """Full ntcard CLI over the 8-device CPU mesh with the chains engine
    forced (NTCARD_SHARDED=chains) — byte-identical to the golden."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, NTCARD_SHARDED="chains")
    r = subprocess.run(
        [sys.executable, "-m", "ntcard_tpu.cli", "-k12", "-c1000", "-r16",
         "-p", str(tmp_path / "c"), str(root / "tests/data/reads.fq")],
        capture_output=True, timeout=600, env=env,
    )
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    got = (tmp_path / "c_k12.hist").read_bytes()
    want = (root / "tests/golden/reads_k12.hist.good").read_bytes()
    assert got == want
