"""The nibble-packed wire format (io.packing.pack_rows / ops.nthash.
unpack_rows) must be a pure re-encoding: sketches fed packed batches are
bit-identical to sketches fed the raw [B, L] batches (it halves the
host-to-device bytes)."""

import random

import numpy as np
import pytest

from ntcard_tpu.io.packing import (
    aligned_stride,
    pack_records,
    pack_rows,
    unpack_rows_np,
)

CHUNK, ROWS, K = 256, 128, 25
STRIDE = aligned_stride(CHUNK, K)


def _random_records(seed, n=400, alphabet="ACGTN"):
    rng = random.Random(seed)
    return [
        bytes("".join(rng.choice(alphabet) for _ in range(rng.randint(1, 3 * K))), "ascii")
        for _ in range(n)
    ]


def _batches(seed):
    return list(pack_records(_random_records(seed), CHUNK, ROWS, K))


def test_pack_roundtrip():
    rng = np.random.default_rng(0)
    b = rng.integers(0, 5, size=(ROWS, CHUNK), dtype=np.uint8)
    p = pack_rows(b)
    assert p.shape == (ROWS // 2, CHUNK)
    # unpacking concatenates [hi-rows, lo-rows]: same multiset of rows,
    # and in this pairing exactly the original order
    np.testing.assert_array_equal(unpack_rows_np(p), b)


def test_pack_rows_odd_rows_rejected():
    with pytest.raises(ValueError):
        pack_rows(np.zeros((3, 8), np.uint8))


def test_sketch_packed_parity():
    from ntcard_tpu.models.sketch import CountTableSketch

    s1 = CountTableSketch((K, 12), s_bits=7, r_bits=12, stride=STRIDE)
    s2 = CountTableSketch((K, 12), s_bits=7, r_bits=12, stride=STRIDE)
    for b in _batches(1):
        s1.update(b)
        s2.update(pack_rows(b), packed=True)
    f1, f2 = s1.finalize(return_table=True), s2.finalize(return_table=True)
    for k in (K, 12):
        assert f1[k]["f1"] == f2[k]["f1"]
        np.testing.assert_array_equal(f1[k]["table"], f2[k]["table"])


def test_hll_packed_parity():
    from ntcard_tpu.models.hll import HllSketch

    s1 = HllSketch(K, n_bits=10, stride=STRIDE)
    s2 = HllSketch(K, n_bits=10, stride=STRIDE)
    for b in _batches(2):
        s1.update(b)
        s2.update(pack_rows(b), packed=True)
    np.testing.assert_array_equal(s1.registers(), s2.registers())


def test_sharded_packed_parity():
    from ntcard_tpu.parallel.data_parallel import ShardedCountTableSketch

    s1 = ShardedCountTableSketch((K,), s_bits=7, r_bits=12, stride=STRIDE, n_devices=8)
    s2 = ShardedCountTableSketch((K,), s_bits=7, r_bits=12, stride=STRIDE, n_devices=8)
    for b in _batches(3):
        s1.update(b)
        s2.update(pack_rows(b), packed=True)
    f1, f2 = s1.finalize(return_table=True), s2.finalize(return_table=True)
    assert f1[K]["f1"] == f2[K]["f1"]
    np.testing.assert_array_equal(f1[K]["table"], f2[K]["table"])


def test_gap_seed_packed_parity():
    from ntcard_tpu.models.sketch import CountTableSketch

    gap = tuple(range(10, 15))  # k=25, g=5
    s1 = CountTableSketch((K,), s_bits=7, r_bits=12, stride=STRIDE, gap_positions=gap)
    s2 = CountTableSketch((K,), s_bits=7, r_bits=12, stride=STRIDE, gap_positions=gap)
    for b in _batches(4):
        s1.update(b)
        s2.update(pack_rows(b), packed=True)
    f1, f2 = s1.finalize(return_table=True), s2.finalize(return_table=True)
    assert f1[K]["f1"] == f2[K]["f1"]
    np.testing.assert_array_equal(f1[K]["table"], f2[K]["table"])
