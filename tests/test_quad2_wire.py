"""quad2 wire parity: the owned-span 2-bit wire with uint8 sidecar and
device-rebuilt halo (io/packing.pack_rows_quad2 <-> ops/nthash.unpack_quad2)
must reproduce the raw code stream bit-exactly, in both the Python and the
fused C packers, across read/contig/N-run/pad-tail shapes."""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from ntcard_tpu.io.packing import (
    StreamPacker,
    pack_records,
    pack_rows,
    pack_rows_quad2,
    quad2_ok,
    quad2_wire_rows,
)
from ntcard_tpu.models.sketch import CountTableSketch
from ntcard_tpu.ops.nthash import unpack_quad2

rng = np.random.default_rng(9)


def _reads(n, lo, hi, alpha="ACGT", seed=4):
    r = random.Random(seed)
    return [
        "".join(r.choice(alpha) for _ in range(r.randint(lo, hi))).encode()
        for _ in range(n)
    ]


@pytest.mark.parametrize(
    "reads",
    [
        _reads(4000, 150, 150),            # uniform short reads
        _reads(60, 3000, 9000),            # contigs (multi-row records)
        _reads(600, 400, 800, "ACGT" * 40 + "N"),  # sparse real Ns
        _reads(3, 5, 20),                  # tiny stream: all-pad tail batch
    ],
    ids=["uniform150", "contigs", "sparseN", "tiny"],
)
def test_roundtrip_python(reads):
    chunk_len, rows, kmax = 512, 256, 64
    p = StreamPacker(chunk_len, rows, kmax)
    n_ok = 0
    for b in pack_records(reads, chunk_len, rows, kmax, packer=p):
        w = pack_rows_quad2(b, p.stride)
        if w is None:
            continue  # sidecar overflow: nibble fallback path, covered below
        assert w.shape == (quad2_wire_rows(rows), p.stride)
        np.testing.assert_array_equal(
            np.asarray(unpack_quad2(jnp.asarray(w), chunk_len - p.stride)), b.T
        )
        n_ok += 1
    assert n_ok >= 1


def test_fill_covers_pad_tail():
    """Flush batches are mostly N padding; the fill entry (254) must keep
    them on the 2-bit wire instead of overflowing to nibble."""
    chunk_len, rows, kmax = 512, 256, 64
    p = StreamPacker(chunk_len, rows, kmax)
    batches = list(pack_records(_reads(3, 5, 20), chunk_len, rows, kmax, packer=p))
    assert len(batches) == 1
    w = pack_rows_quad2(batches[0], p.stride)
    assert w is not None  # no overflow despite ~99% pad Ns


def test_sketch_quad2_matches_raw():
    ks, chunk_len, rows = (12, 17), 272, 256  # stride 256: quad2 geometry-admissible at 256 rows
    p = StreamPacker(chunk_len, rows, max(ks))
    stride = p.stride
    a = CountTableSketch(ks, 7, 10, stride)
    b = CountTableSketch(ks, 7, 10, stride)
    for x in pack_records(_reads(2000, 150, 400, seed=5), chunk_len, rows, max(ks), packer=p):
        a.update(x)
        w = pack_rows_quad2(x, stride)
        assert w is not None
        b.update(jnp.asarray(w), packed=f"quad2:{chunk_len - stride}")
    np.testing.assert_array_equal(np.asarray(a.tables), np.asarray(b.tables))
    assert a._f1_totals() == b._f1_totals()


def test_sketch_quad2_matches_raw_gap_seed():
    k, gap = 13, 3
    half = (k - gap) // 2
    gap_positions = tuple(range(half, half + gap))
    chunk_len, rows = 272, 256
    p = StreamPacker(chunk_len, rows, k)
    stride = p.stride
    a = CountTableSketch((k,), 7, 10, stride, gap_positions=gap_positions)
    b = CountTableSketch((k,), 7, 10, stride, gap_positions=gap_positions)
    for x in pack_records(_reads(2000, 150, 400, seed=6), chunk_len, rows, k, packer=p):
        a.update(x)
        w = pack_rows_quad2(x, stride)
        assert w is not None
        b.update(jnp.asarray(w), packed=f"quad2:{chunk_len - stride}")
    np.testing.assert_array_equal(np.asarray(a.tables), np.asarray(b.tables))
    assert a._f1_totals() == b._f1_totals()


def test_native_quad2_matches_python():
    from ntcard_tpu.native import NativePacker, get_lib

    if get_lib() is None:
        pytest.skip("native packer unavailable")
    recs = _reads(2500, 100, 700, seed=7)
    recs[5] = recs[5][:50] + b"N" + recs[5][51:]
    recs[100] = b"NNN" + recs[100]
    recs[200] = b""

    chunk_len, batch_rows, kmax = 256, 512, 32
    sp = StreamPacker(chunk_len, batch_rows, kmax)
    py = []
    for r in recs:
        for b in sp.feed(r):
            w = pack_rows_quad2(b, sp.stride)
            py.append(w if w is not None else pack_rows(b))
    for b in sp.finish():
        w = pack_rows_quad2(b, sp.stride)
        py.append(w if w is not None else pack_rows(b))

    npk = NativePacker(chunk_len, batch_rows, kmax, wire_packed="quad2")
    fq = b"".join(b"@r\n" + r + b"\n+\n" + b"I" * len(r) + b"\n" for r in recs)
    nat = list(npk.feed_bytes(fq)) + list(npk.flush())

    assert len(py) == len(nat)
    n_q2 = sum(1 for w in py if w.shape[0] == quad2_wire_rows(batch_rows))
    assert n_q2 == len(py)  # incl. the pad-tail flush batch (fill entry)
    for i, (p, q) in enumerate(zip(py, nat)):
        assert p.shape == q.shape, f"batch {i}: {p.shape} vs {q.shape}"
        np.testing.assert_array_equal(p, q, err_msg=f"batch {i}")


def test_quad2_ok_geometry():
    assert quad2_ok(8192, 960)
    assert not quad2_ok(128, 960)  # too few rows (collides with quad rows)
    assert not quad2_ok(8192, 959)  # (B/128 * S) % 128 != 0


def test_quad2_rejects_nonconsecutive_rows():
    """pack_rows_quad2's decode contract only holds when rows are
    consecutive spans of one stream (batch[b, S:] == batch[b+1, :halo]);
    an arbitrary batch violating it must fall back (None), not silently
    encode different codes (ADVICE r2)."""
    S, halo = 128, 16
    bad = rng.integers(0, 4, (256, S + halo), dtype=np.uint8)
    assert pack_rows_quad2(bad, S) is None
    stream = rng.integers(0, 4, 256 * S + halo, dtype=np.uint8)
    good = np.stack([stream[i * S : i * S + S + halo] for i in range(256)])
    wire = pack_rows_quad2(good, S)
    assert wire is not None
    np.testing.assert_array_equal(
        np.asarray(unpack_quad2(jnp.asarray(wire), halo)), good.T
    )
