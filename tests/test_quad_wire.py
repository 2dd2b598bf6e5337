"""The 2-bit 'quad' H2D wire format (io/packing.pack_rows_quad,
ops/nthash.unpack_quad, native packer_pop_quad).

Contract: the device-side decode reconstructs the EXACT code stream of the
raw/nibble paths (N restored from the delta sidecar), so sketches built from
quad wire batches are bit-identical; batches whose N count overflows the
delta slots fall back to the nibble wire on both the C and Python packers.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from ntcard_tpu.io.packing import (
    StreamPacker,
    pack_rows,
    pack_rows_quad,
    quad_ok,
    quad_wire_rows,
    wire_mode_of,
)
from ntcard_tpu.models.sketch import CountTableSketch
from ntcard_tpu.ops.nthash import N_CODE, unpack_quad

rng = np.random.default_rng(7)


def _codes(B, L, n_density):
    c = rng.integers(0, 4, (B, L), dtype=np.uint8)
    m = rng.random((B, L)) < n_density
    c[m] = N_CODE
    return c


@pytest.mark.parametrize("B,L,dens", [(64, 1024, 0.004), (128, 128, 0.005), (512, 256, 0.001)])
def test_roundtrip(B, L, dens):
    batch = _codes(B, L, dens)
    w = pack_rows_quad(batch)
    assert w is not None and w.shape == (quad_wire_rows(B), L)
    assert wire_mode_of(w, B) == "quad"
    got = np.asarray(unpack_quad(jnp.asarray(w)))
    np.testing.assert_array_equal(got, batch.T)


def test_gap_chaining_over_65533():
    batch = rng.integers(0, 4, (64, 1024), dtype=np.uint8)
    batch[0, 0] = N_CODE
    batch[-1, -1] = N_CODE  # gap of 65534 from the first N
    w = pack_rows_quad(batch)
    got = np.asarray(unpack_quad(jnp.asarray(w)))
    np.testing.assert_array_equal(got, batch.T)


def test_overflow_returns_none():
    assert pack_rows_quad(_codes(128, 128, 0.3)) is None  # too many Ns
    assert pack_rows_quad(_codes(24, 128, 0.0)) is None  # B % 64 != 0


def test_sketch_quad_matches_raw():
    ks, stride = (12, 17), 120
    a = CountTableSketch(ks, 7, 10, stride)
    b = CountTableSketch(ks, 7, 10, stride)
    for _ in range(2):
        x = _codes(128, 128, 0.005)
        a.update(x)
        w = pack_rows_quad(x)
        assert w is not None
        b.update(jnp.asarray(w), packed="quad")
    np.testing.assert_array_equal(np.asarray(a.tables), np.asarray(b.tables))
    assert a._f1_totals() == b._f1_totals()


def test_native_quad_matches_python():
    from ntcard_tpu.native import NativePacker, get_lib

    if get_lib() is None:
        pytest.skip("native packer unavailable")
    recs = [
        rng.choice(np.frombuffer(b"ACGT", np.uint8), int(rng.integers(200, 600))).tobytes()
        for _ in range(2000)
    ]
    recs[5] = recs[5][:50] + b"N" + recs[5][51:]
    recs[100] = b"NNN" + recs[100]

    chunk_len, batch_rows, kmax = 256, 512, 32
    sp = StreamPacker(chunk_len, batch_rows, kmax)
    py = []
    for r in recs:
        for b in sp.feed(r):
            w = pack_rows_quad(b)
            py.append(w if w is not None else pack_rows(b))
    for b in sp.finish():
        w = pack_rows_quad(b)
        py.append(w if w is not None else pack_rows(b))

    npk = NativePacker(chunk_len, batch_rows, kmax, wire_packed="quad")
    fq = b"".join(b"@r\n" + r + b"\n+\n" + b"I" * len(r) + b"\n" for r in recs)
    nat = list(npk.feed_bytes(fq)) + list(npk.flush())

    assert len(py) == len(nat)
    n_quad = sum(1 for w in py if w.shape[0] == quad_wire_rows(batch_rows))
    assert n_quad >= 1  # the clean batches actually exercised the quad path
    # the all-N padded flush batch must fall back on BOTH packers
    assert py[-1].shape[0] == batch_rows // 2
    for i, (p, q) in enumerate(zip(py, nat)):
        assert p.shape == q.shape, f"batch {i}: {p.shape} vs {q.shape}"
        np.testing.assert_array_equal(p, q, err_msg=f"batch {i}")


def test_quad_ok_geometry():
    assert quad_ok(8192, 1024)
    assert not quad_ok(8192, 1023)  # odd L
    assert not quad_ok(96, 128)  # B % 64


def test_sketch_quad_matches_raw_gap_seed():
    """Spaced seeds (NTMS64 mask stripping) read extra positions of the
    code stream; the quad decode must feed them identically."""
    k, gap = 13, 3
    half = (k - gap) // 2
    gap_positions = tuple(range(half, half + gap))
    a = CountTableSketch((k,), 7, 10, 112, gap_positions=gap_positions)
    b = CountTableSketch((k,), 7, 10, 112, gap_positions=gap_positions)
    for _ in range(2):
        x = _codes(128, 128, 0.005)
        a.update(x)
        w = pack_rows_quad(x)
        assert w is not None
        b.update(jnp.asarray(w), packed="quad")
    np.testing.assert_array_equal(np.asarray(a.tables), np.asarray(b.tables))
    assert a._f1_totals() == b._f1_totals()
