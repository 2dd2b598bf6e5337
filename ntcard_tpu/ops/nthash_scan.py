"""Batched canonical ntHash — sequential ``lax.scan`` formulation.

This was the first device implementation; it is retained as an
*independent cross-check* of the production rotated-prefix-XOR kernel
(ops/nthash.py), which derives the same values by a completely different
decomposition (tests/test_kernel_vs_oracle.py::test_scan_backend_matches_wxor).
A per-position scan serializes over L loop steps, so nothing in the product
path uses it.

Design (accelerator-first, not a port of the reference's per-read iterator):

* The host packs *all* input records into one N-separated base-code stream,
  cut into fixed-length chunks of ``L`` bases with a ``kmax-1``-base halo
  (stride ``S = L - kmax + 1``). A batch is a dense ``[B, L]`` uint8 array —
  contigs, short reads and SAM records all become the same layout, at ~99%
  lane occupancy. Chunk ``c`` *owns* the windows starting at local positions
  ``[0, S)``; halo windows are recomputed (owned) by the next chunk, so every
  window of the stream is counted exactly once.

* The kernel is a single ``lax.scan`` over the L positions with the batch
  spread across the vector lanes as ``[B/128, 128]`` tiles. Each step advances
  the forward and reverse-complement rolling hashes of every k in the k-list.
  The ntHash rolling recurrences are *exactly windowed* (each base's
  contribution is added on entry and removed bit-exactly k steps later, and
  N contributes 0 both ways — see ops/nthash_ref.py), so the scan rolls
  blindly through N bases and padding with **no data-dependent control
  flow**; a running non-N run-length masks invalid windows afterwards. This
  replaces the reference iterator's N-skip/re-init branches
  (ntHashIterator.hpp:59-86) with pure vector ops.

* 64-bit hash words are (hi, lo) uint32 pairs (utils/u64.py).

Behavioral parity targets: ntHashIterator semantics (reads shorter than k
yield nothing; windows containing non-ACGT/U are skipped), NTC64 canonical
values (vendor/ntHash/nthash.hpp:260-279), ntcard's sampling predicate
(ntcard.cpp:132-145) and nthll's HLL update (nthll.cpp:92-97).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

from ntcard_tpu import _jax_config  # noqa: F401  (platform/cache config before backend init)
import jax
import jax.numpy as jnp
import numpy as np

from ntcard_tpu import constants as C
from ntcard_tpu.utils import u64

N_CODE = C.N

EmitFn = Callable[[jnp.ndarray, jnp.ndarray, jnp.ndarray], object]


def _transposed(codes: jnp.ndarray) -> jnp.ndarray:
    """[B, L] uint8 -> [L, B//128, 128] (position-major for the scan)."""
    B, L = codes.shape
    if B % 128:
        raise ValueError(f"batch rows must be a multiple of 128, got {B}")
    return codes.T.reshape(L, B // 128, 128)


def _out_codes(codes: jnp.ndarray, k: int) -> jnp.ndarray:
    """Codes of the base *leaving* the k-window at each step (N for e<k)."""
    B, L = codes.shape
    pad = jnp.full((B, k), np.uint8(N_CODE), jnp.uint8)
    return _transposed(jnp.concatenate([pad, codes[:, : L - k]], axis=1))


def _lagged_codes(codes: jnp.ndarray, lag: int) -> jnp.ndarray:
    """Codes at stream position e-lag for each step e (N before start; N
    contributes 0 to every hash, and such windows are invalid anyway)."""
    if lag == 0:
        return _transposed(codes)
    B, L = codes.shape
    pad = jnp.full((B, lag), np.uint8(N_CODE), jnp.uint8)
    return _transposed(jnp.concatenate([pad, codes[:, : L - lag]], axis=1))


def _mask_tables(k: int, mask_positions: Sequence[int]):
    """Per masked position p: XOR-out tables for the spaced-seed hash
    (NTMS64 semantics, nthash.hpp:575-602): the forward hash sheds
    srol^(k-1-p)(seed(base)), the reverse sheds srol^p(seed(comp(base))).
    Both read the base at window offset p = stream lag k-1-p."""
    tabs = []
    for p in mask_positions:
        fwd = [C.rot_seed(b, k - 1 - p) for b in range(C.NUM_CODES)]
        rev = [C.rot_seed(C.COMP_CODE[b], p) for b in range(C.NUM_CODES)]
        f_hi, f_lo = zip(*(C.split_u64(v) for v in fwd))
        r_hi, r_lo = zip(*(C.split_u64(v) for v in rev))
        tabs.append(
            dict(
                lag=k - 1 - p,
                f_hi=np.asarray(f_hi, np.uint32),
                f_lo=np.asarray(f_lo, np.uint32),
                r_hi=np.asarray(r_hi, np.uint32),
                r_lo=np.asarray(r_lo, np.uint32),
            )
        )
    return tabs


def scan_stream(
    codes: jnp.ndarray,
    ks: Sequence[int],
    stride: int,
    emit_fns: Dict[int, EmitFn],
    want_f1: bool = True,
    mask_positions: Sequence[int] | None = None,
):
    """Run the rolling-hash scan for every k in ``ks`` over a chunk batch.

    Returns ``(f1, ys)`` where ``f1[k]`` is the exact count of owned valid
    windows (the reference's per-read totKmer sum, ntcard.cpp:155) and
    ``ys[k]`` is the stacked per-step emit output with leading axis L.
    Callers slice steps ``[k-1 : stride+k-1)`` to get the S owned windows.
    """
    B, L = codes.shape
    Bs = B // 128
    in_cT = _transposed(codes)
    out_cTs = tuple(_out_codes(codes, k) for k in ks)
    tabs = {k: C.seed_tables_u32(k) for k in ks}

    mask_tabs = ()
    lag_cTs = ()
    if mask_positions:
        if len(ks) != 1:
            raise ValueError("spaced seeds support a single k only (reference parity)")
        mask_tabs = tuple(_mask_tables(ks[0], mask_positions))
        lag_cTs = tuple(_lagged_codes(codes, mt["lag"]) for mt in mask_tabs)

    z = jnp.zeros((Bs, 128), jnp.uint32)
    carry = {
        "runlen": jnp.zeros((Bs, 128), jnp.int32),
        "fh": {k: (z, z) for k in ks},
        "rh": {k: (z, z) for k in ks},
    }
    if want_f1:
        carry["f1"] = {k: jnp.zeros((Bs, 128), jnp.int32) for k in ks}

    es = jnp.arange(L, dtype=jnp.int32)
    xs = (es, in_cT, out_cTs, lag_cTs)

    def step(carry, x):
        e, in_c, outs, lags = x
        runlen = jnp.where(in_c == N_CODE, 0, carry["runlen"] + 1)
        new = {"runlen": runlen, "fh": {}, "rh": {}}
        if want_f1:
            new["f1"] = {}
        ys = {}
        for i, k in enumerate(ks):
            t = tabs[k]
            out_c = outs[i]
            fh_hi, fh_lo = carry["fh"][k]
            rh_hi, rh_lo = carry["rh"][k]
            # forward: F' = srol(F) ^ seed(in) ^ srol^k(seed(out))
            fh_hi, fh_lo = u64.srol(fh_hi, fh_lo)
            fh_hi = fh_hi ^ u64.lut5(in_c, t["seed_f_hi"]) ^ u64.lut5(out_c, t["rotk_f_hi"])
            fh_lo = fh_lo ^ u64.lut5(in_c, t["seed_f_lo"]) ^ u64.lut5(out_c, t["rotk_f_lo"])
            # reverse: R' = sror( R ^ srol^k(seed(comp(in))) ^ seed(comp(out)) )
            th = rh_hi ^ u64.lut5(in_c, t["rotk_c_hi"]) ^ u64.lut5(out_c, t["seed_c_hi"])
            tl = rh_lo ^ u64.lut5(in_c, t["rotk_c_lo"]) ^ u64.lut5(out_c, t["seed_c_lo"])
            rh_hi, rh_lo = u64.sror(th, tl)
            new["fh"][k] = (fh_hi, fh_lo)
            new["rh"][k] = (rh_hi, rh_lo)
            # window [e-k+1, e] is valid iff its k bases are all non-N, and is
            # owned by this chunk iff its start lies in [0, stride).
            owned_valid = (runlen >= k) & (e >= k - 1) & (e < stride + k - 1)
            eh_hi, eh_lo, er_hi, er_lo = fh_hi, fh_lo, rh_hi, rh_lo
            for mt, lag_c in zip(mask_tabs, lags):
                eh_hi = eh_hi ^ u64.lut5(lag_c, mt["f_hi"])
                eh_lo = eh_lo ^ u64.lut5(lag_c, mt["f_lo"])
                er_hi = er_hi ^ u64.lut5(lag_c, mt["r_hi"])
                er_lo = er_lo ^ u64.lut5(lag_c, mt["r_lo"])
            ch, cl = u64.min64(eh_hi, eh_lo, er_hi, er_lo)
            ys[k] = emit_fns[k](ch, cl, owned_valid)
            if want_f1:
                new["f1"][k] = carry["f1"][k] + owned_valid.astype(jnp.int32)
        return new, ys

    final, ys = jax.lax.scan(step, carry, xs)
    f1 = None
    if want_f1:
        f1 = {k: jnp.sum(final["f1"][k]) for k in ks}
    return f1, ys


def _owned(y: jnp.ndarray, k: int, stride: int) -> jnp.ndarray:
    """Slice the stacked [L, Bs, 128] per-step output down to the S owned
    steps for this k and flatten to [S * B]."""
    return jax.lax.slice_in_dim(y, k - 1, stride + k - 1, axis=0).reshape(-1)


# ---------------------------------------------------------------------------
# Public kernels
# ---------------------------------------------------------------------------


def canonical_hashes(
    codes: jnp.ndarray, k: int, stride: int, mask_positions: Sequence[int] | None = None
):
    """Canonical 64-bit hashes of every owned window (spaced-seed hashes when
    ``mask_positions`` is given).

    Returns (hi, lo, valid), each [B, S]: hi/lo uint32 halves of NTC64 and a
    bool mask of N-free fully-in-stream windows. Primarily the test/API
    surface (parity with ntHashIterator + NTC64 / stHashIterator + NTMS64)."""
    B, L = codes.shape

    def emit(ch, cl, valid):
        return ch, cl, valid

    _, ys = scan_stream(
        codes, (k,), stride, {k: emit}, want_f1=False, mask_positions=mask_positions
    )
    ch, cl, valid = ys[k]

    def fix(a):  # [L, Bs, 128] -> [B, S]
        a = jax.lax.slice_in_dim(a, k - 1, stride + k - 1, axis=0)
        return a.reshape(stride, B).T

    return fix(ch), fix(cl), fix(valid)


def make_sketch_emit(s_bits: int, r_bits: int) -> EmitFn:
    """ntcard's sampling + bucketing (ntcard.cpp:132-145), reproduced exactly:

      sample 0 iff hVal >> (63-sBits) == 1        (rate 2^-(sBits+1))
      sample 1 iff hVal >> (64-sBits) == sMask    (rate 2^-sBits, sMask=2^(sBits-1)-1)
      bucket   = hVal & (2^rBits - 1)
      emit idx = sample*2^rBits + bucket, or the sentinel 2^(rBits+1) if
                 unsampled/invalid (dropped by the table scatter).

    The asymmetric sample rates are a reference quirk that must be kept for
    histogram equality. Requires s_bits <= 31 and r_bits <= 28 (int32 idx).
    """
    if not (1 <= s_bits <= 31):
        raise ValueError(f"s_bits must be in [1,31], got {s_bits}")
    if not (1 <= r_bits <= 28):
        raise ValueError(f"r_bits must be in [1,28], got {r_bits}")
    r_buck = 1 << r_bits
    s_mask = (1 << (s_bits - 1)) - 1
    sentinel = jnp.int32(2 * r_buck)

    def emit(ch, cl, valid):
        s0 = (ch >> jnp.uint32(31 - s_bits)) == jnp.uint32(1)
        s1 = (ch >> jnp.uint32(32 - s_bits)) == jnp.uint32(s_mask)
        bucket = (cl & jnp.uint32(r_buck - 1)).astype(jnp.int32)
        bucket = bucket + jnp.where(s1, jnp.int32(r_buck), jnp.int32(0))
        return jnp.where(valid & (s0 | s1), bucket, sentinel)

    return emit


def sketch_scan(
    codes: jnp.ndarray,
    ks: Sequence[int],
    stride: int,
    s_bits: int,
    r_bits: int,
    mask_positions: Sequence[int] | None = None,
) -> Tuple[Dict[int, jnp.ndarray], Dict[int, jnp.ndarray]]:
    """Fused hash+sample kernel for ntcard: per k, a flat [S*B] int32 array of
    count-table indices (sentinel 2^(r_bits+1) where no update) plus the exact
    valid-window count (F1 contribution)."""
    emit = make_sketch_emit(s_bits, r_bits)
    f1, ys = scan_stream(
        codes, tuple(ks), stride, {k: emit for k in ks}, mask_positions=mask_positions
    )
    idx = {k: _owned(ys[k], k, stride) for k in ks}
    return idx, f1


def make_hll_emit(n_bits: int) -> EmitFn:
    """nthll's register update inputs (nthll.cpp:92-97): register index =
    hVal & (2^n_bits - 1); value = clz64(hVal & ~(2^n_bits-1)), or 0 when that
    masked value is 0 or the window is invalid (max with 0 is a no-op)."""
    if not (1 <= n_bits <= 31):
        raise ValueError(f"n_bits must be in [1,31], got {n_bits}")
    mask = jnp.uint32((1 << n_bits) - 1) if n_bits < 32 else jnp.uint32(0xFFFFFFFF)

    def emit(ch, cl, valid):
        lo_m = cl & ~mask
        clz = jnp.where(
            ch != 0,
            jax.lax.clz(ch),
            jnp.uint32(32) + jax.lax.clz(lo_m),
        ).astype(jnp.int32)
        nonzero = (ch != 0) | (lo_m != 0)
        run0 = jnp.where(valid & nonzero, clz, jnp.int32(0))
        reg = (cl & mask).astype(jnp.int32)
        return reg, run0

    return emit


def hll_scan(codes: jnp.ndarray, k: int, stride: int, n_bits: int):
    """Fused hash+HLL kernel for nthll: flat [S*B] (register index, run0)."""
    emit = make_hll_emit(n_bits)
    _, ys = scan_stream(codes, (k,), stride, {k: emit}, want_f1=False)
    reg, run0 = ys[k]
    return _owned(reg, k, stride), _owned(run0, k, stride)
