"""Batched canonical ntHash over packed base streams — the device hot
kernel, in the *rotated-prefix-XOR* formulation.

The reference's rolling recurrence (nthash.hpp:242-257) is inherently
sequential. Here we exploit that srol (P) is a linear bit permutation and
XOR is associative. With the derotated contribution g(j) = P^(-j)(seed(b_j))
and its inclusive prefix XOR X(j), the forward hash of the window starting at
i is P^(i+k-1)(X(i+k-1) ^ X(i-1)) (nthash.hpp:220-239 algebra). Distributing
the rotation over the XOR and pre-rotating the prefixes once,

    Y(m)  = P^m( X(m) ),        Yc(m) = P^(-(m+1))( Xc(m) ),
    F(i)  = Y(i+k-1)  ^ P^k( Y(i-1) ),
    R(i)  = P^k( Yc(i+k-1) ) ^ Yc(i-1),

where gc(j) = P^j(seed(comp b_j)) feeds Xc. The entire computation is then:

  * seed lookups as 4-way select chains (no gathers: the whole chain
    stays elementwise, so XLA fuses it into one pass);
  * per-position derotations and the Y/Yc rotations via
    ops/rotations.srol_var_iota: multiply/multiply-high by power-of-two
    constants synthesized from the position iota (no variable-amount
    shifts, no broadcasts);
  * 2 inclusive prefix-XORs (``associative_scan`` along the *major* axis —
    log-depth, cheap);
  * per k: one constant P^k rotation + XOR + canonical min + emit.

Multi-k is nearly free (X/Y are k-independent). Spaced seeds strip masked
positions p as P^(k-1-p)(seed(b_{i+p})) / P^p(seed(comp b_{i+p})) — gathers
into 5-entry constant tables (NTMS64 semantics, nthash.hpp:575-617). N bases
contribute seed 0 and are masked by a prefix count, replacing the reference
iterator's N-skip branches (ntHashIterator.hpp:59-86).

Validity/ownership: a chunk of length L owns window starts i in [0, stride);
a window is emitted iff its k bases are N-free. Reads shorter than k yield
nothing by construction (their N separators bound the run).

Layout: device compute is position-major [L, B] (batch along the minor
axis, with all per-position constants materialized full-shape). 64-bit
hashes ride as (hi, lo) uint32 pairs.

The equivalent per-position sequential implementation is kept in
ops/nthash_scan.py as a cross-check oracle for this kernel.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from ntcard_tpu import _jax_config  # noqa: F401  (platform/cache config before backend init)
import jax
import jax.numpy as jnp
import numpy as np

from ntcard_tpu import constants as C
from ntcard_tpu.ops import rotations as R
from ntcard_tpu.utils import u64

N_CODE = C.N

# (5,) uint32 seed luts: forward seeds and complement seeds (host constants).
_SEED_HI = np.asarray([C.split_u64(s)[0] for s in C.SEEDS], np.uint32)
_SEED_LO = np.asarray([C.split_u64(s)[1] for s in C.SEEDS], np.uint32)
_CSEED_HI = np.asarray([C.split_u64(C.SEEDS[C.COMP_CODE[b]])[0] for b in range(5)], np.uint32)
_CSEED_LO = np.asarray([C.split_u64(C.SEEDS[C.COMP_CODE[b]])[1] for b in range(5)], np.uint32)


def _position_consts(L: int, B: int):
    """Per-position rotation-amount residues, derived in-kernel from an iota
    so nothing large is embedded in the program: amounts for P^(-m) (the
    derotation of g), P^m (Y) and P^(-(m+1)) (Yc)."""
    m = jax.lax.broadcasted_iota(jnp.int32, (L, B), 0)
    i33 = m % 33
    i31 = m % 31
    # (-m) mod 33 == (33 - i33) mod 33; select avoids a second modulo
    mneg = (jnp.where(i33 == 0, 0, 33 - i33), jnp.where(i31 == 0, 0, 31 - i31))
    # -(m+1) mod 33 == 32 - i33; likewise 30 - i31
    return mneg, (i33, i31), (32 - i33, 30 - i31)


def _xor_pair_scan(hi, lo):
    """Inclusive prefix-XOR of a (hi, lo) u64 stream along axis 0."""
    return jax.lax.associative_scan(
        lambda a, b: (a[0] ^ b[0], a[1] ^ b[1]), (hi, lo), axis=0
    )


def _shift_prev(x):
    """x(m) -> x(m-1) along axis 0 with x(-1) = 0, keeping only rows [0, S)."""
    return jnp.pad(x[:-1], ((1, 0), (0, 0)))


def unpack_rows(codes: jnp.ndarray) -> jnp.ndarray:
    """Device-side inverse of io.packing.pack_rows: [B/2, L] uint8 row-paired
    nibble batch -> [L, B] transposed code stream (hi nibble = chunk row b,
    lo nibble = chunk row b + B/2).

    Chunk rows are independent (each carries its own halo) and the sketch
    fold commutes, so pairing arbitrary rows into one byte is semantics-free.
    Unpacking is two constant shifts + one lane-axis concat; it halves the
    host->device payload."""
    p = codes.T  # [L, B/2]
    return jnp.concatenate([p >> 4, p & 0x0F], axis=1)


def unpack_quad(wire: jnp.ndarray) -> jnp.ndarray:
    """Device-side inverse of io.packing.pack_rows_quad: [B/4 + B/64, L]
    uint8 quad wire -> [L, B] transposed code stream, bit-identical to the
    nibble path's.

    Two parts: a 2-bit unpack of the code rows (N was sent as 0), then the
    uint16 delta stream (see packing.py for the spec) is decoded to flat
    N positions — per-column cumsum of the column-major stream plus a tiny
    lane prefix of column totals — and one scatter-set restores N_CODE at
    those positions. The wire is ~47% of the nibble wire's bytes."""
    R, L = wire.shape
    if R % 17:
        raise ValueError(f"quad wire rows ({R}) must be a multiple of 17")
    B = R * 64 // 17
    g = B // 4
    p = wire[:g].T  # [L, B/4]
    three = np.uint8(3)
    cT = jnp.concatenate(
        [p & three, (p >> 2) & three, (p >> 4) & three, (p >> 6) & three], axis=1
    )
    tail = wire[g:].reshape(-1, 2)  # little-endian uint16 pairs
    v = tail[:, 0].astype(jnp.int32) | (tail[:, 1].astype(jnp.int32) << np.int32(8))
    A = v.reshape(-1, 128)  # [nslots/128, 128], stream runs down columns
    adv = jnp.where(
        A == np.int32(0xFFFF),
        np.int32(65533),
        jnp.where(A == np.int32(0xFFFE), np.int32(0), A),
    )
    mark = A < np.int32(0xFFFE)
    colsum = jnp.cumsum(adv, axis=0)
    totals = colsum[-1]
    offs = jnp.cumsum(totals) - totals  # exclusive lane prefix (128 elems)
    pos = colsum + offs[None, :]
    li = jnp.where(mark, pos % np.int32(L), np.int32(L))  # L = out of bounds
    bi = pos // np.int32(L)
    return cT.at[li.reshape(-1), bi.reshape(-1)].set(np.uint8(N_CODE), mode="drop")


def unpack_quad2(wire: jnp.ndarray, halo: int) -> jnp.ndarray:
    """Device-side inverse of io.packing.pack_rows_quad2: [B/4 + B/128 + 1,
    S] uint8 quad2 wire -> [S + halo, B] transposed code stream, bit-
    identical to what the quad/nibble paths produce for the same stream.

    Three parts: a 2-bit unpack of the owned spans (N sent as 0), the uint8
    delta sidecar decoded to stream offsets (per-column cumsum + lane
    prefix, io/packing.py quad2 spec) restored by one scatter-set, and the
    halo rebuilt from the data already on device — chunk b's halo is the
    head of chunk b+1, i.e. the NEXT LANE of the same batch; only the last
    lane's halo travels, as the raw-code tail row. ~2.06 bits per owned
    base on the wire (quad: ~2.27)."""
    R, S = wire.shape
    B = (R - 1) * 128 // 33  # R = B/4 + B/128 + 1
    g = B // 4
    drows = B // 128
    p = wire[:g].T  # [S, B/4]
    three = np.uint8(3)
    cT = jnp.concatenate(
        [p & three, (p >> 2) & three, (p >> 4) & three, (p >> 6) & three], axis=1
    )  # [S, B] owned spans
    # sidecar: uint8 entries, stream runs down the columns of [nslots/128, 128]
    nslots = drows * S
    A = wire[g : g + drows].reshape(-1).astype(jnp.int32).reshape(-1, 128)
    is_mark = A <= np.int32(239)
    adv = jnp.where(
        is_mark,
        A,
        jnp.where(A >= np.int32(254), np.int32(0), (A - np.int32(239)) * np.int32(240)),
    )
    colsum = jnp.cumsum(adv, axis=0)
    totals = colsum[-1]
    offs = jnp.cumsum(totals) - totals  # exclusive lane prefix
    pos = colsum + offs[None, :]
    # owned-stream offset -> (sublane j = pos % S, lane b = pos // S)
    ji = jnp.where(is_mark, pos % np.int32(S), np.int32(S))  # S = out of bounds
    bi = pos // np.int32(S)
    cT = cT.at[ji.reshape(-1), bi.reshape(-1)].set(np.uint8(N_CODE), mode="drop")
    # fill entry (254): every stream position after it is N (the all-N pad
    # tail of a flush batch; packing.py quad2 spec)
    fill_from = jnp.min(jnp.where(A == np.int32(254), pos, np.int32(0x7FFFFFFF)))
    sub = jax.lax.broadcasted_iota(jnp.int32, (S, B), 0)
    lane = jax.lax.broadcasted_iota(jnp.int32, (S, B), 1)
    flat = lane * np.int32(S) + sub
    cT = jnp.where(flat > fill_from, np.uint8(N_CODE), cT)
    # halo: chunk b's bases [S, S+halo) = chunk b+1's bases [0, halo) -> one
    # lane rotation of the head rows, with the wire tail row fixing lane B-1
    head = cT[:halo]  # [halo, B] (after N restore)
    tail = wire[g + drows, :halo].reshape(halo, 1)  # raw codes incl. N
    shifted = jnp.concatenate([head[:, 1:], tail], axis=1)
    return jnp.concatenate([cT, shifted], axis=0)  # [S + halo, B]


def _codes_T(codes: jnp.ndarray, packed) -> jnp.ndarray:
    """[*, L] wire/code batch -> [L, B] transposed code stream. ``packed``:
    False = raw [B, L] codes, True/"nibble" = nibble wire, "quad" = quad
    wire, "quad2:<halo>" = owned-span quad2 wire."""
    if isinstance(packed, str) and packed.startswith("quad2:"):
        return unpack_quad2(codes, int(packed.split(":", 1)[1]))
    if packed == "quad":
        return unpack_quad(codes)
    if packed:
        return unpack_rows(codes)
    return codes.T


def window_hashes(
    codes: jnp.ndarray,
    ks: Sequence[int],
    stride: int,
    mask_positions: Sequence[int] | None = None,
    packed: bool = False,
    with_strand: bool = False,
) -> Dict[int, Tuple[jnp.ndarray, ...]]:
    """Canonical (spaced) window hashes for every k.

    codes: [B, L] uint8 (or a wire batch when ``packed``; see _codes_T).
    Returns {k: (hi, lo, valid)}, each [stride, B] (position-major); with
    ``with_strand`` additionally the hStn strand indicator (True = the
    reverse-complement hash was selected, nthash.hpp:512 `rhVal<fhVal`)."""
    if mask_positions and len(ks) != 1:
        raise ValueError("spaced seeds support a single k only (reference parity)")

    cT = _codes_T(codes, packed)  # [L, B] uint8
    L, B = cT.shape
    mneg, ky, kyc = _position_consts(L, B)

    # g(j) = P^(-j)(seed(b_j)), gc(j) = P^(+j)(seed(comp b_j)): select-chain
    # seed lookup + iota-amount rotation — no gathers anywhere, so the chain
    # stays one elementwise fusion.
    s_hi = u64.lut5(cT, _SEED_HI)
    s_lo = u64.lut5(cT, _SEED_LO)
    g_hi, g_lo = R.srol_var_iota(s_hi, s_lo, *mneg)
    c_hi = u64.lut5(cT, _CSEED_HI)
    c_lo = u64.lut5(cT, _CSEED_LO)
    gc_hi, gc_lo = R.srol_var_iota(c_hi, c_lo, *ky)

    x_hi, x_lo = _xor_pair_scan(g_hi, g_lo)
    xc_hi, xc_lo = _xor_pair_scan(gc_hi, gc_lo)

    y_hi, y_lo = R.srol_var_iota(x_hi, x_lo, *ky)
    yc_hi, yc_lo = R.srol_var_iota(xc_hi, xc_lo, *kyc)

    ncnt = jnp.cumsum((cT == N_CODE).astype(jnp.int32), axis=0)

    S = stride
    yp_hi, yp_lo = _shift_prev(y_hi)[:S], _shift_prev(y_lo)[:S]
    ycp_hi, ycp_lo = _shift_prev(yc_hi)[:S], _shift_prev(yc_lo)[:S]
    ncnt_p = _shift_prev(ncnt)[:S]

    out = {}
    for k in ks:
        end = slice(k - 1, k - 1 + S)
        # F(i) = Y(i+k-1) ^ P^k(Y(i-1))
        pk_hi, pk_lo = R.srol_const(yp_hi, yp_lo, k)
        fh_hi = y_hi[end] ^ pk_hi
        fh_lo = y_lo[end] ^ pk_lo
        # R(i) = P^k(Yc(i+k-1)) ^ Yc(i-1)
        qk_hi, qk_lo = R.srol_const(yc_hi[end], yc_lo[end], k)
        rh_hi = qk_hi ^ ycp_hi
        rh_lo = qk_lo ^ ycp_lo

        if mask_positions:
            # strip masked position p: F ^= P^(k-1-p)(seed(b_{i+p})),
            #                          R ^= P^p(seed(comp b_{i+p}))
            for p in mask_positions:
                cp = cT[p : p + S]
                ft = np.array([C.split_u64(C.rot_seed(b, k - 1 - p)) for b in range(5)], np.uint32)
                rt = np.array(
                    [C.split_u64(C.rot_seed(C.COMP_CODE[b], p)) for b in range(5)], np.uint32
                )
                fh_hi = fh_hi ^ u64.lut5(cp, ft[:, 0])
                fh_lo = fh_lo ^ u64.lut5(cp, ft[:, 1])
                rh_hi = rh_hi ^ u64.lut5(cp, rt[:, 0])
                rh_lo = rh_lo ^ u64.lut5(cp, rt[:, 1])

        valid = (ncnt[end] - ncnt_p) == 0
        if with_strand == "forward":
            out[k] = (fh_hi, fh_lo, valid)
            continue
        ch, cl = u64.min64(fh_hi, fh_lo, rh_hi, rh_lo)
        if with_strand:
            out[k] = (ch, cl, valid, u64.lt(rh_hi, rh_lo, fh_hi, fh_lo))
        else:
            out[k] = (ch, cl, valid)
    return out


def window_hashes_doubling(
    codes: jnp.ndarray,
    ks: Sequence[int],
    stride: int,
    mask_positions: Sequence[int] | None = None,
    packed: bool = False,
    with_strand: bool = False,
) -> Dict[int, Tuple[jnp.ndarray, ...]]:
    """window_hashes by *window doubling* instead of rotated prefix scans.

    A length-(a+b) window hash composes from its halves with constant-amount
    rotations only (the add-chain lift of the rolling update,
    nthash.hpp:242-257):

        Wf[a+b](i) = P^b( Wf[a](i) ) ^ Wf[b](i+a)
        Wr[a+b](i) = Wr[a](i) ^ P^a( Wr[b](i+a) )

    starting from Wf[1](i) = seed(b_i), Wr[1](i) = seed(comp b_i). Building
    power-of-two widths by doubling and composing the set bits of each k
    costs ~log2(k)+popcount(k) combines per strand, every one of them plain
    shifts/XORs on full [L, B] tiles — no per-position rotation amounts, no
    associative_scan, nothing that breaks XLA fusion. N validity is the same
    doubling on a windowed OR. Values are bit-identical to window_hashes
    (cross-checked in tests)."""
    if mask_positions and len(ks) != 1:
        raise ValueError("spaced seeds support a single k only (reference parity)")

    cT = _codes_T(codes, packed)  # [L, B] uint8
    S = stride

    def shift_up(x, s):
        return jnp.pad(x[s:], ((0, s), (0, 0)))

    # width-1 windows: the seeds themselves
    f1 = (u64.lut5(cT, _SEED_HI), u64.lut5(cT, _SEED_LO))
    r1 = (u64.lut5(cT, _CSEED_HI), u64.lut5(cT, _CSEED_LO))
    n1 = cT == N_CODE

    def compose(fa, ra, na, la, fb, rb, nb, lb):
        # forward: P^lb(Wf[a](i)) ^ Wf[b](i+la)
        pf = R.srol_const(*fa, lb)
        fb_s = (shift_up(fb[0], la), shift_up(fb[1], la))
        f = (pf[0] ^ fb_s[0], pf[1] ^ fb_s[1])
        # reverse: Wr[a](i) ^ P^la(Wr[b](i+la))
        rb_s = R.srol_const(shift_up(rb[0], la), shift_up(rb[1], la), la)
        r = (ra[0] ^ rb_s[0], ra[1] ^ rb_s[1])
        return f, r, na | shift_up(nb, la)

    kmax = max(ks)
    pow2: dict = {1: (f1, r1, n1)}
    w = 1
    while 2 * w <= kmax:
        f, r, nn = pow2[w]
        pow2[2 * w] = compose(f, r, nn, w, f, r, nn, w)
        w *= 2

    out = {}
    for k in ks:
        acc = None
        alen = 0
        for bit in reversed(range(k.bit_length())):
            p = 1 << bit
            if not (k & p):
                continue
            piece = pow2[p]
            if acc is None:
                acc, alen = piece, p
            else:
                f, r, nn = compose(*acc, alen, *piece, p)
                acc, alen = (f, r, nn), alen + p
        (fh_hi, fh_lo), (rh_hi, rh_lo), has_n = acc
        fh_hi, fh_lo = fh_hi[:S], fh_lo[:S]
        rh_hi, rh_lo = rh_hi[:S], rh_lo[:S]
        valid = ~has_n[:S]

        if mask_positions:
            for p in mask_positions:
                cp = cT[p : p + S]
                ft = np.array(
                    [C.split_u64(C.rot_seed(b, k - 1 - p)) for b in range(5)], np.uint32
                )
                rt = np.array(
                    [C.split_u64(C.rot_seed(C.COMP_CODE[b], p)) for b in range(5)], np.uint32
                )
                fh_hi = fh_hi ^ u64.lut5(cp, ft[:, 0])
                fh_lo = fh_lo ^ u64.lut5(cp, ft[:, 1])
                rh_hi = rh_hi ^ u64.lut5(cp, rt[:, 0])
                rh_lo = rh_lo ^ u64.lut5(cp, rt[:, 1])

        if with_strand == "forward":
            out[k] = (fh_hi, fh_lo, valid)
            continue
        ch, cl = u64.min64(fh_hi, fh_lo, rh_hi, rh_lo)
        if with_strand:
            out[k] = (ch, cl, valid, u64.lt(rh_hi, rh_lo, fh_hi, fh_lo))
        else:
            out[k] = (ch, cl, valid)
    return out


# ---------------------------------------------------------------------------
# Public kernels (API shared with ops/nthash_scan.py)
# ---------------------------------------------------------------------------


def spaced_hashes_forward(
    codes: jnp.ndarray, k: int, stride: int, mask_positions: Sequence[int] | None = None
):
    """Forward-strand (non-canonical) spaced-seed hashes — NTS64 /
    ssHashIterator parity (nthash.hpp:550-572, ssHashIterator.hpp:18-122):
    sVal = fhVal with every don't-care position p's seed contribution
    P^(k-1-p)(seed(b_{i+p})) stripped. Returns (hi, lo, valid), each
    [B, stride]."""
    h = _hash_backend()(codes, (k,), stride, mask_positions, with_strand="forward")[k]
    return h[0].T, h[1].T, h[2].T


def canonical_hashes(
    codes: jnp.ndarray, k: int, stride: int, mask_positions: Sequence[int] | None = None
):
    """Canonical 64-bit hashes of every owned window (spaced-seed hashes when
    ``mask_positions`` is given): (hi, lo, valid), each [B, stride]. Parity
    surface for ntHashIterator + NTC64 / stHashIterator + NTMS64."""
    ch, cl, valid = window_hashes(codes, (k,), stride, mask_positions)[k]
    return ch.T, cl.T, valid.T


def canonical_hashes_strand(
    codes: jnp.ndarray, k: int, stride: int, mask_positions: Sequence[int] | None = None
):
    """Strand-aware canonical hashes — NTMC64-with-hStn parity
    (nthash.hpp:495-534): (hi, lo, hstn, valid), each [B, stride], where
    hstn is True iff the reverse-complement strand's hash was selected
    (`rhVal < fhVal`; ties select forward). Extra hashes for Bloom-filter
    consumers derive via :func:`multi_hashes` exactly as the reference's
    NTMC64 does from its bVal."""
    ch, cl, valid, stn = _hash_backend()(
        codes, (k,), stride, mask_positions, with_strand=True
    )[k]
    return ch.T, cl.T, stn.T, valid.T


def make_sketch_emit(s_bits: int, r_bits: int):
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
    sentinel = np.int32(2 * r_buck)

    def emit(ch, cl, valid):
        s0 = (ch >> np.uint32(31 - s_bits)) == np.uint32(1)
        s1 = (ch >> np.uint32(32 - s_bits)) == np.uint32(s_mask)
        bucket = (cl & np.uint32(r_buck - 1)).astype(jnp.int32)
        bucket = bucket + jnp.where(s1, np.int32(r_buck), np.int32(0))
        return jnp.where(valid & (s0 | s1), bucket, sentinel)

    return emit


def _hash_backend():
    """Kernel backend selection: NTCARD_KERNEL=prefix selects the rotated-
    prefix-scan formulation (window_hashes); default is window doubling
    (fewer ops, no scans). Both are bit-identical
    (tests/test_kernel_vs_oracle.py)."""
    import os

    if os.environ.get("NTCARD_KERNEL", "doubling") == "prefix":
        return window_hashes
    return window_hashes_doubling


def sketch_scan(
    codes: jnp.ndarray,
    ks: Sequence[int],
    stride: int,
    s_bits: int,
    r_bits: int,
    mask_positions: Sequence[int] | None = None,
    packed: bool = False,
) -> Tuple[Dict[int, jnp.ndarray], Dict[int, jnp.ndarray]]:
    """Fused hash+sample kernel for ntcard: per k, a flat [S*B] int32 array of
    count-table indices (sentinel 2^(r_bits+1) where no update) plus the exact
    valid-window count (F1 contribution)."""
    emit = make_sketch_emit(s_bits, r_bits)
    hashes = _hash_backend()(codes, tuple(ks), stride, mask_positions, packed=packed)
    idx = {}
    f1 = {}
    for k in ks:
        ch, cl, valid = hashes[k]
        idx[k] = emit(ch, cl, valid).reshape(-1)
        f1[k] = jnp.sum(valid.astype(jnp.int32))
    return idx, f1


def multi_hashes(h_hi, h_lo, k: int, m: int):
    """NTM64/NTE64 multi-hash derivation (nthash.hpp:307-390): extra hashes
    h_i = bVal * (i ^ k*multiSeed); h_i ^= h_i >> multiShift, for i in
    [1, m). Returns lists of m (hi, lo) pairs with element 0 the base hash.

    ntcard itself uses h=1; this exists for capability parity with ntHash's
    Bloom-filter consumers. u64 multiply emulated in 16-bit limbs."""
    from ntcard_tpu.ops.rotations import _mulhi

    outs = [(h_hi, h_lo)]
    s = np.uint32(C.MULTISHIFT)
    s_inv = np.uint32(32 - C.MULTISHIFT)
    for i in range(1, m):
        c = (i ^ (k * C.MULTISEED)) & C.MASK64
        c_hi, c_lo = C.split_u64(c)
        # 64x64 -> low 64 bits
        t_lo = h_lo * np.uint32(c_lo)
        carry = _mulhi(h_lo, np.uint32(c_lo >> 16), np.uint32(c_lo & 0xFFFF))
        t_hi = h_lo * np.uint32(c_hi) + h_hi * np.uint32(c_lo) + carry
        # t ^= t >> 27:  (hi,lo) >> 27 == (hi >> 27, (lo >> 27) | (hi << 5))
        outs.append((t_hi ^ (t_hi >> s), t_lo ^ ((t_lo >> s) | (t_hi << s_inv))))
    return outs


def make_hll_emit(n_bits: int):
    """nthll's register update inputs (nthll.cpp:92-97): register index =
    hVal & (2^n_bits - 1); value = clz64(hVal & ~(2^n_bits-1)), or 0 when that
    masked value is 0 or the window is invalid (max with 0 is a no-op)."""
    if not (1 <= n_bits <= 31):
        raise ValueError(f"n_bits must be in [1,31], got {n_bits}")
    mask = np.uint32((1 << n_bits) - 1) if n_bits < 32 else np.uint32(0xFFFFFFFF)

    def emit(ch, cl, valid):
        lo_m = cl & ~mask
        clz = jnp.where(
            ch != 0,
            jax.lax.clz(ch),
            np.uint32(32) + jax.lax.clz(lo_m),
        ).astype(jnp.int32)
        nonzero = (ch != 0) | (lo_m != 0)
        run0 = jnp.where(valid & nonzero, clz, np.int32(0))
        reg = (cl & mask).astype(jnp.int32)
        return reg, run0

    return emit


def hll_scan(codes: jnp.ndarray, k: int, stride: int, n_bits: int, packed: bool = False):
    """Fused hash+HLL kernel for nthll: flat [S*B] (register index, run0)."""
    emit = make_hll_emit(n_bits)
    ch, cl, valid = _hash_backend()(codes, (k,), stride, packed=packed)[k]
    reg, run0 = emit(ch, cl, valid)
    return reg.reshape(-1), run0.reshape(-1)
