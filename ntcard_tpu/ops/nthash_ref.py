"""Pure-Python scalar reference implementation of ntHash.

This is the *oracle* the vectorized device kernels are tested against. It mirrors
the mathematical definition of ntHash (reference: /root/reference/vendor/ntHash/
nthash.hpp) but is written from the ring-rotation algebra in
:mod:`ntcard_tpu.constants`, not transliterated.

Definitions (P = srol, the split-rotation permutation; s(b) = per-base seed):

  forward hash of window w[0..k):   F = XOR_{j} P^{k-1-j}( s(w[j]) )
  reverse hash of window w[0..k):   R = XOR_{j} P^{j}( s(comp(w[j])) )
  canonical hash:                   min(F, R) as u64

Rolling one base (out = leaving base, in = entering base):

  F' = P(F)  ^ s(in)        ^ P^k(s(out))          (nthash.hpp:242-248)
  R' = P^-1( R ^ P^k(s(comp(in))) ^ s(comp(out)) ) (nthash.hpp:251-257)

Both recurrences are exactly windowed (each base's contribution is added on
entry and removed bit-exactly on exit, and N contributes 0), so rolling
"through" an N region converges back to the from-scratch value as soon as the
window is N-free — the device kernels rely on this.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

from ntcard_tpu.constants import (
    ASCII_TO_CODE,
    COMP_CODE,
    MASK64,
    MULTISEED,
    MULTISHIFT,
    N,
    SEEDS,
    rot_seed,
    srol,
    sror,
)


def seq_to_codes(seq: str | bytes) -> List[int]:
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    return [int(ASCII_TO_CODE[b]) for b in seq]


def ntf64(codes: Sequence[int], k: int) -> int:
    """Forward-strand base hash of codes[0..k) (nthash.hpp:220-228)."""
    h = 0
    for j in range(k):
        h = srol(h) ^ SEEDS[codes[j]]
    return h


def ntr64(codes: Sequence[int], k: int) -> int:
    """Reverse-complement base hash of codes[0..k) (nthash.hpp:231-239)."""
    h = 0
    for j in range(k):
        h = srol(h) ^ SEEDS[COMP_CODE[codes[k - 1 - j]]]
    return h


def ntc64(codes: Sequence[int], k: int) -> int:
    """Canonical base hash: min(forward, reverse-complement)."""
    return min(ntf64(codes, k), ntr64(codes, k))


def nts64(codes: Sequence[int], k: int, mask_positions: Sequence[int]) -> int:
    """Forward-strand spaced-seed hash — NTS64 (nthash.hpp:550-561): the
    forward base hash with each don't-care position p's rotated seed
    contribution stripped."""
    h = ntf64(codes, k)
    for p in mask_positions:
        h ^= rot_seed(codes[p], k - 1 - p)
    return h


def ntmc64_strand(codes: Sequence[int], k: int) -> Tuple[int, bool]:
    """Strand-aware canonical hash — NTMC64-with-hStn (nthash.hpp:495-521):
    (canonical hash, hStn) with hStn = rhVal < fhVal (ties are forward)."""
    f, r = ntf64(codes, k), ntr64(codes, k)
    return (r, True) if r < f else (f, False)


def ntf64_roll(fh: int, k: int, out_code: int, in_code: int) -> int:
    """Roll the forward hash one base to the right."""
    return srol(fh) ^ SEEDS[in_code] ^ rot_seed(out_code, k)


def ntr64_roll(rh: int, k: int, out_code: int, in_code: int) -> int:
    """Roll the reverse-complement hash one base to the right."""
    return sror(rh ^ rot_seed(COMP_CODE[in_code], k) ^ SEEDS[COMP_CODE[out_code]])


def nte64(h: int, k: int, i: int) -> int:
    """i-th extra hash derived from base hash h (nthash.hpp:337-342)."""
    t = (h * ((i ^ (k * MULTISEED)) & MASK64)) & MASK64
    return t ^ (t >> MULTISHIFT)


def multi_hashes(h: int, k: int, m: int) -> List[int]:
    """[h, NTE64(h,k,1), ..., NTE64(h,k,m-1)] (nthash.hpp:325-334)."""
    return [h] + [nte64(h, k, i) for i in range(1, m)]


def kmer_hashes(seq: str | bytes, k: int) -> List[Tuple[int, int]]:
    """Iterator semantics of the reference ntHashIterator: yields
    (position, canonical hash) for every N-free window, skipping windows that
    contain a non-ACGT/U character (ntHashIterator.hpp:59-86).

    Implemented straightforwardly (from-scratch per window); used as the
    ground truth for both the rolling property and the batch kernels.
    """
    codes = seq_to_codes(seq)
    out = []
    if k == 0 or len(codes) < k:
        return out
    for pos in range(len(codes) - k + 1):
        win = codes[pos : pos + k]
        if any(c == N for c in win):
            continue
        out.append((pos, ntc64(win, k)))
    return out


def kmer_hashes_rolling(seq: str | bytes, k: int) -> List[Tuple[int, int]]:
    """Same result as :func:`kmer_hashes`, computed with the rolling
    recurrences rolled blindly through N bases (validity masked afterwards).
    Exercises the self-correcting property the device kernel depends on."""
    codes = seq_to_codes(seq)
    out = []
    if k == 0 or len(codes) < k:
        return out
    fh = rh = 0
    runlen = 0
    for e, c in enumerate(codes):
        out_code = codes[e - k] if e >= k else N
        fh = ntf64_roll(fh, k, out_code, c)
        rh = ntr64_roll(rh, k, out_code, c)
        runlen = runlen + 1 if c != N else 0
        if e >= k - 1 and runlen >= k:
            out.append((e - k + 1, min(fh, rh)))
    return out


# ---------------------------------------------------------------------------
# Spaced seeds
# ---------------------------------------------------------------------------


def parse_seed(seed_strings: Iterable[str]) -> List[List[int]]:
    """Positions of non-'1' characters per seed pattern
    (stHashIterator.hpp:23-33)."""
    return [[j for j, ch in enumerate(s) if ch != "1"] for s in seed_strings]


def masked_hash(codes: Sequence[int], k: int, mask_positions: Sequence[int]) -> int:
    """Spaced-seed canonical hash of codes[0..k): the full-k forward/reverse
    hashes with the masked positions' contributions XORed out, then min
    (nthash.hpp:575-602, NTMS64 semantics with m=1)."""
    fs = ntf64(codes, k)
    rs = ntr64(codes, k)
    for p in mask_positions:
        fs ^= rot_seed(codes[p], k - 1 - p)
        rs ^= rot_seed(COMP_CODE[codes[p]], p)
    return min(fs, rs)


def spaced_kmer_hashes(
    seq: str | bytes, k: int, mask_positions: Sequence[int]
) -> List[Tuple[int, int]]:
    """(position, spaced canonical hash) for every N-free window.

    Note the reference skips windows containing N *anywhere* (including masked
    positions) — stHashIterator::init uses the full-k N scan."""
    codes = seq_to_codes(seq)
    out = []
    if k == 0 or len(codes) < k:
        return out
    for pos in range(len(codes) - k + 1):
        win = codes[pos : pos + k]
        if any(c == N for c in win):
            continue
        out.append((pos, masked_hash(win, k, mask_positions)))
    return out
