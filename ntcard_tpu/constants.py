"""ntHash constants and derived rotation tables.

The four per-base 64-bit seeds and the multi-hash constants are the frozen,
published ntHash constants (reference: /root/reference/vendor/ntHash/nthash.hpp:22-29).
They are *data*, not code: every downstream hash value depends on them bit-for-bit,
so they must match exactly. (The reference also ships the generator that
once produced such seeds — lib/seedgen.cpp:24-159 — but the published
values do not even satisfy its balance invariants any more: row popcounts
are 33/25/24/30, not 32 each, and per-bit column sums range 0..4, not the
generator's exactly-2-of-4 — measured round 5. Regeneration is therefore
impossible by construction, not merely undesirable; bit-exact copying is
the only parity-correct treatment of these constants.)

Everything else in this module is derived: ntHash treats a 64-bit word as two
independent cyclic rings — a 33-bit ring in bits [0..32] and a 31-bit ring in
bits [33..63] (nthash.hpp:185-217). The reference ships precomputed per-base
rotation tables (A33r/A31l/... and msTab33r/msTab31l); we derive the same values
programmatically from the seeds, which both avoids copying the tables and
documents what they actually are: ``rot_seed(b, n) == srol^n(seed(b))``.

Base coding used throughout the framework: 0=A, 1=C, 2=G, 3=T(=U), 4=N/other.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1
MASK33 = (1 << 33) - 1
MASK31 = (1 << 31) - 1

# Frozen ntHash seed constants (nthash.hpp:25-29).
SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456
SEED_N = 0x0000000000000000

# Multi-hash derivation constants (nthash.hpp:19-22).
MULTISHIFT = 27
MULTISEED = 0x90B45D39FB6DA1FA

# Base codes.
A, C, G, T, N = 0, 1, 2, 3, 4
NUM_CODES = 5  # A, C, G, T, N

# seeds indexed by base code; N hashes to 0.
SEEDS = (SEED_A, SEED_C, SEED_G, SEED_T, SEED_N)

# complement code: A<->T, C<->G, N->N.
COMP_CODE = (T, G, C, A, N)


def srol(v: int) -> int:
    """Split-rotate left by 1: rotate the 33-bit ring (bits 0..32) and the
    31-bit ring (bits 33..63) left by one position each.

    Equivalent to the reference's rol1 followed by swapbits033
    (nthash.hpp:186-211)."""
    v &= MASK64
    lo33 = v & MASK33
    hi31 = v >> 33
    lo33 = ((lo33 << 1) | (lo33 >> 32)) & MASK33
    hi31 = ((hi31 << 1) | (hi31 >> 30)) & MASK31
    return (hi31 << 33) | lo33


def sror(v: int) -> int:
    """Split-rotate right by 1 (inverse of srol).

    Equivalent to the reference's ror1 followed by swapbits3263
    (nthash.hpp:191-217)."""
    v &= MASK64
    lo33 = v & MASK33
    hi31 = v >> 33
    lo33 = ((lo33 >> 1) | (lo33 << 32)) & MASK33
    hi31 = ((hi31 >> 1) | (hi31 << 30)) & MASK31
    return (hi31 << 33) | lo33


def srol_n(v: int, n: int) -> int:
    """srol applied n times, in O(1): rotate each ring by n mod its width."""
    v &= MASK64
    lo33 = v & MASK33
    hi31 = v >> 33
    s33 = n % 33
    s31 = n % 31
    lo33 = ((lo33 << s33) | (lo33 >> (33 - s33))) & MASK33 if s33 else lo33
    hi31 = ((hi31 << s31) | (hi31 >> (31 - s31))) & MASK31 if s31 else hi31
    return (hi31 << 33) | lo33


def rot_seed(code: int, n: int) -> int:
    """srol^n(seed(code)) — the per-base 'rotation table' entry.

    Matches the reference's ``msTab31l[ch][n%31] | msTab33r[ch][n%33]``
    (nthash.hpp:115-183) for the character with this base code."""
    return srol_n(SEEDS[code], n)


# ---------------------------------------------------------------------------
# ASCII -> base-code table (seedTab semantics, nthash.hpp:31-64):
# 'A'/'a' -> A, 'C'/'c' -> C, 'G'/'g' -> G, 'T'/'t'/'U'/'u' -> T,
# everything else -> N.  (RNA U is hashed as T.)
# ---------------------------------------------------------------------------
ASCII_TO_CODE = np.full(256, N, dtype=np.uint8)
for _chars, _code in (
    ("Aa", A),
    ("Cc", C),
    ("Gg", G),
    ("TtUu", T),
):
    for _ch in _chars:
        ASCII_TO_CODE[ord(_ch)] = _code
del _chars, _code, _ch


def split_u64(v: int) -> tuple[int, int]:
    """u64 -> (hi32, lo32)."""
    v &= MASK64
    return v >> 32, v & 0xFFFFFFFF


def seed_tables_u32(k: int):
    """Build the (5,)-entry uint32 hi/lo lookup tables the device kernel needs
    for a given k:

    - seed_f:  seed(b)                       (incoming base, forward strand)
    - rotk_f:  srol^k(seed(b))               (outgoing-base removal, forward)
    - seed_c:  seed(comp(b))                 (outgoing base, reverse strand)
    - rotk_c:  srol^k(seed(comp(b)))         (incoming-base removal, reverse)

    Returns a dict of numpy arrays: {name}_hi / {name}_lo, each shape (5,) uint32.
    """
    tabs = {}

    def put(name, vals):
        his, los = zip(*(split_u64(v) for v in vals))
        tabs[name + "_hi"] = np.asarray(his, dtype=np.uint32)
        tabs[name + "_lo"] = np.asarray(los, dtype=np.uint32)

    put("seed_f", [SEEDS[b] for b in range(NUM_CODES)])
    put("rotk_f", [rot_seed(b, k) for b in range(NUM_CODES)])
    put("seed_c", [SEEDS[COMP_CODE[b]] for b in range(NUM_CODES)])
    put("rotk_c", [rot_seed(COMP_CODE[b], k) for b in range(NUM_CODES)])
    return tabs
