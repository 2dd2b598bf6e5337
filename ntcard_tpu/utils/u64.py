"""uint64 emulation as (hi32, lo32) uint32 pairs.

jax x64 mode stays off (_jax_config.py), so every 64-bit hash value in the
device kernels is carried as two uint32 arrays. The ntHash split-rotation (a 33-bit
ring in bits 0..32 and a 31-bit ring in bits 33..63, reference
/root/reference/vendor/ntHash/nthash.hpp:185-217) maps onto a handful of
uint32 shifts/xors per step.

All functions are shape-polymorphic elementwise jnp ops (usable inside jit,
scan and shard_map alike).

IMPORTANT dtype rule: scalar constants must be Python/numpy literals, never
``jnp.uint32(...)`` module-level arrays — a committed device array captured
by a jit is lifted as a buffer parameter instead of an inline literal, which
turns every shift into a variable-amount shift.
"""

from __future__ import annotations

from ntcard_tpu import _jax_config  # noqa: F401  (platform/cache config before backend init)
import jax.numpy as jnp
import numpy as np

_U1 = np.uint32(1)
_U31 = np.uint32(31)


def srol(hi, lo):
    """Split-rotate left by one: rol1 then swap bits 0<->33.

    Semantics of nthash.hpp:186-211 (rol1 + swapbits033)."""
    nh = (hi << _U1) | (lo >> _U31)
    nl = (lo << _U1) | (hi >> _U31)
    # bit0 (nl&1) and bit33 (bit1 of nh) swap; xor by their difference.
    x = (nl ^ (nh >> _U1)) & _U1
    return nh ^ (x << _U1), nl ^ x


def sror(hi, lo):
    """Split-rotate right by one: ror1 then swap bits 32<->63
    (nthash.hpp:191-217). Inverse of :func:`srol`."""
    nh = (hi >> _U1) | (lo << _U31)
    nl = (lo >> _U1) | (hi << _U31)
    # bit32 (nh&1) and bit63 (bit31 of nh) swap.
    x = (nh ^ (nh >> _U31)) & _U1
    return nh ^ (x | (x << _U31)), nl


def lt(a_hi, a_lo, b_hi, b_lo):
    """Unsigned 64-bit a < b."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def min64(a_hi, a_lo, b_hi, b_lo):
    """Unsigned 64-bit elementwise min, returned as (hi, lo)."""
    sel = lt(a_hi, a_lo, b_hi, b_lo)
    return jnp.where(sel, a_hi, b_hi), jnp.where(sel, a_lo, b_lo)


def lut5(code, table5):
    """Lookup into a 5-entry constant table by base code (0..4) as an explicit
    select chain — guaranteed to stay elementwise on the VPU (no gather).

    ``table5`` is a length-5 numpy uint32 array (host constant)."""
    out = jnp.full(code.shape, np.uint32(table5[4]))
    for i in range(4):
        out = jnp.where(code == i, np.uint32(table5[i]), out)
    return out
