"""Split-rotation P^n on (hi, lo) uint32 pairs.

P = srol is ntHash's split rotation: a 33-bit ring in u64 bits 0..32 and a
31-bit ring in bits 33..63 (reference nthash.hpp:185-217). The
rotated-prefix-XOR hash formulation (ops/nthash.py) needs P^n both with a
fixed amount (:func:`srol_const`) and with *per-position* amounts
(:func:`srol_var_iota`); the per-position amounts derive from the static
position index.

Ring mapping for the (hi, lo) pair: lo = u64 bits 0..31, hi = bits 32..63;
the 33-bit ring is (hi&1, lo), the 31-bit ring is hi>>1.

Rules these implementations keep, so the hash chain stays one elementwise
fusion of constant-amount operations: no gathers, no variable-amount shifts,
no broadcasts of sub-shaped constant arrays, and scalar constants as numpy
literals (a committed 0-d device array becomes a buffer parameter, turning
constant shifts into variable ones).
"""

from __future__ import annotations

from ntcard_tpu import _jax_config  # noqa: F401  (platform/cache config before backend init)
import jax
import jax.numpy as jnp
import numpy as np

MASK31 = np.uint32(0x7FFFFFFF)
_M16 = np.uint32(0xFFFF)
_U16 = np.uint32(16)


def rot_amounts(n: np.ndarray):
    """Static helper: (n mod 33, n mod 31) as uint32 arrays for any integer
    array n (negative allowed)."""
    n = np.asarray(n, dtype=np.int64)
    return (n % 33).astype(np.uint32), (n % 31).astype(np.uint32)


def _pow2_u32(n):
    """2^n as uint32 for int32 n in [0, 31], with no variable shifts, no
    gathers, no multiplies: build the float32 bit pattern (exponent 127+n,
    zero mantissa) with a constant shift, bitcast, and convert — exact for
    powers of two."""
    f = jax.lax.bitcast_convert_type(((n + 127) << 23).astype(jnp.int32), jnp.float32)
    return jax.lax.convert_element_type(f, jnp.uint32)


def _mulhi(a, ch, cl):
    """Exact high 32 bits of a * c, with c pre-split as (ch, cl) = (c >> 16,
    c & 0xFFFF). Standard 16-bit-limb schoolbook product."""
    al = a & _M16
    ah = a >> _U16
    t1 = ah * cl + ((al * cl) >> _U16)
    t2 = al * ch + (t1 & _M16)
    return ah * ch + (t1 >> _U16) + (t2 >> _U16)


def srol_var_iota(hi, lo, n33, n31):
    """P^n elementwise with per-element amounts given as residue arrays
    n33 = n mod 33 (int32, [0,32]) and n31 = n mod 31 (int32, [0,30]),
    typically derived from a positional iota.

    A left-rotation is a multiply by 2^n (low part) plus an exact
    multiply-high (wrapped part); the power-of-two multipliers are
    synthesized from the residues with the float-exponent bit trick.

    31-bit ring: rot = (r * 2^n31) & M31  |  mulhi(r, 2^(n31+1)).
    33-bit ring, X = (b:bit32, a:low32), n = n33 >= 1:
      T2    = X >> (33-n) = mulhi(a, 2^(n-1)) | b*2^(n-1)
      low32 = (a * 2^n) | T2
      bit32 = bit (32-n) of a
    n33 == 0 is the identity (the zeroed constants make each term vanish)."""
    z = jnp.zeros_like(hi)
    c31 = _pow2_u32(n31)
    c31b = _pow2_u32(n31 + 1)  # n31+1 in [1,31]: always in range
    cl33 = jnp.where(n33 == 32, z, _pow2_u32(jnp.minimum(n33, 31)))
    cd33 = jnp.where(n33 == 0, z, _pow2_u32(jnp.maximum(n33 - 1, 0)))
    m32 = jnp.where(n33 == 0, z, _pow2_u32(32 - jnp.maximum(n33, 1)))

    one = np.uint32(1)
    r31 = hi >> one
    rot31 = ((r31 * c31) & MASK31) | _mulhi(r31, c31b >> _U16, c31b & _M16)
    a = lo
    b = hi & one
    t2 = _mulhi(a, cd33 >> _U16, cd33 & _M16) | (b * cd33)
    low = (a * cl33) | t2
    bit32 = ((a & m32) != 0).astype(jnp.uint32) | jnp.where(n33 == 0, b, z)
    return (rot31 << one) | bit32, low


def srol_const(hi, lo, n: int):
    """P^n with a fixed Python-int amount: constant shifts only."""
    n33 = n % 33
    n31 = n % 31
    one = np.uint32(1)
    r31 = hi >> one
    if n31:
        rot31 = ((r31 << np.uint32(n31)) | (r31 >> np.uint32(31 - n31))) & MASK31
    else:
        rot31 = r31
    a = lo
    b = hi & one
    if n33 == 0:
        low, bit32 = a, b
    else:
        s = 33 - n33
        if s == 32:
            t2 = b
        else:
            t2 = (a >> np.uint32(s)) | (b << np.uint32(n33 - 1))
        low = ((a << np.uint32(n33)) if n33 < 32 else jnp.zeros_like(a)) | t2
        bit32 = (a >> np.uint32(32 - n33)) & one
    return (rot31 << one) | bit32, low
