"""Device-resident k-mer Bloom filter over the NTM64 multi-hash derivation.

The reference vendors a Bloom filter as ntHash's flagship consumer
(vendor/ntHash/lib/BloomFilter.hpp:37-294; nttest's FPR sweeps,
nttest.cpp:443-494). On the device the filter is a byte-per-bit uint8 array:
insert is a scatter-max of 1 (bitwise OR over {0,1} — a word-packed filter
under scatter-max would keep only the largest bit per word per pass), query
is a gather + AND across the h derived hash positions. Gathers stay out of
the ntcard hot path (ops/rotations.py) but are the honest primitive
for membership queries; this is a capability surface for downstream ntHash
consumers, not part of the cardinality pipeline.

Byte-per-bit spends 8x the reference's memory for the same m; callers size
``m_bits`` accordingly (the FPR formula is identical).
"""

from __future__ import annotations

from ntcard_tpu import _jax_config  # noqa: F401  (platform/cache config before backend init)
import jax.numpy as jnp
import numpy as np

from ntcard_tpu.ops.nthash import canonical_hashes, multi_hashes


class BloomFilter:
    """Canonical k-mer Bloom filter: 2^m_bits slots, h hashes per k-mer
    (base canonical hash + NTE64-derived extras, nthash.hpp:325-342)."""

    def __init__(self, k: int, m_bits: int, n_hashes: int = 3):
        if not (3 <= m_bits <= 30):
            raise ValueError(f"m_bits must be in [3, 30], got {m_bits}")
        if n_hashes < 1:
            raise ValueError("n_hashes must be >= 1")
        self.k = k
        self.m_bits = m_bits
        self.n_hashes = n_hashes
        self.slots = jnp.zeros((1 << m_bits,), jnp.uint8)
        self.n_inserted = 0

    def _positions(self, codes: np.ndarray, stride: int):
        """[B, L] uint8 codes -> list of n_hashes [B, stride] int32 slot
        indices (-1 where the window is invalid) + the validity mask."""
        hi, lo, valid = canonical_hashes(codes, self.k, stride)
        mask = np.uint32((1 << self.m_bits) - 1)
        out = []
        for _h, l in multi_hashes(hi, lo, self.k, self.n_hashes):
            idx = (l & mask).astype(jnp.int32)
            out.append(jnp.where(valid, idx, np.int32(-1)))
        return out, valid

    def insert_batch(self, codes: np.ndarray, stride: int) -> int:
        """Insert every valid window of a packed [B, L] code batch
        (io/packing layout: windows starting in [0, stride) per row).
        Returns the number of k-mers inserted."""
        pos, valid = self._positions(codes, stride)
        slots = self.slots
        for p in pos:
            # -1 (invalid) wraps to the last slot under .at[] NumPy
            # semantics; route it out of bounds so drop-mode discards it
            idx = jnp.where(p < 0, np.int32(1 << self.m_bits), p)
            slots = slots.at[idx.reshape(-1)].max(np.uint8(1), mode="drop")
        self.slots = slots
        n = int(np.asarray(valid.sum()))
        self.n_inserted += n
        return n

    def contains_batch(self, codes: np.ndarray, stride: int):
        """-> (present bool [B, stride], valid bool [B, stride]) — present
        is meaningful only where valid."""
        pos, valid = self._positions(codes, stride)
        present = valid
        for p in pos:
            present = present & (self.slots[jnp.maximum(p, 0)] == 1)
        return np.asarray(present), np.asarray(valid)

    def fpr_theory(self) -> float:
        """Expected false-positive rate for the current load
        (BloomFilter.hpp semantics: (1 - e^(-h n / m))^h)."""
        m = float(1 << self.m_bits)
        return float(
            (1.0 - np.exp(-self.n_hashes * self.n_inserted / m)) ** self.n_hashes
        )

    def store_raw(self, path: str) -> None:
        """Reference BloomFilter file format (BloomFilter.hpp:260-264): the
        raw bit array, (m + 7)/8 bytes, MSB-first within each byte (the
        reference sets bit ``1 << (7 - hLoc % 8)``, which is exactly
        np.packbits' big-endian order). For power-of-two m the reference's
        ``hVal % m`` equals our ``lo & (m - 1)``, so a filter built here
        from the same k-mers is BYTE-IDENTICAL to one stored by the
        reference's canonical ``insert`` (tests/test_bloom.py interop)."""
        with open(path, "wb") as f:
            f.write(np.packbits(np.asarray(self.slots)).tobytes())

    @classmethod
    def load_raw(cls, path: str, k: int, m_bits: int, n_hashes: int = 3) -> "BloomFilter":
        """Load a reference-format raw bit array (the load constructor of
        BloomFilter.hpp:40-47 — the file carries no header, so k/m/h come
        from the caller, as in the reference)."""
        self = cls(k, m_bits, n_hashes)
        raw = np.fromfile(path, dtype=np.uint8, count=(1 << m_bits) // 8)
        self.slots = jnp.asarray(np.unpackbits(raw)[: 1 << m_bits].astype(np.uint8))
        return self

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            slots=np.packbits(np.asarray(self.slots)),
            k=self.k,
            m_bits=self.m_bits,
            n_hashes=self.n_hashes,
            n_inserted=self.n_inserted,
        )

    @classmethod
    def load(cls, path: str) -> "BloomFilter":
        z = np.load(path)
        self = cls(int(z["k"]), int(z["m_bits"]), int(z["n_hashes"]))
        self.slots = jnp.asarray(
            np.unpackbits(z["slots"])[: 1 << self.m_bits].astype(np.uint8)
        )
        self.n_inserted = int(z["n_inserted"])
        return self
