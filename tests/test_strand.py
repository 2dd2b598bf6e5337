"""Strand-aware canonical hashing (NTMC64-with-hStn parity,
nthash.hpp:495-534): both hash-kernel backends' hStn output must equal the
scalar oracle's `rhVal < fhVal` on every valid window, and the hash must
stay the plain canonical value."""

import numpy as np
import pytest

from ntcard_tpu.io.packing import aligned_stride, pack_records
from ntcard_tpu.ops import nthash_ref as R
from ntcard_tpu.ops.nthash import canonical_hashes_strand
from tests.test_kernel_vs_oracle import random_records

CHUNK, K = 192, 21
STRIDE = aligned_stride(CHUNK, K)


@pytest.mark.parametrize("backend", ["doubling", "prefix"])
def test_strand_matches_oracle(backend, monkeypatch):
    monkeypatch.setenv("NTCARD_KERNEL", backend)
    records = random_records(seed=31, n=60, maxlen=250)
    # oracle: per-record (hash, hstn) multisets over valid windows
    want = []
    for rec in records:
        codes = R.seq_to_codes(rec)
        for pos in range(max(0, len(codes) - K + 1)):
            win = codes[pos : pos + K]
            if any(c == R.N for c in win):
                continue
            want.append(R.ntmc64_strand(win, K))
    got = []
    for b in pack_records(records, CHUNK, 128, K):
        hi, lo, stn, valid = canonical_hashes_strand(b, K, STRIDE)
        hi, lo = np.asarray(hi), np.asarray(lo)
        stn, valid = np.asarray(stn), np.asarray(valid)
        for r, c in zip(*np.nonzero(valid)):
            got.append(((int(hi[r, c]) << 32) | int(lo[r, c]), bool(stn[r, c])))
    assert sorted(got) == sorted(want)


def test_strand_tie_is_forward():
    """A palindromic k-mer (fhVal == rhVal) must report hStn=False — the
    reference's strict `rhVal < fhVal` (nthash.hpp:512)."""
    # revcomp(ACGT-palindrome): e.g. "ACGT" at k=4 is its own revcomp
    codes = R.seq_to_codes("ACGT")
    h, stn = R.ntmc64_strand(codes, 4)
    assert R.ntf64(codes, 4) == R.ntr64(codes, 4)
    assert stn is False and h == R.ntf64(codes, 4)


@pytest.mark.parametrize("backend", ["doubling", "prefix"])
def test_nts64_forward_spaced_matches_oracle(backend, monkeypatch):
    """spaced_hashes_forward — NTS64 / ssHashIterator parity
    (nthash.hpp:550-572): forward-strand spaced hashes vs the scalar
    oracle over every valid window."""
    from ntcard_tpu.ops.nthash import spaced_hashes_forward

    monkeypatch.setenv("NTCARD_KERNEL", backend)
    k, gap = 13, (4, 5, 6)
    records = random_records(seed=41, n=50, maxlen=220)
    want = []
    for rec in records:
        codes = R.seq_to_codes(rec)
        for pos in range(max(0, len(codes) - k + 1)):
            win = codes[pos : pos + k]
            if any(c == R.N for c in win):
                continue
            want.append(R.nts64(win, k, gap))
    stride = aligned_stride(CHUNK, k)
    got = []
    for b in pack_records(records, CHUNK, 128, k):
        hi, lo, valid = spaced_hashes_forward(b, k, stride, gap)
        hi, lo, valid = np.asarray(hi), np.asarray(lo), np.asarray(valid)
        for r, c in zip(*np.nonzero(valid)):
            got.append((int(hi[r, c]) << 32) | int(lo[r, c]))
    assert sorted(got) == sorted(want)
