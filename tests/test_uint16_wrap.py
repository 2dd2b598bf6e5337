"""uint16 counter wraparound semantics (SURVEY.md §4d): the reference's
count table is uint16 and wraps mod 2^16 on overflow (ntcard.cpp:142 ++ on
uint16_t). We accumulate in int32 and wrap at finalization — the results
must be identical because addition commutes mod 2^16."""

import numpy as np

import jax.numpy as jnp

from ntcard_tpu.io.packing import aligned_stride, pack_records
from ntcard_tpu.models.sketch import CountTableSketch
from ntcard_tpu.ops.nthash_ref import kmer_hashes

S_BITS, R_BITS = 1, 1  # high sample rate so a repeated k-mer actually counts


def _sampled_kmer():
    """Find a 12-mer whose canonical hash passes one of the sample tests at
    s_bits=1 (sample1: top bit 0 — rate 1/2)."""
    import itertools

    for cand in itertools.product("ACGT", repeat=6):
        seq = "".join(cand) * 2
        h = kmer_hashes(seq, 12)[0][1]
        s0 = (h >> 62) == 1
        s1 = (h >> 63) == 0  # sMask = 0
        if s0 or s1:
            sample = 1 if s1 else 0
            return seq, h, sample
    raise AssertionError("no sampled 12-mer found")


def test_wraparound_matches_mod_65536():
    seq, h, sample = _sampled_kmer()
    n_occurrences = 70_000  # > 65535: must wrap
    bucket = h & 1

    sketch = CountTableSketch((12,), S_BITS, R_BITS, stride=aligned_stride(128, 12))
    records = [seq.encode()] * n_occurrences
    for batch in pack_records(records, chunk_len=128, batch_rows=128, kmax=12):
        sketch.update(batch)
    state = sketch.finalize(return_table=True)

    table = state[12]["table"]
    assert table.dtype == np.uint16
    assert table[sample, bucket] == n_occurrences % 65536  # wrapped
    assert state[12]["f1"] == n_occurrences
    # the counter-value histogram sees the wrapped value
    assert state[12]["hist"][sample][n_occurrences % 65536] >= 1


def test_small_bin_hist_matches_scatter():
    """The device finalize histogram (models/sketch._hist_row: zeros by a
    reduction, 1 <= v < nbins scattered) must equal the full 65536-bin
    histogram on the bins it reports, including mod-2^16 wrap of large
    counts."""
    import numpy as np

    from ntcard_tpu.models.sketch import _counter_hists_device

    rng = np.random.default_rng(3)
    r_buck = 1 << 10
    # values spanning wrap boundaries and both samples; sentinel col appended
    t = rng.integers(0, 1 << 18, size=(2, 2 * r_buck + 1), dtype=np.int32)
    full = np.asarray(_counter_hists_device(t, r_buck, 65536))
    for nbins in (1, 66, 1001, 1025):
        small = np.asarray(_counter_hists_device(t, r_buck, nbins))
        np.testing.assert_array_equal(small, full[:, :, :nbins])


def test_dense_row_hist_fallback():
    """A (deep-coverage) row in which every bucket is nonzero and in range —
    2^18 of them, the size that once overflowed a compaction buffer — must
    come back exact from the one-pass device histogram."""
    import numpy as np

    from ntcard_tpu.models.sketch import _counter_hists_device

    r_buck = 1 << 18
    rng = np.random.default_rng(9)
    t = rng.integers(1, 64, size=(1, 2 * r_buck + 1), dtype=np.int32)
    got = np.asarray(_counter_hists_device(t, r_buck, 66))
    want = np.stack(
        [
            np.bincount(np.minimum(t[0, s * r_buck : (s + 1) * r_buck], 66), minlength=67)[:66]
            for s in range(2)
        ]
    )
    np.testing.assert_array_equal(got[0], want)
