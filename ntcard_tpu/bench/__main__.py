"""Benchmark CLI — the nttest analog (reference vendor/ntHash/nttest.cpp).

Modes:
  kernel      fused hash+sample+scatter throughput per (k, geometry)
  multik      shared-work scaling over k-list sizes
  uniformity  chi-square uniformity of canonical hash low bits (the
              statistical role of nttest's Bloom-filter FPR sweep)
  bloom       Bloom-filter insert/query FPR over the NTM64 multi-hash
              derivation (nttest.cpp:443-494 analog; CPU-safe)
  race        hash runtime race on identical reads — ntHash (device kernel
              + native host engine) vs CityHash64 / murmur2-64A / XXH64 /
              FNV-1a 64 competitors, per-method Mbases/s (nttest.cpp:496-550
              analog, full method set; city, murmur and xxh verified
              bit-identical to the reference's vendored implementations)
  e2e         end-to-end file pipeline reads/s + Gbp/s
  hostpack    native decode+pack throughput (no device)

Usage: python -m ntcard_tpu.bench [mode ...]  (default: kernel uniformity)
"""

from __future__ import annotations

import sys
import time

import numpy as np


def _bench_top():
    """Load the repo-root bench.py (owns the synthetic dataset)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[2] / "bench.py"
    spec = importlib.util.spec_from_file_location("_bench_top", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chained(stepfn, batches, acc0):
    """Trustworthy device timing: chained dependency + host drain."""
    from ntcard_tpu import _jax_config  # noqa: F401
    import jax

    acc = stepfn(batches[0], acc0)
    _ = np.asarray(jax.tree.leaves(acc)[0])[:8]
    acc = acc0
    t0 = time.perf_counter()
    for b in batches:
        acc = stepfn(b, acc)
    _ = np.asarray(jax.tree.leaves(acc)[0])[:8]
    return (time.perf_counter() - t0) / len(batches)


def bench_kernel():
    from ntcard_tpu import _jax_config  # noqa: F401
    import jax
    import jax.numpy as jnp

    from ntcard_tpu.models.sketch import _table_add, _table_add_dump
    from ntcard_tpu.ops.nthash import sketch_scan

    rng = np.random.default_rng(0)
    print("# hash+sample+table-update (chained, drained)")
    print("#   dump = sentinels land in the table's last row; drop = the product")
    print("#   path (sentinels mapped past the table and dropped)")
    for k, B, L in [(32, 8192, 1024), (64, 8192, 1024), (128, 8192, 1024), (64, 16384, 1024)]:
        stride = ((L - k + 1) // 8) * 8
        # 12 reps: the one final drain divides over the rep count
        batches = [jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8)) for _ in range(12)]
        table0 = jnp.zeros((2 * (1 << 16) + 1,), jnp.int32)

        @jax.jit
        def step_dump(codes, table, k=k, stride=stride):
            idx, _ = sketch_scan(codes, (k,), stride, 7, 16)
            return _table_add_dump(table, idx[k])

        @jax.jit
        def step_drop(codes, table, k=k, stride=stride):
            idx, _ = sketch_scan(codes, (k,), stride, 7, 16)
            return _table_add(table, idx[k], 16)

        dt_du = _chained(step_dump, batches, table0)
        dt_dr = _chained(step_drop, batches, table0)
        print(
            f"k={k:4d} B={B} L={L}: dump {dt_du * 1e3:7.1f} ms/batch  "
            f"drop {dt_dr * 1e3:7.1f} ms/batch  "
            f"{B * stride / dt_dr / 1e6:7.0f} Mbases/s"
        )


def bench_multik():
    from ntcard_tpu import _jax_config  # noqa: F401
    import jax
    import jax.numpy as jnp

    from ntcard_tpu.ops.nthash import sketch_scan

    rng = np.random.default_rng(0)
    B, L = 8192, 1024
    print("# multi-k scaling (shared prefix scans)")
    for ks in [(64,), (32, 64), (32, 64, 96), (16, 32, 64, 96, 128)]:
        stride = ((L - max(ks) + 1) // 8) * 8
        batches = [jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8)) for _ in range(4)]
        table0 = jnp.zeros((len(ks), 2 * (1 << 16) + 1), jnp.int32)

        @jax.jit
        def step(codes, table, ks=ks, stride=stride):
            idx, _ = sketch_scan(codes, ks, stride, 7, 16)
            return jnp.stack(
                [table[i].at[jax.lax.optimization_barrier(idx[k])].add(1) for i, k in enumerate(ks)]
            )

        dt = _chained(step, batches, table0)
        print(f"nK={len(ks)} {str(ks):24s}: {dt * 1e3:7.1f} ms/batch  ({dt / len(ks) * 1e3:5.1f} ms/k)")


def bench_uniformity():
    """Chi-square of canonical-hash bucket occupancy — the role of nttest's
    Bloom-filter FPR uniformity sweep, directly on the hash values."""
    from ntcard_tpu import _jax_config  # noqa: F401
    import jax.numpy as jnp

    from ntcard_tpu.ops.nthash import canonical_hashes

    rng = np.random.default_rng(1)
    B, L, k = 1024, 1024, 64
    stride = ((L - k + 1) // 8) * 8
    codes = jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8))
    hi, lo, valid = canonical_hashes(codes, k, stride)
    v = np.asarray(valid)
    print("# hash uniformity (chi-square over 4096 buckets)")
    # the count-table bucket bits (hVal & (2^rBits-1), ntcard.cpp:141) must be
    # uniform; the TOP bits of a min-canonical hash are skewed low by the
    # min() itself — that skew is part of ntCard's design (its sampling
    # patterns account for it), so it is reported, not asserted.
    for name, arr, shift, expect in [
        ("low12 (table bucket bits)", np.asarray(lo), 0, True),
        ("top12 (min-biased by design)", np.asarray(hi), 20, False),
    ]:
        buckets = ((arr[v] >> shift) & 0xFFF).astype(np.int64)
        counts = np.bincount(buckets, minlength=4096)
        n = counts.sum()
        exp = n / 4096
        chi2 = float(((counts - exp) ** 2 / exp).sum())
        # dof=4095; mean 4095, sd ~sqrt(2*4095)=90.5
        z = (chi2 - 4095) / 90.5
        tag = "|z|<3 required" if expect else "skew expected"
        print(f"{name}: n={n} chi2={chi2:.0f} z={z:+.2f} ({tag})")


def bench_bloom():
    """Bloom-filter insert/query sweep over the NTM64 multi-hash derivation
    — the end-to-end consumer of ops/nthash.multi_hashes
    (models/bloom.BloomFilter), mirroring nttest's FPR table
    (nttest.cpp:443-494 + lib/BloomFilter.hpp insert/contains): insert the
    k-mers of a random sequence with h derived hashes, query disjoint
    absent k-mers, report measured vs theoretical false-positive rate."""
    from ntcard_tpu import _jax_config  # noqa: F401
    import jax.numpy as jnp

    from ntcard_tpu.models.bloom import BloomFilter

    rng = np.random.default_rng(11)
    k = 64
    m_bits = 24
    n_insert_target = 1_000_000
    L = 1024
    stride = ((L - k + 1) // 8) * 8
    B = (n_insert_target // stride + 127) // 128 * 128

    print("# bloom filter FPR over multi_hashes (nttest analog)")
    print(f"# k={k} m=2^{m_bits} slots, n~{B * stride:,} inserts")
    for h in (1, 2, 3, 4):
        ins = jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8))
        qry = jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8))
        bf = BloomFilter(k, m_bits, n_hashes=h)

        t0 = time.perf_counter()
        n_ins = bf.insert_batch(ins, stride)
        t_ins = time.perf_counter() - t0

        t0 = time.perf_counter()
        present, vq = bf.contains_batch(qry, stride)
        fp = int((present & vq).sum())
        nq = int(vq.sum())
        t_q = time.perf_counter() - t0
        print(
            f"h={h}: FPR {fp / max(nq, 1):.5f} (theory {bf.fpr_theory():.5f})  "
            f"insert {n_ins / t_ins / 1e6:6.1f} Mkmers/s  query {nq / t_q / 1e6:6.1f} Mkmers/s"
        )


def bench_e2e():
    from ntcard_tpu.io.packing import aligned_stride
    from ntcard_tpu.models.estimate import comp_est_hist
    from ntcard_tpu.models.sketch import CountTableSketch
    from ntcard_tpu.pipeline import batches_from_files, prefetch

    bench_top = _bench_top()

    fq = bench_top.ensure_data()
    k, r = 64, 16
    chunk_len, rows = 1024, 8192
    stride = aligned_stride(chunk_len, k)
    for trial in range(2):
        stats: dict = {}
        sketch = CountTableSketch((k,), 7, r, stride)
        t0 = time.perf_counter()
        for b in prefetch(batches_from_files([str(fq)], chunk_len, rows, k, stats_out=stats)):
            sketch.update(b)
        state = sketch.finalize()
        comp_est_hist(state[k]["hist"], 7, r, 64)
        dt = time.perf_counter() - t0
        if trial:  # trial 0 is warmup
            print("# end-to-end file pipeline")
            print(
                f"k={k}: {stats['records'] / dt:,.0f} reads/s  "
                f"{stats['bases'] / dt / 1e9:.3f} Gbp/s  ({dt:.2f}s)"
            )


def bench_hostpack():
    from ntcard_tpu.native import get_lib, native_batches_from_files

    bench_top = _bench_top()

    fq = bench_top.ensure_data()
    if get_lib() is None:
        print("native packer unavailable")
        return
    t0 = time.perf_counter()
    stats: dict = {}
    n = sum(1 for _ in native_batches_from_files([str(fq)], 1024, 8192, 64, stats_out=stats))
    dt = time.perf_counter() - t0
    print("# native decode+pack (no device)")
    print(f"{n} batches, {stats['bases'] / dt / 1e6:.0f} Mbases/s")


def _murmur64a(windows: np.ndarray) -> np.ndarray:
    """MurmurHash2 64A over [N, k] byte windows (k % 8 == 0), vectorized
    across N — semantics of the reference's comparison hash
    (vendor/ntHash/lib/murmur.hpp:14-62), reimplemented (not vendored) for
    the runtime race. numpy uint64 arithmetic wraps mod 2^64 like C."""
    n, k = windows.shape
    m = np.uint64(0xC6A4A7935BD1E995)
    r = np.uint64(47)
    chunks = np.ascontiguousarray(windows).view("<u8").reshape(n, k // 8)
    h = np.full(n, np.uint64((k * 0xC6A4A7935BD1E995) & 0xFFFFFFFFFFFFFFFF))
    for i in range(k // 8):
        kx = chunks[:, i] * m
        kx ^= kx >> r
        kx *= m
        h ^= kx
        h *= m
    h ^= h >> r
    h *= m
    h ^= h >> r
    return h


def _xxh64(windows: np.ndarray) -> np.ndarray:
    """XXH64 (seed 0) over [N, k] byte windows (k % 8 == 0), vectorized
    across N — semantics of the reference's vendored comparison hash
    (vendor/ntHash/lib/xxhash.c), reimplemented for the runtime race and
    verified against a compiled build of the original
    (tests/test_bench_race.py)."""
    n, k = windows.shape
    P1 = np.uint64(0x9E3779B185EBCA87)
    P2 = np.uint64(0xC2B2AE3D27D4EB4F)
    P3 = np.uint64(0x165667B19E3779F9)
    P4 = np.uint64(0x85EBCA77C2B2AE63)
    P5 = np.uint64(0x27D4EB2F165667C5)

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))

    chunks = np.ascontiguousarray(windows).view("<u8").reshape(n, k // 8)
    i = 0
    if k >= 32:
        v = [
            np.full(n, np.uint64((int(P1) + int(P2)) & 0xFFFFFFFFFFFFFFFF)),
            np.full(n, P2),
            np.zeros(n, np.uint64),
            np.full(n, np.uint64((-int(P1)) & 0xFFFFFFFFFFFFFFFF)),
        ]
        while i + 4 <= k // 8:
            for lane in range(4):
                v[lane] = rotl(v[lane] + chunks[:, i + lane] * P2, 31) * P1
            i += 4
        h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)
        for lane in range(4):
            h ^= rotl(v[lane] * P2, 31) * P1
            h = h * P1 + P4
    else:
        h = np.full(n, P5, np.uint64)
    h += np.uint64(k)
    while i < k // 8:  # 8-byte tail chunks (k % 32 != 0)
        h ^= rotl(chunks[:, i] * P2, 31) * P1
        h = rotl(h, 27) * P1 + P4
        i += 1
    h ^= h >> np.uint64(33)
    h *= P2
    h ^= h >> np.uint64(29)
    h *= P3
    h ^= h >> np.uint64(32)
    return h


def _city64(windows: np.ndarray) -> np.ndarray:
    """CityHash64 over [N, k] byte windows (any k >= 1), vectorized across
    N — semantics of the reference's vendored comparison hash
    (vendor/ntHash/lib/city.cc:200-236 and its helpers), reimplemented for
    the runtime race and verified against a compiled build of the original
    across every length branch (tests/test_bench_race.py). All arithmetic
    is numpy uint64 arrays, which wrap mod 2^64 like C."""
    n, k = windows.shape
    b = np.ascontiguousarray(windows)
    K0 = np.uint64(0xC3A5C85C97CB3127)
    K1 = np.uint64(0xB492B66FBE98F273)
    K2 = np.uint64(0x9AE16A3B2F90404F)
    K3 = np.uint64(0xC949D7C7509E6557)
    KMUL = np.uint64(0x9DDFEA08EB382D69)

    u64v = b.view("<u8") if k % 8 == 0 else None  # zero-copy aligned fetches

    def f64(off: int) -> np.ndarray:  # little-endian Fetch64 at byte offset
        if u64v is not None and off % 8 == 0:
            return u64v[:, off // 8]
        return b[:, off : off + 8].copy().view("<u8").ravel()

    def f32(off: int) -> np.ndarray:
        return b[:, off : off + 4].copy().view("<u4").ravel().astype(np.uint64)

    def rot(v: np.ndarray, s: int) -> np.ndarray:  # Rotate (right), s may be 0
        if s == 0:
            return v
        return (v >> np.uint64(s)) | (v << np.uint64(64 - s))

    def smix(v: np.ndarray) -> np.ndarray:
        return v ^ (v >> np.uint64(47))

    def h16(u: np.ndarray, v: np.ndarray) -> np.ndarray:  # HashLen16/Hash128to64
        a = (u ^ v) * KMUL
        a ^= a >> np.uint64(47)
        c = (v ^ a) * KMUL
        c ^= c >> np.uint64(47)
        return c * KMUL

    kk = np.uint64(k)
    if k <= 16:  # HashLen0to16 (city.cc:120-139)
        if k > 8:
            a = f64(0)
            t = f64(k - 8)
            return h16(a, rot(t + kk, k % 64)) ^ t  # RotateByAtLeast1(b+len, len)
        if k >= 4:
            a = f32(0)
            return h16(kk + (a << np.uint64(3)), f32(k - 4))
        a = b[:, 0].astype(np.uint64)
        c = b[:, k >> 1].astype(np.uint64)
        d = b[:, k - 1].astype(np.uint64)
        y = a + (c << np.uint64(8))
        z = kk + (d << np.uint64(2))
        return smix(y * K2 ^ z * K3) * K2
    if k <= 32:  # HashLen17to32 (city.cc:143-151)
        a = f64(0) * K1
        t = f64(8)
        c = f64(k - 8) * K2
        d = f64(k - 16) * K0
        return h16(rot(a - t, 43) + rot(c, 30) + d, a + rot(t ^ K3, 20) - c + kk)
    if k <= 64:  # HashLen33to64 (city.cc:177-197)
        z = f64(24)
        a = f64(0) + (kk + f64(k - 16)) * K0
        t = rot(a + z, 52)
        c = rot(a, 37)
        a = a + f64(8)
        c = c + rot(a, 7)
        a = a + f64(16)
        vf = a + z
        vs = t + rot(a, 31) + c
        a = f64(16) + f64(k - 32)
        z = f64(k - 8)
        t = rot(a + z, 52)
        c = rot(a, 37)
        a = a + f64(k - 24)
        c = c + rot(a, 7)
        a = a + f64(k - 16)
        wf = a + z
        ws = t + rot(a, 31) + c
        r = smix((vf + ws) * K2 + (wf + vs) * K0)
        return smix(r * K0 + vs) * K2

    # k > 64: hash the end, then 56 bytes of state over 64-byte chunks
    # (city.cc:210-236); WeakHashLen32WithSeeds inlined (city.cc:154-175)
    def weak32(off: int, a: np.ndarray, t: np.ndarray):
        w, x, y, z = f64(off), f64(off + 8), f64(off + 16), f64(off + 24)
        a = a + w
        t = rot(t + a + z, 21)
        c = a
        a = a + x + y
        t = t + rot(a, 44)
        return a + z, t + c

    x = f64(k - 40)
    y = f64(k - 16) + f64(k - 56)
    z = h16(f64(k - 48) + kk, f64(k - 24))
    v1, v2 = weak32(k - 64, np.full(n, kk), z)
    w1, w2 = weak32(k - 32, y + K1, x)
    x = x * K1 + f64(0)
    rem = (k - 1) & ~63
    s = 0
    while rem:
        x = rot(x + y + v1 + f64(s + 8), 37) * K1
        y = rot(y + v2 + f64(s + 48), 42) * K1
        x = x ^ w2
        y = y + v1 + f64(s + 40)
        z = rot(z + w1, 33) * K1
        v1, v2 = weak32(s, v2 * K1, x + w1)
        w1, w2 = weak32(s + 32, z + w2, y + f64(s + 16))
        z, x = x, z
        s += 64
        rem -= 64
    return h16(h16(v1, w1) + smix(y) * K1 + z, h16(v2, w2) + x)


def _fnv1a64(windows: np.ndarray) -> np.ndarray:
    """FNV-1a 64 over [N, k] byte windows, vectorized across N (a second
    widely-used comparison hash for the race; per-byte like CityHash's
    small-input path)."""
    n, k = windows.shape
    h = np.full(n, np.uint64(0xCBF29CE484222325), dtype=np.uint64)
    prime = np.uint64(0x100000001B3)
    for i in range(k):
        h ^= windows[:, i].astype(np.uint64)
        h *= prime
    return h


def bench_race():
    """Runtime race of hashing methods on identical reads — the nttest
    'runtime' mode analog (nttest.cpp:496-550 races ntbase/nthash against
    city/murmur/xxhash CPU implementations; the vendored comparison libs
    are not ported, so the competitors here are vectorized numpy
    reimplementations of CityHash64, murmur2-64A, XXH64 and FNV-1a 64 —
    the city/murmur/xxh ones verified bit-identical to compiled builds of
    the vendored originals). Reported as Mbases/s over the same input for
    every method:
      nthash-device  the fused canonical-hash kernel (chained, drained)
      nthash-host    the native AVX-512 host engine (hash+sample+count)
      city64         numpy-vectorized per-window competitor
      murmur64a      numpy-vectorized per-window competitor
      xxh64          numpy-vectorized per-window competitor
      fnv1a64        numpy-vectorized per-window competitor"""
    from ntcard_tpu.constants import ASCII_TO_CODE

    k = 64
    n_reads, read_len = 20_000, 152
    rng = np.random.default_rng(3)
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(n_reads, read_len))
    total_bases = n_reads * read_len
    print(f"# hash runtime race: {n_reads} reads x {read_len} bp, k={k}")

    # numpy competitors hash every window of every read
    from numpy.lib.stride_tricks import sliding_window_view

    wins = sliding_window_view(reads, k, axis=1).reshape(-1, k)
    for name, fn in [
        ("city64", _city64),
        ("murmur64a", _murmur64a),
        ("xxh64", _xxh64),
        ("fnv1a64", _fnv1a64),
    ]:
        fn(wins[:1024])  # warm
        t0 = time.perf_counter()
        h = fn(wins)
        dt = time.perf_counter() - t0
        assert h.shape[0] == wins.shape[0]
        print(f"{name:14s} {total_bases / dt / 1e6:8.1f} Mbases/s")

    # the native host engine (hash + sample + count — it has no hash-only
    # entry; the extra work only understates its rate)
    from ntcard_tpu.io.packing import StreamPacker, aligned_stride
    from ntcard_tpu.models.host_engine import HostCountTableSketch, host_engine_available

    stride = aligned_stride(read_len + 8, k)
    if host_engine_available():
        packer = StreamPacker(read_len + 8, 8192, k)
        batches = []
        for row in reads:
            batches.extend(packer.feed(row.tobytes()))
        batches.extend(packer.finish())
        sk = HostCountTableSketch((k,), 7, 16, stride, n_threads=1)
        sk.update(batches[0])  # warm (library load)
        t0 = time.perf_counter()
        for b in batches:
            sk.update(b)
        dt = time.perf_counter() - t0
        print(f"{'nthash-host':14s} {total_bases / dt / 1e6:8.1f} Mbases/s  (1 thread, +sample+count)")

    # the device kernel (canonical hashes only, chained + drained)
    from ntcard_tpu import _jax_config  # noqa: F401
    import jax
    import jax.numpy as jnp

    from ntcard_tpu.ops.nthash import canonical_hashes

    codes = ASCII_TO_CODE[reads]
    rows = (n_reads // 8) * 8
    dev_stride = aligned_stride(read_len, k)  # raw read rows, no separators
    dev_batches = [
        jnp.asarray(codes[i : i + rows // 4]) for i in range(0, rows, rows // 4)
    ]

    @jax.jit
    def step(c, acc):
        hi, lo, valid = canonical_hashes(c, k, dev_stride)
        return acc ^ hi.sum(dtype=jnp.uint32) ^ lo.sum(dtype=jnp.uint32)

    dt = _chained(step, dev_batches, jnp.zeros((1,), jnp.uint32))
    per_batch_bases = (rows // 4) * read_len
    print(f"{'nthash-device':14s} {per_batch_bases / dt / 1e6:8.1f} Mbases/s  (hash only)")


MODES = {
    "kernel": bench_kernel,
    "multik": bench_multik,
    "uniformity": bench_uniformity,
    "bloom": bench_bloom,
    "race": bench_race,
    "e2e": bench_e2e,
    "hostpack": bench_hostpack,
}


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    modes = args or ["kernel", "uniformity"]
    for m in modes:
        if m not in MODES:
            print(f"unknown mode {m}; choose from {sorted(MODES)}", file=sys.stderr)
            return 1
        MODES[m]()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
