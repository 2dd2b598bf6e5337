"""The plain XLA update and finalize (models/sketch.py) against np.bincount,
and the GPU-bring-up plumbing around them: the accelerator-routing helper,
the compile-cache rule, chip_smoke.py's refusal of a CPU backend, and the
absence of the removed Pallas-dialect kernels.

The update is one scatter-add per k over the emit stream, in which the
sentinel 2*r_buck marks "no update". Both plain forms are held to the same
table: _table_add maps the sentinel past the table's end (dropped),
_table_add_dump lets it land in the never-read last row."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ntcard_tpu.io.packing import aligned_stride, pack_records
from ntcard_tpu.models import sketch as S
from ntcard_tpu.ops import nthash_ref as R

REPO = Path(__file__).resolve().parents[1]


def _emit_stream(r_bits, density, n=4096, seed=0):
    """int32[n] emit stream: a `density` share of sampled updates (some
    repeated buckets), the rest the sentinel 2*r_buck."""
    rng = np.random.default_rng(seed + r_bits)
    r_buck = 1 << r_bits
    idx = np.full(n, 2 * r_buck, np.int32)
    m = int(round(density * n))
    pos = rng.choice(n, size=m, replace=False)
    idx[pos] = rng.integers(0, 2 * r_buck, size=m, dtype=np.int32)
    # repeats: the same bucket hit many times within one batch
    if m > 8:
        idx[pos[: m // 8]] = idx[pos[0]]
    return idx


@pytest.mark.parametrize("form", ["drop", "dump"])
@pytest.mark.parametrize("density", [0.0, 0.012, 0.5, 1.0])
@pytest.mark.parametrize("r_bits", [8, 12, 16, 17, 20])
def test_table_add_matches_bincount(r_bits, density, form):
    r_buck = 1 << r_bits
    idx = _emit_stream(r_bits, density)
    table = jnp.zeros((2 * r_buck + 1,), jnp.int32)
    if form == "drop":
        got = np.asarray(jax.jit(S._table_add, static_argnums=2)(table, idx, r_bits))
    else:
        got = np.asarray(jax.jit(S._table_add_dump)(table, idx))
    sampled = idx[idx != 2 * r_buck]
    want = np.bincount(sampled, minlength=2 * r_buck)
    np.testing.assert_array_equal(got[: 2 * r_buck], want)
    # the last row: never written by the drop form, the sentinel count in
    # the dump form — never read by finalize either way
    n_sent = int((idx == 2 * r_buck).sum())
    assert got[2 * r_buck] == (0 if form == "drop" else n_sent)


def _table_case(case, r_bits):
    """int32[1, 2*r_buck+1] table for the histogram cases."""
    r_buck = 1 << r_bits
    rng = np.random.default_rng(17)
    if case == "empty":
        t = np.zeros(2 * r_buck + 1, np.int32)
    elif case == "wrapped":
        # counts past 2^16 that wrap onto low bins, and exact multiples of
        # 2^16 that wrap onto bin 0 (untouched in the reference's uint16)
        base = rng.integers(0, 1200, size=2 * r_buck + 1)
        wraps = rng.integers(0, 3, size=2 * r_buck + 1) << 16
        t = (base + wraps).astype(np.int32)
        t[::7] = 65536
    else:  # dense: every bucket nonzero and in range, beyond 2^18 per row
        t = rng.integers(1, 40, size=2 * r_buck + 1).astype(np.int32)
    return t[None]


def _want_hist(t, r_buck, nbins):
    rows = []
    for s in range(2):
        v = t[0, s * r_buck : (s + 1) * r_buck] & 0xFFFF
        rows.append(np.bincount(v, minlength=65536)[:nbins])
    return np.stack(rows)


@pytest.mark.parametrize("case", ["empty", "wrapped", "dense"])
@pytest.mark.parametrize("nbins", [2, 32, 33, 64, 1001, 65535])
def test_finalize_hist_and_bundle_match_bincount(nbins, case):
    r_bits = 18 if case == "dense" else 12
    r_buck = 1 << r_bits
    t = _table_case(case, r_bits)
    want = _want_hist(t, r_buck, nbins)
    tables = (jnp.asarray(t[0]),)
    got = S._counter_hists_device(tables, r_buck, nbins)
    np.testing.assert_array_equal(got[0], want)
    # the fused bundle: the same histograms, then the F1 (hi, lo) words
    f1s = jnp.asarray(np.array([[3, 0xFFFFFFF0]], np.uint32))
    flat = np.asarray(S._finalize_bundle(tables, f1s, r_buck, nbins))
    np.testing.assert_array_equal(flat[: 2 * nbins].reshape(2, nbins), want)
    words = flat[2 * nbins :].astype(np.int64) & 0xFFFFFFFF
    assert words.tolist() == [3, 0xFFFFFFF0]


def _sampled_kmer(k=8, s_bits=7) -> bytes:
    """An 8-mer whose canonical hash passes the ntcard sample test."""
    rng = np.random.default_rng(99)
    smask = (1 << (s_bits - 1)) - 1
    while True:
        s = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=k))
        hi = R.ntc64(R.seq_to_codes(s), k) >> 32
        if (hi >> (31 - s_bits)) == 1 or (hi >> (32 - s_bits)) == smask:
            return s


@pytest.mark.parametrize("feed", ["batches", "superbatch", "sharded"])
def test_repeat_heavy_matches_host_engine(feed):
    """Low-complexity repeats (a periodic sampled k-mer: thousands of
    updates of one bucket in a batch, the telomeric-repeat shape) through
    the device sketch byte-match the native host engine."""
    from ntcard_tpu.models.host_engine import HostCountTableSketch, host_engine_available
    from ntcard_tpu.parallel.data_parallel import ShardedCountTableSketch

    if not host_engine_available():
        pytest.skip("native toolchain unavailable")
    k, s_bits, r_bits, chunk, rows = 8, 7, 18, 128, 128
    stride = aligned_stride(chunk, k)
    rng = np.random.default_rng(7)
    recs = [_sampled_kmer() * 600]
    recs += [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200)) for _ in range(20)]
    host = HostCountTableSketch((k,), s_bits, r_bits, stride)
    if feed == "sharded":
        dev = ShardedCountTableSketch((k,), s_bits, r_bits, stride, n_devices=2)
        batches = list(pack_records(recs, chunk, 2 * rows, k))
    else:
        dev = S.CountTableSketch((k,), s_bits, r_bits, stride)
        batches = list(pack_records(recs, chunk, rows, k))
    for b in batches:
        host.update(b)
    if feed == "superbatch" and len(batches) >= 2:
        dev.update(np.stack(batches[:2]))
        batches = batches[2:]
    for b in batches:
        dev.update(b)
    want = host.finalize(return_table=True, cov_max=1000)[k]
    got = dev.finalize(return_table=True, cov_max=1000)[k]
    np.testing.assert_array_equal(got["table"], want["table"])
    np.testing.assert_array_equal(got["hist"], want["hist"])
    assert got["f1"] == want["f1"]


def test_fused_finalize_matches_unfused_random(monkeypatch):
    """Fused and unfused finalize agree bit-for-bit (hists, F1) on random
    content at the big-table geometry."""
    k, stride = 8, aligned_stride(128, 8)
    rng = np.random.default_rng(5)
    alphabet = np.frombuffer(b"ACGTN", np.uint8)
    recs = [bytes(rng.choice(alphabet, size=int(rng.integers(10, 300)))) for _ in range(60)]
    monkeypatch.setenv("NTCARD_FINALIZE", "fused")
    sk = S.CountTableSketch((k,), 7, 18, stride)
    for b in pack_records(recs, 128, 128, k):
        sk.update(b)
    fused = sk.finalize(cov_max=200)
    monkeypatch.setenv("NTCARD_FINALIZE", "unfused")
    sk2 = S.CountTableSketch((k,), 7, 18, stride)
    for b in pack_records(recs, 128, 128, k):
        sk2.update(b)
    unfused = sk2.finalize(cov_max=200)
    np.testing.assert_array_equal(fused[k]["hist"], unfused[k]["hist"])
    assert fused[k]["f1"] == unfused[k]["f1"]


@pytest.mark.parametrize(
    "plats,visible,want",
    [
        ("cuda", False, True),
        ("gpu", False, True),
        ("cuda,cpu", False, True),
        ("cpu", True, False),
        (None, True, True),
        (None, False, False),
    ],
)
def test_accelerator_requested(monkeypatch, plats, visible, want):
    from ntcard_tpu import accel

    if plats is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", plats)
    monkeypatch.setattr(accel, "_nvidia_device_visible", lambda: visible)
    assert accel.accelerator_requested() is want


_CACHE_PROBE = (
    "import jax, ntcard_tpu._jax_config\n"
    "from ntcard_tpu.utils import aot\n"
    "from ntcard_tpu import native\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
    "print(aot._cache_dir())\n"
)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir_rule(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it and the AOT store lives
    under it; unset: both sit under the fixed .jax_cache in the checkout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    root = str(tmp_path / "cc") if env_set else str(REPO / ".jax_cache")
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = root
    r = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], capture_output=True, text=True,
        env=env, cwd=str(tmp_path), timeout=120,
    )
    assert r.returncode == 0, r.stderr
    jax_dir, aot_dir = r.stdout.split()
    assert jax_dir == root
    assert aot_dir == os.path.join(root, "ntcard_aot")


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        env=env, cwd=str(cwd), timeout=300,
    )


def _says_ok(stdout: str) -> bool:
    return '"ok": true' in stdout.replace(" ", "").replace('"ok":true', '"ok": true')


def test_chip_smoke_refuses_cpu_backend(tmp_path):
    r = _run_smoke(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert not _says_ok(r.stdout)


def test_chip_smoke_fails_without_the_repo(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes((REPO / "chip_smoke.py").read_bytes())
    r = _run_smoke(tmp_path, lone)
    assert r.returncode != 0
    assert not _says_ok(r.stdout)


def test_package_imports_no_pallas_dialect():
    """Nothing in the package imports the removed kernels' Pallas dialect or
    asks for interpret mode."""
    pkg = REPO / "ntcard_tpu"
    bad = []
    for p in pkg.rglob("*.py"):
        text = p.read_text()
        # spelled in pieces so this file does not match its own search
        for needle in ("pallas" + ".t" + "pu", "plt" + "pu", "interpret" + "="):
            if needle in text:
                bad.append(f"{p.relative_to(REPO)}: {needle}")
    assert not bad, bad


@pytest.mark.gpu
def test_gpu_update_matches_bincount(gpu_device):
    """On the card: the jitted plain update at the default geometry's
    density equals np.bincount of its emit stream."""
    r_bits = 20
    idx = _emit_stream(r_bits, 0.012, n=1 << 20)
    table = jax.device_put(jnp.zeros((2 * (1 << r_bits) + 1,), jnp.int32), gpu_device)
    got = np.asarray(jax.jit(S._table_add, static_argnums=2)(table, idx, r_bits))
    want = np.bincount(idx[idx != 2 << r_bits], minlength=2 << r_bits)
    np.testing.assert_array_equal(got[: 2 << r_bits], want)
