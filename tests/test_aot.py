"""Client-side AOT executable cache (ntcard_tpu/utils/aot.py): forced on
(NTCARD_AOT=1) over the CPU backend — results must be bit-identical to the
plain jit path, cache entries must round-trip through disk, and every
failure path must fall back to jit. Whether the cache pays on the card is
measured by chip_smoke.py (cold wall with and without NTCARD_AOT=0)."""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ntcard_tpu.utils import aot
from ntcard_tpu.utils.aot import aot_jit


@pytest.fixture()
def aot_on(tmp_path, monkeypatch):
    monkeypatch.setenv("NTCARD_AOT", "1")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    yield str(tmp_path / "ntcard_aot")


def _fresh(fn=None, **kw):
    """A new wrapper instance (its in-memory call cache starts empty)."""
    if fn is None:
        def fn(acc, x, k):
            return acc + x * k, (acc ^ x).sum()
        kw = dict(static_argnames=("k",), donate_argnums=(0,))
    return aot_jit(fn, **kw)


def test_roundtrip_and_bit_equality(aot_on):
    f = _fresh()
    x = np.arange(256, dtype=np.int32)
    acc = np.zeros(256, dtype=np.int32)
    r1, s1 = f(acc, x, k=3)
    # plain jit reference
    def fn(acc, x, k):
        return acc + x * k, (acc ^ x).sum()
    jr, js = jax.jit(fn, static_argnames=("k",))(acc, x, k=3)
    assert (np.asarray(r1) == np.asarray(jr)).all()
    assert int(s1) == int(js)
    bins = [n for n in os.listdir(aot_on) if n.endswith(".bin")]
    assert len(bins) == 1  # executable stored
    # a FRESH wrapper (new process analog) must load from disk, not compile
    f2 = _fresh()
    stores = os.path.getmtime(os.path.join(aot_on, bins[0]))
    r2, s2 = f2(np.zeros(256, dtype=np.int32), x, k=3)
    assert (np.asarray(r2) == np.asarray(jr)).all()
    assert os.path.getmtime(os.path.join(aot_on, bins[0])) == stores  # no rewrite


def test_statics_positional_and_shape_keys(aot_on):
    f = _fresh()
    x = np.arange(64, dtype=np.int32)
    acc = np.zeros(64, dtype=np.int32)
    # statics passed positionally (the sketch call style)
    r, s = f(acc, x, 5)
    assert int(np.asarray(r)[1]) == 5
    # distinct static value -> distinct program
    r7, _ = f(np.zeros(64, dtype=np.int32), x, 7)
    assert int(np.asarray(r7)[1]) == 7
    # distinct shape -> distinct program
    y = np.arange(128, dtype=np.int32)
    r3, _ = f(np.zeros(128, dtype=np.int32), y, 5)
    assert np.asarray(r3).shape == (128,)
    assert len([n for n in os.listdir(aot_on) if n.endswith(".bin")]) == 3


def test_corrupt_cache_falls_back(aot_on):
    f = _fresh()
    x = np.arange(32, dtype=np.int32)
    f(np.zeros(32, dtype=np.int32), x, 2)
    for n in os.listdir(aot_on):
        if n.endswith(".bin"):
            with open(os.path.join(aot_on, n), "wb") as fh:
                fh.write(b"garbage")
    f2 = _fresh()
    r, _ = f2(np.zeros(32, dtype=np.int32), x, 2)  # recompiles, no crash
    assert int(np.asarray(r)[1]) == 2


def test_tracer_guard_inlines(aot_on):
    """An aot_jit function used inside an enclosing trace inlines via the
    plain jit path (a compiled executable cannot be traced)."""
    inner = aot_jit(lambda v: v * 2 + 1)

    @jax.jit
    def outer(v):
        return inner(v) + 3

    out = outer(np.arange(8, dtype=np.int32))
    assert (np.asarray(out) == np.arange(8) * 2 + 4).all()
    assert not os.path.exists(aot_on) or not os.listdir(aot_on)


def test_preload_with_specs(aot_on):
    f = _fresh()
    spec = jax.ShapeDtypeStruct((16,), jnp.int32)
    assert f.preload(spec, spec, 4)
    assert len([n for n in os.listdir(aot_on) if n.endswith(".bin")]) == 1
    # the real call reuses the preloaded executable (no new entries)
    x = np.arange(16, dtype=np.int32)
    r, _ = f(np.zeros(16, dtype=np.int32), x, 4)
    assert int(np.asarray(r)[1]) == 4
    assert len([n for n in os.listdir(aot_on) if n.endswith(".bin")]) == 1
    # device_put-COMMITTED args on the default device must land on the
    # SAME in-memory entry as the spec preload (placement normalization —
    # the CLI's wires are committed via explicit device_put, the preload
    # uses bare specs; a key mismatch would silently re-prepare and waste
    # the boot-thread overlap)
    n_entries = len(f._calls)
    xd = jax.device_put(x)
    ad = jax.device_put(np.zeros(16, dtype=np.int32))
    r2, _ = f(ad, xd, 4)
    assert int(np.asarray(r2)[1]) == 4
    assert len(f._calls) == n_entries, "committed-arg call missed the preload entry"


def test_fastkey_skips_trace_and_verifies(aot_on, monkeypatch):
    """Second-process preload must load via the fastkey→digest mapping
    (no foreground trace) and the background verification must pass."""
    f = _fresh()
    spec = jax.ShapeDtypeStruct((32,), jnp.int32)
    assert f.preload(spec, spec, 3)  # traces, stores payload + mapping
    aot.check_trace_verifications()
    maps = [n for n in os.listdir(aot_on) if n.startswith("map_")]
    assert len(maps) == 1
    # fresh wrapper: count foreground lowers via a wrapped lower
    f2 = _fresh()
    lowers = []
    real_lower = f2._jit.lower
    f2._jit = type(
        "W",
        (),
        {
            "lower": staticmethod(
                lambda *a, **k: (lowers.append(1), real_lower(*a, **k))[1]
            ),
            "clear_cache": staticmethod(lambda: None),
            "__call__": staticmethod(lambda *a, **k: None),
        },
    )()
    assert f2.preload(spec, spec, 3)
    # the foreground path must NOT have lowered; the semantic verifier
    # thread does (asynchronously) — the barrier waits and must agree
    aot.check_trace_verifications()
    assert len(lowers) == 1  # exactly the verifier's trace
    # the mapping is now stamped verified: a third fresh wrapper takes the
    # pure fast path (no trace, no pending verification)
    vok = [n for n in os.listdir(aot_on) if n.endswith(".vok")]
    assert len(vok) == 1
    f3 = _fresh()
    assert f3.preload(spec, spec, 3)
    assert aot._VERIFY_PENDING == []
    x = np.arange(32, dtype=np.int32)
    r, _ = f3(np.zeros(32, dtype=np.int32), x, 3)
    assert int(np.asarray(r)[1]) == 3


def test_fastkey_mismatch_raises_and_evicts(aot_on, monkeypatch):
    """A stale mapping (pointing at a DIFFERENT program's digest) must load
    something, but the verification barrier must raise and evict it —
    never silently expose a wrong program's results."""
    f = _fresh()
    spec = jax.ShapeDtypeStruct((32,), jnp.int32)
    assert f.preload(spec, spec, 3)
    aot.check_trace_verifications()
    # a second program with the same signature but different math
    def g_fn(acc, x, k):
        return acc + x * k + 1, (acc | x).sum()
    g = aot_jit(g_fn, static_argnames=("k",), donate_argnums=(0,))
    assert g.preload(spec, spec, 3)
    aot.check_trace_verifications()
    # point f's mapping at g's digest
    maps = sorted(
        (os.path.getmtime(os.path.join(aot_on, n)), n)
        for n in os.listdir(aot_on)
        if n.startswith("map_")
    )
    assert len(maps) == 2
    f_map, g_map = maps[0][1], maps[1][1]
    g_digest = open(os.path.join(aot_on, g_map)).read()
    with open(os.path.join(aot_on, f_map), "w") as fh:
        fh.write(g_digest)
    f3 = _fresh()
    assert f3.preload(spec, spec, 3)  # loads the WRONG executable
    with pytest.raises(RuntimeError, match="differ|mismatch|arity"):
        aot.check_trace_verifications()
    assert not os.path.exists(os.path.join(aot_on, f_map))  # evicted
    # a rerun preloads cleanly via the trace path
    f4 = _fresh()
    assert f4.preload(spec, spec, 3)
    aot.check_trace_verifications()


def test_fastkey_invalidated_by_env_knob(aot_on, monkeypatch):
    """Trace-time NTCARD_* knobs are part of the fast-key material: a knob
    flip must MISS the mapping (different key), not hit a stale one."""
    f = _fresh()
    spec = jax.ShapeDtypeStruct((32,), jnp.int32)
    k1 = f._fastkey(*f._split((spec, spec, 3), {}))
    monkeypatch.setenv("NTCARD_KERNEL", "prefix")
    k2 = f._fastkey(*f._split((spec, spec, 3), {}))
    assert k1 != k2


def test_disabled_paths(tmp_path, monkeypatch):
    monkeypatch.setenv("NTCARD_AOT", "0")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "off"))
    f = _fresh()
    x = np.arange(16, dtype=np.int32)
    r, _ = f(np.zeros(16, dtype=np.int32), x, 4)
    assert int(np.asarray(r)[1]) == 4
    assert not os.path.exists(str(tmp_path / "off"))
    assert not f.preload(jax.ShapeDtypeStruct((16,), jnp.int32),
                         jax.ShapeDtypeStruct((16,), jnp.int32), 4)


def test_sketch_programs_roundtrip(aot_on, monkeypatch):
    """The wrapped sketch update programs produce bit-identical tables when
    loaded from the AOT disk cache in a fresh in-memory state."""
    from ntcard_tpu.io.packing import aligned_stride
    from ntcard_tpu.models import sketch as S

    stride = aligned_stride(256, 24)
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, size=(32, 256), dtype=np.uint8)
    codes[codes == 4] = 4  # code 4 = separator/N in the emit convention

    def run():
        sk = S.CountTableSketch((24,), 7, 12, stride)
        sk.update(codes)
        state = sk.finalize(cov_max=30)
        return state[24]["hist"], state[24]["f1"]

    h1, f1 = run()
    # clear the in-memory AOT call caches (fresh-process analog), keep disk
    for name in ("_update_first", "_update", "_make_tables"):
        fn = getattr(S, name)
        if hasattr(fn, "_calls"):
            fn._calls.clear()
    h2, f2 = run()
    assert f1 == f2
    assert (np.asarray(h1) == np.asarray(h2)).all()


def test_prune_caps_entries(aot_on, monkeypatch):
    os.makedirs(aot_on, exist_ok=True)
    for i in range(12):
        for suffix in (".bin", ".tree"):
            with open(os.path.join(aot_on, f"{i:02d}x{suffix}"), "wb") as fh:
                fh.write(b"z")
    aot._prune(aot_on, cap=5)
    assert len([n for n in os.listdir(aot_on) if n.endswith(".bin")]) == 5
