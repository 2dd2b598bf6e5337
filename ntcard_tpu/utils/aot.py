"""Client-side AOT executable cache: skip the compile on a cold start.

Why: a cold CLI process traces and compiles each jitted program on its
first call; JAX's persistent compilation cache saves the backend compile
but still pays the trace and the executable load. A serialized executable
(``jax.experimental.serialize_executable``) kept on disk and deserialized
on the first call skips that exchange, so the cold CLI's startup chain
loses one serial compile per program.

Design: ``aot_jit(fn, static_argnames=..., donate_argnums=...)`` is a
drop-in replacement for ``jax.jit`` at module level for programs that are
(a) on the cold-start critical path and (b) called from host code (never
from inside another trace — a deserialized executable cannot be traced).
The wrapper keeps a per-process call cache keyed on argument
shapes/dtypes + static values, exactly like jit's own cache; on a miss it
lowers (cheap, client-side tracing), keys the DISK cache on the sha256 of
the lowered HLO text plus the jax version, platform and runtime version
(any change to the traced program or the stack changes the key), and
either deserializes a stored executable or compiles and stores one.
Results are bit-identical by construction — the executable IS the
compiled program for that exact HLO; donation semantics ride inside the
executable (verified by test_aot.py).

The store lives in ``<cache root>/ntcard_aot`` (accel.cache_root: under
JAX_COMPILATION_CACHE_DIR when set). Enabled on accelerator platforms by
default; NTCARD_AOT=0 disables, NTCARD_AOT=1 forces it on CPU (tests).
Every failure path (serialization unsupported, stale/corrupt payload,
version skew, signature surprises) falls back to the plain jitted
function — the cache can only ever change WHEN work happens, not what it
computes. Whether it pays on the card is an open measurement (ROADMAP).

Reference analog: none — the reference is a cold C++ binary
(ntcard.cpp:317-478).
"""

from __future__ import annotations

import hashlib
import inspect
import os
import pickle
import sys
import threading

__all__ = ["aot_jit"]

_PROTO = 1  # bump to invalidate every stored payload


def _cache_dir() -> str:
    from ntcard_tpu.accel import cache_root

    return os.path.join(cache_root(), "ntcard_aot")


_enabled_memo: dict = {}


def _enabled() -> bool:
    env = os.environ.get("NTCARD_AOT", "")
    hit = _enabled_memo.get(env)
    if hit is not None:
        return hit
    if env == "0":
        v = False
    elif env == "1":
        v = True
    else:
        # default: only where executable loads are expensive (accelerators)
        try:
            import jax

            v = jax.devices()[0].platform != "cpu"
        except Exception:
            v = False
    _enabled_memo[env] = v
    return v


def _stack_fingerprint() -> str:
    """Version material folded into every disk key: a payload must never
    outlive the stack that produced it."""
    import jax

    parts = [f"proto{_PROTO}", f"jax{jax.__version__}"]
    try:
        backend = jax.extend.backend.get_backend()
        parts += [backend.platform, str(backend.platform_version)]
    except Exception:
        pass
    parts.append(os.environ.get("XLA_FLAGS", ""))
    return "|".join(parts)


_src_hash_memo: dict = {}


def _source_hash() -> str:
    """Content hash of every .py file in the ntcard_tpu package — part of
    the fast-key material: any source edit must invalidate fast-key
    mappings (the mapped digest was computed from a trace of the OLD
    sources)."""
    import ntcard_tpu

    root = os.path.dirname(os.path.abspath(ntcard_tpu.__file__))
    hit = _src_hash_memo.get(root)
    if hit is not None:
        return hit
    h = hashlib.sha256()
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for name in sorted(files):
            if name.endswith(".py"):
                p = os.path.join(dirpath, name)
                h.update(p.encode())
                try:
                    with open(p, "rb") as fh:
                        h.update(fh.read())
                except OSError:
                    h.update(b"?")
    digest = h.hexdigest()
    _src_hash_memo[root] = digest
    return digest


# pending background trace-verifications of fast-key loads (see
# _AotFunction.preload): (name, thread, box) where box[0] becomes True on
# success, or an error string on digest mismatch
_VERIFY_PENDING: list = []


def check_trace_verifications(timeout: float | None = None) -> None:
    """Barrier for fast-key executable loads: block until every pending
    background trace-verification finishes and raise if any mapped digest
    did not match the real trace (the bad mapping is already evicted, so a
    rerun is clean). Product paths that used fast-key preloads MUST call
    this before exposing results — the verification races the stream and
    normally finishes long before finalize, so the barrier costs nothing
    in the non-pathological case."""
    global _VERIFY_PENDING
    pending, _VERIFY_PENDING = _VERIFY_PENDING, []
    for name, t, box in pending:
        t.join(timeout)
        if t.is_alive():
            raise RuntimeError(
                f"aot[{name}]: fast-key trace verification did not finish"
            )
        if box and box[0] is not True:
            raise RuntimeError(
                f"aot[{name}]: fast-key executable mismatch ({box[0]}); "
                "the stale mapping was evicted — rerun this command"
            )


def _fastkey_on() -> bool:
    """Fast-key trace skipping is for COLD processes. Inside the warm-pool
    daemon the in-memory call cache already amortizes tracing across jobs,
    and a background semantic verifier (compile + paired executions)
    racing a live job's dispatch stream was observed to wedge the daemon —
    the fast key buys nothing there and is disabled."""
    if os.environ.get("NTCARD_AOT_FASTKEY", "1") == "0":
        return False
    return not os.environ.get("NTCARD_IN_DAEMON")


def _prune(cache_dir: str, cap: int = 256) -> None:
    """Drop oldest entries past the cap (each entry: .bin/.tree/.ok)."""
    try:
        maps = [n for n in os.listdir(cache_dir) if n.startswith("map_")]
        if len(maps) > 4 * cap:
            maps.sort(key=lambda n: os.path.getmtime(os.path.join(cache_dir, n)))
            for n in maps[: len(maps) - 4 * cap]:
                try:
                    os.unlink(os.path.join(cache_dir, n))
                except OSError:
                    pass
        names = [n for n in os.listdir(cache_dir) if n.endswith(".bin")]
        if len(names) <= cap:
            return
        names.sort(
            key=lambda n: os.path.getmtime(os.path.join(cache_dir, n))
        )
        for n in names[: len(names) - cap]:
            for suffix in (".bin", ".tree", ".ok"):
                try:
                    os.unlink(os.path.join(cache_dir, n[:-4] + suffix))
                except OSError:
                    pass
    except OSError:
        pass


class _AotFunction:
    """Callable wrapping ``jax.jit(fn, ...)`` with the disk-backed
    executable cache described in the module docstring."""

    def __init__(self, fn, static_argnames=(), donate_argnums=()):
        import jax

        self._fn = fn
        self._name = getattr(fn, "__name__", "fn")
        self._jit = jax.jit(
            fn, static_argnames=static_argnames, donate_argnums=donate_argnums
        )
        self._static = tuple(
            (static_argnames,)
            if isinstance(static_argnames, str)
            else static_argnames
        )
        self._sig = inspect.signature(fn)
        # the split below passes leading non-static params positionally
        # (donation is positional; kwargs are never donated) and statics by
        # keyword; that requires every static to TRAIL every array param
        names = list(self._sig.parameters)
        first_static = min(
            (names.index(s) for s in self._static if s in names),
            default=len(names),
        )
        self._splittable = all(
            n in self._static for n in names[first_static:]
        )
        self._calls: dict = {}
        self._lock = threading.Lock()
        self._warned = False

    # -- helpers -----------------------------------------------------------

    def _split(self, args, kwargs):
        """(array_args_positional, static_kwargs) in signature order."""
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        arrays, statics = [], {}
        for name, val in bound.arguments.items():
            if name in self._static:
                statics[name] = val
            else:
                arrays.append(val)
        return tuple(arrays), statics

    @staticmethod
    def _placement(leaves):
        """Device id the call is pinned to: the committed single device of
        the first committed array leaf, None for default placement, or
        "multi" for sharded operands (AOT then defers to plain jit — a
        deserialized executable binds to an explicit device list, and the
        sharded engines are not on the cold-start path). A commitment to
        the DEFAULT device normalizes to None: it executes identically,
        and the preload path (ShapeDtypeStruct specs, no devices at all)
        must land on the same key as the real device_put-committed call —
        without this the boot-thread preload entry was never hit."""
        import jax

        for v in leaves:
            get = getattr(v, "devices", None)
            if callable(get):
                try:
                    ds = get()
                except Exception:
                    continue
                if len(ds) > 1:
                    return "multi"
                if len(ds) == 1 and getattr(v, "committed", True):
                    dev_id = next(iter(ds)).id
                    return None if dev_id == jax.devices()[0].id else dev_id
        return None

    def _call_key(self, arrays, statics):
        import jax

        leaves, treedef = jax.tree_util.tree_flatten(arrays)
        shapes = tuple(
            (getattr(v, "shape", ()), str(getattr(v, "dtype", type(v))))
            for v in leaves
        )
        return (
            treedef,
            shapes,
            tuple(sorted(statics.items())),
            self._placement(leaves),
        )

    def _note(self, msg: str) -> None:
        if os.environ.get("NTCARD_AOT_VERBOSE"):
            sys.stderr.write(f"ntcard: aot[{self._name}]: {msg}\n")

    def _dev_list(self, arrays):
        import jax

        leaves = jax.tree_util.tree_leaves(arrays)
        place = self._placement(leaves)
        if place == "multi":
            raise ValueError("sharded operands: plain jit path")
        # the executable must load onto exactly the device the call is
        # pinned to (deserialize otherwise binds to EVERY client device —
        # wrong on multi-device CPU meshes); the disk payload itself is
        # device-agnostic, so one entry serves any placement
        return [
            next(d for d in jax.devices() if place is None or d.id == place)
        ]

    def _digest_of(self, lowered) -> str:
        key_material = (
            _stack_fingerprint() + "\0" + self._name + "\0" + lowered.as_text()
        )
        return hashlib.sha256(key_material.encode()).hexdigest()

    def _fastkey(self, arrays, statics) -> str:
        """Trace-free key: everything the lowered HLO is a deterministic
        function of — shapes/dtypes/statics, the package SOURCES, the
        trace-time NTCARD_* knobs, and the stack fingerprint. Used only to
        look up a digest→executable mapping that a prior traced run
        recorded; a background semantic check verifies the mapping before
        results are exposed (check_trace_verifications)."""
        import sys as _sys

        import numpy as _np

        key = self._call_key(arrays, statics)
        # only the TRACE-time knobs (daemon.TRACE_KNOBS) — keying on every
        # NTCARD_* var made unrelated env (deadlines, verbosity) miss valid
        # mappings. A knob this list ever misses is exactly what the
        # semantic verification pass exists to catch.
        from ntcard_tpu.daemon import TRACE_KNOBS

        env = [(k, os.environ.get(k, "")) for k in TRACE_KNOBS]
        material = "\0".join(
            [
                "fk1",
                _stack_fingerprint(),
                self._name,
                repr(key),
                _source_hash(),
                repr(env),
                _sys.version,
                _np.__version__,
            ]
        )
        return hashlib.sha256(material.encode()).hexdigest()

    def _load_entry(self, digest, dev_list, arrays):
        """Deserialize + validate the stored executable for ``digest``.
        Raises on ANY problem (caller falls back to the trace path)."""
        import jax
        from jax.experimental.serialize_executable import deserialize_and_load

        base = os.path.join(_cache_dir(), digest)
        with open(base + ".bin", "rb") as fh:
            payload = fh.read()
        with open(base + ".tree", "rb") as fh:
            in_tree, out_tree = pickle.load(fh)
        compiled = deserialize_and_load(
            payload, in_tree, out_tree, execution_devices=dev_list
        )
        # validate on FIRST deserialize, on dummy zero inputs: a broken
        # loader can produce an executable that loads cleanly and fails
        # (or poisons its async outputs) at execution — observed on the
        # XLA:CPU AOT path. Dummies mean a failure consumes no live
        # (possibly donated) state; the block forces async errors out.
        # A prior process's successful validation (the .ok marker)
        # stands in — the failure mode is deterministic per stack, and
        # the marker saves the ~0.7 s dummy execution on every later
        # cold start (load errors are still caught regardless).
        if not os.path.exists(base + ".ok"):
            import jax.numpy as jnp

            dummies = jax.tree_util.tree_map(
                lambda v: jax.device_put(
                    jnp.zeros(v.shape, v.dtype), dev_list[0]
                ),
                arrays,
            )
            out = compiled(*dummies)
            jax.block_until_ready(out)
            del out, dummies
            with open(base + ".ok", "w"):
                pass
        return compiled

    @staticmethod
    def _evict(digest) -> None:
        base = os.path.join(_cache_dir(), digest)
        for suffix in (".bin", ".tree", ".ok"):
            try:
                os.unlink(base + suffix)
            except OSError:
                pass

    def _prepare(self, arrays, statics, fastkey: str | None = None):
        """Build (or load) the compiled executable for this call shape.
        ``fastkey``: when given, a prior run's fastkey→digest mapping
        skips the ~2 s client-side trace — the trace then runs on a
        BACKGROUND thread purely to verify the mapping
        (check_trace_verifications is the consuming barrier)."""
        import jax
        from jax.experimental.serialize_executable import serialize

        dev_list = self._dev_list(arrays)
        cache_dir = _cache_dir()
        leaves = jax.tree_util.tree_leaves(arrays)
        if self._placement(leaves) is None:
            # canonicalize: lower from bare shape specs, never from live
            # arrays — lowering text differs between committed-array and
            # spec inputs (observed: the same program traced both ways
            # yields different digests), and the fastkey mapping as well
            # as cross-process payload reuse need ONE canonical digest.
            # Spec-lowered executables bind the default device, which IS
            # this placement.
            arrays = jax.tree_util.tree_map(
                lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype), arrays
            )
        else:
            fastkey = None  # pinned placements: no canonical mapping
        if fastkey is not None:
            map_path = os.path.join(cache_dir, "map_" + fastkey)
            try:
                with open(map_path) as fh:
                    digest = fh.read().strip()
                compiled = self._load_entry(digest, dev_list, arrays)
            except Exception:
                pass  # no/stale mapping: trace path below
            else:
                if os.path.exists(map_path + ".vok"):
                    # this mapping already passed a cross-process semantic
                    # verification: pure fast path, no trace at all
                    self._note("fast-key load (verified mapping)")
                    return compiled
                # first cross-process use of the mapping: verify it
                # SEMANTICALLY in the background — trace + compile fresh,
                # run both executables on identical random inputs, demand
                # bitwise-equal outputs (a digest comparison would need the
                # very trace the fast key exists to skip). The
                # check_trace_verifications barrier consumes the result
                # before any results leave the process.
                self._note("fast-key load (semantic verification in background)")
                box: list = [None]

                def _verify(compiled=compiled, arrays=arrays, statics=statics):
                    import numpy as np

                    try:
                        import jax as _jax

                        fresh = self._jit.lower(*arrays, **statics).compile()
                        rng = np.random.default_rng(0)

                        def mk(v):
                            dt = np.dtype(v.dtype)
                            if dt.kind in "iu":
                                hi = min(np.iinfo(dt).max, 1 << 20)
                                return rng.integers(
                                    0, hi, size=v.shape
                                ).astype(dt)
                            return rng.standard_normal(v.shape).astype(dt)

                        base = _jax.tree_util.tree_map(mk, arrays)

                        def put(tree):
                            return _jax.tree_util.tree_map(
                                lambda x: _jax.device_put(x, dev_list[0]),
                                tree,
                            )

                        out_a = compiled(*put(base))
                        out_b = fresh(*put(base))
                        la = _jax.tree_util.tree_leaves(out_a)
                        lb = _jax.tree_util.tree_leaves(out_b)
                        if len(la) != len(lb):
                            raise AssertionError("output arity differs")
                        bad = 0
                        for x, y in zip(la, lb):
                            bad = bad + (x != y).sum()
                        mismatch = int(np.asarray(bad)) != 0
                    except AssertionError as e:
                        mismatch, err = True, str(e)
                    except Exception as e:
                        # infrastructure failure (storm, compile error):
                        # inconclusive — the executable already passed
                        # dummy validation; retry verification next run
                        self._note(f"semantic verify inconclusive: {e!r}")
                        box[0] = True
                        return
                    else:
                        err = "outputs differ on random input"
                    if mismatch:
                        try:
                            os.unlink(map_path)
                        except OSError:
                            pass
                        box[0] = err
                    else:
                        try:
                            with open(map_path + ".vok", "w"):
                                pass
                        except OSError:
                            pass
                        box[0] = True

                t = threading.Thread(
                    target=_verify, daemon=True, name="ntcard-aot-verify"
                )
                t.start()
                _VERIFY_PENDING.append((self._name, t, box))
                return compiled
        lowered = self._jit.lower(*arrays, **statics)
        digest = self._digest_of(lowered)
        self._note(f"traced digest {digest[:8]}")
        base = os.path.join(cache_dir, digest)
        try:
            compiled = self._load_entry(digest, dev_list, arrays)
        except FileNotFoundError:
            pass
        except Exception as e:
            self._note(f"stale/corrupt cache entry, recompiling: {e!r}")
            self._evict(digest)
        else:
            self._note("loaded serialized executable")
            if fastkey is not None:
                self._write_map(cache_dir, fastkey, digest)
            return compiled
        compiled = lowered.compile()
        try:
            payload, in_tree, out_tree = serialize(compiled)
            os.makedirs(cache_dir, exist_ok=True)
            # write-then-rename so a concurrent process never reads a torn
            # payload (the digest names the content, so last-writer-wins
            # races are benign)
            for suffix, data in (
                (".bin", payload),
                (".tree", pickle.dumps((in_tree, out_tree))),
            ):
                tmp = base + suffix + f".tmp{os.getpid()}"
                with open(tmp, "wb") as fh:
                    fh.write(data)
                os.replace(tmp, base + suffix)
            if fastkey is not None:
                self._write_map(cache_dir, fastkey, digest)
            _prune(cache_dir)
        except Exception as e:
            self._note(f"serialize unsupported here, caching skipped: {e!r}")
        return compiled

    @staticmethod
    def _write_map(cache_dir: str, fastkey: str, digest: str) -> None:
        try:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = os.path.join(cache_dir, f"map_{fastkey}.tmp{os.getpid()}")
            with open(tmp, "w") as fh:
                fh.write(digest)
            os.replace(tmp, os.path.join(cache_dir, "map_" + fastkey))
        except OSError:
            pass

    def clear_cache(self) -> None:
        """jit-API compat: drop the in-memory call cache (trace-knob tests
        flip NTCARD_* env vars that are baked into traced programs). The
        DISK cache needs no clearing — its key is the lowered HLO text, so
        a knob flip re-traces to a different digest."""
        with self._lock:
            self._calls.clear()
        self._jit.clear_cache()

    def preload(self, *args, **kwargs) -> bool:
        """Load (deserialize or AOT-compile) the executable for this call
        shape WITHOUT running it — argument arrays may be
        ``jax.ShapeDtypeStruct`` specs. Meant for boot threads: the
        ~0.7-4 s first-call executable load then overlaps input decode
        instead of serializing in front of the first dispatch (the
        function-level lock makes a racing real call WAIT for this load
        rather than duplicate it). No-op when AOT is disabled (the plain
        jit path has no way to pre-load without executing). Returns True
        when an executable is ready."""
        if not self._splittable or not _enabled():
            return False
        try:
            arrays, statics = self._split(args, kwargs)
            key = self._call_key(arrays, statics)
        except Exception:
            return False
        if self._calls.get(key) is not None:
            return self._calls[key] is not False
        fastkey = None
        if _fastkey_on():
            try:
                fastkey = self._fastkey(arrays, statics)
                self._note(f"fastkey {fastkey[:12]}")
            except Exception as e:
                self._note(f"fastkey unavailable: {e!r}")
                fastkey = None
        with self._lock:
            if self._calls.get(key) is None:
                try:
                    self._calls[key] = self._prepare(
                        arrays, statics, fastkey=fastkey
                    )
                except Exception as e:
                    self._note(f"preload failed: {e!r}")
                    self._calls[key] = False
            return self._calls[key] is not False

    # -- call --------------------------------------------------------------

    def __call__(self, *args, **kwargs):
        if not self._splittable or not _enabled():
            return self._jit(*args, **kwargs)
        try:
            import jax

            arrays, statics = self._split(args, kwargs)
            # under an enclosing trace (this fn used inside another jitted
            # program) a compiled executable cannot be called — inline via
            # the plain jit path exactly as before
            leaves = jax.tree_util.tree_leaves(arrays)
            if any(isinstance(v, jax.core.Tracer) for v in leaves):
                return self._jit(*args, **kwargs)
            key = self._call_key(arrays, statics)
        except Exception:
            return self._jit(*args, **kwargs)
        entry = self._calls.get(key)
        if entry is None:
            # the first real dispatch can WIN the race against the
            # boot-thread preload to this lock — compute the fast key here
            # too (memoized source hash + one sha, ~10 ms) so whichever
            # side prepares first still skips the ~2 s trace on a mapping
            # hit and records the mapping for the next cold process
            fastkey = None
            if _fastkey_on():
                try:
                    fastkey = self._fastkey(arrays, statics)
                except Exception:
                    fastkey = None
            with self._lock:
                entry = self._calls.get(key)
                if entry is None:
                    try:
                        entry = self._prepare(arrays, statics, fastkey=fastkey)
                    except Exception as e:
                        self._note(f"aot disabled for this shape: {e!r}")
                        entry = False
                    self._calls[key] = entry
        if entry is False:
            return self._jit(*args, **kwargs)
        return entry(*arrays)


def aot_jit(fn=None, *, static_argnames=(), donate_argnums=()):
    """``jax.jit`` drop-in with the client-side AOT executable cache.
    Usable bare (``@aot_jit``) or with the jit kwargs this codebase uses."""
    if fn is None:
        return lambda f: _AotFunction(
            f, static_argnames=static_argnames, donate_argnums=donate_argnums
        )
    return _AotFunction(
        fn, static_argnames=static_argnames, donate_argnums=donate_argnums
    )
