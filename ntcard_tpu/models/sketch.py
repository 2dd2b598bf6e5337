"""The ntCard sampled count-table sketch as a device-resident model.

The reference keeps one shared ``uint16[nK][2][2^rBits]`` table updated with
``#pragma omp atomic`` increments (ntcard.cpp:132-145, 437-439). Here the
table is a pure functional state: per batch the fused hash+sample kernel
(ops/nthash.sketch_scan) produces flat index streams, and a scatter-add folds
them into per-k int32 tables. Addition commutes, so any batching/sharding
order yields the same table; the uint16 wraparound of the reference is
recovered exactly at finalization time by ``% 65536`` (int32 accumulation
overflows only after 2^31 hits on one bucket — unreachable: each hit requires
a sampled k-mer occurrence, and F1 fits well under 2^31 per bucket in any
real workload; the wrap test covers the semantics).

Sharding story (SURVEY.md §2.6): tables are private per data-parallel shard
and merged by summation — the collective analog of the reference's atomics —
so 1-shard and N-shard runs are bit-identical by construction.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Dict, Sequence

from ntcard_tpu import _jax_config  # noqa: F401  (platform/cache config before backend init)
import jax
import jax.numpy as jnp
import numpy as np

from ntcard_tpu.ops.nthash import sketch_scan
from ntcard_tpu.utils.aot import aot_jit


def _u64_acc_add(hi, lo, add_u32):
    """Exact unsigned-64 accumulate in a (hi, lo) uint32 pair — jax x64 stays
    off (_jax_config), so device int64 is unavailable, and draining to the
    host mid-stream would add a device->host sync per batch."""
    new_lo = lo + add_u32
    carry = (new_lo < add_u32).astype(jnp.uint32)
    return hi + carry, new_lo


def _table_add(table, idx, r_bits):
    """table[2*r_buck+1] += histogram(idx) for one k's emit stream.

    The emit stream marks "no update" with the sentinel 2*r_buck, and at the
    default sampling rates ~98.8% of a batch's windows carry it. The
    sentinel is mapped past the table's end, where the scatter drops it, so
    only the sampled windows issue an update (a GPU scatter-add is an atomic
    per update; ~99% of them on one address would serialize). Row 2*r_buck
    of the table is therefore never written.

    The reference semantics this preserves: every sampled k-mer increments
    its bucket exactly once (ntcard.cpp:437-439)."""
    sent = np.int32(2 * (1 << r_bits))
    dropped = np.int32(table.shape[0])
    return table.at[jnp.where(idx == sent, dropped, idx)].add(1, mode="drop")


def _table_add_dump(table, idx):
    """The other plain form of _table_add: sentinels land in the table's
    last row (2*r_buck, never read). Same table rows 0..2*r_buck-1; kept as
    the baseline that chip_smoke.py times _table_add against on the card."""
    return table.at[idx].add(1, mode="drop")


def _update_impl(tables, f1s, codes, ks, stride, s_bits, r_bits, mask_positions, packed=False):
    """One batch step: tables = tuple of nK int32[2*rbuck+1] arrays; f1s
    [nK, 2] uint32 (hi, lo) exact 64-bit F1 accumulators. Returns
    (tables, f1s).

    Tables are SEPARATE per-k buffers, never a stacked [nK, T] array: each
    k's scatter then touches only its own buffer, and re-stacking per-k
    results would copy the GiB-scale default-r27 tables every batch."""
    idx, f1 = sketch_scan(codes, ks, stride, s_bits, r_bits, mask_positions, packed=packed)
    new_f1s = []
    new_tables = []
    for i, k in enumerate(ks):
        hi, lo = _u64_acc_add(f1s[i, 0], f1s[i, 1], f1[k].astype(jnp.uint32))
        new_f1s.append(jnp.stack([hi, lo]))
        new_tables.append(_table_add(tables[i], idx[k], r_bits))
    return tuple(new_tables), jnp.stack(new_f1s)


_STEP_STATICS = ("ks", "stride", "s_bits", "r_bits", "mask_positions", "packed")


@partial(aot_jit, static_argnames=_STEP_STATICS, donate_argnums=(0, 1))
def _update(tables, f1s, codes, ks, stride, s_bits, r_bits, mask_positions, packed=False):
    """Jitted single-batch step (tables and F1 accumulators donated)."""
    return _update_impl(tables, f1s, codes, ks, stride, s_bits, r_bits, mask_positions, packed)


@partial(aot_jit, static_argnames=_STEP_STATICS, donate_argnums=(0,))
def _update_first(f1s, codes, ks, stride, s_bits, r_bits, mask_positions, packed=False):
    """First-batch step with the table allocation FUSED into the program:
    the per-k zero tables are created in here rather than by a separate
    _make_tables dispatch, so a cold CLI run compiles and loads one program
    fewer on its startup chain (the sketch allocates lazily —
    CountTableSketch.tables property)."""
    tables = tuple(jnp.zeros((2 * (1 << r_bits) + 1,), jnp.int32) for _ in ks)
    return _update_impl(tables, f1s, codes, ks, stride, s_bits, r_bits, mask_positions, packed)


@partial(aot_jit, static_argnames=_STEP_STATICS, donate_argnums=(0, 1))
def _update_stack(tables, f1s, stack, ks, stride, s_bits, r_bits, mask_positions, packed=False):
    """Super-batch step: fold a [n, rows, width] stack of same-format wire
    batches with an on-device lax.scan — ONE host->device put and ONE
    dispatch for n batches. Bit-identical to n single _update calls (the
    same fold body applied in the same order)."""

    def body(carry, codes):
        t, f = carry
        return _update_impl(t, f, codes, ks, stride, s_bits, r_bits, mask_positions, packed), None

    (tables, f1s), _ = jax.lax.scan(body, (tables, f1s), stack)
    return tables, f1s


@partial(aot_jit, static_argnames=("nk", "n"))
def _make_tables(nk, n):
    """All nK per-k table buffers in ONE program (one dispatch instead of
    nK GiB-scale jnp.zeros calls)."""
    return tuple(jnp.zeros((n,), jnp.int32) for _ in range(nk))


@partial(aot_jit, donate_argnums=(0,))
def _merge_add(a, b):
    # donate only `a` (the output aliases it); donating `b` too is unusable
    # and makes every run print a donation warning. tree.map handles both
    # the per-k table tuples and plain arrays (f1s, sharded stacks).
    return jax.tree.map(jnp.add, a, b)


def _hist_row(row, nbins):
    """int32[r_buck] -> int32[nbins]: bins 0..nbins-1 of the histogram of the
    counters mod 2^16 (compEst's p[sample][v], ntcard.cpp:240-247).

    One pass over the row, exact for any density: the zero (untouched)
    buckets — nearly all of a sparse row — are counted by a reduction, and
    only counters with 1 <= v < nbins are scattered into their bins;
    everything else is mapped past the end and dropped. Scattering the
    zeros too would put one atomic per untouched bucket on bin 0."""
    v = row & 0xFFFF
    zeros = (v == 0).sum(dtype=jnp.int32)
    idx = jnp.where((v > 0) & (v < nbins), v, np.int32(nbins))
    h = jnp.zeros((nbins,), jnp.int32).at[idx].add(1, mode="drop")
    return h.at[0].set(zeros)


def _hist_rows(tables, r_buck, nbins):
    """Traced helper: every (k, sample) row's histogram, [2nK, nbins]."""
    return jnp.stack(
        [
            _hist_row(jax.lax.dynamic_slice(t, (s * r_buck,), (r_buck,)), nbins)
            for t in tables
            for s in range(2)
        ]
    )


@partial(aot_jit, static_argnames=("r_buck", "nbins"))
def _hists_all(tables, r_buck, nbins):
    """Every (k, sample) row's counter histogram in ONE program and ONE
    fetched array ([2nK, nbins] int32)."""
    return _hist_rows(tables, r_buck, nbins)


@partial(aot_jit, static_argnames=("r_buck", "nbins"))
def _finalize_bundle(tables, f1s, r_buck, nbins):
    """Everything the device finalize needs in ONE program and ONE fetched
    flat int32 array: the [2nK, nbins] histograms, row-major, followed by
    the 2nK F1 (hi, lo) words. NOT donating: the warm-loading path
    (warm_finalize) runs this on the live tables mid-stream."""
    f1_words = jax.lax.bitcast_convert_type(f1s.reshape(-1), jnp.int32)
    return jnp.concatenate([_hist_rows(tables, r_buck, nbins).reshape(-1), f1_words])


def _counter_hists_device(tables, r_buck, nbins):
    """sequence of nK int32[2*r_buck+1] tables -> [nK, 2, nbins] int32,
    computed on device so only KBs cross to the host instead of the (up to
    1 GB/k) tables themselves."""
    return np.asarray(_hists_all(tables, r_buck, nbins)).reshape(len(tables), 2, nbins)


def _counter_hists(tables, r_buck, nbins: int = 65536):
    """Counter-value histograms over bins 0..nbins-1 ([nK, 2, nbins] int32)
    of a sequence of nK per-k tables (int32[2*r_buck(+1)] each), routed by
    where they live: XLA's CPU scatter is serial and slow at rBits=27 (tens
    of seconds for 2^28 elements), so host tables go through the native
    threaded histogram / np.bincount; on a GPU the tables never leave the
    device (_counter_hists_device)."""
    t0 = tables[0]
    dev = next(iter(t0.devices())) if hasattr(t0, "devices") else None
    if dev is not None and dev.platform != "cpu":
        return _counter_hists_device(tables, r_buck, nbins)
    from ntcard_tpu import native

    nk = len(tables)
    out = np.empty((nk, 2, 65536), np.int64)
    for i in range(nk):
        arr = np.asarray(tables[i])  # zero-copy view when host-resident
        for s in range(2):
            row = arr[s * r_buck : (s + 1) * r_buck]  # contiguous view
            h = native.hist_u16(row)
            if h is None:
                h = np.bincount(row.astype(np.uint16), minlength=65536)
            out[i, s] = h
    return out[:, :, :nbins].astype(np.int32)


class ChainedCountTableSketch:
    """N independent CountTableSketch donation chains fed round-robin, merged
    at finalize: consecutive updates of ONE donated table serialize, and
    independent chains let transfers and dispatches interleave. The fold
    commutes, so the merged result is bit-identical to a single chain."""

    def __init__(self, *args, n_chains: int = 2, **kwargs):
        probe = CountTableSketch(*args, **kwargs)
        # chains multiply resident table memory; cap them so total table
        # bytes stay within budget (default-r27 multi-k tables are
        # GiB-scale, so the 4 GiB default collapses them to one chain while
        # r<=20 runs keep two)
        budget = int(os.environ.get("NTCARD_CHAIN_TABLE_BYTES", 4 << 30))
        # from the config, NOT probe.tables (those allocate lazily)
        table_bytes = len(probe.ks) * (2 * probe.r_buck + 1) * 4
        n_chains = max(1, min(n_chains, budget // max(table_bytes, 1)))
        self._chains = [probe] + [
            CountTableSketch(*args, **kwargs) for _ in range(n_chains - 1)
        ]
        self._i = 0
        s0 = self._chains[0]
        self.ks, self.s_bits, self.r_bits = s0.ks, s0.s_bits, s0.r_bits
        self.stride, self.gap_positions, self.r_buck = s0.stride, s0.gap_positions, s0.r_buck

    def update(self, codes, packed: bool = False) -> None:
        self._chains[self._i].update(codes, packed=packed)
        self._i = (self._i + 1) % len(self._chains)

    def merged(self) -> "CountTableSketch":
        head = self._chains[0]
        for other in self._chains[1:]:
            head.merge_(other)
        self._chains = [head]
        self._i = 0
        return head

    def save(self, path: str) -> None:
        self.merged().save(path)

    def merge_host_(self, host) -> None:
        self._chains[0].merge_host_(host)

    def warm_update(self, wire_rows: int, wire_cols: int, packed) -> list:
        # the update programs are module-level and shape-keyed, so one
        # preload serves every chain
        return self._chains[0].warm_update(wire_rows, wire_cols, packed)

    def warm_finalize(self, cov_max: int = 65535) -> list:
        """Pre-load the finalize executables (CountTableSketch.warm_finalize)
        — one load serves every chain (identical program signatures). With
        >1 chain the finalize-time merge program is warmed too, but ONLY
        when its dummy operands are cheap: at 2-chain boundary configs
        (e.g. single-k rBits=27, ~1.07 GiB/table) the two extra table sets
        would be a multi-GiB transient memory spike racing the live update
        allocations — there, finalize just pays the one-time load."""
        threads = self._chains[0].warm_finalize(cov_max=cov_max)
        nk = len(self.ks)
        table_bytes = 2 * nk * (2 * self.r_buck + 1) * 4  # both dummy sets
        if len(self._chains) > 1 and table_bytes <= (256 << 20):
            import threading

            def _w_merge():
                try:
                    a = _make_tables(nk, 2 * self.r_buck + 1)
                    b = _make_tables(nk, 2 * self.r_buck + 1)
                    _merge_add(a, b)
                except Exception:
                    pass

            t = threading.Thread(target=_w_merge, daemon=True)
            t.start()
            threads.append(t)
        return threads

    def finalize(self, return_table: bool = False, cov_max: int = 65535):
        return self.merged().finalize(return_table=return_table, cov_max=cov_max)


class CountTableSketch:
    """Streaming ntcard sketch over one device.

    feed [B, L] uint8 batches via :meth:`update`; :meth:`finalize` returns
    the reference-equivalent counter-value histograms (and, on request, the
    raw uint16 tables) plus exact F1 counts."""

    def __init__(
        self,
        ks: Sequence[int],
        s_bits: int,
        r_bits: int,
        stride: int,
        gap_positions: Sequence[int] | None = None,
    ):
        if stride % 8 or stride < 8:
            raise ValueError(
                f"stride ({stride}) must be a positive multiple of 8 — use "
                "io.packing.aligned_stride(chunk_len, kmax) so the sketch and "
                "packer agree on window ownership"
            )
        self.ks = tuple(ks)
        self.s_bits = s_bits
        self.r_bits = r_bits
        self.stride = stride
        self.gap_positions = tuple(gap_positions) if gap_positions else None
        self.r_buck = 1 << r_bits
        nk = len(self.ks)
        # per-k SEPARATE table buffers (see _update_impl). Allocated LAZILY:
        # the first update runs _update_first, which fuses the zero-fill
        # into the update program. Readers of .tables (merge, save, finalize
        # on an empty sketch, multihost helpers) transparently get zero
        # tables via the property.
        self._tables = None
        self.f1s = jnp.zeros((nk, 2), jnp.uint32)  # (hi, lo) u64 accumulators
        self._f1_loaded = [0] * nk  # merged-in totals from load/merge_

    @property
    def tables(self):
        if self._tables is None:
            self._tables = _make_tables(len(self.ks), 2 * self.r_buck + 1)
        return self._tables

    @tables.setter
    def tables(self, value):
        self._tables = value

    def _f1_totals(self):
        """Exact per-k F1 as Python ints (single device->host transfer)."""
        vals = np.asarray(self.f1s)
        return [
            self._f1_loaded[i] + ((int(vals[i, 0]) << 32) | int(vals[i, 1]))
            for i in range(len(self.ks))
        ]

    def warm_update(self, wire_rows: int, wire_cols: int, packed) -> list:
        """Pre-load the first-batch and steady-state update executables on
        a background thread (utils/aot.preload) for a known wire geometry —
        each program's first call otherwise pays its compile (or AOT load)
        serially in front of the first dispatch; started from the CLI boot
        thread the loads overlap input decode and the first H2D puts. A
        geometry mismatch (e.g. a per-batch nibble fallback) just wastes the
        preload — the real call loads its own program exactly as before.
        Returns the started threads."""
        import threading

        from jax import ShapeDtypeStruct

        nk = len(self.ks)
        spec_args = (
            ShapeDtypeStruct((nk, 2), jnp.uint32),
            ShapeDtypeStruct((wire_rows, wire_cols), jnp.uint8),
            self.ks,
            self.stride,
            self.s_bits,
            self.r_bits,
            self.gap_positions,
            packed,
        )
        tables_spec = tuple(
            ShapeDtypeStruct((2 * self.r_buck + 1,), jnp.int32) for _ in range(nk)
        )
        targets = [(_update_first, spec_args), (_update, (tables_spec,) + spec_args)]

        # ONE thread, in dispatch order: the preload cost is dominated by
        # client-side tracing, which the GIL serializes anyway — two
        # concurrent preloads would each take ~2x wall and the FIRST
        # dispatch blocks on _update_first alone. The steady-state program
        # warms while batch 1 executes.
        def _warm_all():
            for fn, args in targets:
                fn.preload(*args)

        t = threading.Thread(target=_warm_all, daemon=True, name="ntcard-aot-warm")
        t.start()
        return [t]

    def update(self, codes: np.ndarray, packed: bool = False) -> None:
        """codes: [B, L] uint8, or a wire batch when ``packed`` (see
        io/packing.py) — or a [n, rows, width] stack of same-format wire
        batches (pipeline superbatching), folded by one scanning dispatch."""
        statics = (self.ks, self.stride, self.s_bits, self.r_bits, self.gap_positions, packed)
        if self._tables is None and codes.ndim == 2:
            # first batch: table alloc fused into the update program (one
            # executable load fewer on a cold start)
            self._tables, self.f1s = _update_first(self.f1s, codes, *statics)
        else:
            fn = _update_stack if codes.ndim == 3 else _update
            self.tables, self.f1s = fn(self.tables, self.f1s, codes, *statics)

    def save(self, path: str) -> None:
        """Checkpoint the sketch state (pure, commutative — partial runs can
        be merged offline; the reference has no equivalent, SURVEY.md §5)."""
        from ntcard_tpu.utils.aot import check_trace_verifications

        check_trace_verifications()  # fast-key loads must verify first
        np.savez_compressed(
            path,
            tables=np.asarray(self.tables),
            f1s=np.asarray(self._f1_totals(), np.int64),
            ks=np.asarray(self.ks, np.int64),
            s_bits=self.s_bits,
            r_bits=self.r_bits,
            stride=self.stride,
            gap=np.asarray(self.gap_positions or [], np.int64),
        )

    @classmethod
    def load(cls, path: str) -> "CountTableSketch":
        z = np.load(path)
        gap = tuple(int(x) for x in z["gap"]) or None
        self = cls(
            tuple(int(k) for k in z["ks"]),
            int(z["s_bits"]),
            int(z["r_bits"]),
            int(z["stride"]),
            gap_positions=gap,
        )
        self.tables = tuple(jnp.asarray(z["tables"][i]) for i in range(len(self.ks)))
        self._f1_loaded = [int(v) for v in z["f1s"]]
        return self

    def _check_config(self, other) -> None:
        """The full hash configuration must match — summing sketches built
        with different spaced seeds or strides would silently sum
        semantically incompatible tables."""
        mine = (self.ks, self.s_bits, self.r_bits, self.stride, self.gap_positions)
        theirs = (other.ks, other.s_bits, other.r_bits, other.stride, other.gap_positions)
        if mine != theirs:
            raise ValueError(f"sketch configs differ; cannot merge ({mine} vs {theirs})")

    def merge_(self, other: "CountTableSketch") -> None:
        """Fold another sketch's counts into this one (sum merge)."""
        self._check_config(other)
        # at default rBits the tables are GiB-scale; _merge_add donates ours
        # and other's are dropped, so at most three copies are live mid-merge
        self.tables = _merge_add(self.tables, other.tables)
        other.tables = None
        self._f1_loaded = [a + b for a, b in zip(self._f1_loaded, other._f1_totals())]

    def merge_host_(self, host) -> None:
        """Fold a HostCountTableSketch's counts into this device sketch (the
        hybrid-engine merge): the host's uint16 table rides one small H2D put
        and sums into the int32 table — summing uint16-wrapped counts mod
        2^16 equals summing unwrapped counts mod 2^16, so finalize's wrap
        recovers the exact single-engine histogram. Only sensible when the
        host table is small (the CLI gates hybrid on r_bits)."""
        self._check_config(host)
        nk = len(self.ks)
        padded = []
        for i in range(nk):
            t32 = np.zeros((2 * self.r_buck + 1,), np.int32)
            t32[: 2 * self.r_buck] = host.tables[i]
            padded.append(jnp.asarray(t32))
        self.tables = _merge_add(self.tables, tuple(padded))
        self._f1_loaded = [a + int(b) for a, b in zip(self._f1_loaded, host.f1s)]

    def _bundle_ok(self) -> bool:
        """The fused one-fetch finalize applies where the tables live on an
        accelerator. NTCARD_FINALIZE=fused forces it on CPU (tests);
        NTCARD_FINALIZE=unfused disables it."""
        env = os.environ.get("NTCARD_FINALIZE", "auto")
        if env in ("fused", "unfused"):
            return env == "fused"
        t0 = self.tables[0]
        dev = next(iter(t0.devices())) if hasattr(t0, "devices") else None
        return dev is not None and dev.platform != "cpu"

    def _finalize_fused(self, nbins: int):
        """One program + ONE device->host fetch for hists and F1
        (_finalize_bundle): -> (hists [nK, 2, nbins], f1 totals list)."""
        nk = len(self.ks)
        flat = np.asarray(_finalize_bundle(self.tables, self.f1s, self.r_buck, nbins))
        hists = flat[: 2 * nk * nbins].reshape(nk, 2, nbins)
        words = flat[2 * nk * nbins :].astype(np.int64) & 0xFFFFFFFF
        f1s = [
            self._f1_loaded[i] + int((words[2 * i] << 32) | words[2 * i + 1])
            for i in range(nk)
        ]
        return hists, f1s

    def warm_finalize(self, cov_max: int = 65535) -> list:
        """Pre-load the finalize-bundle executable on a background thread.

        The CLI calls this right after its first real update dispatch, so
        the finalize program compiles (or loads from the AOT store) during
        the dispatch loop instead of serializing into finalize. The warm
        call runs on the live tables — _finalize_bundle does not donate,
        its result is discarded unfetched, and it chains behind whatever
        updates are in flight (pure latency hiding)."""
        import threading

        if self._tables is None or not self._bundle_ok():
            return []  # nothing dispatched yet, or finalize runs on the host
        nbins = min(cov_max + 1, 65536)

        def _w_finalize():
            try:
                _finalize_bundle(self.tables, self.f1s, self.r_buck, nbins)
            except Exception:
                pass  # warm-loading is best-effort; the real call will load

        t = threading.Thread(target=_w_finalize, daemon=True)
        t.start()
        return [t]

    def finalize(self, return_table: bool = False, cov_max: int = 65535) -> Dict[int, dict]:
        """-> {k: {"hist": int64[2, <=cov_max+1], "f1": int, ["table": ...]}}.

        "hist" is compEst's counter-value histogram, computed where the
        tables live and sliced to the cov_max+1 bins the estimator reads;
        return_table=True additionally pulls the raw uint16 table (large —
        test/debug use)."""
        from ntcard_tpu.utils.aot import check_trace_verifications

        check_trace_verifications()  # fast-key loads must verify first
        nbins = min(cov_max + 1, 65536)
        if self._bundle_ok():
            hists, f1s = self._finalize_fused(nbins)
        else:
            hists = np.asarray(_counter_hists(self.tables, self.r_buck, nbins))
            f1s = self._f1_totals()
        out = {}
        for i, k in enumerate(self.ks):
            out[k] = {"hist": hists[i].astype(np.int64), "f1": f1s[i]}
            if return_table:
                t = np.asarray(self.tables[i][: 2 * self.r_buck]).astype(np.uint16)
                out[k]["table"] = t.reshape(2, self.r_buck)
        return out
