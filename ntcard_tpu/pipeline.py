"""Host-side streaming pipeline: files -> records -> packed batches -> device.

The reference parallelizes *across files* with a shared atomic table
(ntcard.cpp:445-467) — its main perf weakness (a single big file is serial).
Here every file's records feed one packed stream (order irrelevant: the
sketch is a commutative fold), cut into dense [B, L] batches that stream to
the device sketch. Record boundaries are N separators, so per-record window
semantics are preserved exactly (ops/nthash.py docstring).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from ntcard_tpu.io.decompress import DecompressError, open_input
from ntcard_tpu.io.packing import StreamPacker
from ntcard_tpu.io.readers import records_from_stream


def iter_file_records(
    paths: Sequence[str], lenient: bool = False, on_error: str = "exit"
) -> Iterator[bytes]:
    """All sequence records of all input files, with the reference's error
    contract: unreadable/unknown-format file -> message + exit(1)
    (ntcard.cpp:459-462); on_error="skip" silently skips unreadable files
    (nthll contract)."""
    for path in paths:
        try:
            stream = open_input(path)
        except DecompressError as e:
            # missing filter program: clean fail-fast, mirroring the
            # reference's SIGCHLD reaper contract (SignalHandler.cpp:38-52)
            if on_error == "skip":
                continue
            print(f"error: {e}", file=sys.stderr)
            raise SystemExit(1)
        except (OSError, ValueError):
            if on_error == "skip":
                continue
            print(f"Error in reading file: {path}", file=sys.stderr)
            raise SystemExit(1)
        try:
            with stream:
                try:
                    yield from records_from_stream(stream, path, lenient=lenient)
                except ValueError:
                    if on_error == "skip":
                        continue
                    print(f"Error in reading file: {path}", file=sys.stderr)
                    raise SystemExit(1)
        except DecompressError as e:
            # fail-fast on decompressor child failure (SignalHandler.cpp:32-62)
            print(f"error: {e}", file=sys.stderr)
            raise SystemExit(1)


def batches_from_files(
    paths: Sequence[str],
    chunk_len: int,
    batch_rows: int,
    kmax: int,
    records: Optional[Iterable[bytes]] = None,
    lenient: bool = False,
    on_error: str = "exit",
    stats_out: Optional[dict] = None,
    wire_packed: bool = False,
) -> Iterator[np.ndarray]:
    """Dense [batch_rows, chunk_len] uint8 batches over all input records —
    or, with ``wire_packed``, H2D wire batches: True/"nibble" gives
    [batch_rows/2, chunk_len] nibble wire (io/packing.pack_rows), "quad"
    gives the [batch_rows/4 + batch_rows/64, chunk_len] 2-bit wire
    (io/packing.pack_rows_quad) with automatic per-batch nibble fallback on
    N-count overflow; consumers pass packed=io.packing.wire_mode_of(...) to
    sketch.update.

    Uses the native C++ decode+pack layer when available (~10x the Python
    path, with the wire pack fused into the batch composition pass); both
    paths produce byte-identical batch streams (tests/test_native_packer.py)."""
    if records is None:
        from ntcard_tpu.native import get_lib, native_batches_from_files

        if get_lib() is not None:
            yield from native_batches_from_files(
                paths, chunk_len, batch_rows, kmax, lenient=lenient,
                on_error=on_error, stats_out=stats_out, wire_packed=wire_packed,
            )
            return
    from ntcard_tpu.io.packing import pack_wire

    packer = StreamPacker(chunk_len, batch_rows, kmax)

    def wire(b):
        return pack_wire(b, wire_packed, packer.stride)
    recs = records if records is not None else iter_file_records(paths, lenient, on_error)
    for rec in recs:
        for b in packer.feed(rec):
            yield wire(b)
    for b in packer.finish():
        yield wire(b)
    if stats_out is not None:
        stats_out["records"] = packer.total_records
        stats_out["bases"] = packer.total_bases - packer.total_records  # minus separators


def default_geometry(kmax: int, target_chunk: int = 1024, batch_rows: int = 8192):
    """Pick (chunk_len, batch_rows): chunk_len comfortably above kmax so halo
    overhead (kmax-1)/chunk_len stays small; batch_rows sized so one batch
    (~8 Mbases) amortizes per-dispatch overhead."""
    chunk_len = max(target_chunk, 8 * kmax)
    return chunk_len, batch_rows


_STATS_LOCK = threading.Lock()


def parallel_batches_from_files(
    paths: Sequence[str],
    chunk_len: int,
    batch_rows: int,
    kmax: int,
    n_threads: int,
    lenient: bool = False,
    on_error: str = "exit",
    stats_out: Optional[dict] = None,
    wire_packed: bool = False,
) -> Iterator[np.ndarray]:
    """Decode+pack files on ``n_threads`` host threads, one packer per
    thread over a deterministic file partition (parallel/multihost.py LPT) —
    the reference's file-level parallelism (`omp parallel for` over files,
    ntcard.cpp:445) without its shared-table atomics: batch order is
    irrelevant because the sketch fold commutes. The native packer releases
    the GIL, so threads genuinely overlap."""
    import queue

    from ntcard_tpu.io.decompress import input_size
    from ntcard_tpu.parallel.multihost import host_file_assignment

    n_threads = max(1, min(n_threads, len(paths)))
    if n_threads == 1:
        yield from batches_from_files(
            paths, chunk_len, batch_rows, kmax,
            lenient=lenient, on_error=on_error, stats_out=stats_out,
            wire_packed=wire_packed,
        )
        return

    sizes = [input_size(p) for p in paths]
    parts = [host_file_assignment(paths, sizes, n_threads, t) for t in range(n_threads)]
    q: "queue.Queue" = queue.Queue(maxsize=2 * n_threads)
    done = object()
    errs: list = []

    def worker(my_paths):
        stats: dict = {}
        try:
            for b in batches_from_files(
                my_paths, chunk_len, batch_rows, kmax,
                lenient=lenient, on_error=on_error, stats_out=stats,
                wire_packed=wire_packed,
            ):
                q.put(b)
        except BaseException as e:
            errs.append(e)
        finally:
            if stats_out is not None and stats:
                with _STATS_LOCK:
                    for key, v in stats.items():
                        stats_out[key] = stats_out.get(key, 0) + v
            q.put(done)

    threads = [threading.Thread(target=worker, args=(p,), daemon=True) for p in parts if p]
    for t in threads:
        t.start()
    remaining = len(threads)
    while remaining:
        item = q.get()
        if item is done:
            remaining -= 1
            continue
        yield item
    if errs:
        raise errs[0]


def _tail_guard_should_stop(
    total_hint: float | None,
    pulled: int,
    host_done: int,
    elapsed: float,
    dev_batch_sec: float,
) -> bool:
    """Decide whether the device side of hybrid_feed should stop claiming.

    True when the host engines alone would finish the *estimated* remaining
    stream faster than the device finishes one more (best-case) batch. The
    hint is an estimate: once `pulled` reaches it the stream has proven it
    an underestimate (compressed inputs report on-disk bytes; URLs report
    0), so the guard disables itself rather than starving a possibly-fast
    device for the unknown remainder."""
    if total_hint is None or host_done <= 0 or dev_batch_sec <= 0.0:
        return False
    remaining = total_hint - pulled
    if remaining <= 0:
        return False  # hint exhausted: distrust it
    host_sec_per_batch = max(elapsed, 1e-9) / host_done  # all workers combined
    return remaining * host_sec_per_batch < dev_batch_sec


def hybrid_feed(
    raw_batches: Iterable[np.ndarray],
    host_update,
    n_host_workers: int = 1,
    total_hint: float | None = None,
    _clock=time.perf_counter,
) -> Iterator[np.ndarray]:
    """Share one RAW batch stream between the host engine and the device.

    ``host_update(batch)`` is called on a background worker for every batch
    the host side claims; the returned iterator yields the remainder for the
    device pipeline. Both consumers pull from the same lock-protected
    iterator, so the split is pure work-stealing: the device side drains
    batches exactly as fast as its (put-encode-bound) pipeline accepts them
    and the host engine absorbs the rest — no static ratio to tune. The
    sketch fold commutes, so ANY split is bit-identical to a single-engine
    run (the hybrid merge happens at finalize: CountTableSketch.merge_host_).

    The returned iterator raises the worker's exception (if any) and joins
    the workers before finishing, so callers may merge the host sketch as
    soon as the loop ends. A worker error stops the whole feed promptly
    (not after the stream drains), and abandoning the iterator early
    (consumer exception) stops and joins the workers via the generator's
    close, so nothing keeps draining the input underneath a failed run.

    Note: the device-claimed batches still need wire packing downstream;
    that runs on the single consuming thread. Hybrid targets the
    slow-transfer regime where the put encode, not packing, binds — on a
    fast link prefer the plain fused native wire path.

    Tail guard: pure work-stealing has one pathology — a slow device that
    claims a batch near the end of the stream extends the makespan past a
    host-only run (the host cannot re-steal a committed batch). When
    ``total_hint`` (estimated batch count) is given, the device side stops
    claiming once the host engines alone would finish the estimated
    remainder faster than the device finishes one more batch, judged from
    the rates both sides have exhibited so far. With the guard, hybrid
    converges to host-only when the device is slow and to dual-engine when
    it is fast; without total_hint behavior is the old unconditional steal."""
    lock = threading.Lock()
    stop = threading.Event()
    it = iter(raw_batches)
    errs: list = []
    t0 = _clock()
    host_done = [0]  # batches completed by host workers (under lock)
    pulled = [0]  # batches claimed by anyone
    dev_pulled = [0]
    dev_last_pull = [0.0]
    dev_batch_sec = [0.0]  # MIN observed consumer inter-pull time (see guard)

    def pull(for_device: bool = False):
        if stop.is_set():
            return None
        if (
            for_device
            and dev_pulled[0] >= 2  # enough samples of both rates
            and _tail_guard_should_stop(
                total_hint,
                pulled[0],
                host_done[0],
                _clock() - t0,
                dev_batch_sec[0],
            )
        ):
            return None  # host finishes the tail before one more put
        with lock:
            b = next(it, None)
            if b is not None:
                pulled[0] += 1
                if for_device:
                    now = _clock()
                    if dev_pulled[0] > 0:
                        dt = now - dev_last_pull[0]
                        # track the BEST (minimum) observed device batch time:
                        # a device's per-batch cost can spike transiently
                        # (compiles, transfers), and a one-sided average would
                        # make the (irreversible) cutoff fire on one stall;
                        # the optimistic estimate only stops the device when
                        # even a best-case batch cannot beat the host tail
                        dev_batch_sec[0] = (
                            dt
                            if dev_batch_sec[0] == 0.0
                            else min(dev_batch_sec[0], dt)
                        )
                    dev_last_pull[0] = now
                    dev_pulled[0] += 1
            return b

    def worker():
        try:
            while True:
                b = pull()
                if b is None:
                    return
                host_update(b)
                with lock:
                    host_done[0] += 1
        except BaseException as e:
            errs.append(e)
            stop.set()

    workers = [
        threading.Thread(target=worker, daemon=True) for _ in range(n_host_workers)
    ]
    for w in workers:
        w.start()
    try:
        while not stop.is_set():
            b = pull(for_device=True)
            if b is None:
                break
            yield b
        # the device side may stop early (tail guard) while the stream still
        # has items: host workers drain the remainder before we return, so
        # callers can merge the host sketch immediately. stop is only set in
        # the finally on a consumer exception / early generator close.
        for w in workers:
            w.join()
    finally:
        stop.set()
        for w in workers:
            w.join()
    if errs:
        raise errs[0]


def superbatch(
    iterator: Iterable[np.ndarray], n: int, axis: int = 0
) -> Iterator[np.ndarray]:
    """Group consecutive same-shape wire batches into [n, rows, width] stacks
    (models/sketch._update_stack folds a stack with one on-device scan) —
    one device_put + one dispatch then amortize the per-call fixed costs
    over n batches. ``axis=1`` stacks per-shard wire
    batches ([D, rows, width] -> [D, n, rows, width]) so the scan axis stays
    behind the sharded device axis.

    Same shape implies same wire format (nibble/quad/quad2 row counts are
    pairwise distinct for any admissible geometry), so a stack is always
    format-homogeneous; a mid-stream format change (e.g. quad's per-batch
    nibble fallback on N overflow) and the stream tail flush as single
    unstacked batches — only two jit signatures ever exist (the stack and
    the single), regardless of where the stream cuts."""
    if n <= 1:
        yield from iterator
        return
    pending: list = []

    def flush_singles():
        for b in pending:
            yield b
        pending.clear()

    for b in iterator:
        if pending and b.shape != pending[0].shape:
            yield from flush_singles()
        pending.append(b)
        if len(pending) == n:
            yield np.stack(pending, axis=axis)
            pending.clear()
    yield from flush_singles()


class EagerPrefetch:
    """Iterator whose upstream is consumed by a background worker into a
    bounded queue, started at CONSTRUCTION — unlike the lazy ``prefetch``
    generator, the upstream (e.g. file decode) runs ahead before the
    consumer's first next(). The CLI's fast device path overlaps input
    decode with the multi-second jax import / device bootstrap this way.

    Upstream exceptions (including the decode error contract's SystemExit)
    are re-raised to the consumer after the already-queued items. ``close``
    stops the worker promptly (used when an eagerly started stream must be
    abandoned, e.g. the auto-detected multi-device fallback)."""

    def __init__(self, iterator: Iterable, depth: int = 3, close_also=None):
        import queue

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: list = []
        self._stop = threading.Event()
        self._close_also = close_also
        self._t = threading.Thread(target=self._work, args=(iterator,), daemon=True)
        self._t.start()

    def _work(self, iterator) -> None:
        import queue

        try:
            for item in iterator:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # propagate SystemExit etc. to consumer
            self._err.append(e)
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(self._done, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        import queue

        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.2)
                break
            except queue.Empty:
                if not self._t.is_alive() and self._q.empty():
                    # worker died without managing to enqueue the sentinel
                    if self._err:
                        raise self._err[0]
                    raise StopIteration
        if item is self._done:
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item

    def __del__(self):
        # a feed abandoned without close() (consumer error path, GC'd
        # library use) must not keep decoding/transferring the whole input
        # on its daemon worker; no join here (GC context)
        self._stop.set()

    def close(self) -> None:
        """Abandon the stream: stop the worker and drop queued items."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except Exception:
            pass
        self._t.join(timeout=5.0)
        if self._close_also is not None:
            self._close_also.close()


def device_prefetch(
    iterator: Iterable,
    depth: int = 3,
    pack: bool = False,
    stage_times: Optional[dict] = None,
    put_fn=None,
    decode_depth: Optional[int] = None,
) -> EagerPrefetch:
    """Two-stage threaded host->device feed: a decode thread runs the
    upstream batch generator, a separate transfer thread issues the explicit
    async ``jax.device_put``, and the caller dispatches. EAGER: both worker
    threads start at the call, and jax is only imported on the transfer
    thread — the caller can build the whole feed before the device
    bootstrap finishes (the transfer thread self-blocks on the jax import
    lock until then, while decode runs ahead into its queue).

    Two concerns shape this:
      * feeding numpy straight into a jitted update makes the transfer part
        of the dispatch, serialized behind in-flight compute; hence the
        explicit async put one stage ahead;
      * `device_put` costs host CPU per batch; in its own thread it
        overlaps decode instead of serializing with it.

    ``decode_depth`` bounds the decoded-batch queue (host RAM only; default
    8 so decode keeps running through a multi-second bootstrap), while
    ``depth`` bounds in-flight device buffers.

    ``pack=True`` additionally nibble-packs each [B, L] batch to [B/2, L]
    (io.packing.pack_rows) in the decode thread — consumers must then call
    update(batch, packed=True); halving the wire halves the put cost. On
    CPU backends the whole thing is a cheap pass-through."""
    from ntcard_tpu.io.packing import pack_rows

    def decode_stage(it):
        # runs in prefetch thread 1: upstream decode (+ wire pack)
        if stage_times is None:
            for b in it:
                yield pack_rows(b) if pack else b
            return
        import time as _time

        st = stage_times
        t_last = _time.perf_counter()
        for b in it:
            t0 = _time.perf_counter()
            st["decode"] = st.get("decode", 0.0) + (t0 - t_last)
            p = pack_rows(b) if pack else b
            t1 = _time.perf_counter()
            st["pack"] = st.get("pack", 0.0) + (t1 - t0)
            st["batches"] = st.get("batches", 0) + 1
            yield p
            t_last = _time.perf_counter()

    def put_stage(it):
        # runs in prefetch thread 2: the transfer. jax is imported HERE (not
        # by the caller): the first import costs seconds, and paying it on
        # this thread keeps the caller free (decode runs ahead regardless).
        if put_fn is None:
            from ntcard_tpu import _jax_config  # noqa: F401
            import jax

            put = jax.device_put
        else:
            put = put_fn  # e.g. PerDeviceCountTableSketch.put_shards
        if stage_times is None:
            for p in it:
                yield put(p)
            return
        import time as _time

        st = stage_times
        for p in it:
            t0 = _time.perf_counter()
            d = put(p)
            st["h2d"] = st.get("h2d", 0.0) + (_time.perf_counter() - t0)
            st["h2d_bytes"] = st.get("h2d_bytes", 0) + int(getattr(p, "nbytes", 0))
            yield d

    # put-ahead depth: more in-flight device buffers keep the put thread
    # busy across dispatch latency at the cost of device memory for the
    # extra wires. Malformed values degrade to the default.
    try:
        depth = max(1, int(os.environ.get("NTCARD_PUT_DEPTH", depth)))
    except ValueError:
        pass
    decoded = EagerPrefetch(decode_stage(iterator), depth=decode_depth or max(depth, 8))
    return EagerPrefetch(put_stage(decoded), depth=depth, close_also=decoded)


def prefetch(iterator: Iterable, depth: int = 3) -> Iterator:
    """Run ``iterator`` in a background thread with a bounded queue — the
    host-decode/device-compute pipeline overlap (the PP analog of SURVEY.md
    §2.6: decode/pack on CPU runs ahead while the chip consumes batches)."""
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    err: list = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # propagate SystemExit etc. to consumer
            err.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            if err:
                raise err[0]
            return
        yield item
