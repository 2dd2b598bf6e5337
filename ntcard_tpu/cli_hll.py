"""nthll command-line driver — flag-compatible with the reference
(nthll.cpp:25-38 usage, :150-196 parsing): -t/--threads, -k/--kmer [64],
hidden -b/--bit (register bits [16]) and -s/--sit (parsed, unused), -h and
-c accepted (no-op: canonical hashing is always on, nthll.cpp:170-172)."""

from __future__ import annotations

import getopt
import sys
from typing import List, Optional

PROGRAM = "nthll"

# getopt spec, shared with the daemon's eligibility probe (daemon.py):
# -h/-c/--hash are accepted-and-ignored, matching the reference binary
GETOPT_SPEC = (
    "t:k:b:s:hc",
    ["threads=", "kmer=", "bit=", "sit=", "hash=", "help", "version"],
)

_FAST_EXIT_OK = True  # cleared by multihost runs (see cli.py)

VERSION_MESSAGE = (
    "nthll (JAX) 1.0.0 (capability parity with nthll 1.2.2)\n"
    "A JAX HyperLogLog distinct k-mer estimator for NVIDIA GPUs.\n"
)

USAGE_MESSAGE = f"""Usage: {PROGRAM} [OPTION]... FILE(S)...
Estimates distinct number of k-mers in FILE(S).

Acceptable file formats: fastq, fasta, sam, bam and in compressed formats gz, bz, zip, xz.
Accepts a list of files by adding @ at the beginning of the list name.

 Options:

  -t, --threads=N\tuse N parallel threads [1] (N>=2 should be used when input files are >=2)
  -k, --kmer=N\tthe length of kmer [64]
      --help\tdisplay this help and exit
      --version\toutput version information and exit

Report bugs to https://github.com/bcgsc/ntCard/issues
"""


def _main_host(args: List[str], km_len: int, n_bits: int, n_thrd: int = 1) -> int:
    """Host-engine nthll: same F0 output, no device/jax involvement
    (models/host_engine.HostHllSketch; lenient sniffing + skip-on-error,
    the nthll reader contract, nthll.cpp:70-90, 225-235)."""
    from ntcard_tpu.io.packing import aligned_stride
    from ntcard_tpu.io.readers import expand_file_args
    from ntcard_tpu.models.estimate import estimate_f0
    from ntcard_tpu.models.host_engine import HostHllSketch
    from ntcard_tpu.pipeline import default_geometry, parallel_batches_from_files, prefetch

    in_files = expand_file_args(args)
    chunk_len, batch_rows = default_geometry(km_len)
    stride = aligned_stride(chunk_len, km_len)
    sketch = HostHllSketch(km_len, n_bits, stride)
    for batch in prefetch(
        parallel_batches_from_files(
            in_files, chunk_len, batch_rows, km_len, n_thrd,
            lenient=True, on_error="skip",
        )
    ):
        sketch.update(batch)
    f0 = estimate_f0(sketch.registers(), canon=True)
    sys.stdout.write(f"F0, Exp# of distnt kmers(k={km_len}): {f0}\n")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args_in = sys.argv[1:] if argv is None else argv

    # Warm-pool daemon routing: a live daemon is used by default, spawned
    # only under NTCARD_DAEMON=1, disabled by =0 (see cli.py / daemon.py)
    from ntcard_tpu.daemon import maybe_run_via_daemon

    rc = maybe_run_via_daemon("nthll", args_in)
    if rc is not None:
        return rc

    n_bits, km_len = 16, 64
    try:
        optlist, args = getopt.gnu_getopt(args_in, *GETOPT_SPEC)
    except getopt.GetoptError as e:
        sys.stderr.write(f"{PROGRAM}: {e}\nTry `{PROGRAM} --help' for more information.\n")
        return 1

    def uint(s, flag):
        try:
            return int(s)
        except ValueError:
            sys.stderr.write(f"{PROGRAM}: invalid option: `-{flag}{s}'\n")
            raise SystemExit(1)

    n_thrd = 1
    for flag, val in optlist:
        if flag in ("-t", "--threads"):
            n_thrd = uint(val, "t")
        elif flag in ("-k", "--kmer"):
            km_len = uint(val, "k")
        elif flag in ("-b", "--bit"):
            n_bits = uint(val, "b")
        elif flag in ("-s", "--sit"):
            uint(val, "s")
        # -h / -c / --hash: accepted, no effect
        elif flag == "--help":
            sys.stderr.write(USAGE_MESSAGE)
            return 0
        elif flag == "--version":
            sys.stderr.write(VERSION_MESSAGE)
            return 0

    if len(args) < 1:
        sys.stderr.write(f"{PROGRAM}: missing arguments\n")
        sys.stderr.write(f"Try `{PROGRAM} --help' for more information.\n")
        return 1

    # Engine selection (cli._use_host_engine's cost model, same constants):
    # when the run targets a GPU, jobs whose estimated host wall beats the
    # device fixed-cost floor route to the native host engine — for nthll
    # the device compute (a 64 KB register max-merge) is so cheap that
    # transfer + startup dominate far longer than for ntcard. Setting
    # NTCARD_HLL_HOST_MAX_BYTES makes that byte threshold the sole
    # authority instead (e.g. =0 forces the device engine).
    import os as _os

    from ntcard_tpu.accel import accelerator_requested

    eng = _os.environ.get("NTCARD_ENGINE", "auto")
    use_host = eng == "host"
    if eng == "auto" and not _os.environ.get("NTCARD_COORDINATOR") and accelerator_requested():
        from ntcard_tpu.cli import device_floor_sec, host_rate_bps
        from ntcard_tpu.io.decompress import input_size as _isize
        from ntcard_tpu.io.readers import expand_file_args as _expand
        from ntcard_tpu.models.host_engine import host_engine_available

        total = sum(_isize(f) for f in _expand(args))
        thresh_env = _os.environ.get("NTCARD_HLL_HOST_MAX_BYTES")
        if thresh_env is not None:
            # explicit byte threshold: sole authority (lets tests and
            # deployments force the device engine at any size)
            use_host = total < int(thresh_env)
        else:
            use_host = total / host_rate_bps() < device_floor_sec()
        use_host = use_host and host_engine_available()
    if use_host:
        return _main_host(args, km_len, n_bits, n_thrd)

    from ntcard_tpu._jax_config import check_backend
    import jax

    from ntcard_tpu.io.decompress import input_size
    from ntcard_tpu.io.packing import aligned_stride
    from ntcard_tpu.io.readers import expand_file_args
    from ntcard_tpu.models.hll import HllSketch, estimate_f0
    from ntcard_tpu.parallel.data_parallel import make_sharded_hll
    from ntcard_tpu.parallel.multihost import (
        host_file_assignment,
        initialize_distributed,
        merged_hll_registers,
    )
    from ntcard_tpu.pipeline import (
        default_geometry,
        device_prefetch,
        parallel_batches_from_files,
    )
    from ntcard_tpu.utils.metrics import Metrics

    # multi-host (env-driven: NTCARD_COORDINATOR / NTCARD_NUM_PROCESSES /
    # NTCARD_PROCESS_ID): per-host file slice, registers max-merged across hosts
    # — nthll's thread-private-sketch pattern (nthll.cpp:218-245) lifted
    # across hosts.
    proc_id, n_procs = initialize_distributed()
    check_backend()
    if n_procs > 1:
        global _FAST_EXIT_OK
        _FAST_EXIT_OK = False

    in_files = expand_file_args(args)
    if n_procs > 1:
        sizes = [input_size(f) for f in in_files]
        in_files = host_file_assignment(in_files, sizes, n_procs, proc_id)

    chunk_len, batch_rows = default_geometry(km_len)
    stride = aligned_stride(chunk_len, km_len)
    n_dev = len(jax.local_devices())
    if n_procs > 1:
        # per-host private registers; the cross-host max-merge happens once
        # at the end (merged_hll_registers)
        sketch = HllSketch(km_len, n_bits, stride)
    elif n_dev > 1:
        sketch = make_sharded_hll(km_len, n_bits, stride, n_devices=n_dev)
        batch_rows = max(128, batch_rows // n_dev) * n_dev
    else:
        sketch = HllSketch(km_len, n_bits, stride)
    from ntcard_tpu.io.packing import (
        pack_shard_wires,
        quad2_ok,
        quad_ok,
        wire_mode_of,
    )

    # 2-bit quad/quad2 wire (see cli.py); the multi-device sketch packs one
    # wire PER SHARD (per-shard sidecars), judged on per-shard geometry
    sharded = n_procs == 1 and n_dev > 1
    rows_ps = batch_rows // n_dev if sharded else batch_rows
    wire_env = _os.environ.get("NTCARD_WIRE", "quad2")
    private_sketch = not sharded
    if wire_env == "quad2" and quad2_ok(rows_ps, stride):
        wire_fmt = "quad2"
    elif wire_env in ("quad", "quad2") and quad_ok(rows_ps, chunk_len):
        wire_fmt = "quad"
    else:
        wire_fmt = True
    use_quad = wire_fmt in ("quad", "quad2")
    halo = chunk_len - stride
    # NTCARD_ENGINE=hybrid: work-steal raw batches between the native host
    # HLL engine and the device (pipeline.hybrid_feed); registers max-merge
    # at the end, so any split is bit-identical (see cli.py / test_hybrid)
    host_sketch = None
    if eng == "hybrid":
        why = None
        if not private_sketch or n_procs > 1:
            why = "sharded/multi-host sketches are device-only"
        else:
            from ntcard_tpu.models.host_engine import HostHllSketch, host_engine_available

            if not host_engine_available():
                why = "native host engine unavailable (no g++?)"
            else:
                host_sketch = HostHllSketch(
                    km_len, n_bits, stride,
                    n_threads=max(1, (_os.cpu_count() or 2) - 2),
                )
        if why is not None:
            sys.stderr.write(f"{PROGRAM}: NTCARD_ENGINE=hybrid ignored: {why}\n")
    # nthll silently skips unreadable files and sniffs leniently (no error
    # path in its reader loop, nthll.cpp:70-90, 225-235). -t fans decode
    # threads over files like the reference's thread-private sketches
    # (nthll.cpp:218-245) — batch order is irrelevant, max-merge commutes.
    if host_sketch is not None:
        from ntcard_tpu.io.packing import pack_wire
        from ntcard_tpu.pipeline import hybrid_feed

        raw = parallel_batches_from_files(
            in_files, chunk_len, batch_rows, km_len, n_thrd,
            lenient=True, on_error="skip",
        )
        # tail-guard hint: on-disk bytes estimate the stream length; the
        # guard self-disables once the estimate is proven short (compressed
        # inputs), see pipeline._tail_guard_should_stop
        est_batches = sum(input_size(f) for f in in_files) / float(
            batch_rows * stride
        )
        batches = (
            pack_wire(b, wire_fmt, stride)
            for b in hybrid_feed(
                raw, host_sketch.update, total_hint=est_batches
            )
        )
    elif sharded:
        raw = parallel_batches_from_files(
            in_files, chunk_len, batch_rows, km_len, n_thrd,
            lenient=True, on_error="skip",
        )
        batches = (
            pack_shard_wires(b, n_dev, wire_fmt if use_quad else True, stride)
            for b in raw
        )
    else:
        batches = parallel_batches_from_files(
            in_files, chunk_len, batch_rows, km_len, n_thrd,
            lenient=True, on_error="skip", wire_packed=wire_fmt,
        )
    # structured metrics (NTCARD_METRICS=1; nthll has no --metrics flag):
    # phase split and peak device memory on stderr, as ntcard's --metrics
    metrics = Metrics()
    with metrics.phase("pipeline"):
        for batch in device_prefetch(batches):
            if sharded:
                sketch.update_shards(
                    batch, packed=wire_mode_of(batch[0], rows_ps, halo)
                )
            else:
                sketch.update(
                    batch, packed=wire_mode_of(batch, batch_rows, halo) if use_quad else True
                )
    with metrics.phase("finalize"):
        regs = merged_hll_registers(sketch) if n_procs > 1 else sketch.registers()
        if host_sketch is not None:
            import numpy as _np

            regs = _np.maximum(regs, host_sketch.registers())
    if proc_id == 0:
        f0 = estimate_f0(regs, canon=True)
        sys.stdout.write(f"F0, Exp# of distnt kmers(k={km_len}): {f0}\n")
    metrics.report()
    return 0


if __name__ == "__main__":
    _rc = main()
    # skip interpreter/jax-client teardown (measured ~0.25 s of exit
    # cost after the outputs are already written and flushed; nothing
    # is in flight — finalize fetched every result). NTCARD_FAST_EXIT=0
    # restores the normal exit for debugging/atexit hooks.
    import os as _o
    import sys as _s
    if _FAST_EXIT_OK and _o.environ.get("NTCARD_FAST_EXIT", "1") != "0":
        _s.stdout.flush()
        _s.stderr.flush()
        _o._exit(_rc)
    raise SystemExit(_rc)
