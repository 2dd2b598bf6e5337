"""ntcard command-line driver — flag-compatible with the reference
(ntcard.cpp:27-48 usage; :317-425 parsing/validation), including the hidden
``-r/--rbit`` and ``-s/--sbit`` flags, the accepted-and-ignored ``-l``/``-f``
short options, and the <50 GB ``sBits=7`` override that runs *after* parsing
(ntcard.cpp:427-431).

Device-path additions (new flags, defaults need no tuning):
  --chunk-len / --batch-rows   device batch geometry
  --devices N                  data-parallel shards over the device mesh
"""

from __future__ import annotations

import getopt
import sys
import time
from typing import List, Optional

from ntcard_tpu.accel import accelerator_requested

PROGRAM = "ntCard"

# cleared by multihost runs: os._exit would kill the jax.distributed
# coordinator while peer processes still poll it (fatal on their side)
_FAST_EXIT_OK = True

VERSION_MESSAGE = (
    "ntcard (JAX) 1.0.0 (capability parity with ntCard 1.2.2)\n"
    "A JAX k-mer cardinality estimation framework for NVIDIA GPUs.\n"
)

USAGE_MESSAGE = f"""Usage: {PROGRAM} [OPTION]... FILE(S)...
Estimates k-mer coverage histogram in FILE(S).

Acceptable file formats: fastq, fasta, sam, bam and in compressed formats gz, bz, zip, xz.
A list of files containing file names in each row can be passed with @ prefix.

 Options:

  -t, --threads=N\tuse N parallel threads [1] (N>=2 should be used when input files are >=2)
           \ton the host engine, N caps ALL workers (reference semantics);
           \ton the device engine, N fans file decode only — device
           \tdispatch/transfer threads are managed by the runtime.
  -k, --kmer=N\tthe length of kmer
  -g, --gap=N\tthe length of gap in the gap seed [0]. g mod 2 must equal k mod 2 unless g == 0
           \t-g does not support multiple k currently.
  -c, --cov=N\tthe maximum coverage of kmer in output [1000]
  -p, --pref=STRING    the prefix for output file name(s)
  -o, --output=STRING\tthe name for output file name (used when output should be a single file)
      --help\tdisplay this help and exit
      --version\toutput version information and exit

 Engine selection (env NTCARD_ENGINE=auto|host|device|hybrid, default auto):
  auto    cost-model routing — native AVX-512 host engine for jobs whose
          estimated host wall beats the accelerator's fixed startup floor,
          GPU streaming engine otherwise (always the device path on CPU-only
          machines, where it is XLA on the CPU)
  host    force the native host engine (never touches the accelerator)
  device  force the GPU streaming engine
  hybrid  work-steal batches between both engines, merge at finalize
 Further env knobs (wire format, sharding engine, kernels) are documented
 in the repo README and .claude/skills/verify/SKILL.md.

Report bugs to https://github.com/bcgsc/ntCard/issues
"""


class Opts:
    def __init__(self):
        self.n_thrd = 1
        self.gap = 0
        self.r_bits = 27
        self.s_bits = 11
        self.cov_max = 1000
        self.prefix = ""
        self.output = ""
        self.k_list: List[int] = []
        self.chunk_len: Optional[int] = None
        self.batch_rows = 8192
        self.devices = 0  # 0 = all local devices
        self.metrics = False
        self.save_sketch = ""
        # multi-host launch (also settable via NTCARD_COORDINATOR /
        # NTCARD_NUM_PROCESSES / NTCARD_PROCESS_ID env)
        self.coordinator = ""
        self.num_hosts = 0
        self.host_id = -1


def _uint(s: str, flag: str) -> int:
    """istringstream >> unsigned semantics: leading integer parse; a fully
    unparsable value is a fatal 'invalid option' (ntcard.cpp:371-374)."""
    try:
        return int(s)
    except ValueError:
        sys.stderr.write(f"{PROGRAM}: invalid option: `-{flag}{s}'\n")
        raise SystemExit(1)


def parse_args(argv: List[str]) -> tuple:
    opt = Opts()
    die = False
    try:
        optlist, args = getopt.gnu_getopt(
            argv,
            "t:s:r:k:c:l:p:f:o:g:",
            [
                "threads=",
                "kmer=",
                "gap=",
                "cov=",
                "rbit=",
                "sbit=",
                "output=",
                "pref=",
                "chunk-len=",
                "batch-rows=",
                "devices=",
                "metrics",
                "save-sketch=",
                "coordinator=",
                "num-hosts=",
                "host-id=",
                "help",
                "version",
            ],
        )
    except getopt.GetoptError as e:
        sys.stderr.write(f"{PROGRAM}: {e}\n")
        sys.stderr.write(f"Try `{PROGRAM} --help' for more information.\n")
        raise SystemExit(1)

    for flag, val in optlist:
        if flag in ("-t", "--threads"):
            opt.n_thrd = _uint(val, "t")
        elif flag in ("-s", "--sbit"):
            opt.s_bits = _uint(val, "s")
        elif flag in ("-r", "--rbit"):
            opt.r_bits = _uint(val, "r")
        elif flag in ("-c", "--cov"):
            opt.cov_max = min(_uint(val, "c"), 65535)
        elif flag in ("-p", "--pref"):
            opt.prefix = val
        elif flag in ("-o", "--output"):
            opt.output = val
        elif flag in ("-g", "--gap"):
            opt.gap = _uint(val, "g")
        elif flag in ("-k", "--kmer"):
            for token in val.split(","):
                opt.k_list.append(_uint(token, "k"))
        elif flag == "--chunk-len":
            opt.chunk_len = _uint(val, "-chunk-len")
        elif flag == "--batch-rows":
            opt.batch_rows = _uint(val, "-batch-rows")
        elif flag == "--devices":
            opt.devices = _uint(val, "-devices")
        elif flag == "--metrics":
            opt.metrics = True
        elif flag == "--save-sketch":
            opt.save_sketch = val
        elif flag == "--coordinator":
            opt.coordinator = val
        elif flag == "--num-hosts":
            opt.num_hosts = _uint(val, "-num-hosts")
        elif flag == "--host-id":
            opt.host_id = _uint(val, "-host-id")
        elif flag == "--help":
            sys.stderr.write(USAGE_MESSAGE)
            raise SystemExit(0)
        elif flag == "--version":
            sys.stderr.write(VERSION_MESSAGE)
            raise SystemExit(0)
        # -l / -f: consumed with their argument, no effect (reference
        # shortopts list them with no switch case, ntcard.cpp:69)

    if len(args) < 1:
        sys.stderr.write(f"{PROGRAM}: missing arguments\n")
        die = True
    if opt.gap != 0 and opt.k_list and (opt.gap % 2 != opt.k_list[0] % 2):
        sys.stderr.write(f"{PROGRAM}Gap size and kmer must have the same modulus\n")
        die = True
    if not opt.k_list:
        sys.stderr.write(f"{PROGRAM}: missing argument -k ... \n")
        die = True
    if not opt.prefix and not opt.output:
        sys.stderr.write(f"{PROGRAM}: missing argument -p/-o ... \n")
        die = True
    if opt.gap != 0 and len(opt.k_list) != 1:
        sys.stderr.write(f"{PROGRAM}: -g does not support multiple k currently.\n")
        die = True
    if die:
        sys.stderr.write(f"Try `{PROGRAM} --help' for more information.\n")
        raise SystemExit(1)
    return opt, args


def _gap_positions(opt) -> Optional[tuple]:
    if opt.gap == 0:
        return None
    # seed '1'*(k-g)/2 + '0'*g + '1'*(k-g)/2 (ntcard.cpp:407-413)
    half = (opt.k_list[0] - opt.gap) // 2
    return tuple(range(half, half + opt.gap))


# Cost-model constants of the auto engine choice (_use_host_engine and
# cli_hll.main), from chip_smoke.py's real phase on an NVIDIA H100 80GB
# HBM3 at a 400 W power limit with 16 host cores (300 Mbp: four gzip level-1
# FASTQ lanes, 119.2 MB on disk, -t4):
# HOST_RATE_BPS: on-disk input bytes per second of the native host engine at
#   nK=1 — ntcard -k64 -r16 -c64 took 2.060 s (gzip decode dominates).
# DEVICE_FLOOR_SEC: fixed cost of a cold device-path CLI run — the same job
#   through the device engine took 16.645 s cold, of which its warm
#   streaming phase is ~2 s; the floor is the cold wall, rounded down.
# DEVICE_WARM_FLOOR_SEC: the same inside the warm daemon, whose backend is
#   live and whose programs are loaded — below what that run resolves (the
#   daemon's r27 3-k job, 1.873 s, undercut a warm CLI's own 1.996 s
#   streaming phase), so a small constant stands in.
HOST_RATE_BPS = 5.79e7
DEVICE_FLOOR_SEC = 16.0
DEVICE_WARM_FLOOR_SEC = 0.25


def host_rate_bps() -> float:
    import os

    return float(os.environ.get("NTCARD_HOST_RATE_BPS", HOST_RATE_BPS))


def device_floor_sec() -> float:
    """The device path's fixed cost for this process: the warm floor
    inside the daemon (NTCARD_IN_DAEMON, daemon.py), the cold floor
    otherwise; NTCARD_DEVICE_FLOOR_SEC overrides both."""
    import os

    default = DEVICE_WARM_FLOOR_SEC if os.environ.get("NTCARD_IN_DAEMON") else DEVICE_FLOOR_SEC
    return float(os.environ.get("NTCARD_DEVICE_FLOOR_SEC", default))


def _use_host_engine(opt, total_size: int) -> bool:
    """Engine selection (NTCARD_ENGINE=auto|host|device|hybrid).

    "auto" (the default) picks, per job, the engine a simple cost model
    predicts fastest — the product must not default to its second-best
    engine:

      * host engine wall  ~ input_bytes / (NTCARD_HOST_RATE_BPS / nK);
      * device path wall  >= NTCARD_DEVICE_FLOOR_SEC of fixed cost (jax
        import, backend start, compiles or AOT loads) before its streaming
        rate matters; inside the warm daemon, DEVICE_WARM_FLOOR_SEC.

    The constants' origins are beside them (HOST_RATE_BPS,
    DEVICE_FLOOR_SEC). Applies ONLY when the run targets a GPU
    (accel.accelerator_requested) — on the CPU platform (tests, machines
    without a card) the XLA path is already host execution, so auto never
    switches. NTCARD_HOST_MIN_RBITS still forces big-table runs to the host
    engine at any size; NTCARD_HOST_TABLE_MAX caps the host table RAM
    (GiB-scale nK*2^rBits tables at extreme configs)."""
    import os

    eng = os.environ.get("NTCARD_ENGINE", "auto")
    if eng == "host":
        return True
    if eng != "auto":
        return False
    if os.environ.get("NTCARD_COORDINATOR") or opt.coordinator or opt.num_hosts:
        return False  # multi-host runs are a device-path feature
    if opt.devices > 1:
        return False  # explicit multi-device request
    if not accelerator_requested():
        return False
    nk = max(1, len(opt.k_list))
    host_table_bytes = nk * 2 * (1 << opt.r_bits) * 2
    if host_table_bytes > int(os.environ.get("NTCARD_HOST_TABLE_MAX", 4 << 30)):
        return False  # host table would not fit sane RAM; stream to HBM
    big_r = opt.r_bits >= int(os.environ.get("NTCARD_HOST_MIN_RBITS", "99"))
    if not big_r:
        if total_size / (host_rate_bps() / nk) >= device_floor_sec():
            return False  # long stream: the device path's rate pays its floor
    from ntcard_tpu.models.host_engine import host_engine_available

    return host_engine_available()


def _select_wire(rows_ps: int, chunk_len: int, stride: int):
    """H2D wire-format selection, shared by BOTH device paths (they must
    stay bit-exact twins): the 2-bit quad/quad2 wire when the (per-shard)
    geometry admits it, nibble otherwise; NTCARD_WIRE opts down. Returns
    (wire_fmt, use_quad, halo, n_super)."""
    import os

    from ntcard_tpu.io.packing import quad2_ok, quad_ok

    wire_env = os.environ.get("NTCARD_WIRE", "quad2")
    if wire_env == "quad2" and quad2_ok(rows_ps, stride):
        wire_fmt = "quad2"
    elif wire_env in ("quad", "quad2") and quad_ok(rows_ps, chunk_len):
        wire_fmt = "quad"
    else:
        wire_fmt = True
    return (
        wire_fmt,
        wire_fmt in ("quad", "quad2"),
        chunk_len - stride,
        int(os.environ.get("NTCARD_SUPERBATCH", "1")),
    )


def _estimate_and_write(opt, state, metrics, stats, s_time, write_ok=True) -> int:
    """Estimate + output + metrics epilogue shared by every engine path."""
    from ntcard_tpu.models.estimate import comp_est_hist
    from ntcard_tpu.output import write_compact, write_default

    ks = opt.k_list
    results = {}
    with metrics.phase("estimate"):
        for k in ks:
            f0, f = comp_est_hist(state[k]["hist"], opt.s_bits, opt.r_bits, opt.cov_max)
            results[k] = {"f1": state[k]["f1"], "f0": f0, "f": f}
    with metrics.phase("output"):
        # multi-host: every process derives the identical merged state, but
        # only process 0 writes (single-writer, like the reference's one node)
        if write_ok:
            if not opt.output:
                write_default(opt.prefix, ks, results, opt.cov_max)
            else:
                write_compact(opt.output, ks, results, opt.cov_max)
    metrics.add("reads", stats.get("records", 0))
    metrics.add("bases", stats.get("bases", 0))
    metrics.report()
    sys.stderr.write(f"Runtime(sec): {time.monotonic() - s_time:.4f}\n")
    return 0


def _main_host(opt, in_files, s_time) -> int:
    """Host-engine run: same outputs, no device/jax involvement at all (the
    import alone costs ~0.7 s — material next to a sub-second job)."""
    from ntcard_tpu.io.packing import aligned_stride
    from ntcard_tpu.models.host_engine import HostCountTableSketch
    from ntcard_tpu.pipeline import (
        default_geometry,
        parallel_batches_from_files,
        prefetch,
    )
    from ntcard_tpu.utils.metrics import Metrics

    ks = opt.k_list
    kmax = max(ks)
    chunk_len, _ = default_geometry(kmax)
    if opt.chunk_len:
        chunk_len = opt.chunk_len
    stride = aligned_stride(chunk_len, kmax)
    # -t caps the engine's in-batch row threads too (reference semantics:
    # -t is omp_set_num_threads for the WHOLE run, ntcard.cpp:441-443 — a
    # -t1 user expects one worker, not one decode thread plus all cores)
    sketch = HostCountTableSketch(
        ks, opt.s_bits, opt.r_bits, stride, gap_positions=_gap_positions(opt),
        n_threads=opt.n_thrd,
    )
    metrics = Metrics(opt.metrics)
    stats: dict = {}
    with metrics.phase("pipeline"):
        # decode in background threads (-t fans over files, reference
        # semantics), hash/count in the foreground — decode, pack and the C
        # sketch update all release the GIL, so the stages genuinely overlap
        for batch in prefetch(
            parallel_batches_from_files(
                in_files, chunk_len, opt.batch_rows, kmax, opt.n_thrd,
                stats_out=stats,
            )
        ):
            with metrics.phase("pipeline.dispatch"):
                sketch.update(batch)
    if opt.save_sketch:
        sketch.save(opt.save_sketch)
    with metrics.phase("finalize"):
        state = sketch.finalize(cov_max=opt.cov_max)
    metrics.tag("engine", "host")
    return _estimate_and_write(opt, state, metrics, stats, s_time)


def _fast_device_ok(opt, in_files) -> bool:
    """Eligibility for the startup-overlapped single-device path
    (_main_device_fast): single host, one (or auto-detect) device, plain
    wire engines. CPU platforms keep the legacy path (the overlap only
    buys anything when a device bootstrap costs seconds; tests opt in via
    NTCARD_EAGER=1 to exercise the fast machinery on the CPU mesh)."""
    import os

    if opt.coordinator or opt.num_hosts or opt.host_id >= 0:
        return False
    if os.environ.get("NTCARD_COORDINATOR") or os.environ.get("NTCARD_NUM_PROCESSES"):
        return False
    if opt.devices > 1:
        return False
    if os.environ.get("NTCARD_ENGINE") == "hybrid":
        return False  # hybrid work-stealing lives in the legacy path
    eager = os.environ.get("NTCARD_EAGER")
    if eager == "0":
        return False
    if opt.devices == 0 and not all(os.path.isfile(f) for f in in_files):
        # auto device-count detection may fall back to the legacy path by
        # RE-READING the inputs after the eager feed consumed a prefix —
        # fine for regular files (re-open), data LOSS for pipes/FIFOs.
        # With --devices 1 there is no fallback, so pipes are fine there.
        return False
    return eager == "1" or accelerator_requested()


def _main_device_fast(opt, in_files, total_size, s_time) -> int:
    """Single-device path with the startup serial chain overlapped.

    A cold device CLI pays, in sequence: the jax import (seconds of pure
    Python), the backend start, and the compile (or AOT load) of the
    update and finalize programs. Here all of that runs on a boot thread
    (+ warm threads, models/sketch.warm_*) while the native decode threads
    fill the eager feed (pipeline.EagerPrefetch), so the dispatch loop
    starts against loaded programs with device-resident batches.
    Bit-exact with the legacy path: same generators, same programs, same
    fold order."""
    import os as _os
    import threading

    from ntcard_tpu.io.packing import (
        aligned_stride,
        quad2_ok,
        quad_ok,
        wire_mode_of,
    )
    from ntcard_tpu.pipeline import (
        default_geometry,
        device_prefetch,
        parallel_batches_from_files,
        superbatch,
    )
    from ntcard_tpu.utils.metrics import Metrics

    ks = opt.k_list
    kmax = max(ks)
    chunk_len, _ = default_geometry(kmax)
    if opt.chunk_len:
        chunk_len = opt.chunk_len
    batch_rows = opt.batch_rows
    stride = aligned_stride(chunk_len, kmax)
    gap_positions = _gap_positions(opt)
    wire_fmt, use_quad, halo, n_super = _select_wire(batch_rows, chunk_len, stride)

    boot: dict = {}
    boot_err: list = []
    boot_done = threading.Event()

    def _boot():
        try:
            t0 = time.monotonic()
            from ntcard_tpu._jax_config import check_backend
            import jax

            check_backend()
            boot["t_jax"] = time.monotonic() - t0
            n_dev = opt.devices or len(jax.devices())
            boot["n_dev"] = n_dev
            if n_dev == 1:
                from ntcard_tpu.models.sketch import ChainedCountTableSketch

                # cheap: tables allocate lazily inside the first update
                # program (models/sketch._update_first), so construction
                # dispatches nothing
                boot["sketch"] = ChainedCountTableSketch(
                    ks, opt.s_bits, opt.r_bits, stride, gap_positions=gap_positions
                )
                if wire_fmt == "quad2" and n_super == 1:
                    # start the update-executable loads NOW (utils/aot):
                    # the quad2 wire geometry is fully determined by
                    # (batch_rows, stride), so the boot thread can pre-load
                    # the exact programs the dispatch loop will run while
                    # decode and the first H2D puts proceed underneath
                    from ntcard_tpu.io.packing import quad2_wire_rows

                    boot["sketch"].warm_update(
                        quad2_wire_rows(batch_rows), stride, f"quad2:{halo}"
                    )
            boot["t_ready"] = time.monotonic() - t0
        except BaseException as e:
            boot_err.append(e)
        finally:
            boot_done.set()

    threading.Thread(target=_boot, daemon=True, name="ntcard-boot").start()

    metrics = Metrics(opt.metrics)
    stats: dict = {}
    stages: dict = {}
    # eager feed: decode/pack threads start NOW and run under the boot
    batches = parallel_batches_from_files(
        in_files, chunk_len, batch_rows, kmax, opt.n_thrd, stats_out=stats,
        wire_packed=wire_fmt,
    )
    feed = device_prefetch(
        superbatch(batches, n_super),
        stage_times=stages if metrics.enabled else None,
    )
    boot_done.wait()
    if boot_err:
        raise boot_err[0]
    if boot["n_dev"] != 1:
        # auto-detected multi-device mesh: the eagerly started single-device
        # stream is abandoned (nothing was dispatched yet) and the sharded
        # legacy path re-reads the inputs
        feed.close()
        return _main_device_legacy(opt, in_files, total_size, s_time)
    sketch = boot["sketch"]

    metrics.start_profile()
    warmed = False
    try:
        with metrics.phase("pipeline"):
            for batch in feed:
                with metrics.phase("pipeline.dispatch"):
                    wire0 = batch if batch.ndim == 2 else batch[0]
                    sketch.update(
                        batch,
                        packed=wire_mode_of(wire0, batch_rows, halo) if use_quad else True,
                    )
                if not warmed:
                    # load the finalize executables in the background while
                    # the dispatch loop runs (models/sketch.warm_finalize)
                    warmed = True
                    sketch.warm_finalize(opt.cov_max)
    except BaseException:
        # stop the eager workers before propagating — an abandoned feed
        # would keep decoding + device_put-ing the whole input underneath
        # the error (library callers may live long after)
        feed.close()
        raise
    for name in ("decode", "pack", "h2d"):
        if name in stages:
            metrics.phases[f"pipeline.{name}"] = stages[name]
    # fast-key AOT barrier: any boot-thread executable loaded via a
    # fastkey→digest mapping must have its background trace-verification
    # pass before results leave the process (utils/aot.py). The verifier
    # races the stream and is long done by now — the join is free unless
    # a stale mapping was actually detected, which raises loudly (the
    # mapping is already evicted, so a rerun traces fresh).
    from ntcard_tpu.utils.aot import check_trace_verifications

    check_trace_verifications()
    if opt.save_sketch:
        sketch.save(opt.save_sketch)
    with metrics.phase("finalize"):
        state = sketch.finalize(cov_max=opt.cov_max)
    metrics.stop_profile()
    metrics.phases["boot.jax"] = round(boot.get("t_jax", 0.0), 4)
    metrics.phases["boot.ready"] = round(boot.get("t_ready", 0.0), 4)
    metrics.tag("engine", "device")
    return _estimate_and_write(opt, state, metrics, stats, s_time)


def main(argv: Optional[List[str]] = None) -> int:
    s_time = time.monotonic()
    args_in = sys.argv[1:] if argv is None else argv

    # Warm-pool daemon routing (daemon.py): an already-serving daemon is
    # used by DEFAULT (repeat invocations skip the jax import + backend
    # handshake + executable loads; byte-identical results); NTCARD_DAEMON=1
    # additionally spawns one on first use, =0 disables even the probe. The
    # no-daemon probe is a single failed unix connect (~microseconds), so
    # the lean-boot host path stays effectively jax-free and instant.
    from ntcard_tpu.daemon import maybe_run_via_daemon

    rc = maybe_run_via_daemon("ntcard", args_in)
    if rc is not None:
        return rc

    opt, args = parse_args(args_in)

    from ntcard_tpu.io.decompress import input_size
    from ntcard_tpu.io.readers import expand_file_args

    in_files = expand_file_args(args)

    # <50 GB heuristic overrides -s after parsing (ntcard.cpp:427-431) —
    # over the GLOBAL input, so every host picks the same sBits.
    total_size = sum(input_size(f) for f in in_files)
    if total_size < 50_000_000_000:
        opt.s_bits = 7

    if _use_host_engine(opt, total_size):
        return _main_host(opt, in_files, s_time)
    if _fast_device_ok(opt, in_files):
        return _main_device_fast(opt, in_files, total_size, s_time)
    return _main_device_legacy(opt, in_files, total_size, s_time)


def _main_device_legacy(opt, in_files, total_size, s_time) -> int:
    """Device path with serial startup — multi-host, explicit multi-device,
    hybrid engine, and CPU-platform (test) runs. Auto multi-device detection
    also lands here via _main_device_fast's fallback."""
    from ntcard_tpu._jax_config import check_backend
    import jax

    from ntcard_tpu.io.decompress import input_size
    from ntcard_tpu.models.sketch import ChainedCountTableSketch
    from ntcard_tpu.parallel.data_parallel import make_sharded_sketch
    from ntcard_tpu.pipeline import (
        default_geometry,
        device_prefetch,
        parallel_batches_from_files,
        superbatch,
    )
    from ntcard_tpu.parallel.multihost import (
        host_file_assignment,
        initialize_distributed,
        merged_finalize,
    )
    from ntcard_tpu.utils.metrics import Metrics

    # multi-host: initialize the distributed runtime BEFORE any backend use;
    # each host then processes only its deterministic file slice and the
    # tables merge at finalize (cross-host psum analog of ntcard.cpp:142-143).
    proc_id, n_procs = initialize_distributed(
        opt.coordinator or None,
        opt.num_hosts or None,
        opt.host_id if opt.host_id >= 0 else None,
    )

    check_backend()
    if n_procs > 1:
        global _FAST_EXIT_OK
        _FAST_EXIT_OK = False

        sizes = [input_size(f) for f in in_files]
        in_files = host_file_assignment(in_files, sizes, n_procs, proc_id)

    ks = opt.k_list
    kmax = max(ks)
    chunk_len, batch_rows = default_geometry(kmax)
    if opt.chunk_len:
        chunk_len = opt.chunk_len
    batch_rows = opt.batch_rows

    gap_positions = _gap_positions(opt)

    from ntcard_tpu.io.packing import aligned_stride

    stride = aligned_stride(chunk_len, kmax)
    n_dev = opt.devices or len(jax.devices())
    if n_procs > 1:
        # per-host private sketch on the host's first local device; the
        # cross-host merge happens once at finalize (merged_finalize)
        sketch = ChainedCountTableSketch(
            ks, opt.s_bits, opt.r_bits, stride, gap_positions=gap_positions
        )
    elif n_dev > 1:
        # chains (per-device private sketches) or shard_map, per
        # NTCARD_SHARDED — bit-identical either way (test_sharding)
        sketch = make_sharded_sketch(
            ks, opt.s_bits, opt.r_bits, stride, gap_positions=gap_positions, n_devices=n_dev
        )
        batch_rows = max(128, batch_rows // n_dev) * n_dev
    else:
        # independent donation chains interleave transfers and dispatches
        # (models/sketch.ChainedCountTableSketch)
        sketch = ChainedCountTableSketch(
            ks, opt.s_bits, opt.r_bits, stride, gap_positions=gap_positions
        )
    # wire format: the 2-bit quad wire halves host-to-device bytes. The
    # sharded sketch packs each shard's row block as its
    # OWN wire (per-shard sidecars, io.packing.pack_shard_wires), so quad /
    # quad2 / superbatching apply to every sketch flavor; admissibility is
    # judged on the per-shard geometry. NTCARD_WIRE=nibble opts out.
    import os as _os

    from ntcard_tpu.io.packing import pack_shard_wires, wire_mode_of

    sharded = n_procs == 1 and n_dev > 1
    rows_ps = batch_rows // n_dev if sharded else batch_rows  # rows per wire
    private_sketch = not sharded
    wire_fmt, use_quad, halo, n_super = _select_wire(rows_ps, chunk_len, stride)

    # NTCARD_ENGINE=hybrid: work-steal the raw batch stream between the
    # native host engine and the device pipeline (pipeline.hybrid_feed) and
    # sum the two commutative sketches at finalize — bit-identical to either
    # engine alone. Gated on the host table being cheap to ship for the
    # merge (uint16 tables ride one H2D put; GiB-scale default-r27 tables
    # would not), on a private (non-sharded, single-host) sketch, and on
    # the native engine actually being available.
    host_sketch = None
    host_table_bytes = len(ks) * 2 * (1 << opt.r_bits) * 2
    if _os.environ.get("NTCARD_ENGINE") == "hybrid":
        why = None
        if not private_sketch or n_procs > 1:
            why = "sharded/multi-host sketches are device-only"
        elif host_table_bytes > int(_os.environ.get("NTCARD_HYBRID_MAX_TABLE", 64 << 20)):
            why = (
                f"host table ({host_table_bytes >> 20} MB) exceeds "
                "NTCARD_HYBRID_MAX_TABLE (merge transfer would dominate)"
            )
        else:
            from ntcard_tpu.models.host_engine import (
                HostCountTableSketch,
                host_engine_available,
            )

            if not host_engine_available():
                why = "native host engine unavailable (no g++?)"
            else:
                host_sketch = HostCountTableSketch(
                    ks, opt.s_bits, opt.r_bits, stride, gap_positions=gap_positions,
                    n_threads=int(
                        _os.environ.get("NTCARD_HYBRID_HOST_THREADS", "0")
                    ) or max(1, (_os.cpu_count() or 2) - 2),
                )
        if why is not None:
            sys.stderr.write(f"{PROGRAM}: NTCARD_ENGINE=hybrid ignored: {why}\n")

    metrics = Metrics(opt.metrics)
    stats: dict = {}
    stages: dict = {}
    metrics.start_profile()
    with metrics.phase("pipeline"):
        if host_sketch is not None:
            from ntcard_tpu.io.packing import pack_wire
            from ntcard_tpu.pipeline import hybrid_feed

            raw = parallel_batches_from_files(
                in_files, chunk_len, batch_rows, kmax, opt.n_thrd, stats_out=stats,
                wire_packed=False,
            )
            # tail-guard hint: on-disk bytes overestimate the stream for
            # plain files (headers/quality inflate FASTQ/SAM ~2-4x -> the
            # device just claims longer) and underestimate it for
            # compressed/URL inputs — the guard self-disables once the
            # estimate is proven short (pipeline._tail_guard_should_stop),
            # so it never starves a fast device either way
            est_batches = total_size / float(batch_rows * stride)
            batches = (
                pack_wire(b, wire_fmt, stride)
                for b in hybrid_feed(
                    raw, host_sketch.update, total_hint=est_batches
                )
            )
        elif sharded:
            # raw batches, then one complete wire per shard row-block (the
            # quad-family sidecars are per-wire, so each shard gets its own)
            raw = parallel_batches_from_files(
                in_files, chunk_len, batch_rows, kmax, opt.n_thrd, stats_out=stats,
                wire_packed=False,
            )
            batches = (
                pack_shard_wires(b, n_dev, wire_fmt if use_quad else True, stride)
                for b in raw
            )
        else:
            batches = parallel_batches_from_files(
                in_files, chunk_len, batch_rows, kmax, opt.n_thrd, stats_out=stats,
                wire_packed=wire_fmt,
            )
        for batch in device_prefetch(
            superbatch(batches, n_super, axis=1 if sharded else 0),
            stage_times=stages if metrics.enabled else None,
            # chains engine: each shard rides one put straight to its device
            put_fn=getattr(sketch, "put_shards", None) if sharded else None,
        ):
            with metrics.phase("pipeline.dispatch"):
                if sharded:
                    w0 = batch[0]  # array [D, ...] and per-device list alike
                    wire0 = w0 if w0.ndim == 2 else w0[0]
                    sketch.update_shards(
                        batch, packed=wire_mode_of(wire0, rows_ps, halo)
                    )
                else:
                    wire0 = batch if batch.ndim == 2 else batch[0]
                    sketch.update(
                        batch,
                        packed=wire_mode_of(wire0, batch_rows, halo) if use_quad else True,
                    )
        if host_sketch is not None:
            sketch.merge_host_(host_sketch)
            metrics.tag("engine", "hybrid")
    for name in ("decode", "pack", "h2d"):
        if name in stages:
            metrics.phases[f"pipeline.{name}"] = stages[name]
    if opt.save_sketch:
        sketch.save(opt.save_sketch)
    with metrics.phase("finalize"):
        if n_procs > 1:
            state = merged_finalize(sketch.merged(), cov_max=opt.cov_max)
        else:
            state = sketch.finalize(cov_max=opt.cov_max)
    metrics.stop_profile()
    return _estimate_and_write(
        opt, state, metrics, stats, s_time, write_ok=proc_id == 0
    )


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
