#!/usr/bin/env python3
"""End-to-end proof that ntcard and nthll run on an NVIDIA GPU.

    python chip_smoke.py [--seed N] [--four]

Drives the product through its user entry points (bin/ntcard, bin/nthll,
bin/ntcardd) on the card, byte-compares every output with a reference, and
times the kernels of the main path. The parent process never imports jax:
each phase is a child process, run one after another, so exactly one JAX
process holds the card at any time. It exits non-zero at the first failed
phase or byte mismatch, and only a complete run prints the last line,
``{"ok": true, "device": {...}}``.

Phases (one card, the default):
  device   platform gpu, device_kind, count, memory_stats()
  goldens  every tests/golden/*.good through the CLIs, NTCARD_ENGINE=device
  inputs   4 gzip'd (level 1) FASTQ lanes of 500,000 x 150 bp reads from
           --seed (300 Mbp in all), reads sampled at 30x from a random
           genome with substitution errors and Ns
  real     ntcard -k64,96,128 -c1000 (default r27), ntcard -k64 -c64 -r16
           and nthll -k64 on the lanes, device engine vs the native host
           engine (the repo's plain reference, independent of JAX): cold
           wall (fresh compile cache), two warm walls (same cache), peak
           device memory, the --metrics phase split; the r27 cold and warm
           walls again with NTCARD_AOT=0
  kernels  the jitted hash+update step at the real batch geometry in both
           plain sentinel forms (r16 k64; r27 k64,96,128), the finalize
           bundle at r27 3-k and the HLL update at k=64, with
           compiled.memory_analysis(); tables and histograms checked
           against np.bincount
  daemon   bin/ntcardd serving the r27 job twice (byte-compared with the
           real phase), and a second client started mid-job, which must
           queue behind it and never open the card

--four runs only the multi-card path and what it is compared with: the r27
3-k job (--devices 4) and nthll -k64 (all four cards) under both
multi-device engines (NTCARD_SHARDED=chains, shardmap), byte-compared with
one card, plus the per-device table placement and the device-to-device
merge transfer rate.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DATA = REPO / "tests" / "data"
GOLD = REPO / "tests" / "golden"

N_LANES, READS_PER_LANE, READ_LEN = 4, 500_000, 150
GENOME_LEN = 10_000_000  # 300 Mbp of reads = 30x coverage

# (golden files, CLI, argv) — the commands of tests/test_e2e_golden.py
GOLDEN_RUNS = [
    (["reads_k12.hist.good"], "ntcard", ["-k12", "-c1000", "-r16", "-p", "{o}/t", "{d}/reads.fq"]),
    (["reads_k12.hist.good"], "ntcard", ["-k12", "-c1000", "-r16", "-p", "{o}/t", "{d}/reads.sam"]),
    (["reads-gap_k12.hist.good"], "ntcard",
     ["-k12", "-c1000", "-r16", "-g2", "-p", "{o}/t", "{d}/reads.fq"]),
    (["reads_k32.hist.good", "reads_k64.hist.good", "reads_k96.hist.good"], "ntcard",
     ["-k32,64,96", "-c64", "-r16", "-p", "{o}/m", "{d}/reads.fq"]),
    (["contig_k25.hist.good", "contig_k96.hist.good"], "ntcard",
     ["-k25,96", "-c64", "-r16", "-p", "{o}/c", "{d}/contig.fa"]),
    (["reads_compact.tsv.good"], "ntcard",
     ["-k12,32", "-c64", "-r16", "-o", "{o}/out.tsv", "{d}/reads.fq"]),
    (["both_k12.hist.good"], "ntcard",
     ["-k12", "-c1000", "-r16", "-p", "{o}/b", "{d}/reads.fq", "{d}/contig.fa"]),
    (["reads_r27_k12.hist.good"], "ntcard",
     ["-k12", "-c1000", "--devices", "1", "-p", "{o}/d", "{d}/reads.fq"]),
    (["nthll_k25.out.good"], "nthll", ["-k25", "{d}/reads.fq"]),
    (["nthll_k25_b10.out.good"], "nthll", ["-k25", "-b10", "{d}/reads.fq"]),
]

# the real-size jobs: (name, CLI, flags, output files)
REAL_JOBS = [
    ("r27_k64_96_128", "ntcard", ["-k64,96,128", "-c1000"], ["k64.hist", "k96.hist", "k128.hist"]),
    ("r16_k64", "ntcard", ["-k64", "-c64", "-r16"], ["k64.hist"]),
    ("hll_k64", "nthll", ["-k64"], ["stdout"]),
]


# the kernel phase's step geometries: (name, ks, r_bits)
KERNEL_CONFIGS = [("r16_k64", [64], 16), ("r27_k64_96_128", [64, 96, 128], 27)]
PLACEMENT_R_BITS = 27  # one default-size (1.07 GB) table per card


class SmokeFailure(Exception):
    pass


def say(line: str) -> None:
    print(line, flush=True)


# --------------------------------------------------------------- parent


def _base_env(cache_root: Path) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["NTCARD_DAEMON"] = "0"  # phases choose the daemon explicitly
    env["JAX_COMPILATION_CACHE_DIR"] = str(cache_root)
    env.pop("NTCARD_ENGINE", None)
    return env


def _cache_base() -> Path:
    """Where this run's compile caches live: under JAX_COMPILATION_CACHE_DIR
    when the machine sets it, else the checkout's git-ignored .jax_cache."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else REPO / ".jax_cache"


def _fresh_cache(tag: str) -> Path:
    """An empty compile-cache root holding only the native host library
    (built once; a cold device run should not pay a g++ build)."""
    d = _cache_base() / f"smoke-{tag}"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    native = _cache_base() / "ntcard_native"
    if native.is_dir():
        shutil.copytree(native, d / "ntcard_native")
    return d


def run_child(phase: str, args: dict, env: dict, timeout: float) -> dict:
    """Run one phase in a child process; its last stdout line is JSON."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child", phase, json.dumps(args)]
    r = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=timeout, cwd=str(REPO))
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    if r.returncode != 0 or not lines:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-6000:])
        raise SmokeFailure(f"phase {phase}: child exited {r.returncode}")
    for ln in lines[:-1]:
        say(f"  {ln}")
    return json.loads(lines[-1])


def run_cli(prog: str, argv: list, env: dict, timeout: float = 900) -> tuple:
    """Run bin/<prog> as a user would; -> (wall seconds, stdout, stderr)."""
    t0 = time.monotonic()
    r = subprocess.run(
        [str(REPO / "bin" / prog)] + argv, capture_output=True, text=True, env=env,
        timeout=timeout, cwd=str(REPO),
    )
    wall = time.monotonic() - t0
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-3000:] + r.stderr[-6000:])
        raise SmokeFailure(f"{prog} {' '.join(argv)}: exit {r.returncode}")
    return wall, r.stdout, r.stderr


def _metrics_of(stderr: str) -> dict:
    for ln in stderr.splitlines():
        if ln.startswith("{") and '"phases_sec"' in ln:
            return json.loads(ln)
    return {}


def _outputs(prefix: Path, files: list, stdout: str) -> dict:
    out = {}
    for f in files:
        out[f] = stdout.encode() if f == "stdout" else Path(f"{prefix}_{f}").read_bytes()
    return out


def _job_argv(prog: str, flags: list, prefix: Path, lanes: list) -> list:
    argv = list(flags) + ["-t4"]
    if prog == "ntcard":
        argv += ["--metrics", "-p", str(prefix)]
    return argv + [str(p) for p in lanes]


def phase_device(env: dict, need: int) -> dict:
    dev = run_child("device", {"need": need}, env, timeout=300)
    say(
        f"phase device: platform={dev['platform']} kind={dev['kind']} count={dev['count']} "
        f"bytes_limit={dev['memory'].get('bytes_limit')}"
    )
    return dev


def phase_nvidia_smi() -> None:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0 or not r.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {r.stderr.strip()}")
    for ln in r.stdout.strip().splitlines():
        say(f"card: {ln.strip()}")


def phase_goldens(work: Path, env: dict) -> None:
    out = work / "golden"
    out.mkdir()
    env = dict(env, NTCARD_ENGINE="device")
    t0 = time.monotonic()
    for goods, prog, argv in GOLDEN_RUNS:
        argv = [a.format(o=out, d=DATA) for a in argv]
        _, stdout, stderr = run_cli(prog, argv, env)
        for g in goods:
            want = (GOLD / g).read_bytes()
            if prog == "nthll":
                got = stdout.encode()
            elif g.endswith(".tsv.good"):
                got = (out / "out.tsv").read_bytes()
                klines = "".join(ln + "\n" for ln in stderr.splitlines() if ln.startswith("k="))
                if klines != (GOLD / "reads_compact.stderr.good").read_text():
                    raise SmokeFailure("golden reads_compact.stderr.good differs")
            else:
                pref = argv[argv.index("-p") + 1]
                got = Path(f"{pref}_{g.split('_')[-1].replace('.good', '')}").read_bytes()
            if got != want:
                raise SmokeFailure(f"golden {g} differs ({prog} {' '.join(argv)})")
    say(f"phase goldens: {sum(len(g) for g, _, _ in GOLDEN_RUNS) + 1} files byte-equal "
        f"over {len(GOLDEN_RUNS)} device runs, {time.monotonic() - t0:.1f} s")


def make_inputs(work: Path, seed: int) -> list:
    """4 gzip level-1 FASTQ lanes of reads from a random genome: uniform
    positions, half reverse-complemented, 0.5% substitutions, 0.05% N."""
    import gzip

    import numpy as np

    t0 = time.monotonic()
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=GENOME_LEN, dtype=np.uint8)
    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    lanes = []
    blobs = []
    for lane in range(N_LANES):
        n = READS_PER_LANE
        pos = rng.integers(0, GENOME_LEN - READ_LEN, size=n)
        reads = genome[pos[:, None] + np.arange(READ_LEN)]
        rc = rng.random(n) < 0.5
        reads[rc] = 3 - reads[rc, ::-1]
        err = rng.random(reads.shape) < 0.005
        reads[err] = rng.integers(0, 4, size=int(err.sum()), dtype=np.uint8)
        reads[rng.random(reads.shape) < 0.0005] = 4
        head = np.frombuffer(
            "".join(f"@L{lane}_{i:07d}\n" for i in range(n)).encode(), np.uint8
        ).reshape(n, -1)
        rec = np.concatenate(
            [
                head,
                acgtn[reads],
                np.full((n, 3), np.frombuffer(b"\n+\n", np.uint8)),
                np.full((n, READ_LEN), ord("I"), np.uint8),
                np.full((n, 1), ord("\n"), np.uint8),
            ],
            axis=1,
        )
        blobs.append(rec.tobytes())
        lanes.append(work / f"lane{lane}.fq.gz")

    def write(i):
        with gzip.open(lanes[i], "wb", compresslevel=1) as fh:
            fh.write(blobs[i])

    threads = [threading.Thread(target=write, args=(i,)) for i in range(N_LANES)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    mb = sum(p.stat().st_size for p in lanes) / 1e6
    say(
        f"phase inputs: {N_LANES} lanes x {READS_PER_LANE} x {READ_LEN} bp = "
        f"{N_LANES * READS_PER_LANE * READ_LEN / 1e6:.0f} Mbp, {mb:.1f} MB gzip, "
        f"{time.monotonic() - t0:.1f} s"
    )
    return lanes


def phase_real(work: Path, lanes: list) -> dict:
    """Device engine vs host engine on the lanes; -> reference outputs."""
    refs = {}
    host_env = dict(_base_env(_cache_base()), NTCARD_ENGINE="host")
    for name, prog, flags, files in REAL_JOBS:
        prefix = work / f"host_{name}"
        wall, so, _ = run_cli(prog, _job_argv(prog, flags, prefix, lanes), host_env)
        refs[name] = _outputs(prefix, files, so)
        say(f"phase real: {name} host engine wall={wall:.3f} s")
    for name, prog, flags, files in REAL_JOBS:
        cache = _fresh_cache(f"real-{name}")
        env = dict(_base_env(cache), NTCARD_ENGINE="device")
        if prog == "nthll":
            env["NTCARD_METRICS"] = "1"  # nthll's --metrics (no flag of its own)
        # warm = the first run on a warm cache (it also verifies the AOT
        # fast-key mappings the cold run recorded), warm2 = steady state
        runs = [("cold", env), ("warm", env), ("warm2", env)]
        if name.startswith("r27"):
            aot0 = dict(_base_env(_fresh_cache("real-aot0")), NTCARD_ENGINE="device", NTCARD_AOT="0")
            runs += [("cold_aot0", aot0), ("warm_aot0", aot0)]
        for tag, e in runs:
            prefix = work / f"dev_{name}_{tag}"
            wall, so, se = run_cli(prog, _job_argv(prog, flags, prefix, lanes), e)
            got = _outputs(prefix, files, so)
            if got != refs[name]:
                raise SmokeFailure(f"real {name} ({tag}): device output differs from host engine")
            m = _metrics_of(se)
            say(
                f"phase real: {name} {tag} wall={wall:.3f} s byte-equal=host "
                f"peak_bytes_in_use={m.get('device_peak_bytes', 'not reported')} "
                f"phases={json.dumps(m.get('phases_sec', {}))}"
            )
    return refs


def phase_kernels(lanes: list, env: dict) -> None:
    res = run_child("kernels", {"lanes": [str(p) for p in lanes], "configs": KERNEL_CONFIGS},
                    env, timeout=900)
    say(f"phase kernels: {json.dumps(res)}")


def phase_daemon(work: Path, lanes: list, refs: dict, env: dict) -> None:
    sock = Path(tempfile.mkdtemp(prefix="ntcd")) / "d.sock"
    denv = dict(env, NTCARD_DAEMON_SOCK=str(sock), NTCARD_ENGINE="device")
    denv.pop("NTCARD_DAEMON", None)  # the CLIs' default: use a live daemon
    log = open(work / "daemon.log", "w")
    proc = subprocess.Popen([str(REPO / "bin" / "ntcardd")], env=denv, stdout=log,
                            stderr=subprocess.STDOUT, cwd=str(REPO))
    try:
        t0 = time.monotonic()
        while "serving on" not in (work / "daemon.log").read_text():
            if proc.poll() is not None or time.monotonic() - t0 > 300:
                raise SmokeFailure("daemon did not start: " + (work / "daemon.log").read_text()[-2000:])
            time.sleep(0.1)
        say(f"phase daemon: serving after {time.monotonic() - t0:.1f} s")
        name, prog, flags, files = REAL_JOBS[0]
        for i in range(2):
            prefix = work / f"daemon_{i}"
            wall, so, _ = run_cli(prog, _job_argv(prog, flags, prefix, lanes), denv)
            if _outputs(prefix, files, so) != refs[name]:
                raise SmokeFailure(f"daemon job {i}: output differs")
            say(f"phase daemon: {name} job {i} wall={wall:.3f} s byte-equal=host")
        jobs0 = _daemon_jobs(sock)
        # a second client while a job runs: it must queue, not open the card
        prefix_a = work / "daemon_a"
        a = subprocess.Popen([str(REPO / "bin" / prog)] + _job_argv(prog, flags, prefix_a, lanes),
                             env=denv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        t_busy = time.monotonic()
        while not _daemon_busy(sock):
            if a.poll() is not None or time.monotonic() - t_busy > 120:
                raise SmokeFailure("the daemon never reported the first job busy")
            time.sleep(0.02)
        hname, hprog, hflags, hfiles = REAL_JOBS[2]
        t_b = time.monotonic()
        b = subprocess.run([str(REPO / "bin" / hprog)] + _job_argv(hprog, hflags, None, lanes),
                           env=denv, capture_output=True, text=True, timeout=900)
        wall_b = time.monotonic() - t_b
        out_a, err_a = a.communicate(timeout=900)
        if a.returncode != 0 or b.returncode != 0:
            sys.stderr.write(err_a[-3000:] + b.stderr[-3000:])
            raise SmokeFailure(f"concurrent clients failed: rc {a.returncode}, {b.returncode}")
        if _outputs(prefix_a, files, out_a) != refs[name] or b.stdout.encode() != refs[hname]["stdout"]:
            raise SmokeFailure("concurrent clients: output differs")
        jobs1 = _daemon_jobs(sock)
        if jobs1 != jobs0 + 2:
            raise SmokeFailure(f"second client did not go through the daemon (jobs {jobs0} -> {jobs1})")
        say(f"phase daemon: second client queued behind a running job: both through the daemon "
            f"(jobs {jobs0} -> {jobs1}), {hname} wall={wall_b:.3f} s, outputs byte-equal=host")
    finally:
        subprocess.run([str(REPO / "bin" / "ntcardd"), "--stop"], env=denv,
                       capture_output=True, timeout=120)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        shutil.rmtree(sock.parent, ignore_errors=True)


def _daemon_request(sock: Path, op: str | None) -> tuple:
    import socket

    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(30)
    try:
        s.connect(str(sock))
        f = s.makefile("rb")
        hello = json.loads(f.readline())
        if op is None:
            return hello, None
        s.sendall(json.dumps({"proto": 2, "op": op}).encode() + b"\n")
        return hello, json.loads(f.readline())
    finally:
        s.close()


def _daemon_busy(sock: Path) -> bool:
    return bool(_daemon_request(sock, None)[0].get("busy"))


def _daemon_jobs(sock: Path) -> int:
    import re

    out = _daemon_request(sock, "ping")[1]["out"]
    return int(re.search(r"jobs (\d+)", out).group(1))


def phase_four(work: Path, lanes: list, env: dict) -> None:
    res = run_child("placement", {"r_bits": PLACEMENT_R_BITS}, env, timeout=600)
    say(f"phase placement: {json.dumps(res)}")
    base = {}
    for name, prog, flags, files in (REAL_JOBS[0], REAL_JOBS[2]):
        one = dict(env, NTCARD_ENGINE="device")
        fl = list(flags)
        if prog == "ntcard":
            fl += ["--devices", "1"]
        else:
            one["CUDA_VISIBLE_DEVICES"] = "0"  # nthll shards over every visible card
        prefix = work / f"one_{name}"
        wall, so, _ = run_cli(prog, _job_argv(prog, fl, prefix, lanes), one)
        base[name] = _outputs(prefix, files, so)
        say(f"phase four: {name} one card wall={wall:.3f} s")
        for engine in ("chains", "shardmap"):
            e = dict(env, NTCARD_ENGINE="device", NTCARD_SHARDED=engine, NTCARD_METRICS="1")
            fl4 = list(flags) + (["--devices", "4"] if prog == "ntcard" else [])
            prefix = work / f"four_{name}_{engine}"
            wall, so, se = run_cli(prog, _job_argv(prog, fl4, prefix, lanes), e)
            if _outputs(prefix, files, so) != base[name]:
                raise SmokeFailure(f"four cards {name} {engine}: output differs from one card")
            m = _metrics_of(se)
            say(f"phase four: {name} {engine} wall={wall:.3f} s byte-equal=one-card "
                f"peak_bytes_in_use={m.get('device_peak_bytes', 'not reported')} "
                f"phases={json.dumps(m.get('phases_sec', {}))}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true", help="the four-card path only")
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return child_main(a.child[0], json.loads(a.child[1]))
    if not (REPO / "ntcard_tpu").is_dir() or not (REPO / "bin" / "ntcard").exists():
        say("chip_smoke: the ntcard checkout is not beside this script")
        return 2
    need = 4 if a.four else 1
    work = Path(tempfile.mkdtemp(prefix="ntcard-smoke-"))
    env = _base_env(_cache_base())
    t0 = time.monotonic()
    try:
        dev = phase_device(env, need)
        phase_nvidia_smi()
        if a.four:
            lanes = make_inputs(work, a.seed)
            phase_four(work, lanes, env)
        else:
            phase_goldens(work, env)
            lanes = make_inputs(work, a.seed)
            refs = phase_real(work, lanes)
            phase_kernels(lanes, env)
            phase_daemon(work, lanes, refs, env)
    except (SmokeFailure, subprocess.TimeoutExpired) as e:
        say(f"chip_smoke: FAILED: {e}")
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(f"chip_smoke: all phases passed in {time.monotonic() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": dev["platform"], "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


# ---------------------------------------------------------------- children


def child_main(phase: str, args: dict) -> int:
    import jax

    if phase == "device":
        devs = jax.devices()
        d = devs[0]
        if d.platform != "gpu":
            raise SystemExit(f"chip_smoke: JAX's backend is {d.platform!r}, not a GPU")
        if len(devs) < args["need"]:
            raise SystemExit(f"chip_smoke: {len(devs)} GPUs, {args['need']} needed")
        mem = {k: v for k, v in (d.memory_stats() or {}).items() if "limit" in k or "in_use" in k}
        print(json.dumps({"platform": d.platform, "kind": d.device_kind, "count": len(devs),
                          "memory": mem}))
    elif phase == "kernels":
        print(json.dumps(_kernels([Path(p) for p in args["lanes"]], args["configs"])))
    elif phase == "placement":
        print(json.dumps(_placement(args["r_bits"])))
    else:
        raise SystemExit(f"unknown phase {phase}")
    return 0


HBM_BYTES_PER_SEC = 3.35e12  # H100 SXM data sheet


def _time(fn, *args, n=20):
    """Mean seconds per call of a chained (donating) step after warm-up;
    ``fn(state, *args) -> state``."""
    import jax

    state = fn(*args)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(n):
        state = fn(state, *args[1:])
    jax.block_until_ready(state)
    return (time.perf_counter() - t0) / n, state


def _mem(compiled) -> dict:
    m = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
            "alias_size_in_bytes", "generated_code_size_in_bytes")
    return {k: getattr(m, k, None) for k in keys} if m is not None else {}


def _kernels(lanes: list, configs: list) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ntcard_tpu.io.packing import aligned_stride, wire_mode_of
    from ntcard_tpu.models import hll as H
    from ntcard_tpu.models import sketch as S
    from ntcard_tpu.ops.nthash import sketch_scan
    from ntcard_tpu.pipeline import default_geometry, parallel_batches_from_files

    out = {}
    s_bits = 7  # inputs under 50 GB (ntcard.cpp:427-431)
    for cfg, ks, r_bits in configs:
        ks = tuple(ks)
        kmax = max(ks)
        chunk, rows = default_geometry(kmax)
        stride = aligned_stride(chunk, kmax)
        gen = parallel_batches_from_files([str(lanes[0])], chunk, rows, kmax, 1, wire_packed="quad2")
        wires = [w for w, _ in zip(gen, range(3))]
        gen.close()
        mode = wire_mode_of(wires[0], rows, chunk - stride)
        wire = jax.device_put(wires[0])
        size = 2 * (1 << r_bits) + 1

        def step(form):
            def f(tables, codes):
                idx, _ = sketch_scan(codes, ks, stride, s_bits, r_bits, None, packed=mode)
                return tuple(form(t, idx[k]) for t, k in zip(tables, ks))

            return jax.jit(f, donate_argnums=0)

        forms = {
            "drop": lambda t, i: S._table_add(t, i, r_bits),
            "dump": S._table_add_dump,
        }
        emit = jax.jit(lambda c: sketch_scan(c, ks, stride, s_bits, r_bits, None, packed=mode))
        idx, f1 = emit(wire)
        idx = {k: np.asarray(v) for k, v in idx.items()}
        sampled = {k: int((v != 2 * (1 << r_bits)).sum()) for k, v in idx.items()}
        windows = sum(int(f1[k]) for k in ks)
        n_positions = sum(v.size for v in idx.values())
        res = {"windows": windows, "positions": n_positions, "sampled_updates": sum(sampled.values()),
               "wire_bytes": int(wires[0].nbytes)}
        for name, form in forms.items():
            fn = step(form)
            zeros = tuple(jnp.zeros((size,), jnp.int32) for _ in ks)
            compiled = fn.lower(zeros, wire).compile()
            sec, tables = _time(lambda t, c: fn(t, c), zeros, wire)
            # bytes the step must move: the wire once, plus a 4-byte read and
            # write per applied update (the dump form applies every window
            # position, sentinels included)
            applied = n_positions if name == "dump" else sum(sampled.values())
            nbytes = wires[0].nbytes + 8 * applied
            res[name] = {
                "ms": round(sec * 1e3, 4),
                "bytes": nbytes,
                "hbm_bound_ms": round(nbytes / HBM_BYTES_PER_SEC * 1e3, 4),
                "xla_bytes_accessed": (compiled.cost_analysis() or {}).get("bytes accessed"),
                "memory_analysis": _mem(compiled),
            }
            del tables
        # correctness: one batch through the product step vs np.bincount
        tables, _f1s = S._update_first(
            jnp.zeros((len(ks), 2), jnp.uint32), wire, ks, stride, s_bits, r_bits, None, mode
        )
        k0 = ks[0]
        t0 = np.asarray(tables[0])[: 2 * (1 << r_bits)]
        want = np.bincount(idx[k0][idx[k0] != 2 * (1 << r_bits)], minlength=2 * (1 << r_bits))
        if not np.array_equal(t0, want):
            raise SystemExit(f"kernels {cfg}: product update differs from np.bincount")
        res["update_check"] = "table == np.bincount(emit stream), one batch, k=%d" % k0
        if len(ks) > 1:
            # fill the tables with the three batches, then time the bundle
            for w in wires[1:]:
                tables, _f1s = S._update(tables, _f1s, jax.device_put(w), ks, stride, s_bits,
                                         r_bits, None, wire_mode_of(w, rows, chunk - stride))
            nbins = 1001
            bundle = jax.jit(S._finalize_bundle._fn, static_argnames=("r_buck", "nbins"))
            compiled = bundle.lower(tables, _f1s, r_buck=1 << r_bits, nbins=nbins).compile()
            flat = bundle(tables, _f1s, r_buck=1 << r_bits, nbins=nbins)
            jax.block_until_ready(flat)
            t_0 = time.perf_counter()
            for _ in range(10):
                flat = bundle(tables, _f1s, r_buck=1 << r_bits, nbins=nbins)
            jax.block_until_ready(flat)
            sec = (time.perf_counter() - t_0) / 10
            flat = np.asarray(flat)
            hists = flat[: 2 * len(ks) * nbins].reshape(len(ks), 2, nbins)
            for i in range(len(ks)):
                row_all = np.asarray(tables[i])
                for s in range(2):
                    row = row_all[s * (1 << r_bits): (s + 1) * (1 << r_bits)] & 0xFFFF
                    if not np.array_equal(hists[i, s], np.bincount(row, minlength=65536)[:nbins]):
                        raise SystemExit(f"kernels: finalize histogram k={ks[i]} s={s} differs")
            nbytes = len(ks) * 2 * (1 << r_bits) * 4
            out[f"finalize_{cfg}"] = {
                "ms": round(sec * 1e3, 4), "bytes": nbytes,
                "hbm_bound_ms": round(nbytes / HBM_BYTES_PER_SEC * 1e3, 4),
                "check": "hists == np.bincount(fetched rows)",
                "memory_analysis": _mem(compiled),
            }
        out[cfg] = res
        del tables
    # HLL update at k=64
    chunk, rows = default_geometry(64)
    stride = aligned_stride(chunk, 64)
    gen = parallel_batches_from_files([str(lanes[0])], chunk, rows, 64, 1, wire_packed="quad2")
    w = next(gen)
    gen.close()
    mode = wire_mode_of(w, rows, chunk - stride)
    wire = jax.device_put(w)
    upd = jax.jit(H._update._fn, static_argnames=("k", "stride", "n_bits", "packed"),
                  donate_argnums=0)
    regs = jnp.zeros((1 << 16,), jnp.int32)
    compiled = upd.lower(regs, wire, k=64, stride=stride, n_bits=16, packed=mode).compile()
    sec, regs = _time(lambda r, c: upd(r, c, k=64, stride=stride, n_bits=16, packed=mode), regs, wire)
    out["hll_k64"] = {"ms": round(sec * 1e3, 4), "wire_bytes": int(w.nbytes),
                      "memory_analysis": _mem(compiled)}
    return out


def _placement(r_bits: int) -> dict:
    """Per-device chains: each card holds its own tables after updates, and
    the merge's device-to-device copy rate (NVLink vs a host bounce)."""
    import jax
    import numpy as np

    from ntcard_tpu.io.packing import aligned_stride, pack_records
    from ntcard_tpu.parallel.data_parallel import PerDeviceCountTableSketch

    devs = jax.devices()[:4]
    k, stride = 64, aligned_stride(1024, 64)
    sk = PerDeviceCountTableSketch((k,), 7, r_bits, stride, n_devices=4)
    rng = np.random.default_rng(0)
    recs = [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=150)) for _ in range(4000)]
    for b in pack_records(recs, 1024, 4 * 128, k):
        sk.update(b)
    where = [sorted(d.id for d in s.tables[0].devices()) for s in sk._sketches]
    if where != [[d.id] for d in devs]:
        raise SystemExit(f"placement: chain tables on {where}, expected one per card")
    t = sk._sketches[1].tables[0]
    jax.block_until_ready(jax.device_put(t, devs[0]))  # warm the copy path
    t0 = time.perf_counter()
    for _ in range(5):
        c = jax.device_put(t, devs[0])
        jax.block_until_ready(c)
    sec = (time.perf_counter() - t0) / 5
    del c
    gb = t.nbytes / 1e9
    return {"chain_table_devices": where, "table_gb": round(gb, 3),
            "d2d_copy_ms": round(sec * 1e3, 3), "d2d_gb_per_s": round(gb / sec, 1)}


if __name__ == "__main__":
    sys.exit(main())
