#!/usr/bin/env python
"""Measured 2-host weak-scaling efficiency on the CPU 'fake cluster'
(SURVEY.md §4: jax.distributed over localhost Gloo stands in for the
network between hosts; multi-host GPU runs are ROADMAP 2.1.5).

Protocol (weak scaling: constant work PER HOST, resources pinned so the
two-host run does not simply contend for the same cores):

  run ONE CLI process pinned to half the cores on one S-base file, and
  TWO jax.distributed CLI processes (coordinator on localhost), each
  pinned to its own half of the cores, each on its own S-base file —
  INCLUDING the cross-host table merge at finalize
  (parallel/multihost.merged_finalize).

  efficiency = (pipeline+finalize)_1host / max_host (pipeline+finalize)_2host

The phase times come from each process's own --metrics JSON (stderr):
per-process measurement excludes interpreter start, jit compiles and the
jax.distributed rendezvous, whose multi-second jitter drowned the earlier
outer-wall-minus-tiny-run calibration (observed efficiencies 0.44-2.55
from the identical code). The 2-host finalize phase CONTAINS the Gloo
merge, so the added communication cost is measured, not modeled.

This measures everything the reference's OpenMP scaling claim measures
(per-worker stream + merge) plus a real network merge the reference does
not have. It does NOT measure the links between cards; chip_smoke.py
--four measures the device-to-device merge copy on four cards.

Usage: python tools/scaling_proxy.py [--reads 150000] [--passes 2]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def make_input(path: Path, n_reads: int, seed: int) -> None:
    rng = random.Random(seed)
    genome = "".join(rng.choice("ACGT") for _ in range(500_000))
    with open(path, "w") as f:
        q = "I" * 150
        for i in range(n_reads):
            s = rng.randint(0, len(genome) - 150)
            f.write(f"@r{i}\n{genome[s:s + 150]}\n+\n{q}\n")


def _env(extra: dict | None = None) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", NTCARD_FAST_EXIT="1")
    env.update(extra or {})
    return env


def _pin(cores: str) -> list:
    return ["taskset", "-c", cores] if os.path.exists("/usr/bin/taskset") else []


def _phase_secs(stderr_text: str) -> float:
    """pipeline + finalize seconds from a --metrics stderr JSON line."""
    for ln in stderr_text.splitlines():
        if ln.startswith("{"):
            try:
                p = json.loads(ln)["phases_sec"]
                return float(p.get("pipeline", 0.0)) + float(p.get("finalize", 0.0))
            except (ValueError, KeyError):
                continue
    raise RuntimeError(f"no metrics line in: {stderr_text[-400:]}")


def run_single(fq: Path, out: Path, cores: str) -> tuple:
    """(wall, pipeline+finalize seconds) of one pinned CLI process."""
    cmd = _pin(cores) + [
        sys.executable, "-m", "ntcard_tpu.cli", "-k12", "-c64", "-r16",
        "--metrics", "-p", str(out), str(fq),
    ]
    t0 = time.perf_counter()
    r = subprocess.run(
        cmd, check=True, capture_output=True, cwd=str(REPO), timeout=600, env=_env()
    )
    return time.perf_counter() - t0, _phase_secs(r.stderr.decode())


def run_two_hosts(fqs: list, out: Path, core_sets: list) -> tuple:
    """(wall, max-over-hosts pipeline+finalize seconds) of the 2-process
    jax.distributed run — the slower host bounds the job, exactly as in a
    real cluster; finalize contains the Gloo table merge."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    for pid in (0, 1):
        cmd = _pin(core_sets[pid]) + [
            sys.executable, "-m", "ntcard_tpu.cli", "-k12", "-c64", "-r16",
            "--metrics", "-p", str(out) + f"_h{pid}",
            "--coordinator", f"localhost:{port}",
            "--num-hosts", "2", "--host-id", str(pid),
        ] + [str(f) for f in fqs]
        procs.append(
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(REPO),
                env=_env(),
            )
        )
    phase = 0.0
    for p in procs:
        _o, e = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(e.decode()[-1000:])
        phase = max(phase, _phase_secs(e.decode()))
    return time.perf_counter() - t0, phase


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=150_000, help="reads per host")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--workdir", default="/tmp/ntcard_scaling")
    args = ap.parse_args()

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    fq0, fq1 = work / "h0.fq", work / "h1.fq"
    for f, seed in ((fq0, 1), (fq1, 2)):
        if not f.exists():
            make_input(f, args.reads, seed)

    ncpu = os.cpu_count() or 4
    half = ncpu // 2
    c0 = f"0-{half - 1}" if half > 1 else "0"
    c1 = f"{half}-{ncpu - 1}" if half > 1 else "1"

    ones = [run_single(fq0, work / "one", c0) for _ in range(args.passes)]
    twos = [
        run_two_hosts([fq0, fq1], work / "two", [c0, c1])
        for _ in range(args.passes)
    ]
    t1 = min(w for w, _ in ones)
    t2 = min(w for w, _ in twos)
    s1 = min(p for _, p in ones)  # pipeline+finalize, single host
    s2 = min(p for _, p in twos)  # max over the two hosts
    stream_eff = s1 / max(s2, 1e-6)
    # extrapolation to 1 Gbp/host: the stream scales linearly with input;
    # the merge is one fixed collective (its cost is inside s2 already and
    # does not grow with input size)
    bases = args.reads * 150
    scale = 1e9 / bases
    merge_extra = max(s2 - s1, 0.0)
    eff_1gbp = min(1.0, (s1 * scale) / (s1 * scale + merge_extra))
    # sanity: the 2-host run's output must equal a 1-process run over BOTH
    # files (bit-exact merge) — correctness rides with the measurement
    subprocess.run(
        _pin(c0) + [sys.executable, "-m", "ntcard_tpu.cli", "-k12", "-c64",
                    "-r16", "-p", str(work / "both"), str(fq0), str(fq1)],
        check=True, capture_output=True, cwd=str(REPO), timeout=600, env=_env(),
    )
    merged = (Path(str(work / "two") + "_h0_k12.hist")).read_bytes()
    combined = (work / "both_k12.hist").read_bytes()
    print(
        json.dumps(
            {
                "metric": "weak_scaling_efficiency_2host_cpu",
                "t1_sec": round(t1, 3),
                "t2_sec": round(t2, 3),
                "efficiency_whole_wall": round(t1 / t2, 4),
                "phase_sec_1host": round(s1, 3),
                "phase_sec_2host_max": round(s2, 3),
                "stream_efficiency": round(stream_eff, 4),
                "efficiency_extrapolated_1gbp_per_host": round(eff_1gbp, 4),
                "reads_per_host": args.reads,
                "cores_per_host": half,
                "merge_bit_exact": merged == combined,
                # both 'hosts' are pinned core-halves of ONE box: they share
                # memory bandwidth and co-tenant load, so stream_efficiency
                # LOWER-BOUNDS real 2-host efficiency
                "note": "stream_efficiency is a lower bound (shared box)",
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
