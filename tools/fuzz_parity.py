"""Randomized end-to-end parity fuzzer: this ntcard vs the reference binary.

Generates random inputs (formats, record lengths incl. < k, N runs,
lowercase, RNA U, CRLF, wrapped FASTA, gzip) and random flag sets, runs
both implementations, and byte-diffs every output artifact. Exercised by
tests/test_fuzz_parity.py (a few seeds) and runnable standalone:

    python tools/fuzz_parity.py --n 20 [--seed 0] [--ref /tmp/ntcard_ref]

Reference build (tests/golden/regen.sh has the same recipe):
    g++ -O3 -fopenmp -I$REF -I$REF/Common -I$REF/vendor -I$REF/vendor/ntHash \
        -o /tmp/ntcard_ref $REF/ntcard.cpp $REF/Common/{Uncompress,Fcontrol,SignalHandler}.cpp -ldl
"""

from __future__ import annotations

import argparse
import gzip
import os
import random
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REF_SRC = Path("/root/reference")


def build_reference(exe: Path, main_src: str = "ntcard.cpp") -> bool:
    if exe.exists():
        return True
    if not REF_SRC.exists() or not shutil.which("g++"):
        return False
    srcs = [REF_SRC / main_src] + [
        REF_SRC / "Common" / f
        for f in ("Uncompress.cpp", "Fcontrol.cpp", "SignalHandler.cpp")
    ]
    cmd = (
        ["g++", "-O3", "-fopenmp"]
        + [f"-I{p}" for p in (REF_SRC, REF_SRC / "Common", REF_SRC / "vendor", REF_SRC / "vendor/ntHash")]
        + ["-o", str(exe)]
        + [str(s) for s in srcs]
        + ["-ldl"]
    )
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def random_seq(rng: random.Random, n: int) -> str:
    alpha = "ACGT"
    s = [rng.choice(alpha) for _ in range(n)]
    # sprinkle N runs
    if n > 4 and rng.random() < 0.4:
        i = rng.randrange(n)
        for j in range(i, min(n, i + rng.randrange(1, 5))):
            s[j] = "N"
    t = "".join(s)
    if rng.random() < 0.3:
        t = t.lower()
    if rng.random() < 0.2:
        t = t.replace("T", "U").replace("t", "u")
    return t


def write_input(rng: random.Random, path_base: Path):
    """Random records in a random container; returns the input path."""
    n_rec = rng.randrange(1, 400)
    maxlen = rng.choice([30, 80, 200, 600, 600, 600])
    if rng.random() < 0.15:  # chromosome-style: few records spanning many
        n_rec = rng.randrange(1, 6)  # (kmax-1)-halo chunks
        maxlen = 20_000
    recs = [random_seq(rng, rng.randrange(0, maxlen)) for _ in range(n_rec)]
    fmt = rng.choice(["fq", "fa", "fa_wrapped", "sam"])
    if fmt == "fq":
        body = "".join(f"@r{i} x\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(recs))
        p = path_base.with_suffix(".fq")
    elif fmt == "fa":
        body = "".join(f">c{i}\n{s}\n" for i, s in enumerate(recs))
        p = path_base.with_suffix(".fa")
    elif fmt == "fa_wrapped":
        out = []
        for i, s in enumerate(recs):
            out.append(f">c{i}\n")
            w = rng.randrange(10, 80)
            for j in range(0, max(len(s), 1), w):
                out.append(s[j : j + w] + "\n")
        body = "".join(out)
        p = path_base.with_suffix(".fa")
    else:  # sam
        hdr = "@HD\tVN:1.6\n@SQ\tSN:c\tLN:1000\n" if rng.random() < 0.7 else ""
        rows = "".join(
            f"r{i}\t0\tc\t1\t60\t{max(len(s),1)}M\t*\t0\t0\t{s or '*'}\t*\n"
            for i, s in enumerate(recs)
        )
        body = hdr + rows
        p = path_base.with_suffix(".sam")
    if rng.random() < 0.15:
        body = body.replace("\n", "\r\n")  # CRLF files (CR is seq-adjacent)
    data = body.encode()
    if fmt != "sam" and rng.random() < 0.3:
        p = Path(str(p) + ".gz")
        data = gzip.compress(data)
    p.write_bytes(data)
    return p


def random_flags(rng: random.Random):
    if rng.random() < 0.25:
        k = [rng.randrange(4, 145)]
        g = 0
        if rng.random() < 0.5:
            g = rng.randrange(1, max(2, k[0] // 2))
            if g % 2 != k[0] % 2:
                g += 1
            if g == 0 or g >= k[0]:
                g = 0
    else:
        k = sorted(rng.sample(range(4, 100), rng.randrange(1, 4)))
        g = 0
    flags = ["-k" + ",".join(map(str, k))]
    if g:
        flags.append(f"-g{g}")
    flags.append(f"-c{rng.choice([1, 10, 64, 200])}")
    flags.append(f"-r{rng.choice([8, 12, 14, 16, 18])}")
    if rng.random() < 0.3:
        flags.append(f"-t{rng.choice([1, 2, 3])}")
    return flags, k


_DAEMON: dict = {}


def _daemon_sock(workdir: Path) -> str | None:
    """One warm-pool daemon per fuzz session (CPU 8-device mesh, private
    socket) for the daemon rotation arm; spawned lazily, stopped by
    stop_daemon(). Returns None if it fails to come up (cases then run the
    plain arms — never a spurious mismatch)."""
    import socket
    import time

    if "sock" in _DAEMON:
        return _DAEMON["sock"]
    sock = str(workdir / "fuzzd.sock")
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8",
        NTCARD_DAEMON_SOCK=sock,
        NTCARD_DAEMON_IDLE_SEC="600",
    )
    env.pop("NTCARD_DAEMON", None)
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m", "ntcard_tpu.daemon"],
            cwd=str(Path(__file__).resolve().parents[1]),
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            stdin=subprocess.DEVNULL,
        )
    except OSError:
        _DAEMON["sock"] = None
        return None
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.connect(sock)
            s.close()
            _DAEMON.update(sock=sock, proc=proc)
            return sock
        except OSError:
            s.close()
            if proc.poll() is not None:
                break
            time.sleep(0.2)
    _DAEMON["sock"] = None
    return None


def stop_daemon() -> None:
    proc = _DAEMON.pop("proc", None)
    _DAEMON.pop("sock", None)
    if proc is not None and proc.poll() is None:
        proc.terminate()  # exact PID we spawned
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()


def run_case(seed: int, ref_exe: Path, workdir: Path, keep: bool = False) -> str | None:
    """Returns None on parity, else a description of the mismatch."""
    rng = random.Random(seed)
    case = workdir / f"case{seed}"
    case.mkdir(parents=True, exist_ok=True)
    n_files = rng.choice([1, 1, 1, 2, 3])
    paths = [write_input(rng, case / f"in{i}") for i in range(n_files)]
    if n_files > 1 and rng.random() < 0.5:
        lst = case / "files.lst"
        lst.write_text("".join(f"{p}\n" for p in paths))
        file_args = [f"@{lst}"]
    else:
        file_args = [str(p) for p in paths]
    inp = paths[0]
    flags, ks = random_flags(rng)
    compact = rng.random() < 0.3

    def outargs(tag):
        if compact:
            return ["-o", str(case / f"{tag}.tsv")]
        return ["-p", str(case / tag)]

    r1 = subprocess.run(
        [str(ref_exe)] + flags + outargs("ref") + file_args,
        capture_output=True, text=True, timeout=300,
    )
    # rotate engines: single-device, 8-virtual-device (sharded: per-shard
    # quad-family wires, shard_map or chains engine), the native host
    # engine (seed % 3 == 0), and hybrid
    ndev = 1 if seed % 2 else 8
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev}",
    )
    if seed % 3 == 0:
        env["NTCARD_ENGINE"] = "host"
    elif seed % 3 == 2:
        env["NTCARD_ENGINE"] = "hybrid"  # work-stealing split (no-op sharded)
    if seed % 5 == 0:
        env["NTCARD_WIRE"] = "quad2"  # owned-span wire (no-op for sharded/host)
    if seed % 7 < 2:
        env["NTCARD_SUPERBATCH"] = "3"  # scanned stack dispatch
    if seed % 11 < 5:
        env["NTCARD_SHARDED"] = "chains"  # per-device engine (no-op at ndev=1)
    if seed % 4 == 1 and env.get("NTCARD_ENGINE") != "host":
        # daemon rotation arm (VERDICT r4 #7): route through the live
        # warm-pool daemon so its byte parity rests on the same fuzz
        # surface as every other engine. The daemon's own mesh is the
        # 8-device CPU one, so 1-device cases double as shard-invariance
        # checks.
        sock = _daemon_sock(workdir)
        if sock:
            env["NTCARD_DAEMON"] = "1"
            env["NTCARD_DAEMON_SOCK"] = sock
            env["NTCARD_DAEMON_CONNECT_SEC"] = "5"
    r2 = subprocess.run(
        [sys.executable, "-m", "ntcard_tpu.cli"] + flags + outargs("ours") + file_args,
        capture_output=True, text=True, timeout=600, env=env,
        cwd=Path(__file__).resolve().parents[1],
    )
    if r1.returncode != r2.returncode:
        return f"exit codes differ: ref={r1.returncode} ours={r2.returncode} ({flags} {inp.name})"
    if r1.returncode != 0:
        return None  # both rejected the case the same way
    if compact:
        a = (case / "ref.tsv").read_bytes()
        b = (case / "ours.tsv").read_bytes()
        if a != b:
            return f"compact TSV differs ({flags} {inp.name})"
        # per-k F1/F0 stderr lines (reference prints them in compact mode)
        sa = sorted(l for l in r1.stderr.splitlines() if l.startswith("k="))
        sb = sorted(l for l in r2.stderr.splitlines() if l.startswith("k="))
        if sa != sb:
            return f"compact stderr differs ({flags} {inp.name})"
    else:
        for k in ks:
            a = (case / f"ref_k{k}.hist").read_bytes()
            b = (case / f"ours_k{k}.hist").read_bytes()
            if a != b:
                return f"k={k} hist differs ({flags} {inp.name})"
    if not keep:
        shutil.rmtree(case, ignore_errors=True)
    return None


def run_case_nthll(seed: int, ref_exe: Path, workdir: Path) -> str | None:
    """nthll parity: stdout F0 line must match exactly."""
    rng = random.Random(seed)
    case = workdir / f"hll{seed}"
    case.mkdir(parents=True, exist_ok=True)
    inp = write_input(rng, case / "in")
    flags = [f"-k{rng.randrange(4, 129)}"]
    if rng.random() < 0.4:
        flags.append(f"-b{rng.choice([8, 10, 16])}")
    r1 = subprocess.run(
        [str(ref_exe)] + flags + [str(inp)], capture_output=True, text=True, timeout=300
    )
    ndev = 1 if seed % 2 else 8
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev}",
    )
    if seed % 3 == 0:
        env["NTCARD_ENGINE"] = "host"
    elif seed % 3 == 2:
        env["NTCARD_ENGINE"] = "hybrid"
    if seed % 5 == 0:
        env["NTCARD_WIRE"] = "quad2"
    if seed % 11 < 5:
        env["NTCARD_SHARDED"] = "chains"
    if seed % 4 == 1 and env.get("NTCARD_ENGINE") != "host":
        sock = _daemon_sock(workdir)  # daemon arm (see run_case)
        if sock:
            env["NTCARD_DAEMON"] = "1"
            env["NTCARD_DAEMON_SOCK"] = sock
            env["NTCARD_DAEMON_CONNECT_SEC"] = "5"
    r2 = subprocess.run(
        [sys.executable, "-m", "ntcard_tpu.cli_hll"] + flags + [str(inp)],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=Path(__file__).resolve().parents[1],
    )
    if (r1.returncode, r1.stdout) != (r2.returncode, r2.stdout):
        return (
            f"nthll differs ({flags} {inp.name}): "
            f"ref rc={r1.returncode} {r1.stdout!r} vs ours rc={r2.returncode} {r2.stdout!r}"
        )
    shutil.rmtree(case, ignore_errors=True)
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ref", default="/tmp/ntcard_bench/ntcard_ref")
    ap.add_argument("--ref-nthll", default="/tmp/ntcard_bench/nthll_ref")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--nthll", action="store_true", help="fuzz nthll instead of ntcard")
    args = ap.parse_args()
    if args.nthll:
        ref = Path(args.ref_nthll)
        if not build_reference(ref, "nthll.cpp"):
            print("cannot build reference nthll", file=sys.stderr)
            return 2
        runner = run_case_nthll
    else:
        ref = Path(args.ref)
        if not build_reference(ref):
            print("cannot build reference binary", file=sys.stderr)
            return 2
        runner = run_case
    work = Path(tempfile.mkdtemp(prefix="ntcard_fuzz_"))
    bad = 0
    try:
        for i in range(args.seed, args.seed + args.n):
            msg = runner(i, ref, work) if runner is run_case_nthll else run_case(i, ref, work, keep=args.keep)
            status = "ok" if msg is None else f"MISMATCH: {msg}"
            print(f"case {i}: {status}", flush=True)
            bad += msg is not None
    finally:
        stop_daemon()
    if not args.keep:
        shutil.rmtree(work, ignore_errors=True)
    print(f"{args.n - bad}/{args.n} cases match")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
