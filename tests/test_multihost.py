"""Multi-host orchestration: the per-host input partition must be
deterministic, disjoint, and complete for any host count; and a real
2-process jax.distributed run (CPU mesh as the fake cluster, SURVEY.md §4)
must produce the byte-identical histogram to a single-process run."""

import socket
import subprocess
import sys
from pathlib import Path

from ntcard_tpu.parallel.multihost import host_file_assignment

DATA = Path(__file__).parent / "data"
GOLDEN = Path(__file__).parent / "golden"


def test_assignment_partition():
    files = [f"f{i}.fq" for i in range(13)]
    sizes = [(i * 37) % 101 for i in range(13)]
    for n_hosts in (1, 2, 3, 8, 13, 20):
        slices = [host_file_assignment(files, sizes, n_hosts, h) for h in range(n_hosts)]
        flat = [f for s in slices for f in s]
        assert sorted(flat) == sorted(files)  # complete and disjoint
        # deterministic
        again = [host_file_assignment(files, sizes, n_hosts, h) for h in range(n_hosts)]
        assert slices == again


def test_two_process_distributed_run(tmp_path):
    """Launch the REAL CLI as two jax.distributed processes (coordinator on
    localhost, CPU backend): each host decodes its own file slice, the
    tables merge over Gloo between the processes at finalize, and process 0's output
    must byte-match the single-process combined golden
    (tests/golden/both_k12.hist.good)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    out0 = tmp_path / "h0"
    out1 = tmp_path / "h1"
    procs = []
    for pid, pref in ((0, out0), (1, out1)):
        cmd = [
            sys.executable, "-m", "ntcard_tpu.cli",
            "-k12", "-c1000", "-r16",
            "-p", str(pref),
            "--coordinator", f"localhost:{port}",
            "--num-hosts", "2", "--host-id", str(pid),
            str(DATA / "reads.fq"), str(DATA / "contig.fa"),
        ]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    got = (tmp_path / "h0_k12.hist").read_bytes()
    want = (GOLDEN / "both_k12.hist.good").read_bytes()
    assert got == want
    # single-writer contract: only process 0 writes output
    assert not (tmp_path / "h1_k12.hist").exists()


def test_two_process_nthll(tmp_path):
    """nthll across two jax.distributed processes (env-driven launch):
    per-host file slices, registers max-merged across processes, process 0 prints —
    must equal the single-process run over both files."""
    import os

    single = subprocess.run(
        [sys.executable, "-m", "ntcard_tpu.cli_hll", "-k25",
         str(DATA / "reads.fq"), str(DATA / "contig.fa")],
        capture_output=True, timeout=600,
    )
    assert single.returncode == 0, single.stderr.decode()[-2000:]

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in (0, 1):
        env = dict(os.environ,
                   NTCARD_COORDINATOR=f"localhost:{port}",
                   NTCARD_NUM_PROCESSES="2",
                   NTCARD_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ntcard_tpu.cli_hll", "-k25",
             str(DATA / "reads.fq"), str(DATA / "contig.fa")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        ))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    # Gloo may emit rank banners on stdout; the F0 line itself must equal
    # the single-process run's (process 0 prints the merged result)
    f0_lines = [l for l in outs[0][0].splitlines() if l.startswith(b"F0,")]
    assert f0_lines == single.stdout.splitlines()
    assert not any(l.startswith(b"F0,") for l in outs[1][0].splitlines())


def test_assignment_balances_bytes():
    files = [f"f{i}" for i in range(16)]
    sizes = [2 ** (20 - i) for i in range(16)]  # heavily skewed
    parts = [host_file_assignment(files, sizes, 4, h) for h in range(4)]
    loads = [sum(sizes[files.index(f)] for f in p) for p in parts]
    # LPT guarantee: max load within 4/3 of the lower bound
    # max(largest file, total/num_hosts)
    opt_lb = max(max(sizes), sum(sizes) / 4)
    assert max(loads) <= 4 / 3 * opt_lb + 1


def test_two_process_default_r27_smoke(tmp_path):
    """Default-r27 (1.07 GB/k tables) across two jax.distributed processes:
    the device reduce-scatter finalize (parallel/multihost.py) must complete
    in test-env memory — the round-2 host path allgathered P x full tables
    into every process — and byte-match a single-process run over the same
    inputs (merge-invariance at real table scale). k=64 keeps the footprint
    ~1 GB/process; cov 64 keeps the finalize histogram small."""
    import os
    import subprocess
    import sys

    args = ["-k64", "-c64", str(DATA / "reads.fq"), str(DATA / "contig.fa")]
    env1 = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=1")
    single = subprocess.run(
        [sys.executable, "-m", "ntcard_tpu.cli", "-p", str(tmp_path / "s")] + args,
        capture_output=True, timeout=600, env=env1,
    )
    assert single.returncode == 0, single.stderr.decode()[-2000:]

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in (0, 1):
        cmd = [
            sys.executable, "-m", "ntcard_tpu.cli",
            "-p", str(tmp_path / "m"),
            "--coordinator", f"localhost:{port}",
            "--num-hosts", "2", "--host-id", str(pid),
        ] + args
        procs.append(
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env1)
        )
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    got = (tmp_path / "m_k64.hist").read_bytes()
    want = (tmp_path / "s_k64.hist").read_bytes()
    assert got == want
