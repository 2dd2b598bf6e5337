"""Persistent device-runtime daemon (ntcard_tpu/daemon.py): byte-parity of
daemon-routed runs against direct in-process runs, warm reuse, per-job env
scoping, and the client's fallback guards. Runs on the forced 8-device CPU
mesh like everything else; the daemon subprocess inherits that platform."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from ntcard_tpu import cli
from ntcard_tpu.daemon import (
    PROTO,
    TRACE_KNOBS,
    _job_eligible,
    _serve_one,
    maybe_run_via_daemon,
)

REPO = Path(__file__).resolve().parents[1]


def _write_fastq(path: Path, n_reads: int = 200, seed: int = 7) -> None:
    import random

    rng = random.Random(seed)
    with open(path, "w") as f:
        for i in range(n_reads):
            seq = "".join(rng.choice("ACGT") for _ in range(100))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * 100}\n")


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """A live daemon subprocess on a private socket; torn down at module end."""
    sock = str(tmp_path_factory.mktemp("daemon") / "d.sock")
    env = dict(os.environ)
    env["NTCARD_DAEMON_SOCK"] = sock
    env["NTCARD_DAEMON_IDLE_SEC"] = "120"
    # the daemon's compiled artefacts (JAX cache, AOT store) go to a
    # private root that test_daemon_with_aot_forced inspects
    env["JAX_COMPILATION_CACHE_DIR"] = str(Path(sock).parent / "cache")
    env.pop("NTCARD_DAEMON", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ntcard_tpu.daemon"],
        cwd=str(REPO),
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
    )
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.connect(sock)
            s.close()
            break
        except OSError:
            s.close()
            if proc.poll() is not None:
                out, err = proc.communicate()
                raise RuntimeError(f"daemon died: {err.decode()[-500:]}")
            time.sleep(0.2)
    else:
        proc.kill()
        raise RuntimeError("daemon did not come up")
    yield sock
    proc.terminate()
    proc.wait(timeout=10)


def _run_pair(tmp_path, daemon_sock, monkeypatch, argv_of):
    """Run the same job directly and through the daemon; return both output
    file payloads keyed by name."""
    direct_pref = tmp_path / "direct"
    via_pref = tmp_path / "via"
    # direct (daemon routing disabled)
    monkeypatch.setenv("NTCARD_DAEMON", "0")
    assert cli.main(argv_of(direct_pref)) == 0
    # via daemon
    monkeypatch.setenv("NTCARD_DAEMON", "1")
    monkeypatch.setenv("NTCARD_DAEMON_SOCK", daemon_sock)
    monkeypatch.setenv("NTCARD_DAEMON_CONNECT_SEC", "5")
    assert cli.main(argv_of(via_pref)) == 0
    monkeypatch.delenv("NTCARD_DAEMON")
    direct = {
        p.name.replace("direct", "X"): p.read_bytes()
        for p in tmp_path.glob("direct*.hist")
    }
    via = {
        p.name.replace("via", "X"): p.read_bytes() for p in tmp_path.glob("via*.hist")
    }
    assert direct and set(direct) == set(via)
    return direct, via


def test_daemon_byte_parity_and_warm_reuse(daemon, tmp_path, monkeypatch):
    fq = tmp_path / "r.fq"
    _write_fastq(fq)

    def argv(prefix):
        return ["-k24,32", "-r12", "-c40", "-p", str(prefix), str(fq)]

    direct, via = _run_pair(tmp_path, daemon, monkeypatch, argv)
    assert direct == via
    # warm rerun on the SAME daemon (the jit cache is now populated): still
    # byte-identical — program reuse must not perturb results
    warm_pref = tmp_path / "warm"
    monkeypatch.setenv("NTCARD_DAEMON", "1")
    monkeypatch.setenv("NTCARD_DAEMON_SOCK", daemon)
    monkeypatch.setenv("NTCARD_DAEMON_CONNECT_SEC", "5")
    assert cli.main(argv(warm_pref)) == 0
    for name, payload in direct.items():
        assert (tmp_path / name.replace("X", "warm")).read_bytes() == payload


def test_daemon_env_scoped_per_job(daemon, tmp_path, monkeypatch):
    """A job-level NTCARD_* knob (nibble wire) rides the request and does not
    leak into the next job (quad2 default) — both match the direct run."""
    fq = tmp_path / "r.fq"
    _write_fastq(fq, seed=11)
    base = ["-k32", "-r12", "-c30"]
    monkeypatch.setenv("NTCARD_DAEMON", "0")
    assert cli.main(base + ["-p", str(tmp_path / "direct"), str(fq)]) == 0
    golden = (tmp_path / "direct_k32.hist").read_bytes()
    monkeypatch.setenv("NTCARD_DAEMON", "1")
    monkeypatch.setenv("NTCARD_DAEMON_SOCK", daemon)
    monkeypatch.setenv("NTCARD_DAEMON_CONNECT_SEC", "5")
    monkeypatch.setenv("NTCARD_WIRE", "nibble")
    assert cli.main(base + ["-p", str(tmp_path / "nib"), str(fq)]) == 0
    monkeypatch.delenv("NTCARD_WIRE")
    assert cli.main(base + ["-p", str(tmp_path / "post"), str(fq)]) == 0
    assert (tmp_path / "nib_k32.hist").read_bytes() == golden
    assert (tmp_path / "post_k32.hist").read_bytes() == golden


def test_daemon_nthll_routes(daemon, tmp_path, monkeypatch, capsys):
    from ntcard_tpu import cli_hll

    fq = tmp_path / "r.fq"
    _write_fastq(fq, seed=3)
    monkeypatch.setenv("NTCARD_DAEMON", "0")
    assert cli_hll.main(["-k32", str(fq)]) == 0
    direct = capsys.readouterr().out
    monkeypatch.setenv("NTCARD_DAEMON", "1")
    monkeypatch.setenv("NTCARD_DAEMON_SOCK", daemon)
    monkeypatch.setenv("NTCARD_DAEMON_CONNECT_SEC", "5")
    assert cli_hll.main(["-k32", str(fq)]) == 0
    assert capsys.readouterr().out == direct


def test_eligibility_guards(tmp_path, monkeypatch):
    fq = tmp_path / "r.fq"
    _write_fastq(fq, n_reads=5)
    ok = ["-k12", "-p", "x", str(fq)]
    assert _job_eligible("ntcard", ok)
    # usage errors / help / version stay in-process
    assert not _job_eligible("ntcard", ["--help"])
    assert not _job_eligible("ntcard", ["-k12", str(fq)])  # missing -p/-o
    assert not _job_eligible("nthll", ["--help"])
    assert not _job_eligible("nthll", [])
    # FIFOs can only be read by the invoking process
    fifo = tmp_path / "pipe.fq"
    os.mkfifo(fifo)
    assert not _job_eligible("ntcard", ["-k12", "-p", "x", str(fifo)])
    # multi-host jobs own a distributed runtime
    assert not _job_eligible(
        "ntcard", ["-k12", "-p", "x", "--num-hosts", "2", str(fq)]
    )
    monkeypatch.setenv("NTCARD_ENGINE", "host")
    assert not _job_eligible("ntcard", ok)
    monkeypatch.delenv("NTCARD_ENGINE")
    # missing input: let the in-process run print the real error
    assert not _job_eligible("ntcard", ["-k12", "-p", "x", str(tmp_path / "no.fq")])


def test_client_disabled_and_no_daemon(tmp_path, monkeypatch):
    # NTCARD_DAEMON=0: pure no-op (not even a socket probe is observable)
    monkeypatch.setenv("NTCARD_DAEMON", "0")
    assert maybe_run_via_daemon("ntcard", ["-k12", "-p", "x", "f.fq"]) is None
    # enabled but no daemon up: returns None (in-process) after spawning;
    # point the spawn at a sock dir we control and a no-op spawner
    fq = tmp_path / "r.fq"
    _write_fastq(fq, n_reads=5)
    monkeypatch.setenv("NTCARD_DAEMON", "1")
    monkeypatch.setenv("NTCARD_DAEMON_SOCK", str(tmp_path / "none.sock"))
    monkeypatch.setenv("NTCARD_DAEMON_CONNECT_SEC", "0.1")
    spawned = []
    monkeypatch.setattr("ntcard_tpu.daemon._spawn_daemon", lambda p: spawned.append(p))
    assert maybe_run_via_daemon("ntcard", ["-k12", "-p", "x", str(fq)]) is None
    assert spawned == [str(tmp_path / "none.sock")]
    # UNSET (the product default): a live daemon would be used, but none is
    # ever spawned — and an ineligible job must not trigger a spawn even
    # when opted in
    spawned.clear()
    monkeypatch.delenv("NTCARD_DAEMON")
    assert maybe_run_via_daemon("ntcard", ["-k12", "-p", "x", str(fq)]) is None
    assert spawned == []
    monkeypatch.setenv("NTCARD_DAEMON", "1")
    assert maybe_run_via_daemon("ntcard", ["--help"]) is None
    assert spawned == []


def test_server_protocol_errors():
    """_serve_one answers malformed and version-skewed requests with the
    protocol exit codes and never crashes the accept loop."""
    for payload, want in [
        (b"not json\n", 70),
        (json.dumps({"proto": PROTO + 1, "argv": ["ntcard"]}).encode() + b"\n", 71),
        (json.dumps({"proto": PROTO, "argv": "nope"}).encode() + b"\n", 70),
    ]:
        a, b = socket.socketpair()
        try:
            a.sendall(payload)
            a.shutdown(socket.SHUT_WR)
            _serve_one(b)
            f = a.makefile()
            hello = json.loads(f.readline())  # protocol-2 accept greeting
            assert hello.get("ready") == 1 and hello.get("busy") == 0
            resp = json.loads(f.readline())
            assert resp["exit"] == want
        finally:
            a.close()
            b.close()


def test_control_ops_and_prewarm(tmp_path, monkeypatch):
    """--status/--stop control requests, and NTCARD_DAEMON_WARM running a
    synthetic job at boot (program shapes depend on flags, not input size,
    so the warm job loads exactly what a real job of those flags needs)."""
    from ntcard_tpu.daemon import _control

    sock = str(tmp_path / "c.sock")
    env = dict(os.environ)
    env["NTCARD_DAEMON_SOCK"] = sock
    env["NTCARD_DAEMON_IDLE_SEC"] = "120"
    env["NTCARD_DAEMON_WARM"] = "-k12 -r10 -c20"
    env.pop("NTCARD_DAEMON", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "ntcard_tpu.daemon"],
        cwd=str(REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    try:
        monkeypatch.setenv("NTCARD_DAEMON_SOCK", sock)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                s.connect(sock)
                s.close()
                break
            except OSError:
                s.close()
                assert proc.poll() is None, proc.communicate()[1].decode()[-500:]
                time.sleep(0.2)
        # ping queues behind the boot-time prewarm; a reply proves both ran
        assert _control("ping") == 0
        assert _control("stop") == 0
        out, err = proc.communicate(timeout=30)
        assert proc.returncode == 0
        assert "prewarmed '-k12 -r10 -c20'" in err.decode()
    finally:
        if proc.poll() is None:
            proc.kill()


def test_control_no_daemon(tmp_path, monkeypatch, capsys):
    from ntcard_tpu.daemon import _control

    monkeypatch.setenv("NTCARD_DAEMON_SOCK", str(tmp_path / "gone.sock"))
    assert _control("ping") == 1


def test_client_bounded_wait_on_wedged_daemon(tmp_path, monkeypatch):
    """A daemon wedged in backend boot (or busy) accepts connections into
    the backlog but never greets; the client must give up after
    NTCARD_DAEMON_READY_SEC and run in-process instead of hanging."""
    import threading

    sock = str(tmp_path / "wedge.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock)
    srv.listen(4)  # accepts queue in the backlog; nobody ever greets
    fq = tmp_path / "r.fq"
    _write_fastq(fq, n_reads=5)
    monkeypatch.setenv("NTCARD_DAEMON", "1")
    monkeypatch.setenv("NTCARD_DAEMON_SOCK", sock)
    monkeypatch.setenv("NTCARD_DAEMON_CONNECT_SEC", "1")
    monkeypatch.setenv("NTCARD_DAEMON_READY_SEC", "0.5")
    try:
        t0 = time.monotonic()
        rc = maybe_run_via_daemon("ntcard", ["-k12", "-p", "x", str(fq)])
        took = time.monotonic() - t0
        assert rc is None  # fell back to the in-process path
        assert took < 5.0  # bounded by the ready timeout, not a hang
    finally:
        srv.close()


def _daemon_jobs(sock: str) -> int:
    """Job counter from the daemon's --status ping output."""
    import re

    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(10)
    s.connect(sock)
    f = s.makefile("rb")
    assert json.loads(f.readline())["ready"] == 1
    s.sendall(json.dumps({"proto": PROTO, "op": "ping"}).encode() + b"\n")
    resp = json.loads(f.readline())
    s.close()
    m = re.search(r"jobs (\d+)", resp["out"])
    assert m, resp
    return int(m.group(1))


def test_noenv_probe_uses_live_daemon(daemon, tmp_path, monkeypatch):
    """The PRODUCT DEFAULT (no NTCARD_DAEMON env at all) must route through
    an already-serving daemon — verified via the daemon's own job
    counter."""
    fq = tmp_path / "r.fq"
    _write_fastq(fq, seed=21)
    monkeypatch.delenv("NTCARD_DAEMON", raising=False)
    monkeypatch.setenv("NTCARD_DAEMON_SOCK", daemon)
    monkeypatch.setenv("NTCARD_DAEMON_CONNECT_SEC", "5")
    before = _daemon_jobs(daemon)
    assert cli.main(["-k16", "-r10", "-c20", "-p", str(tmp_path / "ne"), str(fq)]) == 0
    assert _daemon_jobs(daemon) == before + 1
    assert (tmp_path / "ne_k16.hist").exists()
    # NTCARD_DAEMON=0 with the same live daemon: stays in-process
    monkeypatch.setenv("NTCARD_DAEMON", "0")
    assert cli.main(["-k16", "-r10", "-c20", "-p", str(tmp_path / "off"), str(fq)]) == 0
    assert _daemon_jobs(daemon) == before + 1


def test_busy_greeting_and_fallback(monkeypatch, tmp_path):
    """A busy daemon greets busy=1 instantly; the default client falls back
    silently and immediately, a queue-mode client proceeds."""
    import threading

    from ntcard_tpu import daemon as dmod

    # server side: greeting carries busy=1 while the job lock is held
    a, b = socket.socketpair()
    try:
        with dmod._job_lock:
            t = threading.Thread(target=dmod._serve_one, args=(b,), daemon=True)
            t.start()
            hello = json.loads(a.makefile("rb").readline())
            assert hello == {"ready": 1, "busy": 1}
            a.close()
        t.join(5)
    finally:
        b.close()

    # client side against a fake always-busy server
    sock = str(tmp_path / "busy.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock)
    srv.listen(4)
    got_request = []

    def fake_server():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            conn.sendall(b'{"ready": 1, "busy": 1}\n')
            try:
                conn.settimeout(2)
                line = conn.makefile("rb").readline()
                if line:
                    got_request.append(line)
                    conn.sendall(b'{"exit": 0, "out": "", "err": ""}\n')
            except OSError:
                pass
            conn.close()

    t = threading.Thread(target=fake_server, daemon=True)
    t.start()
    fq = tmp_path / "r.fq"
    _write_fastq(fq, n_reads=5)
    monkeypatch.setenv("NTCARD_DAEMON", "1")
    monkeypatch.setenv("NTCARD_DAEMON_SOCK", sock)
    monkeypatch.delenv("NTCARD_DAEMON_BUSY", raising=False)
    argv = ["-k12", "-p", "x", str(fq)]
    t0 = time.monotonic()
    import io as io_mod
    import sys as sys_mod

    err_cap = io_mod.StringIO()
    real_err = sys_mod.stderr
    sys_mod.stderr = err_cap
    try:
        rc = maybe_run_via_daemon("ntcard", argv)
    finally:
        sys_mod.stderr = real_err
    assert rc is None  # immediate in-process fallback
    assert time.monotonic() - t0 < 2.0  # no READY_SEC stall
    assert err_cap.getvalue() == ""  # neutral: no scary message
    assert got_request == []  # never sent the job
    # queue mode: the request goes through despite busy=1
    monkeypatch.setenv("NTCARD_DAEMON_BUSY", "queue")
    assert maybe_run_via_daemon("ntcard", argv) == 0
    assert len(got_request) == 1
    srv.close()


def test_output_destinations_not_routed(tmp_path, monkeypatch):
    """Non-regular output destinations fall back in-process: the daemon's
    fd 1 is its log file, and a /dev/fd process substitution does not exist
    in the daemon's process at all."""
    fq = tmp_path / "r.fq"
    _write_fastq(fq, n_reads=5)
    assert _job_eligible("ntcard", ["-k12", "-p", str(tmp_path / "ok"), str(fq)])
    assert not _job_eligible("ntcard", ["-k12", "-o", "/dev/stdout", str(fq)])
    assert not _job_eligible("ntcard", ["-k12", "-o", "/dev/fd/63", str(fq)])
    assert not _job_eligible("ntcard", ["-k12", "-p", "/dev/fd/63", str(fq)])
    # an existing FIFO as the concrete output target
    fifo = tmp_path / "out.tsv"
    os.mkfifo(fifo)
    assert not _job_eligible("ntcard", ["-k12", "-o", str(fifo), str(fq)])
    fifo2 = tmp_path / "pref_k12.hist"
    os.mkfifo(fifo2)
    assert not _job_eligible(
        "ntcard", ["-k12", "-p", str(tmp_path / "pref"), str(fq)]
    )
    # --save-sketch to a device path
    assert not _job_eligible(
        "ntcard", ["-k12", "-p", str(tmp_path / "ok2"), "--save-sketch",
                   "/dev/null", str(fq)]
    )


def test_env_knob_robustness(monkeypatch):
    """Malformed / degenerate numeric knobs degrade to defaults instead of
    crashing the server loop or the client."""
    from ntcard_tpu.daemon import _env_float

    monkeypatch.setenv("NTCARD_DAEMON_IDLE_SEC", "0")
    assert _env_float("NTCARD_DAEMON_IDLE_SEC", 900.0, lo=1.0) == 1.0
    monkeypatch.setenv("NTCARD_DAEMON_IDLE_SEC", "bogus")
    assert _env_float("NTCARD_DAEMON_IDLE_SEC", 900.0, lo=1.0) == 900.0
    monkeypatch.delenv("NTCARD_DAEMON_IDLE_SEC")
    assert _env_float("NTCARD_DAEMON_IDLE_SEC", 900.0, lo=1.0) == 900.0


def test_read_timeout_does_not_wedge_server(monkeypatch):
    """A client that connects and never sends a complete request line gets
    a bad-request reply after the read timeout instead of wedging the
    connection thread (ADVICE r4: accepted sockets are blocking)."""
    import threading

    from ntcard_tpu import daemon as dmod

    monkeypatch.setenv("NTCARD_DAEMON_REQUEST_SEC", "0.5")
    a, b = socket.socketpair()
    done = []

    def run():
        dmod._serve_one(b)
        done.append(True)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    f = a.makefile("rb")
    hello = json.loads(f.readline())
    assert hello["ready"] == 1
    a.sendall(b'{"proto": 2')  # incomplete line, then silence
    t.join(10)
    assert done, "server thread wedged on a silent client"
    resp = json.loads(f.readline())
    assert resp["exit"] == 70
    a.close()
    b.close()


def test_daemon_with_aot_forced(daemon, tmp_path, monkeypatch):
    """The combined production stack — daemon routing + the AOT executable
    cache (forced on CPU) — must stay byte-identical to a plain direct run.
    NTCARD_AOT rides the request env, so the DAEMON process serves the job
    through aot_jit entries, stored under its own cache root."""
    fq = tmp_path / "r.fq"
    _write_fastq(fq, seed=31)
    # --devices 1: the 8-virtual-device test mesh routes to the sharded
    # engines, which don't run the aot-wrapped single-device programs
    argv = ["-k20,28", "-r11", "-c25", "--devices", "1"]
    monkeypatch.setenv("NTCARD_DAEMON", "0")
    assert cli.main(argv + ["-p", str(tmp_path / "direct"), str(fq)]) == 0
    golden = (tmp_path / "direct_k20.hist").read_bytes()
    monkeypatch.setenv("NTCARD_DAEMON", "1")
    monkeypatch.setenv("NTCARD_DAEMON_SOCK", daemon)
    monkeypatch.setenv("NTCARD_DAEMON_CONNECT_SEC", "5")
    monkeypatch.setenv("NTCARD_AOT", "1")
    for tag in ("a1", "a2"):  # second pass: daemon-side AOT entries warm
        assert cli.main(argv + ["-p", str(tmp_path / tag), str(fq)]) == 0
        assert (tmp_path / f"{tag}_k20.hist").read_bytes() == golden
    aot_dir = Path(daemon).parent / "cache" / "ntcard_aot"
    assert aot_dir.exists()  # the daemon actually wrote entries


def test_idle_expiry_and_threaded_stop(tmp_path, monkeypatch):
    """The threaded accept loop must idle-expire from the last connection
    CLOSE (not wedge forever at a sub-second timeout, the old non-blocking
    BlockingIOError crash class), and a connection mid-count must hold
    expiry open."""
    import threading

    from ntcard_tpu import daemon as dmod

    sock = str(tmp_path / "idle.sock")
    rc = []
    t = threading.Thread(
        target=lambda: rc.append(dmod.serve(sock, idle_sec=2.0)), daemon=True
    )
    t.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not os.path.exists(sock):
        time.sleep(0.1)
    assert os.path.exists(sock), "daemon never bound"
    # a ping resets the idle clock and is served from a conn thread
    monkeypatch.setenv("NTCARD_DAEMON_SOCK", sock)
    from ntcard_tpu.daemon import _control

    assert _control("ping") == 0
    t.join(timeout=30)  # idle expiry fires ~2 s after the ping closes
    assert not t.is_alive(), "serve did not idle-expire"
    assert rc == [0]
    assert not os.path.exists(sock)  # socket unlinked on exit


def test_trace_time_knobs_not_routed(tmp_path, monkeypatch):
    """Jobs forcing trace-time kernel knobs run in-process: inside a
    long-lived daemon they could execute programs traced under different
    knob values (jit cache keys carry shapes only)."""
    fq = tmp_path / "r.fq"
    _write_fastq(fq, n_reads=5)
    ok = ["-k12", "-p", "x", str(fq)]
    assert _job_eligible("ntcard", ok)
    for knob in TRACE_KNOBS:
        monkeypatch.setenv(knob, "anything")
        assert not _job_eligible("ntcard", ok), knob
        monkeypatch.delenv(knob)


def _fake_daemon(sock: str, greeting: bytes | None, requests: list):
    """A unix-socket server that greets with ``greeting`` (or never, when
    None) and answers every request line with exit 0; records requests."""
    import threading

    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock)
    srv.listen(4)

    def loop():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            if greeting is None:
                continue  # accepted, never greeted: a daemon still booting
            try:
                conn.sendall(greeting)
                conn.settimeout(5)
                line = conn.makefile("rb").readline()
                if line:
                    requests.append(line)
                    conn.sendall(b'{"exit": 0, "out": "", "err": ""}\n')
            except OSError:
                pass
            conn.close()

    threading.Thread(target=loop, daemon=True).start()
    return srv


@pytest.fixture
def gpu_host(monkeypatch, tmp_path):
    """Client side of a GPU host: the daemon owns the card while it lives."""
    from ntcard_tpu import daemon as dmod

    monkeypatch.setattr(dmod, "accelerator_requested", lambda: True)
    monkeypatch.delenv("NTCARD_DAEMON_BUSY", raising=False)
    monkeypatch.delenv("NTCARD_DAEMON", raising=False)  # the product default
    sock = str(tmp_path / "g.sock")
    monkeypatch.setenv("NTCARD_DAEMON_SOCK", sock)
    fq = tmp_path / "r.fq"
    _write_fastq(fq, n_reads=5)
    return sock, ["-k12", "-p", str(tmp_path / "x"), str(fq)]


def test_gpu_host_busy_daemon_queues(gpu_host, monkeypatch):
    """On a GPU host a busy daemon is queued behind, never bypassed: an
    in-process run would open the card a second time."""
    sock, argv = gpu_host
    got = []
    srv = _fake_daemon(sock, b'{"ready": 1, "busy": 1}\n', got)
    try:
        assert maybe_run_via_daemon("ntcard", argv) == 0
        assert len(got) == 1
    finally:
        srv.close()


def test_gpu_host_silent_daemon_refuses(gpu_host, monkeypatch, capsys):
    """A live daemon that never greets (still booting) makes the client
    wait up to NTCARD_DAEMON_READY_SEC and then fail — not run in-process."""
    sock, argv = gpu_host
    with open(sock + ".lock", "w") as fh:
        fh.write(str(os.getpid()))  # a live owner
    srv = _fake_daemon(sock, None, [])
    try:
        monkeypatch.setenv("NTCARD_DAEMON_READY_SEC", "0.3")
        assert maybe_run_via_daemon("ntcard", argv) == 1
        assert "holds the GPU" in capsys.readouterr().err
    finally:
        srv.close()


def test_gpu_host_unroutable_job_refused(gpu_host, tmp_path, capsys):
    """A job that cannot move into the daemon (a FIFO input) is refused
    while a daemon serves; jax-free jobs (usage errors) still run
    in-process."""
    sock, argv = gpu_host
    srv = _fake_daemon(sock, b'{"ready": 1, "busy": 0}\n', [])
    try:
        fifo = tmp_path / "pipe.fq"
        os.mkfifo(fifo)
        assert maybe_run_via_daemon("ntcard", ["-k12", "-p", "x", str(fifo)]) == 1
        assert "holds the GPU" in capsys.readouterr().err
        assert maybe_run_via_daemon("ntcard", ["--help"]) is None
    finally:
        srv.close()


def test_gpu_host_spawn_routes_first_job(gpu_host, monkeypatch):
    """Spawn-on-first-use on a GPU host: the first job waits for the new
    daemon and goes through it instead of running in-process beside it."""
    sock, argv = gpu_host
    got = []
    servers = []

    def spawn(path):
        with open(path + ".lock", "w") as fh:
            fh.write(str(os.getpid()))
        servers.append(_fake_daemon(path, b'{"ready": 1, "busy": 0}\n', got))

    monkeypatch.setattr("ntcard_tpu.daemon._spawn_daemon", spawn)
    monkeypatch.setenv("NTCARD_DAEMON", "1")
    try:
        assert maybe_run_via_daemon("ntcard", argv) == 0
        assert len(servers) == 1 and len(got) == 1
    finally:
        for srv in servers:
            srv.close()


def test_gpu_host_no_daemon_runs_in_process(gpu_host, monkeypatch):
    """With no daemon at all (probe-only default), nothing holds the card:
    the job runs in-process."""
    _sock, argv = gpu_host
    assert maybe_run_via_daemon("ntcard", argv) is None
