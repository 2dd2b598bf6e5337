"""Persistent device-runtime server ("warm pool") for the ntcard/nthll CLIs.

Why this exists: a cold device CLI pays a serial startup chain before the
first byte of real work — the jax import (seconds of pure Python), the
backend start, and the compile (or AOT load) of every jitted program.
Genomics pipelines invoke ntcard once per sample, dozens to thousands of
times; paying the device bootstrap per invocation is pure waste. The
daemon holds ONE live backend client + the in-process jit program cache
across invocations, so repeat runs pay only decode + H2D transfer +
dispatch + finalize.

It is also how several invocations share one GPU: a JAX process reserves
most of the card's memory when it starts, so a second process on the same
card fails for want of memory. On a GPU host (accel.accelerator_requested)
a client never opens the card while a daemon lives: it queues behind a
busy daemon, waits for one still booting, and after spawning one on first
use routes its own job through it.

This is the standard accelerator-serving pattern (persistent workers /
model servers), not a benchmark device: results are byte-identical to cold
runs because every job builds a fresh sketch over the same programs (the
test suite drives ``cli.main`` repeatedly in one process already —
tests/test_e2e_golden.py — which is exactly what the daemon does).

The reference has no analog — its engine is a cold OpenMP binary
(ntcard.cpp:317-478).

Protocol (version 2, newline-delimited JSON over a unix socket):
  server -> client   {"ready": 1, "busy": 0|1}         (greeting on accept)
  client -> server   {"proto": 2, "argv": ["ntcard", ...], "cwd": str,
                      "env": {NTCARD_* vars of the client}}
  server -> client   {"exit": int, "out": str, "err": str}
Output FILES are written by the daemon process directly (same machine,
same cwd); stdout/stderr text is captured and relayed.

Concurrency semantics: connections are accepted on threads (so the
greeting is immediate even mid-job) but JOBS run strictly one at a time
under a lock — device state, cwd and stdio are process-global. The
greeting carries a ``busy`` flag. Off the GPU a client that sees busy=1
falls back to an in-process run immediately and silently, and one whose
daemon has not greeted within NTCARD_DAEMON_READY_SEC (10) does the same;
``NTCARD_DAEMON_BUSY=queue`` opts into queueing instead. On a GPU host
queueing is the behaviour, the greeting wait defaults to 600 s, and a
daemon that never greets ends the client with an error instead of an
in-process run. Once a request is SENT there is deliberately no reply
timeout — the daemon will run that job, so abandoning it would
double-write.

Default-path routing: with NTCARD_DAEMON unset the CLIs probe the socket
and use an ALREADY-RUNNING daemon (a live warm runtime is free to use and
byte-identical); they never spawn one implicitly. NTCARD_DAEMON=1 adds
spawn-on-first-use; NTCARD_DAEMON=0 disables even the probe.

Caveat: NTCARD_* knobs read at TRACE time (TRACE_KNOBS) are baked into
jit programs keyed only on shapes — across daemon jobs of identical shapes
the FIRST job's values would win silently, so jobs setting one run
in-process (off the GPU) or are refused (on a GPU host, where a daemon
holds the card).

Knobs:
  NTCARD_DAEMON=1            CLIs route eligible jobs through the daemon,
                             spawning it on first use (off the GPU that
                             first job runs in-process while the daemon
                             boots; on a GPU host it waits and routes)
  NTCARD_DAEMON=0            never probe or use a daemon
  (unset)                    use a live daemon if one is serving; never spawn
  NTCARD_DAEMON_SOCK=path    socket path [$XDG_RUNTIME_DIR or $TMPDIR]
  NTCARD_DAEMON_IDLE_SEC=n   server exits after n idle seconds [900]
  NTCARD_DAEMON_CONNECT_SEC  client connect timeout [0.5]
  NTCARD_DAEMON_READY_SEC    client wait for the greeting [10; GPU: 600]
  NTCARD_DAEMON_BUSY=queue   queue behind a busy daemon instead of falling
                             back in-process [fallback; GPU: always queue]
  NTCARD_DAEMON_REQUEST_SEC  server-side greeting->request read timeout
                             (a silent client is a bad request) [10]

Not routed: --help/--version/bad usage and jobs forced onto the jax-free
host engine (these never open the card, so they run in-process anywhere);
multi-host jobs (they own a distributed runtime), non-regular-file inputs
OR outputs (a FIFO or /dev/fd process substitution is only readable /
writable inside the invoking process; `-o /dev/stdout` must reach the
CLIENT's stdout, not the daemon's), and jobs setting a trace-time knob —
these run in-process off the GPU, and on a GPU host whose daemon holds the
card they exit with an error instead of opening it a second time.
"""

from __future__ import annotations

import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback

from ntcard_tpu.accel import accelerator_requested

PROTO = 2

# NTCARD_* knobs read while TRACING (baked into jit programs keyed only on
# shapes); utils/aot folds the same list into its fast keys
TRACE_KNOBS = ("NTCARD_KERNEL",)

# exit codes the server uses for protocol-level failures (EX_SOFTWARE /
# EX_PROTOCOL flavors; never returned for a job that actually ran)
_EXIT_BAD_REQUEST = 70
_EXIT_PROTO_MISMATCH = 71


def _env_float(name: str, default: float, lo: float | None = None) -> float:
    """Parse a numeric env knob, degrading to the default on malformed
    values and clamping to a positive floor where one is given (an idle
    timeout of 0 would make the listener non-blocking and crash the serve
    loop with BlockingIOError instead of idle-exiting)."""
    raw = os.environ.get(name)
    try:
        v = float(raw) if raw is not None else float(default)
    except ValueError:
        v = float(default)
    if lo is not None:
        v = max(v, lo)
    return v


def default_sock_path() -> str:
    p = os.environ.get("NTCARD_DAEMON_SOCK")
    if p:
        return p
    import tempfile

    base = os.environ.get("XDG_RUNTIME_DIR") or tempfile.gettempdir()
    return os.path.join(base, f"ntcard-daemon-{os.getuid()}.sock")


def _recv_line(conn: socket.socket) -> bytes:
    buf = bytearray()
    while b"\n" not in buf:
        chunk = conn.recv(1 << 16)
        if not chunk:
            break
        buf += chunk
    line, _, _ = bytes(buf).partition(b"\n")
    return line


# ---------------------------------------------------------------- server

_job_lock = threading.Lock()


def _run_job(argv: list, cwd: str, env: dict) -> tuple:
    """Run one CLI job in-process: swap cwd + NTCARD_* env + stdio, call the
    CLI main, restore everything. Returns (rc, stdout_text, stderr_text).

    The env swap is scoped to NTCARD_* keys: run-time knobs (engine
    selection, wire format, replay lag) take per-job effect; TRACE-time
    knobs are frozen per program fingerprint — see the module docstring
    caveat. Platform-level vars (JAX_PLATFORMS, XLA_FLAGS) are
    intentionally NOT swapped — the backend client is already initialized
    and they could not take effect anyway.

    Every step here — including the cwd/env swap itself (a client can
    legitimately send a since-deleted cwd) — is exception-guarded: one bad
    request must never unwind the accept loop and throw away the warm
    state the daemon exists to keep."""
    try:
        old_cwd = os.getcwd()
    except OSError:
        old_cwd = "/"  # daemon's own start dir was deleted; anchor somewhere
    touched = set(env) | {k for k in os.environ if k.startswith("NTCARD_")}
    touched |= {"NTCARD_DAEMON", "NTCARD_FAST_EXIT", "NTCARD_IN_DAEMON"}
    saved = {k: os.environ.get(k) for k in touched}
    out_buf, err_buf = io.StringIO(), io.StringIO()
    old_out, old_err = sys.stdout, sys.stderr
    rc = 1
    try:
        os.chdir(cwd)
        for k in touched:
            os.environ.pop(k, None)
        os.environ.update(env)
        # never recurse (a probe of our own socket would greet busy — or
        # deadlock in queue mode), never race the parent's exit shortcut
        os.environ["NTCARD_DAEMON"] = "0"
        os.environ.pop("NTCARD_FAST_EXIT", None)
        # in-daemon marker: the backend client is live and programs are
        # cached, so cli._use_host_engine's auto cost model must charge the
        # device path its WARM floor (cli.DEVICE_WARM_FLOOR_SEC)
        os.environ["NTCARD_IN_DAEMON"] = "1"
        sys.stdout, sys.stderr = out_buf, err_buf
        prog = argv[0] if argv else "ntcard"
        try:
            if prog == "nthll":
                from ntcard_tpu import cli_hll

                rc = cli_hll.main(argv[1:])
            else:
                from ntcard_tpu import cli

                rc = cli.main(argv[1:])
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    except BaseException:
        traceback.print_exc(file=err_buf)
        rc = 1
    finally:
        sys.stdout, sys.stderr = old_out, old_err
        try:
            os.chdir(old_cwd)
        except OSError:
            pass
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rc, out_buf.getvalue(), err_buf.getvalue()


def _serve_one(conn: socket.socket, stats: dict | None = None) -> bool:
    """Handle one connection. Returns False when a stop request asks the
    accept loop to shut down."""
    keep_going = True
    # bound the protocol exchange: greeting -> request is milliseconds for a
    # real client, and an accepted socket is BLOCKING regardless of the
    # listener's timeout — without this, a client that connects and never
    # sends a complete line would wedge this connection thread forever
    try:
        conn.settimeout(_env_float("NTCARD_DAEMON_REQUEST_SEC", 10.0, lo=0.1))
    except OSError:
        return True
    busy = 1 if _job_lock.locked() else 0
    try:
        # greeting: tells the client a live daemon actually ACCEPTED it
        # (connects land in the backlog only during backend boot now that
        # accepts are threaded; the client waits NTCARD_DAEMON_READY_SEC).
        # busy=1 lets the client fall back instantly instead of queueing.
        conn.sendall(json.dumps({"ready": 1, "busy": busy}).encode() + b"\n")
    except OSError:
        return True  # client gave up waiting; nothing else to do
    try:
        req = json.loads(_recv_line(conn) or b"{}")
    except (OSError, ValueError):
        req = None  # incl. the read timeout: treat as a bad request
    if not isinstance(req, dict):
        reply = {"exit": _EXIT_BAD_REQUEST, "out": "", "err": "ntcardd: bad request\n"}
    elif req.get("proto") != PROTO:
        reply = {"exit": _EXIT_PROTO_MISMATCH, "out": "", "err": ""}
    elif req.get("op") == "ping":
        s = dict(stats or {})
        reply = {
            "exit": 0,
            "out": f"ntcardd: pid {os.getpid()}, jobs {s.get('jobs', 0)}, "
            f"up {s.get('uptime', 0.0):.0f}s\n",
            "err": "",
        }
    elif req.get("op") == "stop":
        reply = {"exit": 0, "out": f"ntcardd: pid {os.getpid()} stopping\n", "err": ""}
        keep_going = False
    elif not isinstance(req.get("argv"), list):
        reply = {"exit": _EXIT_BAD_REQUEST, "out": "", "err": "ntcardd: bad request\n"}
    else:
        with _job_lock:
            rc, out, err = _run_job(
                req["argv"], req.get("cwd") or os.getcwd(), req.get("env") or {}
            )
        if stats is not None:
            stats["jobs"] = stats.get("jobs", 0) + 1
        reply = {"exit": rc, "out": out, "err": err}
    try:
        conn.sendall(json.dumps(reply).encode() + b"\n")
    except OSError:
        pass  # client went away; the job's file outputs are on disk regardless
    return keep_going


def _prewarm() -> None:
    """NTCARD_DAEMON_WARM="<ntcard flags>" (e.g. "-k64,96,128"): run one
    throwaway job on a tiny synthetic input at boot so even the FIRST
    routed job of that flag shape finds its executables loaded. Wire
    batches are fixed-geometry ([batch_rows, stride], padded —
    io/packing.py), so program shapes depend on the FLAGS, not the input
    size: a 200-read synthetic warms exactly the programs a 90 Mbp job of
    the same flags will run. Best-effort; failures only cost the warmth."""
    import shlex
    import tempfile

    spec = os.environ.get("NTCARD_DAEMON_WARM")
    if not spec:
        return
    try:
        with tempfile.TemporaryDirectory(prefix="ntcardd-warm-") as tmp:
            fq = os.path.join(tmp, "warm.fq")
            # deterministic 200 x 150 bp of all four bases (content is
            # irrelevant — only shapes and code paths matter)
            with open(fq, "w") as f:
                seq = ("ACGT" * 38)[:150]
                for i in range(200):
                    f.write(f"@w{i}\n{seq}\n+\n{'I' * 150}\n")
            argv = ["ntcard"] + shlex.split(spec) + ["-p", os.path.join(tmp, "w"), fq]
            env = {"NTCARD_ENGINE": "device"}
            rc, _, err = _run_job(argv, tmp, env)
            if rc != 0:
                sys.stderr.write(f"ntcardd: prewarm failed (rc {rc}): {err[-300:]}\n")
            else:
                sys.stderr.write(f"ntcardd: prewarmed '{spec}'\n")
    except OSError as e:
        sys.stderr.write(f"ntcardd: prewarm skipped: {e}\n")


def serve(sock_path: str | None = None, idle_sec: float | None = None) -> int:
    """Bind the socket and serve jobs until idle expiry. Single-instance per
    socket path via an flock'd sidecar lockfile (released by the kernel on
    process death, so a crashed daemon never wedges the path — the stale
    socket file is unlinked by the next winner)."""
    import fcntl

    sock_path = sock_path or default_sock_path()
    idle = (
        max(float(idle_sec), 1.0)
        if idle_sec is not None
        else _env_float("NTCARD_DAEMON_IDLE_SEC", 900.0, lo=1.0)
    )
    lock_file = open(sock_path + ".lock", "a+")
    try:
        fcntl.flock(lock_file, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        lock_file.close()
        return 0  # a live daemon owns this socket path
    # the owner's pid, for clients deciding whether a daemon lives
    # (_daemon_alive) while it boots and before it greets
    lock_file.truncate(0)
    lock_file.write(str(os.getpid()))
    lock_file.flush()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        os.unlink(sock_path)  # stale file from a dead daemon (we hold the lock)
    except OSError:
        pass
    srv.bind(sock_path)
    os.chmod(sock_path, 0o600)
    # listen BEFORE booting the backend: clients that connect during the
    # boot queue in the backlog instead of spawning duplicate daemons
    srv.listen(8)
    try:
        from ntcard_tpu._jax_config import check_backend

        check_backend()  # pays the backend start once, here, not in job 1
    except (Exception, SystemExit) as e:
        # no backend: a daemon would add IPC around pure host runs for
        # nothing, and every routed job would fail identically
        sys.stderr.write(f"ntcardd: backend init failed, exiting: {e}\n")
        try:
            os.unlink(sock_path)
        except OSError:
            pass
        return 1
    # SIGTERM (the polite stop a supervisor sends): unlink the socket file
    # and exit IMMEDIATELY via os._exit — raising SystemExit through the
    # accept loop lets Python tear down the PJRT runtime's C++ threads,
    # which aborts with "FATAL: exception not rethrown" (observed). Stale
    # socket files are harmless to clients but untidy; best-effort (the
    # handler install fails on non-main threads, e.g. tests).
    import signal

    def _on_term(*_):
        try:
            os.unlink(sock_path)
        except OSError:
            pass
        os._exit(0)

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass
    _prewarm()
    sys.stderr.write(f"ntcardd: serving on {sock_path}\n")
    stats = {"jobs": 0, "t0": time.monotonic()}
    # threaded accepts, serialized jobs: the greeting (with its busy flag)
    # goes out the moment a client connects even while a job is running —
    # the actual work still runs one at a time under _job_lock (device
    # state, cwd and stdio are process-global). Idle expiry counts from the
    # last connection CLOSE (a running job never expires under itself).
    stop_evt = threading.Event()
    state = {"last": time.monotonic(), "active": 0}
    state_lock = threading.Lock()

    def _conn_thread(conn: socket.socket) -> None:
        try:
            with conn:
                if not _serve_one(conn, stats):
                    stop_evt.set()
        finally:
            with state_lock:
                state["active"] -= 1
                state["last"] = time.monotonic()

    srv.settimeout(1.0)
    try:
        while not stop_evt.is_set():
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                with state_lock:
                    expired = (
                        state["active"] == 0
                        and time.monotonic() - state["last"] > idle
                    )
                if expired:
                    return 0  # idle expiry
                continue
            with state_lock:
                state["active"] += 1
                state["last"] = time.monotonic()
            stats["uptime"] = time.monotonic() - stats["t0"]
            threading.Thread(
                target=_conn_thread, args=(conn,), daemon=True,
                name="ntcardd-conn",
            ).start()
        # stop requested: let in-flight (and already-queued) jobs finish —
        # their requests were accepted, abandoning them would half-write
        while True:
            with state_lock:
                if state["active"] == 0:
                    return 0
            time.sleep(0.05)
    finally:
        try:
            os.unlink(sock_path)
        except OSError:
            pass
        srv.close()


# ---------------------------------------------------------------- client


def _spawn_daemon(sock_path: str) -> None:
    """Start a detached daemon for this socket path (idempotent — a loser of
    the flock race exits 0 immediately). Its log rides next to the socket."""
    log_path = sock_path + ".log"
    env = dict(os.environ)
    env.pop("NTCARD_DAEMON", None)  # belt + braces; jobs also strip it
    try:
        with open(log_path, "ab") as log:
            subprocess.Popen(
                [sys.executable, "-m", "ntcard_tpu.daemon"],
                stdin=subprocess.DEVNULL,
                stdout=log,
                stderr=log,
                start_new_session=True,
                env=env,
            )
    except OSError as e:
        sys.stderr.write(f"ntcard: could not spawn daemon: {e}\n")


_LOCAL = "local"  # runs in-process and never opens the card
_CARD = "card"  # runs in-process and may open the card
_ROUTE = "route"  # runs through the daemon


def _route_of(prog: str, argv: list) -> str:
    """Where a job must run. Only jobs whose semantics are identical inside
    the daemon process route there; the others run in-process."""
    if os.environ.get("NTCARD_ENGINE") == "host":
        return _LOCAL  # jax-free path; daemon buys nothing
    if os.environ.get("NTCARD_COORDINATOR") or os.environ.get("NTCARD_NUM_PROCESSES"):
        return _CARD  # multi-host runs own a distributed runtime
    # TRACE-time knobs are baked into jit programs keyed only on shapes
    # (module docstring caveat): inside a long-lived daemon a job forcing
    # one could execute a program traced under DIFFERENT knob values
    for knob in TRACE_KNOBS:
        if os.environ.get(knob):
            return _CARD
    # probe-parse with stderr suppressed (the in-process run will re-parse
    # and print any usage/error text exactly once)
    if prog == "nthll":
        import getopt

        from ntcard_tpu.cli_hll import GETOPT_SPEC

        try:
            optlist, files = getopt.gnu_getopt(list(argv), *GETOPT_SPEC)
        except getopt.GetoptError:
            return _LOCAL
        if not files or any(f in ("--help", "--version") for f, _ in optlist):
            return _LOCAL
    else:
        from ntcard_tpu import cli

        real_err = sys.stderr
        sys.stderr = io.StringIO()
        try:
            opt, files = cli.parse_args(list(argv))
        except SystemExit:
            return _LOCAL  # --help/--version/usage errors stay in-process
        finally:
            sys.stderr = real_err
        if opt.coordinator or opt.num_hosts or opt.host_id >= 0:
            return _CARD
        # output destinations get the same non-regular-file screening as
        # inputs: `-o /dev/stdout` must reach the CLIENT's stdout (the
        # daemon's fd 1 is its log), and `-o >(cmd)` names a /dev/fd that
        # does not exist in the daemon process at all
        out_paths = [opt.output, opt.save_sketch]
        out_paths += [f"{opt.prefix}_k{k}.hist" for k in opt.k_list if opt.prefix]
        for p in out_paths:
            if not p:
                continue
            if p.startswith(("/dev/", "/proc/")):
                return _CARD
            if os.path.exists(p) and not os.path.isfile(p):
                return _CARD
    import stat

    from ntcard_tpu.io.readers import expand_file_args

    try:
        in_files = expand_file_args(list(files))
    except OSError:
        return _LOCAL  # the in-process run reports the bad @list and exits
    for f in in_files:
        # FIFOs and /dev/fd/N process substitutions are only readable in
        # the invoking process; URLs and plain files read fine from the
        # daemon (same machine, cwd carried in the request)
        if "://" in f:
            continue
        try:
            st = os.stat(f)
        except OSError:
            return _LOCAL  # missing input: the in-process run reports it
        if not stat.S_ISREG(st.st_mode):
            return _CARD
    return _ROUTE


def _job_eligible(prog: str, argv: list) -> bool:
    """True when the job may run through the daemon (_route_of)."""
    return _route_of(prog, argv) == _ROUTE


def _daemon_alive(sock_path: str) -> bool:
    """True while the daemon process that owns ``sock_path`` lives: serve()
    takes the socket's lock file first and writes its pid there, so this
    holds from before the daemon binds until it exits."""
    try:
        with open(sock_path + ".lock") as fh:
            pid = int(fh.read().strip() or 0)
    except (OSError, ValueError):
        return False
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass  # alive, owned by another user
    return True


def _connect(sock_path: str) -> socket.socket | None:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(_env_float("NTCARD_DAEMON_CONNECT_SEC", 0.5, lo=0.05))
    try:
        s.connect(sock_path)
    except OSError:
        s.close()
        return None
    return s


def _connect_spawned(sock_path: str, wait_sec: float) -> socket.socket | None:
    """Connect to a daemon just spawned for ``sock_path``: poll until it
    binds, for as long as it lives (a few seconds' grace while the process
    starts and takes its lock), at most ``wait_sec``. None when it died."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < wait_sec:
        s = _connect(sock_path)
        if s is not None:
            return s
        if time.monotonic() - t0 > 15.0 and not _daemon_alive(sock_path):
            return None
        time.sleep(0.05)
    return None


def _refuse(sock_path: str, why: str) -> int:
    sys.stderr.write(
        f"ntcard: the daemon on {sock_path} holds the GPU and {why}; a second "
        "process on the card would fail for want of memory. Stop the daemon "
        "(ntcardd --stop) or run with NTCARD_DAEMON=0 once it has exited.\n"
    )
    return 1


def maybe_run_via_daemon(prog: str, argv: list) -> int | None:
    """CLI hook: run this job through the persistent daemon. Returns the
    job's exit code, or None meaning "run in-process".

    Called unconditionally by both CLIs. NTCARD_DAEMON=0 disables it;
    NTCARD_DAEMON=1/auto routes eligible jobs AND spawns a daemon on first
    use; with the variable UNSET, an already-serving daemon is still used
    — a live warm runtime is strictly faster and byte-identical, so the
    product default takes it — but none is ever spawned implicitly.

    On a GPU host (accel.accelerator_requested) the daemon owns the card
    while it lives, so this never returns None for a job that would open
    the card beside it: it queues behind a busy daemon, waits out one that
    is still booting, routes the first job through a daemon it spawned,
    and refuses (exit 1) a job that cannot be routed."""
    mode = os.environ.get("NTCARD_DAEMON", "")
    if mode == "0" or os.environ.get("NTCARD_IN_DAEMON"):
        return None
    opt_in = mode in ("1", "auto")
    exclusive = accelerator_requested()
    sock_path = default_sock_path()
    ready_sec = _env_float("NTCARD_DAEMON_READY_SEC", 600.0 if exclusive else 10.0, lo=0.05)
    s = _connect(sock_path)
    if s is None and not (opt_in or exclusive):
        return None  # the probe-only default: no daemon is serving
    route = _route_of(prog, argv)
    if s is None and route != _LOCAL:
        if exclusive and _daemon_alive(sock_path):
            # a daemon is starting and holds (or is about to hold) the
            # card: wait for its socket
            s = _connect_spawned(sock_path, ready_sec)
        elif opt_in and route == _ROUTE:
            # opted-in clients spawn a daemon — only for jobs that would
            # actually route; others must not boot a backend for nothing
            _spawn_daemon(sock_path)
            if exclusive:
                s = _connect_spawned(sock_path, ready_sec)
    if s is None:
        if exclusive and route != _LOCAL and _daemon_alive(sock_path):
            return _refuse(sock_path, f"has not bound its socket within {ready_sec:.0f} s")
        return None  # no daemon holds the card: this job runs in-process
    if route != _ROUTE:
        s.close()
        if exclusive and route == _CARD:
            return _refuse(sock_path, "this job cannot run through it")
        return None
    try:
        cwd = os.getcwd()
    except OSError:
        s.close()
        return None  # deleted cwd: the in-process path decides what breaks
    env = {
        k: v
        for k, v in os.environ.items()
        if k.startswith("NTCARD_") and k != "NTCARD_DAEMON"
    }
    req = {"proto": PROTO, "argv": [prog] + list(argv), "cwd": cwd, "env": env}
    sent = False
    try:
        # wait (bounded) for the accept-greeting: a daemon still booting
        # accepts into the backlog and greets once its backend is up. A
        # busy daemon DOES greet (conn threads) with busy=1. Off the GPU
        # both fall back silently (the designed degradation, not a fault)
        # unless the client opted into queueing; on a GPU host the client
        # queues. AFTER the request is sent the reply wait is unbounded on
        # purpose: the daemon WILL run the job (abandoning it would
        # double-write), and a big input runs for as long as it runs.
        s.settimeout(ready_sec)
        f = s.makefile("rb")
        try:
            hello = json.loads(f.readline() or b"null")
        except socket.timeout:
            if exclusive:
                return _refuse(sock_path, f"has not greeted within {ready_sec:.0f} s")
            return None
        if not (isinstance(hello, dict) and hello.get("ready")):
            return None
        queue = exclusive or os.environ.get("NTCARD_DAEMON_BUSY") == "queue"
        if hello.get("busy") and not queue:
            return None
        s.settimeout(None)
        s.sendall(json.dumps(req).encode() + b"\n")
        sent = True
        resp = json.loads(f.readline() or b"null")
    except (OSError, ValueError):
        if sent:
            # the daemon died mid-job; rerunning in-process is safe
            # (outputs are plain files, a partial double-write is
            # overwritten) but worth a note
            sys.stderr.write(
                "ntcard: daemon connection lost; running in-process\n"
            )
        return None
    finally:
        s.close()
    if not isinstance(resp, dict) or resp.get("exit") == _EXIT_PROTO_MISMATCH:
        return None  # version skew: this client outruns the daemon's protocol
    sys.stdout.write(resp.get("out", ""))
    sys.stderr.write(resp.get("err", ""))
    return int(resp.get("exit", 1))


def _control(op: str) -> int:
    """Send a ping/stop to the daemon on the configured socket path."""
    sock_path = default_sock_path()
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(30.0)
    try:
        s.connect(sock_path)
        f = s.makefile("rb")
        hello = json.loads(f.readline() or b"null")  # accept greeting
        if not (isinstance(hello, dict) and hello.get("ready")):
            raise OSError("no greeting")
        s.sendall(json.dumps({"proto": PROTO, "op": op}).encode() + b"\n")
        resp = json.loads(f.readline() or b"{}")
    except (OSError, ValueError):
        sys.stderr.write(f"ntcardd: no daemon on {sock_path}\n")
        return 1
    finally:
        s.close()
    sys.stdout.write(resp.get("out", ""))
    sys.stderr.write(resp.get("err", ""))
    return int(resp.get("exit", 1))


_USAGE = """Usage: ntcardd [--status | --stop | --help]

Persistent warm-pool runtime server for the ntcard/nthll CLIs. With no
argument, serves on the socket (NTCARD_DAEMON_SOCK, default
$TMPDIR/ntcard-daemon-<uid>.sock) until idle for NTCARD_DAEMON_IDLE_SEC
(900). A LIVE daemon is used by the CLIs automatically (no env needed);
NTCARD_DAEMON=1 also makes them spawn one on first use, =0 opts out.

Jobs run one at a time; concurrent invocations see a busy greeting and
queue on a GPU host (one process per card), or fall back to normal
in-process runs instantly elsewhere (NTCARD_DAEMON_BUSY=queue to queue
there too). Results are byte-identical to daemon-less runs.

  --status   ping the serving daemon (pid, jobs served, uptime)
  --stop     ask it to finish the current job and exit
Env: NTCARD_DAEMON_SOCK, NTCARD_DAEMON_IDLE_SEC, NTCARD_DAEMON_WARM
     ("-k64,96,128" prewarms those flag shapes at boot),
     NTCARD_DAEMON_CONNECT_SEC, NTCARD_DAEMON_READY_SEC,
     NTCARD_DAEMON_REQUEST_SEC, NTCARD_DAEMON_BUSY.
"""

def main(argv: list | None = None) -> int:
    """Console entry point (`ntcardd` when installed; `bin/ntcardd` /
    `python -m ntcard_tpu.daemon` in-repo)."""
    args = sys.argv[1:] if argv is None else argv
    if "--help" in args or "-h" in args:
        sys.stderr.write(_USAGE)
        return 0
    if "--status" in args:
        return _control("ping")
    if "--stop" in args:
        return _control("stop")
    return serve()


if __name__ == "__main__":
    raise SystemExit(main())
