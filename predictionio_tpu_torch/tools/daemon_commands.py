"""``pio start-all / stop-all`` daemon management.

Port of ``predictionio_tpu/tools/daemon_commands.py``: bring up / tear
down the long-running services as detached background processes.
``start-all`` launches the Event Server, the dashboard and the admin
server, each as ``python -m predictionio_tpu_torch.tools.cli <verb>``;
``stop-all`` terminates whatever the pidfiles point at, ignoring stale
entries. The query server is managed by ``deploy`` / ``undeploy``.

Both packages may share one store, so the port keeps its pidfiles and
logs in a subdirectory of its own:

    $PIO_FS_BASEDIR/pids/predictionio_tpu_torch/<service>.pid
    $PIO_FS_BASEDIR/logs/predictionio_tpu_torch/<service>.log

The reference's ``stop-all`` reads ``pids/<service>.pid`` only, so it
never finds the port's daemons; the port's ``stop-all`` signals a pid
only while its command line is ``-m predictionio_tpu_torch.tools.cli``,
so never the reference's daemon nor a recycled pid.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def register(sub: argparse._SubParsersAction) -> None:
    start = sub.add_parser(
        "start-all", help="start event server, dashboard, admin server as daemons"
    )
    start.add_argument("--event-server-port", type=int, default=7070)
    start.add_argument("--dashboard-port", type=int, default=9000)
    start.add_argument("--admin-port", type=int, default=7071)
    start.add_argument("--stats", action="store_true", help="event server /stats.json")
    start.set_defaults(func=cmd_start_all)

    stop = sub.add_parser("stop-all", help="stop daemons started by start-all")
    stop.set_defaults(func=cmd_stop_all)


def _base_dir() -> str:
    from predictionio_tpu_torch.data.storage import base_dir

    return base_dir()


#: the port's own subdirectory of ``pids/`` and ``logs/``: the reference's
#: ``stop-all`` reads ``pids/<service>.pid`` and never these
_OWN = "predictionio_tpu_torch"

#: what a daemon of the port runs: ``python -m`` this CLI module
_CLI_MODULE = "predictionio_tpu_torch.tools.cli"


def _pid_path(service: str) -> str:
    return os.path.join(_base_dir(), "pids", _OWN, f"{service}.pid")


def _log_path(service: str) -> str:
    return os.path.join(_base_dir(), "logs", _OWN, f"{service}.log")


def _alive(pid: int) -> bool:
    """True when pid is OUR daemon: alive AND (where /proc allows checking)
    running ``python -m predictionio_tpu_torch.tools.cli``. A recycled pid
    from a stale pidfile, and a daemon of the JAX package (``-m
    predictionio_tpu.tools.cli``), must never be signalled."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass  # EPERM = the process EXISTS, just owned by someone else
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            argv = f.read().decode("utf-8", "replace").split("\0")
    except OSError:
        return True  # no /proc (macOS etc.): best-effort liveness only
    return any(a == "-m" and b == _CLI_MODULE for a, b in zip(argv, argv[1:]))


def _read_pid(service: str) -> int | None:
    try:
        with open(_pid_path(service)) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def _spawn(service: str, argv: list[str]) -> int:
    os.makedirs(os.path.dirname(_pid_path(service)), exist_ok=True)
    os.makedirs(os.path.dirname(_log_path(service)), exist_ok=True)
    log = open(_log_path(service), "a")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *argv],
        stdout=log,
        stderr=subprocess.STDOUT,
        stdin=subprocess.DEVNULL,
        start_new_session=True,  # detach from this CLI's process group
    )
    log.close()
    with open(_pid_path(service), "w") as f:
        f.write(str(proc.pid))
    return proc.pid


_SERVICES = ("eventserver", "dashboard", "adminserver")


def cmd_start_all(args: argparse.Namespace) -> int:
    plans = {
        "eventserver": ["eventserver", "--port", str(args.event_server_port)]
        + (["--stats"] if args.stats else []),
        "dashboard": ["dashboard", "--port", str(args.dashboard_port)],
        "adminserver": ["adminserver", "--port", str(args.admin_port)],
    }
    rc = 0
    for service in _SERVICES:
        existing = _read_pid(service)
        if existing is not None and _alive(existing):
            print(f"{service}: already running (pid {existing})")
            continue
        pid = _spawn(service, plans[service])
        time.sleep(0.3)
        if _alive(pid):
            print(f"{service}: started (pid {pid}, log {_log_path(service)})")
        else:
            print(f"{service}: FAILED to start -- see {_log_path(service)}")
            rc = 1
    return rc


def cmd_stop_all(args: argparse.Namespace) -> int:
    stopped = 0
    for service in _SERVICES:
        pid = _read_pid(service)
        pidfile = _pid_path(service)
        if pid is None:
            continue
        drop_pidfile = True
        if _alive(pid):
            try:
                os.kill(pid, signal.SIGTERM)
                print(f"{service}: stopped (pid {pid})")
                stopped += 1
            except OSError as exc:
                # daemon still running: keep the pidfile so a later
                # (privileged) stop-all can still find it
                print(f"{service}: could not stop pid {pid}: {exc}")
                drop_pidfile = False
        else:
            print(f"{service}: not running (stale pidfile)")
        if drop_pidfile:
            try:
                os.unlink(pidfile)
            except OSError:
                pass
    if stopped == 0:
        print("Nothing to stop.")
    return 0
