"""The port's ``start-all`` / ``stop-all`` against the JAX package's.

As ``tests/test_server_ops.py`` holds the reference: the three daemons
start, answer and stop, a second ``start-all`` respawns nothing, a stale
pidfile is dropped and a pidfile pointing at a live process that is not
the port's daemon (a recycled pid) is never signalled. Both packages may
share one store: the port keeps its pidfiles and logs under
``pids/predictionio_tpu_torch/`` and ``logs/predictionio_tpu_torch/``,
and one package's ``stop-all`` never stops the other's daemons, in
either order.
"""

import os
import socket
import time
import urllib.request

import pytest

from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu_torch.tools import cli, daemon_commands

SERVICES = ("eventserver", "dashboard", "adminserver")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def gone(pid: int) -> bool:
    """The process has exited (no /proc entry, or a zombie not yet reaped)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def wait_gone(pids, timeout: float = 30.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(gone(p) for p in pids):
            return True
        time.sleep(0.2)
    return False


def wait_http(url: str, timeout: float = 60.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=2) as resp:
                if resp.status == 200:
                    return
        except Exception:
            time.sleep(0.3)
    pytest.fail(f"{url} never came up")


@pytest.fixture()
def basedir(tmp_path, monkeypatch):
    from predictionio_tpu.data import storage as jax_storage
    from predictionio_tpu_torch.data import storage

    for key in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", REPO)
    storage.reset()
    jax_storage.reset()
    yield tmp_path
    storage.reset()
    jax_storage.reset()


def read_pids(root) -> dict:
    return {s: int((root / f"{s}.pid").read_text()) for s in SERVICES
            if (root / f"{s}.pid").exists()}


def start_argv(ports) -> list[str]:
    return ["start-all", "--event-server-port", str(ports[0]),
            "--dashboard-port", str(ports[1]), "--admin-port", str(ports[2])]


def test_start_all_stop_all(basedir, capsys):
    ports = free_ports(3)
    own = basedir / "pids" / "predictionio_tpu_torch"
    try:
        assert cli.main(start_argv(ports)) == 0
        out = capsys.readouterr().out
        assert out.count("started") == 3, out
        pids = read_pids(own)
        assert set(pids) == set(SERVICES)
        assert not (basedir / "pids" / "eventserver.pid").exists()  # the reference's name
        for service in SERVICES:
            assert f"log {basedir}/logs/predictionio_tpu_torch/{service}.log" in out
        wait_http(f"http://127.0.0.1:{ports[1]}/")                  # the dashboard
        wait_http(f"http://127.0.0.1:{ports[2]}/cmd/app")           # the admin server
        assert cli.main(start_argv(ports)) == 0
        assert capsys.readouterr().out.count("already running") == 3
    finally:
        # the daemons must die even when an assertion above fails
        code = cli.main(["stop-all"])
        out = capsys.readouterr().out
    assert code == 0 and out.count("stopped") == 3, out
    assert wait_gone(pids.values())
    assert read_pids(own) == {}
    assert cli.main(["stop-all"]) == 0
    assert "Nothing to stop." in capsys.readouterr().out


def test_stop_all_drops_stale_pidfiles(basedir, capsys):
    own = basedir / "pids" / "predictionio_tpu_torch"
    own.mkdir(parents=True)
    (own / "eventserver.pid").write_text("999999999")
    (own / "dashboard.pid").write_text("not a pid")
    assert cli.main(["stop-all"]) == 0
    out = capsys.readouterr().out
    assert "eventserver: not running (stale pidfile)" in out and "Nothing to stop." in out
    assert not (own / "eventserver.pid").exists()


def test_stop_all_never_kills_a_recycled_pid(basedir, capsys):
    """A pidfile pointing at a live process that is not the port's
    daemon -- this very pytest process -- is stale, not killed."""
    own = basedir / "pids" / "predictionio_tpu_torch"
    own.mkdir(parents=True)
    (own / "eventserver.pid").write_text(str(os.getpid()))
    assert cli.main(["stop-all"]) == 0
    assert "stale pidfile" in capsys.readouterr().out  # and we are alive to assert it
    assert not daemon_commands._alive(os.getpid())


@pytest.mark.parametrize("first", ["jax", "port"])
def test_one_packages_stop_all_never_stops_the_others_daemons(first, basedir, capsys):
    """Both packages' daemons on one store: ``first``'s stop-all stops
    its own three and leaves the other's running; the other's then
    stops its own."""
    mains = {"jax": jax_cli.main, "port": cli.main}
    other = "port" if first == "jax" else "jax"
    roots = {"jax": basedir / "pids", "port": basedir / "pids" / "predictionio_tpu_torch"}
    ports = free_ports(6)
    pids = {}
    try:
        for name, p in (("jax", ports[:3]), ("port", ports[3:])):
            assert mains[name](start_argv(p)) == 0
            assert capsys.readouterr().out.count("started") == 3
            pids[name] = read_pids(roots[name])
        assert set(pids["jax"].values()).isdisjoint(pids["port"].values())
        assert mains[first](["stop-all"]) == 0
        assert capsys.readouterr().out.count("stopped") == 3
        assert wait_gone(pids[first].values())
        time.sleep(0.5)
        assert not any(gone(p) for p in pids[other].values())
        assert read_pids(roots[other]) == pids[other]
        port_of = dict(zip(("jax", "port"), (ports[:3], ports[3:])))[other]
        wait_http(f"http://127.0.0.1:{port_of[1]}/")  # the other's dashboard answers
    finally:
        for name in (first, other):
            mains[name](["stop-all"])
        out = capsys.readouterr().out
    assert out.count("stopped") == 3, out
    assert wait_gone(pids[other].values())
