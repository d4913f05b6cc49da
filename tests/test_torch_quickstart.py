"""The README's Quickstart through the port, on the CPU, as real processes.

The port's version of ``tests/test_quickstart_e2e.py``: ``template get``
-> ``app new`` -> the event server -> ``EventClient`` posts (single and
batched) -> ``build`` -> ``train`` -> ``deploy`` -> ``EngineClient``
queries -> ``undeploy``, each verb a ``python -m
predictionio_tpu_torch.tools.cli`` subprocess with ``--device cpu``. The
same events go through the JAX package's console into a store of its
own, trained with ``--als-solver pallas`` (its B1 kernel in interpret
mode) and deployed with ``"retrieval": {"mode": "mips"}`` (its B2 kernel
in interpret mode, the catalog past one 512-item tile); the port's
``itemScores`` must equal the reference's: the same items, scores within
``atol`` 1e-4 (``tests/test_torch_store_train.py``'s bar for the store
path's served scores).

Every ``docs/quickstart-*.md`` page also runs through the port, as
``tests/test_quickstarts.py`` runs it through the reference: the page's
events imported, its engine.json trained on the CPU and its query
answered over HTTP.
"""

import datetime as dt
import json
import os
import re
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USERS, ITEMS, PER_USER = 50, 700, 30


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_http(url: str, proc, timeout: float = 120.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"{url}: the server exited {proc.returncode}")
        try:
            with urllib.request.urlopen(url, timeout=2) as resp:
                if resp.status < 500:
                    return
        except Exception:
            time.sleep(0.3)
    raise TimeoutError(f"{url} never came up")


def rate_events() -> list[dict]:
    """``USERS`` users, ``PER_USER`` ratings each over ``ITEMS`` items,
    one second apart (no time ties: both stores read them in one order)."""
    rng = np.random.default_rng(7)
    base = dt.datetime(2024, 3, 1, tzinfo=dt.timezone.utc)
    rows = []
    for u in range(USERS):
        for item in rng.choice(ITEMS, size=PER_USER, replace=False):
            rows.append({"event": "rate", "entityType": "user", "entityId": f"u{u}",
                         "targetEntityType": "item", "targetEntityId": f"i{item}",
                         "properties": {"rating": int(rng.integers(1, 6))},
                         "eventTime": (base + dt.timedelta(seconds=len(rows))).isoformat()})
    return rows


class Console:
    """One package's console on one store, its servers stopped at the end."""

    def __init__(self, pkg: str, basedir: str):
        self.pkg = pkg
        self.env = dict(os.environ, PIO_FS_BASEDIR=basedir, PYTHONPATH=REPO,
                        JAX_PLATFORMS="cpu")
        for key in [k for k in self.env if k.startswith("PIO_STORAGE_")]:
            del self.env[key]
        self.procs = []

    def run(self, *argv) -> str:
        out = subprocess.run([sys.executable, "-m", f"{self.pkg}.tools.cli", *argv],
                             env=self.env, capture_output=True, text=True, timeout=600,
                             cwd=REPO)
        assert out.returncode == 0, (argv, out.stdout, out.stderr)
        return out.stdout

    def serve(self, *argv):
        proc = subprocess.Popen([sys.executable, "-m", f"{self.pkg}.tools.cli", *argv],
                                env=self.env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL, cwd=REPO)
        self.procs.append(proc)
        return proc

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()


def quickstart(pkg: str, tmp_path, events: list[dict], queries: list[dict]) -> dict:
    """The Quickstart through ``pkg``'s console; returns the answers."""
    client = __import__(f"{pkg}.client", fromlist=["EventClient"])
    console = Console(pkg, str(tmp_path / pkg / "store"))
    engine_dir = tmp_path / pkg / "engine"
    device = ["--device", "cpu"] if pkg.endswith("_torch") else []
    try:
        console.run("template", "get", "recommendation", str(engine_dir),
                    "--app-name", "QuickstartApp")
        variant = json.loads((engine_dir / "engine.json").read_text())
        variant["algorithms"][0]["params"]["retrieval"] = {"mode": "mips"}
        (engine_dir / "engine.json").write_text(json.dumps(variant))
        out = console.run("app", "new", "QuickstartApp")
        key = re.search(r"Access Key: (\S+)", out).group(1)

        es_port = free_port()
        es = console.serve("eventserver", "--ip", "127.0.0.1", "--port", str(es_port))
        wait_http(f"http://127.0.0.1:{es_port}/", es)
        events_client = client.EventClient(f"http://127.0.0.1:{es_port}", access_key=key)
        first = events[0]
        eid = events_client.create(
            event=first["event"], entity_type=first["entityType"],
            entity_id=first["entityId"], target_entity_type=first["targetEntityType"],
            target_entity_id=first["targetEntityId"], properties=first["properties"],
            event_time=first["eventTime"])
        assert events_client.get(eid)["properties"] == first["properties"]
        for i in range(1, len(events), 50):
            statuses = events_client.create_batch(events[i:i + 50])
            assert [s["status"] for s in statuses] == [201] * len(events[i:i + 50])

        assert "Build finished" in console.run("build", "--engine-dir", str(engine_dir))
        solver = [] if device else ["--als-solver", "pallas"]
        trained = console.run("train", "--engine-dir", str(engine_dir), *device, *solver)
        instance = re.search(r"Engine instance ID: (\S+)", trained).group(1)

        qs_port = free_port()
        qs = console.serve("deploy", "--engine-dir", str(engine_dir), "--ip", "127.0.0.1",
                           "--port", str(qs_port), *device)
        wait_http(f"http://127.0.0.1:{qs_port}/", qs)
        engine = client.EngineClient(f"http://127.0.0.1:{qs_port}", timeout=60)
        answers = [engine.query(q) for q in queries]
        said = console.run("undeploy", "--ip", "127.0.0.1", "--port", str(qs_port))
        assert "Engine server stopping." in said
        assert qs.wait(timeout=60) is not None
        return {"answers": answers, "instance": instance}
    finally:
        console.close()


def test_the_quickstart_serves_the_references_item_scores(tmp_path):
    events = rate_events()
    assert len({e["targetEntityId"] for e in events}) > 512  # stage 1 runs
    queries = [{"user": f"u{u}", "num": 10} for u in (0, 7, 19, 33)] + [
        {"user": "u3", "num": 5}, {"user": "nobody", "num": 4}]
    port = quickstart("predictionio_tpu_torch", tmp_path, events, queries)
    ref = quickstart("predictionio_tpu", tmp_path, events, queries)
    for got, want, q in zip(port["answers"], ref["answers"], queries):
        assert [s["item"] for s in got["itemScores"]] == [s["item"] for s in want["itemScores"]], q
        np.testing.assert_allclose([s["score"] for s in got["itemScores"]],
                                   [s["score"] for s in want["itemScores"]], atol=1e-4)
    assert all(len(a["itemScores"]) == q["num"] for a, q in zip(port["answers"][:5], queries))
    assert port["answers"][-1] == {"itemScores": []}


def test_train_and_deploy_without_a_card_raise_never_fall_back(tmp_path):
    """No ``--device cpu`` and no card: ``train`` and ``deploy`` (of an
    instance trained with ``--device cpu``) exit non-zero with the device
    error; nothing trains or serves on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    console = Console("predictionio_tpu_torch", str(tmp_path / "store"))
    engine_dir = tmp_path / "engine"
    console.run("template", "get", "recommendation", str(engine_dir), "--app-name", "A")
    console.run("app", "new", "A")
    events = tmp_path / "events.jsonl"
    events.write_text("".join(json.dumps(e) + "\n" for e in rate_events()[:200]))
    console.run("import", "--appid", "1", "--input", str(events))

    def without_device(*argv):
        out = subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *argv,
             "--engine-dir", str(engine_dir)],
            env=console.env, capture_output=True, text=True, timeout=300, cwd=REPO)
        assert out.returncode != 0, argv
        assert "CUDA is not available" in out.stderr, (argv, out.stderr[-2000:])
        return out

    assert "Training completed" not in without_device("train").stdout
    assert "Training completed" in console.run(
        "train", "--engine-dir", str(engine_dir), "--device", "cpu")
    without_device("deploy", "--port", str(free_port()))


# --------------------------------------------------------------------------
# the docs pages
# --------------------------------------------------------------------------

_DOCS = os.path.join(REPO, "docs")

#: (page, app name created in step 1, required response key), as
#: ``tests/test_quickstarts.py`` lists them
PAGES = [
    ("quickstart-recommendation.md", "QuickRec", "itemScores"),
    ("quickstart-classification.md", "QuickClass", "label"),
    ("quickstart-similarproduct.md", "QuickSimilar", "itemScores"),
    ("quickstart-universal.md", "QuickUR", "itemScores"),
    ("quickstart-ecommerce.md", "QuickShop", "itemScores"),
    ("quickstart-ncf.md", "QuickNCF", "itemScores"),
    ("quickstart-sequence.md", "QuickSeq", "itemScores"),
]


def _blocks(page: str, lang: str) -> list[str]:
    with open(os.path.join(_DOCS, page)) as f:
        return re.findall(rf"```{lang}\n(.*?)```", f.read(), re.S)


@pytest.fixture()
def port_store(tmp_path, monkeypatch):
    from predictionio_tpu_torch.data import storage

    for key in [k for k in os.environ if k.startswith(("PIO_STORAGE_", "PIO_SNAPSHOT"))]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path / "store"))
    storage.reset()
    yield storage
    storage.reset()


def test_every_quickstart_page_is_listed():
    assert sorted(p for p, _, _ in PAGES) == sorted(
        f for f in os.listdir(_DOCS) if f.startswith("quickstart-") and f.endswith(".md"))


@pytest.mark.parametrize("page,app_name,response_key", PAGES)
def test_quickstart_page_runs_through_the_port(page, app_name, response_key, port_store,
                                               tmp_path, capsys):
    from predictionio_tpu_torch.data.storage.base import STATUS_COMPLETED
    from predictionio_tpu_torch.tools import cli
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    jsonl = _blocks(page, "jsonl")
    assert len(jsonl) == 1, f"{page}: expected exactly 1 jsonl block"
    engine_json, query_json = _blocks(page, "json")
    assert json.loads(engine_json)["datasource"]["params"]["appName"] == app_name

    assert cli.main(["app", "new", app_name]) == 0
    app_id = re.search(r"ID:\s*(\d+)", capsys.readouterr().out).group(1)
    events_path = tmp_path / "events.jsonl"
    events_path.write_text(jsonl[0])
    assert cli.main(["import", "--appid", app_id, "--input", str(events_path)]) == 0
    variant_path = tmp_path / "engine.json"
    variant_path.write_text(engine_json)
    capsys.readouterr()
    assert cli.main(["build", "--engine-dir", str(tmp_path)]) == 0
    assert "Build finished" in capsys.readouterr().out
    instance = run_train(load_engine_variant(str(variant_path)), device="cpu")
    assert instance.status == STATUS_COMPLETED

    import threading

    server, service = cli.build_query_server(str(variant_path), port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        from predictionio_tpu_torch.client import EngineClient

        body = EngineClient(f"http://127.0.0.1:{server.server_address[1]}",
                            timeout=60).query(json.loads(query_json))
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    assert response_key in body, (page, body)
    if response_key == "itemScores":
        assert len(body["itemScores"]) > 0, (page, body)
    else:
        assert body["label"] == "spam", (page, body)
