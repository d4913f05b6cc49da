"""The port's micro-batched query server on the CPU, held to the JAX template.

``pio deploy`` of the port sends every ``POST /queries.json`` through the
micro-batcher (``workflow/microbatch.py``, a verbatim copy of the
reference's): concurrent queries become one ``batch_predict``, padded up
to a bucket. The reference's contract (``tests/test_microbatch.py``) is
that batching changes nothing a client sees. Here, from numpy seeds:

- under 16 concurrent clients the batched server (the default knobs, and
  a wide window that surely coalesces) answers byte for byte what the
  unbatched server (``max_batch_size=1``) answers, and both answer
  exactly the JAX ``ALSAlgorithm``'s predict dicts; with user queries
  alone, stage 1 of the retrieval (kernel B2 on the card, its plain
  version here) runs at most once per flushed batch;
- per-request isolation through HTTP: bad queries in a batch answer 400
  alone, their batchmates 200 with their own answers;
- ``POST /stop`` and the drain: queries parked in a batch when the
  server stops are all answered, and a later query is refused with 503;
- plugins, feedback to the event server, ``GET /models.json`` and
  ``GET /reload`` on a deploy of an engine instance from the store.
"""

import http.client
import json
import re
import threading
import time

import numpy as np
import pytest

from predictionio_tpu.controller.base import Params as JaxParams
from predictionio_tpu.models._als_common import build_seen as jax_build_seen
from predictionio_tpu.models.recommendation.engine import (
    ALSAlgorithm as JaxALSAlgorithm,
    RecommendationModel as JaxRecommendationModel,
)
from predictionio_tpu.parallel.als import ALSModel as JaxALSModel
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.api.eventserver import create_event_server
from predictionio_tpu_torch.data.storage.base import AccessKey
from predictionio_tpu_torch.models.recommendation import model_from_arrays, save_model
from predictionio_tpu_torch.ops import mips
from predictionio_tpu_torch.tools.cli import build_query_server
from predictionio_tpu_torch.utils.http import Request
from predictionio_tpu_torch.workflow.core_workflow import run_train
from predictionio_tpu_torch.workflow.create_server import (
    EngineServerPlugin,
    FeedbackConfig,
    ServerRejection,
    create_query_server,
)
from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant
from predictionio_tpu_torch.workflow.microbatch import BatchConfig
from test_torch_online import basedir, trained_variant  # noqa: F401
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

RETRIEVAL = {"mode": "mips", "shortlist": 32, "blockItems": 64, "blockTopk": 16}
USERS, ITEMS, RANK = 24, 300, 16
CLIENTS = 16
#: a window that surely coalesces the clients released together
WIDE = BatchConfig(window_ms=400.0, idle_ms=400.0)
WAIT_S = 60


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    """(engine.json, model dir, jax algorithm, jax model): one random
    model made from a seed, saved for the port and built for the JAX
    template from the same arrays."""
    rng = np.random.default_rng(5)
    uf = rng.standard_normal((USERS, RANK)).astype(np.float32)
    itf = rng.standard_normal((ITEMS, RANK)).astype(np.float32)
    users, items = rng.integers(0, USERS, 400), rng.integers(0, ITEMS, 400)
    user_ids = [f"u{u}" for u in range(USERS)]
    item_ids = [f"i{i}" for i in range(ITEMS)]
    root = tmp_path_factory.mktemp("microbatch")
    save_model(model_from_arrays(uf, itf, user_ids, item_ids, users, items),
               str(root / "model"))
    engine_json = root / "engine.json"
    engine_json.write_text(json.dumps({
        "id": "recommendation",
        "engineFactory": "predictionio_tpu.models.recommendation.engine_factory",
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [{"name": "als", "params": {"rank": RANK, "retrieval": RETRIEVAL}}],
    }))
    jax_model = JaxRecommendationModel(
        als=JaxALSModel(user_factors=uf, item_factors=itf),
        user_index={uid: idx for idx, uid in enumerate(user_ids)},
        item_ids=item_ids,
        item_index={iid: idx for idx, iid in enumerate(item_ids)},
        seen=jax_build_seen(users, items),
    )
    jax_algo = JaxALSAlgorithm(JaxParams({"rank": RANK, "retrieval": RETRIEVAL}))
    return str(engine_json), str(root / "model"), jax_algo, jax_model


class Served:
    """A port query server in a thread; ``close()`` stops the listener,
    then drains the batcher, as ``run_query_server`` does."""

    def __init__(self, engine, batching):
        engine_json, model_dir, _, _ = engine
        self.server, self.service = build_query_server(
            engine_json, model_dir, port=0, device="cpu", batching=batching)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.port = self.server.server_address[1]

    def post(self, obj, path="/queries.json", conn=None):
        if conn is not None:
            return post_on(conn, obj, path)
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=WAIT_S)
        try:
            return post_on(conn, obj, path)
        finally:
            conn.close()

    def metrics(self) -> str:
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=WAIT_S)
        try:
            conn.request("GET", "/metrics")
            return conn.getresponse().read().decode()
        finally:
            conn.close()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.service.close()
        self.thread.join(timeout=WAIT_S)
        assert not self.thread.is_alive()


def post_on(conn, obj, path="/queries.json"):
    """``(status, body bytes)`` of one POST on a kept-alive connection."""
    body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
    conn.request("POST", path, body, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read()


def metric(scrape: str, name: str) -> float:
    """The sum of every series of ``name`` in a Prometheus scrape."""
    pattern = re.compile(rf"^{re.escape(name)}(\{{[^}}]*\}})? (\S+)$")
    return sum(float(m.group(2)) for line in scrape.splitlines()
               if (m := pattern.match(line)))


def client_queries(k: int) -> list[dict]:
    """Client ``k``'s queries: known users, a blackList, unseenOnly off,
    item similarity and a cold user."""
    return [
        {"user": f"u{(3 * k) % USERS}", "num": 5},
        {"user": f"u{(3 * k + 1) % USERS}", "num": 7, "blackList": [f"i{k}", f"i{k + 1}"]},
        {"user": f"u{(3 * k + 2) % USERS}", "num": 4, "unseenOnly": False},
        {"items": [f"i{2 * k}", f"i{2 * k + 7}"], "num": 3},
        {"user": f"cold{k}", "num": 4},
    ]


def run_clients(served, queries_of, n=CLIENTS):
    """``n`` keep-alive clients released together, each posting its
    queries in turn; returns ``{(client, j): (status, body bytes)}``."""
    barrier = threading.Barrier(n)
    out, errors = {}, []

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", served.port, timeout=WAIT_S)
        try:
            barrier.wait(timeout=WAIT_S)
            for j, q in enumerate(queries_of(k)):
                out[(k, j)] = served.post(q, conn=conn)
        except Exception as exc:  # surfaced below, with the others
            errors.append(exc)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return out


@pytest.fixture(scope="module")
def unbatched(engine):
    served = Served(engine, BatchConfig(max_batch_size=1))
    yield served
    served.close()


@pytest.mark.parametrize("batching", [BatchConfig(), WIDE], ids=["default", "wide"])
def test_batched_server_answers_as_unbatched_and_the_reference(engine, unbatched, batching):
    _, _, jax_algo, jax_model = engine
    assert not unbatched.service.batching.enabled
    served = Served(engine, batching)
    try:
        assert served.service.batching.enabled
        got = run_clients(served, client_queries)
        want = run_clients(unbatched, client_queries)
        assert got == want  # status and body bytes
        for (k, j), (status, body) in got.items():
            q = client_queries(k)[j]
            assert status == 200
            assert json.loads(body) == jax_algo.predict(jax_model, q), q
        scrape = served.metrics()
        flushes = metric(scrape, "pio_serving_batch_flush_total")
        assert metric(scrape, "pio_serving_batch_size_count") == flushes > 0
        assert metric(scrape, "pio_serving_batch_size_sum") == len(got)
        if batching is WIDE:
            assert flushes < len(got)  # the clients really coalesced
    finally:
        served.close()


def test_one_stage1_search_per_flushed_batch(engine, monkeypatch):
    """Known-user queries alone: every flush searches once (kernel B2 on
    the card), so the searches are at most the flushes and fewer than
    the queries; a flush of cold users alone searches nothing."""
    calls = []
    plain = mips.mips_block_topk

    def counting(queries, *args, **kwargs):
        calls.append(queries.shape[0])
        return plain(queries, *args, **kwargs)

    counting.launches = 0  # what /metrics mirrors: no launch on the CPU
    monkeypatch.setattr(mips, "mips_block_topk", counting)
    served = Served(engine, WIDE)
    calls.clear()  # the deploy's warm-up searches
    try:
        got = run_clients(served, lambda k: [{"user": f"u{(k + j) % USERS}", "num": 5}
                                             for j in range(3)])
        assert all(status == 200 for status, _ in got.values())
        flushes = metric(served.metrics(), "pio_serving_batch_flush_total")
        assert 0 < len(calls) <= flushes < len(got)
        # each search covers a padded bucket of the ladder (1/4/16/64),
        # itself padded to the retrieval's 8-row query blocks
        assert set(calls) <= {8, 16, 64}
        calls.clear()
        assert run_clients(served, lambda k: [{"user": f"cold{k}", "num": 5}])
        assert calls == []
    finally:
        served.close()


def test_per_request_isolation_through_http(engine, unbatched):
    """Bad queries coalesced with good ones answer 400 alone: the
    batched predict raises, the batch is rescored per query, and every
    good query answers exactly what the unbatched server answers."""
    bad = {3: {"num": 3}, 7: {"user": "u1", "num": "x"}, 11: b"{not json"}

    def queries_of(k):
        return [bad.get(k, {"user": f"u{k}", "num": 6})]

    served = Served(engine, WIDE)
    try:
        got = run_clients(served, queries_of)
        want = run_clients(unbatched, queries_of)
    finally:
        served.close()
    assert got.keys() == want.keys()
    for key, (status, body) in got.items():
        if key[0] in bad:
            # an error body carries its own trace's id when it was sampled
            untraced = [{k: v for k, v in json.loads(b).items() if k != "traceId"}
                        for b in (body, want[key][1])]
            assert status == want[key][0] == 400 and untraced[0] == untraced[1], key
        else:
            assert (status, body) == want[key] and json.loads(body)["itemScores"], key
    assert "bad query" in json.loads(got[(7, 0)][1])["message"]


def test_stop_drains_queries_parked_in_a_batch(engine, monkeypatch):
    """``POST /stop`` while queries wait in a wide window: stopping the
    listener and then the service flushes them at once (a "drain"
    flush), every one answers 200 with the unbatched answer, and a query
    after the drain is refused with 503."""
    served = Served(engine, BatchConfig(window_ms=30_000.0, idle_ms=30_000.0))
    batcher = served.service._batcher
    submitted = threading.Semaphore(0)
    submit = batcher.submit

    def counting_submit(query):
        future = submit(query)
        submitted.release()
        return future

    monkeypatch.setattr(batcher, "submit", counting_submit)
    answers, threads = {}, []
    for k in range(6):
        def client(k=k):
            answers[k] = served.post({"user": f"u{k}", "num": 4})
        threads.append(threading.Thread(target=client))
        threads[-1].start()
    try:
        for _ in threads:
            assert submitted.acquire(timeout=WAIT_S)
        assert served.post({}, path="/stop") == (200, b'{"status": "stopping"}')
        assert served.service._stop_event.wait(timeout=WAIT_S)
        assert not answers  # still parked: the window is 30 s
    finally:
        served.close()
        for t in threads:
            t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    assert metric(served.service.metrics.exposition(),
                  "pio_serving_batch_flush_total") == 1  # the drain flush
    for k, (status, body) in answers.items():
        assert status == 200
        assert body == json.dumps(served.service._predict_one(
            {"user": f"u{k}", "num": 4})[0]).encode()
    late = served.service.handle_query(Request(
        method="POST", path="/queries.json", query={}, headers={},
        body=b'{"user": "u0"}', path_params={}))
    assert late.status == 503 and late.body == {"message": "server is stopping"}


class Blocker(EngineServerPlugin):
    """Rejects one user's answers and records every answer it sees."""

    def __init__(self):
        self.sniffed = []

    def output_blocker(self, query, prediction):
        if query.get("user") == "u3":
            raise ServerRejection("blocked by a plugin", status=451)

    def output_sniffer(self, query, prediction):
        self.sniffed.append(query.get("user"))


def test_plugins_feedback_models_and_reload(basedir):  # noqa: F811
    """The rest of the reference's query server around the batcher: a
    plugin's blocker answers its status and its sniffer sees every
    answer; with feedback on, each answer carries a ``prId`` and a
    "predict" event reaches the event server; ``GET /models.json`` lists
    the registry; ``GET /reload`` serves the latest COMPLETED instance."""
    engine_json = trained_variant(basedir)
    variant = load_engine_variant(engine_json)
    storage.get_meta_data_access_keys().insert(AccessKey(key="fb-key", app_id=1))
    events = create_event_server(host="127.0.0.1", port=0).start()
    blocker = Blocker()
    thread, service = create_query_server(
        variant, "127.0.0.1", 0, device="cpu", plugins=[blocker],
        feedback=FeedbackConfig(f"http://127.0.0.1:{events.port}", "fb-key"))
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", thread.port, timeout=WAIT_S)
    try:
        first = service.instance.id
        status, body = post_on(conn, {"user": "u1", "num": 3})
        answer = json.loads(body)
        assert status == 200 and answer["itemScores"] and len(answer["prId"]) == 32
        status, body = post_on(conn, {"user": "u3", "num": 3})
        assert (status, json.loads(body)["message"]) == (451, "blocked by a plugin")
        assert blocker.sniffed == ["u1"]
        deadline = time.monotonic() + WAIT_S
        while not (found := list(storage.get_l_events().find(app_id=1, entity_type="pio_pr"))):
            assert time.monotonic() < deadline, "no feedback event reached the event server"
            time.sleep(0.05)
        assert [(e.event, e.entity_id) for e in found] == [("predict", answer["prId"])]
        assert found[0].properties["query"] == {"user": "u1", "num": 3}
        conn.request("GET", "/models.json")
        assert json.loads(conn.getresponse().read()) == {"currentVersion": None, "versions": []}
        second = run_train(variant, device="cpu").id
        conn.request("GET", "/reload")
        resp = conn.getresponse()
        assert (resp.status, json.loads(resp.read())) == (
            200, {"status": "reloaded", "engineInstanceId": second})
        assert second != first and service.instance.id == second
    finally:
        conn.close()
        thread.stop()
        service.close()
        events.stop()
