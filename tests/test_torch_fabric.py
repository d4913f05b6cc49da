"""The port's serving fabric on the CPU: rings, frontends, scorer shards.

The multi-process tier and the sharded fabric are the reference's
(``serving/{shmring,frontend,procserver,shardmap}.py`` verbatim copies,
``serving/fabric.py`` with the device passed to its shards,
``serving/shard.py`` ported). The contract is the reference's own
(``tests/test_procserver.py``, ``tests/test_sharding.py``): a client sees
the same bytes whichever tier answers. Here, from numpy seeds, with
every process of the port:

- a ring written by the JAX package's ``shmring`` reads back through the
  port's, and a frontend worker process echoes through the port's
  ``ScorerBridge``;
- a ring's counters, written by one process while another polls them,
  never read as a value they did not hold;
- ``frontend_workers=2`` (async and sync dispatch) answers byte for byte
  as the unbatched single-process server, within the reference's wakeup
  budget (at most 2 per request under async dispatch);
- a 2-shard fabric with ``device="cpu"`` answers every user as the
  unsharded server on the same registry version, and one
  ``POST /models/swap`` moves both shards to the next version, which
  each stamps on its answers;
- ``PIO_SHARD_BUDGET_BYTES`` lets a shard load its per-shard blob and
  refuses a full one;
- ``ALSAlgorithm.shard_model`` equals the JAX template's on the same
  arrays, and owned users score as on the whole model;
- ``pio retrain --scorer-shards 2`` republishes only the shards of
  touched users, carries the other shard's bytes verbatim, and
  recomputes every shard when the catalog grows;
- the event server with ``frontend_workers=2`` stores a posted batch as
  the JAX package's single-process server does;
- the command line: ``deploy --frontend-workers 2``, ``deploy
  --scorer-shards 2`` and ``eventserver --frontend-workers 2`` run as
  processes of their own, answer, and stop.

Every wait is bounded: spawns, joins, sockets and polls carry deadlines.
"""

import datetime as dt
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from predictionio_tpu.controller.base import Params as JaxParams
from predictionio_tpu.models._als_common import build_seen as jax_build_seen
from predictionio_tpu.models.recommendation.engine import (
    ALSAlgorithm as JaxALSAlgorithm,
    RecommendationModel as JaxRecommendationModel,
)
from predictionio_tpu.parallel.als import ALSModel as JaxALSModel
from predictionio_tpu.serving import shmring as jax_shmring
from predictionio_tpu_torch.controller.base import Params
from predictionio_tpu_torch.controller.engine import deserialize_model, serialize_model
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.wal import WriteAheadLog
from predictionio_tpu_torch.models.recommendation import ALSAlgorithm, model_from_arrays
from predictionio_tpu_torch.online.foldin import StalenessBudget
from predictionio_tpu_torch.online.registry import ModelRegistry
from predictionio_tpu_torch.serving import shmring
from predictionio_tpu_torch.serving.procserver import FrontendConfig, ScorerBridge
from predictionio_tpu_torch.serving.shardmap import shard_of
from predictionio_tpu_torch.utils.http import Response, Router
from predictionio_tpu_torch.workflow.create_server import (
    QueryService,
    create_multiproc_query_server,
    create_query_server,
    create_sharded_query_server,
)
from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant
from predictionio_tpu_torch.workflow.microbatch import BatchConfig
from test_torch_online import basedir, ingest_via_wal, new_loop, trained_variant  # noqa: F401
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

RETRIEVAL = {"mode": "mips", "shortlist": 32, "blockItems": 64, "blockTopk": 16}
USERS, ITEMS, RANK = 96, 300, 8
ALGO = {"rank": RANK, "retrieval": RETRIEVAL}
WAIT_S = 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNBATCHED = BatchConfig(max_batch_size=1)


def arrays(seed=9):
    rng = np.random.default_rng(seed)
    uf = rng.standard_normal((USERS, RANK)).astype(np.float32)
    itf = rng.standard_normal((ITEMS, RANK)).astype(np.float32)
    seen_u, seen_i = rng.integers(0, USERS, 500), rng.integers(0, ITEMS, 500)
    return uf, itf, seen_u, seen_i


def model(uf, itf, seen_u, seen_i):
    return model_from_arrays(uf, itf, [f"u{u}" for u in range(USERS)],
                             [f"i{i}" for i in range(ITEMS)], seen_u, seen_i)


@pytest.fixture()
def published(basedir):  # noqa: F811
    """An engine.json and two registry versions of one random model,
    each with the full blob and two per-shard blobs: version 2 is
    version 1 with 24 users' rows changed (the same item side)."""
    engine_json = basedir / "engine.json"
    engine_json.write_text(json.dumps({
        "id": "fabric",
        "engineFactory": "predictionio_tpu.models.recommendation.engine_factory",
        "datasource": {"params": {"appName": "FabricApp"}},
        "algorithms": [{"name": "als", "params": ALGO}],
    }))
    variant = load_engine_variant(str(engine_json))
    algorithm = ALSAlgorithm(Params(ALGO), device="cpu")
    registry = ModelRegistry.for_variant(variant)
    uf, itf, seen_u, seen_i = arrays()
    uf2 = uf.copy()
    uf2[::4] *= -1.5
    for factors in (uf, uf2):
        full = model(factors, itf, seen_u, seen_i)
        registry.publish(
            serialize_model(variant.template, full),
            meta={"source": "test", "engine_params": variant.engine_params.to_json_obj()},
            shard_blobs=[serialize_model(variant.template, algorithm.shard_model(full, k, 2))
                         for k in range(2)],
        )
    return str(engine_json), variant, registry


def post(port, obj, path="/queries.json", conn=None):
    own = conn is None
    conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request("POST", path, json.dumps(obj).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read(), resp.getheader("x-pio-model-version")
    finally:
        if own:
            conn.close()


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def metric(scrape: str, name: str, labels: str = "") -> float | None:
    pattern = re.compile(rf"^{re.escape(name + labels)} (\S+)$")
    for line in scrape.splitlines():
        if m := pattern.match(line):
            return float(m.group(1))
    return None


def queries():
    return [{"user": f"u{u}", "num": 6} for u in range(0, USERS, 3)] + [
        {"user": "u5", "num": 4, "blackList": ["i1", "i2"]},
        {"user": "u7", "num": 5, "unseenOnly": False},
        {"items": ["i3", "i9"], "num": 4},
        {"user": "stranger", "num": 3},
    ]


def concurrent(port, qs, clients=8):
    """``qs`` spread over keep-alive ``clients``; ``{index: answer}``."""
    out, errors = {}, []

    def client(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
        try:
            for j in range(k, len(qs), clients):
                out[j] = post(port, qs[j], conn=conn)
        except Exception as exc:
            errors.append(exc)
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return out


class Single:
    """The unbatched single-process server on registry ``version``."""

    def __init__(self, variant, version):
        self.thread, self.service = create_query_server(
            variant, "127.0.0.1", 0, device="cpu", model_version=version,
            batching=UNBATCHED)
        self.thread.start()
        self.port = self.thread.port

    def answers(self, qs):
        return {j: post(self.port, q) for j, q in enumerate(qs)}

    def close(self):
        self.thread.stop()
        self.service.close()


def test_ring_round_trip_and_frontend_echo(tmp_path):
    """A ring the JAX package writes reads back through the port's (one
    wire format); the port's frontend process echoes through its bridge
    on one keep-alive connection."""
    ref = jax_shmring.RingFile.create(str(tmp_path / "x.ring"), 4, 256, generation=1)
    ring = shmring.RingFile.attach(str(tmp_path / "x.ring"))
    for i in range(6):  # past the slot count: wraps
        ref.requests.push({"i": i}, bytes([i]) * 3)
        assert ring.requests.pop() == ({"i": i}, bytes([i]) * 3)
    assert ring.requests.pop() is None
    ring.close()
    ref.close()
    router = Router()
    router.add("POST", "/queries.json",
               lambda r: Response(200, {"echo": r.json(), "q": r.query}))
    bridge = ScorerBridge(router, "127.0.0.1", 0,
                          FrontendConfig(workers=1, stats_flush_s=0.02)).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", bridge.port, timeout=WAIT_S)
        for k in range(3):
            conn.request("POST", f"/queries.json?k={k}", json.dumps({"n": k}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            assert json.loads(resp.read()) == {"echo": {"n": k}, "q": {"k": str(k)}}
        conn.close()
    finally:
        bridge.stop()


def test_ring_counters_read_whole_across_processes(tmp_path):
    """A consumer process pops as fast as it can while this process
    pushes 8 messages at a time into 16 slots and polls ``pending()``
    until the ring drains. The consumer's tail only grows, so ``pending``
    never rises between pushes and a push never finds the ring full. A
    counter written through ``struct.pack_into`` (which zeroes the field
    before it stores the value) shows both within a few thousand
    messages."""
    n = 50_000
    path = str(tmp_path / "c.ring")
    ring = shmring.RingFile.create(path, 16, 64, generation=1)
    consumer = subprocess.Popen([sys.executable, "-c", (
        "import sys, time\n"
        "from predictionio_tpu_torch.serving.shmring import RingFile\n"
        f"ring, n, deadline = RingFile.attach({path!r}), 0, time.monotonic() + {WAIT_S}\n"
        f"while n < {n}:\n"
        "    if ring.requests.pop() is not None:\n"
        "        n += 1\n"
        "    elif time.monotonic() > deadline:\n"
        "        sys.exit(f'popped {n} before the deadline')\n")], cwd=REPO)
    sent = rises = full = 0
    try:
        while sent < n:
            for _ in range(min(8, n - sent)):
                try:
                    ring.requests.push({"i": sent})
                except shmring.RingFull:
                    full += 1
                    break
                sent += 1
            last = ring.requests.pending()
            while last:
                if consumer.poll() is not None:
                    break
                now = ring.requests.pending()
                rises += now > last
                last = now
            if consumer.poll() is not None:
                break
        assert consumer.wait(timeout=WAIT_S) == 0
    finally:
        if consumer.poll() is None:
            consumer.kill()
            consumer.wait(timeout=WAIT_S)
        ring.close()
    assert (sent, rises, full) == (n, 0, 0)


def test_a_respawned_ring_starts_zeroed_under_its_new_generation(tmp_path):
    """The risk ``pio check`` accepts at ``RingFile.create`` (R003: its
    rename has no fsync before it): the ring file is scratch, not state.
    A worker killed with messages in both rings, published stats, a
    STATE_READY header and a ``.tmp`` carcass beside its file is respawned
    over the same path under generation 2: the new file reads zeroed --
    nothing pending, no stats, the init state -- and the dead worker's
    mapping, still open, writes into the orphaned inode, never into it."""
    path = str(tmp_path / "w0.ring")
    dead = shmring.RingFile.create(path, 4, 128, generation=1)
    dead.requests.push({"q": 1}, b"body")
    dead.completions.push({"r": 1})
    dead.write_stats({"served": 7})
    dead.set_state(shmring.STATE_READY)
    with open(f"{path}.tmp", "wb") as f:
        f.write(b"\xff" * 64)
    fresh = shmring.RingFile.create(path, 4, 128, generation=2)
    seen = shmring.RingFile.attach(path)
    try:
        dead.requests.push({"q": 2})
        assert (seen.generation, seen.state) == (2, shmring.STATE_INIT)
        assert seen.requests.pending() == seen.completions.pending() == 0
        assert seen.requests.pop() is None and seen.read_stats() is None
        assert not os.path.exists(f"{path}.tmp")
        fresh.requests.push({"q": 3})
        assert seen.requests.pop() == ({"q": 3}, b"")
        assert dead.requests.pending() == 2
    finally:
        for ring in (seen, fresh, dead):
            ring.close()


@pytest.mark.parametrize("dispatch", ["async", "sync"])
def test_frontend_workers_answer_byte_identically(published, dispatch):
    _, variant, _ = published
    single = Single(variant, 1)
    handle, service = create_multiproc_query_server(
        variant, "127.0.0.1", 0, device="cpu", model_version=1,
        frontend=FrontendConfig(workers=2, dispatch=dispatch, stats_flush_s=0.02,
                                spawn_timeout_s=WAIT_S))
    try:
        handle.start()
        qs = queries()
        got = concurrent(handle.port, qs)
        assert got == single.answers(qs)
        assert all(status == 200 and version == "1" for status, _, version in got.values())
        status, body = get(handle.port, "/")
        info = json.loads(body)
        assert status == 200 and info["frontend"]["workers"] == 2
        assert info["devices"] == ["cpu"] and info["batching"]["enabled"]
        scrape = get(handle.port, "/metrics")[1].decode()
        wakeups = metric(scrape, "pio_scorer_wakeups_per_request")
        if dispatch == "async":
            assert metric(scrape, "pio_scorer_dispatch_threads") == 0.0
            assert 0.0 < wakeups <= 2.0, wakeups
        else:
            assert wakeups > 2.0, wakeups
    finally:
        handle.stop()
        service.close()
        single.close()


def test_sharded_fabric_answers_as_unsharded_and_swaps_per_shard(published):
    """Two shard processes (``device="cpu"``) behind two frontends: every
    query answers the unsharded server's bytes on version 1; one swap
    moves both shards to version 2, each stamping it, with the unsharded
    server's version-2 bytes; each shard's control face mirrors its B2
    launch count (0 here: the plain version launches nothing)."""
    _, variant, _ = published
    fabric = create_sharded_query_server(
        variant, "127.0.0.1", 0, scorer_shards=2, model_version=1, device="cpu",
        frontend=FrontendConfig(workers=2, spawn_timeout_s=120.0))
    single = Single(variant, 1)
    try:
        fabric.start()
        qs = queries()
        got = concurrent(fabric.port, qs)
        assert got == single.answers(qs)
        assert {shard_of(q["user"], 2) for q in qs if "user" in q} == {0, 1}
        status, body, _ = post(fabric.port, {}, path="/models/swap")
        swap = json.loads(body)
        assert status == 200 and swap["status"] == "swapped", body
        assert [s["modelVersion"] for s in swap["shards"]] == [2, 2]
        assert json.loads(get(fabric.port, "/models.json")[1])["currentVersion"] == 2
        single.close()
        single = Single(variant, 2)
        got = concurrent(fabric.port, qs)
        assert got == single.answers(qs)
        assert {version for _, _, version in got.values()} == {"2"}
        for k in range(2):
            status, body = get(fabric._shard_port(k), "/metrics")
            scrape = body.decode()
            assert metric(scrape, "pio_kernel_launches_total",
                          '{kernel="mips_block_topk"}') == 0.0
            assert metric(scrape, "pio_scorer_shard_index") == float(k)
            info = json.loads(get(fabric._shard_port(k), "/")[1])
            assert info["devices"] == ["cpu"] and info["modelVersion"] == 2
    finally:
        fabric.stop()
        single.close()


def test_shard_budget_refuses_a_full_blob(published, monkeypatch):
    """Under ``PIO_SHARD_BUDGET_BYTES`` between a shard's blob and the
    full one, a shard loads its per-shard blob and answers its users as
    the whole model; a version with the full blob alone is refused."""
    _, variant, registry = published
    v1 = registry.get(1)
    full, shards = len(v1.load_blob()), [len(v1.load_blob(shard=k)) for k in range(2)]
    budget = (max(shards) + full) // 2
    assert max(shards) < budget < full
    monkeypatch.setenv("PIO_SHARD_BUDGET_BYTES", str(budget))
    registry.publish(v1.load_blob(), meta={"source": "test"})  # version 3: no shards
    whole = QueryService(variant, device="cpu", model_version=1, batching=UNBATCHED)
    for k in range(2):
        shard = QueryService(variant, device="cpu", model_version=1, shard=k,
                             num_shards=2, batching=UNBATCHED)
        owned = [u for u in range(USERS) if shard_of(f"u{u}", 2) == k]
        assert sorted(shard.models[0].user_index) == sorted(f"u{u}" for u in owned)
        for u in owned[:8]:
            q = {"user": f"u{u}", "num": 5}
            assert shard._predict_one(q) == whole._predict_one(q)
        with pytest.raises(RuntimeError, match="over the shard budget"):
            QueryService(variant, device="cpu", model_version=3, shard=k, num_shards=2)
        shard.close()
    whole.close()


def test_shard_model_equals_the_reference():
    uf, itf, seen_u, seen_i = arrays(seed=4)
    port_model = model(uf, itf, seen_u, seen_i)
    jax_model = JaxRecommendationModel(
        als=JaxALSModel(user_factors=uf, item_factors=itf),
        user_index=dict(port_model.user_index), item_ids=list(port_model.item_ids),
        item_index=dict(port_model.item_index), seen=jax_build_seen(seen_u, seen_i))
    algorithm = ALSAlgorithm(Params(ALGO), device="cpu")
    jax_algorithm = JaxALSAlgorithm(JaxParams(ALGO))
    assert algorithm.shard_model(port_model, 0, 1) is port_model
    for n in (2, 3):
        covered = set()
        for k in range(n):
            ours = algorithm.shard_model(port_model, k, n)
            ref = jax_algorithm.shard_model(jax_model, k, n)
            assert ours.user_index == ref.user_index
            np.testing.assert_array_equal(ours.als.user_factors, ref.als.user_factors)
            assert ours.als.item_factors is port_model.als.item_factors
            assert ours.seen == ref.seen and ours.item_ids == ref.item_ids
            covered |= set(ours.user_index)
            for uid in list(ours.user_index)[:6]:
                q = {"user": uid, "num": 7}
                assert algorithm.predict(ours, q) == algorithm.predict(port_model, q)
            # a shard's model survives its blob (the registry's per-shard file)
            back = deserialize_model(
                load_template(), serialize_model(load_template(), ours))
            assert back.user_index == ours.user_index and back.seen == ours.seen
            np.testing.assert_array_equal(back.als.user_factors, ours.als.user_factors)
        assert covered == set(port_model.user_index)


def load_template():
    from predictionio_tpu_torch.controller.engine import TEMPLATES

    return TEMPLATES["recommendation"]


def test_retrain_shard_blobs_carry_untouched_shards_verbatim(basedir):  # noqa: F811
    engine_json = trained_variant(basedir)
    loop = new_loop(engine_json, basedir, scorer_shards=2,
                    budget=StalenessBudget(max_item_growth_frac=1.0))
    users = sorted(loop.model.user_index)
    by_shard = {k: [u for u in users if shard_of(u, 2) == k] for k in range(2)}
    wal = WriteAheadLog(str(basedir / "wal"))
    # each event a second old: one stamped in the loop's own millisecond
    # counts as future-dated and defers its cycle
    past = lambda: dt.datetime.now(dt.timezone.utc) - dt.timedelta(seconds=1)  # noqa: E731
    try:
        ingest_via_wal(wal, by_shard[0][0], "i1", event_time=past())
        assert loop.run_once() == "foldin"
        ingest_via_wal(wal, by_shard[1][0], "i2", event_time=past())
        assert loop.run_once() == "foldin"
        ingest_via_wal(wal, by_shard[1][1], "brand-new-item", event_time=past())
        assert loop.run_once() == "foldin"
    finally:
        wal.close()
    v1, v2, v3 = (loop.registry.get(v) for v in (1, 2, 3))
    assert [v.shard_count for v in (v1, v2, v3)] == [2, 2, 2]
    assert [v.manifest["shard_item_count"] for v in (v1, v2, v3)] == [10, 10, 11]
    # v2 touched shard 1 only: shard 0's bytes are v1's, verbatim
    assert v2.load_blob(shard=0) == v1.load_blob(shard=0)
    assert v2.load_blob(shard=1) != v1.load_blob(shard=1)
    # the catalog grew in v3: every shard is recomputed
    template = load_engine_variant(engine_json).template
    for k in range(2):
        shard_model = deserialize_model(template, v3.load_blob(shard=k))
        assert "brand-new-item" in shard_model.item_index
        assert set(shard_model.user_index) == set(by_shard[k])
    whole = deserialize_model(template, v3.load_blob())
    assert whole.item_ids == shard_model.item_ids


def _event_store(pkg_storage, base_cls, root, monkeypatch):
    monkeypatch.setenv("PIO_FS_BASEDIR", str(root))
    pkg_storage.reset()
    app_id = pkg_storage.get_meta_data_apps().insert(base_cls.App(name="FeApp"))
    pkg_storage.get_meta_data_access_keys().insert(base_cls.AccessKey(key="fe-key", app_id=app_id))
    pkg_storage.get_l_events().init_channel(app_id)


def test_eventserver_frontend_workers_store_a_batch(tmp_path, monkeypatch):
    """``pio eventserver --frontend-workers 2``: a posted batch (with an
    invalid item) answers the JAX single-process server's statuses, and
    every valid event is stored."""
    from predictionio_tpu.data import storage as jax_storage
    from predictionio_tpu.data.api import eventserver as jax_eventserver
    from predictionio_tpu.data.storage import base as jax_base
    from predictionio_tpu_torch.data.api import eventserver
    from predictionio_tpu_torch.data.storage import base

    for key in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(key)
    t0 = dt.datetime(2024, 5, 1, tzinfo=dt.timezone.utc)
    batch = [{"event": "rate", "entityType": "user", "entityId": f"u{i % 4}",
              "targetEntityType": "item", "targetEntityId": f"i{i}",
              "properties": {"rating": 1 + i % 5},
              "eventTime": (t0 + dt.timedelta(seconds=i)).isoformat()} for i in range(12)]
    batch.insert(5, {"event": "rate"})  # no entity: 400 for this item alone
    answers = {}
    _event_store(jax_storage, jax_base, tmp_path / "jax", monkeypatch)
    ref = jax_eventserver.create_event_server(host="127.0.0.1", port=0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", ref.port, timeout=WAIT_S)
        conn.request("POST", "/batch/events.json?accessKey=fe-key", json.dumps(batch),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        answers["jax"] = resp.status, [r["status"] for r in json.loads(resp.read())]
        conn.close()
    finally:
        ref.stop()
        jax_storage.reset()
    _event_store(storage, base, tmp_path / "port", monkeypatch)
    handle = eventserver.create_multiproc_event_server(
        host="127.0.0.1", port=0,
        frontend_config=FrontendConfig(workers=2, dispatch="sync", max_inflight=32,
                                       stats_flush_s=0.02, spawn_timeout_s=WAIT_S))
    try:
        conn = http.client.HTTPConnection("127.0.0.1", handle.port, timeout=WAIT_S)
        conn.request("POST", "/batch/events.json?accessKey=fe-key", json.dumps(batch),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        answers["port"] = resp.status, [r["status"] for r in json.loads(resp.read())]
        conn.close()
    finally:
        handle.stop()
    assert answers["port"] == answers["jax"]
    assert answers["port"][1].count(201) == 12
    app_id = storage.get_meta_data_apps().get_by_name("FeApp").id
    stored = list(storage.get_l_events().find(app_id=app_id))
    assert sorted(e.target_entity_id for e in stored) == sorted(f"i{i}" for i in range(12))
    storage.reset()


def _cli(args, env):
    """A verb of the port's CLI in its own process, and the port it
    printed on its first line."""
    proc = subprocess.Popen([sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *args],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line:
        proc.kill()
        raise AssertionError(proc.communicate(timeout=WAIT_S)[1])
    return proc, int(line.split("http://", 1)[1].split()[0].rsplit(":", 1)[1])


@pytest.mark.parametrize("tier", [["--frontend-workers", "2"], ["--scorer-shards", "2"]],
                         ids=["frontend-workers", "scorer-shards"])
def test_deploy_command_line_tiers(published, tier):
    """``deploy --frontend-workers 2`` and ``deploy --scorer-shards 2``
    through the command line (``--device cpu``): both answer version 1
    as the unbatched server does, and ``POST /stop`` ends the process."""
    engine_json, variant, _ = published
    env = dict(os.environ, PYTHONPATH=REPO)
    proc, port = _cli(["deploy", "--variant", engine_json, "--device", "cpu", "--port", "0",
                       "--model-version", "1", *tier], env)
    single = Single(variant, 1)
    try:
        qs = queries()[:12]
        assert concurrent(port, qs, clients=4) == single.answers(qs)
        assert post(port, {}, path="/stop")[0] == 200
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        single.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)


def test_eventserver_command_line_frontend_workers(tmp_path, monkeypatch):
    """``eventserver --frontend-workers 2`` through the command line
    stores what it acknowledges, and stops on SIGINT."""
    for key in [k for k in os.environ if k.startswith("PIO_STORAGE_")]:
        monkeypatch.delenv(key)
    from predictionio_tpu_torch.data.storage import base

    _event_store(storage, base, tmp_path, monkeypatch)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc, port = _cli(["eventserver", "--ip", "127.0.0.1", "--port", "0",
                       "--frontend-workers", "2"], env)
    try:
        event = {"event": "rate", "entityType": "user", "entityId": "u1",
                 "targetEntityType": "item", "targetEntityId": "i1",
                 "properties": {"rating": 4}}
        status, body, _ = post(port, event, path="/events.json?accessKey=fe-key")
        assert status == 201, body
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
    storage.reset()
    app_id = storage.get_meta_data_apps().get_by_name("FeApp").id
    stored = list(storage.get_l_events().find(app_id=app_id))
    assert [e.entity_id for e in stored] == ["u1"]
    storage.reset()
