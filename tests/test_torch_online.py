"""The port's continuous learning against the JAX package's, on the CPU.

``pio retrain --follow``: events acknowledged into the WAL by the event
server, the follower's tail, the snapshot refresh, the fold-in of the
touched users (kernel B1 on the card; its plain version here), the
registry publish and the hot swap of a running query server. Held to the
reference:

- ``fold_in_als_model`` equals the JAX package's on the same snapshot
  and base factors -- its Pallas kernel in interpret mode and its "xla"
  path, explicit and implicit, with new users and items -- within 1e-4,
  the f32 bar of ``tests/test_torch_als.py``; each folded row is also
  within 1e-4 of the closed-form ridge solve, the bar of
  ``tests/test_online.py``; untouched rows stay bit-equal and new item
  rows are zero;
- the staleness budget raises at the reference's thresholds, before any
  solve; ``ALSAlgorithm.fold_in`` equals the reference's;
- ``RetrainLoop.run_once`` end to end (WAL event server -> "foldin" ->
  registry v1 -> a query server swapped to it, answering as the folded
  model, which equals the reference's fold), idle, deferred, GC-gap and
  budget escalations, a failure between fold and publish that replays to
  the same factors, and a failed partition isolated;
- a swap under four concurrent query threads drops no request and mixes
  no versions; ``pio deploy --model-version`` serves a pinned version
  and fails with the registry's message on a missing or corrupt one;
- the registry the port publishes validates under the JAX
  ``ModelRegistry`` (manifest, CRC).

The card tests (marker ``cuda``) hold the loop's fold-in to one B1
launch equal to the "xla" path within 1e-4, and a swapped mips deploy to
B2 launches.
"""

import dataclasses
import datetime as dt
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import requests
import torch

from predictionio_tpu.online import foldin as jax_foldin
from predictionio_tpu.online.registry import ModelRegistry as JaxModelRegistry
from predictionio_tpu.parallel.als import ALSConfig as JaxALSConfig
from predictionio_tpu.parallel.als import ALSModel as JaxALSModel
from predictionio_tpu.workflow.json_extractor import (
    load_engine_variant as jax_load_engine_variant,
)
from predictionio_tpu_torch.controller.base import Params
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.ingest import wal_payload
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.data.wal import PartitionedWal, WriteAheadLog, _segment_name
from predictionio_tpu_torch.models.recommendation import ALSAlgorithm
from predictionio_tpu_torch.models.recommendation.convert import model_from_arrays
from predictionio_tpu_torch.online import foldin
from predictionio_tpu_torch.online.loop import RetrainConfig, RetrainLoop
from predictionio_tpu_torch.online.registry import ModelRegistry, RegistryError
from predictionio_tpu_torch.parallel.als import ALSConfig, ALSModel
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow.core_workflow import run_train
from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401
from test_torch_store_train import one_blob, one_model

ATOL = 1e-4
APP = "OnlineApp"
ALGO = {"rank": 4, "numIterations": 2, "seed": 7, "checkpointInterval": 0}
TEMPLATE_OF = {"als": "recommendation", "ncf": "ncf"}


# ---------------------------------------------------------------------------
# fold-in parity
# ---------------------------------------------------------------------------

class FakeSnapshot:
    """Snapshot-shaped columns + vocabs (``data/snapshot.Snapshot``'s
    read surface), shared as is by both packages' folds."""

    def __init__(self, users, items, times, ratings, uvocab, ivocab):
        self._cols = {
            "users": np.asarray(users, np.int64), "items": np.asarray(items, np.int64),
            "names": np.zeros(len(users), np.int32),
            "times": np.asarray(times, np.float64),
            "ratings": np.asarray(ratings, np.float64),
        }
        self._vocabs = {"users": list(uvocab), "items": list(ivocab), "names": ["rate"]}
        self.manifest = {"until_ms": int(max(times, default=0) * 1000) + 1}

    def column(self, name):
        return self._cols[name]

    def vocab(self, which):
        return self._vocabs[which]

    def __len__(self):
        return len(self._cols["users"])


def fold_case(seed=0, known_users=12, known_items=8, rank=4):
    """Base factors of known users/items, and a snapshot whose vocab
    order differs from the model's, with history before the window,
    window rows from known and new users on known and new items, a rating
    left absent (NaN: scored 1.0) and a user touched only by the WAL."""
    rng = np.random.default_rng(seed)
    user_ids = [f"u{k}" for k in range(known_users)]
    item_ids = [f"i{k}" for k in range(known_items)]
    uf = rng.normal(size=(known_users, rank)).astype(np.float32)
    itf = rng.normal(size=(known_items, rank)).astype(np.float32)
    uvocab = list(rng.permutation(user_ids + ["n0", "n1"]))
    ivocab = list(rng.permutation(item_ids + ["j0"]))
    window_ms = 1_700_000_000_000
    rows = []
    for k in range(120):  # history
        rows.append((f"u{rng.integers(0, known_users)}", f"i{rng.integers(0, known_items)}",
                     window_ms / 1000 - 100 + k * 0.5, float(rng.integers(1, 6))))
    for k, user in enumerate(["u2", "u5", "n0", "n1", "u5", "n0", "u9"]):
        item = "j0" if k in (2, 4) else f"i{rng.integers(0, known_items)}"
        rows.append((user, item, window_ms / 1000 + 1 + k,
                     np.nan if k == 3 else float(rng.integers(1, 6))))
    snap = FakeSnapshot(
        [uvocab.index(u) for u, _, _, _ in rows], [ivocab.index(i) for _, i, _, _ in rows],
        [t for _, _, t, _ in rows], [r for _, _, _, r in rows], uvocab, ivocab)
    base = dict(user_index={u: k for k, u in enumerate(user_ids)}, item_ids=item_ids,
                item_index={i: k for k, i in enumerate(item_ids)})
    return uf, itf, base, snap, window_ms, rows


PERMISSIVE = dict(max_touched_frac=1.0, max_item_growth_frac=1.0, max_user_growth_frac=10.0)


@pytest.mark.parametrize("reference_solver", ["pallas", "xla"])
@pytest.mark.parametrize("implicit", [False, True])
def test_fold_in_als_model_equals_the_reference(implicit, reference_solver):
    uf, itf, base, snap, window_ms, rows = fold_case(seed=3 + implicit)
    params = dict(rank=4, reg=0.1, alpha=5.0, implicit=implicit)
    jax_out = jax_foldin.fold_in_als_model(
        JaxALSModel(user_factors=uf, item_factors=itf), delta=jax_foldin.FoldinDelta(
            snap, window_ms, touched_user_ids={"u7"},
            budget=jax_foldin.StalenessBudget(**PERMISSIVE)),
        config=JaxALSConfig(solver=reference_solver, **params), **base)
    out = foldin.fold_in_als_model(
        ALSModel(user_factors=uf, item_factors=itf), delta=foldin.FoldinDelta(
            snap, window_ms, touched_user_ids={"u7"},
            budget=foldin.StalenessBudget(**PERMISSIVE)),
        config=ALSConfig(solver="auto", **params), device="cpu", **base)
    np.testing.assert_allclose(out.als.user_factors, jax_out.als.user_factors,
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out.als.item_factors, jax_out.als.item_factors)
    assert (out.user_index, out.item_ids, out.item_index) == (
        jax_out.user_index, jax_out.item_ids, jax_out.item_index)
    assert (out.touched_users, out.new_users, out.new_items, out.max_window_ms) == (
        jax_out.touched_users, jax_out.new_users, jax_out.new_items,
        jax_out.max_window_ms) == (6, 2, 1, window_ms + 7000)
    np.testing.assert_array_equal(out.window_pairs, jax_out.window_pairs)
    # untouched rows bit-equal to the base; the new item row is zero
    touched = {"u2", "u5", "u7", "u9", "n0", "n1"}
    for uid, row in base["user_index"].items():
        if uid not in touched:
            np.testing.assert_array_equal(out.als.user_factors[row], uf[row])
    assert not out.als.item_factors[out.item_index["j0"]].any()
    # each folded row is the closed-form ridge solution (tests/test_online.py)
    yty = out.als.item_factors.T @ out.als.item_factors
    for uid in touched:
        hist = [(out.item_index[i], 1.0 if np.isnan(r) else r)
                for u, i, _, r in rows if u == uid]
        y = out.als.item_factors[[i for i, _ in hist]].astype(np.float64)
        v = np.asarray([r for _, r in hist])
        if implicit:
            c1 = params["alpha"] * v
            gram = yty + (y * c1[:, None]).T @ y + params["reg"] * np.eye(4)
            rhs = y.T @ (1.0 + c1)
        else:
            gram = y.T @ y + params["reg"] * len(hist) * np.eye(4)
            rhs = y.T @ v
        np.testing.assert_allclose(out.als.user_factors[out.user_index[uid]],
                                   np.linalg.solve(gram, rhs), atol=ATOL, rtol=0)


def test_budget_raises_at_the_reference_thresholds(monkeypatch):
    cases = [(4, 10, 1, 0, 10), (6, 10, 0, 0, 10), (1, 10, 0, 2, 10), (1, 10, 6, 0, 10),
             (2, 10, 0, 1, 10), (0, 0, 0, 0, 0)]
    budgets = [dict(max_touched_frac=0.5, max_item_growth_frac=0.1), {}]

    def outcome(module, budget, case):
        try:
            module.StalenessBudget(**budget).check(*case)
        except module.StalenessExceeded as exc:
            return exc.reason
        return None

    passes = [[True, False, False, False, True, True],
              [False, False, False, False, False, True]]
    for budget, want in zip(budgets, passes):
        got = [outcome(foldin, budget, c) for c in cases]
        assert got == [outcome(jax_foldin, budget, c) for c in cases]
        assert [g is None for g in got] == want
    # the budget is checked before any solve
    uf, itf, base, snap, window_ms, _ = fold_case()
    monkeypatch.setattr(foldin, "fold_in_users",
                        lambda *a, **k: pytest.fail("solved past the budget"))
    with pytest.raises(foldin.StalenessExceeded, match="touched-user fraction"):
        foldin.fold_in_als_model(
            ALSModel(user_factors=uf, item_factors=itf),
            delta=foldin.FoldinDelta(snap, window_ms,
                                     budget=foldin.StalenessBudget(max_touched_frac=0.1)),
            config=ALSConfig(rank=4), device="cpu", **base)


def test_algorithm_fold_in_equals_the_reference():
    """``ALSAlgorithm.fold_in``: a NEW model (the old one intact) whose
    trained-in seen map absorbed the window's pairs, as the reference's;
    None for an empty window."""
    from predictionio_tpu.controller.base import Params as JaxParams
    from predictionio_tpu.models._als_common import build_seen as jax_build_seen
    from predictionio_tpu.models.recommendation.engine import (
        ALSAlgorithm as JaxALSAlgorithm,
    )
    from predictionio_tpu.models.recommendation.engine import (
        RecommendationModel as JaxRecommendationModel,
    )

    uf, itf, base, snap, window_ms, _ = fold_case(seed=9)
    seen_u, seen_i = np.arange(12), np.arange(12) % 8
    model = model_from_arrays(uf, itf, list(base["user_index"]), base["item_ids"],
                              seen_u, seen_i, app_name=APP, event_names=["rate"])
    jax_model = JaxRecommendationModel(
        als=JaxALSModel(user_factors=uf, item_factors=itf), seen=jax_build_seen(seen_u, seen_i),
        seen_mode="model", app_name=APP, event_names=["rate"], **base)
    params = {"rank": 4, "lambda": 0.1, "alsSolver": "xla"}
    delta = dict(snapshot=snap, window_start_ms=window_ms)
    out = ALSAlgorithm(Params(params), device="cpu").fold_in(
        model, foldin.FoldinDelta(budget=foldin.StalenessBudget(**PERMISSIVE), **delta))
    jax_out = JaxALSAlgorithm(JaxParams(params)).fold_in(
        jax_model, jax_foldin.FoldinDelta(budget=jax_foldin.StalenessBudget(**PERMISSIVE),
                                          **delta))
    assert out is not model and "n0" not in model.user_index and model.seen == jax_model.seen
    assert out.seen == jax_out.seen and out.seen != model.seen
    assert (out.user_index, out.item_ids) == (jax_out.user_index, jax_out.item_ids)
    np.testing.assert_allclose(out.als.user_factors, jax_out.als.user_factors,
                               atol=ATOL, rtol=0)
    empty = FakeSnapshot([], [], [], [], list(base["user_index"]), base["item_ids"])
    assert ALSAlgorithm(Params(params), device="cpu").fold_in(
        model, foldin.FoldinDelta(empty, window_ms)) is None


# ---------------------------------------------------------------------------
# the loop, the registry, the swap
# ---------------------------------------------------------------------------

@pytest.fixture()
def basedir(tmp_path, monkeypatch):
    """A fresh ``PIO_FS_BASEDIR`` for both packages' registries."""
    for key in [k for k in os.environ
                if k.startswith(("PIO_STORAGE_", "PIO_SNAPSHOT", "PIO_REGISTRY",
                                 "PIO_ONLINE_TEST"))]:
        monkeypatch.delenv(key)
    monkeypatch.setenv("PIO_FS_BASEDIR", str(tmp_path))
    from predictionio_tpu.data import storage as jax_storage

    storage.reset()
    jax_storage.reset()
    yield tmp_path
    storage.reset()
    jax_storage.reset()


def trained_variant(tmp_path, app=APP, items=10, n=300, algorithm="als", **engine):
    """An app with ``n`` rate events an hour old, and an engine instance
    of the ``algorithm``'s template (default: recommendation, ``ALGO``
    with ``engine`` over it) trained from it by the port, on the CPU.
    Returns the engine.json path."""
    app_id = storage.get_meta_data_apps().insert(App(name=app))
    le = storage.get_l_events()
    le.init_channel(app_id)
    rng = np.random.default_rng(3)
    start = dt.datetime.now(dt.timezone.utc) - dt.timedelta(hours=1)
    le.batch_insert([
        Event(event="rate", entity_type="user", entity_id=f"u{rng.integers(0, 20)}",
              target_entity_type="item", target_entity_id=f"i{rng.integers(0, items)}",
              properties=DataMap({"rating": float(rng.integers(1, 6))}),
              event_time=start + dt.timedelta(milliseconds=11 * k))
        for k in range(n)
    ], app_id)
    path = tmp_path / f"engine-{algorithm}.json"
    path.write_text(json.dumps({
        "id": f"online-{algorithm}",
        "engineFactory": f"predictionio_tpu.models.{TEMPLATE_OF[algorithm]}.engine_factory",
        "datasource": {"params": {"appName": app}},
        "algorithms": [{"name": algorithm,
                        "params": {**(ALGO if algorithm == "als" else {}), **engine}}],
    }))
    run_train(load_engine_variant(str(path)), device="cpu")
    return str(path)


def ingest_via_wal(wal, user, item, rating=5.0, event_time=None, app_id=1):
    """The event server's durable cycle, inlined: WAL append + fsync ->
    storage flush -> checkpoint. Returns the record's seqno."""
    event = Event(event="rate", entity_type="user", entity_id=user,
                  target_entity_type="item", target_entity_id=item,
                  properties=DataMap({"rating": rating}),
                  **({"event_time": event_time} if event_time else {})).with_id()
    seqno = wal.append(wal_payload(event, app_id, None))
    wal.sync()
    storage.get_l_events().insert_batch([(event, app_id, None)], on_duplicate="ignore")
    wal.checkpoint(seqno)
    return seqno


def new_loop(engine_json, tmp_path, notify=(), **config):
    return RetrainLoop(
        load_engine_variant(engine_json),
        RetrainConfig(notify_urls=list(notify), wal_dir=str(tmp_path / "wal"), **config),
        device="cpu",
    )


class Served:
    """A port query server of ``engine_json`` in a thread."""

    def __init__(self, engine_json, **kwargs):
        self.server, self.service = cli.build_query_server(
            engine_json, port=0, device="cpu", **kwargs)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def post(self, path, obj):
        r = requests.post(f"{self.url}{path}", json=obj, timeout=60)
        return r.status_code, r.headers.get("x-pio-model-version"), r.json()

    def version(self):
        return requests.get(f"{self.url}/", timeout=60).json()["modelVersion"]

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_retrain_loop_end_to_end(basedir):
    """Events through the WAL event server fold in (one cycle, "foldin"),
    publish registry version 1 and swap a running query server to it,
    which answers as the folded model; the fold equals the JAX package's
    on the same snapshot (its Pallas kernel, interpret mode) within 1e-4;
    an idle cycle moves nothing; the budget escalates to a full retrain
    (version 2); a swap back to version 1 answers as before, a missing
    version answers 404 and the old epoch keeps serving; the JAX
    registry reads what the port published."""
    from predictionio_tpu_torch.data.api.eventserver import create_event_server
    from predictionio_tpu_torch.data.storage.base import AccessKey
    from predictionio_tpu_torch.data.wal import read_checkpoint

    engine_json = trained_variant(basedir)
    storage.get_meta_data_access_keys().insert(AccessKey(key="k", app_id=1))
    events = create_event_server(host="127.0.0.1", port=0, ingest_mode="wal").start()
    served = Served(engine_json)
    try:
        # the WAL directory is the event server's default, $PIO_FS_BASEDIR/wal
        loop = RetrainLoop(load_engine_variant(engine_json),
                           RetrainConfig(notify_urls=[served.url]), device="cpu")
        assert loop.run_once() == "idle" and served.version() is None
        batch = [{"event": "rate", "entityType": "user", "entityId": user,
                  "targetEntityType": "item", "targetEntityId": item,
                  "properties": {"rating": 4}}
                 for user, item in [("u1", "i3"), ("u4", "i0"), ("fresh", "i2"),
                                    ("fresh", "i5"), ("u1", "i9")]]
        r = requests.post(f"http://127.0.0.1:{events.port}/batch/events.json",
                          params={"accessKey": "k"}, json=batch, timeout=60)
        assert [x["status"] for x in r.json()] == [201] * 5
        deadline = time.time() + 30  # the ack is the fsync; wait for the flush
        while read_checkpoint(str(basedir / "wal")) < 5 and time.time() < deadline:
            time.sleep(0.02)
        captured = {}
        fold = loop.algorithms[0].fold_in

        def spy(model, delta):
            captured.update(model=model, delta=delta)
            return fold(model, delta)

        loop.algorithms[0].fold_in = spy
        assert loop.run_once() == "foldin"
        assert loop.cursor.seqno == 5 and loop.current_version == 1
        assert served.version() == 1
        v1 = loop.registry.latest()
        assert (v1.version, v1.source, v1.manifest["records"]) == (1, "foldin", 5)
        # the fold equals the reference's on the same snapshot and base
        base, delta = captured["model"], captured["delta"]
        config = loop.algorithms[0]._config()
        jax_out = jax_foldin.fold_in_als_model(
            JaxALSModel(user_factors=base.als.user_factors,
                        item_factors=base.als.item_factors),
            base.user_index, base.item_ids, base.item_index,
            jax_foldin.FoldinDelta(delta.snapshot, delta.window_start_ms,
                                   touched_user_ids=delta.touched_user_ids),
            JaxALSConfig(rank=config.rank, reg=config.reg, alpha=config.alpha,
                         implicit=config.implicit, solver="pallas"))
        np.testing.assert_allclose(loop.models[0].als.user_factors, jax_out.als.user_factors,
                                   atol=ATOL, rtol=0)
        assert loop.models[0].user_index == jax_out.user_index
        # the swapped server answers as the folded model
        algorithm = ALSAlgorithm(Params(ALGO), device="cpu")
        queries = [{"user": "fresh", "num": 4}, {"user": "u1", "num": 3},
                   {"user": "u7", "num": 5}]
        v1_answers = []
        for q in queries:
            status, header, body = served.post("/queries.json", q)
            assert (status, header) == (200, "1")
            assert body == algorithm.predict(loop.models[0], q)
            v1_answers.append(body)
        assert v1_answers[0]["itemScores"]
        # idle: nothing new, nothing moves
        assert loop.run_once() == "idle"
        assert (loop.cursor.seqno, loop.registry.latest().version) == (5, 1)
        # the JAX registry reads (and CRC-checks) the port's version
        jax_registry = JaxModelRegistry.for_variant(jax_load_engine_variant(engine_json))
        assert jax_registry.dir == loop.registry.dir
        assert jax_registry.latest().load_blob() == v1.load_blob()
        assert jax_registry.get(1).manifest == v1.manifest
        # past the budget: a full retrain from the store, version 2
        loop.config.budget = foldin.StalenessBudget(max_touched_frac=0.0)
        r = requests.post(f"http://127.0.0.1:{events.port}/events.json",
                          params={"accessKey": "k"}, json=batch[1], timeout=60)
        assert r.status_code == 201
        deadline = time.time() + 30
        while read_checkpoint(str(basedir / "wal")) < 6 and time.time() < deadline:
            time.sleep(0.02)
        assert loop.run_once() == "full_retrain"
        v2 = loop.registry.latest()
        assert (v2.version, v2.source, v2.instance_id) == (2, "train", loop.instance.id)
        assert served.version() == 2 and loop.cursor.seqno == 6
        # rollback, then a swap to a version that does not exist
        assert served.post("/models/swap", {"version": 1})[0] == 200
        for q, want in zip(queries, v1_answers):
            assert served.post("/queries.json", q)[1:] == ("1", want)
        status, _, body = served.post("/models/swap", {"version": 99})
        assert status == 404 and "not found" in body["message"]
        assert served.post("/queries.json", queries[0])[1:] == ("1", v1_answers[0])
        assert served.post("/models/lag", {"foldinLagSeconds": 1.5})[0] == 200
        assert loop.cycles["foldin"] == 1 and loop.cycles["full_retrain"] == 1
    finally:
        served.close()
        events.stop()


def test_loop_edges(basedir, monkeypatch):
    """Another app's record is skipped past (idle); a future-dated record
    defers, then folds; a failure between fold and publish publishes
    nothing, holds the cursor, and the next run replays the window to the
    same factors; a WAL GC gap holds still without escalation, and
    retrains in full with it."""
    engine_json = trained_variant(basedir)
    wal = WriteAheadLog(str(basedir / "wal"))
    loop = new_loop(engine_json, basedir)
    seqno = ingest_via_wal(wal, "other", "i1", app_id=2)
    assert loop.run_once() == "idle" and loop.cursor.seqno == seqno
    future = dt.datetime.now(dt.timezone.utc) + dt.timedelta(seconds=1.5)
    seqno = ingest_via_wal(wal, "skewuser", "i1", event_time=future)
    assert loop.run_once() == "deferred" and loop.cursor.seqno < seqno
    time.sleep(1.6)
    assert loop.run_once() == "foldin" and loop.cursor.seqno == seqno
    first = loop.registry.latest()

    seqno = ingest_via_wal(wal, "crashuser", "i2")
    folded = {}
    fold = loop.algorithms[0].fold_in
    loop.algorithms[0].fold_in = lambda m, d: folded.setdefault("model", fold(m, d))
    monkeypatch.setattr(loop, "_test_hold",
                        lambda: (_ for _ in ()).throw(RuntimeError("killed")))
    with pytest.raises(RuntimeError, match="killed"):
        loop.run_once()
    assert loop.registry.latest().version == first.version
    assert new_loop(engine_json, basedir).cursor.seqno < seqno
    replay = new_loop(engine_json, basedir)
    assert replay.run_once() == "foldin" and replay.cursor.seqno == seqno
    np.testing.assert_array_equal(replay.models[0].als.user_factors,
                                  folded["model"].als.user_factors)
    assert replay.models[0].user_index == folded["model"].user_index
    wal.close()

    # a GC gap: the oldest retained record is newer than the cursor
    for name in os.listdir(basedir / "wal"):
        if name.endswith(".log"):
            os.rename(basedir / "wal" / name, basedir / "wal" / _segment_name(50))
    (basedir / "wal" / "wal.ckpt").write_text("60")
    stuck = new_loop(engine_json, basedir, allow_full_retrain=False)
    before = (stuck.cursor.seqno, stuck.registry.latest().version)
    assert stuck.run_once() == "noop"
    assert (stuck.cursor.seqno, stuck.registry.latest().version) == before
    assert new_loop(engine_json, basedir).run_once() == "full_retrain"
    assert ModelRegistry.for_variant(load_engine_variant(engine_json)).latest().source == "train"


def test_failed_partition_is_isolated(basedir, monkeypatch):
    """P = 2: a partition whose poll fails (``PIO_ONLINE_TEST_FAIL_PART``)
    holds its cursor while the other folds and publishes; once it
    recovers its window folds too, and a restart finds nothing pending."""
    from predictionio_tpu_torch.data.ingest import partition_of

    engine_json = trained_variant(basedir)
    wal = PartitionedWal(str(basedir / "wal"), partitions=2)
    users = {}
    for k in range(40):
        users.setdefault(partition_of(Event(event="rate", entity_type="user",
                                            entity_id=f"p{k}"), 2), f"p{k}")
    seqnos = {part: ingest_via_wal(wal.part(part), user, "i3")
              for part, user in users.items()}
    wal.close()
    loop = new_loop(engine_json, basedir)
    assert loop.partitions == 2
    monkeypatch.setenv("PIO_ONLINE_TEST_FAIL_PART", "1")
    assert loop.run_once() == "foldin"
    assert [c.seqno for c in loop.cursors] == [seqnos[0], 0]
    # the held partition's records are in this publish only because the
    # SQL-exact snapshot already holds them; its change detection replays
    assert users[0] in loop.models[0].user_index
    assert loop.cycles["part_failures"] == 1
    generation = loop.registry.latest().version
    monkeypatch.delenv("PIO_ONLINE_TEST_FAIL_PART")
    assert loop.run_once() == "foldin"
    assert [c.seqno for c in loop.cursors] == [seqnos[0], seqnos[1]]
    assert users[1] in loop.models[0].user_index
    assert loop.registry.latest().version > generation
    # a restarted follower reads both cursors and finds nothing pending
    restarted = new_loop(engine_json, basedir)
    assert [c.seqno for c in restarted.cursors] == [seqnos[0], seqnos[1]]
    assert restarted.run_once() == "idle"


def _publish_scaled_versions(engine_json, scales):
    """One registry version per scale of the trained model's user
    factors (distinct answers per version), and the expected answers."""
    from predictionio_tpu_torch.workflow.core_workflow import load_instance_models

    variant = load_engine_variant(engine_json)
    _, [model] = load_instance_models(variant)
    registry = ModelRegistry.for_variant(variant)
    algorithm = ALSAlgorithm(Params(ALGO), device="cpu")
    expected = {}
    for scale in scales:
        scaled = dataclasses.replace(model, als=ALSModel(
            user_factors=model.als.user_factors * scale, item_factors=model.als.item_factors))
        v = registry.publish(one_blob("recommendation", scaled), meta={
            "source": "test", "engine_params": variant.engine_params.to_json_obj()})
        expected[v.version] = {u: algorithm.predict(scaled, {"user": u, "num": 3})
                               for u in ("u0", "u1", "u2", "u3")}
    return registry, expected


def test_swap_under_concurrent_queries(basedir):
    """Four client threads query across three hot swaps: no request
    fails or drops, and every answer is the one its version (the
    ``x-pio-model-version`` header) computes: no mixed epoch."""
    engine_json = trained_variant(basedir)
    _, expected = _publish_scaled_versions(engine_json, [1.0, 2.0, 3.0, 4.0])
    served = Served(engine_json, model_version=1)
    stop = threading.Event()
    results, errors = [], []

    def client(k):
        user = f"u{k}"
        with requests.Session() as http:
            while not stop.is_set():
                try:
                    r = http.post(f"{served.url}/queries.json",
                                  json={"user": user, "num": 3}, timeout=60)
                    if r.status_code != 200:
                        errors.append(r.status_code)
                    else:
                        results.append((int(r.headers["x-pio-model-version"]), user, r.json()))
                except Exception as exc:
                    errors.append(repr(exc))

    clients = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the epoch reads and the swaps finely
    try:
        for c in clients:
            c.start()
        for target in (2, 3, 4):
            time.sleep(0.3)
            status, _, body = served.post("/models/swap", {"version": target})
            assert status == 200 and body["modelVersion"] == target
        time.sleep(0.3)
    finally:
        stop.set()
        for c in clients:
            c.join(timeout=60)
        sys.setswitchinterval(interval)
        served.close()
    assert not any(c.is_alive() for c in clients)
    assert not errors and len(results) > 20
    for version, user, body in results:
        assert body == expected[version][user]
    assert len({v for v, _, _ in results}) >= 3


def test_deploy_model_version(basedir, capsys):
    """``deploy --model-version N`` serves version N (info and header);
    a missing or corrupt version exits with the registry's message."""
    engine_json = trained_variant(basedir)
    registry, expected = _publish_scaled_versions(engine_json, [1.0, 2.0])
    served = Served(engine_json, model_version=1)
    try:
        assert served.version() == 1
        assert served.post("/queries.json", {"user": "u2", "num": 3})[1:] == (
            "1", expected[1]["u2"])
    finally:
        served.close()
    argv = ["deploy", "--variant", engine_json, "--device", "cpu", "--port", "0"]
    with pytest.raises(SystemExit, match="model version 9 not found"):
        cli.main(argv + ["--model-version", "9"])
    with open(os.path.join(registry.get(2).path, "model.bin"), "r+b") as f:
        f.write(b"\xff")
    with pytest.raises(SystemExit, match="CRC mismatch"):
        cli.main(argv + ["--model-version", "2"])
    with pytest.raises(RegistryError, match="CRC mismatch"):
        cli.build_query_server(engine_json, model_version=2, device="cpu")


def test_retrain_command_line(basedir, monkeypatch, capsys):
    """``retrain --notify ''`` (batch mode) runs one cycle through the
    command line and publishes; ``--scorer-shards 2`` also publishes two
    per-shard blobs, each holding its shard's users; without a card and
    without ``--device cpu`` it raises."""
    engine_json = trained_variant(basedir)
    wal = WriteAheadLog(str(basedir / "wal"))
    ingest_via_wal(wal, "cliuser", "i4")
    wal.close()
    argv = ["retrain", "--variant", engine_json, "--notify", ""]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert "foldin=1" in capsys.readouterr().out
    latest = ModelRegistry.for_variant(load_engine_variant(engine_json)).latest()
    assert latest.version == 1
    model = one_model("recommendation", latest.load_blob())
    assert "cliuser" in model.user_index
    wal = WriteAheadLog(str(basedir / "wal"))
    ingest_via_wal(wal, "cliuser2", "i5")
    wal.close()
    assert cli.main(argv + ["--device", "cpu", "--scorer-shards", "2"]) == 0
    assert "foldin=1" in capsys.readouterr().out
    latest = ModelRegistry.for_variant(load_engine_variant(engine_json)).latest()
    assert latest.version == 2 and latest.shard_count == 2
    full = one_model("recommendation", latest.load_blob())
    owned = [set(one_model("recommendation", latest.load_blob(shard=k)).user_index)
             for k in range(2)]
    assert owned[0] | owned[1] == set(full.user_index) and not owned[0] & owned[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)


def test_templates_without_a_fold_in_hook(basedir):
    """As in the reference: NCF's loop follows the WAL but, with no
    ``fold_in``, escalates every window to a full retrain; SASRec's
    datasource describes no interaction scan to follow, so its loop is
    refused."""
    ncf_json = trained_variant(basedir, algorithm="ncf", embedDim=4, hidden=[8, 4],
                               epochs=1, batchSize=64, checkpoint=False)
    wal = WriteAheadLog(str(basedir / "wal"))
    seqno = ingest_via_wal(wal, "ncfuser", "i2")
    wal.close()
    loop = new_loop(ncf_json, basedir)
    assert not loop.algorithms[0].supports_fold_in
    assert loop.run_once() == "full_retrain" and loop.cursor.seqno == seqno
    assert "ncfuser" in loop.models[0].user_index
    assert loop.registry.latest().source == "train"
    seq_json = str(basedir / "engine-sasrec.json")
    with open(seq_json, "w") as f:
        json.dump({"id": "online-sasrec", "datasource": {"params": {"appName": APP}},
                   "preparator": {"params": {"maxLen": 8}},
                   "algorithms": [{"name": "sasrec", "params": {
                       "embedDim": 8, "numHeads": 1, "numBlocks": 1, "ffnDim": 8,
                       "epochs": 1, "batchSize": 32}}]}, f)
    run_train(load_engine_variant(seq_json), device="cpu")
    with pytest.raises(ValueError, match="exposes no online handle"):
        new_loop(seq_json, basedir)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_loop_fold_in_launches_b1_once_on_card(basedir):
    """On ``cuda`` one fold-in cycle is one B1 launch, and the folded
    rows equal the unfused "xla" path on the card within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from predictionio_tpu_torch.ops import als_gram

    engine_json = trained_variant(basedir)
    wal = WriteAheadLog(str(basedir / "wal"))
    for user, item in [("u1", "i2"), ("cardnew", "i4"), ("u3", "i9")]:
        ingest_via_wal(wal, user, item)
    wal.close()
    loop = RetrainLoop(load_engine_variant(engine_json),
                       RetrainConfig(wal_dir=str(basedir / "wal")), device="cuda")
    captured = {}
    fold = loop.algorithms[0].fold_in

    def spy(model, delta):
        captured["delta"] = delta
        return fold(model, delta)

    loop.algorithms[0].fold_in = spy
    before = als_gram.gram_rhs.launches
    assert loop.run_once() == "foldin"
    assert als_gram.gram_rhs.launches == before + 1
    xla = foldin.fold_in_als_model(
        ALSModel(user_factors=loop.models[0].als.user_factors,
                 item_factors=loop.models[0].als.item_factors),
        loop.models[0].user_index, loop.models[0].item_ids, loop.models[0].item_index,
        captured["delta"], dataclasses.replace(loop.algorithms[0]._config(), solver="xla"),
        device="cuda")
    np.testing.assert_allclose(loop.models[0].als.user_factors, xla.als.user_factors,
                               atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_swapped_mips_deploy_launches_b2_on_card(basedir):
    """A deploy with ``retrieval: mips`` swapped to a registry version
    answers through B2 (stage 1 runs past 512 items)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from predictionio_tpu_torch.ops import mips

    engine_json = trained_variant(basedir, items=700, n=4000,
                                  retrieval={"mode": "mips"})
    _publish_scaled_versions(engine_json, [2.0])
    server, _ = cli.build_query_server(engine_json, port=0, device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert requests.post(f"{url}/models/swap", json={}, timeout=60).status_code == 200
        before = mips.mips_block_topk.launches
        r = requests.post(f"{url}/queries.json", json={"user": "u1", "num": 5}, timeout=60)
        assert r.status_code == 200 and r.headers["x-pio-model-version"] == "1"
        assert mips.mips_block_topk.launches > before
    finally:
        server.shutdown()
        server.server_close()
