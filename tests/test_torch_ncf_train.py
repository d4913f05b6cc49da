"""The port's NCF training and template against the JAX package, on the CPU.

``train_ncf`` starts from the JAX package's own initial weights (carried
across with ``params_from_flax``) and runs the reference's loop on a
one-device ``local_mesh(1, 1)``: the step losses agree within
``rtol=1e-5, atol=1e-4`` and the final params within ``atol=1e-4``, the
f32 bar of the reference's parity tests. Adam's first updates are
``lr * sign(g)``, so a gradient that cancels to about 0 could flip a
step between the frameworks; at these sizes none does, and no looser
bar is needed. Resume from the per-epoch checkpoint equals an
uninterrupted run exactly. A model trained by the JAX template answers
the same queries with the same items through the port, and the port's
``train`` and ``deploy`` verbs serve the NCF template over HTTP.
"""

import datetime as dt
import http.client
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams
from predictionio_tpu.data import DataMap, Event
from predictionio_tpu.data.storage.base import App
from predictionio_tpu.models.ncf import engine_factory
from predictionio_tpu.models.ncf.model import NCFConfig as JaxNCFConfig
from predictionio_tpu.models.ncf.model import NeuMF as JaxNeuMF
from predictionio_tpu.models.ncf.model import make_implicit_batches as jax_implicit_batches
from predictionio_tpu.models.ncf.model import train_ncf as jax_train_ncf
from predictionio_tpu.parallel.mesh import local_mesh
from predictionio_tpu.workflow.context import RuntimeContext
from predictionio_tpu_torch.controller.base import TrainContext
from predictionio_tpu_torch.models.ncf import (
    NCFAlgorithm,
    NCFPreparator,
    load_model,
    model_from_flax,
    save_model,
)
from predictionio_tpu_torch.models.ncf import engine as ncf_engine
from predictionio_tpu_torch.models.ncf.model import (
    NCFConfig,
    make_implicit_batches,
    params_from_flax,
    train_ncf,
)
from predictionio_tpu_torch.models.recommendation import RatingsData
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow.checkpoint import CheckpointManager
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

ALGO = {"embedDim": 8, "hidden": [16, 8], "epochs": 6, "batchSize": 32,
        "learningRate": 0.02, "seed": 1}


def ratings(seed=0, n_users=30, n_items=20, n=700):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n).astype(np.int32)
    items = rng.integers(0, n_items, n).astype(np.int32)
    return users, items, rng.integers(1, 6, n).astype(np.float32)


def flax_init(kw):
    """The JAX ``train_ncf``'s own initial params (its PRNGKey(seed) init)."""
    config = JaxNCFConfig(**kw)
    params = JaxNeuMF(config).init(
        jax.random.PRNGKey(config.seed), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32)
    )["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("implicit", [False, True])
def test_train_ncf_matches_the_jax_loop(implicit):
    kw = dict(num_users=30, num_items=20, embed_dim=8, hidden=(16, 8), epochs=2,
              batch_size=128, learning_rate=0.01, implicit=implicit, seed=4)
    users, items, labels = ratings()
    if implicit:
        users, items, labels = jax_implicit_batches(
            users, items, 20, 4, np.random.default_rng(4))
    jax_params, jax_losses = jax_train_ncf(
        JaxNCFConfig(**kw), users, items, labels, local_mesh(1, 1), log_every=1)
    state, losses = train_ncf(
        NCFConfig(**kw), users, items, labels, "cpu", log_every=1,
        init_state=params_from_flax(flax_init(kw)))
    steps = 2 * -(-users.size // 128)  # the short last batch is a step too
    assert len(losses) == len(jax_losses) == steps
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5, atol=1e-4)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jax_params))
    assert state.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(state[name].numpy(), want[name].numpy(), atol=1e-4)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    users, items, labels = ratings(seed=3)
    kw = dict(num_users=30, num_items=20, embed_dim=8, hidden=(16, 8),
              batch_size=64, learning_rate=0.02, seed=2)
    straight, _ = train_ncf(NCFConfig(epochs=5, **kw), users, items, labels, "cpu")
    ckpt = CheckpointManager(str(tmp_path / "ncf"))
    train_ncf(NCFConfig(epochs=3, **kw), users, items, labels, "cpu", checkpoint=ckpt)
    assert ckpt.latest_step() == 2
    resumed, _ = train_ncf(NCFConfig(epochs=5, **kw), users, items, labels, "cpu",
                           checkpoint=CheckpointManager(str(tmp_path / "ncf")))
    assert ckpt.latest_step() == 4
    for name in straight:
        np.testing.assert_array_equal(resumed[name].numpy(), straight[name].numpy())


class EpochLog:
    def __init__(self):
        self.epochs = []
        self.phases = []

    def record_epoch(self, epoch, seconds, losses):
        self.epochs.append((epoch, seconds, losses))

    def record_phase(self, name, seconds, rows):
        self.phases.append((name, seconds, rows))


def test_telemetry_sees_every_step_and_unported_options_raise():
    users, items, labels = ratings()
    log = EpochLog()
    config = NCFConfig(num_users=30, num_items=20, embed_dim=4, hidden=(8, 4),
                       epochs=2, batch_size=100)
    _, logged = train_ncf(config, users, items, labels, "cpu", log_every=3, telemetry=log)
    assert [e for e, _, _ in log.epochs] == [0, 1]
    every = [loss for _, _, losses in log.epochs for loss in losses]
    assert len(every) == 14 and logged == every[2::3]
    assert [(name, rows) for name, _, rows in log.phases] == [("permutation", 700)] * 2
    assert all(s >= 0 for _, s, _ in log.phases)
    # a model axis in one process is refused, never trained as one device
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        NCFAlgorithm({}, device="cpu").train(
            TrainContext(device="cpu", mesh_shape=[-1, 2]),
            RatingsData(users=users, items=items, ratings=labels, times=None,
                        user_ids=[f"u{u}" for u in range(30)],
                        item_ids=[f"i{i}" for i in range(20)]))
    assert NCFAlgorithm({"seenFilter": "live"}, device="cpu").seen_mode == "live"
    with pytest.raises(ValueError, match="seenFilter"):
        NCFAlgorithm({"seenFilter": "sometimes"}, device="cpu")


def test_sampling_is_timed_and_the_tables_go_up_once(monkeypatch):
    """``NCFAlgorithm.train`` reports its negative sampling to the
    telemetry with the examples it made, and a model's two scorers on a
    device share one upload of its tables and weights."""
    users, items, _ = ratings()
    data = RatingsData(users=users, items=items, ratings=np.ones(users.size, np.float32),
                       times=np.arange(users.size, dtype=np.float64),
                       user_ids=[f"u{u}" for u in range(30)],
                       item_ids=[f"i{i}" for i in range(20)])
    log = EpochLog()
    ctx = TrainContext(device="cpu", telemetry=log)
    model = NCFAlgorithm(dict(ALGO, implicit=True, epochs=1), device="cpu").train(ctx, data)
    examples = make_implicit_batches(users, items, 20, 4, np.random.default_rng(ALGO["seed"]),
                                     device="cpu")[0].size
    assert examples > users.size
    assert [(name, rows) for name, _, rows in log.phases] == [
        ("negative_sampling", examples), ("permutation", examples)]
    uploads = []
    upload = ncf_engine.head_tensors
    monkeypatch.setattr(ncf_engine, "head_tensors",
                        lambda *args: uploads.append(args[2]) or upload(*args))
    for use_pallas in (True, False):
        algo = NCFAlgorithm(dict(ALGO, usePallas=use_pallas), device="cpu")
        algo.warm_up(model)
        algo.predict(model, {"user": "u0", "num": 3})
        algo.batch_predict(model, [(0, {"user": "u1", "num": 3})])
    assert uploads == [torch.device("cpu")]


# --------------------------------------------------------------------------
# the template: a JAX-trained model in the port, and the port's verbs
# --------------------------------------------------------------------------


def clique_events(seed=5, users=24, items=16):
    """Two cliques of users, each rating its half of the items 5 and the
    other half 1 (tests/test_ncf.py:159)."""
    rng = np.random.default_rng(seed)
    rows = []
    for u in range(users):
        for i in range(items):
            if rng.random() < 0.6:
                liked = (i < items // 2) == (u % 2 == 0)
                rows.append((f"u{u}", f"i{i}", 5.0 if liked else 1.0))
    return rows


@pytest.fixture()
def jax_ncf(storage_env):
    """The JAX template trained on the clique events; returns
    ``(algorithm, model, events)``."""
    app_id = storage_env.get_meta_data_apps().insert(App(name="NcfApp"))
    le = storage_env.get_l_events()
    le.init_channel(app_id)
    rows = clique_events()
    le.batch_insert([
        Event(event="rate", entity_type="user", entity_id=u, target_entity_type="item",
              target_entity_id=i, properties=DataMap({"rating": r}))
        for u, i, r in rows
    ], app_id=app_id)
    params = EngineParams.from_json_obj({
        "datasource": {"params": {"appName": "NcfApp"}},
        "algorithms": [{"name": "ncf", "params": dict(ALGO, epochs=20)}]})
    engine = engine_factory()
    model = engine.train(RuntimeContext({"pio.mesh_shape": [1, 1]}), params)[0]
    return engine._algorithms(params)[0], model, rows


QUERIES = [
    {"user": "u0", "num": 3, "unseenOnly": False},
    {"user": "u1", "num": 5},
    {"user": "u2", "num": 4, "blackList": ["i0", "i1"]},
    {"user": "u7", "num": 16},
    {"user": "ghost", "num": 3},
]


def same_response(got, want, atol=2e-5):
    assert [s["item"] for s in got["itemScores"]] == [s["item"] for s in want["itemScores"]]
    np.testing.assert_allclose([s["score"] for s in got["itemScores"]],
                               [s["score"] for s in want["itemScores"]],
                               rtol=2e-4, atol=atol)


def carried(jax_model):
    users = [u for u, rows in sorted(jax_model.seen.items()) for _ in rows]
    items = [i for _, rows in sorted(jax_model.seen.items()) for i in sorted(rows)]
    user_ids = sorted(jax_model.user_index, key=jax_model.user_index.get)
    params = jax.tree_util.tree_map(np.asarray, jax_model.params)
    return model_from_flax(params, user_ids, jax_model.item_ids, users, items)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_a_jax_trained_model_answers_the_same_in_the_port(jax_ncf, use_pallas, tmp_path):
    jax_algo, jax_model, _ = jax_ncf
    model = carried(jax_model)
    assert model.seen == jax_model.seen
    save_model(model, str(tmp_path / "m"))
    model = load_model(str(tmp_path / "m"))
    algo = NCFAlgorithm(dict(ALGO, usePallas=use_pallas), device="cpu")
    algo.warm_up(model)
    for query in QUERIES:
        same_response(algo.predict(model, query), jax_algo.predict(jax_model, query))
    batched = dict(algo.batch_predict(model, list(enumerate(QUERIES))))
    for qid, query in enumerate(QUERIES):
        same_response(batched[qid], algo.predict(model, query))
    assert batched[4] == {"itemScores": []}


def test_live_seen_filter_equals_the_reference(jax_ncf, monkeypatch):
    """``seenFilter: "live"``: the JAX-trained model and its port read the
    user's events from one store per query and answer alike, before and
    after a new event for the user; the new item drops out at once."""
    import dataclasses

    from predictionio_tpu_torch.data import storage as torch_storage
    from predictionio_tpu_torch.data.event import Event as TorchEvent

    monkeypatch.setattr(torch_storage, "_registry", torch_storage._Registry())
    jax_algo, jax_model, _ = jax_ncf
    live = dict(seen={}, seen_mode="live", app_name="NcfApp", event_names=["rate", "buy"])
    jax_live = dataclasses.replace(jax_model, **live)
    model = dataclasses.replace(carried(jax_model), **live)
    algo = NCFAlgorithm(ALGO, device="cpu")
    queries = QUERIES + [{"user": f"u{u}", "num": 16} for u in range(24)]
    for query in queries:
        same_response(algo.predict(model, query), jax_algo.predict(jax_live, query))
    batched = dict(algo.batch_predict(model, list(enumerate(queries))))
    for qid, query in enumerate(queries):
        same_response(batched[qid], jax_algo.predict(jax_live, query))
    unseen = {"user": "u0", "num": 16}
    before = [s["item"] for s in algo.predict(model, unseen)["itemScores"]]
    app_id = torch_storage.get_meta_data_apps().get_by_name("NcfApp").id
    torch_storage.get_l_events().insert(TorchEvent(
        event="buy", entity_type="user", entity_id="u0", target_entity_type="item",
        target_entity_id=before[0]), app_id)
    after = algo.predict(model, unseen)
    assert before[0] not in [s["item"] for s in after["itemScores"]]
    same_response(after, jax_algo.predict(jax_live, unseen))
    torch_storage.reset()


def test_the_engine_has_no_fallback(jax_ncf, monkeypatch):
    """A scorer that fails (a refused launch) fails the query: the plain
    head and the batch scorer are never taken in its place."""
    _, jax_model, _ = jax_ncf
    model = carried(jax_model)

    def refused(*args, **kwargs):
        def score(user):
            raise RuntimeError("ncf_score launch failed with CUDA error 700")
        return score

    def never(*args, **kwargs):
        pytest.fail("a fallback scorer was built")

    monkeypatch.setattr(ncf_engine, "all_items_scorer", refused)
    monkeypatch.setattr(ncf_engine, "batch_scorer", never)
    monkeypatch.setattr(ncf_engine.NCFModel, "batch_scorer", never)
    algo = NCFAlgorithm(dict(ALGO, usePallas=True), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        algo.predict(model, {"user": "u0", "num": 3})


def write_events(path, rows):
    base = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    with open(path, "w") as f:
        for n, (u, i, r) in enumerate(rows):
            f.write(json.dumps({
                "event": "rate", "entityType": "user", "entityId": u,
                "targetEntityType": "item", "targetEntityId": i,
                "properties": {"rating": r},
                "eventTime": (base + dt.timedelta(seconds=n)).isoformat()}) + "\n")
    return str(path)


def write_engine_json(path, params, **extra):
    variant = {"engineFactory": "predictionio_tpu.models.ncf.engine_factory",
               "datasource": {"params": {"appName": "NcfApp"}},
               "algorithms": [{"name": "ncf", "params": params}], **extra}
    path.write_text(json.dumps(variant))
    return str(path)


def post(conn, query):
    conn.request("POST", "/queries.json", body=json.dumps(query).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    assert resp.status == 200, body
    return body


@pytest.mark.parametrize("implicit", [False, True])
def test_train_then_deploy_verbs_serve_ncf(tmp_path, implicit):
    rows = clique_events()
    events = write_events(tmp_path / "events.jsonl", rows)
    engine_json = write_engine_json(tmp_path / "engine.json", dict(ALGO, implicit=implicit))
    model_dir = str(tmp_path / "model")
    assert cli.main(["train", "--engine-json", engine_json, "--events", events,
                     "--model-out", model_dir, "--device", "cpu"]) == 0
    assert not os.path.exists(os.path.join(model_dir, "checkpoints"))
    model = load_model(model_dir)
    assert model.config.implicit is implicit and model.config.hidden == (16, 8)

    # the same training through the components, in process
    data = RatingsData(
        users=np.array([model.user_index[u] for u, _, _ in rows]),
        items=np.array([model.item_index[i] for _, i, _ in rows]),
        ratings=np.array([r for _, _, r in rows], np.float32),
        times=np.arange(len(rows), dtype=np.float64),
        user_ids=sorted(model.user_index, key=model.user_index.get),
        item_ids=model.item_ids)
    algo = NCFAlgorithm(dict(ALGO, implicit=implicit), device="cpu")
    ctx = TrainContext(device="cpu")
    direct = algo.train(ctx, NCFPreparator().prepare(ctx, data))
    for name in direct.state:
        np.testing.assert_array_equal(direct.state[name].numpy(), model.state[name].numpy())

    server, service = cli.build_query_server(engine_json, model_dir, port=0, device="cpu")
    assert type(service.algorithms[0]).__name__ == "NCFAlgorithm"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
    try:
        for query in QUERIES:
            assert post(conn, query) == algo.predict(model, query)
        # the cliques: u0 (even) ranks the first half of the items on top
        top = post(conn, {"user": "u0", "num": 4, "unseenOnly": False})["itemScores"]
        assert all(int(s["item"][1:]) < 8 for s in top), top
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_template_dispatch(tmp_path):
    params = dict(ALGO)
    by_factory = write_engine_json(tmp_path / "a.json", params)
    _, template = cli.load_variant(by_factory)
    assert template.algorithm == "ncf"
    by_name = tmp_path / "b.json"
    by_name.write_text(json.dumps({"algorithms": [{"name": "ncf", "params": params}]}))
    assert cli.load_variant(str(by_name))[1].algorithm == "ncf"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for example, name in (("ncf", "ncf"), ("recommendation", "als"), ("ecommerce", "ecomm"),
                          ("similarproduct", "cooccurrence"), ("universal", "ur"),
                          ("classification", "naive-bayes")):
        path = os.path.join(repo, "examples", example, "engine.json")
        assert cli.load_variant(path)[1].algorithm == name
    for bad, match in (
        # the test suite's own engine (tests/fake_engine.py), which no
        # template of the port stands for
        ({"engineFactory": "fake_engine.engine_factory",
          "algorithms": [{"name": "mean"}]}, "not a ported template"),
        ({"algorithms": [{"name": "mean"}]}, "not a ported template"),
        ({"engineFactory": "predictionio_tpu.models.ncf.engine_factory",
          "algorithms": [{"name": "als"}]}, "algorithm is 'ncf'"),
    ):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=match):
            cli.load_variant(str(path))
    events = write_events(tmp_path / "e.jsonl", clique_events(users=4))
    sharded = write_engine_json(tmp_path / "m.json", params,
                                sparkConf={"pio.mesh_shape": [1, 2]})
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        cli.train(sharded, events, str(tmp_path / "out"), device="cpu")


def test_default_device_without_cuda_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NCFAlgorithm({})
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    engine_json = os.path.join(repo, "examples", "ncf", "engine.json")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.build_trainer(engine_json, str(tmp_path / "events.jsonl"))
    users, items, labels = ratings()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_ncf(NCFConfig(num_users=30, num_items=20), users, items, labels)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_implicit_batches(users, items, 20, 4, np.random.default_rng(0))
