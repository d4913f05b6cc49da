"""The port's SASRec training and sequence template against the JAX package.

``train_sasrec`` starts from the JAX package's own initial weights (carried
across with ``params_from_flax``) and runs the reference's loop on a
one-device ``(data, seq)`` mesh: the step losses agree within
``rtol=1e-5, atol=1e-4`` and the final params within ``atol=1e-4``, the
f32 bars of the NCF parity tests (Adam's first updates are
``lr * sign(g)``, so a gradient that cancels to about 0 could flip a step
between the frameworks; at these sizes none does). The port's ``train``
and ``deploy`` verbs serve ``examples/sequence/engine.json`` over HTTP.
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
from jax.sharding import Mesh

from predictionio_tpu.models.sequence.model import SASRec as JaxSASRec
from predictionio_tpu.models.sequence.model import SASRecConfig as JaxSASRecConfig
from predictionio_tpu.models.sequence.model import train_sasrec as jax_train_sasrec
from predictionio_tpu_torch.controller.base import TrainContext
from predictionio_tpu_torch.models.sequence import (
    SASRecAlgorithm,
    SequenceDataSource,
    SequencePreparator,
    load_model,
)
from predictionio_tpu_torch.models.sequence.engine import group_sequences
from predictionio_tpu_torch.models.sequence.model import (
    SASRecConfig,
    params_from_flax,
    train_sasrec,
)
from predictionio_tpu_torch.parallel.mesh import Mesh as TorchMesh
from predictionio_tpu_torch.tools import cli
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQUENCE_JSON = os.path.join(REPO, "examples", "sequence", "engine.json")


def sequences(n=70, t=8, num_items=12, seed=0):
    """Right-padded id rows (0 = pad) of lengths 2..t: item cycles with
    noise, so the loss has something to learn and padding to skip."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, t), np.int32)
    for r in range(n):
        length = rng.integers(2, t + 1)
        start = rng.integers(0, num_items)
        out[r, :length] = (start + np.arange(length)) % num_items + 1
    return out


def flax_init(config_kw, t):
    """The JAX ``train_sasrec``'s own initial params (its PRNGKey(seed) init)."""
    params = JaxSASRec(JaxSASRecConfig(**config_kw)).init(
        jax.random.PRNGKey(config_kw["seed"]), jnp.zeros((1, t), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("attention", ["auto", "flash"])
def test_train_sasrec_matches_the_jax_loop(attention):
    kw = dict(num_items=12, max_len=8, embed_dim=8, num_heads=2, num_blocks=2, ffn_dim=16,
              learning_rate=0.01, batch_size=32, epochs=3, seed=2, attention=attention)
    seqs = sequences()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "seq"))
    jax_params, jax_losses = jax_train_sasrec(JaxSASRecConfig(**kw), seqs, mesh, log_every=1)
    state, losses = train_sasrec(SASRecConfig(**kw), seqs, "cpu", log_every=1,
                                 init_state=params_from_flax(flax_init(kw, 8)))
    assert len(losses) == len(jax_losses) == 3 * 3  # 70 rows: 32 + 32 + a short 6
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5, atol=1e-4)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jax_params))
    assert state.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(state[name].numpy(), want[name].numpy(), atol=1e-4,
                                   err_msg=name)


class EpochLog:
    def __init__(self):
        self.epochs = []

    def record_epoch(self, epoch, seconds, losses):
        self.epochs.append((epoch, seconds, losses))


def test_telemetry_and_unported_options_raise():
    config = SASRecConfig(num_items=12, max_len=8, embed_dim=8, num_blocks=1, ffn_dim=8,
                          batch_size=30, epochs=2)
    log = EpochLog()
    _, logged = train_sasrec(config, sequences(), "cpu", log_every=2, telemetry=log)
    assert [e for e, _, _ in log.epochs] == [0, 1]
    every = [loss for _, _, losses in log.epochs for loss in losses]
    assert len(every) == 6 and logged == every[1::2]
    with pytest.raises(ValueError, match="max_len"):
        train_sasrec(config, sequences(t=6), "cpu")
    # a mesh is never quietly one process: one process cannot build [1, 2]
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        TrainContext(device="cpu", mesh_shape=[1, 2],
                     runtime_conf={"pio.mesh_axes": ["data", "seq"]}).mesh
    # max_len must divide over the seq axis (the reference's text)
    seq3 = TorchMesh(("data", "seq"), (1, 3), (0, 0), torch.device("cpu"))
    with pytest.raises(ValueError, match="max_len=8 must divide over seq axis size 3"):
        train_sasrec(config, sequences(), "cpu", mesh=seq3)
    assert SASRecAlgorithm({"historyMode": "live"}, device="cpu").history_mode == "live"
    with pytest.raises(ValueError, match="historyMode"):
        SASRecAlgorithm({"historyMode": "sometimes"}, device="cpu")
    with pytest.raises(ValueError, match="attention"):
        SASRecConfig(num_items=3, attention="fast")


def test_live_history_equals_the_reference(storage_env, monkeypatch):
    """``historyMode: "live"``: both packages continue the user's events
    read from one store per query (no trained-in histories) and answer
    alike, before and after a new event extends the user's sequence."""
    import dataclasses

    from predictionio_tpu.controller.engine import EngineParams
    from predictionio_tpu.data import DataMap, Event
    from predictionio_tpu.data.storage.base import App
    from predictionio_tpu.models.sequence import engine_factory
    from predictionio_tpu.models.sequence.engine import SASRecModel as JaxSASRecModel
    from predictionio_tpu_torch.data import storage as torch_storage
    from predictionio_tpu_torch.data.event import Event as TorchEvent
    from predictionio_tpu_torch.models.sequence import model_from_flax

    monkeypatch.setattr(torch_storage, "_registry", torch_storage._Registry())
    kw = dict(num_items=12, max_len=8, embed_dim=8, num_heads=2, num_blocks=2, ffn_dim=16,
              seed=2)
    params = flax_init(kw, 8)
    item_ids = [f"i{j}" for j in range(12)]
    live = dict(history_mode="live", app_name="SeqApp", event_names=["view", "buy"])
    jax_model = JaxSASRecModel(params=jax.tree_util.tree_map(jnp.asarray, params),
                               config=JaxSASRecConfig(**kw), item_ids=item_ids,
                               item_index={i: j for j, i in enumerate(item_ids)},
                               histories={}, **live)
    model = dataclasses.replace(model_from_flax(params, SASRecConfig(**kw), item_ids, {}),
                                **live)
    app_id = storage_env.get_meta_data_apps().insert(App(name="SeqApp"))
    le = storage_env.get_l_events()
    le.init_channel(app_id)
    t0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    rng = np.random.default_rng(6)
    le.batch_insert([
        Event(event=("view", "buy", "rate")[n % 3], entity_type="user", entity_id=f"u{u}",
              target_entity_type="item", target_entity_id=f"i{rng.integers(0, 12)}",
              properties=DataMap({}), event_time=t0 + dt.timedelta(seconds=10 * n + u))
        for u in range(6) for n in range(int(rng.integers(1, 11)))
    ], app_id=app_id)
    jax_algo = engine_factory()._algorithms(EngineParams.from_json_obj(
        {"algorithms": [{"name": "sasrec", "params": {}}]}))[0]
    algo = SASRecAlgorithm({}, device="cpu")
    queries = [{"user": f"u{u}", "num": 5} for u in range(6)] + [
        {"user": "u1", "num": 12, "unseenOnly": False}, {"user": "ghost", "num": 3},
        {"items": ["i3", "i4"], "num": 4}]

    def same(got, want):
        assert [x["item"] for x in got["itemScores"]] == [x["item"] for x in want["itemScores"]]
        np.testing.assert_allclose([x["score"] for x in got["itemScores"]],
                                   [x["score"] for x in want["itemScores"]], atol=2e-4)

    for q in queries:
        same(algo.predict(model, q), jax_algo.predict(jax_model, q))
    batched = dict(algo.batch_predict(model, list(enumerate(queries))))
    for qid, q in enumerate(queries):
        same(batched[qid], jax_algo.predict(jax_model, q))
    q = {"user": "u2", "num": 12}
    before = algo.predict(model, q)
    torch_storage.get_l_events().insert(TorchEvent(
        event="view", entity_type="user", entity_id="u2", target_entity_type="item",
        target_entity_id=before["itemScores"][0]["item"],
        event_time=t0 + dt.timedelta(days=1)), app_id)
    after = algo.predict(model, q)
    assert before["itemScores"][0]["item"] not in [x["item"] for x in after["itemScores"]]
    same(after, jax_algo.predict(jax_model, q))
    torch_storage.reset()


def test_grouping_is_the_reference_order():
    """Per-user time order with ties in input order, users by index,
    short histories dropped."""
    users = np.array([1, 0, 1, 0, 2, 1, 0])
    items = np.array([10, 20, 11, 21, 30, 12, 22])
    times = np.array([5.0, 1.0, 3.0, 1.0, 0.0, 3.0, 0.5])
    seqs, ids = group_sequences(users, items, times, ["a", "b", "c"], min_len=2)
    assert ids == ["a", "b"]
    assert [s.tolist() for s in seqs] == [[22, 20, 21], [11, 12, 10]]


# --------------------------------------------------------------------------
# the verbs: train -> deploy with the template's engine.json
# --------------------------------------------------------------------------


def write_events(path, users=30, length=10, items=12, seed=4):
    """View events: each user walks the item cycle from a random start,
    one event a second."""
    rng = np.random.default_rng(seed)
    base = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    n = 0
    with open(path, "w") as f:
        for u in range(users):
            start = rng.integers(0, items)
            for step in range(length):
                f.write(json.dumps({
                    "event": "view", "entityType": "user", "entityId": f"u{u}",
                    "targetEntityType": "item",
                    "targetEntityId": f"i{(start + step) % items}",
                    "eventTime": (base + dt.timedelta(seconds=n)).isoformat()}) + "\n")
                n += 1
    return str(path)


def post(conn, query):
    conn.request("POST", "/queries.json", body=json.dumps(query).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    assert resp.status == 200, body
    return body


QUERIES = [
    {"user": "u0", "num": 4},
    {"items": ["i3", "i4", "i5"], "num": 3},
    {"items": ["i7"], "num": 5, "unseenOnly": False, "blackList": ["i8"]},
    {"user": "ghost", "num": 3},
]


def test_train_then_deploy_verbs_serve_the_sequence_template(tmp_path):
    events = write_events(tmp_path / "events.jsonl")
    model_dir = str(tmp_path / "model")
    assert cli.main(["train", "--engine-json", SEQUENCE_JSON, "--events", events,
                     "--model-out", model_dir, "--device", "cpu"]) == 0
    model = load_model(model_dir)
    with open(SEQUENCE_JSON) as f:
        variant = json.load(f)
    params = variant["algorithms"][0]["params"]
    assert (model.config.embed_dim, model.config.num_blocks, model.config.epochs,
            model.config.max_len) == (params["embedDim"], params["numBlocks"],
                                      params["epochs"], 64)
    assert len(model.histories) == 30 and len(model.item_ids) == 12

    # the same training through the components, in process
    ctx = TrainContext(device="cpu")
    data = SequenceDataSource(variant["datasource"]["params"], events_path=events).read_training(ctx)
    algo = SASRecAlgorithm(params, device="cpu")
    direct = algo.train(ctx, SequencePreparator(variant["preparator"]["params"]).prepare(ctx, data))
    for name in direct.state:
        torch.testing.assert_close(direct.state[name], model.state[name], atol=0, rtol=0)
    for user, hist in direct.histories.items():
        np.testing.assert_array_equal(model.histories[user], hist)

    server, service = cli.build_query_server(SEQUENCE_JSON, model_dir, port=0, device="cpu")
    assert type(service.algorithms[0]).__name__ == "SASRecAlgorithm"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
    try:
        for query in QUERIES:
            assert post(conn, query) == algo.predict(model, query)
        assert post(conn, QUERIES[-1]) == {"itemScores": []}
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_template_dispatch_and_unported_settings(tmp_path):
    assert list(cli.load_variant(SEQUENCE_JSON)[1].algorithm_class_map) == ["sasrec"]
    by_name = tmp_path / "b.json"
    by_name.write_text(json.dumps({"algorithms": [{"name": "sasrec", "params": {}}]}))
    assert cli.load_variant(str(by_name))[1].data_source_class is SequenceDataSource
    events = write_events(tmp_path / "e.jsonl", users=4)
    with open(SEQUENCE_JSON) as f:
        variant = json.load(f)
    # a [1, 2] mesh in one process is refused, never trained as one device
    for change, match in (({"sparkConf": dict(variant["sparkConf"], **{"pio.mesh_shape": [1, 2]})},
                           "needs 2 ranks, have 1"),
                          ({"algorithms": [{"name": "sasrec",
                                            "params": {"historyMode": "sometimes"}}]},
                           "historyMode"),
                          ({"algorithms": [{"name": "sasrec", "params": {"maxLen": 32}}]},
                           "maxLen")):
        path = tmp_path / "bad.json"
        path.write_text(json.dumps(dict(variant, **change)))
        with pytest.raises(ValueError, match=match):
            cli.train(str(path), events, str(tmp_path / "out"), device="cpu")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SASRecAlgorithm({})
    variant, engine = cli.load_variant(SEQUENCE_JSON)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine._algorithms(variant.engine_params)
    config = SASRecConfig(num_items=12, max_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_sasrec(config, sequences())
