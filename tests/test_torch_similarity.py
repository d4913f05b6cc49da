"""The port's similar-product and Universal Recommender templates against
the JAX package's, on the CPU.

The same events (two cliques of users; "buy" a sparse conversion, "view"
dense browsing; item ``$set`` categories) go into each package's own
store, and each package's engine trains on its store: the port's
cooccurrence runs ``ops/cooccurrence.py`` with ``device="cpu"``. The
indicator tables must equal the reference's (indices exactly, values at
rtol = atol = 1e-5), the histories and item properties too, and every
scenario of ``tests/test_similarity_templates.py:184-364`` -- item and
user anchors, blackLists, cold users, the UR's property filters and
boosts, batch_predict -- must answer as equal dicts. Also: the
evaluation pairs, the model directory and blob round trips, what is not
ported, and ``pio train`` / ``pio deploy`` of each shipped engine.json
(``examples/{ecommerce,similarproduct,universal}/engine.json``,
unchanged) with ``--device cpu`` through the port's command line.
"""

import dataclasses
import datetime as dt
import json
import os

import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.data import storage as jax_storage
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.base import App as JaxApp
from predictionio_tpu.eval.split import SplitSpec as JaxSplitSpec
from predictionio_tpu.models.similarproduct import engine_factory as jax_sp_factory
from predictionio_tpu.models.similarproduct.engine import (
    SimilarProductDataSource as JaxSimilarProductDataSource,
)
from predictionio_tpu.models.universal import engine_factory as jax_ur_factory
from predictionio_tpu.models.universal.engine import URDataSource as JaxURDataSource
from predictionio_tpu.workflow.context import RuntimeContext
from predictionio_tpu_torch.controller.base import Params, TrainContext
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.eval.split import SplitSpec
from predictionio_tpu_torch.models import similarproduct, universal
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow.core_workflow import load_instance_models
from predictionio_tpu_torch.workflow.json_extractor import template_engine
from test_torch_store_train import (  # noqa: F401
    _serve,
    basedir,
    fill_store,
    one_blob,
    one_model,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP = "Shop"
TOL = 1e-5
BASE = dt.datetime(2024, 5, 1, tzinfo=dt.timezone.utc)


def clique_events(users: int = 40, seed: int = 3, app_items: int = 10) -> list[dict]:
    """The reference's ``seed_store_events`` at 40 users: clique c0 views
    three of i0-i4 and buys one of them, clique c1 the same over i5-i9;
    each item's ``category`` (odd/even) and ``tags`` ``$set``."""
    rng = np.random.default_rng(seed)
    rows = [("$set", "item", f"i{i}", None,
             {"category": "odd" if i % 2 else "even", "tags": [f"t{i % 3}", "all"]})
            for i in range(app_items)]
    for u in range(users):
        base = (u % 2) * 5
        viewed = rng.choice(5, size=3, replace=False) + base
        rows += [("view", "user", f"u{u}", f"i{i}", {}) for i in viewed]
        rows.append(("buy", "user", f"u{u}", f"i{int(rng.choice(viewed))}", {}))
        if u % 5 == 0:  # a repeat view counts once in the cooccurrence
            rows.append(("view", "user", f"u{u}", f"i{viewed[0]}", {}))
    out = []
    for k, (name, etype, eid, target, props) in enumerate(rows):
        e = {"eventId": f"ev{k:05d}", "event": name, "entityType": etype, "entityId": eid,
             "properties": props, "eventTime": (BASE + dt.timedelta(seconds=k)).isoformat()}
        if target is not None:
            e.update(targetEntityType="item", targetEntityId=target)
        out.append(e)
    return out


@pytest.fixture()
def stores(basedir, tmp_path):  # noqa: F811
    """``use("jax" | "port")``: each package's store holds the events."""
    paths = {name: str(tmp_path / name) for name in ("jax", "port")}
    events = clique_events()
    basedir(paths["jax"])
    fill_store(jax_storage, JaxApp, JaxEvent, events, app_name=APP)
    basedir(paths["port"])
    fill_store(storage, App, Event, events, app_name=APP)
    return lambda name: basedir(paths[name])


def engine_obj(name: str, **params) -> dict:
    events = ["view", "buy"] if name == "cooccurrence" else ["buy", "view"]
    return {"datasource": {"params": {"appName": APP, "eventNames": events}},
            "algorithms": [{"name": name, "params": {"chunk": 8, **params}}]}


def both_trained(stores, name: str, **params):
    """(jax algorithm, jax model, port algorithm, port model), each
    trained from its own store."""
    stores("jax")
    jax_params = JaxEngineParams.from_json_obj(engine_obj(name, **params))
    engine = (jax_sp_factory if name == "cooccurrence" else jax_ur_factory)()
    jax_model = engine.train(RuntimeContext(), jax_params)[0]
    jax_algo = engine._algorithms(jax_params)[0]
    stores("port")
    engine = template_engine("similarproduct" if name == "cooccurrence" else "universal")
    obj = engine_obj(name, **params)
    ctx = TrainContext(device="cpu")
    data = engine.data_source_class(Params(obj["datasource"]["params"])).read_training(ctx)
    algo = engine.algorithm_class_map[name](Params(obj["algorithms"][0]["params"]),
                                            device="cpu")
    return jax_algo, jax_model, algo, algo.train(ctx, engine.preparator_class().prepare(
        ctx, data))


SP_QUERIES = [
    {"items": ["i1"], "num": 3},
    {"items": ["i1", "i7", "nope"], "num": 6},
    {"items": ["i2"], "num": 10, "blackList": ["i0", "i4"]},
    {"user": "u0", "num": 5},
    {"user": "u3", "num": 5, "blackList": ["i6"]},
    {"user": "stranger", "num": 3},
    {"items": ["zzz"]},
]


@pytest.mark.parametrize("llr", [True, False])
@pytest.mark.parametrize("mode", ["scan", "mips"])
def test_similar_product_equals_the_reference(stores, mode, llr):
    params = {"llr": llr, "topK": 4}
    if mode == "mips":
        params["retrieval"] = {"mode": "mips"}
    jax_algo, jax_model, algo, model = both_trained(stores, "cooccurrence", **params)
    assert model.item_ids == jax_model.item_ids
    np.testing.assert_array_equal(model.top_indices, jax_model.top_indices)
    np.testing.assert_allclose(model.top_values, jax_model.top_values, rtol=TOL, atol=TOL)
    assert model.user_history == jax_model.user_history
    stores("port")
    for q in SP_QUERIES:
        assert algo.predict(model, q) == jax_algo.predict(jax_model, q), q
    queries = list(enumerate(SP_QUERIES))
    batched = dict(algo.batch_predict(model, queries))
    assert batched == dict(jax_algo.batch_predict(jax_model, queries))
    assert batched == {qid: algo.predict(model, q) for qid, q in queries}
    # the reference's own checks: the clique holds, anchors and the
    # blackList are excluded, an unknown item answers empty
    items = [s["item"] for s in algo.predict(model, SP_QUERIES[0])["itemScores"]]
    assert items and "i1" not in items and all(int(i[1:]) < 5 for i in items)
    assert algo.predict(model, {"items": ["zzz"]}) == {"itemScores": []}
    with pytest.raises(ValueError, match="'items' or 'user'"):
        algo.query_from_json({"num": 3})


UR_QUERIES = [
    {"user": "u0", "num": 3},
    {"user": "u3", "num": 5, "blackList": ["i6"]},
    {"user": "u2", "num": 5, "unseenOnly": False},
    {"user": "nobody"},
    {"items": ["i6"], "num": 3},
    {"user": "u4", "items": ["i8"], "num": 6},
    {"user": "u0", "num": 5, "fields": [{"name": "category", "values": ["even"],
                                          "bias": -1}]},
    {"user": "u2", "num": 5, "fields": [{"name": "category", "values": ["odd"],
                                          "bias": 100.0}]},
    {"user": "u5", "num": 5, "fields": [{"name": "tags", "values": ["t1"], "bias": 3.0},
                                         {"name": "category", "values": ["odd"],
                                          "bias": -1}]},
]


def test_universal_recommender_equals_the_reference(stores):
    jax_algo, jax_model, algo, model = both_trained(stores, "ur", topK=5)
    assert (model.event_names, model.item_ids) == (jax_model.event_names, jax_model.item_ids)
    assert model.user_history == jax_model.user_history
    assert model.item_properties == jax_model.item_properties
    assert model.indicators.keys() == jax_model.indicators.keys() == {"buy", "view"}
    for name, inverted in jax_model.indicators.items():
        assert model.indicators[name].keys() == inverted.keys()
        for j, pairs in inverted.items():
            got = model.indicators[name][j]
            assert [p for p, _ in got] == [p for p, _ in pairs]
            np.testing.assert_allclose([v for _, v in got], [v for _, v in pairs],
                                       rtol=TOL, atol=TOL)
    stores("port")
    for q in UR_QUERIES:
        assert algo.predict(model, q) == jax_algo.predict(jax_model, q), q
    queries = list(enumerate(UR_QUERIES))
    batched = dict(algo.batch_predict(model, queries))
    assert batched == dict(jax_algo.batch_predict(jax_model, queries))
    assert batched == {qid: algo.predict(model, q) for qid, q in queries}
    # the reference's checks: u0's clique, an empty cold user, the even
    # filter, the odd boost reorders without filtering
    items = [s["item"] for s in algo.predict(model, UR_QUERIES[0])["itemScores"]]
    assert items and all(int(i[1:]) < 5 for i in items)
    assert algo.predict(model, {"user": "nobody"}) == {"itemScores": []}
    flt = algo.predict(model, UR_QUERIES[6])["itemScores"]
    assert all(int(s["item"][1:]) % 2 == 0 for s in flt)
    base = algo.predict(model, {"user": "u2", "num": 5})["itemScores"]
    boost = algo.predict(model, UR_QUERIES[7])["itemScores"]
    assert len(boost) == len(base)


def test_evaluation_pairs_equal_the_reference(stores):
    """``read_eval`` of both templates and similar-product's
    ``read_replay``: the same folds, the same pairs."""
    ctx = RuntimeContext()
    stores("jax")
    jax_sp = JaxSimilarProductDataSource({"appName": APP})
    jax_ur = JaxURDataSource({"appName": APP, "eventNames": ["buy", "view"]})
    want = (jax_sp.read_eval(ctx), jax_ur.read_eval(ctx),
            jax_sp.read_replay(ctx, JaxSplitSpec(split_frac=0.75, k=4)))
    stores("port")
    sp = similarproduct.SimilarProductDataSource(Params({"appName": APP}))
    ur = universal.URDataSource(Params({"appName": APP, "eventNames": ["buy", "view"]}))
    got = (sp.read_eval(None), ur.read_eval(None),
           sp.read_replay(None, SplitSpec(split_frac=0.75, k=4)))
    (gt, _, gp), (wt, _, wp) = got[0][0], want[0][0]
    assert gp == wp and gp and all("items" in q for q, _ in gp)
    np.testing.assert_array_equal(gt.items, wt.items)
    (gt, _, gp), (wt, _, wp) = got[1][0], want[1][0]
    assert gp == wp and gp and gt.user_ids == wt.user_ids
    for name in wt.per_event:
        for a, b in zip(gt.per_event[name], wt.per_event[name]):
            np.testing.assert_array_equal(a, b)
    assert got[2].pairs == want[2].pairs and got[2].pairs
    np.testing.assert_array_equal(got[2].train_data.users, want[2].train_data.users)


@pytest.mark.parametrize("template", ["similarproduct", "universal"])
def test_model_round_trips(stores, template, tmp_path):
    name = "cooccurrence" if template == "similarproduct" else "ur"
    _, _, algo, model = both_trained(stores, name)
    files = type(algo).model_files
    files.save(model, str(tmp_path / "m"))
    for loaded in (files.load(str(tmp_path / "m")),
                   one_model(template, one_blob(template, model))):
        for f in dataclasses.fields(model):
            a, b = getattr(loaded, f.name), getattr(model, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            else:
                assert a == b, f.name
        queries = SP_QUERIES if template == "similarproduct" else UR_QUERIES
        for q in queries:
            assert algo.predict(loaded, q) == algo.predict(model, q)
    if template == "similarproduct":
        with pytest.raises(ValueError, match="indicator tables"):
            similarproduct.model_from_arrays(np.zeros((3, 2)), np.zeros((3, 3)),
                                             ["a", "b", "c"], {})


def test_what_is_not_ported_raises(stores, monkeypatch):
    """``"reader": "streaming"`` is ported: each DataSource hands the
    reference's handle, and each algorithm trains it over the context's
    mesh (one process: 1 x 1) into the indicators the reference's
    algorithm trains over its own (the streamed models in depth:
    ``test_torch_streaming_templates.py``; several ranks:
    ``test_torch_sharded_reader.py``). Each algorithm without a card
    still raises."""
    from predictionio_tpu.models.similarproduct.engine import (
        CooccurrenceAlgorithm as JaxCooccurrenceAlgorithm,
    )
    from predictionio_tpu.models.universal.engine import URAlgorithm as JaxURAlgorithm
    from predictionio_tpu_torch.models._streaming import StreamingHandle

    for name, source, jax_source in (
            ("cooccurrence", similarproduct.SimilarProductDataSource,
             JaxSimilarProductDataSource),
            ("ur", universal.URDataSource, JaxURDataSource)):
        params = dict(engine_obj(name)["datasource"]["params"], reader="streaming")
        stores("jax")
        want = jax_source(Params(params)).read_training(RuntimeContext())
        stores("port")
        handle = source(Params(params)).read_training(None)
        assert isinstance(handle, StreamingHandle)
        for field in ("app_id", "event_names", "probe_event_names", "empty_message"):
            assert getattr(handle, field) == getattr(want, field), field
        algo = template_engine("similarproduct" if name == "cooccurrence" else "universal") \
            .algorithm_class_map[name](Params({"chunk": 8}), device="cpu")
        model = algo.train(TrainContext(device="cpu"), handle)
        stores("jax")
        jax_algo = (JaxCooccurrenceAlgorithm if name == "cooccurrence" else JaxURAlgorithm)(
            Params({"chunk": 8}))
        want_model = jax_algo.train(RuntimeContext({"pio.mesh_shape": [1, 1]}), want)
        assert model.item_ids == want_model.item_ids
        if name == "cooccurrence":
            np.testing.assert_array_equal(model.top_indices, np.asarray(want_model.top_indices))
            np.testing.assert_allclose(model.top_values, np.asarray(want_model.top_values),
                                       atol=1e-4)
        else:
            assert set(model.indicators) == set(want_model.indicators)
            for kind, rows in want_model.indicators.items():
                assert {j: [p for p, _ in v] for j, v in model.indicators[kind].items()} == \
                    {j: [p for p, _ in v] for j, v in rows.items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for algorithm in (similarproduct.CooccurrenceAlgorithm, universal.URAlgorithm):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            algorithm(Params({}))


#: the shipped engine.json of each template, its appName, and queries
SHIPPED = {
    "ecommerce": ("MyShop", [{"user": "u0", "num": 4}, {"user": "u3", "num": 3,
                                                       "blackList": ["i1"]}]),
    "similarproduct": ("MyApp", [{"items": ["i1"], "num": 4}, {"user": "u3", "num": 3}]),
    "universal": ("MyApp", [{"user": "u0", "num": 4}, {"items": ["i6"], "num": 3}]),
}


@pytest.mark.parametrize("template", sorted(SHIPPED))
def test_shipped_engine_json_trains_and_deploys_through_the_cli(basedir, tmp_path,  # noqa: F811
                                                                template, capsys):
    """``pio train`` from the store and ``pio deploy`` of the instance,
    the example engine.json unchanged; the same events trained from a
    file (``--events``) give the same model."""
    app, queries = SHIPPED[template]
    basedir(tmp_path / "store")
    events = clique_events()
    fill_store(storage, App, Event, events, app_name=app)
    engine_json = os.path.join(REPO, "examples", template, "engine.json")
    assert cli.main(["train", "--engine-json", engine_json, "--device", "cpu"]) == 0
    assert "Engine instance ID" in capsys.readouterr().out
    variant, engine = cli.load_variant(engine_json)
    assert engine.algorithm_class_map == template_engine(template).algorithm_class_map
    _, [model] = load_instance_models(variant)
    [algo] = engine._algorithms(variant.engine_params, "cpu")
    answers = _serve(engine_json, queries)
    assert [status for status, _ in answers] == [200] * len(queries)
    assert [body for _, body in answers] == [algo.predict(model, q) for q in queries]
    assert answers[0][1]["itemScores"]
    events_path = tmp_path / "events.jsonl"
    events_path.write_text("".join(json.dumps(e) + "\n" for e in events))
    from_file = cli.train(engine_json, str(events_path), str(tmp_path / "model"),
                          device="cpu")
    for q in queries:
        assert algo.predict(from_file, q) == algo.predict(model, q)
