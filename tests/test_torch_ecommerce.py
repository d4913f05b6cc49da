"""The port's e-commerce template against the JAX package's, on the CPU.

The same events (two shopper cliques with ``$set`` item categories, a
catalog past 512 items so mips stage 1 runs) go into each package's own
store. The JAX engine trains on its store; its model carried across with
``model_from_arrays`` must answer every scenario of
``tests/test_ecommerce_template.py`` -- clique, categories, white and
black lists, the live unavailable-items constraint, cold users from
recent views, unseenOnly, batch_predict -- as EQUAL dicts, in scan and
mips mode. The port's own training (implicit ALS, the buy-weighted
confidences) must give factors within 1e-4 of the JAX engine's
(``tests/test_als_gram.py::test_fit_matches_xla``'s bar) and the same
seen map and category index. Also: a fold-in whose window holds item
``$set`` records against the reference's, the retrain loop handing the
fold its confidences and ``$set`` types, the model directory and blob
round trips, the evaluation folds, and what is not ported.
"""

import dataclasses
import datetime as dt

import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.data import storage as jax_storage
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.base import App as JaxApp
from predictionio_tpu.eval.split import SplitSpec as JaxSplitSpec
from predictionio_tpu.models.ecommerce import engine_factory as jax_ecommerce_factory
from predictionio_tpu.models.ecommerce.engine import (
    ECommerceDataSource as JaxECommerceDataSource,
)
from predictionio_tpu.online import foldin as jax_foldin
from predictionio_tpu.workflow.context import RuntimeContext
from predictionio_tpu_torch.controller.base import Params, TrainContext
from predictionio_tpu_torch.controller.engine import (
    TEMPLATES,
    deserialize_model,
    serialize_model,
)
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.eval.split import SplitSpec
from predictionio_tpu_torch.models.ecommerce import (
    ECommAlgorithm,
    ECommerceDataSource,
    ECommercePreparator,
    load_model,
    model_from_arrays,
    save_model,
)
from predictionio_tpu_torch.models.recommendation.convert import seen_arrays
from predictionio_tpu_torch.online import foldin
from test_torch_store_train import basedir, fill_store  # noqa: F401
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

APP = "ShopApp"
ALGO = {"rank": 8, "numIterations": 8, "seed": 3, "lambda": 0.05, "alpha": 10.0,
        "checkpointInterval": 0}
MIPS = {"mode": "mips", "shortlist": 48, "blockItems": 64, "blockTopk": 16}
FILLERS = 600
BASE = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
ATOL = 1e-4


def shop_events(seed: int = 11) -> list[dict]:
    """Electronics buyers (g0*) and clothing buyers (g1*), buys and views
    of their own clique; 600 "misc" filler items viewed once each; every
    item's categories ``$set``; one event a second, each with its id."""
    rng = np.random.default_rng(seed)
    electronics = [f"e{i}" for i in range(6)]
    clothing = [f"c{i}" for i in range(6)]
    fillers = [f"f{i}" for i in range(FILLERS)]
    rows = []
    for items, cat in ((electronics, "electronics"), (clothing, "clothing"),
                       (fillers, "misc")):
        rows += [("$set", "item", item, None, {"categories": [cat]}) for item in items]
    for g, liked in enumerate((electronics, clothing)):
        for u in range(8):
            user = f"g{g}u{u}"
            rows += [("buy", "user", user, str(i), {})
                     for i in rng.choice(liked, size=4, replace=False)]
            rows += [("view", "user", user, str(i), {})
                     for i in rng.choice(liked, size=2, replace=False)]
    rows += [("view", "user", f"g{k % 2}u{k % 8}", item, {})
             for k, item in enumerate(fillers)]
    out = []
    for k, (name, etype, eid, target, props) in enumerate(rows):
        e = {"eventId": f"ev{k:05d}", "event": name, "entityType": etype, "entityId": eid,
             "properties": props, "eventTime": (BASE + dt.timedelta(seconds=k)).isoformat()}
        if target is not None:
            e.update(targetEntityType="item", targetEntityId=target)
        out.append(e)
    return out


def live_event(k: int, name: str, etype: str, eid: str, target=None, props=None) -> dict:
    e = {"eventId": f"live{k:03d}", "event": name, "entityType": etype, "entityId": eid,
         "properties": props or {},
         "eventTime": (BASE + dt.timedelta(days=1, seconds=k)).isoformat()}
    if target is not None:
        e.update(targetEntityType="item", targetEntityId=target)
    return e


@pytest.fixture()
def shop(basedir, tmp_path):  # noqa: F811
    """``use("jax" | "port")`` points both registries at that package's
    store; ``insert(events)`` adds live events to both."""
    paths = {name: str(tmp_path / name) for name in ("jax", "port")}
    events = shop_events()
    basedir(paths["jax"])
    fill_store(jax_storage, JaxApp, JaxEvent, events, app_name=APP)
    basedir(paths["port"])
    fill_store(storage, App, Event, events, app_name=APP)

    class Shop:
        @staticmethod
        def use(name):
            basedir(paths[name])

        @staticmethod
        def insert(live):
            for name, registry, event_class in (("jax", jax_storage, JaxEvent),
                                                ("port", storage, Event)):
                basedir(paths[name])
                registry.get_l_events().batch_insert(
                    [event_class.from_json_obj(e) for e in live], 1)

    return Shop


def jax_params(**algo):
    return JaxEngineParams.from_json_obj({
        "datasource": {"params": {"appName": APP}},
        "algorithms": [{"name": "ecomm", "params": {**ALGO, **algo}}],
    })


def jax_train(shop, **algo):
    shop.use("jax")
    params = jax_params(**algo)
    engine = jax_ecommerce_factory()
    model = engine.train(RuntimeContext(), params)[0]
    return engine._algorithms(params)[0], model


def carry(jax_model):
    """The JAX engine's model as the port's (``model_from_arrays``)."""
    user_ids = sorted(jax_model.user_index, key=jax_model.user_index.get)
    seen_users, seen_items = seen_arrays(jax_model.seen)
    return model_from_arrays(
        jax_model.als.user_factors, jax_model.als.item_factors, user_ids,
        jax_model.item_ids, seen_users, seen_items, jax_model.category_items,
        jax_model.app_name, jax_model.similar_events,
    )


def port_algorithm(**algo):
    return ECommAlgorithm(Params({**ALGO, **algo}), device="cpu")


QUERIES = [
    {"user": "g0u0", "num": 3, "unseenOnly": False},
    {"user": "g0u0", "num": 4, "categories": ["clothing"]},
    {"user": "g0u0", "num": 4, "categories": ["nope"]},
    {"user": "g0u0", "num": 10, "whiteList": ["e0", "e1", "f3"], "unseenOnly": False},
    {"user": "g0u0", "num": 12, "blackList": ["e0"], "unseenOnly": False},
    {"user": "g0u0", "num": 12},
    {"user": "g1u3", "num": 6, "categories": ["electronics", "clothing"],
     "blackList": ["c1"]},
    {"user": "g1u5", "num": 20, "categories": ["misc"]},
    {"user": "brandnew", "num": 3},
    {"user": "brandnew", "num": 5, "recentCount": 1, "categories": ["electronics"]},
    {"user": "ghost", "num": 3},
]


def cold_views(shop):
    shop.insert([live_event(k, "view", "user", "brandnew", item)
                 for k, item in enumerate(["e0", "e2", "f7"])])


@pytest.mark.parametrize("mode", ["scan", "mips"])
def test_every_scenario_answers_as_the_reference(shop, mode):
    retrieval = {"retrieval": MIPS} if mode == "mips" else {}
    jax_algo, jax_model = jax_train(shop, **retrieval)
    algo, model = port_algorithm(**retrieval), carry(jax_model)
    cold_views(shop)
    for q in QUERIES:
        shop.use("jax")
        want = jax_algo.predict(jax_model, q)
        shop.use("port")
        assert algo.predict(model, q) == want, q
    shop.use("port")
    clique = algo.predict(model, QUERIES[0])["itemScores"]
    assert clique and all(s["item"].startswith("e") for s in clique)
    assert algo.predict(model, QUERIES[2]) == {"itemScores": []}
    cold = [s["item"] for s in algo.predict(model, QUERIES[8])["itemScores"]]
    assert cold and {"e0", "e2", "f7"}.isdisjoint(cold)
    assert algo.predict(model, QUERIES[10]) == {"itemScores": []}


@pytest.mark.parametrize("mode", ["scan", "mips"])
def test_unavailable_items_are_read_live_as_the_reference_reads_them(shop, mode):
    """A ``$set`` on constraint/unavailableItems drops items without a
    retrain; a newer ``$set`` replaces the list."""
    retrieval = {"retrieval": MIPS} if mode == "mips" else {}
    jax_algo, jax_model = jax_train(shop, **retrieval)
    algo, model = port_algorithm(**retrieval), carry(jax_model)
    q = {"user": "g0u0", "num": 12, "unseenOnly": False}

    def both():
        shop.use("jax")
        want = jax_algo.predict(jax_model, q)
        shop.use("port")
        got = algo.predict(model, q)
        assert got == want
        return {s["item"] for s in got["itemScores"]}

    assert "e0" in both()
    shop.insert([live_event(1, "$set", "constraint", "unavailableItems",
                            props={"items": ["e0", "e1"]})])
    assert {"e0", "e1"}.isdisjoint(both())
    shop.insert([live_event(2, "$set", "constraint", "unavailableItems",
                            props={"items": []})])
    assert "e0" in both()


@pytest.mark.parametrize("mode", ["scan", "mips"])
def test_batch_predict_equals_the_reference_and_predict(shop, mode):
    retrieval = {"retrieval": MIPS} if mode == "mips" else {}
    jax_algo, jax_model = jax_train(shop, **retrieval)
    algo, model = port_algorithm(**retrieval), carry(jax_model)
    cold_views(shop)
    shop.insert([live_event(9, "$set", "constraint", "unavailableItems",
                            props={"items": ["e0"]})])
    queries = list(enumerate(QUERIES))
    shop.use("jax")
    want = dict(jax_algo.batch_predict(jax_model, queries))
    shop.use("port")
    got = dict(algo.batch_predict(model, queries))
    assert got == want
    for qid, q in queries:
        assert got[qid] == algo.predict(model, q), q
    assert "e0" not in {s["item"] for s in got[0]["itemScores"]}
    with pytest.raises(ValueError, match="must contain 'user'"):
        algo.batch_predict(model, [(0, {"num": 3})])
    with pytest.raises(ValueError, match="must contain 'user'"):
        algo.query_from_json({"num": 3})


def _port_train(shop, **algo):
    shop.use("port")
    ctx = TrainContext(device="cpu")
    data = ECommerceDataSource(Params({"appName": APP})).read_training(ctx)
    prepared = ECommercePreparator(Params({})).prepare(ctx, data)
    algorithm = port_algorithm(**algo)
    return algorithm, algorithm.train(ctx, prepared)


def test_training_matches_the_reference(shop):
    """Implicit ALS with buy confidence 2 from the port's store: factors
    within 1e-4 of the JAX engine's, the same vocabularies, seen map and
    category index; the clique answers."""
    _, jax_model = jax_train(shop)
    algorithm, model = _port_train(shop)
    assert model.user_index == jax_model.user_index
    assert model.item_ids == jax_model.item_ids
    np.testing.assert_allclose(model.als.user_factors, jax_model.als.user_factors,
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(model.als.item_factors, jax_model.als.item_factors,
                               atol=ATOL, rtol=0)
    assert model.seen == jax_model.seen
    assert model.category_items.keys() == jax_model.category_items.keys()
    for c, rows in jax_model.category_items.items():
        np.testing.assert_array_equal(model.category_items[c], rows)
    assert (model.app_name, model.similar_events) == (APP, ["view"])
    top = algorithm.predict(model, {"user": "g1u0", "num": 3, "unseenOnly": False})
    assert all(s["item"].startswith("c") for s in top["itemScores"])


class NamedSnapshot:
    """A snapshot's read surface (``data/snapshot.Snapshot``) over given
    columns, with event names, shared as is by both packages' folds."""

    def __init__(self, rows, uvocab, ivocab, nvocab):
        self._cols = {
            "users": np.asarray([uvocab.index(u) for u, _, _, _ in rows], np.int64),
            "items": np.asarray([ivocab.index(i) for _, i, _, _ in rows], np.int64),
            "names": np.asarray([nvocab.index(n) for _, _, n, _ in rows], np.int32),
            "times": np.asarray([t for _, _, _, t in rows], np.float64),
            "ratings": np.full(len(rows), np.nan),
        }
        self._vocabs = {"users": uvocab, "items": ivocab, "names": nvocab}
        self.manifest = {"until_ms": int(max(t for *_, t in rows) * 1000) + 1}

    def column(self, name):
        return self._cols[name]

    def vocab(self, which):
        return self._vocabs[which]

    def __len__(self):
        return len(self._cols["users"])


def test_fold_in_with_a_set_window_equals_the_reference(shop):
    """The window's views and buys re-solve the touched users with the
    datasource's confidences; its item ``$set`` rebuilds the category
    index from the store, so a new category serves one cycle later."""
    jax_algo, jax_model = jax_train(shop)
    model = carry(jax_model)
    algorithm = port_algorithm()
    users = sorted(model.user_index, key=model.user_index.get) + ["newbie"]
    items = list(model.item_ids) + ["n0"]
    t0 = BASE.timestamp()
    history = [(f"g{k % 2}u{k % 8}", f"{'ec'[k % 2]}{k % 6}", ("view", "buy")[k % 3 == 0],
                t0 + k) for k in range(40)]
    window = [("g0u1", "c2", "buy", t0 + 500), ("newbie", "e1", "view", t0 + 501),
              ("g1u2", "n0", "view", t0 + 502)]
    snap = NamedSnapshot(history + window, users, items, ["view", "buy"])
    shop.insert([live_event(3, "$set", "item", "e4", props={"categories": ["sale"]}),
                 live_event(4, "$set", "item", "n0", props={"categories": ["sale"]})])
    budget = dict(max_touched_frac=1.0, max_item_growth_frac=1.0, max_user_growth_frac=10.0)
    kw = dict(snapshot=snap, window_start_ms=int((t0 + 500) * 1000),
              extras={"event_values": {"view": 1.0, "buy": 2.0}}, set_entity_types={"item"})
    shop.use("jax")
    want = jax_algo.fold_in(jax_model, jax_foldin.FoldinDelta(
        budget=jax_foldin.StalenessBudget(**budget), **kw))
    shop.use("port")
    got = algorithm.fold_in(model, foldin.FoldinDelta(
        budget=foldin.StalenessBudget(**budget), **kw))
    assert got is not model and "newbie" not in model.user_index
    assert (got.user_index, got.item_ids) == (want.user_index, want.item_ids)
    np.testing.assert_allclose(got.als.user_factors, want.als.user_factors,
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got.als.item_factors, want.als.item_factors)
    assert got.seen == want.seen and got.seen != model.seen
    assert got.category_items.keys() == want.category_items.keys()
    for c, rows in want.category_items.items():
        np.testing.assert_array_equal(got.category_items[c], rows)
    np.testing.assert_array_equal(got.category_items["sale"],
                                  [got.item_index["e4"], got.item_index["n0"]])
    served = algorithm.predict(got, {"user": "g0u0", "num": 5, "categories": ["sale"],
                                     "unseenOnly": False})
    assert {s["item"] for s in served["itemScores"]} <= {"e4", "n0"}
    # a window of only $set records still publishes, the factors unchanged
    only_set = algorithm.fold_in(model, foldin.FoldinDelta(
        NamedSnapshot(history, users, items, ["view", "buy"]), int((t0 + 500) * 1000),
        set_entity_types={"item"}))
    assert only_set is not None and only_set.als is model.als
    assert "sale" in only_set.category_items
    assert algorithm.fold_in(model, foldin.FoldinDelta(
        NamedSnapshot(history, users, items, ["view", "buy"]), int((t0 + 500) * 1000))) is None


def test_retrain_loop_hands_the_fold_its_confidences_and_set_types(shop, tmp_path):
    """``pio retrain`` on an e-commerce engine: the WAL's view and item
    ``$set`` fold in (the reference's ``online/loop.py:342-356``
    extras), the new category serves, and ``--scorer-shards 2``
    publishes the replicated model per shard (no ``shard_model``)."""
    import json

    from predictionio_tpu_torch.data.ingest import wal_payload
    from predictionio_tpu_torch.data.wal import WriteAheadLog
    from predictionio_tpu_torch.online.loop import RetrainConfig, RetrainLoop
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    shop.use("port")
    engine_json = tmp_path / "engine.json"
    engine_json.write_text(json.dumps({
        "id": "shop", "engineFactory": "predictionio_tpu.models.ecommerce.engine_factory",
        "datasource": {"params": {"appName": APP, "buyWeight": 3.0}},
        "algorithms": [{"name": "ecomm", "params": ALGO}]}))
    run_train(load_engine_variant(str(engine_json)), device="cpu")
    wal = WriteAheadLog(str(tmp_path / "wal"))
    for e in (live_event(5, "view", "user", "g0u3", "c4"),
              live_event(6, "$set", "item", "c4", props={"categories": ["clothing", "new"]})):
        event = Event.from_json_obj(e)
        seqno = wal.append(wal_payload(event, 1, None))
        wal.sync()
        storage.get_l_events().insert_batch([(event, 1, None)], on_duplicate="ignore")
        wal.checkpoint(seqno)
    wal.close()
    loop = RetrainLoop(load_engine_variant(str(engine_json)),
                       RetrainConfig(notify_urls=[], wal_dir=str(tmp_path / "wal"),
                                     scorer_shards=2), device="cpu")
    captured = {}
    fold = loop.algorithm.fold_in

    def spy(model, delta):
        captured["delta"] = delta
        return fold(model, delta)

    loop.algorithm.fold_in = spy
    assert loop.run_once() == "foldin"
    delta = captured["delta"]
    assert delta.extras["event_values"] == {"view": 1.0, "buy": 3.0}
    assert "item" in delta.set_entity_types
    np.testing.assert_array_equal(loop.model.category_items["new"],
                                  [loop.model.item_index["c4"]])
    answer = loop.algorithm.predict(loop.model, {"user": "g0u0", "num": 4,
                                                 "categories": ["new"], "unseenOnly": False})
    assert [s["item"] for s in answer["itemScores"]] == ["c4"]
    version = loop.registry.latest()
    full = version.load_blob()
    assert version.shard_count == 2
    assert all(version.load_blob(shard=k) == full for k in range(2))


def test_model_round_trips(shop, tmp_path):
    """``save_model`` / ``load_model`` and the blob keep every field;
    ``model_from_arrays`` refuses mismatched tables."""
    _, jax_model = jax_train(shop)
    model = carry(jax_model)
    save_model(model, str(tmp_path / "m"))
    template = TEMPLATES["ecommerce"]
    for loaded in (load_model(str(tmp_path / "m")),
                   deserialize_model(template, serialize_model(template, model))):
        for f in dataclasses.fields(model):
            a, b = getattr(loaded, f.name), getattr(model, f.name)
            if f.name == "als":
                np.testing.assert_array_equal(a.user_factors, b.user_factors)
                np.testing.assert_array_equal(a.item_factors, b.item_factors)
            elif f.name == "category_items":
                assert a.keys() == b.keys()
                assert all(np.array_equal(a[c], b[c]) for c in a)
            else:
                assert a == b, f.name
    algo = port_algorithm()
    q = {"user": "g0u2", "num": 5, "categories": ["electronics"]}
    assert algo.predict(load_model(str(tmp_path / "m")), q) == algo.predict(model, q)
    with pytest.raises(ValueError, match="factor tables"):
        model_from_arrays(np.zeros((2, 3)), np.zeros((4, 2)), ["a", "b"], list("wxyz"),
                          [], [], {})
    with pytest.raises(ValueError, match="parallel arrays"):
        model_from_arrays(np.zeros((2, 3)), np.zeros((4, 3)), ["a", "b"], list("wxyz"),
                          [0], [], {})


def test_evaluation_folds_equal_the_reference(shop):
    """``read_eval`` (each user's latest interaction held out) and
    ``read_replay`` (the timeline cut) cut the same folds."""
    shop.use("jax")
    jax_ds = JaxECommerceDataSource(jax_params().data_source_params)
    want_eval = jax_ds.read_eval(RuntimeContext())
    want_replay = jax_ds.read_replay(RuntimeContext(), JaxSplitSpec(split_frac=0.7, k=5))
    shop.use("port")
    ds = ECommerceDataSource(Params({"appName": APP}))
    got_eval = ds.read_eval(None)
    got_replay = ds.read_replay(None, SplitSpec(split_frac=0.7, k=5))
    for (gt, gi, gp), (wt, wi, wp) in zip(got_eval, want_eval):
        assert gp == wp and dict(gi) == dict(wi)
        for name in ("users", "items", "weights", "times"):
            np.testing.assert_array_equal(getattr(gt, name), getattr(wt, name))
        assert gt.categories == wt.categories
    assert got_replay.pairs == want_replay.pairs and got_replay.pairs
    for name in ("users", "items", "weights", "times"):
        np.testing.assert_array_equal(getattr(got_replay.train_data, name),
                                      getattr(want_replay.train_data, name))


def test_what_is_not_ported_raises(shop, monkeypatch):
    """``"reader": "streaming"`` is ported: the DataSource hands the
    reference's handle, the buy-weighted confidences riding it (the
    streamed model against the reference: ``test_torch_streaming_templates.
    py``), and the preparator packs it for the context's mesh as the
    reference packs it for its own (a 1 x 1 mesh in one process; several
    ranks: ``test_torch_store_train.py``'s launch). The algorithm
    without a card still raises."""
    from predictionio_tpu.models.ecommerce.engine import (
        ECommercePreparator as JaxECommercePreparator,
    )
    from predictionio_tpu_torch.models._streaming import StreamingHandle

    shop.use("jax")
    want = JaxECommerceDataSource(
        Params({"appName": APP, "reader": "streaming"})).read_training(RuntimeContext())
    shop.use("port")
    handle = ECommerceDataSource(
        Params({"appName": APP, "reader": "streaming"})).read_training(None)
    assert isinstance(handle, StreamingHandle)
    assert (handle.app_id, handle.event_names, handle.extras) == (
        want.app_id, want.event_names, want.extras)
    assert handle.extras["event_values"] == {"view": 1.0, "buy": 2.0}
    ctx = TrainContext(device="cpu")
    _, got = ECommercePreparator(Params({"buckets": 2})).prepare(ctx, handle)
    assert ctx.mesh.shape == {"data": 1, "model": 1}
    shop.use("jax")
    _, want_als = JaxECommercePreparator(Params({"buckets": 2})).prepare(
        RuntimeContext({"pio.mesh_shape": [1, 1]}), want)
    for g_side, w_side in ((got.by_row, want_als.by_row), (got.by_col, want_als.by_col)):
        np.testing.assert_array_equal(g_side.slot_of, w_side.slot_of)
        assert g_side.global_rows == w_side.global_rows
        for gb, wb in zip(g_side.blocks, w_side.blocks, strict=True):
            for name in ("indices", "values", "mask"):
                np.testing.assert_array_equal(getattr(gb, name), getattr(wb, name))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ECommAlgorithm(Params(ALGO))
