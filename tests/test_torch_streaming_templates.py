"""The templates' streaming reader (``"reader": "streaming"``) and streamed
ALS feed (``alsFeed: "streamed"``) in the port against the JAX package's,
on the CPU.

The same events go into each package's own store, and each package's
engine trains on its store through the streaming reader, as the
scenarios of ``tests/test_recommendation_template.py:145`` and ``:186``,
``tests/test_ecommerce_template.py:227``, ``tests/test_similarity_templates.py:206``
and ``:287`` and ``tests/test_snapshot.py:140`` and ``:528`` do. ALS
factors are held to the reference's solver-parity bar (``atol`` 1e-4,
``tests/test_als_gram.py:198``) and the vocabularies equal; the port's
streamed models equal its materialized twins bit for bit, so their
answers (live seen filter and histories) are equal dicts; indicator
tables equal the JAX package's (indices exactly, values at rtol = atol =
1e-5, ``tests/test_torch_similarity.py``'s bar). Also: ``pio train
--als-feed streamed --snapshot-mode refresh`` through the port's command
line, its ``stream`` journal record and its deploy; the fallback to the
resident feed without a snapshot; what still refuses (NCF, an events
file).
"""

import copy
import datetime as dt
import json
import logging
import os

import numpy as np
import pytest

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.data import storage as jax_storage
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.base import App as JaxApp
from predictionio_tpu.models.ecommerce import engine_factory as jax_ecommerce_factory
from predictionio_tpu.models.recommendation import engine_factory as jax_rec_factory
from predictionio_tpu.models.similarproduct import engine_factory as jax_sp_factory
from predictionio_tpu.models.universal import engine_factory as jax_ur_factory
from predictionio_tpu.workflow.context import RuntimeContext
from predictionio_tpu_torch.controller.base import Params, TrainContext
from predictionio_tpu_torch.controller.engine import TEMPLATES
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import DataMap, Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.models import _streaming
from predictionio_tpu_torch.models.recommendation import (
    RecommendationDataSource,
)
from predictionio_tpu_torch.parallel import reader as torch_reader
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow.core_workflow import load_instance_model
from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant
from test_torch_ecommerce import shop_events
from test_torch_similarity import clique_events
from test_torch_store_train import _serve, basedir, fill_store, make_events  # noqa: F401

ATOL = 1e-4
TOL = 1e-5
REC_ALGO = {"rank": 8, "numIterations": 6, "lambda": 0.05, "seed": 3,
            "checkpointInterval": 0}
ECOMM_ALGO = {"rank": 8, "numIterations": 8, "lambda": 0.05, "alpha": 10.0, "seed": 3,
              "checkpointInterval": 0}


@pytest.fixture()
def two_stores(basedir, tmp_path):  # noqa: F811
    """``fill(events, app)`` puts the events into each package's store;
    ``use(name)`` points both registries at one of them."""
    paths = {name: str(tmp_path / name) for name in ("jax", "port")}

    class Stores:
        @staticmethod
        def fill(events, app):
            basedir(paths["jax"])
            fill_store(jax_storage, JaxApp, JaxEvent, events, app_name=app)
            basedir(paths["port"])
            fill_store(storage, App, Event, events, app_name=app)

        @staticmethod
        def use(name):
            basedir(paths[name])
            return paths[name]

    return Stores


def port_train(template: str, obj: dict, runtime_conf=None):
    """(algorithm, model, prepared data) of the port's engine on its store."""
    tmpl = TEMPLATES[template]
    ctx = TrainContext(device="cpu", runtime_conf=dict(runtime_conf or {}))
    data = tmpl.datasource_class(Params(obj["datasource"]["params"])).read_training(ctx)
    data.sanity_check()
    prepared = tmpl.preparator_class(Params(obj.get("preparator", {}).get("params", {}))) \
        .prepare(ctx, data)
    algo = tmpl.algorithm_class(Params(obj["algorithms"][0]["params"]), device="cpu")
    return algo, algo.train(ctx, prepared), prepared


def jax_train(factory, obj: dict, runtime_conf=None):
    engine = factory()
    params = JaxEngineParams.from_json_obj(obj)
    return engine._algorithms(params)[0], engine.train(RuntimeContext(runtime_conf), params)[0]


def streaming(obj: dict, **datasource) -> dict:
    out = copy.deepcopy(obj)
    out["datasource"]["params"].update(reader="streaming", **datasource)
    return out


def assert_factors_close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.user_factors, want.user_factors, atol=atol, rtol=0)
    np.testing.assert_allclose(got.item_factors, want.item_factors, atol=atol, rtol=0)


def assert_factors_equal(got, want):
    np.testing.assert_array_equal(got.user_factors, want.user_factors)
    np.testing.assert_array_equal(got.item_factors, want.item_factors)


# --------------------------------------------------------------------------
# recommendation
# --------------------------------------------------------------------------

REC = {"datasource": {"params": {"appName": "MovieApp", "eventNames": ["rate", "buy"]}},
       "algorithms": [{"name": "als", "params": REC_ALGO}]}
REC_QUERIES = [{"user": "u0", "num": 4}, {"user": "u3", "num": 6, "blackList": ["s1"]},
               {"user": "u5", "num": 5, "unseenOnly": False}, {"items": ["s2"], "num": 3},
               {"user": "nobody", "num": 3}]


def test_recommendation_streaming_reader_equals_the_reference(two_stores):
    """``"reader": "streaming"``: the DataSource hands a lazy handle, the
    preparator streams the store's chunked scan, and the model equals the
    materialized one (the same deterministic scan order), keeps no seen
    map and filters live; the default seenFilter is live there, and
    ``"model"`` raises."""
    two_stores.fill(make_events(), "MovieApp")
    two_stores.use("jax")
    _, want = jax_train(jax_rec_factory, streaming(REC))
    two_stores.use("port")
    algo, got, (data, als_data) = port_train("recommendation", streaming(REC))
    assert data.streamed and data.users.size == 0
    assert als_data.by_row.retained_edges == als_data.by_row.blocks[0].mask.sum()
    assert (got.seen, got.seen_mode) == ({}, "live") and (want.seen, want.seen_mode) == (
        {}, "live")
    assert got.user_index == want.user_index and got.item_ids == want.item_ids
    assert_factors_close(got.als, want.als)
    m_algo, materialized, _ = port_train("recommendation", REC)
    assert_factors_equal(got.als, materialized.als)
    live_algo = TEMPLATES["recommendation"].algorithm_class(
        Params({**REC_ALGO, "seenFilter": "live"}), device="cpu")
    for q in REC_QUERIES:
        assert algo.predict(got, q) == live_algo.predict(materialized, q) == (
            m_algo.predict(materialized, q)), q
    with pytest.raises(ValueError, match="seenFilter"):
        port_train("recommendation", {**streaming(REC), "algorithms": [
            {"name": "als", "params": {**REC_ALGO, "seenFilter": "model"}}]})


def test_recommendation_als_feed_streamed_trains_from_snapshot(two_stores, tmp_path,
                                                               monkeypatch):
    """``alsFeed: streamed`` and its ``pio.als_feed`` override route the
    streaming preparator through ``reader.snapshot_streamed_als_data``:
    the block store under the snapshot generation, trained by
    ``als_fit_streamed``, equal to the resident feed bit for bit and to
    the JAX package's streamed feed within the bar."""
    two_stores.fill(make_events(), "MovieApp")
    conf = {"pio.snapshot_mode": "use", "pio.snapshot_dir": str(tmp_path / "snaps")}

    def make(als_feed=None, **prep):
        obj = streaming(REC)
        if als_feed:
            prep["alsFeed"] = als_feed
        obj["preparator"] = {"params": prep}
        return obj

    calls, block_rows = [], {}
    orig = torch_reader.snapshot_streamed_als_data

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return orig(*args, **kwargs, **block_rows)

    monkeypatch.setattr(torch_reader, "snapshot_streamed_als_data", spy)
    two_stores.use("port")
    _, resident, _ = port_train("recommendation", make(), conf)
    assert not calls
    _, streamed, (_, store) = port_train("recommendation", make("streamed"), conf)
    assert len(calls) == 1
    assert os.path.basename(os.path.dirname(store.directory)) == "blocks"
    assert_factors_equal(streamed.als, resident.als)
    # `pio train --als-feed streamed` wins over the engine param; smaller
    # blocks (several a side) still give the resident factors
    block_rows["block_rows"] = 8
    cut = dict(conf, **{"pio.als_feed": "streamed"})
    _, overridden, (_, small) = port_train("recommendation", make("resident"), cut)
    assert len(calls) == 2 and len(small.by_row.specs) > 1
    assert_factors_equal(overridden.als, resident.als)
    with pytest.raises(ValueError, match="alsFeed"):
        port_train("recommendation", make("bogus"), conf)
    two_stores.use("jax")
    jax_conf = dict(conf, **{"pio.snapshot_dir": str(tmp_path / "jax_snaps")})
    _, want = jax_train(jax_rec_factory, make("streamed"), jax_conf)
    assert_factors_close(streamed.als, want.als)


def test_streamed_feed_without_a_snapshot_falls_back_to_resident(two_stores, caplog):
    two_stores.fill(make_events(), "MovieApp")
    two_stores.use("port")
    obj = streaming(REC)
    obj["preparator"] = {"params": {"alsFeed": "streamed"}}
    with caplog.at_level(logging.WARNING, logger="pio.streaming"):
        _, model, (_, als_data) = port_train("recommendation", obj)
    assert hasattr(als_data.by_row, "blocks")  # the resident pack
    assert "falling back to the resident feed" in caplog.text
    _, resident, _ = port_train("recommendation", streaming(REC))
    assert_factors_equal(model.als, resident.als)


def test_pio_train_als_feed_streamed_and_deploy(two_stores, tmp_path, capsys, monkeypatch):
    """The chip script's walk on the CPU: ``pio train --snapshot-mode
    refresh --als-feed streamed`` of a streaming engine.json (the journal
    of ``--profile`` closes with the fit's ``stream`` record), then ``pio
    deploy`` of the instance: its answers equal the materialized model's
    served with the live filter."""
    two_stores.fill(make_events(), "MovieApp")
    two_stores.use("port")
    variant = {"id": "stream-rec",
               "engineFactory": "predictionio_tpu.models.recommendation.engine_factory",
               **streaming(REC), "preparator": {"params": {"maxEventsPerUser": 12}}}
    engine_json = str(tmp_path / "engine.json")
    with open(engine_json, "w") as f:
        json.dump(variant, f)
    profile = str(tmp_path / "profile")
    # the verb exports its --snapshot-mode; restored after the test
    monkeypatch.setenv("PIO_SNAPSHOT_MODE", "off")
    assert cli.main(["train", "--engine-json", engine_json, "--device", "cpu",
                     "--snapshot-mode", "refresh", "--als-feed", "streamed",
                     "--profile", profile]) == 0
    assert "Engine instance ID" in capsys.readouterr().out
    with open(os.path.join(profile, "als-telemetry.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["event"] for r in records] == ["meta"] + ["step"] * 6 + ["stream"]
    stream = records[-1]
    assert stream["half_steps"] == 12 and stream["h2d_block_bytes"] > 0
    assert stream["max_inflight_blocks"] <= 2
    _, model = load_instance_model(load_engine_variant(engine_json))
    assert model.seen_mode == "live"
    materialized_obj = {**REC, "preparator": {"params": {"maxEventsPerUser": 12}}}
    _, materialized, _ = port_train("recommendation", materialized_obj)
    assert_factors_equal(model.als, materialized.als)
    live_algo = TEMPLATES["recommendation"].algorithm_class(
        Params({**REC_ALGO, "seenFilter": "live"}), device="cpu")
    served = _serve(engine_json, REC_QUERIES)
    assert [status for status, _ in served] == [200] * len(REC_QUERIES)
    assert [body for _, body in served] == [live_algo.predict(materialized, q)
                                            for q in REC_QUERIES]


def test_ncf_and_events_files_refuse_the_streaming_reader(two_stores, tmp_path):
    two_stores.fill(make_events(), "MovieApp")
    two_stores.use("port")
    ncf = {"datasource": {"params": {"appName": "MovieApp", "reader": "streaming"}},
           "algorithms": [{"name": "ncf", "params": {"epochs": 1}}]}
    with pytest.raises(ValueError, match="NCF template does not support"):
        port_train("ncf", ncf)
    with pytest.raises(ValueError, match="events file is read whole"):
        RecommendationDataSource(Params({"appName": "MovieApp", "reader": "streaming"}),
                                 events_path=str(tmp_path / "events.jsonl"))


# --------------------------------------------------------------------------
# e-commerce
# --------------------------------------------------------------------------

ECOMM = {"datasource": {"params": {"appName": "ShopApp"}},
         "algorithms": [{"name": "ecomm", "params": ECOMM_ALGO}]}
ECOMM_QUERIES = [
    {"user": "g0u0", "num": 3, "unseenOnly": False},
    {"user": "g0u0", "num": 20},
    {"user": "g0u0", "num": 4, "categories": ["clothing"]},
    {"user": "g1u3", "num": 6, "categories": ["electronics", "clothing"],
     "blackList": ["c1"]},
    {"user": "g1u5", "num": 10, "whiteList": ["c0", "c2", "f3"]},
    {"user": "ghost", "num": 3},
]


def test_ecommerce_streaming_equals_the_reference(two_stores):
    """Buy-weighted confidences applied in the stream, categories carried,
    the live seen filter; the model equals the materialized one and the
    JAX package's streamed one."""
    two_stores.fill(shop_events(), "ShopApp")
    two_stores.use("jax")
    _, want = jax_train(jax_ecommerce_factory, streaming(ECOMM))
    two_stores.use("port")
    algo, got, (data, _) = port_train("ecommerce", streaming(ECOMM))
    assert data.streamed and (got.seen, got.seen_mode) == ({}, "live")
    assert (want.seen, want.seen_mode) == ({}, "live")
    assert got.user_index == want.user_index and got.item_ids == want.item_ids
    assert_factors_close(got.als, want.als)
    assert got.category_items.keys() == want.category_items.keys()
    for c, rows in want.category_items.items():
        np.testing.assert_array_equal(got.category_items[c], rows)
    m_algo, materialized, _ = port_train("ecommerce", ECOMM)
    assert_factors_equal(got.als, materialized.als)
    for q in ECOMM_QUERIES:
        assert algo.predict(got, q) == m_algo.predict(materialized, q), q
    clique = algo.predict(got, ECOMM_QUERIES[0])["itemScores"]
    assert clique and all(s["item"].startswith("e") for s in clique)


# --------------------------------------------------------------------------
# similar-product and universal
# --------------------------------------------------------------------------


def cooc_obj(name: str, **params) -> dict:
    events = ["view", "buy"] if name == "cooccurrence" else ["buy", "view"]
    return {"datasource": {"params": {"appName": "Shop", "eventNames": events}},
            "algorithms": [{"name": name, "params": {"chunk": 8, **params}}]}


def test_similar_product_streaming_equals_the_reference(two_stores):
    """The streaming reader's CSR gives the materialized indicators (and
    the JAX package's streamed ones); user queries read the store live, so
    a fresh event anchors without a retrain."""
    two_stores.fill(clique_events(), "Shop")
    obj = cooc_obj("cooccurrence")
    two_stores.use("jax")
    _, want = jax_train(jax_sp_factory, streaming(obj))
    two_stores.use("port")
    algo, got, _ = port_train("similarproduct", streaming(obj))
    assert (got.history_mode, got.user_history) == ("live", {})
    assert got.item_ids == want.item_ids
    np.testing.assert_array_equal(got.top_indices, want.top_indices)
    np.testing.assert_allclose(got.top_values, want.top_values, rtol=TOL, atol=TOL)
    m_algo, materialized, _ = port_train("similarproduct", obj)
    assert got.item_ids == materialized.item_ids
    np.testing.assert_array_equal(got.top_indices, materialized.top_indices)
    np.testing.assert_array_equal(got.top_values, materialized.top_values)
    for q in ({"user": "u0", "num": 3}, {"user": "u3", "num": 5, "blackList": ["i6"]},
              {"items": ["i1"], "num": 4}):
        assert algo.predict(got, q) == m_algo.predict(materialized, q), q
    assert algo.predict(got, {"user": "u_new", "num": 3}) == {"itemScores": []}
    app_id = storage.get_meta_data_apps().get_by_name("Shop").id
    storage.get_l_events().insert(Event(
        event="view", entity_type="user", entity_id="u_new", target_entity_type="item",
        target_entity_id="i1", properties=DataMap({})), app_id)
    assert algo.predict(got, {"user": "u_new", "num": 3})["itemScores"]


def test_universal_streaming_equals_the_reference(two_stores):
    """Every event type's cross-occurrence over one shared universe: the
    indicator tables equal the materialized build's and the JAX
    package's streamed ones (in item-id space), user histories read live,
    and the answers equal the materialized model's."""
    two_stores.fill(clique_events(), "Shop")
    obj = cooc_obj("ur", topK=5)
    two_stores.use("jax")
    _, want = jax_train(jax_ur_factory, streaming(obj))
    two_stores.use("port")
    algo, got, _ = port_train("universal", streaming(obj))
    m_algo, materialized, _ = port_train("universal", obj)
    assert (got.history_mode, got.user_history) == ("live", {})

    def by_id(model, name):
        return {model.item_ids[j]: {(model.item_ids[p], round(v, 4)) for p, v in pairs}
                for j, pairs in model.indicators[name].items()}

    assert set(got.indicators) == set(want.indicators) == set(materialized.indicators)
    for name in got.indicators:
        assert by_id(got, name) == by_id(want, name) == by_id(materialized, name), name
    assert got.item_properties == materialized.item_properties
    for q in ({"user": "u0", "num": 4}, {"user": "u3", "num": 4},
              {"items": ["i1"], "num": 4}, {"user": "u1", "num": 4,
              "fields": [{"name": "category", "values": ["odd"], "bias": -1}]}):
        assert algo.predict(got, q) == m_algo.predict(materialized, q), q


# --------------------------------------------------------------------------
# the snapshot under the streaming sources
# --------------------------------------------------------------------------


def test_streaming_source_serves_without_sql(two_stores, tmp_path):
    """Once built, the handle-level source replays the snapshot's memmaps
    only (the store is not touched), and the chunks equal the JAX
    package's over the same events."""
    from predictionio_tpu.models._streaming import (
        StreamingHandle as JaxStreamingHandle,
    )
    from predictionio_tpu.models._streaming import (
        streaming_coo_source as jax_streaming_coo_source,
    )

    two_stores.fill(make_events(), "MovieApp")
    bound = dt.datetime(2030, 1, 1, tzinfo=dt.timezone.utc)
    kw = dict(app_name="MovieApp", app_id=1, channel_id=None, channel_name=None,
              event_names=["rate", "buy"], until_time=bound)
    conf = {"pio.snapshot_mode": "use", "pio.snapshot_dir": str(tmp_path / "snaps")}
    two_stores.use("jax")
    src, want_u, want_i = jax_streaming_coo_source(JaxStreamingHandle(**kw),
                                                   runtime_conf=dict(conf))
    want = [np.concatenate(c) for c in zip(*src())]
    two_stores.use("port")
    handle = _streaming.StreamingHandle(**kw)
    conf["pio.snapshot_dir"] = str(tmp_path / "port_snaps")
    src1, u1, i1 = _streaming.streaming_coo_source(handle, runtime_conf=conf)
    first = [np.concatenate(c) for c in zip(*src1())]

    class Broken:
        def __getattr__(self, name):
            raise AssertionError("storage touched after the snapshot build")

        iter_interaction_chunks = True
        count_interactions = None

    real = storage.get_l_events
    storage.get_l_events = lambda: Broken()
    try:
        src2, u2, i2 = _streaming.streaming_coo_source(handle, runtime_conf=conf)
        second = [np.concatenate(c) for c in zip(*src2())]
    finally:
        storage.get_l_events = real
    for a, b, w in zip(first, second, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, w)
    assert u1.ids == u2.ids == want_u.ids and i1.ids == i2.ids == want_i.ids


def test_streaming_handle_captures_until(two_stores):
    two_stores.fill(make_events(users=4), "MovieApp")
    two_stores.use("port")
    handle = _streaming.streaming_handle_or_none(
        Params({"appName": "MovieApp", "reader": "streaming"}), ["rate", "buy"])
    assert handle is not None and handle.until_time.tzinfo is not None
    assert _streaming.streaming_handle_or_none(Params({"appName": "MovieApp"}),
                                               ["rate"]) is None
    with pytest.raises(ValueError, match="alsFeed"):
        _streaming.resolve_als_feed(Params({"alsFeed": "sideways"}))
    assert _streaming.resolve_als_feed(Params({}), {"pio.als_feed": "streamed"}) == "streamed"


def test_snapshot_ratings_arrays_equal_the_reference(two_stores, tmp_path):
    """A replay read's COO arrays served from the handle's snapshot: the
    JAX package's arrays and vocabularies over the same events; None with
    snapshots off."""
    from predictionio_tpu.models._streaming import (
        StreamingHandle as JaxStreamingHandle,
    )
    from predictionio_tpu.models._streaming import (
        snapshot_ratings_arrays as jax_snapshot_ratings_arrays,
    )

    two_stores.fill(make_events(), "MovieApp")
    kw = dict(app_name="MovieApp", app_id=1, channel_id=None, channel_name=None,
              event_names=["rate", "buy"],
              until_time=dt.datetime(2030, 1, 1, tzinfo=dt.timezone.utc))
    two_stores.use("jax")
    want = jax_snapshot_ratings_arrays(JaxStreamingHandle(**kw), {
        "pio.snapshot_mode": "use", "pio.snapshot_dir": str(tmp_path / "jax")})
    two_stores.use("port")
    handle = _streaming.StreamingHandle(**kw)
    got = _streaming.snapshot_ratings_arrays(handle, {
        "pio.snapshot_mode": "use", "pio.snapshot_dir": str(tmp_path / "port")})
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    assert got[4:] == want[4:] and len(got[0]) == sum(
        1 for e in make_events() if e["event"] in ("rate", "buy"))
    assert _streaming.snapshot_ratings_arrays(handle, {"pio.snapshot_mode": "off"}) is None
