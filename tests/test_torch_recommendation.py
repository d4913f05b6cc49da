"""The port's recommendation serving against the JAX template.

A tiny model is trained with the JAX package's own ``als_fit`` on the
CPU, carried across with ``model_from_arrays``, and both packages'
``ALSAlgorithm``s answer the same queries in scan and mips mode. The
responses must be EQUAL, item order and scores alike: both re-rank on
the host with the same ``np.einsum`` arithmetic, and the mips shortlists
are index-identical (``tests/test_torch_mips.py``).
"""

import dataclasses
import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.controller.base import Params as JaxParams
from predictionio_tpu.models._als_common import build_seen as jax_build_seen
from predictionio_tpu.models.recommendation.engine import (
    ALSAlgorithm as JaxALSAlgorithm,
    RecommendationModel as JaxRecommendationModel,
)
from predictionio_tpu.parallel.als import ALSConfig, als_fit, build_als_data
from predictionio_tpu_torch.models import _als_common as torch_common
from predictionio_tpu_torch.models.recommendation import (
    ALSAlgorithm,
    load_model,
    model_from_arrays,
    save_model,
)

NUM_USERS, NUM_ITEMS, RANK = 24, 300, 8

#: retrieval modes under test: the scan, mips through stage 1 + merge
#: (300 items > shortlist 48), and mips on its exhaustive branch
RETRIEVAL = {
    "scan": None,
    "mips": {"mode": "mips", "shortlist": 48, "blockItems": 64, "blockTopk": 16},
    "mips_exhaustive": {"mode": "mips"},
}


@pytest.fixture(scope="module")
def trained():
    """(jax model, port model): a JAX-trained ALS model on seeded
    interactions, and the same arrays carried into the port."""
    rng = np.random.default_rng(3)
    n_edges = 900
    users = rng.integers(0, NUM_USERS, n_edges)
    items = rng.integers(0, NUM_ITEMS, n_edges)
    pairs = np.unique(np.stack([users, items], 1), axis=0)
    users, items = pairs[:, 0], pairs[:, 1]
    ratings = rng.integers(1, 6, users.size).astype(np.float32)
    config = ALSConfig(rank=RANK, iterations=3, reg=0.05, seed=3)
    data = build_als_data(users, items, ratings, NUM_USERS, NUM_ITEMS, config)
    als = als_fit(data, config)
    user_ids = [f"u{u}" for u in range(NUM_USERS)]
    item_ids = [f"i{i}" for i in range(NUM_ITEMS)]
    jax_model = JaxRecommendationModel(
        als=als,
        user_index={uid: idx for idx, uid in enumerate(user_ids)},
        item_ids=item_ids,
        item_index={iid: idx for idx, iid in enumerate(item_ids)},
        seen=jax_build_seen(users, items),
    )
    port_model = model_from_arrays(
        als.user_factors, als.item_factors, user_ids, item_ids, users, items
    )
    return jax_model, port_model


def _queries(jax_model):
    seen0 = sorted(jax_model.seen[0])
    return [
        {"user": "u0", "num": 5},
        {"user": "u1", "num": 12, "blackList": ["i3", "i17", "nope"]},
        {"user": "u0", "num": 8, "unseenOnly": False},
        {"user": "u2", "num": 4, "blackList": [f"i{i}" for i in seen0]},
        {"items": ["i3", "i42"], "num": 6},
        {"items": ["i7", "missing"], "num": 3},
        {"user": "cold-user", "num": 5},
        {"items": ["missing"], "num": 5},
    ]


def _algorithms(mode):
    params = {"rank": RANK}
    if RETRIEVAL[mode] is not None:
        params["retrieval"] = RETRIEVAL[mode]
    return JaxALSAlgorithm(JaxParams(params)), ALSAlgorithm(params, device="cpu")


@pytest.mark.parametrize("mode", sorted(RETRIEVAL))
def test_predict_equals_reference(trained, mode):
    jax_model, port_model = trained
    jax_algo, port_algo = _algorithms(mode)
    jax_algo.warm_up(jax_model)
    port_algo.warm_up(port_model)
    for q in _queries(jax_model):
        assert port_algo.predict(port_model, q) == jax_algo.predict(jax_model, q), q
    assert port_algo.predict(port_model, {"user": "u0", "num": 5})["itemScores"]


@pytest.mark.parametrize("mode", sorted(RETRIEVAL))
def test_batch_predict_equals_reference_and_predict(trained, mode):
    jax_model, port_model = trained
    jax_algo, port_algo = _algorithms(mode)
    queries = list(enumerate(_queries(jax_model))) + [
        (100 + u, {"user": f"u{u}", "num": 7}) for u in range(NUM_USERS)
    ]
    port = dict(port_algo.batch_predict(port_model, queries))
    assert port == dict(jax_algo.batch_predict(jax_model, queries))
    assert port == {qid: port_algo.predict(port_model, q) for qid, q in queries}


def test_mips_matches_scan_when_shortlist_holds_top_k(trained):
    """A shortlist covering the catalog gives the scan's bytes exactly."""
    _, port_model = trained
    scan = ALSAlgorithm({}, device="cpu")
    mips = ALSAlgorithm({"retrieval": {"mode": "mips", "shortlist": 512}}, device="cpu")
    for q in _queries(trained[0]):
        assert mips.predict(port_model, q) == scan.predict(port_model, q), q


def test_save_load_round_trip(trained, tmp_path):
    _, port_model = trained
    save_model(port_model, str(tmp_path / "model"))
    loaded = load_model(str(tmp_path / "model"))
    np.testing.assert_array_equal(loaded.als.user_factors, port_model.als.user_factors)
    np.testing.assert_array_equal(loaded.als.item_factors, port_model.als.item_factors)
    assert loaded.user_index == port_model.user_index
    assert loaded.item_ids == port_model.item_ids
    assert loaded.item_index == port_model.item_index
    assert loaded.seen == port_model.seen
    algo = ALSAlgorithm({"retrieval": RETRIEVAL["mips"]}, device="cpu")
    for q in _queries(trained[0]):
        assert algo.predict(loaded, q) == algo.predict(port_model, q)


def test_model_from_arrays_validates():
    f = np.zeros((3, 4), np.float32)
    with pytest.raises(ValueError):
        model_from_arrays(f, np.zeros((2, 5), np.float32), ["a", "b", "c"], ["x", "y"], [], [])
    with pytest.raises(ValueError):
        model_from_arrays(f, f, ["a", "b"], ["x", "y", "z"], [], [])
    with pytest.raises(ValueError):
        model_from_arrays(f, f, ["a", "b", "c"], ["x", "y", "z"], [0, 1], [0])


def test_seen_filter_modes():
    assert ALSAlgorithm({"seenFilter": "live"}, device="cpu").seen_mode == "live"
    with pytest.raises(ValueError):
        ALSAlgorithm({"seenFilter": "sometimes"}, device="cpu")
    with pytest.raises(ValueError, match="unknown retrieval"):
        ALSAlgorithm({"retrieval": {"mode": "mips", "shortList": 3}}, device="cpu")


def test_serving_helpers_match_reference():
    from predictionio_tpu.models import _als_common as jax_common

    rng = np.random.default_rng(5)
    users = rng.integers(0, 50, 400)
    items = rng.integers(0, 90, 400)
    assert torch_common.build_seen(users, items) == jax_common.build_seen(users, items)
    for n in (1, 1000, 10_000_000):
        assert torch_common.score_buffer_rows(n) == jax_common.score_buffer_rows(n)
    scores = rng.standard_normal(200).astype(np.float32)
    scores[[3, 9, 40]] = scores[7]  # threshold ties
    scores[[11, 12]] = -np.inf
    for num in (0, 5, 8, 199, 200, 300):
        np.testing.assert_array_equal(
            torch_common.topk_order(scores, num), jax_common.topk_order(scores, num)
        )
    index = {"a": 0, "b": 1}
    qs = [(0, {"user": "a"}), (1, {"user": "zz"}), (2, {"items": ["x"]}), (3, "raw")]
    assert torch_common.partition_user_queries(index, qs) == (
        jax_common.partition_user_queries(index, qs)
    )


def test_live_seen_filter_equals_the_reference(trained, storage_env, monkeypatch):
    """``seenFilter: "live"``: both packages read the user's events from
    one store per query (the port through its own registry) and answer
    alike, before and after a new event for the user arrives; the new
    item drops out of the user's list at once."""
    from predictionio_tpu.data import DataMap, Event
    from predictionio_tpu.data.storage.base import App
    from predictionio_tpu_torch.data import storage as torch_storage
    from predictionio_tpu_torch.data.event import Event as TorchEvent

    monkeypatch.setattr(torch_storage, "_registry", torch_storage._Registry())
    jax_model, port_model = trained
    app_id = storage_env.get_meta_data_apps().insert(App(name="LiveApp"))
    le = storage_env.get_l_events()
    le.init_channel(app_id)
    t0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    le.batch_insert([
        Event(event=("rate", "buy", "view")[n % 3], entity_type="user",
              entity_id=f"u{u}", target_entity_type="item", target_entity_id=f"i{i}",
              properties=DataMap({"rating": 4}), event_time=t0 + dt.timedelta(seconds=n))
        for n, (u, items) in enumerate(sorted(jax_model.seen.items())) for i in sorted(items)
    ], app_id=app_id)
    live = dict(seen={}, seen_mode="live", app_name="LiveApp", event_names=["rate", "buy"])
    jax_live = dataclasses.replace(jax_model, **live)
    port_live = dataclasses.replace(port_model, **live)
    queries = _queries(jax_model) + [{"user": f"u{u}", "num": 9} for u in range(NUM_USERS)]
    for mode in ("scan", "mips"):
        jax_algo, port_algo = _algorithms(mode)
        for q in queries:
            assert port_algo.predict(port_live, q) == jax_algo.predict(jax_live, q), q
        batch = list(enumerate(queries))
        assert dict(port_algo.batch_predict(port_live, batch)) == dict(
            jax_algo.batch_predict(jax_live, batch))
    top = port_algo.predict(port_live, {"user": "u0", "num": 1})["itemScores"][0]["item"]
    torch_storage.get_l_events().insert(TorchEvent(
        event="buy", entity_type="user", entity_id="u0", target_entity_type="item",
        target_entity_id=top), app_id)
    after = port_algo.predict(port_live, {"user": "u0", "num": 10})
    assert top not in [s["item"] for s in after["itemScores"]]
    assert after == jax_algo.predict(jax_live, {"user": "u0", "num": 10})
    torch_storage.reset()

