"""The port's SASRec and sequence template against the JAX package, on the CPU.

One flax-initialized SASRec, carried into the port with
``params_from_flax``, gives the JAX ``SASRec.apply``'s hidden states
within ``atol`` 2e-4 under both attention modes (the reference's own bar
for flash against plain in ``tests/test_flash_attention.py``: the
LayerNorms and two transformer blocks sum in other orders), and the same
next-item scores. A model trained by the JAX template, carried with
``model_from_flax``, answers the same queries with the same items (scores
within 2e-4) through ``predict`` and ``batch_predict``, before and after
a ``save_model``/``load_model`` round trip.
"""

import dataclasses
import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams
from predictionio_tpu.data import DataMap, Event
from predictionio_tpu.data.storage.base import App
from predictionio_tpu.models.sequence import engine_factory
from predictionio_tpu.models.sequence.model import SASRec as JaxSASRec
from predictionio_tpu.models.sequence.model import SASRecConfig as JaxSASRecConfig
from predictionio_tpu.models.sequence.model import score_next_items_batch as jax_score_batch
from predictionio_tpu.workflow.context import RuntimeContext
from predictionio_tpu_torch.models.sequence import (
    SASRecAlgorithm,
    SASRecConfig,
    load_model,
    model_from_flax,
    save_model,
)
from predictionio_tpu_torch.models.sequence.model import (
    SASRec,
    network,
    params_from_flax,
    score_next_items_batch,
    sequence_loss,
)

BASE = dict(num_items=20, max_len=12, embed_dim=8, num_heads=2, num_blocks=2, ffn_dim=16)


def flax_params(config_kw, seed=0):
    params = JaxSASRec(JaxSASRecConfig(**config_kw)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, config_kw["max_len"]), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def left_padded(rng, rows=3, pad=4, t=12, num_items=20):
    return np.concatenate([np.zeros((rows, pad), np.int64),
                           rng.integers(1, num_items + 1, size=(rows, t - pad))], axis=1)


def test_state_dict_names_are_the_flax_tree():
    state = params_from_flax(flax_params(BASE))
    net = SASRec(SASRecConfig(**BASE))
    assert set(state) == set(net.state_dict())
    for name, value in net.state_dict().items():
        assert state[name].shape == value.shape, name
    assert "att_1.qkv.weight" in state and "att_1.qkv.bias" not in state
    net.load_state_dict(state)


@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_forward_matches_flax_apply(attention):
    kw = dict(BASE, attention=attention)
    params = flax_params(kw, seed=3)
    rng = np.random.default_rng(0)
    seqs = np.concatenate([left_padded(rng), rng.integers(1, 21, size=(2, 12))])
    want = JaxSASRec(JaxSASRecConfig(**kw)).apply({"params": params}, jnp.asarray(seqs, jnp.int32))
    net = network(params_from_flax(params), SASRecConfig(**kw), "cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(seqs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_forward_matches_flax_apply_at_head_dim_136(attention):
    """One head of 136: past the attention kernels' 128, where on the card
    the chunked instances take it, zero-padded to 192."""
    kw = dict(BASE, embed_dim=136, num_heads=1, num_blocks=1, ffn_dim=32, attention=attention)
    params = flax_params(kw, seed=5)
    rng = np.random.default_rng(2)
    seqs = np.concatenate([left_padded(rng), rng.integers(1, 21, size=(2, 12))])
    want = JaxSASRec(JaxSASRecConfig(**kw)).apply({"params": params}, jnp.asarray(seqs, jnp.int32))
    net = network(params_from_flax(params), SASRecConfig(**kw), "cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(seqs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_flash_and_plain_agree_on_real_positions():
    """The two attention modes differ only on fully-masked padding rows,
    which the model zeroes; and the loss and its gradients agree."""
    state = params_from_flax(flax_params(BASE, seed=4))
    rng = np.random.default_rng(1)
    seqs = torch.from_numpy(left_padded(rng))
    targets = torch.zeros_like(seqs)
    targets[:, :-1] = seqs[:, 1:]
    grads = {}
    for attention in ("plain", "flash"):
        net = network(state, SASRecConfig(**BASE, attention=attention), "cpu").train()
        loss = sequence_loss(net, seqs, targets)
        loss.backward()
        grads[attention] = (loss.item(), {n: p.grad.clone() for n, p in net.named_parameters()})
    assert grads["plain"][0] == pytest.approx(grads["flash"][0], abs=1e-5)
    for name, g in grads["plain"][1].items():
        torch.testing.assert_close(grads["flash"][1][name], g, atol=1e-5, rtol=1e-4)


def test_next_item_scores_match_the_reference():
    kw = dict(BASE, attention="plain")
    params = flax_params(kw, seed=5)
    prefixes = [np.array([3]), np.arange(1, 16), np.array([20, 2, 2, 7]), np.array([9, 1])]
    want = jax_score_batch(params, JaxSASRecConfig(**kw), prefixes)
    net = network(params_from_flax(params), SASRecConfig(**kw), "cpu")
    got = score_next_items_batch(net, prefixes)
    assert got.shape == (4, 20)
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert score_next_items_batch(net, []).shape == (0, 20)


# --------------------------------------------------------------------------
# a JAX-trained model in the port
# --------------------------------------------------------------------------

N_ITEMS, MAX_LEN = 12, 8
ALGO = {"embedDim": 8, "numHeads": 2, "numBlocks": 2, "ffnDim": 16,
        "epochs": 6, "batchSize": 16, "learningRate": 0.01}


def browsing_events(users=24, seed=3):
    """Users browse the item cycle i0 -> i1 -> ... -> i11 -> i0 in order
    (tests/test_sequence_template.py:105)."""
    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
    rows = []
    for u in range(users):
        start = rng.integers(0, N_ITEMS)
        for step in range(MAX_LEN):
            rows.append((f"u{u}", f"i{(start + step) % N_ITEMS}",
                         t0 + dt.timedelta(seconds=u * 1000 + step)))
    return rows


@pytest.fixture()
def jax_sequence(storage_env):
    """The JAX template trained on the browsing events; returns
    ``(algorithm, model)``."""
    app_id = storage_env.get_meta_data_apps().insert(App(name="ShopApp"))
    le = storage_env.get_l_events()
    le.init_channel(app_id)
    le.batch_insert([
        Event(event="view", entity_type="user", entity_id=u, target_entity_type="item",
              target_entity_id=i, properties=DataMap({}), event_time=when)
        for u, i, when in browsing_events()
    ], app_id=app_id)
    params = EngineParams.from_json_obj({
        "datasource": {"params": {"appName": "ShopApp", "eventNames": ["view"]}},
        "preparator": {"params": {"maxLen": MAX_LEN}},
        "algorithms": [{"name": "sasrec", "params": ALGO}]})
    engine = engine_factory()
    model = engine.train(RuntimeContext(), params)[0]
    return engine._algorithms(params)[0], model


QUERIES = [
    {"user": "u0", "num": 3},
    {"items": ["i3", "i4", "i5"], "num": 4},
    {"items": ["i9"], "num": 12, "unseenOnly": False},
    {"user": "u1", "num": 5, "unseenOnly": False},
    {"user": "u2", "num": 3, "blackList": ["i0", "i1"]},
    {"items": ["i2", "no-such-item", "i2"], "num": 2},
    {"user": "ghost", "num": 3},
    {"items": ["no-such-item"], "num": 3},
]


def same_response(got, want, atol=2e-4):
    assert [s["item"] for s in got["itemScores"]] == [s["item"] for s in want["itemScores"]]
    np.testing.assert_allclose([s["score"] for s in got["itemScores"]],
                               [s["score"] for s in want["itemScores"]], rtol=0, atol=atol)


def carried(jax_model):
    config = SASRecConfig(**dataclasses.asdict(jax_model.config))
    return model_from_flax(jax.tree_util.tree_map(np.asarray, jax_model.params), config,
                           jax_model.item_ids, jax_model.histories)


def test_a_jax_trained_model_answers_the_same_in_the_port(jax_sequence, tmp_path):
    jax_algo, jax_model = jax_sequence
    model = carried(jax_model)
    algo = SASRecAlgorithm(ALGO, device="cpu")
    algo.warm_up(model)
    for stage in ("carried", "loaded"):
        for query in QUERIES:
            same_response(algo.predict(model, query), jax_algo.predict(jax_model, query))
        batched = dict(algo.batch_predict(model, list(enumerate(QUERIES))))
        jax_batched = dict(jax_algo.batch_predict(jax_model, list(enumerate(QUERIES))))
        for qid, query in enumerate(QUERIES):
            same_response(batched[qid], jax_batched[qid])
            same_response(batched[qid], algo.predict(model, query), atol=1e-5)
        assert batched[6] == batched[7] == {"itemScores": []}
        if stage == "carried":
            save_model(model, str(tmp_path / "m"))
            loaded = load_model(str(tmp_path / "m"))
            assert loaded.config == model.config and loaded.item_ids == model.item_ids
            assert loaded.histories.keys() == model.histories.keys()
            for user, hist in model.histories.items():
                np.testing.assert_array_equal(loaded.histories[user], hist)
            for name, value in model.state.items():
                torch.testing.assert_close(loaded.state[name], value, atol=0, rtol=0)
            model = loaded
