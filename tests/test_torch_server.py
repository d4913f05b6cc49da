"""The port's query server on the CPU, held to the JAX template's answers.

The server runs on ``device="cpu"`` in a thread on a free localhost port;
``POST /queries.json`` must answer exactly the JAX ``ALSAlgorithm``'s
predict dict for the same model, ``GET /`` a status, and bad input 400.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from predictionio_tpu.controller.base import Params as JaxParams
from predictionio_tpu.models._als_common import build_seen as jax_build_seen
from predictionio_tpu.models.recommendation.engine import (
    ALSAlgorithm as JaxALSAlgorithm,
    RecommendationModel as JaxRecommendationModel,
)
from predictionio_tpu.parallel.als import ALSModel as JaxALSModel
from predictionio_tpu_torch.models.recommendation import model_from_arrays, save_model
from predictionio_tpu_torch.tools.cli import build_query_server
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

RETRIEVAL = {"mode": "mips", "shortlist": 32, "blockItems": 64, "blockTopk": 16}


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    """(base url, jax algorithm, jax model) with the port serving the
    same arrays through the ``deploy`` code path."""
    rng = np.random.default_rng(21)
    uf = rng.standard_normal((12, 16)).astype(np.float32)
    itf = rng.standard_normal((200, 16)).astype(np.float32)
    users, items = rng.integers(0, 12, 150), rng.integers(0, 200, 150)
    user_ids = [f"u{u}" for u in range(12)]
    item_ids = [f"i{i}" for i in range(200)]
    root = tmp_path_factory.mktemp("deploy")
    save_model(
        model_from_arrays(uf, itf, user_ids, item_ids, users, items),
        str(root / "model"),
    )
    engine_json = root / "engine.json"
    engine_json.write_text(json.dumps({
        "id": "recommendation",
        "engineFactory": "predictionio_tpu.models.recommendation.engine_factory",
        "datasource": {"params": {"appName": "MyApp"}},
        "algorithms": [{"name": "als", "params": {"rank": 16, "retrieval": RETRIEVAL}}],
    }))
    server, service = build_query_server(
        str(engine_json), str(root / "model"), port=0, device="cpu"
    )
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    jax_model = JaxRecommendationModel(
        als=JaxALSModel(user_factors=uf, item_factors=itf),
        user_index={uid: idx for idx, uid in enumerate(user_ids)},
        item_ids=item_ids,
        item_index={iid: idx for idx, iid in enumerate(item_ids)},
        seen=jax_build_seen(users, items),
    )
    jax_algo = JaxALSAlgorithm(JaxParams({"rank": 16, "retrieval": RETRIEVAL}))
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}", jax_algo, jax_model
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        assert not thread.is_alive()


def _post(url, body: bytes):
    req = urllib.request.Request(
        url + "/queries.json", data=body, method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_queries_answer_the_reference_predict(deployed):
    url, jax_algo, jax_model = deployed
    for q in (
        {"user": "u0", "num": 5},
        {"user": "u3", "num": 9, "blackList": ["i1", "i2"]},
        {"user": "u4", "num": 6, "unseenOnly": False},
        {"items": ["i10", "i11"], "num": 4},
        {"user": "nobody", "num": 4},
    ):
        status, body = _post(url, json.dumps(q).encode())
        assert status == 200
        assert body == jax_algo.predict(jax_model, q), q


def test_status_and_errors(deployed):
    url, _, _ = deployed
    with urllib.request.urlopen(url + "/", timeout=30) as resp:
        info = json.loads(resp.read())
    assert resp.status == 200 and info["status"] == "alive"
    assert info["algorithms"] == ["ALSAlgorithm"] and info["devices"] == ["cpu"]
    assert _post(url, b"{not json")[0] == 400
    status, body = _post(url, json.dumps({"num": 3}).encode())  # no user/items
    assert status == 400 and "bad query" in body["message"]
    assert _post(url, json.dumps({"user": "u0", "num": "x"}).encode())[0] == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert err.value.code == 404
