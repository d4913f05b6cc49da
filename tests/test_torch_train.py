"""The port's training path against the JAX template, on the CPU.

The same events go into the JAX package's event store (the
``storage_env`` fixture) and, as a JSON-lines file in the ``pio import``
wire shape, into the port's reader. The two training reads must encode
them identically; the JAX template's ``engine.train`` and the port's
``train`` verb must then give factors within the f32 bar (``atol``
1e-4), the same item order for every user, and the port's deployed model
directory must answer ``/queries.json`` as the JAX template predicts.
Checkpoints: a run that dies after an iteration resumes to the
uninterrupted result, and a changed vocabulary discards them.
"""

import datetime as dt
import http.client
import json
import os
import threading

import numpy as np
import pytest

from predictionio_tpu.controller.engine import EngineParams
from predictionio_tpu.data import Event as JaxEvent
from predictionio_tpu.data.storage.base import App
from predictionio_tpu.data.store import PEventStore
from predictionio_tpu.models.recommendation import engine_factory
from predictionio_tpu.workflow.context import RuntimeContext
from predictionio_tpu_torch.data.store import read_events_file
from predictionio_tpu_torch.models import _als_common as torch_common
from predictionio_tpu_torch.models.recommendation import ALSAlgorithm, load_model
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow import checkpoint as torch_checkpoint
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

ALGO = {"rank": 8, "numIterations": 6, "lambda": 0.05, "seed": 3,
        "implicitPrefs": False, "checkpointInterval": 1}
VARIANT = {
    "id": "recommendation",
    "datasource": {"params": {"appName": "MovieApp", "eventNames": ["rate", "buy"]}},
    "preparator": {"params": {"maxEventsPerUser": 12}},
    "algorithms": [{"name": "als", "params": ALGO}],
    "serving": {"params": {}},
}


def make_events(seed: int = 7, users: int = 40, extra_user: bool = False) -> list[dict]:
    """Two cliques of users with disjoint tastes, plus events the
    training read must drop: "view" events, a target that is not an
    item, and a ``$set`` on an item. Every event has its own time, one
    second apart, in a shuffled file order."""
    rng = np.random.default_rng(seed)
    scifi = [f"s{i}" for i in range(15)]
    romance = [f"r{i}" for i in range(15)]
    rows = []
    for u in range(users):
        liked, other = (scifi, romance) if u % 2 else (romance, scifi)
        for item in rng.choice(liked, size=10, replace=False):
            rows.append(("rate", f"u{u}", "item", str(item),
                         {"rating": int(rng.integers(4, 6))}))
        for item in rng.choice(other, size=3, replace=False):
            rows.append(("rate", f"u{u}", "item", str(item),
                         {"rating": int(rng.integers(1, 3))}))
        rows.append(("buy", f"u{u}", "item", str(rng.choice(liked)), {}))
        rows.append(("view", f"u{u}", "item", str(rng.choice(other)), {}))
    rows.append(("rate", "u0", "user", "u1", {"rating": 5}))
    if extra_user:
        rows += [("rate", "newcomer", "item", "s0", {"rating": 5}),
                 ("rate", "newcomer", "item", "s1", {"rating": 4})]
    base = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    events = [
        {"event": name, "entityType": "user", "entityId": user,
         "targetEntityType": ttype, "targetEntityId": target,
         "properties": props,
         "eventTime": (base + dt.timedelta(seconds=i)).isoformat()}
        for i, (name, user, ttype, target, props) in enumerate(rows)
    ]
    events.append({"event": "$set", "entityType": "item", "entityId": "s0",
                   "properties": {"genre": "scifi"},
                   "eventTime": base.isoformat()})
    order = rng.permutation(len(events))
    return [events[i] for i in order]


def write_jsonl(path, events: list[dict]) -> str:
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return str(path)


def write_engine_json(path, variant=VARIANT) -> str:
    with open(path, "w") as f:
        json.dump(variant, f)
    return str(path)


@pytest.fixture()
def movie_store(storage_env):
    """The events in the JAX package's store, app ``MovieApp``."""
    events = make_events()
    app_id = storage_env.get_meta_data_apps().insert(App(name="MovieApp"))
    le = storage_env.get_l_events()
    le.init_channel(app_id)
    le.batch_insert([JaxEvent.from_json_obj(e) for e in events], app_id=app_id)
    return events


def test_events_reader_matches_the_store(movie_store, tmp_path):
    path = write_jsonl(tmp_path / "events.jsonl", movie_store)
    want = PEventStore.dataset(
        "MovieApp", event_names=["rate", "buy"], target_entity_type="item"
    )
    got = read_events_file(path, event_names=["rate", "buy"], target_entity_type="item")
    assert got.entity_id_vocab == want.entity_id_vocab
    assert got.target_entity_id_vocab == want.target_entity_id_vocab
    assert got.event_name_vocab == want.event_name_vocab
    for name in ("entity_ids", "target_entity_ids", "event_names", "event_times"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.ratings, want.ratings)  # NaN where absent
    assert np.isnan(got.ratings).sum() == 40  # the buy events


def test_events_reader_reports_the_bad_line(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text(json.dumps({"event": "rate", "entityType": "user"}) + "\n")
    with pytest.raises(ValueError, match=r"bad.jsonl:1: .*entityId"):
        read_events_file(str(path))


def _post(conn, query):
    conn.request("POST", "/queries.json", body=json.dumps(query).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    assert resp.status == 200, body
    return body


def _same_response(got, want):
    assert [s["item"] for s in got["itemScores"]] == [
        s["item"] for s in want["itemScores"]
    ]
    np.testing.assert_allclose(
        [s["score"] for s in got["itemScores"]],
        [s["score"] for s in want["itemScores"]], atol=1e-4,
    )


def test_train_verb_matches_the_jax_template(movie_store, tmp_path):
    engine = engine_factory()
    params = EngineParams.from_json_obj(VARIANT)
    jax_model = engine.train(RuntimeContext({"pio.mesh_shape": [1, 1]}), params)[0]
    jax_algo = engine._algorithms(params)[0]

    engine_json = write_engine_json(tmp_path / "engine.json")
    events = write_jsonl(tmp_path / "events.jsonl", movie_store)
    model_dir = str(tmp_path / "model")
    assert cli.main(["train", "--engine-json", engine_json, "--events", events,
                     "--model-out", model_dir, "--device", "cpu"]) == 0
    assert not os.path.exists(os.path.join(model_dir, "checkpoints"))
    model = load_model(model_dir)

    assert model.user_index == jax_model.user_index
    assert model.item_ids == jax_model.item_ids
    assert model.seen == jax_model.seen
    np.testing.assert_allclose(
        model.als.user_factors, jax_model.als.user_factors, atol=1e-4
    )
    np.testing.assert_allclose(
        model.als.item_factors, jax_model.als.item_factors, atol=1e-4
    )
    algo = ALSAlgorithm(ALGO, device="cpu")
    for user in model.user_index:
        _same_response(algo.predict(model, {"user": user, "num": 10}),
                       jax_algo.predict(jax_model, {"user": user, "num": 10}))

    server, _ = cli.build_query_server(engine_json, model_dir, port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
    try:
        for query in ({"user": "u0", "num": 5}, {"user": "u7", "num": 10},
                      {"user": "u3", "num": 4, "unseenOnly": False},
                      {"items": ["s3", "r2"], "num": 6},
                      {"user": "nobody", "num": 3}):
            _same_response(_post(conn, query), jax_algo.predict(jax_model, query))
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


class _Killed(RuntimeError):
    pass


def _train(tmp_path, name, events, *, resume=False):
    out = str(tmp_path / name)
    model = cli.train(write_engine_json(tmp_path / "engine.json"), events, out,
                      resume=resume, device="cpu")
    return model, out


def _spy_start(monkeypatch) -> list[int]:
    """Record the ``start_iteration`` every fit begins at."""
    starts = []
    real = torch_common.als_fit

    def spy(*args, **kwargs):
        starts.append(kwargs["start_iteration"])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch_common, "als_fit", spy)
    return starts


def _die_after(monkeypatch, step: int) -> None:
    """Checkpoint saves work until ``step`` is on disk, then the run dies."""
    real = torch_checkpoint.CheckpointManager.save

    def save(self, it, state):
        real(self, it, state)
        if it == step:
            raise _Killed(f"killed after iteration {it}")

    monkeypatch.setattr(torch_checkpoint.CheckpointManager, "save", save)


def test_resume_after_a_crash_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    events = write_jsonl(tmp_path / "events.jsonl", make_events())
    whole, _ = _train(tmp_path, "whole", events)
    starts = _spy_start(monkeypatch)
    with monkeypatch.context() as m:
        _die_after(m, 2)
        with pytest.raises(_Killed):
            _train(tmp_path, "crashed", events)
    ckpt = torch_checkpoint.CheckpointManager(str(tmp_path / "crashed" / "checkpoints" / "als"))
    assert ckpt.latest_step() == 2
    resumed, out = _train(tmp_path, "crashed", events, resume=True)
    assert starts == [0, 3]
    assert not os.path.exists(os.path.join(out, "checkpoints"))
    np.testing.assert_array_equal(resumed.als.user_factors, whole.als.user_factors)
    np.testing.assert_array_equal(resumed.als.item_factors, whole.als.item_factors)


def test_changed_vocabulary_discards_the_checkpoint(tmp_path, monkeypatch):
    events = write_jsonl(tmp_path / "events.jsonl", make_events())
    with monkeypatch.context() as m:
        _die_after(m, 2)
        with pytest.raises(_Killed):
            _train(tmp_path, "crashed", events)
    grown = write_jsonl(tmp_path / "grown.jsonl", make_events(extra_user=True))
    fresh, _ = _train(tmp_path, "fresh", grown)
    starts = _spy_start(monkeypatch)
    resumed, _ = _train(tmp_path, "crashed", grown, resume=True)
    assert starts == [0]  # the stale steps were discarded, not restored
    assert "newcomer" in resumed.user_index
    np.testing.assert_array_equal(resumed.als.user_factors, fresh.als.user_factors)
    np.testing.assert_array_equal(resumed.als.item_factors, fresh.als.item_factors)


def test_checkpoint_manager_round_trip(tmp_path):
    ckpt = torch_checkpoint.CheckpointManager(str(tmp_path / "c"))
    assert ckpt.latest_step() is None and ckpt.read_meta() is None
    steps = torch_checkpoint.KEEP_STEPS + 2
    for step in range(steps):
        ckpt.save(step, {"users": np.full((3, 2), step, np.float32), "iteration": step})
    assert ckpt.latest_step() == steps - 1
    kept = range(steps - torch_checkpoint.KEEP_STEPS, steps)
    assert sorted(os.listdir(ckpt.path)) == [f"step_{s:08d}.npz" for s in kept]
    state = ckpt.restore({"users": np.zeros((3, 2), np.float32), "iteration": 0})
    assert state["iteration"] == steps - 1 and isinstance(state["iteration"], int)
    assert (state["users"] == steps - 1).all()
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({"users": np.zeros((4, 2), np.float32), "iteration": 0})
    ckpt.write_meta({"rank": 2})
    assert ckpt.read_meta() == {"rank": 2}
    ckpt.reset()
    assert ckpt.latest_step() is None and ckpt.read_meta() is None
    assert torch_checkpoint.CheckpointManager(ckpt.path, fresh=True).latest_step() is None


def test_unported_options_raise(tmp_path):
    """An events file has no chunked store scan, so ``"reader":
    "streaming"`` (the streaming reader of the store, ported) refuses it;
    ``alsFeed: "streamed"`` on the file's materialized read -- the engine
    param or ``train --als-feed`` -- packs resident, as the reference's
    materialized read does, to the default feed's factors; a feed that is
    neither raises."""
    events = write_jsonl(tmp_path / "events.jsonl", make_events(users=4))
    variant = dict(VARIANT, datasource={"params": {"appName": "MovieApp",
                                                   "reader": "streaming"}})
    engine_json = write_engine_json(tmp_path / "engine.json", variant)
    with pytest.raises(ValueError, match="events file is read whole"):
        cli.train(engine_json, events, str(tmp_path / "m"), device="cpu")
    base = cli.train(write_engine_json(tmp_path / "engine.json", VARIANT), events,
                     str(tmp_path / "m0"), device="cpu")
    for n, (feed, als_feed) in enumerate((("streamed", None), (None, "streamed"))):
        prep = dict(VARIANT["preparator"]["params"], **({"alsFeed": feed} if feed else {}))
        engine_json = write_engine_json(tmp_path / "engine.json",
                                        dict(VARIANT, preparator={"params": prep}))
        model = cli.train(engine_json, events, str(tmp_path / f"m{n + 1}"), device="cpu",
                          als_feed=als_feed)
        np.testing.assert_array_equal(model.als.user_factors, base.als.user_factors)
        np.testing.assert_array_equal(model.als.item_factors, base.als.item_factors)
    engine_json = write_engine_json(tmp_path / "engine.json", dict(
        VARIANT, preparator={"params": {"alsFeed": "sideways"}}))
    with pytest.raises(ValueError, match="alsFeed"):
        cli.train(engine_json, events, str(tmp_path / "m"), device="cpu")
