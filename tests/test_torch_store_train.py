"""The port's store path against the JAX package's, on the CPU.

``pio train`` from the event store records an engine instance and a
model blob; ``pio deploy`` resolves the latest COMPLETED instance and
loads the blob. The same events go into each package's own store (same
event ids, so both scans break time ties alike); the JAX package's
``run_train`` and the port's must record the same instance (ids, times
and the store's own directory aside) and ALS factors within the f32 bar
(``atol`` 1e-4, ``tests/test_als_gram.py::test_fit_matches_xla``), and
the port's deploy must answer as the JAX template predicts. Also: a
pickled blob (one the JAX package wrote) is refused, ``--resume``
continues only on equal params, what is not ported raises, and the whole
walk -- ``app new`` -> ``/batch/events.json`` -> ``import`` -> ``train``
-> ``deploy`` -- runs through the port's command line alone.
"""

import datetime as dt
import glob
import http.client
import io
import json
import os
import pickle
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import requests

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.data import storage as jax_storage
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.base import App as JaxApp
from predictionio_tpu.workflow.context import WorkflowParams as JaxWorkflowParams
from predictionio_tpu.workflow.core_workflow import run_train as jax_run_train
from predictionio_tpu.workflow.json_extractor import (
    load_engine_variant as jax_load_engine_variant,
)
from predictionio_tpu_torch.controller.base import TrainContext
from predictionio_tpu_torch.controller.engine import EngineParams, ModelBlobError
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.models import _als_common as torch_common
from predictionio_tpu_torch.models.recommendation import ALSAlgorithm
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow import checkpoint as torch_checkpoint
from predictionio_tpu_torch.workflow.core_workflow import (
    WorkflowParams,
    engine_params_from_instance,
    load_instance_models,
    run_train,
)
from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant, template_engine
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_algorithm(template: str, algorithm: str | None = None) -> EngineParams:
    """Engine params of one block of ``algorithm`` (default: the
    template's first) with empty params."""
    name = algorithm or next(iter(template_engine(template).algorithm_class_map))
    return EngineParams.from_json_obj({"algorithms": [{"name": name, "params": {}}]})


def one_blob(template: str, model, algorithm: str | None = None) -> bytes:
    """The blob ``Engine.serialize_models`` writes for one model."""
    return template_engine(template).serialize_models(
        None, one_algorithm(template, algorithm), "", [model])


def one_model(template: str, blob: bytes, algorithm: str | None = None):
    """The one model of ``blob``, rehydrated by the template's engine on
    the CPU without a warm-up."""
    [model] = template_engine(template).prepare_deploy(
        TrainContext(device="cpu"), one_algorithm(template, algorithm), "", blob,
        warm_up=False)
    return model
ALGO = {"rank": 8, "numIterations": 6, "lambda": 0.05, "seed": 3,
        "implicitPrefs": False, "checkpointInterval": 0}
VARIANT = {
    "id": "store-rec",
    "engineFactory": "predictionio_tpu.models.recommendation.engine_factory",
    "datasource": {"params": {"appName": "StoreApp", "eventNames": ["rate", "buy"]}},
    "preparator": {"params": {"maxEventsPerUser": 12}},
    "algorithms": [{"name": "als", "params": ALGO}],
    "serving": {"params": {}},
    "sparkConf": {"pio.mesh_shape": [1, 1]},
}


def make_events(users: int = 30, seed: int = 5) -> list[dict]:
    """Two cliques of users with disjoint tastes, one event a second (no
    time ties), each with its event id, plus events the read drops."""
    rng = np.random.default_rng(seed)
    liked = {0: [f"s{i}" for i in range(12)], 1: [f"r{i}" for i in range(12)]}
    rows = []
    for u in range(users):
        for item in rng.choice(liked[u % 2], size=8, replace=False):
            rows.append(("rate", f"u{u}", str(item), {"rating": int(rng.integers(4, 6))}))
        for item in rng.choice(liked[1 - u % 2], size=2, replace=False):
            rows.append(("rate", f"u{u}", str(item), {"rating": 1}))
        rows.append(("buy", f"u{u}", str(rng.choice(liked[u % 2])), {}))
        rows.append(("view", f"u{u}", str(rng.choice(liked[1 - u % 2])), {}))
    base = dt.datetime(2024, 2, 1, tzinfo=dt.timezone.utc)
    return [
        {"eventId": f"ev{i:05d}", "event": name, "entityType": "user", "entityId": user,
         "targetEntityType": "item", "targetEntityId": item, "properties": props,
         "eventTime": (base + dt.timedelta(seconds=i)).isoformat()}
        for i, (name, user, item, props) in enumerate(rows)
    ]


def write_json(path, obj) -> str:
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


@pytest.fixture()
def basedir(tmp_path, monkeypatch):
    """``use(path)`` points both packages' registries at ``path``."""
    for key in [k for k in os.environ if k.startswith(("PIO_STORAGE_", "PIO_SNAPSHOT"))]:
        monkeypatch.delenv(key)

    def use(path) -> str:
        monkeypatch.setenv("PIO_FS_BASEDIR", str(path))
        storage.reset()
        jax_storage.reset()
        return str(path)

    yield use
    storage.reset()
    jax_storage.reset()


def fill_store(registry, app_class, event_class, events, app_name="StoreApp") -> int:
    app_id = registry.get_meta_data_apps().insert(app_class(name=app_name))
    le = registry.get_l_events()
    le.init_channel(app_id)
    le.batch_insert([event_class.from_json_obj(e) for e in events], app_id)
    return app_id


INSTANCE_FIELDS = ("status", "engine_id", "engine_version", "engine_variant",
                   "engine_factory", "batch", "runtime_conf", "data_source_params",
                   "preparator_params", "algorithms_params", "serving_params")


def _serve(engine_json, queries, **kwargs):
    import threading

    server, _ = cli.build_query_server(engine_json, port=0, device="cpu", **kwargs)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
    try:
        out = []
        for q in queries:
            conn.request("POST", "/queries.json", body=json.dumps(q).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out.append((resp.status, json.loads(resp.read())))
        return out
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_train_from_the_store_matches_the_jax_run_train(basedir, tmp_path, monkeypatch):
    events = make_events()
    engine_json = write_json(tmp_path / "engine.json", VARIANT)
    monkeypatch.setenv("PIO_TEST_MARK", "same")

    basedir(tmp_path / "jax")
    fill_store(jax_storage, JaxApp, JaxEvent, events)
    jax_instance = jax_run_train(jax_load_engine_variant(engine_json),
                                 JaxWorkflowParams(batch="b1"))
    jax_blob = jax_storage.get_model_data_models().get(jax_instance.id).models
    jax_model = pickle.loads(pickle.loads(jax_blob)[0][1])

    basedir(tmp_path / "port")
    fill_store(storage, App, Event, events)
    timings = {}
    instance = run_train(load_engine_variant(engine_json), WorkflowParams(batch="b1"),
                         device="cpu", timings=timings)
    assert set(timings) == {"read", "prepare", "train[als]", "persist"}
    recorded = storage.get_meta_data_engine_instances().get(instance.id)
    for name in INSTANCE_FIELDS:
        assert getattr(recorded, name) == getattr(jax_instance, name), name
    assert recorded.status == "COMPLETED" and recorded.end_time >= recorded.start_time
    strip = lambda env: {k: v for k, v in env.items() if k != "PIO_FS_BASEDIR"}
    assert strip(recorded.env) == strip(jax_instance.env)
    assert recorded.env["PIO_TEST_MARK"] == "same"
    assert engine_params_from_instance(recorded) == load_engine_variant(engine_json).engine_params

    blob = storage.get_model_data_models().get(instance.id).models
    assert blob[:2] == b"PK"  # a zip, not a pickle
    model = one_model("recommendation", blob)
    assert model.user_index == jax_model.user_index
    assert model.item_ids == jax_model.item_ids
    assert model.seen == jax_model.seen
    np.testing.assert_allclose(model.als.user_factors, jax_model.als.user_factors, atol=1e-4)
    np.testing.assert_allclose(model.als.item_factors, jax_model.als.item_factors, atol=1e-4)

    queries = [{"user": "u0", "num": 5}, {"user": "u7", "num": 10},
               {"user": "u3", "num": 4, "unseenOnly": False},
               {"items": ["s3", "r2"], "num": 6}, {"user": "nobody", "num": 3}]
    from predictionio_tpu.models.recommendation import engine_factory

    jax_algo = engine_factory()._algorithms(JaxEngineParams.from_json_obj(VARIANT))[0]
    for (status, got), q in zip(_serve(engine_json, queries), queries):
        want = jax_algo.predict(jax_model, q)
        assert status == 200
        assert [s["item"] for s in got["itemScores"]] == [s["item"] for s in want["itemScores"]]
        np.testing.assert_allclose([s["score"] for s in got["itemScores"]],
                                   [s["score"] for s in want["itemScores"]], atol=1e-4)
    # an explicit instance id resolves the same model
    assert _serve(engine_json, queries[:1], engine_instance_id=instance.id)[0][1] == (
        _serve(engine_json, queries[:1])[0][1])

    # a deploy of the JAX package's store finds its pickled blob: refused
    basedir(tmp_path / "jax")
    with pytest.raises(ModelBlobError, match="pickle, written by the JAX package"):
        cli.build_query_server(engine_json, port=0, device="cpu")
    with pytest.raises(ModelBlobError, match="Retrain it"):
        one_model("recommendation", jax_blob)


def test_a_pickled_or_foreign_blob_is_refused():
    with pytest.raises(ModelBlobError, match="never unpickles"):
        one_model("recommendation", pickle.dumps([("pickle", b"x")]))
    with pytest.raises(ModelBlobError, match="not a model blob"):
        one_model("recommendation", b"PK-not-a-zip")
    from predictionio_tpu_torch.models.recommendation import model_from_arrays

    model = model_from_arrays(np.ones((2, 3), np.float32), np.ones((4, 3), np.float32),
                              ["a", "b"], ["w", "x", "y", "z"], [0, 1], [2, 3])
    blob = one_blob("recommendation", model)
    with pytest.raises(ModelBlobError, match="'recommendation' model"):
        one_model("ncf", blob)
    back = one_model("recommendation", blob)
    assert back.seen == model.seen and back.item_ids == model.item_ids
    # a pickle entry for an algorithm that saves model files: refused
    # before its bytes (no pickle at all) are read
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        zf.writestr("manifest.json", json.dumps({
            "format": "predictionio_tpu_torch.model-zip", "version": 2,
            "algorithms": [{"algorithm": "als", "kind": "pickle", "file": "0/model.pkl"}]}))
        zf.writestr("0/model.pkl", b"not a pickle")
    with pytest.raises(ModelBlobError, match="pickles algorithm 'als'.*saves model files"):
        one_model("recommendation", buf.getvalue())


#: a model blob of the recommendation template as the port wrote it before
#: engines (manifest version 1: the files at the zip's root), of
#: ``_v1_model()``
V1_BLOB = (
    "UEsDBBQAAAAAAAAAIQAruAPWlgAAAJYAAAANAAAAbWFuaWZlc3QuanNvbnsiZm9ybWF0IjogInByZWRpY3Rpb25p"
    "b190cHVfdG9yY2gubW9kZWwtemlwIiwgInZlcnNpb24iOiAxLCAidGVtcGxhdGUiOiAicmVjb21tZW5kYXRpb24i"
    "LCAiYWxnb3JpdGhtIjogImFscyIsICJmaWxlcyI6IFsiZmFjdG9ycy5ucHoiLCAidm9jYWIuanNvbiJdfVBLAwQU"
    "AAAAAAAAACEAnpC6gnYEAAB2BAAACwAAAGZhY3RvcnMubnB6UEsDBC0AAAAAAAAAIQAKnACk//////////8QABQA"
    "dXNlcl9mYWN0b3JzLm5weQEAEACYAAAAAAAAAJgAAAAAAAAAk05VTVBZAQB2AHsnZGVzY3InOiAnPGY0JywgJ2Zv"
    "cnRyYW5fb3JkZXInOiBGYWxzZSwgJ3NoYXBlJzogKDIsIDMpLCB9ICAgICAgICAgICAgICAgICAgICAgICAgICAg"
    "ICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgIAoAAAAAAACAPgAAAD8AAEA/AACAPwAAoD9QSwMELQAAAAAA"
    "AAAhAAE+2ur//////////xAAFABpdGVtX2ZhY3RvcnMubnB5AQAQALAAAAAAAAAAsAAAAAAAAACTTlVNUFkBAHYA"
    "eydkZXNjcic6ICc8ZjQnLCAnZm9ydHJhbl9vcmRlcic6IEZhbHNlLCAnc2hhcGUnOiAoNCwgMyksIH0gICAgICAg"
    "ICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgCgAAAAAAAAA+AACAPgAA"
    "wD4AAAA/AAAgPwAAQD8AAGA/AACAPwAAkD8AAKA/AACwP1BLAwQtAAAAAAAAACEAfmr7yf//////////DgAUAHNl"
    "ZW5fdXNlcnMubnB5AQAQAJAAAAAAAAAAkAAAAAAAAACTTlVNUFkBAHYAeydkZXNjcic6ICc8aTgnLCAnZm9ydHJh"
    "bl9vcmRlcic6IEZhbHNlLCAnc2hhcGUnOiAoMiwpLCB9ICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAg"
    "ICAgICAgICAgICAgICAgICAgICAgICAgICAgCgAAAAAAAAAAAQAAAAAAAABQSwMELQAAAAAAAAAhAGBIfgz/////"
    "/////w4AFABzZWVuX2l0ZW1zLm5weQEAEACQAAAAAAAAAJAAAAAAAAAAk05VTVBZAQB2AHsnZGVzY3InOiAnPGk4"
    "JywgJ2ZvcnRyYW5fb3JkZXInOiBGYWxzZSwgJ3NoYXBlJzogKDIsKSwgfSAgICAgICAgICAgICAgICAgICAgICAg"
    "ICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgICAgIAoCAAAAAAAAAAMAAAAAAAAAUEsBAi0DLQAAAAAA"
    "AAAhAAqcAKSYAAAAmAAAABAAAAAAAAAAAAAAAIABAAAAAHVzZXJfZmFjdG9ycy5ucHlQSwECLQMtAAAAAAAAACEA"
    "AT7a6rAAAACwAAAAEAAAAAAAAAAAAAAAgAHaAAAAaXRlbV9mYWN0b3JzLm5weVBLAQItAy0AAAAAAAAAIQB+avvJ"
    "kAAAAJAAAAAOAAAAAAAAAAAAAACAAcwBAABzZWVuX3VzZXJzLm5weVBLAQItAy0AAAAAAAAAIQBgSH4MkAAAAJAA"
    "AAAOAAAAAAAAAAAAAACAAZwCAABzZWVuX2l0ZW1zLm5weVBLBQYAAAAABAAEAPQAAABsAwAAAABQSwMEFAAAAAAA"
    "AAAhAEWvWx+LAAAAiwAAAAoAAAB2b2NhYi5qc29ueyJ1c2VyX2lkcyI6IFsiYSIsICJiIl0sICJpdGVtX2lkcyI6"
    "IFsidyIsICJ4IiwgInkiLCAieiJdLCAic2Vlbl9tb2RlIjogIm1vZGVsIiwgImFwcF9uYW1lIjogIiIsICJldmVu"
    "dF9uYW1lcyI6IG51bGwsICJjaGFubmVsX25hbWUiOiBudWxsfVBLAQIUAxQAAAAAAAAAIQAruAPWlgAAAJYAAAAN"
    "AAAAAAAAAAAAAACAAQAAAABtYW5pZmVzdC5qc29uUEsBAhQDFAAAAAAAAAAhAJ6QuoJ2BAAAdgQAAAsAAAAAAAAA"
    "AAAAAIABwQAAAGZhY3RvcnMubnB6UEsBAhQDFAAAAAAAAAAhAEWvWx+LAAAAiwAAAAoAAAAAAAAAAAAAAIABYAUA"
    "AHZvY2FiLmpzb25QSwUGAAAAAAMAAwCsAAAAEwYAAAAA"
)


def _v1_model():
    from predictionio_tpu_torch.models.recommendation import model_from_arrays

    return model_from_arrays(np.arange(6, dtype=np.float32).reshape(2, 3) / 4,
                             np.arange(12, dtype=np.float32).reshape(4, 3) / 8,
                             ["a", "b"], ["w", "x", "y", "z"], [0, 1], [2, 3])


def test_a_version_1_blob_deploys_and_one_algorithm_writes_its_bytes(basedir, tmp_path):
    """A blob of an earlier port still deploys, in process and through
    ``deploy``; a one-algorithm template engine writes it byte for byte."""
    import base64

    blob = base64.b64decode(V1_BLOB)
    want = _v1_model()
    assert one_blob("recommendation", want) == blob
    got = one_model("recommendation", blob)
    np.testing.assert_array_equal(got.als.user_factors, want.als.user_factors)
    np.testing.assert_array_equal(got.als.item_factors, want.als.item_factors)
    assert (got.user_index, got.item_ids, got.seen) == (
        want.user_index, want.item_ids, want.seen)
    # recorded as an instance's blob, the deploy serves it
    from predictionio_tpu_torch.data.storage.base import EngineInstance, Model

    basedir(tmp_path / "store")
    engine_json = write_json(tmp_path / "engine.json", VARIANT)
    variant = load_engine_variant(engine_json)
    instances = storage.get_meta_data_engine_instances()
    now = dt.datetime.now(dt.timezone.utc)
    instance_id = instances.insert(EngineInstance(
        status="COMPLETED", start_time=now, end_time=now, engine_id=variant.variant_id,
        engine_version=variant.engine_version, engine_variant=variant.path,
        engine_factory=variant.engine_factory, data_source_params="{}",
        preparator_params="{}", serving_params="{}",
        algorithms_params=json.dumps([{"name": "als", "params": {}}])))
    storage.get_model_data_models().insert(Model(id=instance_id, models=blob))
    query = {"user": "a", "num": 2, "unseenOnly": False}
    [(status, body)] = _serve(engine_json, [query])
    algorithm = ALSAlgorithm(VARIANT["algorithms"][0]["params"], device="cpu")
    assert status == 200 and body == algorithm.predict(want, query)


class _Killed(RuntimeError):
    pass


def _die_after(monkeypatch, step: int) -> None:
    real = torch_checkpoint.CheckpointManager.save

    def save(self, it, state):
        real(self, it, state)
        if it == step:
            raise _Killed(f"killed after iteration {it}")

    monkeypatch.setattr(torch_checkpoint.CheckpointManager, "save", save)


def _spy_starts(monkeypatch) -> list:
    starts = []
    real = torch_common.als_fit

    def spy(*args, **kwargs):
        starts.append(kwargs["start_iteration"])
        return real(*args, **kwargs)

    monkeypatch.setattr(torch_common, "als_fit", spy)
    return starts


def test_resume_continues_only_on_equal_params(basedir, tmp_path, monkeypatch):
    base = basedir(tmp_path / "store")
    fill_store(storage, App, Event, make_events(users=12))
    variant = dict(VARIANT, algorithms=[
        {"name": "als", "params": dict(ALGO, checkpointInterval=1)}])
    engine_json = write_json(tmp_path / "engine.json", variant)
    straight = run_train(load_engine_variant(engine_json), device="cpu")
    _, [straight_model] = load_instance_models(load_engine_variant(engine_json), straight.id)

    with monkeypatch.context() as m:
        _die_after(m, 3)
        with pytest.raises(_Killed):
            run_train(load_engine_variant(engine_json), device="cpu")
    instances = storage.get_meta_data_engine_instances()
    failed = instances.get_latest("store-rec", "1", os.path.abspath(engine_json))
    assert failed.status == "FAILED"
    ckpt_dirs = os.listdir(os.path.join(base, "checkpoints"))
    assert [d for d in ckpt_dirs if d.startswith("als-")]  # keyed by run key
    starts = _spy_starts(monkeypatch)
    resumed = run_train(load_engine_variant(engine_json), WorkflowParams(resume=True),
                        device="cpu")
    assert resumed.id == failed.id and resumed.status == "COMPLETED"
    assert starts == [4]  # the step after the last checkpoint
    assert not [d for d in os.listdir(os.path.join(base, "checkpoints"))
                if d.startswith("als-")]
    _, [model] = load_instance_models(load_engine_variant(engine_json))
    np.testing.assert_array_equal(model.als.user_factors, straight_model.als.user_factors)
    np.testing.assert_array_equal(model.als.item_factors, straight_model.als.item_factors)

    # params changed since the crash: --resume starts a fresh instance
    with monkeypatch.context() as m:
        _die_after(m, 2)
        with pytest.raises(_Killed):
            run_train(load_engine_variant(engine_json), device="cpu")
    crashed = instances.get_latest("store-rec", "1", os.path.abspath(engine_json))
    changed = dict(variant, algorithms=[
        {"name": "als", "params": dict(ALGO, checkpointInterval=1, numIterations=4)}])
    write_json(engine_json, changed)
    starts.clear()
    fresh = run_train(load_engine_variant(engine_json), WorkflowParams(resume=True),
                      device="cpu")
    assert fresh.id != crashed.id and starts == [0]
    assert instances.get(crashed.id).status == "FAILED"


def test_unported_launch_options_raise(basedir, tmp_path):
    """A rank other than 0 of a launch trains but persists nothing: no
    run lock, no instance row, no blob, no checkpoints (alone, without a
    coordinator, its mesh is 1 x 1), the classifiers' as the ALS
    template's; ``pio.profile``, ported since, trains and writes its
    trace and journal."""
    basedir(tmp_path)
    fill_store(storage, App, Event, make_events())
    engine_json = write_json(tmp_path / "engine.json", dict(
        VARIANT, sparkConf={"pio.process_id": 1},
        algorithms=[{"name": "als", "params": dict(ALGO, checkpointInterval=1)}]))
    rank1 = run_train(load_engine_variant(engine_json), device="cpu")
    assert rank1.status == "COMPLETED" and rank1.id is None
    assert storage.get_meta_data_engine_instances().get_all() == []
    assert not os.path.exists(torch_checkpoint._checkpoint_base())
    with open(os.path.join(REPO, "examples", "classification", "engine.json")) as f:
        classify = json.load(f)
    fill_store(storage, App, Event, [
        {"event": "train", "entityType": "message", "entityId": f"m{i}",
         "properties": {"text": text, "label": label},
         "eventTime": f"2024-05-01T00:00:{i:02d}Z", "eventId": f"sms{i:03d}"}
        for i, (text, label) in enumerate([("win cash now", "spam"), ("free prize", "spam"),
                                           ("see you at lunch", "ham"),
                                           ("meeting at noon", "ham")])], app_name="SmsApp")
    classify["datasource"]["params"]["appName"] = "SmsApp"
    classify["sparkConf"] = {"pio.num_processes": 2, "pio.process_id": 1}
    rank1 = run_train(load_engine_variant(write_json(tmp_path / "classify.json", classify)),
                      device="cpu")
    assert rank1.status == "COMPLETED" and rank1.id is None
    assert storage.get_meta_data_engine_instances().get_all() == []
    engine_json = write_json(tmp_path / "engine.json", VARIANT)
    with pytest.raises(LookupError, match="run `pio train` first"):
        cli.build_query_server(engine_json, port=0, device="cpu")
    profile = tmp_path / "prof"
    engine_json = write_json(tmp_path / "engine.json",
                             dict(VARIANT, sparkConf={"pio.profile": str(profile)}))
    instance = run_train(load_engine_variant(engine_json), device="cpu")
    assert instance.status == "COMPLETED"
    assert os.path.exists(profile / f"{instance.id}.pt.trace.json")
    with open(profile / "als-telemetry.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [line["event"] for line in lines] == ["meta"] + ["step"] * ALGO["numIterations"]


def test_two_process_cli_train_records_one_instance(basedir, tmp_path):
    """The launch on the CPU: two ``tools/cli.py train`` processes on one
    sqlite store under the env contract (``PIO_COORDINATOR`` /
    ``PIO_NUM_PROCESSES`` / ``PIO_PROCESS_ID``), a 1 x 2 mesh (ALX
    model-sharded factors, checkpoints every 2 iterations on rank 0).
    Exactly one COMPLETED instance is recorded, with one blob; rank 1
    prints its rank and writes neither a blob nor a checkpoint; the
    launch-scoped keys reach neither the persisted runtime conf nor its
    env; and the deployed answers equal a one-process train's."""
    from test_torch_distributed import free_port

    base = basedir(tmp_path / "store")
    fill_store(storage, App, Event, make_events())
    algo = dict(ALGO, checkpointInterval=2)
    launch = write_json(tmp_path / "launch.json", dict(
        VARIANT, algorithms=[{"name": "als", "params": algo}],
        sparkConf={"pio.mesh_shape": [1, 2], "pio.num_processes": 2}))
    instance_id = _two_process_train(base, launch)
    recorded = storage.get_meta_data_engine_instances().get_all()
    assert [(i.id, i.status) for i in recorded] == [(instance_id, "COMPLETED")]
    assert recorded[0].runtime_conf == {"pio.mesh_shape": [1, 2]}
    assert not any(k in recorded[0].env for k in ("PIO_COORDINATOR", "PIO_PROCESS_ID"))
    models = storage.get_model_data_models()
    assert models.get(instance_id) is not None
    checkpoints = torch_checkpoint._checkpoint_base()
    assert not os.path.exists(checkpoints) or os.listdir(checkpoints) == []

    one = write_json(tmp_path / "one.json", dict(
        VARIANT, id="store-rec-one", algorithms=[{"name": "als", "params": algo}]))
    single = run_train(load_engine_variant(one), device="cpu")
    queries = [{"user": f"u{u}", "num": 6} for u in range(0, 30, 3)]
    got = _serve(launch, queries, engine_instance_id=instance_id)
    want = _serve(one, queries, engine_instance_id=single.id)
    for (g_status, g), (w_status, w) in zip(got, want):
        assert g_status == w_status == 200
        assert [e["item"] for e in g["itemScores"]] == [e["item"] for e in w["itemScores"]]
        np.testing.assert_allclose([e["score"] for e in g["itemScores"]],
                                   [e["score"] for e in w["itemScores"]], atol=1e-4)


#: the neural templates' shipped engine.jsons, cut to this store's size
NEURAL = {
    "ncf": {"embedDim": 8, "hidden": [16, 8], "epochs": 2, "batchSize": 32,
            "learningRate": 0.01, "seed": 1},
    "sequence": {"embedDim": 8, "numHeads": 2, "numBlocks": 1, "ffnDim": 16, "epochs": 2,
                 "batchSize": 8, "learningRate": 0.01, "seed": 1},
}


@pytest.mark.parametrize("template,shape,seq_parallel", [
    ("ncf", [2, 1], None), ("ncf", [1, 2], None), ("sequence", [2, 1], "ring"),
    ("sequence", [1, 2], "ring"), ("sequence", [1, 2], "ulysses")])
def test_two_process_cli_train_of_the_neural_templates(basedir, tmp_path, template, shape,
                                                       seq_parallel):
    """``examples/ncf/engine.json`` (batch over ``data`` or params over
    ``model``) and ``examples/sequence/engine.json`` (its ``("data",
    "seq")`` axes; ring attention or Ulysses over ``seq``) trained by two
    ``tools/cli.py train`` processes on one store: one COMPLETED
    instance, recorded by rank 0; its params within 1e-4 of a one-process
    train's of the same store and engine.json, and the deployed answers
    the same items with scores within 1e-4."""
    base = basedir(tmp_path / "store")
    fill_store(storage, App, Event, make_events())
    with open(os.path.join(REPO, "examples", template, "engine.json")) as f:
        variant = json.load(f)
    variant["datasource"]["params"]["appName"] = "StoreApp"
    algorithm = variant["algorithms"][0]
    algorithm["params"] = dict(algorithm["params"], **NEURAL[template])
    if template == "sequence":
        variant["preparator"]["params"]["maxLen"] = 8
        algorithm["params"]["seqParallel"] = seq_parallel
    one = write_json(tmp_path / "one.json", variant)
    variant["sparkConf"] = dict(variant["sparkConf"], **{"pio.mesh_shape": shape,
                                                          "pio.num_processes": 2})
    launch = write_json(tmp_path / "launch.json", variant)
    instance_id = _two_process_train(base, launch)
    recorded = storage.get_meta_data_engine_instances().get_all()
    assert [(i.id, i.status) for i in recorded] == [(instance_id, "COMPLETED")]
    single = run_train(load_engine_variant(one), device="cpu")
    _, [got] = load_instance_models(load_engine_variant(launch), instance_id)
    _, [want] = load_instance_models(load_engine_variant(one), single.id)
    assert got.state.keys() == want.state.keys()
    for name in want.state:
        np.testing.assert_allclose(got.state[name], want.state[name], atol=1e-4, err_msg=name)
    queries = [{"user": f"u{u}", "num": 6} for u in range(0, 30, 3)]
    got_answers = _serve(launch, queries, engine_instance_id=instance_id)
    want_answers = _serve(one, queries, engine_instance_id=single.id)
    for (g_status, g), (w_status, w) in zip(got_answers, want_answers):
        assert g_status == w_status == 200 and g["itemScores"]
        np.testing.assert_allclose([e["score"] for e in g["itemScores"]],
                                   [e["score"] for e in w["itemScores"]], atol=1e-4)
        assert [e["item"] for e in g["itemScores"]] == [e["item"] for e in w["itemScores"]]


def _two_process_train(base: str, variant: str, *flags: str) -> str:
    """``tools/cli.py train --variant VARIANT --device cpu FLAGS`` in two
    processes on the store at ``base``, under the launch contract's env
    (a fresh coordinator port), both killed past the timeout. Both exit
    0, rank 1 says it trained and records nothing; returns the instance
    id rank 0 printed."""
    from test_torch_distributed import free_port

    env = dict(os.environ, PYTHONPATH=REPO, PIO_FS_BASEDIR=base, OMP_NUM_THREADS="1",
               PIO_COORDINATOR=f"127.0.0.1:{free_port()}")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.cli", "train", "--variant",
         variant, "--device", "cpu", *flags], env=dict(env, PIO_PROCESS_ID=str(rank)),
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "Training completed on rank 1" in outs[1] and "Engine instance ID" not in outs[1]
    storage.reset()
    return outs[0].split("Engine instance ID:")[1].split()[0]


def test_two_process_streaming_reader_train_matches_one_process(basedir, tmp_path):
    """The streaming reader's multi-rank half through the command line:
    two ``train --snapshot-mode refresh --als-feed streamed`` processes of
    a ``"reader": "streaming"`` variant on a 1 x 2 mesh. The ranks agree
    on rank 0's scan bound, rank 0 readies the snapshot before rank 1
    loads it, the block store is laid out for the mesh (rank 0 builds it,
    rank 1 reads its rows of every block), and the model-sharded streamed
    fit runs. One COMPLETED instance is recorded; its factors are within
    1e-4 of a one-process streamed train's of the same store, and the
    deployed answers equal it."""
    base = basedir(tmp_path / "store")
    fill_store(storage, App, Event, make_events())
    streaming = dict(VARIANT["datasource"]["params"], reader="streaming")
    launch = write_json(tmp_path / "launch.json", dict(
        VARIANT, datasource={"params": streaming},
        sparkConf={"pio.mesh_shape": [1, 2], "pio.num_processes": 2}))
    flags = ("--snapshot-mode", "refresh", "--als-feed", "streamed")
    instance_id = _two_process_train(base, launch, *flags)
    recorded = storage.get_meta_data_engine_instances().get_all()
    assert [(i.id, i.status) for i in recorded] == [(instance_id, "COMPLETED")]
    stores = lambda: sorted(glob.glob(os.path.join(
        base, "**", "gen-*", "blocks", "blocks-*", "manifest.json"), recursive=True))
    assert len(stores()) == 1  # one block store, built by rank 0, read by both

    one = write_json(tmp_path / "one.json", dict(
        VARIANT, id="store-rec-one", datasource={"params": streaming}))
    assert cli.main(["train", "--variant", one, "--device", "cpu", *flags]) == 0
    storage.reset()
    single = [i for i in storage.get_meta_data_engine_instances().get_all()
              if i.id != instance_id]
    assert [i.status for i in single] == ["COMPLETED"]
    assert len(stores()) == 2  # the one-process packing is a store of its own
    _, [got] = load_instance_models(load_engine_variant(launch), instance_id)
    _, [want] = load_instance_models(load_engine_variant(one), single[0].id)
    assert got.user_index == want.user_index and got.item_ids == want.item_ids
    np.testing.assert_allclose(got.als.user_factors, want.als.user_factors, atol=1e-4)
    np.testing.assert_allclose(got.als.item_factors, want.als.item_factors, atol=1e-4)
    queries = [{"user": f"u{u}", "num": 6} for u in range(0, 30, 3)]
    got_answers = _serve(launch, queries, engine_instance_id=instance_id)
    want_answers = _serve(one, queries, engine_instance_id=single[0].id)
    for (g_status, g), (w_status, w) in zip(got_answers, want_answers):
        assert g_status == w_status == 200
        assert [e["item"] for e in g["itemScores"]] == [e["item"] for e in w["itemScores"]]
        np.testing.assert_allclose([e["score"] for e in g["itemScores"]],
                                   [e["score"] for e in w["itemScores"]], atol=1e-4)


def _start(args, env):
    """A verb of the port's CLI in its own process; returns it and the
    port it printed."""
    proc = subprocess.Popen([sys.executable, "-m", "predictionio_tpu_torch.tools.cli", *args],
                            env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line:
        proc.kill()
        raise AssertionError(proc.stderr.read())
    return proc, int(line.split("http://", 1)[1].split()[0].rsplit(":", 1)[1].rstrip(")"))


def test_the_cli_walks_app_events_import_train_deploy(basedir, tmp_path, capsys):
    base = basedir(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=REPO, PIO_FS_BASEDIR=base)
    assert cli.main(["app", "new", "WalkApp"]) == 0
    said = capsys.readouterr().out
    app_id = int(said.split("ID: ")[1].split()[0])
    key = said.split("Access Key: ")[1].split()[0]
    events = make_events(users=16)
    posted, imported = events[:300], events[300:]
    server, port = _start(["eventserver", "--ip", "127.0.0.1", "--port", "0"], env)
    try:
        for start in range(0, len(posted), 50):
            r = requests.post(f"http://127.0.0.1:{port}/batch/events.json",
                              params={"accessKey": key}, json=posted[start:start + 50],
                              timeout=30)
            assert r.status_code == 200 and {x["status"] for x in r.json()} == {201}
    finally:
        server.terminate()
        server.wait(timeout=30)
    src = tmp_path / "more.jsonl"
    src.write_text("".join(json.dumps(e) + "\n" for e in imported))
    assert cli.main(["import", "--appid", str(app_id), "--input", str(src)]) == 0
    variant = dict(VARIANT, datasource={"params": {"appName": "WalkApp",
                                                   "eventNames": ["rate", "buy"]}})
    engine_dir = tmp_path / "engine"
    engine_dir.mkdir()
    write_json(engine_dir / "engine.json", variant)
    assert cli.main(["train", "--engine-dir", str(engine_dir), "--device", "cpu"]) == 0
    instance_id = capsys.readouterr().out.split("Engine instance ID: ")[1].split()[0]
    _, [model] = load_instance_models(load_engine_variant(str(engine_dir / "engine.json")))
    assert len(model.user_index) == 16

    deploy, port = _start(["deploy", "--engine-dir", str(engine_dir), "--device", "cpu",
                           "--port", "0"], env)
    try:
        algo = ALSAlgorithm(ALGO, device="cpu")
        for q in ({"user": "u1", "num": 5}, {"items": ["s1"], "num": 3}):
            got = requests.post(f"http://127.0.0.1:{port}/queries.json", json=q, timeout=30)
            assert got.status_code == 200 and got.json() == algo.predict(model, q)
    finally:
        deploy.terminate()
        deploy.wait(timeout=30)
    instance = storage.get_meta_data_engine_instances().get(instance_id)
    assert instance.status == "COMPLETED"
    assert cli.main(["export", "--appid", str(app_id), "--output",
                     str(tmp_path / "out.jsonl")]) == 0
    assert len((tmp_path / "out.jsonl").read_text().splitlines()) == len(events)


def test_deploy_can_turn_the_live_seen_filter_on(basedir, tmp_path):
    """A model trained with the trained-in seen map is deployed with
    ``seenFilter: "live"`` at the same variant path:
    the instance resolves, and an item the user buys after training drops
    out of the user's list at once."""
    basedir(tmp_path / "store")
    app_id = fill_store(storage, App, Event, make_events(users=12))
    engine_json = write_json(tmp_path / "engine.json", VARIANT)
    run_train(load_engine_variant(engine_json), device="cpu")
    query = {"user": "u3", "num": 6}
    (_, before), = _serve(engine_json, [query])
    top = before["itemScores"][0]["item"]
    storage.get_l_events().insert(Event(event="buy", entity_type="user", entity_id="u3",
                                        target_entity_type="item", target_entity_id=top),
                                  app_id)
    (_, unchanged), = _serve(engine_json, [query])
    assert unchanged == before  # the trained-in map knows nothing of the new event
    live = dict(ALGO, seenFilter="live")
    write_json(engine_json, dict(VARIANT, algorithms=[{"name": "als", "params": live}]))
    (_, after), = _serve(engine_json, [query])
    items = [s["item"] for s in after["itemScores"]]
    assert top not in items and items[:5] == [s["item"] for s in before["itemScores"]][1:]
