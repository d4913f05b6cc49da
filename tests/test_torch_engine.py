"""The port's DASE ``Engine`` against the JAX package's, on the CPU.

A user engine module is written into an engine directory twice: a copy
of ``tests/fake_engine.py`` against ``predictionio_tpu.controller`` and
the same engine against ``predictionio_tpu_torch.controller``, each
with an ``AverageServing`` variant, a datasource sanity threshold
(``minRatings``) and the datasource's online handle. engine.json names
the module's factory (``engineFactory``), resolved from the engine
directory. Both packages run it on the same seeded rate events (numpy
``default_rng(0)``), each on its own store, and the port's results must
equal the reference's exactly (these engines compute on the host):
multi-algorithm training, deploy answers through ``FirstServing`` and
``AverageServing``, retrain-on-deploy, the ``PersistentModel`` round
trip, a sanity-check failure and ``--skip-sanity-check``, the evaluation
leaderboard, batchpredict rows, the micro-batched serving path, and the
retrain loop's publish and swap.

A second user engine combines the port's recommendation and NCF
templates: the recommendation datasource, a preparator returning both
ALS's CSR and NCF's COO, an ``ALSAlgorithm`` and an ``NCFAlgorithm``
subclass each taking its half, and a Serving returning both predictions
by name. Against the same engine on the JAX package: the ALS factors
within ``atol`` 1e-4 and each served ALS list the same up to near-ties
within 1e-4 (``tests/test_torch_store_train.py``, ``test_torch_eval``'s
``same_ranking``), the NCF COO equal, the JAX-trained NCF model carried
into the port answering as the reference within ``rtol`` 2e-4 /
``atol`` 2e-5 (``test_torch_ncf_train.same_response``), and every served
NCF part equal to the port's own ``NCFAlgorithm.predict`` of the
blob's model.
"""

import datetime as dt
import json
import os
import sys
import threading

import numpy as np
import pytest
import requests

from predictionio_tpu.data import storage as jax_storage
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.base import App as JaxApp
from predictionio_tpu.tools import cli as jax_cli
from predictionio_tpu.workflow import batch_predict as jax_batch_predict
from predictionio_tpu.workflow import core_workflow as jax_workflow
from predictionio_tpu.workflow.create_server import create_query_server as jax_serve
from predictionio_tpu.workflow.json_extractor import build_engine as jax_build_engine
from predictionio_tpu.workflow.json_extractor import (
    load_engine_variant as jax_load_variant,
)
from predictionio_tpu_torch.controller import Engine, TrainContext
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow import batch_predict, core_workflow
from predictionio_tpu_torch.workflow.create_server import create_query_server
from predictionio_tpu_torch.workflow.json_extractor import build_engine, load_engine_variant
from predictionio_tpu_torch.workflow.microbatch import BatchConfig
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401
from test_torch_store_train import basedir, fill_store  # noqa: F401

APP = "RateApp"
#: the engine module of each package, by module name
MODULES = {"jax": "jax_user_engine", "port": "port_user_engine"}
CONTROLLER = {"jax": "predictionio_tpu", "port": "predictionio_tpu_torch"}

#: tests/fake_engine.py against ``{pkg}``, with a sanity threshold, the
#: datasource's online handle and an AverageServing factory
USER_ENGINE = '''\
"""Fake DASE components: a tiny deterministic 'mean rating' engine."""

from __future__ import annotations

from dataclasses import dataclass

from {pkg}.controller import (
    Algorithm,
    AverageServing,
    DataSource,
    Engine,
    EvalInfo,
    FirstServing,
    Preparator,
)
from {pkg}.controller.base import PersistentModel, SanityCheck
from {pkg}.data.store import PEventStore
from {pkg}.models._streaming import build_streaming_handle


@dataclass
class TrainingData(SanityCheck):
    ratings: list[tuple[str, str, float]]  # (user, item, rating)
    min_ratings: int = 1

    def sanity_check(self) -> None:
        if len(self.ratings) < self.min_ratings:
            raise ValueError(f"{{len(self.ratings)}} rating events, fewer than "
                             f"{{self.min_ratings}}")


class FakeDataSource(DataSource):
    def read_training(self, ctx) -> TrainingData:
        events = PEventStore.find(self.params.appName, event_names=["rate"])
        return TrainingData(
            [
                (e.entity_id, e.target_entity_id, e.properties.get_double("rating"))
                for e in events
            ],
            self.params.get_or("minRatings", 1),
        )

    def read_eval(self, ctx):
        td = self.read_training(ctx)
        k = self.params.get_or("folds", 2)
        folds = []
        for i in range(k):
            train = TrainingData([r for j, r in enumerate(td.ratings) if j % k != i])
            test = [r for j, r in enumerate(td.ratings) if j % k == i]
            queries = [({{"user": u, "item": it}}, rating) for u, it, rating in test]
            folds.append((train, EvalInfo(fold=i), queries))
        return folds

    def online_handle(self):
        return build_streaming_handle(self.params, ["rate"])


class FakePreparator(Preparator):
    def prepare(self, ctx, training_data: TrainingData):
        return training_data


class MeanModel:
    def __init__(self, mean: float):
        self.mean = mean


class FakeAlgorithm(Algorithm):
    """Predicts the global mean rating (+ optional bias param)."""

    def train(self, ctx, prepared_data: TrainingData) -> MeanModel:
        ratings = [r for _, _, r in prepared_data.ratings]
        return MeanModel(sum(ratings) / len(ratings) + self.params.get_or("bias", 0.0))

    def predict(self, model: MeanModel, query) -> dict:
        return {{"rating": model.mean}}


class RetrainAlgorithm(FakeAlgorithm):
    persist_model = False


class PoisonableAlgorithm(FakeAlgorithm):
    def predict(self, model: MeanModel, query) -> dict:
        if isinstance(query, dict) and query.get("boom"):
            raise ValueError("poison query")
        return super().predict(model, query)


class SelfSavingModel(PersistentModel, MeanModel):
    saved: dict[str, float] = {{}}

    def save(self, instance_id: str, params) -> bool:
        SelfSavingModel.saved[instance_id] = self.mean
        return True

    @classmethod
    def load(cls, instance_id: str, params) -> "SelfSavingModel":
        return cls(cls.saved[instance_id])


class PersistentAlgorithm(FakeAlgorithm):
    def train(self, ctx, prepared_data):
        base = super().train(ctx, prepared_data)
        return SelfSavingModel(base.mean)


ALGORITHMS = {{
    "mean": FakeAlgorithm,
    "retrain": RetrainAlgorithm,
    "persistent": PersistentAlgorithm,
    "poisonable": PoisonableAlgorithm,
}}


def engine_factory() -> Engine:
    return Engine(
        data_source_class=FakeDataSource,
        preparator_class=FakePreparator,
        algorithm_class_map=ALGORITHMS,
        serving_class=FirstServing,
    )


def average_engine_factory() -> Engine:
    return Engine(FakeDataSource, FakePreparator, ALGORITHMS, AverageServing)
'''


def rate_events(seed: int = 0, users: int = 12, items: int = 8, n: int = 40) -> list[dict]:
    """``n`` rate events of integer stars, an hour old, one a second."""
    rng = np.random.default_rng(seed)
    base = dt.datetime.now(dt.timezone.utc) - dt.timedelta(hours=1)
    return [
        {"eventId": f"ev{k:04d}", "event": "rate", "entityType": "user",
         "entityId": f"u{rng.integers(users)}", "targetEntityType": "item",
         "targetEntityId": f"i{rng.integers(items)}",
         "properties": {"rating": int(rng.integers(1, 6))},
         "eventTime": (base + dt.timedelta(seconds=k)).isoformat()}
        for k in range(n)
    ]


@pytest.fixture()
def stores(basedir, tmp_path):  # noqa: F811
    """``use("jax" | "port")`` points both registries at that package's
    store; each holds the same events under ``APP``."""
    events = rate_events()
    paths = {name: str(tmp_path / f"store-{name}") for name in ("jax", "port")}
    basedir(paths["jax"])
    fill_store(jax_storage, JaxApp, JaxEvent, events, app_name=APP)
    basedir(paths["port"])
    fill_store(storage, App, Event, events, app_name=APP)
    return lambda name: basedir(paths[name])


def write_engine(root, pkg: str, algorithms: list[dict], factory="engine_factory",
                 engine_id="user-engine", **datasource) -> str:
    """The user engine module of ``pkg`` and an engine.json naming its
    ``factory``, in the engine directory ``root/pkg``; returns the
    engine.json's path."""
    engine_dir = os.path.join(str(root), pkg)
    os.makedirs(engine_dir, exist_ok=True)
    with open(os.path.join(engine_dir, f"{MODULES[pkg]}.py"), "w") as f:
        f.write(USER_ENGINE.format(pkg=CONTROLLER[pkg]))
    path = os.path.join(engine_dir, "engine.json")
    with open(path, "w") as f:
        json.dump({"id": engine_id, "engineFactory": f"{MODULES[pkg]}.{factory}",
                   "datasource": {"params": {"appName": APP, **datasource}},
                   "algorithms": algorithms}, f)
    return path


def both_engines(tmp_path, algorithms, **kw) -> dict:
    return {pkg: write_engine(tmp_path, pkg, algorithms, **kw) for pkg in ("jax", "port")}


class Deployed:
    """A query server of one package in a thread."""

    def __init__(self, pkg: str, engine_json: str, batching: BatchConfig | None = None):
        if pkg == "jax":
            from predictionio_tpu.workflow.microbatch import BatchConfig as JaxBatchConfig

            config = None if batching is None else JaxBatchConfig(
                max_batch_size=batching.max_batch_size, window_ms=batching.window_ms)
            self.thread, self.service = jax_serve(
                jax_load_variant(engine_json), host="127.0.0.1", port=0, batching=config)
        else:
            self.thread, self.service = create_query_server(
                load_engine_variant(engine_json), host="127.0.0.1", port=0, device="cpu",
                batching=batching)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.thread.port}"

    def query(self, obj) -> tuple[int, dict]:
        r = requests.post(f"{self.url}/queries.json", json=obj, timeout=60)
        return r.status_code, r.json()

    def close(self):
        self.thread.stop()
        self.service.close()


def run_train(pkg: str, engine_json: str, skip_sanity_check: bool = False):
    if pkg == "jax":
        params = jax_workflow.WorkflowParams(skip_sanity_check=skip_sanity_check)
        return jax_workflow.run_train(jax_load_variant(engine_json), params)
    params = core_workflow.WorkflowParams(skip_sanity_check=skip_sanity_check)
    return core_workflow.run_train(load_engine_variant(engine_json), params, device="cpu")


def served(stores, engine_jsons: dict, queries: list, batching=None) -> dict:
    """Each package trains its engine.json on its store, deploys it and
    answers ``queries``: ``{pkg: [(status, body), ...]}``."""
    out = {}
    for pkg, engine_json in engine_jsons.items():
        stores(pkg)
        run_train(pkg, engine_json)
        server = Deployed(pkg, engine_json, batching)
        try:
            out[pkg] = [server.query(q) for q in queries]
        finally:
            server.close()
    return out


QUERIES = [{"user": "u1"}, {"user": "u3", "item": "i2"}, {}]
PAIR = [{"name": "mean", "params": {}}, {"name": "mean", "params": {"bias": 1.0}}]


@pytest.mark.parametrize("bias", [0.0, 1.0])
def test_multi_algorithm_train_equals_the_reference(stores, tmp_path, bias):
    engine_jsons = both_engines(tmp_path, [{"name": "mean", "params": {}},
                                           {"name": "mean", "params": {"bias": bias}},
                                           {"name": "poisonable", "params": {"bias": 2.0}}])
    stores("jax")
    jax_variant = jax_load_variant(engine_jsons["jax"])
    from predictionio_tpu.workflow.context import RuntimeContext

    want = jax_build_engine(jax_variant).train(RuntimeContext(), jax_variant.engine_params)
    stores("port")
    variant = load_engine_variant(engine_jsons["port"])
    engine = build_engine(variant)
    assert isinstance(engine, Engine)
    ctx = TrainContext(device="cpu")
    got = engine.train(ctx, variant.engine_params)
    assert [m.mean for m in got] == [m.mean for m in want]
    assert got[1].mean == got[0].mean + bias and got[2].mean == got[0].mean + 2.0
    assert set(ctx.timings) == {"read", "prepare", "train[mean]", "train[poisonable]"}
    # through the verb: one instance, its blob holding each block's model
    instance = run_train("port", engine_jsons["port"])
    _, models = core_workflow.load_instance_models(variant, instance.id, device="cpu")
    assert [m.mean for m in models] == [m.mean for m in want]


@pytest.mark.parametrize("factory", ["engine_factory", "average_engine_factory"])
def test_deploy_answers_equal_the_reference(stores, tmp_path, factory):
    """FirstServing answers the first block's prediction and
    AverageServing the mean of both, as the reference's."""
    answers = served(stores, both_engines(tmp_path, PAIR, factory=factory), QUERIES)
    assert answers["port"] == answers["jax"]
    ratings = [e["properties"]["rating"] for e in rate_events()]
    want = sum(ratings) / len(ratings) + (0.5 if factory == "average_engine_factory" else 0)
    assert answers["port"] == [(200, {"rating": pytest.approx(want)})] * len(QUERIES)


def test_reload_and_a_second_train_equal_the_reference(stores, tmp_path):
    """``/reload`` swaps a deploy to the latest instance in both."""
    out = {}
    for pkg in ("jax", "port"):
        stores(pkg)
        engine_json = write_engine(tmp_path, pkg, PAIR[:1])
        run_train(pkg, engine_json)
        server = Deployed(pkg, engine_json)
        try:
            first = server.query({})[1]
            biased = write_engine(tmp_path, pkg, [{"name": "mean", "params": {"bias": 10.0}}])
            run_train(pkg, biased)
            assert requests.get(f"{server.url}/reload", timeout=60).status_code == 200
            out[pkg] = (first, server.query({})[1])
        finally:
            server.close()
    assert out["port"] == out["jax"]
    assert out["port"][1]["rating"] == pytest.approx(out["port"][0]["rating"] + 10.0)


def test_retrain_on_deploy_equals_the_reference(stores, tmp_path):
    engine_jsons = both_engines(tmp_path, [{"name": "retrain", "params": {}},
                                           {"name": "mean", "params": {"bias": 1.0}}],
                                factory="average_engine_factory")
    answers = served(stores, engine_jsons, QUERIES)
    assert answers["port"] == answers["jax"]
    stores("port")
    instance = core_workflow.resolve_engine_instance(load_engine_variant(engine_jsons["port"]))
    blob = storage.get_model_data_models().get(instance.id).models
    import zipfile
    import io

    manifest = json.loads(zipfile.ZipFile(io.BytesIO(blob)).read("manifest.json"))
    assert [(e["algorithm"], e["kind"]) for e in manifest["algorithms"]] == [
        ("retrain", "retrain"), ("mean", "pickle")]


def test_persistent_model_round_trip_equals_the_reference(stores, tmp_path):
    import importlib

    engine_jsons = both_engines(tmp_path, [{"name": "persistent", "params": {}}])
    answers = served(stores, engine_jsons, QUERIES)
    assert answers["port"] == answers["jax"]
    stores("port")
    instance = core_workflow.resolve_engine_instance(load_engine_variant(engine_jsons["port"]))
    module = importlib.import_module(MODULES["port"])
    assert module.SelfSavingModel.saved[instance.id] == answers["port"][0][1]["rating"]
    _, [model] = core_workflow.load_instance_models(
        load_engine_variant(engine_jsons["port"]), device="cpu")
    assert type(model) is module.SelfSavingModel


def test_sanity_check_failure_and_skip_equal_the_reference(stores, tmp_path, capsys):
    """A datasource below its ``minRatings`` fails ``pio train`` in both
    (the instance FAILED); ``--skip-sanity-check`` trains the same data
    in both."""
    engine_jsons = both_engines(tmp_path, PAIR, minRatings=1000)
    errors, models = {}, {}
    for pkg, main, registry in (("jax", jax_cli.main, jax_storage), ("port", cli.main, storage)):
        stores(pkg)
        argv = ["train", "--variant", engine_jsons[pkg]]
        device = ["--device", "cpu"] if pkg == "port" else []
        with pytest.raises(ValueError) as failed:
            main(argv + device)
        errors[pkg] = str(failed.value)
        [instance] = registry.get_meta_data_engine_instances().get_all()
        assert instance.status == "FAILED"
        assert main(argv + device + ["--skip-sanity-check"]) == 0
        out = capsys.readouterr().out
        assert "Engine instance ID" in out
        models[pkg] = registry.get_meta_data_engine_instances().get_latest_completed(
            "user-engine", "1", os.path.abspath(engine_jsons[pkg])).id
    assert errors["port"] == errors["jax"] == "40 rating events, fewer than 1000"
    stores("port")
    _, got = core_workflow.load_instance_models(load_engine_variant(engine_jsons["port"]),
                                                device="cpu")
    ratings = [e["properties"]["rating"] for e in rate_events()]
    assert [m.mean for m in got] == [sum(ratings) / len(ratings),
                                     sum(ratings) / len(ratings) + 1.0]


def test_evaluation_leaderboard_equals_the_reference(stores, tmp_path):
    import importlib

    from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
    from predictionio_tpu.controller.metrics import EngineParamsGenerator as JaxGenerator
    from predictionio_tpu.controller.metrics import Evaluation as JaxEvaluation
    from predictionio_tpu.controller.metrics import OptionAverageMetric as JaxMetric
    from predictionio_tpu_torch.controller import (
        EngineParams,
        EngineParamsGenerator,
        Evaluation,
        OptionAverageMetric,
    )

    both_engines(tmp_path, PAIR)
    for pkg in ("jax", "port"):
        sys.path.insert(0, os.path.join(str(tmp_path), pkg))

    def absolute_error(eval_info, query, prediction, actual):
        return -abs(prediction["rating"] - actual)

    candidates = [{"datasource": {"params": {"appName": APP, "folds": 3}},
                   "algorithms": [{"name": "mean", "params": {"bias": b}},
                                  {"name": "mean", "params": {"bias": 2 * b}}]}
                  for b in (0.0, 0.5, -0.25)]
    results = {}
    for pkg, evaluation, metric, generator, params, run in (
            ("jax", JaxEvaluation, JaxMetric, JaxGenerator, JaxEngineParams,
             jax_workflow.run_evaluation),
            ("port", Evaluation, OptionAverageMetric, EngineParamsGenerator, EngineParams,
             lambda *a: core_workflow.run_evaluation(*a, device="cpu"))):
        stores(pkg)
        engine = importlib.import_module(MODULES[pkg]).average_engine_factory()
        instance = run(evaluation(engine=engine, metric=metric(score=absolute_error)),
                       generator([params.from_json_obj(c) for c in candidates]))
        assert instance.status == "COMPLETED"
        results[pkg] = instance
    assert results["port"].evaluator_results == results["jax"].evaluator_results
    assert json.loads(results["port"].evaluator_results_json) == json.loads(
        results["jax"].evaluator_results_json)
    assert "<= BEST" in results["port"].evaluator_results


def test_batch_predict_rows_equal_the_reference(stores, tmp_path):
    engine_jsons = both_engines(tmp_path, PAIR + [{"name": "poisonable", "params": {}}],
                                factory="average_engine_factory")
    queries = tmp_path / "q.jsonl"
    queries.write_text("".join(json.dumps(q) + "\n" for q in QUERIES + [{"boom": True}]))
    rows = {}
    for pkg in ("jax", "port"):
        stores(pkg)
        run_train(pkg, engine_jsons[pkg])
        out = tmp_path / f"{pkg}.jsonl"
        if pkg == "jax":
            count = jax_batch_predict.run_batch_predict(
                jax_load_variant(engine_jsons[pkg]), str(queries), str(out))
            rows[pkg] = [json.loads(line) for line in out.read_text().splitlines()]
            continue
        # a query every algorithm scores: the port's rows equal the
        # reference's; one an algorithm raises on is the port's
        # departure (it fails the run, not the row)
        clean = tmp_path / "clean.jsonl"
        clean.write_text("".join(json.dumps(q) + "\n" for q in QUERIES))
        count = batch_predict.run_batch_predict(
            load_engine_variant(engine_jsons[pkg]), str(clean), str(out), device="cpu")
        assert count == len(QUERIES)
        rows[pkg] = [json.loads(line) for line in out.read_text().splitlines()]
        with pytest.raises(ValueError, match="poison query"):
            batch_predict.run_batch_predict(
                load_engine_variant(engine_jsons[pkg]), str(queries),
                str(tmp_path / "poisoned.jsonl"), device="cpu")
    assert rows["port"] == rows["jax"][:len(QUERIES)]
    assert rows["jax"][-1]["error"] == "poison query"
    assert all("prediction" in row for row in rows["port"])


def test_micro_batched_serving_equals_the_reference(stores, tmp_path):
    """Concurrent queries coalesce into batches (``serve_batch`` of the
    engine's Serving); a poisoned query fails alone, as in the
    reference."""
    engine_jsons = both_engines(tmp_path, PAIR + [{"name": "poisonable", "params": {}}],
                                factory="average_engine_factory")
    queries = [{"user": f"u{k}"} for k in range(12)] + [{"boom": True}]
    out = {}
    for pkg in ("jax", "port"):
        stores(pkg)
        run_train(pkg, engine_jsons[pkg])
        server = Deployed(pkg, engine_jsons[pkg],
                          BatchConfig(max_batch_size=16, window_ms=50.0))
        try:
            answers: dict = {}
            threads = [threading.Thread(target=lambda k=k, q=q: answers.__setitem__(
                k, server.query(q))) for k, q in enumerate(queries)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            out[pkg] = [answers[k] for k in range(len(queries))]
            if pkg == "port":
                assert server.service._batcher is not None
                text = requests.get(f"{server.url}/metrics", timeout=60).text
                flushes = [line for line in text.splitlines()
                           if line.startswith("pio_serving_batch_size_count")]
                assert flushes and 1 <= float(flushes[0].split()[-1]) < len(queries)
        finally:
            server.close()
    assert [s for s, _ in out["port"]] == [s for s, _ in out["jax"]]
    assert out["port"][:-1] == out["jax"][:-1]
    assert out["port"][-1][0] >= 400 and out["port"][0][0] == 200


def ingest(pkg: str, wal_dir: str, user: str, item: str, rating: float, app_id: int) -> int:
    """The event server's durable cycle for one event of ``pkg``: WAL
    append + fsync -> storage flush -> checkpoint."""
    import importlib

    root = CONTROLLER[pkg]
    wal_mod = importlib.import_module(f"{root}.data.wal")
    ingest_mod = importlib.import_module(f"{root}.data.ingest")
    event_mod = importlib.import_module(f"{root}.data.event")
    registry = jax_storage if pkg == "jax" else storage
    event = event_mod.Event(
        event="rate", entity_type="user", entity_id=user, target_entity_type="item",
        target_entity_id=item, properties=event_mod.DataMap({"rating": rating}),
        event_time=dt.datetime.now(dt.timezone.utc) - dt.timedelta(seconds=1)).with_id()
    wal = wal_mod.WriteAheadLog(wal_dir)
    try:
        seqno = wal.append(ingest_mod.wal_payload(event, app_id, None))
        wal.sync()
        registry.get_l_events().insert_batch([(event, app_id, None)], on_duplicate="ignore")
        wal.checkpoint(seqno)
    finally:
        wal.close()
    return seqno


def test_retrain_loop_publish_and_swap_equal_the_reference(stores, tmp_path):
    """The user engine has no ``fold_in``: a WAL window escalates to a
    full retrain through the engine, registry version 1 is published and
    a deployed server swaps to it; its answers equal the reference's."""
    from predictionio_tpu.online.loop import RetrainConfig as JaxRetrainConfig
    from predictionio_tpu.online.loop import RetrainLoop as JaxRetrainLoop
    from predictionio_tpu_torch.online.loop import RetrainConfig, RetrainLoop

    engine_jsons = both_engines(tmp_path, PAIR, factory="average_engine_factory")
    out = {}
    for pkg in ("jax", "port"):
        base = stores(pkg)
        run_train(pkg, engine_jsons[pkg])
        server = Deployed(pkg, engine_jsons[pkg])
        wal_dir = os.path.join(base, "wal")
        try:
            before = server.query({})[1]
            ingest(pkg, wal_dir, "fresh", "i3", 5.0, app_id=1)
            ingest(pkg, wal_dir, "u2", "i1", 5.0, app_id=1)
            if pkg == "jax":
                loop = JaxRetrainLoop(jax_load_variant(engine_jsons[pkg]), JaxRetrainConfig(
                    notify_urls=[server.url], wal_dir=wal_dir))
            else:
                loop = RetrainLoop(load_engine_variant(engine_jsons[pkg]), RetrainConfig(
                    notify_urls=[server.url], wal_dir=wal_dir), device="cpu")
            assert loop.run_once() == "full_retrain"
            latest = loop.registry.latest()
            assert (latest.version, latest.source) == (1, "train")
            version = requests.get(f"{server.url}/", timeout=60).json()["modelVersion"]
            out[pkg] = (before, server.query({})[1], version, [m.mean for m in loop.models])
        finally:
            server.close()
    assert out["port"] == out["jax"]
    assert out["port"][2] == 1 and out["port"][1] != out["port"][0]


# ---------------------------------------------------------------------------
# the recommendation + NCF user engine
# ---------------------------------------------------------------------------

#: the two-template user engine of ``{pkg}`` (chip_smoke's dase_engine
#: phase runs the port's at full width)
REC_NCF_ENGINE = '''\
"""ALS and NCF over one datasource, both predictions served by name."""

from {pkg}.controller import Engine, Preparator, Serving
from {pkg}.models.ncf.engine import NCFAlgorithm, NCFPreparator
from {pkg}.models.recommendation.engine import (
    ALSAlgorithm,
    RecommendationDataSource,
    RecommendationPreparator,
)


class BothPreparator(Preparator):
    """ALS's CSR and NCF's COO of the same ratings."""

    def prepare(self, ctx, training_data):
        return (RecommendationPreparator(self.params).prepare(ctx, training_data),
                NCFPreparator(self.params).prepare(ctx, training_data))


class UserALS(ALSAlgorithm):
    def train(self, ctx, prepared_data):
        return super().train(ctx, prepared_data[0])


class UserNCF(NCFAlgorithm):
    def train(self, ctx, prepared_data):
        return super().train(ctx, prepared_data[1])


class ByName(Serving):
    def serve(self, query, predictions):
        return {{"als": predictions[0], "ncf": predictions[1]}}


def engine_factory():
    return Engine(RecommendationDataSource, BothPreparator,
                  {{"als": UserALS, "ncf": UserNCF}}, ByName)
'''

REC_NCF_MODULES = {"jax": "jax_rec_ncf_engine", "port": "port_rec_ncf_engine"}
ALS_PARAMS = {"rank": 4, "numIterations": 4, "lambda": 0.1, "seed": 3,
              "checkpointInterval": 0, "retrieval": {"mode": "mips"}}
NCF_PARAMS = {"embedDim": 8, "hidden": [16, 8], "epochs": 2, "batchSize": 128,
              "learningRate": 0.01, "implicit": True, "seed": 4, "checkpoint": False}
REC_QUERIES = [{"user": "u0", "num": 5}, {"user": "u3", "num": 4, "unseenOnly": False},
               {"user": "u7", "num": 6, "blackList": ["s0", "s1"]},
               {"user": "nobody", "num": 3}]


def write_rec_ncf(root, pkg: str) -> str:
    engine_dir = os.path.join(str(root), f"rec-ncf-{pkg}")
    os.makedirs(engine_dir, exist_ok=True)
    with open(os.path.join(engine_dir, f"{REC_NCF_MODULES[pkg]}.py"), "w") as f:
        f.write(REC_NCF_ENGINE.format(pkg=CONTROLLER[pkg]))
    path = os.path.join(engine_dir, "engine.json")
    with open(path, "w") as f:
        json.dump({"id": "rec-ncf", "engineFactory": f"{REC_NCF_MODULES[pkg]}.engine_factory",
                   "datasource": {"params": {"appName": "RecNcf",
                                             "eventNames": ["rate", "buy"]}},
                   "algorithms": [{"name": "als", "params": ALS_PARAMS},
                                  {"name": "ncf", "params": NCF_PARAMS}],
                   "sparkConf": {"pio.mesh_shape": [1, 1]}}, f)
    return path


def test_the_als_and_ncf_user_engine_against_the_reference(basedir, tmp_path):  # noqa: F811
    from predictionio_tpu.workflow.context import RuntimeContext
    from predictionio_tpu_torch.models.ncf import NCFAlgorithm
    from predictionio_tpu_torch.models.recommendation import ALSAlgorithm
    from test_torch_eval import same_ranking
    from test_torch_ncf_train import carried, same_response
    from test_torch_store_train import make_events

    events = make_events(users=16)
    paths = {pkg: str(tmp_path / f"store-{pkg}") for pkg in ("jax", "port")}
    engine_jsons = {pkg: write_rec_ncf(tmp_path, pkg) for pkg in ("jax", "port")}
    basedir(paths["jax"])
    fill_store(jax_storage, JaxApp, JaxEvent, events, app_name="RecNcf")
    jax_variant = jax_load_variant(engine_jsons["jax"])
    jax_engine = jax_build_engine(jax_variant)
    jax_ctx = RuntimeContext({"pio.mesh_shape": [1, 1]})
    jax_als, jax_ncf = jax_engine.train(jax_ctx, jax_variant.engine_params)
    jax_algos = jax_engine._algorithms(jax_variant.engine_params)
    jax_prepared = jax_engine.preparator_class({}).prepare(
        jax_ctx, jax_engine.data_source_class(
            jax_variant.engine_params.data_source_params).read_training(jax_ctx))
    jax_workflow.run_train(jax_variant)
    jax_server = Deployed("jax", engine_jsons["jax"])
    try:
        want = [jax_server.query(q) for q in REC_QUERIES]
    finally:
        jax_server.close()

    basedir(paths["port"])
    fill_store(storage, App, Event, events, app_name="RecNcf")
    variant = load_engine_variant(engine_jsons["port"])
    engine = build_engine(variant)
    ctx = TrainContext(device="cpu", runtime_conf=dict(variant.runtime_conf))
    prepared = engine.preparator_class({}).prepare(
        ctx, engine.data_source_class(variant.engine_params.data_source_params)
        .read_training(ctx))
    for name in ("users", "items", "ratings"):
        np.testing.assert_array_equal(getattr(prepared[1], name),
                                      getattr(jax_prepared[1], name))
    instance = core_workflow.run_train(variant, device="cpu")
    _, (als, ncf) = core_workflow.load_instance_models(variant, instance.id, device="cpu")
    assert (als.user_index, als.item_ids) == (jax_als.user_index, jax_als.item_ids)
    np.testing.assert_allclose(als.als.user_factors, jax_als.als.user_factors, atol=1e-4)
    np.testing.assert_allclose(als.als.item_factors, jax_als.als.item_factors, atol=1e-4)
    for item in (0, len(als.item_ids) - 1):
        np.testing.assert_allclose(als.als.score_users_for_item(item),
                                   jax_als.als.score_users_for_item(item), atol=1e-4)
    # the JAX-trained NCF half, carried into the port, answers as the reference
    port_ncf = NCFAlgorithm(NCF_PARAMS, device="cpu")
    for q in REC_QUERIES[:3]:
        same_response(port_ncf.predict(carried(jax_ncf), q), jax_algos[1].predict(jax_ncf, q))
    server = Deployed("port", engine_jsons["port"])
    try:
        got = [server.query(q) for q in REC_QUERIES]
    finally:
        server.close()
    port_als = ALSAlgorithm(ALS_PARAMS, device="cpu")
    for (status, body), (want_status, want_body), q in zip(got, want, REC_QUERIES):
        assert status == want_status == 200 and set(body) == {"als", "ncf"}
        same_ranking(body["als"]["itemScores"], want_body["als"]["itemScores"])
        assert body["als"] == port_als.predict(als, q)
        assert body["ncf"] == port_ncf.predict(ncf, q)
    assert got[0][1]["als"]["itemScores"] and got[0][1]["ncf"]["itemScores"]
    assert got[-1][1] == {"als": {"itemScores": []}, "ncf": {"itemScores": []}}


def test_no_fallback_a_warm_up_failure_or_a_missing_card_raises(stores, tmp_path,
                                                                 monkeypatch, caplog):
    """Where the reference logs a ``warm_up`` failure and serves on, the
    port's deploy fails; without a card and without ``device="cpu"``
    every entry point raises."""
    import importlib

    import torch

    engine_jsons = both_engines(tmp_path, PAIR)
    for pkg in ("jax", "port"):
        stores(pkg)
        run_train(pkg, engine_jsons[pkg])
    module = {pkg: importlib.import_module(MODULES[pkg]) for pkg in MODULES}

    def broken(self, model):
        raise RuntimeError("no serving state")

    for pkg in ("jax", "port"):
        monkeypatch.setattr(module[pkg].FakeAlgorithm, "warm_up", broken)
    stores("jax")
    server = Deployed("jax", engine_jsons["jax"])
    try:
        assert server.query({})[0] == 200
    finally:
        server.close()
    assert "warm_up failed" in caplog.text
    stores("port")
    with pytest.raises(RuntimeError, match="no serving state"):
        Deployed("port", engine_jsons["port"])
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    variant = load_engine_variant(engine_jsons["port"])
    queries = tmp_path / "q.jsonl"
    queries.write_text("{}\n")
    from predictionio_tpu_torch.online.loop import RetrainLoop

    for call in (lambda: core_workflow.run_train(variant),
                 lambda: create_query_server(variant, host="127.0.0.1", port=0),
                 lambda: batch_predict.run_batch_predict(variant, str(queries),
                                                         str(tmp_path / "out.jsonl")),
                 lambda: RetrainLoop(variant)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
