"""The port's classification template against the JAX package's, on the CPU.

The same labelled events (the reference tests' SMS-spam messages, and
users' ``$set`` properties) go into each package's own store; each
package's engine trains on its store, the port's ``ops/classify.py`` with
``device="cpu"``. Naive Bayes must equal the reference at ``rtol=1e-6``
(the reference's sharded-vs-single bar), logistic regression at
``rtol=2e-3, atol=2e-4`` (its bar for a different reduction order), and
every scenario of ``tests/test_classification_template.py`` (text mode
with both algorithms, properties mode, eval accuracy) must give the
reference's labels, its scores at the algorithm's bar. Also: the
vectorizers, the evaluation folds, ``examples/classification/
engine.json`` (and a logistic-regression variant) through the port's
``pio train`` / ``pio deploy`` / ``pio eval`` / ``pio batchpredict``, a
reference model carried across (``from_reference``), the blob, and the
card twins of the trainers (``cuda``-marked, skipped without a card).
"""

import json
import os

import numpy as np
import pytest
import torch

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.controller.metrics import AverageMetric as JaxAverageMetric
from predictionio_tpu.controller.metrics import EngineParamsGenerator as JaxGenerator
from predictionio_tpu.controller.metrics import Evaluation as JaxEvaluation
from predictionio_tpu.data import storage as jax_storage
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.base import App as JaxApp
from predictionio_tpu.models.classification import engine_factory as jax_factory
from predictionio_tpu.models.classification.engine import (
    ClassificationDataSource as JaxDataSource,
)
from predictionio_tpu.ops import classify as jax_classify
from predictionio_tpu.ops import features as jax_features
from predictionio_tpu.workflow.context import RuntimeContext
from predictionio_tpu.workflow.core_workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu_torch.controller.base import Params, TrainContext
from predictionio_tpu_torch.controller.engine import EngineParams, ModelBlobError
from predictionio_tpu_torch.controller.metrics import (
    AverageMetric,
    EngineParamsGenerator,
    Evaluation,
)
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.models import classification
from predictionio_tpu_torch.ops import classify, features
from predictionio_tpu_torch.parallel.mesh import local_mesh
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow.core_workflow import load_instance_models, run_evaluation
from predictionio_tpu_torch.workflow.json_extractor import build_engine, load_engine_variant
from test_torch_store_train import (  # noqa: F401
    _serve,
    basedir,
    fill_store,
    one_blob,
    one_model,
    write_json,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB_RTOL = 1e-6
LR_TOL = dict(rtol=2e-3, atol=2e-4)
SPAM = ["win cash now", "free prize claim now", "win free entry", "cash prize winner",
        "claim your free cash", "urgent prize waiting"]
HAM = ["see you at lunch", "meeting moved to monday", "call me when home",
       "lunch tomorrow?", "are you coming home", "the meeting is at noon"]
QUERIES = [{"text": "free cash prize now"}, {"text": "see you at the meeting"},
           {"text": "WIN a free lunch"}, {"text": "unseen words only"}, {"text": ""}]


def sms_events() -> list[dict]:
    """The reference's ``sms_app`` fixture as wire events, one a second
    (the store reads them in event-time order), plus events the read
    drops: another event name, a message without a label."""
    rows = [("train", f"{k}{i}", {"text": t, "label": k})
            for k, texts in (("spam", SPAM), ("ham", HAM)) for i, t in enumerate(texts)]
    rows += [("view", "x0", {"text": "win", "label": "spam"}), ("train", "x1", {"text": "hi"})]
    return [{"event": name, "entityType": "message", "entityId": eid, "properties": props,
             "eventTime": f"2024-05-01T00:00:{k:02d}Z", "eventId": f"ev{k:03d}"}
            for k, (name, eid, props) in enumerate(rows)]


def property_events(users: int = 30) -> list[dict]:
    """The reference's properties-mode users, plus a numeric attribute
    that is not a 0/1 flag and a user without the label."""
    out = []
    for i in range(users):
        voice = i % 2
        props = {"voice": voice, "sms": 1 - voice, "minutes": 10 * (i % 7) + 5 * voice,
                 "plan": "talk" if voice else "data", "region": ["n", "s", "e"][i % 3]}
        out.append({"event": "$set", "entityType": "user", "entityId": f"u{i}",
                    "properties": props, "eventTime": f"2024-05-01T00:{i // 60:02d}:{i % 60:02d}Z"})
    out.append({"event": "$set", "entityType": "user", "entityId": "nolabel",
                "properties": {"voice": 1}, "eventTime": "2024-05-02T00:00:00Z"})
    return out


APPS = {"SmsApp": sms_events, "PropApp": property_events}
PROPERTY_QUERIES = [{"features": {"voice": 1, "sms": 0}}, {"features": {"voice": 0, "sms": 1}},
                    {"features": {"region": "s", "minutes": 40}}, {"features": {"region": "w"}}]


@pytest.fixture()
def stores(basedir, tmp_path):  # noqa: F811
    """``use("jax" | "port")``: each package's store holds both apps."""
    paths = {name: str(tmp_path / name) for name in ("jax", "port")}
    for name, registry, app, event in (("jax", jax_storage, JaxApp, JaxEvent),
                                       ("port", storage, App, Event)):
        basedir(paths[name])
        for app_name, make in APPS.items():
            fill_store(registry, app, event, make(), app_name=app_name)
    return lambda name: basedir(paths[name])


def engine_obj(algo: str, app: str = "SmsApp", **params) -> dict:
    datasource = {"appName": app}
    if app == "PropApp":
        datasource.update(mode="properties", labelField="plan")
    return {"datasource": {"params": datasource}, "algorithms": [{"name": algo, "params": params}]}


def both_trained(stores, algo: str, app: str = "SmsApp", **params):
    """(jax algorithm, jax model, port algorithm, port model), each
    trained from its own store through its engine's stages."""
    stores("jax")
    engine = jax_factory()
    jax_params = JaxEngineParams.from_json_obj(engine_obj(algo, app, **params))
    jax_model = engine.train(RuntimeContext(), jax_params)[0]
    jax_algo = engine._algorithms(jax_params)[0]
    stores("port")
    ep = EngineParams.from_json_obj(engine_obj(algo, app, **params))
    engine = classification.engine_factory()
    ctx = TrainContext(device="cpu")
    port_model = engine.train(ctx, ep)[0]
    return jax_algo, jax_model, engine._algorithms(ep, "cpu")[0], port_model


def assert_models_equal(got, want):
    """The inner models at their bar, the feature spaces equal."""
    assert got.space.mode == want.space.mode and got.space.classes == want.space.classes
    assert got.space.hash_dim == want.space.hash_dim
    for part in ("binary", "numeric"):
        g, w = getattr(got.space, part), getattr(want.space, part)
        assert (g is None) == (w is None) and (g is None or vars(g) == vars(w))
    if hasattr(want.inner, "log_prior"):
        np.testing.assert_allclose(got.inner.log_prior, want.inner.log_prior, rtol=NB_RTOL)
        np.testing.assert_allclose(got.inner.log_likelihood, want.inner.log_likelihood,
                                   rtol=NB_RTOL)
    else:
        np.testing.assert_allclose(got.inner.weights, want.inner.weights, **LR_TOL)
        np.testing.assert_allclose(got.inner.bias, want.inner.bias, **LR_TOL)


def assert_answers_equal(got, want, algo):
    """Same label; each score at the algorithm's bar."""
    assert got["label"] == want["label"]
    assert list(got["scores"]) == list(want["scores"])
    tol = dict(rtol=NB_RTOL) if algo == "naive-bayes" else LR_TOL
    np.testing.assert_allclose(list(got["scores"].values()), list(want["scores"].values()), **tol)


# -- the trainers -------------------------------------------------------------


def test_vectorizers_equal_the_reference():
    texts = SPAM + HAM + ["Win CASH now!", "it's 5 o'clock", ""]
    assert [features.tokenize(t) for t in texts] == [jax_features.tokenize(t) for t in texts]
    for dim in (32, 4096):
        np.testing.assert_array_equal(features.hashing_vectorize(texts, dim),
                                      jax_features.hashing_vectorize(texts, dim))
    records = [{"plan": "a", "n": 1}, {"plan": "b"}, {"n": 2, "x": True}]
    got = features.BinaryVectorizer.fit(records, ["plan", "x"])
    want = jax_features.BinaryVectorizer.fit(records, ["plan", "x"])
    assert got.index == want.index and got.dim == want.dim
    probe = records + [{"plan": "zz"}]
    np.testing.assert_array_equal(got.transform(probe), want.transform(probe))
    np.testing.assert_array_equal(features.NumericVectorizer(["n", "x"]).transform(probe),
                                  jax_features.NumericVectorizer(["n", "x"]).transform(probe))


def nb_cases():
    rng = np.random.default_rng(2)
    return {
        "class-conditional": (np.array([[3, 1], [1, 3]] * 20, np.float32),
                              np.array([0, 1] * 20, np.int32), 2, 1.0),
        "three-classes-101": (rng.integers(0, 5, size=(101, 7)).astype(np.float32),
                              rng.integers(0, 3, size=101).astype(np.int32), 3, 1.0),
        "sms-hashed": (jax_features.hashing_vectorize(SPAM + HAM, 4096),
                       np.array([1] * 6 + [0] * 6, np.int32), 2, 0.25),
    }


@pytest.mark.parametrize("name", sorted(nb_cases()))
def test_naive_bayes_equals_the_reference(name):
    x, y, classes, smoothing = nb_cases()[name]
    want = jax_classify.train_naive_bayes(x, y, classes, smoothing=smoothing)
    got = classify.train_naive_bayes(x, y, classes, smoothing=smoothing, device="cpu")
    assert got.log_prior.dtype == got.log_likelihood.dtype == np.float32
    np.testing.assert_allclose(got.log_prior, want.log_prior, rtol=NB_RTOL)
    np.testing.assert_allclose(got.log_likelihood, want.log_likelihood, rtol=NB_RTOL)
    probe = x[:5] + 1.0
    assert (got.scores(probe).argmax(1) == want.scores(probe).argmax(1)).all()


def test_naive_bayes_refuses_negative_features_and_a_mesh():
    x, y = np.array([[1.0, -1.0], [0.0, 2.0]], np.float32), np.array([0, 1])
    with pytest.raises(ValueError) as want:
        jax_classify.train_naive_bayes(x, y, 2)
    with pytest.raises(ValueError) as got:
        classify.train_naive_bayes(x, y, 2, device="cpu")
    assert str(got.value) == str(want.value)
    # a mesh of one rank along data trains as one device does (the
    # sharded fits are test_torch_classify_mesh.py's)
    one = local_mesh(device="cpu")
    with pytest.raises(ValueError) as on_mesh:
        classify.train_naive_bayes(x, y, 2, mesh=one, device="cpu")
    assert str(on_mesh.value) == str(want.value)
    for train in (classify.train_naive_bayes, classify.train_logistic_regression):
        got, alone = (train(np.abs(x), y, 2, mesh=m, device="cpu") for m in (one, None))
        for name, value in vars(got).items():
            np.testing.assert_array_equal(value, getattr(alone, name))


@pytest.mark.parametrize("case", ["separable-60", "ragged-40", "sms-100"])
def test_logistic_regression_equals_the_reference(case):
    if case == "sms-100":
        x, y = jax_features.hashing_vectorize(SPAM + HAM, 4096), np.array([1] * 6 + [0] * 6)
        iterations = 100
    else:
        rng = np.random.default_rng(0 if case == "separable-60" else 1)
        x = rng.normal(size=(200 if case == "separable-60" else 203, 4)).astype(np.float32)
        y = ((x[:, 0] + x[:, 1] > 0) if case == "separable-60" else (x[:, 0] - x[:, 2] > 0))
        iterations = int(case.split("-")[1])
    y = y.astype(np.int32)
    want = jax_classify.train_logistic_regression(x, y, 2, iterations=iterations)
    got = classify.train_logistic_regression(x, y, 2, iterations=iterations, device="cpu")
    np.testing.assert_allclose(got.weights, want.weights, **LR_TOL)
    np.testing.assert_allclose(got.bias, want.bias, **LR_TOL)
    if case == "separable-60":
        assert (got.scores(x).argmax(axis=1) == y).mean() > 0.95


# -- the template's scenarios -------------------------------------------------


@pytest.mark.parametrize("algo", ["naive-bayes", "logistic-regression"])
def test_text_mode_spam_answers_equal_the_reference(stores, algo):
    jax_algo, jax_model, algo_, model = both_trained(stores, algo, iterations=60)
    assert_models_equal(model, jax_model)
    for query in QUERIES:
        assert_answers_equal(algo_.predict(model, query), jax_algo.predict(jax_model, query), algo)
    spam = algo_.predict(model, {"text": "free cash prize now"})
    assert spam["label"] == "spam" and 1.0 >= spam["scores"]["spam"] > 0.5
    assert algo_.predict(model, {"text": "see you at the meeting"})["label"] == "ham"
    assert spam["scores"]["spam"] + spam["scores"]["ham"] == pytest.approx(1.0)
    with pytest.raises(ValueError, match="'text' or 'features'"):
        algo_.predict(model, {"nope": 1})
    indexed = list(enumerate(QUERIES))
    assert algo_.batch_predict(model, indexed) == [(i, algo_.predict(model, q))
                                                   for i, q in indexed]


def test_properties_mode_answers_equal_the_reference(stores):
    jax_algo, jax_model, algo_, model = both_trained(stores, "naive-bayes", "PropApp")
    assert_models_equal(model, jax_model)
    assert model.space.numeric.fields == ["minutes", "sms", "voice"]
    for query in PROPERTY_QUERIES:
        assert_answers_equal(algo_.predict(model, query), jax_algo.predict(jax_model, query),
                             "naive-bayes")
    assert algo_.predict(model, PROPERTY_QUERIES[0])["label"] == "talk"


def test_properties_mode_logistic_regression_within_the_references_own_spread(stores):
    """Logistic regression on the properties data: separable, with
    collinear columns (voice + sms = 1 = the region one-hots), so past
    ~30 updates its line searches fail and any two reduction orders part
    beyond ``rtol=2e-3, atol=2e-4`` -- the reference's own sharded and
    single-device fits included. The port's model is held to that
    spread: no farther from the reference's single-device fit than the
    reference's two fits are from each other (5.2e-3 here; the port's is
    1.4e-3), and its labels equal the engine's."""
    from predictionio_tpu.parallel.mesh import local_mesh

    jax_algo, jax_model, algo_, model = both_trained(stores, "logistic-regression", "PropApp")
    ctx = TrainContext(device="cpu")
    ep = EngineParams.from_json_obj(engine_obj("logistic-regression", "PropApp"))
    engine = classification.engine_factory()
    data = engine.data_source_class(ep.data_source_params).read_training(ctx)
    _, x, y = engine.preparator_class(ep.preparator_params).prepare(ctx, data)
    single = jax_classify.train_logistic_regression(x, y, 2)
    sharded = jax_classify.train_logistic_regression(x, y, 2, mesh=local_mesh(8, 1))
    spread = np.abs(sharded.weights - single.weights).max()
    assert np.abs(model.inner.weights - single.weights).max() <= spread
    for query in PROPERTY_QUERIES:
        assert algo_.predict(model, query)["label"] == jax_algo.predict(jax_model, query)["label"]


def test_eval_folds_equal_the_reference(stores):
    stores("jax")
    want = JaxDataSource({"appName": "SmsApp", "evalFolds": 4}).read_eval(None)
    stores("port")
    got = classification.ClassificationDataSource(
        Params({"appName": "SmsApp", "evalFolds": 4})).read_eval(None)
    assert len(got) == len(want) == 4
    for (gt, gi, gp), (wt, wi, wp) in zip(got, want):
        assert (gt.records, gt.labels, gt.mode) == (wt.records, wt.labels, wt.mode)
        assert dict(gi) == dict(wi) and gp == wp and gp


@pytest.mark.parametrize("algo", ["naive-bayes", "logistic-regression"])
def test_eval_accuracy_equals_the_reference(stores, algo):
    def accuracy(ei, q, p, a):
        return 1.0 if p["label"] == a else 0.0

    stores("jax")
    want = jax_run_evaluation(
        JaxEvaluation(engine=jax_factory(), metric=JaxAverageMetric(score=accuracy)),
        JaxGenerator([JaxEngineParams.from_json_obj(engine_obj(algo, iterations=60))]))
    stores("port")
    got = run_evaluation(
        Evaluation(engine=classification.engine_factory(), metric=AverageMetric(score=accuracy)),
        EngineParamsGenerator([EngineParams.from_json_obj(engine_obj(algo, iterations=60))]),
        device="cpu")
    got_score = json.loads(got.evaluator_results_json)["bestScore"]
    assert got_score == json.loads(want.evaluator_results_json)["bestScore"]
    if algo == "naive-bayes":
        assert got_score >= 0.8


def test_a_mesh_is_refused(stores):
    stores("port")
    engine = classification.engine_factory()
    ep = EngineParams.from_json_obj(engine_obj("naive-bayes"))
    data = engine.data_source_class(ep.data_source_params).read_training(None)
    prepared = engine.preparator_class(ep.preparator_params).prepare(None, data)
    for name in ("naive-bayes", "logistic-regression"):
        algo = engine.algorithm_class_map[name](Params({}), device="cpu")
        # two ranks along data: a launch of one process cannot fill it
        with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
            algo.train(TrainContext(device="cpu", mesh_shape=[2, 1]), prepared)
    model = engine.algorithm_class_map["naive-bayes"](Params({}), device="cpu").train(
        TrainContext(device="cpu", mesh_shape=[-1, 1]), prepared)
    assert model.space.classes == ["ham", "spam"]


# -- the carry-over, the blob and the verbs -----------------------------------


@pytest.mark.parametrize("algo,app", [("naive-bayes", "SmsApp"),
                                      ("logistic-regression", "SmsApp"),
                                      ("naive-bayes", "PropApp")])
def test_a_reference_model_carried_across_serves_the_same(stores, algo, app, tmp_path):
    jax_algo, jax_model, algo_, _ = both_trained(stores, algo, app, iterations=20)
    carried = classification.from_reference(jax_model)
    queries = QUERIES if app == "SmsApp" else [{"features": {"voice": 1, "sms": 0}},
                                              {"features": {"region": "e"}}]
    files = classification.engine_factory().algorithm_class_map[algo].model_files
    files.save(carried, str(tmp_path / "m"))
    for model in (carried, files.load(str(tmp_path / "m")),
                  one_model("classification", one_blob("classification", carried, algo),
                            algo)):
        for q in queries:
            assert algo_.predict(model, q) == jax_algo.predict(jax_model, q)


def test_the_blob_keeps_the_algorithm_class(stores):
    """A logistic-regression blob serves through the class that trained
    it; engine params naming the other algorithm, or a blob naming an
    algorithm the engine lacks, are refused."""
    _, _, _, model = both_trained(stores, "logistic-regression", iterations=10)
    engine = classification.engine_factory()
    assert list(engine.algorithm_class_map) == ["naive-bayes", "logistic-regression"]
    blob = one_blob("classification", model, "logistic-regression")
    lr_params = EngineParams.from_json_obj(engine_obj("logistic-regression"))
    ctx = TrainContext(device="cpu")
    [loaded] = engine.prepare_deploy(ctx, lr_params, "", blob)
    assert type(engine._algorithms(lr_params, "cpu")[0]) is (
        classification.LogisticRegressionAlgorithm)
    np.testing.assert_array_equal(loaded.inner.weights, model.inner.weights)
    with pytest.raises(ValueError, match="'logistic-regression', got 'naive-bayes'"):
        engine.prepare_deploy(ctx, EngineParams.from_json_obj(engine_obj("naive-bayes")),
                              "", blob)
    import io
    import zipfile

    buf = io.BytesIO()
    with zipfile.ZipFile(io.BytesIO(blob)) as src, zipfile.ZipFile(buf, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "manifest.json":
                data = data.replace(b'"logistic-regression"', b'"svm"')
            dst.writestr(name, data)
    with pytest.raises(ModelBlobError, match="trained by 'svm'"):
        engine.prepare_deploy(ctx, lr_params, "", buf.getvalue())
    no_factory = write_json(stores("port") + "/engine.json",
                            {"algorithms": [{"name": "logistic-regression"}]})
    assert build_engine(load_engine_variant(no_factory)).algorithm_class_map[
        "logistic-regression"] is classification.LogisticRegressionAlgorithm
    with pytest.raises(KeyError, match="'svm' not registered in engine"):
        engine._algorithms(EngineParams.from_json_obj(engine_obj("svm")), "cpu")


@pytest.mark.parametrize("algo", ["naive-bayes", "logistic-regression"])
def test_engine_json_trains_deploys_and_batch_predicts_through_the_cli(
        basedir, tmp_path, capsys, algo):  # noqa: F811
    """``examples/classification/engine.json`` unchanged (and its
    logistic-regression variant): ``pio train`` from the store, ``pio
    deploy`` of the instance, ``pio batchpredict``; the same events from
    a file give the same answers."""
    basedir(tmp_path / "store")
    events = sms_events()
    fill_store(storage, App, Event, events, app_name="MyApp")
    engine_json = os.path.join(REPO, "examples", "classification", "engine.json")
    if algo == "logistic-regression":
        obj = json.load(open(engine_json))
        obj["algorithms"] = [{"name": algo, "params": {"reg": 1e-4, "iterations": 100}}]
        engine_json = write_json(tmp_path / "engine.json", obj)
    assert cli.main(["train", "--engine-json", engine_json, "--device", "cpu"]) == 0
    assert "Engine instance ID" in capsys.readouterr().out
    variant, engine = cli.load_variant(engine_json)
    assert engine.algorithm_class_map == classification.ALGORITHMS
    assert variant.engine_params.algorithm_params_list[0][0] == algo
    _, [model] = load_instance_models(variant)
    [algorithm] = engine._algorithms(variant.engine_params, "cpu")
    answers = _serve(engine_json, QUERIES)
    assert [status for status, _ in answers] == [200] * len(QUERIES)
    assert [body for _, body in answers] == [algorithm.predict(model, q) for q in QUERIES]
    assert answers[0][1]["label"] == "spam"
    queries = tmp_path / "q.jsonl"
    queries.write_text("".join(json.dumps(q) + "\n" for q in QUERIES))
    out = tmp_path / "p.jsonl"
    assert cli.main(["batchpredict", "--engine-json", engine_json, "--input", str(queries),
                     "--output", str(out), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["prediction"] for r in rows] == [algorithm.predict(model, q) for q in QUERIES]
    events_path = tmp_path / "events.jsonl"
    events_path.write_text("".join(json.dumps(e) + "\n" for e in events))
    from_file = cli.train(engine_json, str(events_path), str(tmp_path / "model"), device="cpu")
    for q in QUERIES:
        assert algorithm.predict(from_file, q) == algorithm.predict(model, q)


def test_properties_mode_trains_from_a_file_as_from_the_store(basedir, tmp_path):  # noqa: F811
    basedir(tmp_path / "store")
    events = property_events()
    fill_store(storage, App, Event, events, app_name="PropApp")
    engine_json = write_json(tmp_path / "engine.json", engine_obj("naive-bayes", "PropApp"))
    events_path = tmp_path / "events.jsonl"
    events_path.write_text("".join(json.dumps(e) + "\n" for e in events))
    from_file = cli.train(engine_json, str(events_path), str(tmp_path / "model"), device="cpu")
    variant, engine = cli.load_variant(engine_json)
    [from_store] = engine.train(TrainContext(device="cpu"), variant.engine_params)
    assert_models_equal(from_file, from_store)
    np.testing.assert_array_equal(from_file.inner.log_likelihood,
                                  from_store.inner.log_likelihood)


def test_the_cli_eval_of_a_user_module(basedir, tmp_path, capsys):  # noqa: F811
    """``pio eval EVALUATION GENERATOR`` over the classification template,
    an accuracy ``AverageMetric`` over 3 folds."""
    basedir(tmp_path / "store")
    fill_store(storage, App, Event, sms_events(), app_name="SmsApp")
    (tmp_path / "sms_eval.py").write_text(
        "from predictionio_tpu_torch.controller.engine import EngineParams\n"
        "from predictionio_tpu_torch.models.classification import engine_factory\n"
        "from predictionio_tpu_torch.controller.metrics import (\n"
        "    AverageMetric, EngineParamsGenerator, Evaluation)\n"
        "def accuracy(info, q, p, a):\n"
        "    return 1.0 if p['label'] == a else 0.0\n"
        "EVALUATION = Evaluation(engine=engine_factory(),\n"
        "                        metric=AverageMetric(score=accuracy))\n"
        "def generator():\n"
        "    return EngineParamsGenerator([EngineParams.from_json_obj({\n"
        "        'datasource': {'params': {'appName': 'SmsApp', 'evalFolds': 3}},\n"
        "        'algorithms': [{'name': name, 'params': {}}]})\n"
        "        for name in ('naive-bayes', 'logistic-regression')])\n"
    )
    out_path = tmp_path / "results.json"
    code = cli.main(["eval", "sms_eval.EVALUATION", "sms_eval.generator", "--engine-dir",
                     str(tmp_path), "--device", "cpu", "--output-path", str(out_path)])
    assert code == 0, capsys.readouterr().out
    results = json.loads(out_path.read_text())
    assert len(results["results"]) == 2 and results["bestScore"] >= 0.8


# -- the card twins -----------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_naive_bayes_on_the_card_equals_the_cpu():
    _card()
    for x, y, classes, smoothing in nb_cases().values():
        cpu = classify.train_naive_bayes(x, y, classes, smoothing=smoothing, device="cpu")
        card = classify.train_naive_bayes(x, y, classes, smoothing=smoothing, device="cuda")
        np.testing.assert_allclose(card.log_prior, cpu.log_prior, rtol=NB_RTOL)
        np.testing.assert_allclose(card.log_likelihood, cpu.log_likelihood, rtol=NB_RTOL)


@pytest.mark.cuda
def test_logistic_regression_on_the_card_equals_the_cpu():
    _card()
    x = jax_features.hashing_vectorize(SPAM + HAM, 4096)
    y = np.array([1] * 6 + [0] * 6, np.int32)
    cpu = classify.train_logistic_regression(x, y, 2, device="cpu")
    card = classify.train_logistic_regression(x, y, 2, device="cuda")
    np.testing.assert_allclose(card.weights, cpu.weights, **LR_TOL)
    np.testing.assert_allclose(card.bias, cpu.bias, **LR_TOL)
