"""The port's evaluation layer against the JAX package's, on the CPU.

``eval/split.py`` and ``eval/metrics.py`` are copies, held to the
reference's functions on random inputs (exactly). The templates' eval
hooks (``read_eval``, ``read_replay``) cut the same folds from one event
stream in each package's own store. ``run_replay_eval`` trains on the
prefix in both packages (ALS through the reference's "xla" path and the
port's plain twin of B1; the mips arm through the reference's stage-1
program and the port's plain twin of B2, over a catalog past 512 items
so stage 1 runs) and must report the same split, the same retrieval
guard counts, ranked lists equal up to near-ties (scores within 1e-4)
and metrics within 1e-4; with ``seenFilter: "live"`` both downgrade to
the trained-in map and neither scores 0. NCF's replay starts both
packages from the same initial weights and holds them to the NCF
training bar (``tests/test_torch_ncf_train.py``: params within 1e-4).
The k-fold ``run_evaluation`` of the recommendation template records a
COMPLETED evaluation instance with the reference's ``bestScore`` within
1e-4. The CLI's exit-2 contract is the reference's
(``tests/test_eval.py:477-573``).
"""

import datetime as dt
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.controller.metrics import (
    EngineParamsGenerator as JaxGenerator,
)
from predictionio_tpu.controller.metrics import Evaluation as JaxEvaluation
from predictionio_tpu.controller.metrics import (
    OptionAverageMetric as JaxOptionAverage,
)
from predictionio_tpu.data import storage as jax_storage
from predictionio_tpu.data.event import Event as JaxEvent
from predictionio_tpu.data.storage.base import App as JaxApp
from predictionio_tpu.eval import metrics as jax_metrics
from predictionio_tpu.eval import split as jax_split
from predictionio_tpu.eval.replay import run_replay_eval as jax_replay
from predictionio_tpu.models.ncf.model import NCFConfig as JaxNCFConfig
from predictionio_tpu.models.ncf.model import NeuMF as JaxNeuMF
from predictionio_tpu.models.recommendation import engine_factory as jax_rec_factory
from predictionio_tpu.models.recommendation.engine import (
    RecommendationDataSource as JaxRecSource,
)
from predictionio_tpu.models.sequence.engine import SequenceDataSource as JaxSeqSource
from predictionio_tpu.workflow.context import RuntimeContext
from predictionio_tpu.workflow.core_workflow import run_evaluation as jax_run_evaluation
from predictionio_tpu.workflow.json_extractor import (
    load_engine_variant as jax_load_variant,
)
from predictionio_tpu_torch.controller.base import TrainContext
from predictionio_tpu_torch.controller.engine import EngineParams
from predictionio_tpu_torch.controller.metrics import (
    EngineParamsGenerator,
    Evaluation,
    OptionAverageMetric,
)
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.eval import metrics, split
from predictionio_tpu_torch.eval.replay import run_replay_eval
from predictionio_tpu_torch.models.ncf import model as ncf_model
from predictionio_tpu_torch.models.ncf.model import params_from_flax
from predictionio_tpu_torch.models import recommendation
from predictionio_tpu_torch.models.recommendation import RecommendationDataSource
from predictionio_tpu_torch.models.sequence import SequenceDataSource
from predictionio_tpu_torch.tools import cli
from predictionio_tpu_torch.workflow.core_workflow import run_evaluation
from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant
from test_torch_store_train import basedir, fill_store, write_json  # noqa: F401
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

APP = "ReplayApp"
#: a catalog past 512 items: the mips arm's stage 1 (B2's plain twin) runs
ITEMS = 720
ALS = {"rank": 6, "numIterations": 4, "lambda": 0.1, "seed": 3,
       "checkpointInterval": 0, "retrieval": {"mode": "mips"}}
BASE = dt.datetime(2024, 3, 1, tzinfo=dt.timezone.utc)
NEAR_TIE = 1e-4


def replay_events(users=120, items=ITEMS, per_user=30, seed=7) -> list[dict]:
    """Four taste groups over the catalog: each user rates items of its
    group 4-5 and a few others 1-2, plus an unrated "buy"; the events
    are shuffled over one timeline, one second apart (no time ties), so
    every user has events on both sides of a split."""
    rng = np.random.default_rng(seed)
    group = items // 4
    rows = []
    for u in range(users):
        g = u % 4
        own = rng.choice(np.arange(g * group, (g + 1) * group), size=per_user - 4,
                         replace=False)
        other = rng.choice(np.setdiff1d(np.arange(items), own), size=4, replace=False)
        rows += [("rate", f"u{u}", f"i{i}", {"rating": int(rng.integers(4, 6))}) for i in own]
        rows += [("rate", f"u{u}", f"i{i}", {"rating": int(rng.integers(1, 3))}) for i in other]
        rows.append(("buy", f"u{u}", f"i{int(own[0])}", {}))
    # every catalog item has a rating, so both vocabularies hold it
    rows += [("rate", f"u{i % users}", f"i{i}", {"rating": 3}) for i in range(items)]
    order = rng.permutation(len(rows))
    return [
        {"eventId": f"ev{k:05d}", "event": rows[j][0], "entityType": "user",
         "entityId": rows[j][1], "targetEntityType": "item", "targetEntityId": rows[j][2],
         "properties": rows[j][3], "eventTime": (BASE + dt.timedelta(seconds=k)).isoformat()}
        for k, j in enumerate(order)
    ]


def variant_obj(algorithm="als", app=APP, **params) -> dict:
    factory = {"als": "recommendation", "ncf": "ncf", "sasrec": "sequence"}[algorithm]
    return {
        "id": f"eval-{algorithm}",
        "engineFactory": f"predictionio_tpu.models.{factory}.engine_factory",
        "datasource": {"params": {"appName": app}},
        "algorithms": [{"name": algorithm, "params": params}],
        "sparkConf": {"pio.mesh_shape": [1, 1]},
    }


@pytest.fixture()
def stores(basedir, tmp_path):  # noqa: F811
    """``use("jax" | "port")`` points both registries at that package's
    store; each holds the same events."""
    events = replay_events()
    paths = {name: str(tmp_path / name) for name in ("jax", "port")}
    basedir(paths["jax"])
    fill_store(jax_storage, JaxApp, JaxEvent, events, app_name=APP)
    basedir(paths["port"])
    fill_store(storage, App, Event, events, app_name=APP)
    return lambda name: basedir(paths[name])


def same_ranking(got: list, want: list, tol: float = NEAR_TIE) -> None:
    """Two ``itemScores`` lists: scores within ``tol`` rank by rank, and
    the same items in order except where two items' scores lie within
    ``tol`` of each other (a near-tie may swap)."""
    assert len(got) == len(want)
    w_scores = np.array([s["score"] for s in want])
    g_scores = np.array([s["score"] for s in got])
    np.testing.assert_allclose(g_scores, w_scores, rtol=tol, atol=tol)
    for pos, (g, w) in enumerate(zip(got, want)):
        if g["item"] != w["item"]:
            assert abs(g_scores[pos] - w_scores[pos]) <= tol, (pos, g, w)


def same_report(got: dict, want: dict) -> None:
    assert got["split"] == want["split"]
    assert got["k"] == want["k"]
    assert set(got["metrics"]) == set(want["metrics"])
    for name, value in want["metrics"].items():
        assert got["metrics"][name] == pytest.approx(value, abs=1e-4), name
    assert got["queries"] == want["queries"] and got["actual"] == want["actual"]
    for g, w in zip(got["responses"], want["responses"]):
        same_ranking(g["itemScores"], w["itemScores"])
    if want["retrieval_guard"] is None:
        assert got["retrieval_guard"] is None
    else:
        for key in ("users_compared", "shortlist"):
            assert got["retrieval_guard"][key] == want["retrieval_guard"][key], key
        for key, value in want["retrieval_guard"].items():
            if isinstance(value, float):
                assert got["retrieval_guard"][key] == pytest.approx(value, abs=1e-4), key


# --------------------------------------------------------------------------
# eval/split.py and eval/metrics.py: copies, held to the originals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = 400
    users = rng.integers(0, 30, n)
    items = rng.integers(0, 50, n)
    times = np.round(rng.uniform(1.7e9, 1.7e9 + 1e5, n), 3)
    times[::7] = times[3]  # ties at a boundary
    for kw in ({"split_frac": 0.8}, {"split_frac": 0.31},
               {"split_time": dt.datetime.fromtimestamp(times[3], dt.timezone.utc).isoformat()},
               {"split_time": "2023-11-14T22:13:20"}):
        spec = split.SplitSpec(k=5, **kw)
        want_spec = jax_split.SplitSpec(k=5, **kw)
        spec.validate()
        want_spec.validate()
        assert split.resolve_split_seconds(times, spec) == \
            jax_split.resolve_split_seconds(times, want_spec)
        got = split.split_interactions(users, items, times, spec)
        want = jax_split.split_interactions(users, items, times, want_spec)
        np.testing.assert_array_equal(got.train_mask, want.train_mask)
        assert got.holdout.keys() == want.holdout.keys()
        for u in want.holdout:
            np.testing.assert_array_equal(np.asarray(got.holdout[u]), np.asarray(want.holdout[u]))
        assert got.bounds.to_json_obj() == want.bounds.to_json_obj()
    for bad in ({"split_time": "jan 5th"}, {"split_frac": 1.5},
                {"split_time": "2024-01-01", "split_frac": 0.5}):
        with pytest.raises(ValueError) as got_err:
            split.SplitSpec(k=5, **bad).validate()
        with pytest.raises(ValueError) as want_err:
            jax_split.SplitSpec(k=5, **bad).validate()
        assert str(got_err.value) == str(want_err.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    predicted = [[f"i{j}" for j in rng.choice(40, size=int(rng.integers(0, 12)), replace=False)]
                 for _ in range(60)]
    actual = [[f"i{j}" for j in rng.choice(40, size=int(rng.integers(0, 6)), replace=False)]
              for _ in range(60)]
    for k in (1, 5, 10):
        for names in (None, "ndcg,hit_rate", ["mrr", "recall"]):
            got = metrics.ranking_metrics(predicted, actual, k, metrics.select_metrics(names))
            want = jax_metrics.ranking_metrics(predicted, actual, k,
                                               jax_metrics.select_metrics(names))
            assert got == want
        for got, want in zip(metrics.relevance_matrix(predicted, actual, k),
                             jax_metrics.relevance_matrix(predicted, actual, k)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.select_metrics("precision")
    assert metrics.DEFAULT_METRICS == jax_metrics.DEFAULT_METRICS


# --------------------------------------------------------------------------
# the templates' folds
# --------------------------------------------------------------------------


def _rec_fold_equal(got, want):
    for name in ("users", "items", "ratings", "times"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.user_ids == want.user_ids and got.item_ids == want.item_ids
    assert got.eval_fold and want.eval_fold


def test_recommendation_folds_equal_the_reference(stores):
    params = {"appName": APP, "evalFolds": 3, "evalK": 7}
    stores("jax")
    want_folds = JaxRecSource(params).read_eval(RuntimeContext({}))
    want_replay = JaxRecSource(params).read_replay(
        RuntimeContext({}), jax_split.SplitSpec(split_frac=0.75, k=7))
    stores("port")
    ctx = TrainContext(device="cpu")
    got_folds = RecommendationDataSource(params).read_eval(ctx)
    got_replay = RecommendationDataSource(params).read_replay(
        ctx, split.SplitSpec(split_frac=0.75, k=7))
    assert len(got_folds) == len(want_folds) == 3
    for (g_train, g_info, g_pairs), (w_train, w_info, w_pairs) in zip(got_folds, want_folds):
        _rec_fold_equal(g_train, w_train)
        assert dict(g_info) == dict(w_info)
        assert [(q, sorted(a)) for q, a in g_pairs] == [(q, sorted(a)) for q, a in w_pairs]
    _rec_fold_equal(got_replay.train_data, want_replay.train_data)
    assert got_replay.pairs == want_replay.pairs
    assert got_replay.bounds.to_json_obj() == want_replay.bounds.to_json_obj()


def test_sequence_folds_equal_the_reference(stores):
    params = {"appName": APP, "eventNames": ["rate", "buy"], "evalFolds": 2, "evalK": 5}
    stores("jax")
    want = JaxSeqSource(params).read_eval(RuntimeContext({}))
    stores("port")
    got = SequenceDataSource(params).read_eval(TrainContext(device="cpu"))
    assert len(got) == len(want) == 2
    for (g_train, g_info, g_pairs), (w_train, w_info, w_pairs) in zip(got, want):
        assert g_train.user_ids == w_train.user_ids and g_train.item_ids == w_train.item_ids
        assert len(g_train.sequences) == len(w_train.sequences)
        for a, b in zip(g_train.sequences, w_train.sequences):
            np.testing.assert_array_equal(a, b)
        assert dict(g_info) == dict(w_info) and g_pairs == w_pairs
    assert all(len(pairs) > 0 for _, _, pairs in got)


# --------------------------------------------------------------------------
# run_replay_eval, port against reference
# --------------------------------------------------------------------------


def _both_replays(stores, tmp_path, obj, **kw):
    engine_json = write_json(tmp_path / "engine.json", obj)
    stores("jax")
    want = jax_replay(jax_load_variant(engine_json), include_responses=True, **kw)
    stores("port")
    got = run_replay_eval(load_engine_variant(engine_json), include_responses=True,
                          device="cpu", **kw)
    return got, want


@pytest.mark.parametrize("seen", ["model", "live"])
def test_replay_equals_the_reference(stores, tmp_path, seen):
    got, want = _both_replays(stores, tmp_path, variant_obj(**ALS, seenFilter=seen),
                              split_frac=0.8, k=10)
    same_report(got, want)
    assert got["model"] == want["model"] == {
        "source": "replay-train", "model_version": None, "instance_id": None}
    guard = got["retrieval_guard"]
    assert guard["users_compared"] > 20 and guard["shortlist"] == 512
    # the live filter was downgraded: held-out items stay rankable
    assert got["metrics"]["hit_rate_at_10"] > 0 and want["metrics"]["hit_rate_at_10"] > 0


def test_replay_at_a_split_time_and_metric_subset(stores, tmp_path):
    boundary = (BASE + dt.timedelta(seconds=900)).isoformat()
    got, want = _both_replays(stores, tmp_path, variant_obj(**dict(ALS, retrieval={})),
                              split_time=boundary, k=5, metrics="ndcg,mrr",
                              retrieval_guard=False)
    same_report(got, want)
    assert set(got["metrics"]) == {"ndcg_at_5", "mrr"}
    assert got["retrieval_guard"] is None


def test_snapshot_served_replay_equals_the_store_read(stores, tmp_path):
    engine_json = write_json(tmp_path / "engine.json", variant_obj(**ALS))
    stores("port")
    plain = run_replay_eval(load_engine_variant(engine_json), include_responses=True,
                            device="cpu")
    variant = load_engine_variant(engine_json)
    variant.runtime_conf["pio.snapshot_mode"] = "use"
    variant.runtime_conf["pio.snapshot_dir"] = str(tmp_path / "snaps")
    served = run_replay_eval(variant, include_responses=True, device="cpu")
    assert os.listdir(tmp_path / "snaps")
    assert served == plain


def _flax_init(config) -> dict:
    kw = {f: getattr(config, f) for f in ("num_users", "num_items", "embed_dim", "hidden",
                                          "epochs", "batch_size", "learning_rate", "implicit",
                                          "negatives", "seed")}
    params = JaxNeuMF(JaxNCFConfig(**kw)).init(
        jax.random.PRNGKey(config.seed), jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32)
    )["params"]
    return params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def test_ncf_replay_equals_the_reference(stores, tmp_path, monkeypatch):
    """Both packages start from the reference's initial weights (the
    port's own init draws other values) and train one epoch on the
    prefix, implicit with sampled negatives (byte-identical draws)."""
    real_init = ncf_model.init_model

    def flax_start(config):
        net = real_init(config)
        net.load_state_dict(_flax_init(config))
        return net

    monkeypatch.setattr(ncf_model, "init_model", flax_start)
    ncf = {"embedDim": 8, "hidden": [16, 8], "epochs": 1, "batchSize": 256,
           "learningRate": 0.01, "implicit": True, "seed": 2, "checkpoint": False}
    got, want = _both_replays(stores, tmp_path, variant_obj("ncf", **ncf), k=10)
    assert got["retrieval_guard"] is None and want["retrieval_guard"] is None
    assert got["split"] == want["split"] and got["queries"] == want["queries"]
    for name, value in want["metrics"].items():
        assert got["metrics"][name] == pytest.approx(value, abs=1e-4), name
    for g, w in zip(got["responses"], want["responses"]):
        same_ranking(g["itemScores"], w["itemScores"])


def test_replay_of_a_registry_version(stores, tmp_path):
    """A pinned registry version (published by the port's loop format)
    scores the same holdout; the lineage names it; a JAX-package
    version (a pickle) is refused as a deploy refuses it."""
    from predictionio_tpu_torch.online.registry import ModelRegistry
    from predictionio_tpu_torch.workflow.json_extractor import build_engine
    from predictionio_tpu_torch.workflow.core_workflow import load_instance_models, run_train

    engine_json = write_json(tmp_path / "engine.json", variant_obj(**ALS))
    stores("port")
    variant = load_engine_variant(engine_json)
    instance = run_train(variant, device="cpu")
    _, [model] = load_instance_models(variant)
    registry = ModelRegistry.for_variant(variant, registry_dir=str(tmp_path / "reg"))
    params = variant.engine_params.to_json_obj()
    blob = build_engine(variant).serialize_models(None, variant.engine_params,
                                                  instance.id, [model])
    entry = registry.publish(blob,
                             {"source": "train", "instance_id": instance.id,
                              "engine_params": params})
    pinned = run_replay_eval(variant, model_version=entry.version,
                             registry_dir=str(tmp_path / "reg"), device="cpu")
    trained = run_replay_eval(variant, device="cpu")
    assert pinned["model"]["source"] == "registry"
    assert pinned["model"]["model_version"] == entry.version
    assert pinned["model"]["instance_id"] == instance.id
    assert pinned["split"] == trained["split"]
    assert pinned["retrieval_guard"]["users_compared"] == trained["retrieval_guard"]["users_compared"]
    pickled = registry.publish(b"\x80\x04N.", {"source": "train", "engine_params": params})
    with pytest.raises(ValueError, match="pickle"):
        run_replay_eval(variant, model_version=pickled.version,
                        registry_dir=str(tmp_path / "reg"), device="cpu")


# --------------------------------------------------------------------------
# k-fold run_evaluation
# --------------------------------------------------------------------------


def precision(eval_info, query, prediction, actual):
    got = [s["item"] for s in prediction["itemScores"]]
    if not got:
        return None
    return len(set(got) & set(actual)) / len(got)


def test_kfold_evaluation_equals_the_reference(stores):
    """The reference's ``test_evaluation_precision_at_k`` metric, both
    packages, the same candidates."""
    candidates = [
        {"datasource": {"params": {"appName": APP, "evalFolds": 2, "evalK": 10}},
         "algorithms": [{"name": "als", "params": dict(ALS, retrieval={}, rank=r,
                                                       seenFilter=seen)}]}
        for r, seen in ((4, "model"), (6, "live"))
    ]
    stores("jax")
    want = jax_run_evaluation(
        JaxEvaluation(engine=jax_rec_factory(), metric=JaxOptionAverage(score=precision)),
        JaxGenerator([JaxEngineParams.from_json_obj(c) for c in candidates]),
        runtime_conf={"pio.mesh_shape": [1, 1]})
    stores("port")
    got = run_evaluation(
        Evaluation(engine=recommendation.engine_factory(),
                   metric=OptionAverageMetric(score=precision)),
        EngineParamsGenerator([EngineParams.from_json_obj(c) for c in candidates]),
        evaluation_class="tests.precision", device="cpu")
    assert got.status == "COMPLETED"
    recorded = storage.get_meta_data_evaluation_instances().get(got.id)
    assert recorded.status == "COMPLETED" and recorded.evaluation_class == "tests.precision"
    g, w = json.loads(recorded.evaluator_results_json), json.loads(want.evaluator_results_json)
    assert g["bestScore"] == pytest.approx(w["bestScore"], abs=1e-4)
    assert g["bestIndex"] == w["bestIndex"]
    for a, b in zip(g["results"], w["results"]):
        assert a["score"] == pytest.approx(b["score"], abs=1e-4)
        assert a["engineParams"] == b["engineParams"]
    # a random top-10 holds about 16 held-out items / 720 = 0.022 precision
    assert g["bestScore"] > 1.5 * 16 / ITEMS
    assert "<= BEST" in recorded.evaluator_results


def test_failed_evaluation_is_recorded(stores):
    stores("port")
    evaluation = Evaluation(engine=recommendation.engine_factory(),
                            metric=OptionAverageMetric(score=precision))
    bad = EngineParamsGenerator([EngineParams.from_json_obj(
        {"datasource": {"params": {"appName": "NoSuchApp"}},
         "algorithms": [{"name": "als", "params": ALS}]})])
    with pytest.raises(Exception):
        run_evaluation(evaluation, bad, device="cpu")
    (instance,) = storage.get_meta_data_evaluation_instances().get_all()
    assert instance.status == "FAILED"
    with pytest.raises(TypeError, match="not the port's EngineParams"):
        run_evaluation(evaluation, EngineParamsGenerator([JaxEngineParams()]), device="cpu")


# --------------------------------------------------------------------------
# the command line (reference tests/test_eval.py:477-573)
# --------------------------------------------------------------------------


def run(capsys, *argv):
    try:
        code = cli.main(list(argv))
    except SystemExit as exc:  # a message exits 1, as the interpreter does
        code, said = (1, f"{exc.code}\n") if isinstance(exc.code, str) else (exc.code, "")
    else:
        said = ""
    out = capsys.readouterr()
    return code, out.out + out.err + said


@pytest.fixture()
def port_variant(stores, tmp_path):
    stores("port")
    return write_json(tmp_path / "engine.json", variant_obj(**dict(ALS, retrieval={})))


def test_cli_round_trip(port_variant, tmp_path, capsys):
    out_path = tmp_path / "report.json"
    boundary = (BASE + dt.timedelta(seconds=900)).isoformat()
    code, out = run(capsys, "eval", "--replay", "--variant", port_variant,
                    "--split-time", boundary, "--k", "5", "--metrics", "ndcg,hit_rate",
                    "--no-retrieval-guard", "--output-path", str(out_path), "--device", "cpu")
    assert code == 0
    report = json.loads(out_path.read_text())
    assert set(report["metrics"]) == {"ndcg_at_5", "hit_rate_at_5"}
    assert report["split"]["split_time_iso"] == boundary
    assert f"Results written to {out_path}" in out


@pytest.mark.parametrize("argv, said", [
    (["--metrics", "precision"], ("unknown metric", "hit_rate")),
    (["--split-time", "jan 5th"], ("malformed --split-time", "ISO-8601")),
    (["--split-time", "2024-03-01T00:10:00Z", "--split-frac", "0.5"], ("exactly one",)),
    (["--model-version", "7"], ("model version 7", "retained")),
])
def test_cli_exit2_contract(port_variant, tmp_path, capsys, argv, said):
    code, out = run(capsys, "eval", "--replay", "--variant", port_variant,
                    "--registry-dir", str(tmp_path / "registry"), "--device", "cpu", *argv)
    assert code == 2
    for text in said:
        assert text in out


def test_cli_unsupported_template_and_missing_evaluation(stores, tmp_path, capsys):
    stores("port")
    engine_json = write_json(tmp_path / "engine.json",
                             variant_obj("sasrec", epochs=1, eventNames=["rate"]))
    code, out = run(capsys, "eval", "--replay", "--variant", engine_json, "--device", "cpu")
    assert code == 2 and "read_replay" in out
    code, out = run(capsys, "eval")
    assert code == 2 and "--replay" in out


def test_cli_dotted_evaluation(stores, tmp_path, capsys):
    """``eval EVALUATION GENERATOR`` from a user module built of the
    port's objects; one built of the JAX package's is refused."""
    stores("port")
    (tmp_path / "my_eval.py").write_text(
        "from predictionio_tpu_torch.controller.engine import EngineParams\n"
        "from predictionio_tpu_torch.models.recommendation import engine_factory\n"
        "from predictionio_tpu_torch.controller.metrics import (\n"
        "    EngineParamsGenerator, Evaluation, OptionAverageMetric)\n"
        "def hit(info, q, p, a):\n"
        "    got = [s['item'] for s in p['itemScores']]\n"
        "    return float(bool(set(got) & set(a))) if got else None\n"
        "EVALUATION = Evaluation(engine=engine_factory(),\n"
        "                        metric=OptionAverageMetric(score=hit))\n"
        f"PARAMS = {{'datasource': {{'params': {{'appName': '{APP}', 'evalFolds': 2}}}},\n"
        f"          'algorithms': [{{'name': 'als', 'params': {dict(ALS, retrieval={})!r}}}]}}\n"
        "def generator():\n"
        "    return EngineParamsGenerator([EngineParams.from_json_obj(PARAMS)])\n"
        "from predictionio_tpu.controller.metrics import Evaluation as JaxEvaluation\n"
        "JAX_ONE = JaxEvaluation\n"
    )
    out_path = tmp_path / "results.json"
    code, out = run(capsys, "eval", "my_eval.EVALUATION", "my_eval.generator",
                    "--engine-dir", str(tmp_path), "--device", "cpu",
                    "--output-path", str(out_path))
    assert code == 0, out
    assert "Evaluation instance ID:" in out
    assert json.loads(out_path.read_text())["bestScore"] > 0
    code, out = run(capsys, "eval", "my_eval.JAX_ONE", "my_eval.generator",
                    "--engine-dir", str(tmp_path), "--device", "cpu")
    assert code != 0 and "did not yield the port's Evaluation" in out
    code, out = run(capsys, "eval", "my_eval.nothing_here", "--engine-dir", str(tmp_path),
                    "--device", "cpu")
    assert code != 0 and "no attribute" in out


def test_the_verbs_default_to_the_card(port_variant, tmp_path, monkeypatch, capsys):
    """Without ``--device cpu`` and without a card, ``eval --replay``,
    k-fold ``eval`` and ``batchpredict`` raise; none carries on on the
    CPU."""
    import torch

    from predictionio_tpu_torch.workflow.core_workflow import run_train

    run_train(load_engine_variant(port_variant), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["eval", "--replay", "--variant", port_variant])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_evaluation(Evaluation(engine=recommendation.engine_factory(),
                                  metric=OptionAverageMetric(score=precision)),
                       EngineParamsGenerator([EngineParams()]))
    queries = tmp_path / "q.jsonl"
    queries.write_text('{"user": "u1"}\n')
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["batchpredict", "--variant", port_variant, "--input", str(queries),
                  "--output", str(tmp_path / "out.jsonl")])
