"""The classifiers and k-means over the ``data`` axis, against the JAX package's.

``d`` gloo processes (a ``[d, 1]`` mesh; for ``d = 4`` also ``[2, 2]``,
whose model ranks repeat the work) train on example counts ``d`` does
not divide, so the zero-weight pad rows take part. The reference runs
the same calls on ``local_mesh(d, 1)`` of the 8 virtual CPU devices:

- Naive Bayes within ``rtol=1e-6``;
- logistic regression: the first 10 L-BFGS iterates within 1e-5 of the
  largest weight on non-separable data (``tests/test_torch_lbfgs.py``'s
  bar) and within ``rtol=2e-3, atol=2e-4`` on the SMS messages (the
  reference's bar for another reduction order); the 100-update model
  gives the reference's labels and lies no farther from the reference's
  single-device fit than the reference's sharded fit does, or within
  that bar;
- k-means: centers within 1e-4, the same ``iterations_run``, cost
  within 1e-5 relative.

Then two ``tools/cli.py train`` processes of the classification template
(naive-bayes and logistic-regression, the mesh given after ``--``) on one
store: one COMPLETED instance, whose blob serves the labels of a
one-process train.
"""

import functools
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from predictionio_tpu.models import e2 as jax_e2
from predictionio_tpu.ops import classify as jax_classify
from predictionio_tpu.parallel import mesh as jax_mesh
from predictionio_tpu_torch.data import storage
from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.storage.base import App
from predictionio_tpu_torch.models.classification.engine import NaiveBayesAlgorithm
from predictionio_tpu_torch.workflow.core_workflow import load_instance_models, run_train
from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant
from test_torch_classification import HAM, QUERIES, SPAM, sms_events
from test_torch_distributed import run_workers
from test_torch_store_train import _two_process_train, basedir, fill_store, write_json  # noqa: F401
from test_torch_leakwatch import port_span_watch, port_span_watch_session  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB_RTOL = 1e-6
EARLY = 10
EARLY_RTOL = 1e-5
LR_TOL = dict(rtol=2e-3, atol=2e-4)
KM_ATOL, KM_COST_RTOL = 1e-4, 1e-5


def classify_inputs() -> dict:
    """The trainers' inputs, from fixed seeds: name -> (x, y, classes) or,
    for k-means, (x, k, iterations, seed). Row counts 203, 13 and 1,001
    leave pad rows on 2 and 4 ranks."""
    from predictionio_tpu_torch.ops.features import hashing_vectorize

    rng = np.random.default_rng(3)
    nb_x = rng.poisson(1.5, (203, 24)).astype(np.float32)
    nb_y = rng.integers(0, 3, 203).astype(np.int32)
    rng = np.random.default_rng(4)
    lr_x = rng.normal(size=(203, 5)).astype(np.float32)
    lr_y = np.argmax(lr_x[:, :3] + 0.8 * rng.normal(size=(203, 3)), axis=1).astype(np.int32)
    texts = SPAM + HAM + ["free lunch prize now"]
    sms_y = np.array([1] * 6 + [0] * 6 + [1], np.int32)
    rng = np.random.default_rng(20)
    centers = rng.normal(0, 6, (8, 3))
    rng = np.random.default_rng(21)
    km_x = np.concatenate([rng.normal(c, 1.0, size=(125, 3)) for c in centers])[:1001]
    return {"nb": (nb_x, nb_y, 3), "lr_noisy": (lr_x, lr_y, 3),
            "lr_sms": (hashing_vectorize(texts, 4096), sms_y, 2),
            "kmeans": (km_x.astype(np.float32), 8, 40, 5)}


_WORKER = """
import sys

import numpy as np

from predictionio_tpu_torch.models import e2
from predictionio_tpu_torch.ops import classify
from predictionio_tpu_torch.parallel import distributed, mesh as M

out, d = sys.argv[1], int(sys.argv[2])
assert distributed.init_distributed(device="cpu")
rank = distributed.distributed_info()["rank"]
data = classify_inputs()
res = {}
meshes = {"": distributed.build_mesh([d, 1], ("data", "model"), device="cpu")}
if d == 4:
    meshes["2x2."] = distributed.build_mesh([2, 2], ("data", "model"), device="cpu")
for tag, mesh in meshes.items():
    x, y, c = data["nb"]
    nb = classify.train_naive_bayes(x, y, c, mesh=mesh)
    res[tag + "nb.log_prior"], res[tag + "nb.log_likelihood"] = nb.log_prior, nb.log_likelihood
mesh = meshes[""]
for name in ("lr_noisy", "lr_sms"):
    x, y, c = data[name]
    early = []
    model = classify.train_logistic_regression(
        x, y, c, iterations=100, mesh=mesh,
        on_iterate=lambda k, p: early.append([t.numpy().copy() for t in p]) if k <= 10 else None)
    res[name + ".weights"], res[name + ".bias"] = model.weights, model.bias
    res[name + ".early_w"] = np.stack([w for w, _ in early])
    res[name + ".early_b"] = np.stack([b for _, b in early])
x, k, iterations, seed = data["kmeans"]
km = e2.kmeans(x, k=k, iterations=iterations, seed=seed, mesh=mesh)
res["km.centers"], res["km.cost"], res["km.iterations_run"] = km.centers, km.cost, km.iterations_run
# shard_examples: this rank's rows, the pad rows weighing 0
n = 2 * d - 1
xs, ys, ws, got = M.shard_examples(mesh, np.ones((n, 2)), np.arange(n))
assert got is mesh and xs.shape == (2, 2)
assert ys.tolist() == [2 * rank, 2 * rank + 1 if rank < d - 1 else 0], ys
assert ws.tolist() == ([1.0, 0.0] if rank == d - 1 else [1.0, 1.0]), ws
calls = M.collective_counts()
assert calls["gloo:all_reduce"] > 100 and calls["gloo:all_gather"] >= 1, calls
np.savez(f"{out}-{rank}.npz", **res)
distributed.shutdown_distributed()
print("OK", flush=True)
"""


def jax_iterates(x, y, classes, mesh, iterations=EARLY, reg=1e-4):
    """[(w, b)] after each update of the reference's sharded fit
    (``predictionio_tpu/ops/classify.py:106-137`` on ``mesh``), one
    jitted update a call so each iterate can be read."""
    x_j, y_j, w_j, _ = jax_mesh.shard_examples(mesh, x, y)

    def loss_fn(p):
        logits = x_j @ p["w"] + p["b"]
        nll = optax.softmax_cross_entropy_with_integer_labels(logits, y_j)
        nll = (nll * w_j).sum() / w_j.sum()
        return nll + reg * (p["w"] ** 2).sum()

    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(loss_fn)

    @jax.jit
    def step(p, state):
        value, grad = value_and_grad(p, state=state)
        updates, state = opt.update(grad, state, p, value=value, grad=grad, value_fn=loss_fn)
        return optax.apply_updates(p, updates), state

    params = {"w": jnp.zeros((x.shape[1], classes), jnp.float32),
              "b": jnp.zeros((classes,), jnp.float32)}
    state = opt.init(params)
    out = []
    for _ in range(iterations):
        params, state = step(params, state)
        out.append((np.asarray(params["w"]), np.asarray(params["b"])))
    return out


@functools.lru_cache(maxsize=None)
def jax_fits(name: str, d: int):
    """The reference's 100-update fits of ``name``: (sharded over ``d``,
    single-device)."""
    x, y, c = classify_inputs()[name]
    sharded = jax_classify.train_logistic_regression(x, y, c, mesh=jax_mesh.local_mesh(d, 1))
    single = jax_classify.train_logistic_regression(x, y, c)
    return sharded, single


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_fits_equal_the_reference(d, tmp_path):
    out = str(tmp_path / "fits")
    # the workers import no test module (JAX stays out of them)
    source = (f"import numpy as np\nSPAM, HAM = {SPAM!r}, {HAM!r}\n"
              + inspect.getsource(classify_inputs) + _WORKER)
    run_workers(source, n=d, args=(out, d), timeout=300)
    got = [dict(np.load(f"{out}-{r}.npz")) for r in range(d)]
    for g in got[1:]:  # every rank returns the whole model
        for key, value in g.items():
            np.testing.assert_array_equal(value, got[0][key], err_msg=key)
    got = got[0]
    data = classify_inputs()

    x, y, c = data["nb"]
    for tag, mesh in (("", (d, 1)),) + ((("2x2.", (2, 2)),) if d == 4 else ()):
        want = jax_classify.train_naive_bayes(x, y, c, mesh=jax_mesh.local_mesh(*mesh))
        np.testing.assert_allclose(got[tag + "nb.log_prior"], want.log_prior, rtol=NB_RTOL)
        np.testing.assert_allclose(got[tag + "nb.log_likelihood"], want.log_likelihood,
                                   rtol=NB_RTOL)

    for name in ("lr_noisy", "lr_sms"):
        x, y, c = data[name]
        want = jax_iterates(x, y, c, jax_mesh.local_mesh(d, 1))
        for k, (ww, wb) in enumerate(want):
            gw, gb = got[name + ".early_w"][k], got[name + ".early_b"][k]
            if name == "lr_noisy":
                scale = max(np.abs(ww).max(), np.abs(wb).max())
                assert max(np.abs(gw - ww).max(), np.abs(gb - wb).max()) <= EARLY_RTOL * scale, k
            else:
                np.testing.assert_allclose(gw, ww, **LR_TOL, err_msg=f"iterate {k + 1}")
                np.testing.assert_allclose(gb, wb, **LR_TOL, err_msg=f"iterate {k + 1}")
        sharded, single = jax_fits(name, d)
        port = jax_classify.LogisticRegressionModel(got[name + ".weights"], got[name + ".bias"])
        assert (port.scores(x).argmax(1) == sharded.scores(x).argmax(1)).all()
        gap = np.abs(port.weights - single.weights).max()
        spread = np.abs(sharded.weights - single.weights).max()
        within_bar = np.all(np.abs(port.weights - single.weights)
                            <= LR_TOL["atol"] + LR_TOL["rtol"] * np.abs(single.weights))
        assert within_bar or gap <= spread, (name, gap, spread)

    x, k, iterations, seed = data["kmeans"]
    want = jax_e2.kmeans(x, k=k, iterations=iterations, seed=seed,
                         mesh=jax_mesh.local_mesh(d, 1))
    assert int(got["km.iterations_run"]) == want.iterations_run
    np.testing.assert_allclose(got["km.centers"], want.centers, atol=KM_ATOL)
    np.testing.assert_allclose(float(got["km.cost"]), want.cost, rtol=KM_COST_RTOL)


@pytest.mark.parametrize("algo", ["naive-bayes", "logistic-regression"])
def test_two_process_pio_train_serves_the_one_process_labels(basedir, tmp_path, algo):  # noqa: F811
    """``pio train -- --mesh-shape 2,1 --dcn-mesh-shape 1,1`` in two
    processes: rank 0 records the one instance; its model serves the
    labels (and, for Naive Bayes, the scores within 1e-6) of a
    one-process train of the same engine.json."""
    base = basedir(tmp_path / "store")
    fill_store(storage, App, Event, sms_events(), app_name="SmsApp")
    with open(os.path.join(REPO, "examples", "classification", "engine.json")) as f:
        variant = json.load(f)
    variant["datasource"]["params"]["appName"] = "SmsApp"
    variant["algorithms"] = [{"name": algo, "params": {"iterations": 60}
                              if algo == "logistic-regression" else {}}]
    one = write_json(tmp_path / "one.json", variant)
    variant["sparkConf"] = {"pio.num_processes": 2}
    launch = write_json(tmp_path / "launch.json", dict(variant, id="classify-launch"))
    instance_id = _two_process_train(base, launch, "--", "--mesh-shape", "2,1",
                                     "--dcn-mesh-shape", "1,1")
    recorded = storage.get_meta_data_engine_instances().get_all()
    assert [(i.id, i.status) for i in recorded] == [(instance_id, "COMPLETED")]
    assert recorded[0].runtime_conf == {"pio.mesh_shape": [2, 1], "pio.dcn_mesh_shape": [1, 1]}
    single = run_train(load_engine_variant(one), device="cpu")
    _, [model] = load_instance_models(load_engine_variant(launch), instance_id)
    _, [want] = load_instance_models(load_engine_variant(one), single.id)
    algorithm = NaiveBayesAlgorithm(device="cpu")  # predict reads only the model
    queries = QUERIES + [{"text": t} for t in SPAM + HAM]
    for q in queries:
        got_answer, want_answer = algorithm.predict(model, q), algorithm.predict(want, q)
        assert got_answer["label"] == want_answer["label"], q
        if algo == "naive-bayes":
            np.testing.assert_allclose(list(got_answer["scores"].values()),
                                       list(want_answer["scores"].values()), rtol=1e-6)
