"""The port's L-BFGS (``ops/lbfgs.py``) against ``optax.lbfgs()``, on the CPU.

The reference trains its logistic regression with ``optax.lbfgs()`` at
its defaults (``predictionio_tpu/ops/classify.py:126-137``). Here the same
loss, from the same zero start, runs through optax (jitted, one update a
call, so each iterate can be read) and through the port; the iterates
after 1, 2, 5 and 10 updates must agree to ``1e-5`` relative to the
largest weight (f32 reductions differ between XLA and torch, so the
trajectories may part by rounding only), and the final model at the
reference's own bar for a different reduction order (``rtol=2e-3,
atol=2e-4``, ``tests/test_classification_template.py:99-100``). The data
are the reference tests' own: the linearly separable and the
203-example sets (``:64-70``, ``:85-99``) and the 12-message SMS set,
which is under-determined over 4,096 hashed columns and converges
slowly (its iterate at 60 updates is the hardest case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from predictionio_tpu.ops.features import hashing_vectorize
from predictionio_tpu_torch.ops import lbfgs
from predictionio_tpu_torch.ops.classify import train_logistic_regression

EARLY_RTOL = 1e-5
SPAM = ["win cash now", "free prize claim now", "win free entry", "cash prize winner",
        "claim your free cash", "urgent prize waiting"]
HAM = ["see you at lunch", "meeting moved to monday", "call me when home",
       "lunch tomorrow?", "are you coming home", "the meeting is at noon"]


def dataset(name):
    """(x, y, classes, iterations): the reference tests' inputs."""
    if name == "separable":
        rng = np.random.default_rng(0)
        x = rng.normal(size=(200, 4)).astype(np.float32)
        return x, (x[:, 0] + x[:, 1] > 0).astype(np.int32), 2, 60
    if name == "ragged":
        rng = np.random.default_rng(1)
        x = rng.normal(size=(203, 4)).astype(np.float32)
        return x, (x[:, 0] - x[:, 2] > 0).astype(np.int32), 2, 40
    if name == "three-class":
        rng = np.random.default_rng(7)
        x = rng.normal(size=(150, 6)).astype(np.float32)
        return x, np.argmax(x[:, :3] + 0.3 * x[:, 3:], axis=1).astype(np.int32), 3, 30
    x = hashing_vectorize(SPAM + HAM, 4096)
    return x, np.array([1] * 6 + [0] * 6, np.int32), 2, 60


def optax_iterates(x, y, classes, iterations, reg=1e-4):
    """[(w, b, linesearch steps)] after each update, the reference's loss
    and optimizer (``predictionio_tpu/ops/classify.py:110-137``)."""
    x_j, y_j = jnp.asarray(x), jnp.asarray(y)
    weights = jnp.ones(x.shape[0], jnp.float32)

    def loss_fn(p):
        logits = x_j @ p["w"] + p["b"]
        nll = optax.softmax_cross_entropy_with_integer_labels(logits, y_j)
        nll = (nll * weights).sum() / weights.sum()
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
        out.append((np.asarray(params["w"]), np.asarray(params["b"]),
                    int(optax.tree.get(state, "num_linesearch_steps"))))
    return out


def port_iterates(x, y, classes, iterations, stats=None):
    out = []
    train_logistic_regression(
        x, y, classes, iterations=iterations, device="cpu", stats=stats,
        on_iterate=lambda k, p: out.append((p[0].numpy().copy(), p[1].numpy().copy())))
    return out


@pytest.mark.parametrize("name", ["separable", "ragged", "three-class", "sms"])
def test_iterates_equal_optax(name):
    x, y, classes, iterations = dataset(name)
    want = optax_iterates(x, y, classes, iterations)
    stats = {}
    got = port_iterates(x, y, classes, iterations, stats)
    assert len(got) == iterations == stats["iterations"]
    for k in (1, 2, 5, 10):
        (gw, gb), (ww, wb, _) = got[k - 1], want[k - 1]
        scale = max(np.abs(ww).max(), np.abs(wb).max())
        assert max(np.abs(gw - ww).max(), np.abs(gb - wb).max()) <= EARLY_RTOL * scale, k
    (gw, gb), (ww, wb, _) = got[-1], want[-1]
    np.testing.assert_allclose(gw, ww, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(gb, wb, rtol=2e-3, atol=2e-4)
    # every evaluation is in a line search but the first; one host sync a
    # line-search step, one a direction
    assert stats["evaluations"] == stats["linesearch_steps"] + 1
    assert stats["host_syncs"] == stats["linesearch_steps"] + iterations
    assert iterations <= stats["linesearch_steps"] <= lbfgs.MAX_LINESEARCH_STEPS * iterations


def test_linesearch_step_counts_equal_optax_early():
    """The early line searches take as many steps as optax's: the same
    branches of the interval search and the zoom."""
    x, y, classes, _ = dataset("sms")
    want = [ls for _, _, ls in optax_iterates(x, y, classes, 10)]
    steps = []

    class Counting(lbfgs._ZoomLinesearch):
        def run(self):
            out = super().run()
            steps.append(self.count)
            return out

    real = lbfgs._ZoomLinesearch
    lbfgs._ZoomLinesearch = Counting
    try:
        port_iterates(x, y, classes, 10)
    finally:
        lbfgs._ZoomLinesearch = real
    assert steps == want


def test_interpolation_formulas_equal_optax():
    """The zoom's cubic and quadratic steps are optax's, in float32."""
    from optax._src import linesearch as optax_ls

    f32 = np.float32
    rng = np.random.default_rng(3)
    for _ in range(20):
        a, fa, fpa, b, fb, c, fc = (f32(v) for v in rng.normal(size=7))
        with np.errstate(all="ignore"):
            got_c = lbfgs._cubicmin(a, fa, fpa, b, fb, c, fc)
            got_q = lbfgs._quadmin(a, fa, fpa, b, fb)
        want_c = float(optax_ls._cubicmin(a, fa, fpa, b, fb, c, fc))
        want_q = float(optax_ls._quadmin(a, fa, fpa, b, fb))
        assert got_q == pytest.approx(want_q, rel=1e-5)
        if np.isnan(want_c):
            assert np.isnan(got_c)
        else:
            assert got_c == pytest.approx(want_c, rel=1e-4, abs=1e-6)


def test_minimizes_a_quadratic_like_optax():
    """A parameter tree of two tensors (a tree's vdot is the sum over
    both), an ill-conditioned quadratic: the same iterates as optax."""
    diag_w = np.linspace(1.0, 50.0, 6, dtype=np.float32).reshape(3, 2)
    diag_b = np.array([0.5, 8.0], np.float32)

    def jax_f(p):
        return 0.5 * (jnp.sum(diag_w * (p["w"] - 1.0) ** 2) + jnp.sum(diag_b * (p["b"] + 2.0) ** 2))

    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(jax_f)
    params = {"w": jnp.zeros((3, 2)), "b": jnp.zeros(2)}
    state = opt.init(params)
    for _ in range(6):
        value, grad = vg(params, state=state)
        updates, state = opt.update(grad, state, params, value=value, grad=grad, value_fn=jax_f)
        params = optax.apply_updates(params, updates)

    tw, tb = torch.from_numpy(diag_w), torch.from_numpy(diag_b)

    def torch_vg(p):
        w, b = (t.detach().requires_grad_() for t in p)
        value = 0.5 * ((tw * (w - 1.0) ** 2).sum() + (tb * (b + 2.0) ** 2).sum())
        return value.detach(), list(torch.autograd.grad(value, (w, b)))

    (w, b), stats = lbfgs.lbfgs_minimize(torch_vg, [torch.zeros(3, 2), torch.zeros(2)], 6)
    np.testing.assert_allclose(w.numpy(), np.asarray(params["w"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(params["b"]), rtol=1e-5, atol=1e-6)
    assert stats.iterations == 6
