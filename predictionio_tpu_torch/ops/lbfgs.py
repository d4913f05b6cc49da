"""L-BFGS with the zoom line search, as the classification trainer calls it.

The JAX package trains its logistic regression with ``optax.lbfgs()`` at
its defaults (``predictionio_tpu/ops/classify.py:126-137``, optax 0.2.6).
This module is that algorithm in torch, not ``torch.optim.LBFGS``, whose
line search and first-step scaling differ. It is the chain
``optax/_src/alias.py::lbfgs`` builds:

- ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``
  (``optax/_src/transform.py``): the last 10 parameter and gradient
  differences in a ring indexed by ``count % 10``, each weighed
  ``1/<y,s>`` (0 where that product is 0); the two-loop recursion over
  all 10 slots, unused ones weighing 0; the identity scaled by
  ``<y,s>/<y,y>``, and before the first pair by ``min(1, 1/|g|)``;
- ``scale(-1)``, since no learning rate is given;
- ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy="one")`` (``optax/_src/linesearch.py``): the
  interval search and the zoom with cubic, quadratic or bisection steps,
  the Armijo and approximate decrease tests and the curvature test, and
  on failure the safe step (the best point of sufficient decrease seen).

``value_and_grad_from_state`` (``optax/_src/utils.py``) reuses the line
search's last value and gradient, so an iteration evaluates the loss
only inside its line search (the first one also at the start).

Where the state lives: the parameters, the gradients, the memory ring
and the two-loop recursion's scalars stay on the parameters' device.
The line search's scalars (values, slopes, step sizes, the interval)
are host ``numpy.float32``, the reference's jitted f32 scalar
arithmetic; each line-search step fetches its value and slope in one
transfer, the one host sync of the step (``LBFGSStats.host_syncs``).
A tree's ``vdot`` is the sum over its tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

F = np.float32
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
INCREASE_FACTOR = F(2.0)
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = F(1e-5)  # the zoom's interval threshold
TOL = F(0.0)


@dataclass
class LBFGSStats:
    """What one minimisation did: ``iterations`` updates,
    ``evaluations`` loss-and-gradient evaluations, ``linesearch_steps``
    over all line searches, ``host_syncs`` device-to-host transfers and
    ``safe_steps`` line searches that ended on the safe step."""

    iterations: int = 0
    evaluations: int = 0
    linesearch_steps: int = 0
    host_syncs: int = 0
    safe_steps: int = 0


def vdot(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The inner product of two parameter trees: the sum over tensors."""
    total = None
    for x, y in zip(xs, ys):
        v = torch.dot(x.reshape(-1), y.reshape(-1))
        total = v if total is None else total + v
    return total


def add_scale(xs, scalar, ys) -> list[torch.Tensor]:
    """``x + scalar * y`` per tensor (``optax.tree.add_scale``)."""
    return [x + scalar * y for x, y in zip(xs, ys)]


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through ``(a, fa)``, ``(b, fb)``,
    ``(c, fc)`` with slope ``fpa`` at ``a``; NaN where it has none
    (``optax/_src/linesearch.py::_cubicmin``)."""
    C = fpa
    db = b - a
    dc = c - a
    t = db * dc
    denom = t * t * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * dc * dc)) * v0 + db * db * db * v1) / denom
    radical = B * B - F(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (F(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through ``(a, fa)`` and
    ``(b, fb)`` with slope ``fpa`` at ``a`` (``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (F(2.0) * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """The Armijo test, or the approximate decrease test near a minimum
    (``_compute_decrease_error``): 0 when met, inf for a NaN."""
    err = value - value_init - F(SLOPE_RTOL) * stepsize * slope_init
    approx = slope - F(2 * SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - F(APPROX_DEC_RTOL) * np.abs(value_init)
    err = np.minimum(np.maximum(approx, delta), err)
    err = np.maximum(err, F(0.0))
    return F(np.inf) if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    """The curvature test (``_compute_curvature_error``)."""
    err = np.maximum(np.abs(slope) - F(CURV_RTOL) * np.abs(slope_init), F(0.0))
    return F(np.inf) if np.isnan(err) else err


class _ZoomLinesearch:
    """One zoom line search along ``updates`` from ``params``
    (``optax/_src/linesearch.py::zoom_linesearch``): ``run`` returns the
    step size and the value and gradient there."""

    def __init__(self, evaluate, params, updates, value, grad, slope, stats):
        self.evaluate, self.params, self.updates = evaluate, params, updates
        self.stats = stats
        self.count = 0
        self.stepsize, self.value, self.grad, self.slope = F(0.0), value, grad, slope
        self.value_init, self.slope_init = value, slope
        self.decrease_error = self.curvature_error = F(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = F(0.0), value, slope
        self.high, self.value_high, self.slope_high = F(0.0), value, slope
        self.cubic_ref, self.value_cubic_ref = F(0.0), value
        self.safe_stepsize, self.safe_value, self.safe_grad = F(0.0), value, grad

    def _on_line(self, stepsize):
        """Value, gradient and slope at ``params + stepsize * updates``:
        the device evaluates, the host receives value and slope."""
        step = add_scale(self.params, float(stepsize), self.updates)
        value, grad = self.evaluate(step)
        slope = vdot(grad, self.updates)
        fetched = torch.stack([value, slope]).cpu().numpy()
        self.stats.evaluations += 1
        self.stats.host_syncs += 1
        return F(fetched[0]), grad, F(fetched[1])

    def _errors(self, stepsize, value, slope):
        dec = _decrease_error(stepsize, value, slope, self.value_init, self.slope_init)
        curv = _curvature_error(slope, self.slope_init)
        return dec, curv, np.maximum(dec, curv)

    def _search_interval(self):
        """Algorithm 3.5 of Nocedal and Wright (``_search_interval``)."""
        iter_num = self.count
        prev_stepsize, prev_value, prev_slope = self.stepsize, self.value, self.slope
        new_stepsize = F(1.0) if iter_num == 0 else INCREASE_FACTOR * prev_stepsize
        value, grad, slope = self._on_line(new_stepsize)
        dec, curv, error = self._errors(new_stepsize, value, slope)
        if dec <= TOL:
            self.safe_stepsize, self.safe_value, self.safe_grad = new_stepsize, value, grad
        set_high_to_new = bool(dec > 0.0) or (bool(value >= prev_value) and iter_num > 0)
        set_low_to_new = bool(slope >= 0.0) and not set_high_to_new
        if set_low_to_new:
            low, high = (new_stepsize, value, slope), (prev_stepsize, prev_value, prev_slope)
        else:
            low, high = (prev_stepsize, prev_value, prev_slope), (new_stepsize, value, slope)
        self.interval_found = set_high_to_new or set_low_to_new or bool(error <= TOL)
        self.done = bool(error <= TOL)
        self.failed = iter_num + 1 >= MAX_LINESEARCH_STEPS and not self.done
        self.low, self.value_low, self.slope_low = low
        self.high, self.value_high, self.slope_high = high
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self.stepsize, self.value, self.grad, self.slope = new_stepsize, value, grad, slope
        self.decrease_error, self.curvature_error = dec, curv

    def _zoom_into_interval(self):
        """Algorithm 3.6 of Nocedal and Wright (``_zoom_into_interval``)."""
        low, value_low, slope_low = self.low, self.value_low, self.slope_low
        high, value_high, slope_high = self.high, self.value_high, self.slope_high
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic_chk, quad_chk = F(0.2) * delta, F(0.1) * delta
        too_small_int = bool(delta <= STEPSIZE_PRECISION)
        middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                 self.cubic_ref, self.value_cubic_ref)
        middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
        if left + cubic_chk < middle_cubic < right - cubic_chk:
            middle = middle_cubic
        elif left + quad_chk < middle_quad < right - quad_chk:
            middle = middle_quad
        else:
            middle = (low + high) / F(2.0)
        value, grad, slope = self._on_line(middle)
        dec, curv, error = self._errors(middle, value, slope)
        if dec <= TOL and value < self.safe_value:
            self.safe_stepsize, self.safe_value, self.safe_grad = middle, value, grad
        self.done = bool(error <= TOL)
        set_high_to_middle = bool(dec > 0.0) or bool(value >= value_low)
        set_high_to_low = bool(slope * (high - low) >= 0.0) and not set_high_to_middle
        if set_high_to_middle:
            self.high, self.value_high, self.slope_high = middle, value, slope
        if set_high_to_low:
            self.high, self.value_high, self.slope_high = low, value_low, slope_low
        if not set_high_to_middle:
            self.low, self.value_low, self.slope_low = middle, value, slope
        if set_high_to_middle or set_high_to_low:
            self.cubic_ref, self.value_cubic_ref = high, value_high
        else:
            self.cubic_ref, self.value_cubic_ref = low, value_low
        presumably_failed = self.count + 1 >= MAX_LINESEARCH_STEPS or (
            too_small_int and bool(self.safe_stepsize > 0.0))
        self.failed = presumably_failed and not self.done
        self.stepsize, self.value, self.grad, self.slope = middle, value, grad, slope
        self.decrease_error, self.curvature_error = dec, curv

    def _try_safe_step(self):
        """On failure, the best step of sufficient decrease found, if any
        (``_try_safe_step``)."""
        self.stats.safe_steps += 1
        if self.safe_stepsize > 0.0 or np.isinf(self.decrease_error):
            self.stepsize, self.value, self.grad = (
                self.safe_stepsize, self.safe_value, self.safe_grad)

    def run(self):
        with np.errstate(all="ignore"):
            while not (self.done or self.failed):
                if self.interval_found:
                    self._zoom_into_interval()
                else:
                    self._search_interval()
                self.count += 1
                self.stats.linesearch_steps += 1
                if self.failed:
                    self._try_safe_step()
        return self.stepsize, self.value, self.grad


def lbfgs_minimize(
    value_and_grad: Callable[[list[torch.Tensor]], tuple[torch.Tensor, list[torch.Tensor]]],
    params: Sequence[torch.Tensor],
    iterations: int,
    *,
    on_iterate: Callable[[int, list[torch.Tensor]], None] | None = None,
) -> tuple[list[torch.Tensor], LBFGSStats]:
    """``iterations`` updates of ``optax.lbfgs()`` from ``params``.

    ``value_and_grad(params)`` returns the loss (a 0-d tensor) and its
    gradient, one tensor per parameter, on the parameters' device.
    ``on_iterate(k, params)`` sees the parameters after update ``k``
    (1-based). Returns the final parameters and the ``LBFGSStats``."""
    stats = LBFGSStats()
    params = [p.detach() for p in params]
    device, dtype = params[0].device, params[0].dtype
    m = MEMORY_SIZE
    dp_mem = [torch.zeros((m,) + tuple(p.shape), dtype=dtype, device=device) for p in params]
    du_mem = [torch.zeros_like(d) for d in dp_mem]
    rho = torch.zeros(m, dtype=dtype, device=device)
    prev_params = prev_grad = None
    value = F(np.inf)  # the line search's last value: none before the first
    grad = None

    for count in range(iterations):
        # value_and_grad_from_state: the last line search's, unless not finite
        fresh = not np.isfinite(value)
        if fresh:
            value_dev, grad = value_and_grad(params)
            stats.evaluations += 1
        # scale_by_lbfgs: the memory, then the preconditioned direction
        idx, prev = count % m, (count - 1) % m
        if count > 0:
            dp = [p - q for p, q in zip(params, prev_params)]
            du = [g - q for g, q in zip(grad, prev_grad)]
            yts = vdot(du, dp)
            rho[prev] = torch.where(yts == 0.0, torch.zeros_like(yts), 1.0 / yts)
            for mem, new in zip(dp_mem + du_mem, dp + du):
                mem[prev] = new
            yty = vdot(du, du)
            gamma = torch.where(yty > 0.0, yts / yty, torch.ones_like(yty))
        else:
            gamma = torch.clamp(1.0 / torch.sqrt(vdot(grad, grad)), max=1.0)
        prev_params, prev_grad = params, grad
        order = [(idx + j) % m for j in range(m)]
        vec, alphas = list(grad), {}
        for j in reversed(order):
            alphas[j] = rho[j] * vdot([d[j] for d in dp_mem], vec)
            vec = add_scale(vec, -alphas[j], [u[j] for u in du_mem])
        vec = [gamma * v for v in vec]
        for j in order:
            beta = rho[j] * vdot([u[j] for u in du_mem], vec)
            vec = add_scale(vec, alphas[j] - beta, [d[j] for d in dp_mem])
        updates = [-v for v in vec]
        # the zoom line search, started from the value and slope here
        slope_dev = vdot(updates, grad)
        if fresh:
            value, slope = (F(v) for v in torch.stack([value_dev, slope_dev]).cpu().numpy())
        else:
            slope = F(slope_dev.cpu().numpy())
        stats.host_syncs += 1
        search = _ZoomLinesearch(value_and_grad, params, updates, value, grad, slope, stats)
        stepsize, value, grad = search.run()
        params = add_scale(params, float(stepsize), updates)
        stats.iterations += 1
        if on_iterate is not None:
            on_iterate(count + 1, params)
    return params, stats
