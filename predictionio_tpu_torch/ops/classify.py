"""Multinomial Naive Bayes and logistic regression, trained on the card.

Port of ``predictionio_tpu/ops/classify.py``. Neither trainer reaches a
Pallas kernel in the reference (its device work is plain ``jnp`` under
``jax.jit``), so both are plain torch on ``device`` (``cuda`` unless the
caller names ``"cpu"``; without a card and without that request they
raise):

- ``train_naive_bayes``: the count matrix is one product
  ``onehot(y).T @ x``; the smoothed log prior and log likelihood follow
  elementwise in float32.
- ``train_logistic_regression``: full-batch ``sum(CE(x @ w + b, y) * w)
  / sum(w) + reg * |w|^2`` minimised by ``ops/lbfgs.py``, the port of the
  ``optax.lbfgs()`` the reference calls. ``x`` is uploaded once per call;
  every evaluation is two passes over it on the device (the logits, the
  weight gradient). ``learning_rate`` is accepted and unused, as on the
  reference's L-BFGS branch (its Adam branch serves only optax versions
  without ``lbfgs`` and is not ported).

Both trainers take one path, the reference's: ``shard_examples`` puts
the examples over the ``data`` axis of the ``mesh`` when that axis is
above 1 (each rank holds its rows, zero-weight pad rows making ``n``
divide the axis), else every example at weight 1 on ``device`` over a
1-rank ``data`` mesh, whose ``all_reduce_sum`` is the identity. One
``all_reduce_sum`` over ``("data",)`` joins the ranks' sums:

- Naive Bayes: the weighted counts, class counts and ``w.sum()`` in one
  all-reduce;
- logistic regression: each evaluation's weighted NLL sum, its gradient
  and ``w.sum()`` in one all-reduce; the ``reg`` term and its gradient
  are added once, after it. Every rank then sees the same bits and takes
  the same line-search decisions; the final parameters' checksum must
  agree along the axis (``check_replicas_agree``) or the fit raises.

The parameters are replicated; a ``model`` axis above 1 repeats the work
on each model rank, as the reference's ``P("data")`` replication does.
The model dataclasses are host numpy and copied.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np
import torch
import torch.nn.functional as F

from predictionio_tpu_torch.ops.lbfgs import lbfgs_minimize
from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_sum,
    shard_examples,
)
from predictionio_tpu_torch.utils.device import resolve_device


def data_mesh(mesh):
    """``mesh`` when its ``data`` axis spreads examples (above 1), else
    None: the trainer runs as on one device."""
    return mesh if mesh is not None and mesh.axis_size("data") > 1 else None


def example_mesh(mesh, device) -> Mesh:
    """The mesh the trainers spread examples over: ``mesh`` when its
    ``data`` axis is above 1, else a 1-rank ``data`` mesh on ``device``."""
    return data_mesh(mesh) or Mesh(("data",), (1,), (0,), resolve_device(device))


def check_replicas_agree(mesh, params, what: str) -> None:
    """Raise unless every rank of the ``data`` axis holds the same bits
    in ``params`` (a position-weighted checksum of their int32 views,
    gathered along the axis)."""
    bits = torch.cat([p.detach().reshape(-1) for p in params]).view(torch.int32).to(torch.int64)
    checksum = (bits * torch.arange(1, bits.numel() + 1, device=bits.device)).sum()
    sums = all_gather_rows(mesh, ("data",), checksum.reshape(1)).tolist()
    if len(set(sums)) != 1:
        raise RuntimeError(f"{what}: the data axis's replicas parted (checksums {sums})")


def to_device(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``a`` (numpy or torch) as a ``dtype`` tensor on ``device``, copied
    only when it is not one already."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


@dataclass
class NaiveBayesModel:
    log_prior: np.ndarray       # [C]
    log_likelihood: np.ndarray  # [C, D]

    def scores(self, x: np.ndarray) -> np.ndarray:
        """Log-posterior (unnormalized) per class: [n, C]."""
        return x @ self.log_likelihood.T + self.log_prior


def train_naive_bayes(
    x,
    y,
    num_classes: int,
    smoothing: float = 1.0,
    mesh=None,
    *,
    device=None,
) -> NaiveBayesModel:
    """Multinomial NB on ``device`` (a spreading ``mesh``: its ranks'
    devices): the count matrix is one product."""
    # multinomial NB is defined over counts; negative features would poison
    # the log with NaNs (the reference rejects them the same way)
    if bool((torch.as_tensor(x) < 0).any()):
        raise ValueError(
            "NaiveBayes requires non-negative features (multinomial counts);"
            " use logistic-regression for signed features"
        )
    x, y, w, mesh = shard_examples(example_mesh(mesh, device), x, y)
    onehot = F.one_hot(y.long(), num_classes).to(x.dtype) * w[:, None]  # pad rows: 0
    c, d = onehot.shape[1], x.shape[1]
    summed = all_reduce_sum(mesh, ("data",), torch.cat([
        (onehot.T @ x).reshape(-1), onehot.sum(dim=0), w.sum().reshape(1)]))
    counts = summed[:c * d].view(c, d)
    class_counts, total = summed[c * d:-1], summed[-1]
    log_prior = torch.log(class_counts + smoothing) - torch.log(
        total + num_classes * smoothing
    )
    smoothed = counts + smoothing
    log_likelihood = torch.log(smoothed) - torch.log(smoothed.sum(dim=1, keepdim=True))
    return NaiveBayesModel(log_prior.cpu().numpy(), log_likelihood.cpu().numpy())


@dataclass
class LogisticRegressionModel:
    weights: np.ndarray  # [D, C]
    bias: np.ndarray     # [C]

    def scores(self, x: np.ndarray) -> np.ndarray:
        logits = x @ self.weights + self.bias
        e = np.exp(logits - logits.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)


def logistic_value_and_grad(mesh, x: torch.Tensor, y: torch.Tensor,
                            weights: torch.Tensor, reg: float):
    """``value_and_grad([w, b])`` over the ``data`` axis: the reference's
    ``sum(nll * w) / sum(w) + reg * |w|^2`` (``F.cross_entropy`` is the
    same log-softmax CE as ``optax.softmax_cross_entropy_with_integer_labels``)
    as a 0-d tensor, and its gradient ``[dw, db]``. Each rank computes its
    rows' weighted NLL sum and its gradient (two passes over ``x``: the
    logits, the weight gradient); one all-reduce carries them and
    ``sum(w)``; the ``reg`` term and its gradient are added after it,
    once."""
    total_w = weights.sum().reshape(1)

    def value_and_grad(params):
        w, b = (p.detach().requires_grad_() for p in params)
        with torch.enable_grad():
            nll = F.cross_entropy(x @ w + b, y, reduction="none")
            nll_sum = (nll * weights).sum()
            gw, gb = torch.autograd.grad(nll_sum, (w, b))
        summed = all_reduce_sum(mesh, ("data",), torch.cat([
            gw.reshape(-1), gb, nll_sum.detach().reshape(1), total_w]))
        w, total = w.detach(), summed[-1]
        value = summed[-2] / total + reg * (w ** 2).sum()
        grads = [summed[:w.numel()].view_as(w) / total + 2.0 * reg * w,
                 summed[w.numel():-2] / total]
        return value, grads

    return value_and_grad


def train_logistic_regression(
    x,
    y,
    num_classes: int,
    reg: float = 1e-4,
    iterations: int = 100,
    learning_rate: float = 0.1,
    mesh=None,
    *,
    device=None,
    stats: dict | None = None,
    on_iterate=None,
) -> LogisticRegressionModel:
    """Full-batch multinomial logistic regression on ``device`` (a
    spreading ``mesh``: its ranks' devices, the examples over ``data``)
    through L-BFGS, from zero weights, ``iterations`` updates.

    ``stats`` (a dict) receives ``ops/lbfgs.py``'s ``LBFGSStats``
    fields; ``on_iterate(k, [w, b])`` sees the device parameters after
    update ``k``."""
    del learning_rate  # the L-BFGS line search sets every step
    x, y, weights, mesh = shard_examples(example_mesh(mesh, device), x, y)
    dev = mesh.device
    value_and_grad = logistic_value_and_grad(mesh, x, y.long(), weights, reg)
    init = [
        torch.zeros((x.shape[1], num_classes), dtype=torch.float32, device=dev),
        torch.zeros((num_classes,), dtype=torch.float32, device=dev),
    ]
    (w, b), run = lbfgs_minimize(value_and_grad, init, iterations, on_iterate=on_iterate)
    check_replicas_agree(mesh, (w, b), "logistic regression")
    if stats is not None:
        stats.update(asdict(run))
    return LogisticRegressionModel(w.cpu().numpy(), b.cpu().numpy())
