"""Multinomial Naive Bayes and logistic regression, trained on the card.

Port of ``predictionio_tpu/ops/classify.py``. Neither trainer reaches a
Pallas kernel in the reference (its device work is plain ``jnp`` under
``jax.jit``), so both are plain torch on ``device`` (``cuda`` unless the
caller names ``"cpu"``; without a card and without that request they
raise):

- ``train_naive_bayes``: the count matrix is one product
  ``onehot(y).T @ x``; the smoothed log prior and log likelihood follow
  elementwise in float32.
- ``train_logistic_regression``: full-batch ``mean CE(x @ w + b, y) +
  reg * |w|^2`` minimised by ``ops/lbfgs.py``, the port of the
  ``optax.lbfgs()`` the reference calls. ``x`` is uploaded once per call;
  every evaluation is two passes over it on the device (the logits, the
  weight gradient). ``learning_rate`` is accepted and unused, as on the
  reference's L-BFGS branch (its Adam branch serves only optax versions
  without ``lbfgs`` and is not ported).

Without a mesh the reference's ``shard_examples`` weighs every example
1, so its weighted means and masked counts are plain ones here. A
``mesh`` spreads training over several devices, which the port does not
do yet: it raises (ROADMAP.md slice 20). The model dataclasses are
host numpy and copied.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np
import torch
import torch.nn.functional as F

from predictionio_tpu_torch.ops.lbfgs import lbfgs_minimize
from predictionio_tpu_torch.utils.device import resolve_device

MESH_NOT_PORTED = (
    "a device mesh spreads training over several devices, which the port "
    "does not do yet for the classifiers and k-means (ROADMAP.md slice 20); "
    "train on one device"
)


def refuse_mesh(mesh) -> None:
    """Raise for a mesh: the port trains on one device."""
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)


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
    """Multinomial NB on ``device``: the count matrix is one product."""
    refuse_mesh(mesh)
    dev = resolve_device(device)
    x = to_device(x, torch.float32, dev)
    # multinomial NB is defined over counts; negative features would poison
    # the log with NaNs (the reference rejects them the same way)
    if bool((x < 0).any()):
        raise ValueError(
            "NaiveBayes requires non-negative features (multinomial counts);"
            " use logistic-regression for signed features"
        )
    y = to_device(y, torch.long, dev)
    onehot = F.one_hot(y, num_classes).to(x.dtype)                   # [n, C]
    counts = onehot.T @ x                                            # [C, D]
    class_counts = onehot.sum(dim=0)                                 # [C]
    total = torch.tensor(float(x.shape[0]), dtype=x.dtype, device=dev)
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


def logistic_value_and_grad(x: torch.Tensor, y: torch.Tensor, reg: float):
    """``value_and_grad([w, b])``: ``mean CE(x @ w + b, y) + reg * |w|^2``
    (the reference's loss; ``F.cross_entropy`` is the same log-softmax
    CE as ``optax.softmax_cross_entropy_with_integer_labels``) as a 0-d
    tensor, and its gradient ``[dw, db]``, on ``x``'s device. One call
    reads ``x`` twice: the logits, and the weight gradient."""

    def value_and_grad(params):
        w, b = (p.detach().requires_grad_() for p in params)
        with torch.enable_grad():
            nll = F.cross_entropy(x @ w + b, y)
            value = nll + reg * (w ** 2).sum()
            grads = torch.autograd.grad(value, (w, b))
        return value.detach(), list(grads)

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
    """Full-batch multinomial logistic regression on ``device`` through
    L-BFGS, from zero weights, ``iterations`` updates.

    ``stats`` (a dict) receives ``ops/lbfgs.py``'s ``LBFGSStats``
    fields; ``on_iterate(k, [w, b])`` sees the device parameters after
    update ``k``."""
    del learning_rate  # the L-BFGS line search sets every step
    refuse_mesh(mesh)
    dev = resolve_device(device)
    x = to_device(x, torch.float32, dev)
    y = to_device(y, torch.long, dev)
    init = [
        torch.zeros((x.shape[1], num_classes), dtype=torch.float32, device=dev),
        torch.zeros((num_classes,), dtype=torch.float32, device=dev),
    ]
    (w, b), run = lbfgs_minimize(logistic_value_and_grad(x, y, reg), init, iterations,
                                 on_iterate=on_iterate)
    if stats is not None:
        stats.update(asdict(run))
    return LogisticRegressionModel(w.cpu().numpy(), b.cpu().numpy())
