"""Lloyd's K-Means on the card.

Port of ``predictionio_tpu/ops/kmeans.py``. The reference's Lloyd step
is plain ``jnp`` under ``jax.jit`` (no Pallas kernel), so it is plain
torch on ``device`` here (``cuda`` unless the caller names ``"cpu"``):

- the assignment is the matmul identity ``|x - c|^2 = |x|^2 - 2 x.c +
  |c|^2``, one ``[N, D] @ [D, K]`` product, then ``argmin`` (the first
  index on ties, as ``jnp.argmin``);
- the update is the one-hot product ``onehot(assign)^T @ x`` and the
  per-cluster counts; a cluster with no point keeps its center;
- k-means++ seeding (``_kmeanspp_init``) and ``KMeansModel`` (whose
  ``predict`` is host numpy) are copied.

The stopping rule, the final assignment-only pass (so ``cost`` is that
of the returned centers) and the ``ValueError``s are the reference's.
A ``mesh`` whose ``data`` axis is above 1 spreads the rows over it, as
the reference does: every rank holds ``x`` in full and seeds k-means++
on the host from the same ``seed`` (so the centers agree), the rows pad
with zero-weight rows to a multiple of ``8 x`` the axis, each rank takes
its slice, and a Lloyd step's ``[K, D]`` sums, ``[K]`` counts and cost
go in one ``all_reduce_sum`` over ``("data",)``, so the stop rule reads
the same cost on every rank. At data 1 the pad rows would count
nothing, so the port leaves them out (``tests/test_torch_e2.py`` holds
a fit of 1,001 rows to the reference's padded one). ``x`` is uploaded
once per fit; each Lloyd iteration syncs once, for its cost.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from predictionio_tpu_torch.ops.classify import data_mesh, to_device
from predictionio_tpu_torch.parallel.mesh import all_reduce_sum, put_global
from predictionio_tpu_torch.utils.device import resolve_device


def lloyd_step(x: torch.Tensor, centers: torch.Tensor, weights: torch.Tensor | None = None,
               mesh=None):
    """One Lloyd iteration: ``(new_centers, assign, cost)``, the cost
    that of the INPUT centers (the assignment happens before the
    update). With ``weights`` and ``mesh`` (this rank's rows of ``x``
    over ``data``, pad rows weighing 0): the weighted sums, counts and
    cost summed over the axis in one all-reduce."""
    k = centers.shape[0]
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(centers * centers, dim=1)
    d = x2 - 2.0 * (x @ centers.T) + c2[None]
    assign = torch.argmin(d, dim=1)
    onehot = F.one_hot(assign, k).to(x.dtype)
    nearest = torch.min(d, dim=1).values
    if weights is not None:
        onehot = onehot * weights[:, None]  # pad rows count nothing
        nearest = nearest * weights
    sums = onehot.T @ x                 # [K, D]
    counts = onehot.sum(dim=0)          # [K]
    cost = torch.sum(nearest)
    if mesh is not None:
        summed = all_reduce_sum(mesh, ("data",), torch.cat([
            sums.reshape(-1), counts, cost.reshape(1)]))
        at = sums.numel()
        sums, counts, cost = summed[:at].view_as(sums), summed[at:-1], summed[-1]
    new_centers = torch.where(
        counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), centers
    )
    return new_centers, assign, cost


def _kmeanspp_init(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Standard k-means++ seeding (host, numpy)."""
    n = x.shape[0]
    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    centers[0] = x[rng.integers(n)]
    d2 = np.sum((x - centers[0]) ** 2, axis=1)
    for j in range(1, k):
        total = float(d2.sum())
        if total <= 0.0:
            # every remaining point coincides with a chosen center (constant
            # or heavily duplicated data): any pick is equally (un)good --
            # rng.choice with an all-zero p would raise instead
            centers[j] = x[rng.integers(n)]
            continue
        centers[j] = x[rng.choice(n, p=d2 / total)]
        d2 = np.minimum(d2, np.sum((x - centers[j]) ** 2, axis=1))
    return centers


@dataclass
class KMeansModel:
    centers: np.ndarray       # [k, D]
    cost: float               # final within-cluster sum of squares
    iterations_run: int

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        d = (
            np.sum(x * x, axis=1, keepdims=True)
            - 2.0 * (x @ self.centers.T)
            + np.sum(self.centers * self.centers, axis=1)[None]
        )
        return d.argmin(axis=1)


def kmeans_fit(
    x: np.ndarray,
    k: int,
    iterations: int = 20,
    tol: float = 1e-4,
    seed: int = 0,
    mesh=None,
    *,
    device=None,
) -> KMeansModel:
    """Fit K-Means with k-means++ init (host) and Lloyd iterations on
    ``device``. Stops early when the relative cost improvement drops
    below ``tol`` (MLlib's epsilon semantics). A spreading ``mesh``
    runs the steps on its ranks' devices, the rows over ``data``."""
    mesh = data_mesh(mesh)
    if k <= 0:
        raise ValueError(f"k must be positive, got {k}")
    x = np.asarray(x, dtype=np.float32)
    if x.ndim != 2 or x.shape[0] < k:
        raise ValueError(f"need a [N>=k, D] matrix, got shape {x.shape}")

    dev = resolve_device(device) if mesh is None else mesh.device
    rng = np.random.default_rng(seed)
    centers = to_device(_kmeanspp_init(x, k, rng), torch.float32, dev)
    if mesh is None:
        xd, step = to_device(x, torch.float32, dev), lloyd_step
    else:
        n, block = x.shape[0], 8 * mesh.axis_size("data")
        padded = -(-n // block) * block
        w = np.zeros(padded, dtype=np.float32)
        w[:n] = 1.0
        xd = put_global(mesh, np.pad(x, ((0, padded - n), (0, 0))))
        wd = put_global(mesh, w)

        def step(xs, c):
            return lloyd_step(xs, c, wd, mesh)

    prev_cost = None
    it = 0
    for it in range(1, iterations + 1):
        centers, _, cost_dev = step(xd, centers)
        # the cost scores the INPUT centers, one update behind the ones
        # returned
        cost = float(cost_dev)
        # the first iteration has no previous cost to compare against
        if prev_cost is not None and prev_cost - cost <= tol * abs(prev_cost):
            break
        prev_cost = cost
    # one assignment-only pass so the reported cost matches the RETURNED
    # centers, not the pre-update ones
    _, _, final_cost = step(xd, centers)
    return KMeansModel(
        centers=centers.cpu().numpy(), cost=float(final_cost), iterations_run=it
    )
