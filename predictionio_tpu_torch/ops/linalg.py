"""Batched SPD solve for the ALS normal equations.

Port of ``predictionio_tpu/ops/linalg.py::batched_spd_solve`` (reference
``ops/linalg.py:15``). It was never a Pallas kernel there: on the CPU it
is ``lax.linalg.cholesky`` + ``cho_solve``, here ``torch.linalg.
cholesky_ex`` + ``torch.cholesky_solve``, with the same jitter. The
reference's unrolled variant (``_unrolled_chol_solve``, ``:51``) exists
to lay a [R, K, K] batch along the TPU's vector lanes; it is a TPU
layout device and is not ported.
"""

from __future__ import annotations

import torch


def batched_spd_solve(
    gram: torch.Tensor, rhs: torch.Tensor, jitter: float = 1e-6
) -> torch.Tensor:
    """Solve ``gram[b] @ x[b] = rhs[b]`` for a batch of SPD systems.

    ``gram`` [..., K, K], ``rhs`` [..., K], both f32. A small jitter
    guards rows whose Gram is singular (entities with no interactions);
    their solution is ~0 because their rhs is 0. A row whose Gram is not
    positive definite even then comes back NaN, as the reference's
    ``cholesky`` gives it; the check stays on the device (no sync)."""
    k = gram.shape[-1]
    eye = torch.eye(k, dtype=gram.dtype, device=gram.device)
    chol, info = torch.linalg.cholesky_ex(gram + jitter * eye)
    x = torch.cholesky_solve(rhs.unsqueeze(-1), chol).squeeze(-1)
    return torch.where((info == 0).unsqueeze(-1), x, torch.nan)
