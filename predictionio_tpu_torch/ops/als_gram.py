"""Fused gather->Gram/rhs half-step for ALS on the card.

Port of ``predictionio_tpu/ops/als_gram.py``. The ALS half-step tail
(``parallel/als.py``) is gather-bound: the unfused path materializes the
gathered opposite-side factors as a ``[rows, L, K]`` device intermediate
(one write and two read passes) before reducing it to a ``[K, K]`` Gram
and a ``[K]`` rhs per row. On a CUDA tensor ``gram_rhs`` launches the
hand-written kernel ``csrc/als_gram.cu``, which gathers each row's factor
rows into shared memory (``cp.async``, double-buffered) and accumulates
there the Gram and rhs on the tensor cores (3xTF32 ``mma.sync``, up to
rank ``MMA_MAX_RANK``) or, past it, on the f32 units, so the intermediate
never reaches device memory; on a CPU tensor it takes the plain version
``gram_rhs_plain``.

Contract (shared with the unfused path):

- ``indices[r, l]`` selects a row of ``factors``; padding slots point at
  the trailing ZERO row, so every padding contribution dies through the
  gathered zeros (no mask stream).
- ``factors`` is ``[S + 1, K]`` (zero row appended), f32 or bf16; Gram
  and rhs accumulate in f32 regardless.
- explicit mode:  gram[r] = sum_l y y^T,          rhs[r] = sum_l v * y
- implicit mode:  gram[r] = sum_l (alpha v) y y^T, rhs[r] = sum_l (1 + alpha v) y
  (the YtY term, the ridge and the solve stay outside, shared with the
  unfused path).
"""

from __future__ import annotations

import torch

from predictionio_tpu_torch import _kernels
from predictionio_tpu_torch.ops.launches import counted

#: the padded length must be a multiple of this (``pack_padded_csr``'s
#: ``len_multiple``; the reference's chunk picker needs it too)
LEN_MULTIPLE = 8

#: the largest rank ``csrc/als_gram.cu`` takes: past ``MMA_MAX_RANK`` its
#: K (K + 1) Gram and rhs entries, in groups of 5 x 1,024 a block, must fit
#: the grid's 65,535 rows of blocks
MAX_RANK = 18_317

#: the largest rank the kernel's tensor-core instance takes; past it the
#: grouped SIMT instance runs
MMA_MAX_RANK = 512

_FACTOR_DTYPES = (torch.float32, torch.bfloat16)


def gram_instance(k: int) -> str:
    """Which instance of ``csrc/als_gram.cu`` runs rank ``k``: ``"mma"``
    (tensor cores, 1 <= k <= ``MMA_MAX_RANK``) or ``"simt"`` (up to
    ``MAX_RANK``); the kernel's ``als_gram_instance`` agrees. Raises for a
    rank no instance takes."""
    if not 1 <= k <= MAX_RANK:
        raise ValueError(f"rank {k} is outside the kernel's ranks 1..{MAX_RANK}")
    return "mma" if k <= MMA_MAX_RANK else "simt"


def _check(indices: torch.Tensor, values: torch.Tensor, factors: torch.Tensor):
    """Shapes, dtypes and devices both versions need; returns ``(r, l, k)``."""
    if indices.dim() != 2 or values.shape != indices.shape:
        raise ValueError(
            f"indices and values must both be [R, L], got "
            f"{tuple(indices.shape)} and {tuple(values.shape)}"
        )
    if factors.dim() != 2 or factors.shape[0] < 1:
        raise ValueError(f"factors must be [S + 1, K], got {tuple(factors.shape)}")
    if indices.dtype != torch.int32 or values.dtype != torch.float32:
        raise TypeError(
            f"expected int32 indices and float32 values, got {indices.dtype}"
            f" and {values.dtype}"
        )
    if factors.dtype not in _FACTOR_DTYPES:
        raise TypeError(f"factors must be float32 or bfloat16, got {factors.dtype}")
    if not (indices.device == values.device == factors.device):
        raise ValueError(
            f"tensors on different devices: {indices.device}, "
            f"{values.device}, {factors.device}"
        )
    r, pad_len = indices.shape
    if pad_len % LEN_MULTIPLE:
        raise ValueError(
            f"padded length {pad_len} is not a multiple of {LEN_MULTIPLE} "
            "(pack_padded_csr guarantees len_multiple=8)"
        )
    return r, pad_len, factors.shape[1]


def gram_rhs_plain(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: torch.Tensor,
    alpha: float = 0.0,
    *,
    implicit: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version, on any device: gather ``factors[indices]``
    into a ``[R, L, K]`` f32 tensor, then the Gram and rhs products in f32
    (the reference's ``_gram_solve_explicit``/``_gram_solve_implicit``
    products, ``parallel/als.py:403-433``). This is also the unfused
    ``alsSolver: "xla"`` path."""
    _check(indices, values, factors)
    g = factors[indices.long()].to(torch.float32)          # [R, L, K]
    return gathered_products(g, values, alpha, implicit=implicit)


def gathered_products(
    g: torch.Tensor,
    values: torch.Tensor,
    alpha: float = 0.0,
    *,
    implicit: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Gram and rhs of already gathered f32 rows ``g [R, L, K]``
    (``gram_rhs_plain`` after its gather; the model-sharded "xla"
    half-step gathers its local hits and reduce-scatters them first)."""
    if implicit:
        w = values * alpha
        gram = torch.bmm((g * w.unsqueeze(-1)).transpose(1, 2), g)
        rhs = torch.bmm(g.transpose(1, 2), (1.0 + w).unsqueeze(-1)).squeeze(-1)
    else:
        gram = torch.bmm(g.transpose(1, 2), g)
        rhs = torch.bmm(g.transpose(1, 2), values.unsqueeze(-1)).squeeze(-1)
    return gram, rhs


@counted
def gram_rhs(
    indices: torch.Tensor,
    values: torch.Tensor,
    factors: torch.Tensor,
    alpha: float = 0.0,
    *,
    implicit: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused gather->Gram/rhs over one padded-CSR block.

    ``indices`` int32 [R, L] (padding -> the trailing zero factor row;
    every entry must lie in ``[0, S]``, which the kernel does not check),
    ``values`` f32 [R, L], ``factors`` [S + 1, K] f32/bf16. Returns
    ``(gram [R, K, K] f32, rhs [R, K] f32)``; the caller adds the ridge
    or YtY and solves (``ops.linalg.batched_spd_solve``).

    CUDA tensors launch ``csrc/als_gram.cu`` (and count the launch in
    ``gram_rhs.launches``) or raise; CPU tensors take ``gram_rhs_plain``.
    The kernel takes any rank up to ``MAX_RANK`` (18,317), on the
    instance ``gram_instance(k)`` names; the tensor-core one returns
    ``gram`` exactly symmetric."""
    r, pad_len, k = _check(indices, values, factors)
    if indices.device.type == "cpu":
        return gram_rhs_plain(indices, values, factors, alpha, implicit=implicit)
    if indices.device.type != "cuda":
        raise ValueError(f"no gram_rhs kernel for device {indices.device}")
    if not (indices.is_contiguous() and values.is_contiguous() and factors.is_contiguous()):
        raise ValueError("gram_rhs needs contiguous tensors")
    gram_instance(k)
    lib = _kernels.library("als_gram")
    gram = torch.empty((r, k, k), dtype=torch.float32, device=indices.device)
    rhs = torch.empty((r, k), dtype=torch.float32, device=indices.device)
    if r == 0:
        return gram, rhs
    with torch.cuda.device(indices.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.als_gram_rhs_launch(
            indices.data_ptr(), values.data_ptr(), factors.data_ptr(),
            gram.data_ptr(), rhs.data_ptr(),
            r, pad_len, k, factors.shape[0], float(alpha), int(bool(implicit)),
            int(factors.dtype == torch.bfloat16), stream,
        )
    _kernels.check(status, "als_gram_rhs launch")
    gram_rhs.launches += 1
    return gram, rhs


def half_step_bytes(
    rows: int, pad_len: int, rank: int, itemsize: int, fused: bool
) -> float:
    """Device-memory bytes one half-step tail moves over a [rows, pad_len]
    block (copy of the reference's bytes model, ``ops/als_gram.py:212``).

    Shared streams: indices (i32) + values (f32) read once; Gram + rhs
    (f32) written once. The gather is one random-read pass of
    rows*L*K*itemsize. Fused: that pass is the only [rows, L, K]-sized
    one. Unfused: the gathered intermediate is also written once and read
    back by the Gram and rhs products -> 4 gather-sized passes.
    """
    streams = rows * pad_len * (4 + 4)            # indices + values
    outs = rows * (rank * rank + rank) * 4        # gram + rhs, f32
    gather_pass = rows * pad_len * rank * itemsize
    passes = 1 if fused else 4
    return float(streams + outs + passes * gather_pass)
