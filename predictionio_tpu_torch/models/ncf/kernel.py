"""Fused all-items NeuMF scoring for one user, and the batch scorer.

Port of ``predictionio_tpu/models/ncf/kernel.py``. The serving hot path
scores EVERY item for a user, then takes the top-k on the host:

    score[i] = w_out . [gmf_u * gmf_item[i] ; mlp(mlp_u ++ mlp_item[i])] + b_out

- ``ncf_score_plain``: the plain torch head for any tower depth (the
  counterpart of ``reference_score_all_items``), on any device.
- ``ncf_score_all_items``: the counting wrapper of kernel B3
  (``csrc/ncf_score.cu``, the depth-2 head fused in one launch). A CUDA
  tensor launches it or raises; a CPU tensor takes ``ncf_score_plain``.
- ``make_all_items_scorer`` (``all_items_scorer`` over tensors already
  on the device): the tables go to the device once, the user row is a
  view of the device table, each call is one launch and one copy back.
  Depth-2 towers go through B3; other depths through the plain head, as
  the reference routes them (its kernel is depth-2 only).
- ``make_batch_scorer`` (``batch_scorer`` over tensors already on the
  device): plain torch for any depth, in chunks of about
  ``pair_budget`` user-item pairs padded to power-of-two buckets (the
  reference computes it outside any Pallas kernel too).

Weights keep the flax layout at these functions: a dense kernel is
``[in, out]``, the output kernel ``[E + H, 1]``. ``head_tensors`` cuts
them out of a ``NeuMF`` state dict. The reference pads the item tables
to its 1024-item tiles; B3 bounds-checks and writes exactly ``I``
scores.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from predictionio_tpu_torch.models.ncf.model import mlp_depth
from predictionio_tpu_torch.ops.launches import counted
from predictionio_tpu_torch.utils.device import resolve_device


def _head(gmf_u, mlp_u, gmf_items, mlp_items, kernels, biases, out_kernel, out_bias):
    """Scores of users ``[U, E]`` against items ``[I, E]`` -> ``[U, I]``,
    the reference's arithmetic: the first dense layer over the
    concatenation, relu after every hidden layer, the output layer over
    ``[gmf ; h]``."""
    u, e = gmf_u.shape
    n = gmf_items.shape[0]
    gmf = gmf_u[:, None, :] * gmf_items[None, :, :]
    h = torch.cat(
        [mlp_u[:, None, :].expand(u, n, e), mlp_items[None, :, :].expand(u, n, e)],
        dim=-1,
    )
    for kernel, bias in zip(kernels, biases):
        h = torch.relu(h @ kernel + bias)
    return (torch.cat([gmf, h], dim=-1) @ out_kernel + out_bias)[..., 0]


def _check(gmf_items, mlp_items, gmf_u, mlp_u, kernels, biases, out_kernel, out_bias):
    """Shapes, dtypes and devices every version needs; returns ``(I, E)``."""
    tensors = [gmf_items, mlp_items, gmf_u, mlp_u, *kernels, *biases, out_kernel, out_bias]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the NCF head takes float32 tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on different devices: {sorted({str(t.device) for t in tensors})}")
    if gmf_items.dim() != 2 or mlp_items.shape != gmf_items.shape:
        raise ValueError(
            f"item tables must both be [I, E], got {tuple(gmf_items.shape)} "
            f"and {tuple(mlp_items.shape)}"
        )
    n, e = gmf_items.shape
    if gmf_u.shape != (e,) or mlp_u.shape != (e,):
        raise ValueError(f"user rows must be [{e}], got {tuple(gmf_u.shape)}, {tuple(mlp_u.shape)}")
    if len(kernels) != len(biases) or not kernels:
        raise ValueError("one bias per dense kernel, at least one layer")
    width = 2 * e
    for layer, (k, b) in enumerate(zip(kernels, biases)):
        if k.dim() != 2 or k.shape[0] != width or b.shape != (k.shape[1],):
            raise ValueError(
                f"mlp_{layer}: kernel {tuple(k.shape)} / bias {tuple(b.shape)} "
                f"do not take a width-{width} input"
            )
        width = k.shape[1]
    if out_kernel.shape != (e + width, 1) or out_bias.shape != (1,):
        raise ValueError(
            f"out: kernel {tuple(out_kernel.shape)} / bias {tuple(out_bias.shape)}, "
            f"expected ({e + width}, 1) / (1,)"
        )
    return n, e


def ncf_score_plain(
    gmf_items: torch.Tensor,
    mlp_items: torch.Tensor,
    gmf_u: torch.Tensor,
    mlp_u: torch.Tensor,
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    out_kernel: torch.Tensor,
    out_bias: torch.Tensor,
) -> torch.Tensor:
    """One user's scores over every item, plain torch, any depth:
    item tables ``[I, E]``, user rows ``[E]``, dense ``kernels[l]``
    ``[in, out]`` with ``biases[l]`` ``[out]``, ``out_kernel``
    ``[E + H, 1]``, ``out_bias`` ``[1]``; returns ``[I]`` f32."""
    _check(gmf_items, mlp_items, gmf_u, mlp_u, kernels, biases, out_kernel, out_bias)
    return _head(gmf_u[None], mlp_u[None], gmf_items, mlp_items,
                 kernels, biases, out_kernel, out_bias)[0]


@counted
def ncf_score_all_items(
    gmf_items: torch.Tensor,
    mlp_items: torch.Tensor,
    gmf_u: torch.Tensor,
    mlp_u: torch.Tensor,
    kernels: Sequence[torch.Tensor],
    biases: Sequence[torch.Tensor],
    out_kernel: torch.Tensor,
    out_bias: torch.Tensor,
) -> torch.Tensor:
    """The fused NeuMF head of ``ncf_score_plain``'s arguments.

    CUDA tensors launch ``csrc/ncf_score.cu`` (and count the launch in
    ``ncf_score_all_items.launches``) or raise: the kernel takes the
    depth-2 tower and contiguous tensors at any width (both dense layers
    on the tensor cores in 3xTF32; the weights held in shared memory
    while they fit, else staged there a chunk at a time). CPU tensors
    take ``ncf_score_plain``."""
    n, e = _check(gmf_items, mlp_items, gmf_u, mlp_u, kernels, biases, out_kernel, out_bias)
    if gmf_items.device.type == "cpu":
        return ncf_score_plain(gmf_items, mlp_items, gmf_u, mlp_u,
                               kernels, biases, out_kernel, out_bias)
    if gmf_items.device.type != "cuda":
        raise ValueError(f"no NCF scorer kernel for device {gmf_items.device}")
    if len(kernels) != 2:
        raise ValueError(
            f"kernel B3 takes the depth-2 tower, got depth {len(kernels)} "
            "(other depths score with ncf_score_plain)"
        )
    w0, w1 = kernels
    b0, b1 = biases
    h0, h1 = w0.shape[1], w1.shape[1]
    operands = [gmf_items, mlp_items, gmf_u, mlp_u, w0, b0, w1, b1, out_kernel, out_bias]
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("ncf_score_all_items needs contiguous tensors")
    from predictionio_tpu_torch import _kernels

    lib = _kernels.library("ncf_score")
    out = torch.empty(n, dtype=torch.float32, device=gmf_items.device)
    if n == 0:
        return out
    out_w = out_kernel.reshape(-1)
    with torch.cuda.device(gmf_items.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ncf_score_launch(
            gmf_items.data_ptr(), mlp_items.data_ptr(), gmf_u.data_ptr(), mlp_u.data_ptr(),
            w0[:e].data_ptr(), w0[e:].data_ptr(), b0.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), out_w[:e].data_ptr(), out_w[e:].data_ptr(),
            out_bias.data_ptr(), out.data_ptr(), n, e, h0, h1, stream,
        )
    _kernels.check(status, "ncf_score launch")
    ncf_score_all_items.launches += 1
    return out


def head_tensors(state: Mapping[str, torch.Tensor], num_items: int, device):
    """``(gmf_users, mlp_users, head)`` on ``device``: the two user tables
    and the item-side arguments of ``ncf_score_plain`` after the user
    rows, ``(gmf_items, mlp_items, kernels, biases, out_kernel,
    out_bias)``, in the flax layout, each made contiguous once."""
    def put(t):
        return torch.as_tensor(t, dtype=torch.float32).to(device).contiguous()

    depth = mlp_depth(state)
    head = (
        put(state["gmf_item.weight"][:num_items]),
        put(state["mlp_item.weight"][:num_items]),
        [put(state[f"mlp_{i}.weight"].T) for i in range(depth)],
        [put(state[f"mlp_{i}.bias"]) for i in range(depth)],
        put(state["out.weight"].T),
        put(state["out.bias"]),
    )
    return put(state["gmf_user.weight"]), put(state["mlp_user.weight"]), head


def make_all_items_scorer(state: Mapping[str, torch.Tensor], num_items: int, device=None):
    """A host-callable ``score(user_index) -> np.ndarray[num_items]``:
    ``all_items_scorer`` over the tables and weights put on ``device``
    (``cuda`` unless ``"cpu"`` is named) once, here."""
    return all_items_scorer(head_tensors(state, num_items, resolve_device(device)))


def all_items_scorer(tensors):
    """``score(user_index) -> np.ndarray[I]`` over ``head_tensors``'s
    result: each call indexes the user rows on their device, makes one
    launch of B3 (depth 2; the plain head at other depths, as the
    reference does) and copies the scores back."""
    gmf_users, mlp_users, (gi, mi, kernels, biases, out_k, out_b) = tensors
    score_fn = ncf_score_all_items if len(kernels) == 2 else ncf_score_plain

    def score(user_index) -> np.ndarray:
        u = int(user_index)
        with torch.no_grad():
            return score_fn(gi, mi, gmf_users[u], mlp_users[u],
                            kernels, biases, out_k, out_b).cpu().numpy()

    return score


def make_batch_scorer(state: Mapping[str, torch.Tensor], num_items: int, device=None,
                      pair_budget: int = 2_000_000):
    """Host-callable ``scores(user_indices [U]) -> np [U, num_items]``:
    ``batch_scorer`` over the tables and weights put on ``device``
    (``cuda`` unless ``"cpu"`` is named) once, here."""
    return batch_scorer(head_tensors(state, num_items, resolve_device(device)), pair_budget)


def batch_scorer(tensors, pair_budget: int = 2_000_000):
    """``scores(user_indices [U]) -> np [U, I]`` over ``head_tensors``'s
    result: the ``pio batchpredict`` engine of NCF, plain torch for any
    depth. Chunks hold at most ``pair_budget // I`` users (the
    ``[u, I, feature]`` intermediates stay bounded) and a ragged chunk
    pads to the next power of two with user 0, as the reference's
    compiled-shape buckets do."""
    gmf_users, mlp_users, (gi, mi, kernels, biases, out_k, out_b) = tensors
    num_items = gi.shape[0]
    chunk = max(1, pair_budget // max(num_items, 1))

    def bucket(n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        return min(b, chunk)

    def scores(user_indices) -> np.ndarray:
        user_indices = np.asarray(user_indices, np.int64)
        out = np.empty((user_indices.size, num_items), np.float32)
        for start in range(0, user_indices.size, chunk):
            part = user_indices[start : start + chunk]
            n = part.size
            pad = bucket(n)
            if n < pad:
                part = np.pad(part, (0, pad - n))
            idx = torch.from_numpy(part).to(gi.device)
            with torch.no_grad():
                got = _head(gmf_users[idx], mlp_users[idx], gi, mi,
                            kernels, biases, out_k, out_b)
            out[start : start + n] = got[:n].cpu().numpy()
        return out

    return scores
