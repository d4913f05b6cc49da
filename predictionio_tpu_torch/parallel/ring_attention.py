"""Single-device reference attention.

Port of ``plain_attention`` (``predictionio_tpu/parallel/ring_attention.py:33``)
on tensors: the full ``[B, H, T, T]`` score matrix, masked scores set to
the finite -1e30, a softmax over the keys. A query row whose every key is
masked returns the uniform average of the values (the flash kernels
return 0 there). Ring attention and Ulysses, the reference's
sequence-parallel strategies over a mesh axis, wait for multi-GPU.
"""

from __future__ import annotations

import torch

_NEG = -1e30  # finite "masked" score: keeps exp() NaN-free on all-masked rows


def plain_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    mask: torch.Tensor | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Reference attention. Shapes: q,k,v [B, T, H, D] -> [B, T, H, D].

    ``mask``: optional [B, Tk] key validity (padding) mask.
    """
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        cm = torch.arange(tq, device=q.device)[:, None] >= torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(~cm[None, None], _NEG)
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
