"""Plain reference of the ``sasrec-ml20m`` configuration: SASRec (Kang and
McAuley, ICDM 2018, arXiv:1808.09781) at the paper's MovieLens widths,
trained by Adam on next-item cross-entropy over the whole vocabulary (the
sequence template's loss; the paper samples negatives), without dropout,
in plain PyTorch.

- ``sequences``: each user's items in time order (ties by input order),
  users with fewer than ``min_len`` events dropped, the last ``max_len``
  items kept, ids shifted by one (0 pads) and right-padded.
- ``initial_params``: the run's seeded init, drawn from a CPU
  ``torch.Generator`` in this order: the item table and the position
  table N(0, 1/E); then per block the q/k/v projection, the output
  projection and the two feed-forward layers, each a normal truncated at
  two standard deviations with standard deviation 1/sqrt(fan_in) (flax's
  ``lecun_normal``); biases 0, LayerNorm scales 1.
- ``loss``: embeddings scaled by sqrt(E) plus positions; per block a
  pre-norm causal self-attention over valid keys and a pre-norm ReLU
  feed-forward, each residual; a final LayerNorm (eps 1e-6) zeroed at
  padding; the tied head over the whole vocabulary, padding id included;
  the cross-entropy summed over positions with a target and divided by
  their count. Position t predicts the item at t + 1.
- ``train``: Adam (b1 0.9, b2 0.999, eps 1e-8) written out.

``precision`` ``"f64"`` is the judge. ``"tf32"`` is the control: float32
with every product's operands rounded to TF32 (10 mantissa bits, to
nearest), forward and backward, as the card computes a float32 product
with TF32 on.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

TRUNC_STD = 0.87962566103423978   # std of a standard normal truncated to [-2, 2]
NEG = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` on TF32-rounded operands, its two gradient products on
    TF32-rounded operands too; ``b`` 2-D or with ``a``'s batch dims."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = tf32(g) @ tf32(b).transpose(-1, -2)
        if b.dim() == 2:
            gb = tf32(a.reshape(-1, a.shape[-1])).T @ tf32(g.reshape(-1, g.shape[-1]))
        else:
            gb = tf32(a).transpose(-1, -2) @ tf32(g)
        return ga, gb


def _matmul(precision: str):
    if precision == "f64":
        return torch.matmul
    if precision == "tf32":
        return _TF32MatMul.apply
    raise ValueError(f"precision {precision!r}: want 'f64' or 'tf32'")


def sequences(users, items, times, max_len: int, min_len: int, device) -> torch.Tensor:
    users = torch.as_tensor(users, device=device)
    by_time = torch.sort(torch.as_tensor(times, device=device), stable=True).indices
    order = by_time[torch.sort(users[by_time], stable=True).indices]
    u = users[order]
    ids, counts = torch.unique_consecutive(u, return_counts=True)
    keep = counts >= min_len
    row_of_user = torch.full((int(u.max()) + 1,), -1, dtype=torch.int64, device=device)
    row_of_user[ids[keep]] = torch.arange(int(keep.sum()), device=device)
    count_of = torch.zeros_like(row_of_user)
    count_of[ids] = counts
    starts = torch.cumsum(counts, 0) - counts
    start_of = torch.zeros_like(row_of_user)
    start_of[ids] = starts
    position = torch.arange(u.numel(), device=device) - start_of[u]
    first = torch.clamp(count_of[u] - max_len, min=0)
    take = (row_of_user[u] >= 0) & (position >= first)
    matrix = torch.zeros((int(keep.sum()), max_len), dtype=torch.int64, device=device)
    it = torch.as_tensor(items, device=device)[order]
    matrix[row_of_user[u][take], (position - first)[take]] = it[take] + 1
    return matrix


def initial_params(vocab: int, max_len: int, embed: int, blocks: int, ffn: int,
                   seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.empty(shape).normal_(0.0, 1.0 / math.sqrt(embed), generator=g)

    def lecun(out_features: int, in_features: int):
        std = 1.0 / math.sqrt(in_features) / TRUNC_STD
        w = torch.empty((out_features, in_features))
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
        return w

    p = {"item_embed.weight": normal(vocab, embed), "pos_embed.weight": normal(max_len, embed)}
    for i in range(blocks):
        qkv, proj = lecun(3 * embed, embed), lecun(embed, embed)
        ffn_in, ffn_out = lecun(ffn, embed), lecun(embed, ffn)
        p.update({
            f"ln_att_{i}.weight": torch.ones(embed), f"ln_att_{i}.bias": torch.zeros(embed),
            f"att_{i}.qkv.weight": qkv, f"att_{i}.proj.weight": proj,
            f"ln_ffn_{i}.weight": torch.ones(embed), f"ln_ffn_{i}.bias": torch.zeros(embed),
            f"ffn_in_{i}.weight": ffn_in, f"ffn_in_{i}.bias": torch.zeros(ffn),
            f"ffn_out_{i}.weight": ffn_out, f"ffn_out_{i}.bias": torch.zeros(embed),
        })
    p["ln_out.weight"], p["ln_out.bias"] = torch.ones(embed), torch.zeros(embed)
    return p


def loss(p: dict, seq: torch.Tensor, heads: int, blocks: int, precision: str) -> torch.Tensor:
    mm = _matmul(precision)
    b, t = seq.shape
    table = p["item_embed.weight"]
    e = table.shape[1]
    d = e // heads
    target = torch.zeros_like(seq)
    target[:, :-1] = seq[:, 1:]
    valid_key = seq > 0
    x = table[seq] * math.sqrt(e) + p["pos_embed.weight"][:t][None]
    causal = torch.ones((t, t), dtype=torch.bool, device=seq.device).tril()
    allowed = causal[None, None] & valid_key[:, None, None, :]
    for i in range(blocks):
        a = F.layer_norm(x, (e,), p[f"ln_att_{i}.weight"], p[f"ln_att_{i}.bias"], 1e-6)
        q, k, v = mm(a, p[f"att_{i}.qkv.weight"].T).reshape(b, t, 3, heads, d).unbind(2)
        q, k, v = (z.transpose(1, 2) for z in (q, k, v))          # [B, H, T, D]
        s = mm(q, k.transpose(-1, -2)) * d ** -0.5
        attn = torch.softmax(s.masked_fill(~allowed, NEG), dim=-1)
        o = mm(attn, v).transpose(1, 2).reshape(b, t, e)
        x = x + mm(o, p[f"att_{i}.proj.weight"].T)
        f = F.layer_norm(x, (e,), p[f"ln_ffn_{i}.weight"], p[f"ln_ffn_{i}.bias"], 1e-6)
        f = torch.relu(mm(f, p[f"ffn_in_{i}.weight"].T) + p[f"ffn_in_{i}.bias"])
        x = x + mm(f, p[f"ffn_out_{i}.weight"].T) + p[f"ffn_out_{i}.bias"]
    h = F.layer_norm(x, (e,), p["ln_out.weight"], p["ln_out.bias"], 1e-6) * valid_key[..., None]
    logits = mm(h, table.T)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), target.reshape(-1),
                         ignore_index=0, reduction="sum")
    return ce / (target > 0).sum().clamp_min(1)


def train(params: dict, batches, heads: int, blocks: int, lr: float, precision: str,
          device, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam over ``batches`` (``[B, T]`` id tensors) from ``params``;
    returns ``(losses, first gradient, params after the last step)``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = torch.float64 if precision == "f64" else torch.float32
    p = {n: w.detach().to(device=device, dtype=dtype, copy=True).requires_grad_(True)
         for n, w in params.items()}
    m = {n: torch.zeros_like(w) for n, w in p.items()}
    v = {n: torch.zeros_like(w) for n, w in p.items()}
    losses, first = [], None
    for step, seq in enumerate(batches, start=1):
        value = loss(p, seq.to(device), heads, blocks, precision)
        grads = torch.autograd.grad(value, list(p.values()))
        losses.append(value.item())
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(p, grads)}
        with torch.no_grad():
            for (n, w), g in zip(p.items(), grads):
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[n] / (1 - b1 ** step)
                v_hat = v[n] / (1 - b2 ** step)
                w.sub_(lr * m_hat / (v_hat.sqrt() + eps))
    return losses, first, {n: w.detach() for n, w in p.items()}


def first_batches(num_rows: int, batch: int, steps: int, seed: int) -> list[np.ndarray]:
    """The rows of the first ``steps`` batches: the first epoch's
    permutation of ``numpy``'s generator of the run's seed."""
    order = np.random.default_rng(seed).permutation(num_rows)
    return [order[i * batch:(i + 1) * batch] for i in range(steps)]
