"""Operations and bytes of the kernels and steps the cells drive, computed
from shapes and from the cell's own data, never from the program.

A bound is the least time the card could take: the larger of the bytes
over the memory rate and the operations over the f32-exact rate
(``peaks``). Each input byte is read once and each output byte written
once; where the work depends on the data, only what the data needs is
counted (valid causal pairs), not the padding a layout adds.
"""

from __future__ import annotations

import numpy as np

from pio_bench.peaks import F32_EXACT_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S


def causal_pairs(lengths: np.ndarray, t: int) -> int:
    """(query, key) pairs a causal pass over right-padded rows of valid
    ``lengths`` at padded length ``t`` computes per head: each valid key
    at position ``j`` is seen by the ``t - j`` queries at or after it."""
    lengths = np.minimum(np.asarray(lengths, np.int64), t)
    # sum_{j < l} (t - j) = l t - l (l - 1) / 2
    return int((lengths * t - lengths * (lengths - 1) // 2).sum())


def flash_bound(kernel: str, b: int, h: int, t: int, d: int, pairs: int) -> float:
    """Seconds of one B4 (``"flash_forward"``) or fused B5 + B6
    (``"flash_backward"``) launch on ``[b, t, h, d]`` f32 tensors: inputs
    read once and outputs written once (q, k, v, out, dO, dq, dk, dv, the
    ``[b, t]`` mask bytes, the ``[b, h, t]`` lse); operations on the
    valid causal pairs, 2 d a pair for each product (B4: q.k and P V; the
    backward: q.k, dO.v, P dO, dS q, dS k) on the tensor cores in 3xTF32,
    and the backward's 2 d a row for delta on the CUDA cores."""
    n, rows = b * t * h * d * 4, b * h * t * 4
    nbytes, per_pair, per_row = {
        "flash_forward": (3 * n + b * t + n + rows, 4 * d, 0),
        "flash_backward": (5 * n + b * t + rows + 3 * n, 10 * d, 2 * d),
    }[kernel]
    pair_ops, row_ops = float(per_pair * pairs * h), float(per_row * b * h * t)
    return max(nbytes / HBM_BYTES_PER_S,
               pair_ops / F32_EXACT_OPS_PER_S + row_ops / F32_OPS_PER_S)


def sasrec_step_flops(b: int, t: int, embed: int, ffn: int, blocks: int, vocab: int,
                      pairs: int) -> float:
    """Model operations of one SASRec training step on a ``[b, t]`` batch
    whose causal pairs per head total ``pairs``: the forward's products
    (per token and block the q/k/v and output projections, 8 E^2, and the
    feed-forward, 4 E F; per pair and block q.k and P V, 4 E over the
    heads; per token the tied head, 2 E V) and twice that for the
    backward. The embedding gathers, norms and softmax count nothing."""
    tokens = b * t
    dense = tokens * blocks * (8 * embed * embed + 4 * embed * ffn)
    attention = blocks * 4 * embed * pairs
    head = 2 * tokens * embed * vocab
    return 3.0 * (dense + attention + head)
