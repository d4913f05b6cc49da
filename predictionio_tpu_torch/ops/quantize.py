"""Symmetric per-block int8 quantization for device-resident factor tables.

The port's own copy of ``predictionio_tpu/ops/quantize.py`` (numpy only,
unchanged in arithmetic): the packed bytes must be identical to the
reference's, which ``tests/test_torch_mips.py`` checks. The SMEM/VMEM
notes below describe the TPU layout; on the card the int8 tile and its
scale sit in one block's shared memory (``csrc/mips_topk.cu``).

The serving-scale bottleneck is HBM bytes per scanned item
(``ops/mips.py``): a rank-16 f32 item-factor table costs 64 B/item, so a
10M-item catalog reads 640 MB per full scan. Packing rows int8 with one
f32 scale per contiguous block of rows cuts that 4x (8x from bf16), which
is the ALX recipe (arxiv 2112.02194) applied to the SERVING table the way
``factorDtype: bfloat16`` applied it to training gathers.

Quantization is symmetric (zero-point = 0): factor tables are zero-mean
by construction (ridge-regularized ALS solves), so an asymmetric
zero-point would spend a stream on correcting a bias that is ~0, and
symmetry keeps the kernel's dequantize a single multiply. The scale is
per BLOCK of rows, not per row: the MIPS kernel reads one scalar per
[block_items, K] tile (SMEM), and the error bound stays local to the
block instead of following the global absmax.

Error contract (property-tested in ``tests/test_mips.py``):

- element round-trip: ``|x - scale * q| <= scale / 2`` within each block
  (127 clips only the exact absmax element, which rounds to itself);
- dot-product: for a query ``y``, ``|y . x - y . deq(x)| <=
  (scale / 2) * ||y||_1`` per item row -- the bound ``score_error_bound``
  reports and the shortlist oversampling margin is sized against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: rows per quantization block (and per MIPS kernel tile). 512 int8 rows
#: at rank 16 is an 8 KB tile -- far under VMEM, big enough that the
#: per-block f32 scale is amortized to 0.06 bits/element of overhead.
BLOCK_ITEMS = 512


@dataclass(frozen=True)
class PackedFactors:
    """A factor table packed for the MIPS scan.

    ``q`` is ``[padded_items, K]`` int8 with ``padded_items`` a
    ``block_items`` multiple (padding rows are zero -- they dequantize to
    zero scores and the search tail drops their indices);
    ``scales`` is ``[num_blocks, 1]`` f32 (2D: SMEM scalars ride (1, 1)
    blocks). Rows ``i`` of the original table live at ``q[i]`` unchanged
    -- candidate indices out of the kernel are already catalog indices.
    """

    q: np.ndarray
    scales: np.ndarray
    num_items: int
    block_items: int

    @property
    def num_blocks(self) -> int:
        return self.q.shape[0] // self.block_items

    @property
    def packed_bytes(self) -> int:
        return self.q.nbytes + self.scales.nbytes


def pack_int8_blockwise(
    factors: np.ndarray, block_items: int = BLOCK_ITEMS
) -> PackedFactors:
    """Quantize ``[num_items, K]`` f32/f64 factors to symmetric per-block
    int8. Blocks are contiguous row ranges; the last block zero-pads."""
    factors = np.asarray(factors, np.float32)
    if factors.ndim != 2:
        raise ValueError(f"factors must be [items, K], got {factors.shape}")
    if block_items < 8 or block_items % 8:
        raise ValueError(
            f"block_items must be a positive multiple of 8, got {block_items}"
        )
    num_items, k = factors.shape
    padded = -(-max(num_items, 1) // block_items) * block_items
    x = np.zeros((padded, k), np.float32)
    x[:num_items] = factors
    blocks = x.reshape(-1, block_items, k)
    absmax = np.abs(blocks).max(axis=(1, 2))
    # all-zero blocks (padding tails, unseen cold rows) keep scale 1.0:
    # 0 / 1.0 quantizes to 0 and dequantizes to 0 exactly
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(
        np.rint(blocks / scales[:, None, None]), -127, 127
    ).astype(np.int8)
    return PackedFactors(
        q=q.reshape(padded, k),
        scales=scales.reshape(-1, 1),
        num_items=num_items,
        block_items=block_items,
    )


def unpack_blockwise(packed: PackedFactors) -> np.ndarray:
    """Dequantize back to ``[num_items, K]`` f32 (padding rows dropped)."""
    blocks = packed.q.reshape(-1, packed.block_items, packed.q.shape[1])
    x = blocks.astype(np.float32) * packed.scales[:, :, None]
    return x.reshape(-1, packed.q.shape[1])[: packed.num_items]


def quantization_error_bound(packed: PackedFactors) -> np.ndarray:
    """Per-block max-abs element error, ``scales / 2`` -- the round-trip
    contract ``tests/test_mips.py`` pins."""
    return packed.scales[:, 0] / 2.0


def score_error_bound(packed: PackedFactors, query: np.ndarray) -> np.ndarray:
    """Per-block bound on ``|exact - quantized|`` dot-product scores for
    one query row: ``(scale / 2) * ||query||_1``. The shortlist margin
    (``RetrievalConfig.shortlist`` over ``num``) buys recall against
    exactly this reordering window."""
    l1 = float(np.abs(np.asarray(query, np.float32)).sum())
    return quantization_error_bound(packed) * l1
