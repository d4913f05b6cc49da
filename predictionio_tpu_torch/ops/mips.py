"""Fused quantized MIPS top-k: two-stage sub-linear retrieval on the card.

Port of ``predictionio_tpu/ops/mips.py``. The contract is the reference's:

- **Stage 1** (``mips_block_topk``): scan the int8 block-quantized item
  table (``ops/quantize``) tile by tile, fusing the dequantize, the query
  dot product and a per-tile top-R selection. On a CUDA tensor this is
  the hand-written kernel ``csrc/mips_topk.cu``; on a CPU tensor its
  plain torch twin ``mips_block_topk_plain``. The ``[B, items]`` score
  matrix never reaches device memory in the kernel: what leaves it is
  ``[B, num_blocks, R]`` candidates.
- **Stage 2** (``RetrievalIndex.search``): merge the per-block candidates
  by a stable descending sort (``lax.top_k``'s lower-index-first tie
  order; ``torch.topk`` promises no order on CUDA), sort the shortlist by
  catalog index, and re-score exactly in f32 against the resident table.

Containment contract: a tile's top-R is selected on the QUANTIZED scores
with padding rows masked below any real score, so the quantized global
top-``min(R, shortlist)`` is always inside the candidate set; recall vs
the exact scan is bounded only by quantization reorderings inside the
``score_error_bound`` window, which the shortlist margin oversamples.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from predictionio_tpu_torch.ops.quantize import BLOCK_ITEMS, pack_int8_blockwise
from predictionio_tpu_torch.utils.device import resolve_device

#: query rows per kernel block (the reference's f32 sublane multiple; here
#: the n = 8 of a tensor-core product, or one warp per query row in the
#: SIMT instance's 8-warp block)
BLOCK_QUERIES = 8

#: padding rows mask to _NEG before selection; already-selected columns
#: mask STRICTLY BELOW it (_SEL), so once real scores are exhausted the
#: selection drains distinct padding columns (-> merge sentinels) instead
#: of re-emitting a selected column as a duplicate candidate
_NEG = -1e30
_SEL = -2e30

#: grid.y of the kernel's SIMT passes instance is B / BLOCK_QUERIES and
#: CUDA caps it at 65535
_MAX_BATCH = 65535 * BLOCK_QUERIES

#: the largest per-tile top-R and rank the kernel's tensor-core instance
#: takes; past either the SIMT passes instance runs
MMA_MAX_TOPK = 64
MMA_MAX_RANK = 2048


def mips_instance(k: int, bi: int, r: int) -> str:
    """Which instance of ``csrc/mips_topk.cu`` runs rank ``k``, tiles of
    ``bi`` items and ``r`` candidates a tile: ``"mma"`` (bf16 tensor
    cores with exact operands, a threshold selection; ``r <=
    MMA_MAX_TOPK`` and ``k <= MMA_MAX_RANK``, any tile) or ``"passes"``
    (the SIMT form). The kernel's ``mips_block_topk_instance`` agrees.
    Raises for arguments no launch takes."""
    if k < 1 or bi < 1 or not 0 < r <= bi:
        raise ValueError(f"no stage-1 instance for rank {k}, tile {bi}, block_topk {r}")
    return "mma" if r <= MMA_MAX_TOPK and k <= MMA_MAX_RANK else "passes"


def _check_stage1(queries, q_table, scales, block_topk: int, num_items: int):
    """The reference's argument checks (ops/mips.py:116-127) plus the
    dtype/device/contiguity checks a raw kernel needs; returns
    ``(b, k, nb, bi)``."""
    if queries.dim() != 2 or q_table.dim() != 2 or q_table.shape[1] != queries.shape[1]:
        raise ValueError(
            f"queries [B, K] and q_table [padded, K] disagree: "
            f"{tuple(queries.shape)} vs {tuple(q_table.shape)}"
        )
    b, k = queries.shape
    padded_items = q_table.shape[0]
    nb = scales.shape[0]
    if scales.numel() != nb or nb == 0 or padded_items % nb:
        raise ValueError(
            f"scales must be [num_blocks, 1] dividing {padded_items} rows, "
            f"got {tuple(scales.shape)}"
        )
    bi = padded_items // nb
    if b % BLOCK_QUERIES:
        raise ValueError(
            f"batch {b} must be a multiple of {BLOCK_QUERIES} "
            "(RetrievalIndex.search pads)"
        )
    if not 0 < block_topk <= bi:
        raise ValueError(f"block_topk {block_topk} must be in [1, {bi}]")
    if not 0 < num_items <= padded_items:
        raise ValueError(f"num_items {num_items} must be in [1, {padded_items}]")
    if (queries.dtype, q_table.dtype, scales.dtype) != (
        torch.float32, torch.int8, torch.float32
    ):
        raise TypeError(
            "expected float32 queries, int8 q_table and float32 scales, got "
            f"{queries.dtype}, {q_table.dtype}, {scales.dtype}"
        )
    if not (queries.device == q_table.device == scales.device):
        raise ValueError(
            f"tensors on different devices: {queries.device}, "
            f"{q_table.device}, {scales.device}"
        )
    return b, k, nb, bi


def mips_block_topk_plain(
    queries: torch.Tensor,
    q_table: torch.Tensor,
    scales: torch.Tensor,
    *,
    block_topk: int,
    num_items: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of stage 1, on any device: dequantize, one
    product per tile, the same masks, and the top R per tile by a stable
    descending sort (lowest index first among ties; padding columns drain
    in ascending order after every real row). Materializes the
    ``[B, padded]`` scores the kernel never writes."""
    b, k, nb, bi = _check_stage1(queries, q_table, scales, block_topk, num_items)
    g = q_table.reshape(nb, bi, k).to(torch.float32) * scales.reshape(nb, 1, 1)
    s = torch.einsum("bk,nik->bni", queries, g)                     # [B, nb, BI]
    col = torch.arange(nb * bi, device=queries.device).reshape(nb, bi)
    s.masked_fill_(col >= num_items, _NEG)
    order = torch.sort(s, dim=2, descending=True, stable=True).indices
    order = order[:, :, :block_topk]
    scores = torch.take_along_dim(s, order, dim=2)
    idx = (order + col[:, :1]).to(torch.int32)
    return scores.reshape(b, nb * block_topk), idx.reshape(b, nb * block_topk)


def mips_block_topk(
    queries: torch.Tensor,
    q_table: torch.Tensor,
    scales: torch.Tensor,
    *,
    block_topk: int,
    num_items: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1: per-quantization-block top-``block_topk`` candidates.

    ``queries`` f32 [B, K] (B a ``BLOCK_QUERIES`` multiple), ``q_table``
    int8 [padded_items, K], ``scales`` f32 [num_blocks, 1]. Returns
    ``(scores [B, num_blocks * R] f32, indices [B, num_blocks * R] i32)``
    with indices already global catalog indices; padding rows (index >=
    ``num_items``) are masked to ``_NEG`` before the selection.

    CUDA tensors launch ``csrc/mips_topk.cu`` (and count the launch in
    ``mips_block_topk.launches``) or raise; CPU tensors take
    ``mips_block_topk_plain``. Any rank and tile size launch, through
    the instance ``mips_instance`` names; the SIMT passes instance keeps
    the score rows of tiles past 2,048 items in a global scratch this
    wrapper allocates."""
    b, k, nb, bi = _check_stage1(queries, q_table, scales, block_topk, num_items)
    if queries.device.type == "cpu":
        return mips_block_topk_plain(
            queries, q_table, scales, block_topk=block_topk, num_items=num_items
        )
    if queries.device.type != "cuda":
        raise ValueError(f"no stage-1 kernel for device {queries.device}")
    if not (queries.is_contiguous() and q_table.is_contiguous() and scales.is_contiguous()):
        raise ValueError("mips_block_topk needs contiguous tensors")
    if b > _MAX_BATCH:
        raise ValueError(f"batch {b} exceeds the kernel grid's {_MAX_BATCH} rows")
    from predictionio_tpu_torch import _kernels

    lib = _kernels.library("mips_topk")
    scores = torch.empty((b, nb, block_topk), dtype=torch.float32, device=queries.device)
    idx = torch.empty((b, nb, block_topk), dtype=torch.int32, device=queries.device)
    with torch.cuda.device(queries.device):
        scratch = _kernels.scratch(
            lib.mips_block_topk_scratch_floats(b, k, bi, block_topk, nb),
            queries.device, "mips_block_topk",
        )
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.mips_block_topk_launch(
            queries.data_ptr(), q_table.data_ptr(), scales.data_ptr(),
            scores.data_ptr(), idx.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            b, k, bi, block_topk, num_items, nb, stream,
        )
    _kernels.check(status, "mips_block_topk launch")
    mips_block_topk.launches += 1
    return scores.reshape(b, nb * block_topk), idx.reshape(b, nb * block_topk)


#: kernel launches since the last reset (``chip_smoke.py`` reads it to
#: show the served path went through the kernel)
mips_block_topk.launches = 0


def _search_program(
    queries: torch.Tensor,
    q_table: torch.Tensor,
    scales: torch.Tensor,
    table_f32: torch.Tensor,
    *,
    block_topk: int,
    shortlist: int,
    num_items: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 + merge + stage-2 exact re-rank.

    When the whole catalog fits the stage-2 budget (``num_items <=
    shortlist``) stage 1 is skipped: the shortlist IS the catalog and
    retrieval is exact by construction (small catalogs would otherwise
    inherit stage 1's per-block candidate cap)."""
    dev = queries.device
    if num_items <= shortlist:
        width = min(shortlist, q_table.shape[0])
        base = torch.arange(width, dtype=torch.int32, device=dev)
        sel = torch.where(base < num_items, base, num_items)
        sel = sel.expand(queries.shape[0], width)
    else:
        cand_s, cand_i = mips_block_topk(
            queries, q_table, scales, block_topk=block_topk, num_items=num_items
        )
        valid = cand_i < num_items
        cand_s = torch.where(valid, cand_s, -torch.inf)
        cand_i = torch.where(valid, cand_i, num_items)   # sentinel sorts last
        s = min(shortlist, cand_s.shape[1])
        # lax.top_k's order: value descending, lower position first on ties
        pos = torch.sort(cand_s, dim=1, descending=True, stable=True).indices[:, :s]
        sel = torch.take_along_dim(cand_i, pos, dim=1)
        # ascending catalog order: the host tail's stable ranking then
        # breaks score ties by global index, byte-matching the full scan
        sel = torch.sort(sel, dim=1).values
    gathered = table_f32[sel.clamp(0, num_items - 1).long()]         # [B, S, K]
    exact = torch.einsum("bk,bsk->bs", queries, gathered)
    exact = torch.where(sel < num_items, exact, -torch.inf)
    return sel, exact


@dataclass(frozen=True)
class RetrievalConfig:
    """The ``retrieval`` engine-param block (``docs/templates.md``).

    ``mode``: "scan" (full [rows, items] host matmul, the default) or
    "mips" (this module). ``shortlist`` is the stage-2 candidate count per
    query -- the recall margin over ``num``; ``block_items`` the
    quantization/tile granularity; ``block_topk`` the per-tile candidates
    (must stay >= the largest ``num`` served for the containment
    contract). Catalogs no larger than ``shortlist`` skip stage 1 and
    retrieve exactly (the shortlist is the catalog).
    """

    mode: str = "scan"
    shortlist: int = 512
    block_items: int = BLOCK_ITEMS
    block_topk: int = 16

    def __post_init__(self) -> None:
        if self.mode not in ("scan", "mips"):
            raise ValueError(
                f"retrieval.mode must be 'scan' or 'mips', got {self.mode!r}"
            )
        if self.shortlist < 1:
            raise ValueError("retrieval.shortlist must be >= 1")
        if self.block_topk < 1:
            raise ValueError("retrieval.blockTopk must be >= 1")

    @staticmethod
    def from_params(raw) -> "RetrievalConfig":
        """Parse the engine.json ``"retrieval": {...}`` block (camelCase
        knobs, template convention); None/{} -> scan defaults."""
        if not raw:
            return RetrievalConfig()
        if not isinstance(raw, dict):
            raise ValueError(
                f'"retrieval" must be an object like {{"mode": "mips"}}, '
                f"got {raw!r}"
            )
        known = {"mode", "shortlist", "blockItems", "blockTopk"}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(
                f"unknown retrieval params {sorted(unknown)}; "
                f"expected a subset of {sorted(known)}"
            )
        return RetrievalConfig(
            mode=raw.get("mode", "scan"),
            shortlist=int(raw.get("shortlist", 512)),
            block_items=int(raw.get("blockItems", BLOCK_ITEMS)),
            block_topk=int(raw.get("blockTopk", 16)),
        )


class RetrievalIndex:
    """Device-resident two-stage retrieval index over one factor table.

    Holds the int8 packed table, its scales and the f32 re-rank table on
    ``device`` (``cuda`` unless the caller names ``"cpu"``). Built lazily
    at serving time and cached per (table, config) by
    ``models/_als_common.retrieval_index``.
    """

    def __init__(
        self,
        factors: np.ndarray,
        config: RetrievalConfig,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        self.config = config
        self.device = resolve_device(device)
        packed = pack_int8_blockwise(
            np.asarray(factors, np.float32), config.block_items
        )
        self.num_items = packed.num_items
        self.packed_bytes = packed.packed_bytes
        self._q = torch.from_numpy(packed.q).to(self.device)
        self._scales = torch.from_numpy(packed.scales).to(self.device)
        self._table = torch.from_numpy(
            np.ascontiguousarray(factors, np.float32)
        ).to(self.device)

    def search(self, queries: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Top-``shortlist`` candidates for each query row.

        Returns ``(indices [B, S] i32 ascending per row, exact_scores
        [B, S] f32)``; slots past the catalog come back as ``(num_items,
        -inf)`` and drop in the format tail. Batches pad to the next
        power-of-two block multiple (the reference's bounded set of
        shapes)."""
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        b = queries.shape[0]
        padded = BLOCK_QUERIES
        while padded < b:
            padded *= 2
        if padded != b:
            queries = np.concatenate(
                [queries, np.zeros((padded - b, queries.shape[1]), np.float32)]
            )
        q = torch.from_numpy(np.ascontiguousarray(queries)).to(self.device)
        idx, scores = _search_program(
            q, self._q, self._scales, self._table,
            block_topk=self.config.block_topk,
            shortlist=self.config.shortlist,
            num_items=self.num_items,
        )
        return idx[:b].cpu().numpy(), scores[:b].cpu().numpy()


def reference_shortlist(
    factors: np.ndarray, queries: np.ndarray, config: RetrievalConfig
) -> np.ndarray:
    """Numpy reference of the two-stage candidate selection: the same
    quantized stage-1 arithmetic and merge the kernel fuses, as plain
    host math (the recall oracle). Returns ``[B, shortlist]`` ascending
    candidate catalog indices (padding slots carry ``num_items``
    sentinels past tiny catalogs)."""
    packed = pack_int8_blockwise(
        np.asarray(factors, np.float32), config.block_items
    )
    if packed.num_items <= config.shortlist:
        width = min(config.shortlist, packed.q.shape[0])
        base = np.arange(width, dtype=np.int32)
        sel = np.where(base < packed.num_items, base, packed.num_items)
        return np.broadcast_to(
            sel, (np.atleast_2d(queries).shape[0], width)
        ).copy()
    deq = packed.q.astype(np.float32) * np.repeat(
        packed.scales[:, 0], config.block_items
    )[:, None]
    qs = np.asarray(queries, np.float32) @ deq.T          # [B, padded]
    b, padded = qs.shape
    qs = np.where(np.arange(padded)[None, :] < packed.num_items, qs, _NEG)
    nb = packed.num_blocks
    r = min(config.block_topk, config.block_items)
    tiles = qs.reshape(b, nb, config.block_items)
    if r < config.block_items:
        part = np.argpartition(-tiles, r - 1, axis=2)[:, :, :r]
    else:
        part = np.broadcast_to(
            np.arange(config.block_items), tiles.shape
        )[:, :, :r]
    cand_i = (
        part + (np.arange(nb) * config.block_items)[None, :, None]
    ).reshape(b, -1)
    cand_s = np.take_along_axis(qs, cand_i, axis=1)
    cand_s = np.where(cand_i < packed.num_items, cand_s, -np.inf)
    s = min(config.shortlist, cand_s.shape[1])
    if s < cand_s.shape[1]:
        top = np.argpartition(-cand_s, s - 1, axis=1)[:, :s]
    else:
        top = np.broadcast_to(np.arange(cand_s.shape[1]), cand_s.shape)
    return np.sort(np.take_along_axis(cand_i, top, axis=1), axis=1)


def mips_bytes(
    num_items: int,
    rank: int,
    batch: int,
    block_items: int = BLOCK_ITEMS,
    block_topk: int = 16,
    shortlist: int = 512,
) -> float:
    """Device-memory bytes the two-stage path moves for one query batch.

    Stage 1 reads the int8 table + scales once and re-reads the query
    block per item tile; it writes the [B, nb, R] candidate pair. Stage 2
    gathers shortlist f32 rows and writes the [B, S] pair.
    """
    padded = -(-num_items // block_items) * block_items
    nb = padded // block_items
    stage1 = (
        padded * rank                      # int8 table, one pass
        + nb * 4                           # scales
        + batch * rank * 4 * nb            # query block per tile
        + batch * nb * block_topk * 8      # candidate scores + indices
    )
    shortlist_rows = min(shortlist, nb * block_topk)
    stage2 = batch * shortlist_rows * (rank * 4 + 8 + 4)
    return float(stage1 + stage2)


def scan_bytes(num_items: int, rank: int, batch: int) -> float:
    """The full-scan counterpart: one f32 table pass plus the [B, items]
    score buffer write + the selection's read-back."""
    return float(
        num_items * rank * 4 + batch * rank * 4 + 2 * batch * num_items * 4
    )
