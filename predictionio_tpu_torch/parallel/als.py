"""Alternating Least Squares on the card, in one process or several.

Port of ``predictionio_tpu/parallel/als.py``:

- interactions live as padded CSR blocks (``ops.ragged``), optionally
  LENGTH-BUCKETED per side (``_plan_buckets``): each side's entities are
  relabeled into length-sorted factor slots and split into a few
  buckets, each its own padded block. The opposite side's column ids are
  slot-mapped at pack time; ``slot_of`` maps factors back to original
  entity order at the host boundary only. The host half (``ALSConfig``
  to ``build_als_data``, the initial factors) stays numpy and produces
  the reference's arrays byte for byte.
- each half-step runs, per bucket, the gather->Gram/rhs of
  ``ops.als_gram`` (the CUDA kernel on the card, its plain version on the
  CPU or with ``solver="xla"``), then adds the ALS-WR ridge (explicit) or
  YtY + reg*I (implicit, Hu-Koren-Volinsky with the YtY trick) and solves
  every row's K x K system at once (``ops.linalg.batched_spd_solve``).
- factors live on the device in slot order, each side as one ``[S + 1,
  K]`` buffer whose last row stays zero (the padding sentinel's gather
  target). A half-step writes its solved rows into its own side's buffer
  in place: it never reads that side, so the update is exact, and no
  per-iteration concatenation or zero-row append is needed.

Over a ``parallel.mesh.Mesh`` of ``torch.distributed`` ranks (``mesh=``;
one rank per process, reference ``:583-790``) every bucket's rows shard
over the ``data`` axis (``_Sharding``):

- ``factor_sharding="replicated"``: every rank holds both whole tables.
  It solves its data shard of each bucket through B1 and the batched
  solve, and an ``all_gather`` over ``data`` rebuilds the bucket's rows
  on every rank.
- ``factor_sharding="model"`` (ALX): each rank holds its ``model``-axis
  slice ``[S/m, K]`` of both tables, plus a zero row
  (``_sharded_block_body``, reference ``:490``). With ``solver`` "auto"
  or "pallas" the bucket's indices remap to the slice's local rows, the
  out-of-slice ones (the padding sentinel among them) to the trailing
  zero row; B1 runs on the local ``[S/m + 1, K]`` table, and a
  reduce-scatter over ``model`` sums the partial Gram/rhs and hands each
  rank its ``rows/m`` slice to solve. With "xla" the local hits are
  gathered and the ``[rows, L, K]`` gather is reduce-scattered before
  the products. An ``all_gather`` over the mesh then hands each rank the
  bucket's solved rows, of which it keeps its slice. Implicit mode's YtY
  is the sum over ``model`` of the slices' Grams.

A process group that fails, or a collective that fails, raises: nothing
falls back to one process or to a plain kernel. With no mesh (or a 1 x 1
one) the collectives are the identity and the fit is the one-card fit.

``als_fit_streamed`` runs the same half-steps over a ``parallel.stream``
block store (``alsFeed: "streamed"``): both factor tables stay on the
device and the padded-CSR blocks stream in from disk, two pinned host
staging buffers and a copy stream overlapping block N+1's copy with
block N's B1 launch and solve. Over a mesh each rank reads only its data
shard's rows of each block.

Explicit objective:  sum_obs (r - u.v)^2 + lam * (|U|^2 + |V|^2)
Implicit objective (Hu-Koren-Volinsky): confidence c = 1 + alpha*r on
observed pairs, preference p = 1; unobserved pairs have c = 1, p = 0.

``ALSModel`` keeps its factors as host numpy arrays and scores with
``np.einsum``: the mips shortlist's host re-rank
(``models/_als_common._host_rerank``) replays exactly this arithmetic, so
a shortlist holding the true top-k gives a response byte-identical to
the scan's.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from predictionio_tpu_torch.ops.als_gram import (
    gathered_products,
    gram_rhs,
    gram_rhs_plain,
    half_step_bytes,
)
from predictionio_tpu_torch.ops.linalg import batched_spd_solve
from predictionio_tpu_torch.ops.ragged import PaddedCSR, pack_padded_csr, round_up
from predictionio_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_max,
    all_reduce_sum,
    reduce_scatter_rows,
)
from predictionio_tpu_torch.utils.device import resolve_device


@dataclass
class ALSConfig:
    rank: int = 16
    iterations: int = 10
    reg: float = 0.1           # lambda (MLlib: lambda_)
    alpha: float = 40.0        # implicit confidence scale
    implicit: bool = False
    seed: int = 0
    max_len: int | None = None  # per-row history cap
    dtype: str = "float32"     # factor dtype; Grams always accumulate f32
    buckets: int = 1           # length buckets per side (1 = single block)
    #: "replicated": every rank holds both factor tables. "model": ALX
    #: block model-parallelism -- factors shard over the mesh's ``model``
    #: axis, each rank gathers only its local hits, and a reduce-scatter
    #: over ``model`` completes the sum; per-rank factor memory drops to
    #: total_slots/model_axis rows. Requires build_als_data(model_shards=m).
    #: The templates' "auto" picks "model" on a mesh whose model axis is
    #: above 1.
    factor_sharding: str = "replicated"
    #: half-step tail: "auto" and "pallas" run the fused gather->Gram
    #: kernel (``ops.als_gram.gram_rhs``: CUDA on the card, its plain
    #: version on the CPU); "xla" runs the unfused gather + products
    #: (``gram_rhs_plain``) on whatever device the fit runs on.
    solver: str = "auto"


@dataclass
class BucketedCSR:
    """One side's interactions as length-bucketed padded CSR blocks.

    Block ``b`` covers factor-matrix slots ``[offset_b, offset_b +
    padded_rows_b)``; real rows are deterministically SCATTERED across the
    block's padded range (see _plan_buckets), padding rows carry zero mask
    wherever they fall. ``slot_of[original_id]`` is the factor row the
    entity occupies; built with ``buckets=1`` the slot map is the identity
    and ``blocks`` holds one block.
    ``indices`` entries are the OPPOSITE side's slots; padding slots carry
    the sentinel ``opposite.total_slots`` (the zero row appended to the
    gathered factor matrix).
    """

    blocks: tuple[PaddedCSR, ...]
    slot_of: np.ndarray  # int64 [num_rows]: original row id -> factor slot
    num_rows: int        # real (original) row count
    total_slots: int     # sum of the blocks' padded row counts
    #: set by the sharded reader (``parallel.reader``): the global padded
    #: row count of each bucket; at one process each block's own height.
    #: None = built by ``build_als_data``
    global_rows: tuple[int, ...] | None = None
    #: edges this process retained after the reader's partitioned scan
    retained_edges: int = 0

    @property
    def truncated(self) -> int:
        return sum(b.truncated for b in self.blocks)


@dataclass
class ALSData:
    """Both orientations of the interaction matrix."""

    by_row: BucketedCSR  # users x items
    by_col: BucketedCSR  # items x users


@dataclass
class _BucketPlan:
    order: np.ndarray      # original ids in slot order (real rows only)
    sizes: list[int]       # real rows per bucket
    offsets: list[int]     # first slot of each bucket
    slot_of: np.ndarray    # [num_rows]
    total_slots: int
    lengths: list[int]     # padded L per bucket

    @property
    def padded_rows(self) -> list[int]:
        ends = self.offsets[1:] + [self.total_slots]
        return [e - o for o, e in zip(self.offsets, ends)]


def _plan_buckets(
    counts: np.ndarray,
    cap: int | None,
    n_buckets: int,
    row_multiple: int,
    len_multiple: int = 8,
) -> _BucketPlan:
    """Partition rows into <=``n_buckets`` length buckets minimizing the
    total padded slot count sum_b padded_rows_b * padded_len_b.

    Rows are sorted by (capped) length descending; candidate cut points
    are the positions where the 8-rounded length drops, so the exact DP
    over candidates is tiny. Using FEWER buckets than allowed is
    considered too: each bucket pays a row-roundup tax.
    """
    n = counts.size

    def padded_len(raw: int) -> int:
        capped_max = min(raw, cap) if cap else raw
        return max(round_up(capped_max, len_multiple), len_multiple)

    if n_buckets <= 1 or n <= 1:
        total = max(round_up(max(n, 1), row_multiple), row_multiple)
        return _BucketPlan(
            order=np.arange(n, dtype=np.int64),
            sizes=[n],
            offsets=[0],
            slot_of=np.arange(n, dtype=np.int64),
            total_slots=total,
            lengths=[padded_len(int(counts.max()) if n else 0)],
        )

    capped = np.minimum(counts, cap) if cap else counts
    order = np.argsort(-capped, kind="stable").astype(np.int64)
    rounded = np.maximum(
        ((capped[order] + len_multiple - 1) // len_multiple) * len_multiple,
        len_multiple,
    )
    cuts = list(np.nonzero(np.diff(rounded) != 0)[0] + 1)
    cand = [0] + cuts + [n]
    if len(cand) > 66:  # cap DP size for absurd max_len; keep ends exact
        step = (len(cand) - 2) // 64 + 1
        cand = [0] + cand[1:-1][::step] + [n]

    def seg_cost(i: int, j: int) -> int:
        rows = cand[j] - cand[i]
        return round_up(rows, row_multiple) * int(rounded[cand[i]])

    m = len(cand) - 1
    inf = float("inf")
    dp = [[inf] * (m + 1) for _ in range(n_buckets + 1)]
    back: list[list[int]] = [[0] * (m + 1) for _ in range(n_buckets + 1)]
    dp[0][0] = 0.0
    for b in range(1, n_buckets + 1):
        for j in range(1, m + 1):
            for i in range(j):
                if dp[b - 1][i] == inf:
                    continue
                cost = dp[b - 1][i] + seg_cost(i, j)
                if cost < dp[b][j]:
                    dp[b][j] = cost
                    back[b][j] = i
    b_best = min(range(1, n_buckets + 1), key=lambda b: dp[b][m])
    bounds = [m]
    b, j = b_best, m
    while b > 0:
        j = back[b][j]
        bounds.append(j)
        b -= 1
    bounds.reverse()  # candidate indices 0 = start .. m = end

    sizes, offsets, lengths = [], [], []
    slot_of = np.empty(n, dtype=np.int64)
    off = 0
    for b, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        size = cand[hi] - cand[lo]
        sizes.append(size)
        offsets.append(off)
        lengths.append(int(rounded[cand[lo]]))
        # deterministic scatter over the bucket's whole padded range (the
        # reference balances multi-host shards with it; kept so the slot
        # map, and with it every packed array, equals the reference's)
        padded_b = max(round_up(size, row_multiple), row_multiple)
        perm = np.random.default_rng(0x5EED + b).permutation(padded_b)[:size]
        slot_of[order[cand[lo] : cand[hi]]] = off + perm
        off += padded_b
    return _BucketPlan(
        order=order, sizes=sizes, offsets=offsets, slot_of=slot_of,
        total_slots=off, lengths=lengths,
    )


def _pack_side(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    times: np.ndarray | None,
    plan: _BucketPlan,
    opp_total_slots: int,
    opp_slot_of: np.ndarray,
    cap: int | None,
    row_multiple: int,
) -> BucketedCSR:
    """Pack one orientation into its bucket blocks (slot-mapped columns)."""
    row_slots = plan.slot_of[rows]
    cols_slotted = opp_slot_of[cols]
    blocks = []
    for off, padded, length in zip(
        plan.offsets, plan.padded_rows, plan.lengths
    ):
        sel = (row_slots >= off) & (row_slots < off + padded)
        blocks.append(
            pack_padded_csr(
                row_slots[sel] - off,
                cols_slotted[sel],
                vals[sel],
                num_rows=padded,
                num_cols=opp_total_slots,
                max_len=cap,
                times=None if times is None else times[sel],
                row_multiple=row_multiple,
                pad_len=length,
            )
        )
    return BucketedCSR(
        blocks=tuple(blocks),
        slot_of=plan.slot_of,
        num_rows=int(plan.slot_of.shape[0]),
        total_slots=plan.total_slots,
    )


def build_als_data(
    users: np.ndarray,
    items: np.ndarray,
    ratings: np.ndarray,
    num_users: int,
    num_items: int,
    config: ALSConfig,
    times: np.ndarray | None = None,
    num_shards: int = 1,
    model_shards: int = 1,
) -> ALSData:
    """Pack COO interactions into both (bucketed) CSR orientations.

    Every bucket's row count is padded to a multiple of 8 * num_shards *
    model_shards, so each data shard is equal and, with
    ``factor_sharding="model"``, splits evenly again over the model
    axis; one card uses 1 and 1. With ``config.buckets == 1`` the layout
    is the single-block one.
    """
    users = np.asarray(users, dtype=np.int64)
    items = np.asarray(items, dtype=np.int64)
    ratings = np.asarray(ratings, dtype=np.float32)
    # ids beyond the declared catalog are an encoder/count mismatch; fail
    # HERE (np.bincount would silently grow the entity universe)
    for ids, declared, what in ((users, num_users, "user"),
                                (items, num_items, "item")):
        if ids.size and int(ids.max()) >= declared:
            raise ValueError(
                f"{what} id {int(ids.max())} out of range for "
                f"num_{what}s={declared}"
            )
    rm = 8 * max(num_shards, 1) * max(model_shards, 1)
    nb = max(int(config.buckets), 1)
    plan_u = _plan_buckets(
        np.bincount(users, minlength=num_users), config.max_len, nb, rm
    )
    plan_i = _plan_buckets(
        np.bincount(items, minlength=num_items), config.max_len, nb, rm
    )
    by_row = _pack_side(
        users, items, ratings, times, plan_u,
        plan_i.total_slots, plan_i.slot_of, config.max_len, rm,
    )
    by_col = _pack_side(
        items, users, ratings, times, plan_i,
        plan_u.total_slots, plan_u.slot_of, config.max_len, rm,
    )
    return ALSData(by_row=by_row, by_col=by_col)


def _eye(rank: int, device) -> torch.Tensor:
    return torch.eye(rank, dtype=torch.float32, device=device)


def _finish_explicit(gram, rhs, n_obs, reg: float, rank: int, out_dtype):
    """ALS-WR ridge + batched solve over precomputed Gram/rhs: the tail the
    fused kernel and the unfused path share, so solver parity reduces to
    Gram/rhs parity (reference ``parallel/als.py:363``)."""
    ridge = reg * torch.clamp(n_obs, min=1.0)
    gram = gram + ridge[:, None, None] * _eye(rank, gram.device)
    return batched_spd_solve(gram, rhs).to(out_dtype)


def _finish_implicit(gram_fix, rhs, yty, reg: float, rank: int, out_dtype):
    """YtY + per-row correction + constant ridge + solve (reference
    ``parallel/als.py:374``). ``gram_fix`` holds only the observed-entry
    corrections sum_obs (c-1) y y^T."""
    gram = yty[None] + gram_fix + reg * _eye(rank, yty.device)
    return batched_spd_solve(gram, rhs).to(out_dtype)


def _factors_yty(factors: torch.Tensor) -> torch.Tensor:
    """f32 K x K Gram of a factor matrix (implicit mode's global term)."""
    f = factors.to(torch.float32)
    return f.T @ f


def half_step_fn(solver: str):
    """The gather->Gram/rhs an ``ALSConfig.solver`` names: the fused
    kernel's wrapper for "auto" and "pallas", the unfused products for
    "xla"."""
    if solver not in ("auto", "xla", "pallas"):
        raise ValueError(
            "ALSConfig.solver must be 'auto', 'xla' or 'pallas', "
            f"got {solver!r}"
        )
    return gram_rhs_plain if solver == "xla" else gram_rhs


def _no_mark(name: str):
    return contextlib.nullcontext()


def solve_rows(gram_fn, block, opp_full, yty, config: ALSConfig, out_dtype,
               mark=_no_mark):
    """One bucket's half-step: Gram/rhs of its rows against ``opp_full``
    ([S + 1, K], zero row last), then the shared tail. ``mark(name)``
    names the two parts (``als.gram_rhs``, ``als.solve``) for a profiler
    trace."""
    idx, val, n_obs = block
    with mark("als.gram_rhs"):
        gram, rhs = gram_fn(idx, val, opp_full, config.alpha, implicit=config.implicit)
    with mark("als.solve"):
        if config.implicit:
            return _finish_implicit(gram, rhs, yty, config.reg, config.rank, out_dtype)
        return _finish_explicit(gram, rhs, n_obs, config.reg, config.rank, out_dtype)


def _sharded_block_body(gram_fn, block, opp_local, yty, config: ALSConfig, out_dtype,
                        sharding: "_Sharding", mark=_no_mark):
    """One bucket's half-step with MODEL-SHARDED factors (reference
    ``parallel/als.py:490``): ``block`` holds this rank's data shard of
    the bucket's rows, ``opp_local`` its ``[S/m + 1, K]`` slice of the
    opposite table (zero row last), ``sharding`` the fit's. Returns this
    rank's ``rows/m`` slice of the shard's solved rows; in mesh order the
    slices are the bucket's rows.

    The fused kernel (``gram_fn`` is ``gram_rhs``): indices inside the
    slice remap to its local rows, every other one (the padding sentinel
    too, which lies outside every slice) to the local zero row -- the
    reference's ``safe = where(hit, loc, s_m)`` -- so B1 accumulates the
    slice's partial Gram/rhs, and a reduce-scatter over ``model`` sums
    the partials and hands each rank its rows. The unfused path
    (``gram_rhs_plain``, ``solver="xla"``) gathers the local hits, zero
    elsewhere, reduce-scatters the ``[rows, L, K]`` gather (each entry is
    nonzero on one slice only, so the sum is exact) and takes the
    products of its rows."""
    idx, val, n_obs = block
    m, mi = sharding.m, sharding.mi
    s_m = opp_local.shape[0] - 1
    rows = idx.shape[0] // m
    loc = idx.long() - mi * s_m
    hit = (loc >= 0) & (loc < s_m)
    with mark("als.gram_rhs"):
        if gram_fn is gram_rhs:
            safe = torch.where(hit, loc, s_m).to(torch.int32)
            gram, rhs = gram_fn(safe, val, opp_local, config.alpha, implicit=config.implicit)
            gram, rhs = sharding.model_sum(gram), sharding.model_sum(rhs)
        else:
            g = opp_local[loc.clamp(0, s_m - 1)].to(torch.float32) * hit.unsqueeze(-1)
            g = sharding.model_sum(g)
            gram, rhs = gathered_products(g, val[mi * rows:(mi + 1) * rows], config.alpha,
                                          implicit=config.implicit)
    with mark("als.solve"):
        if config.implicit:
            return _finish_implicit(gram, rhs, yty, config.reg, config.rank, out_dtype)
        n_s = n_obs[mi * rows:(mi + 1) * rows]
        return _finish_explicit(gram, rhs, n_s, config.reg, config.rank, out_dtype)


class _Sharding:
    """Where a fit's rows and factors live on ``mesh`` (None: one rank).

    ``d``/``di`` and ``m``/``mi`` are the data and model axes' sizes and
    this rank's positions. A block of ``R`` rows gives this rank its data
    shard's rows ``local_rows(R)``; ``table`` is this rank's buffer of a
    side (the whole ``[S + 1, K]``, or with ``model`` its ``[S/m + 1,
    K]`` slice, zero row last); ``solve`` runs one block's half-step and
    returns the block's solved rows, gathered from every rank that holds
    a part; ``write`` keeps what of them lies in this rank's table;
    ``to_host`` gathers a whole side (a collective when ``model``)."""

    def __init__(self, mesh: Mesh | None, factor_sharding: str):
        self.mesh = mesh
        self.d = mesh.axis_size("data") if mesh is not None else 1
        self.di = mesh.axis_index("data") if mesh is not None else 0
        self.m = mesh.axis_size("model") if mesh is not None else 1
        self.mi = mesh.axis_index("model") if mesh is not None else 0
        self.model = factor_sharding == "model"
        self.ranks = mesh.size if mesh is not None else 1

    def check(self, side, name: str, rows_per_block) -> None:
        """The reference's divisibility guarantee (``:987-1008``)."""
        if self.model:
            if side.total_slots % self.m or any(r % (self.d * self.m) for r in rows_per_block):
                raise ValueError(
                    f"factor_sharding='model' needs every {name} bucket's padded rows "
                    f"divisible by data*model = {self.d}*{self.m}; build the data with "
                    f"build_als_data(..., num_shards={self.d}, model_shards={self.m})"
                )
        elif any(r % self.d for r in rows_per_block):
            raise ValueError(
                f"every {name} bucket's padded rows must shard evenly over the "
                f"{self.d}-way data axis; build the data with "
                f"build_als_data(..., num_shards={self.d})"
            )

    def local_rows(self, rows: int) -> tuple[int, int]:
        per = rows // self.d
        return self.di * per, (self.di + 1) * per

    def table(self, slot_factors: np.ndarray, dtype, device) -> torch.Tensor:
        if self.model:
            s_m = slot_factors.shape[0] // self.m
            slot_factors = slot_factors[self.mi * s_m:(self.mi + 1) * s_m]
        return _side_buffer(slot_factors, dtype, device)

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every model rank's ``x``, this rank's ``1/m`` of its
        rows (the reduce-scatter over ``model``)."""
        return reduce_scatter_rows(self.mesh, ("model",), x) if self.m > 1 else x

    def yty(self, opp: torch.Tensor) -> torch.Tensor:
        g = _factors_yty(opp[:-1])
        return all_reduce_sum(self.mesh, ("model",), g) if self.model and self.m > 1 else g

    def solve(self, gram_fn, block, opp, yty, config: ALSConfig, dtype, mark) -> torch.Tensor:
        if self.model:
            rows = _sharded_block_body(gram_fn, block, opp, yty, config, dtype, self, mark)
            axes = ("data", "model")
        else:
            rows = solve_rows(gram_fn, block, opp, yty, config, dtype, mark)
            axes = ("data",)
        if self.ranks == 1:
            return rows
        # f32 on the wire: bf16 rows round-trip exactly
        return all_gather_rows(self.mesh, axes, rows.to(torch.float32))

    def write(self, buf: torch.Tensor, offset: int, rows: torch.Tensor) -> None:
        if not self.model:
            buf[offset:offset + rows.shape[0]] = rows
            return
        s_m = buf.shape[0] - 1
        lo = max(offset, self.mi * s_m)
        hi = min(offset + rows.shape[0], (self.mi + 1) * s_m)
        if lo < hi:
            buf[lo - self.mi * s_m:hi - self.mi * s_m] = rows[lo - offset:hi - offset]

    def to_host(self, buf: torch.Tensor, side) -> np.ndarray:
        """A side's f32 factors in original entity order (the dtype knob
        is a training layout: checkpoints and serving stay f32)."""
        full = buf[:-1].to(torch.float32)
        if self.model and self.m > 1:
            full = all_gather_rows(self.mesh, ("model",), full)
        return full.cpu().numpy()[side.slot_of]

    def any_rank(self, flag: bool) -> bool:
        """``flag`` on some rank: the ranks take a collective branch
        together (a rank-0-only checkpoint callback must not leave the
        others out of the gathers it needs)."""
        if self.ranks == 1:
            return flag
        return bool(all_reduce_max(self.mesh, int(flag)))


@dataclass
class ALSModel:
    user_factors: np.ndarray  # [num_users, K]
    item_factors: np.ndarray  # [num_items, K]
    #: lazily-built catalog norm cache -- similar_items is called once per
    #: anchor at serving time and must not rescan item_factors every call
    _item_norms: np.ndarray | None = field(
        default=None, init=False, repr=False, compare=False
    )
    #: lazily-built device retrieval indexes (``ops/mips.RetrievalIndex``),
    #: keyed by (kind, RetrievalConfig, device) -- see
    #: ``models/_als_common.retrieval_index``
    _retrieval_cache: dict | None = field(
        default=None, init=False, repr=False, compare=False
    )

    def __getstate__(self):
        # device tensors never enter a serialized model: indexes rebuild
        # at deploy (``warm_up``)
        state = self.__dict__.copy()
        state["_retrieval_cache"] = None
        return state

    def score_items_for_user(self, user_index: int) -> np.ndarray:
        # einsum, not @: BLAS sgemv picks its kernel by matrix height, so a
        # gathered-row product is a ULP off the full one -- einsum's per-row
        # reduction is height-independent, which lets the mips shortlist
        # re-rank (_als_common._host_rerank) reproduce these scores bitwise
        return np.einsum("ik,k->i", self.item_factors, self.user_factors[user_index])

    def score_users_for_item(self, item_index: int) -> np.ndarray:
        return self.user_factors @ self.item_factors[item_index]

    @property
    def item_norms(self) -> np.ndarray:
        if self._item_norms is None:
            self._item_norms = np.linalg.norm(self.item_factors, axis=1)
        return self._item_norms

    def similar_items(self, item_index: int) -> np.ndarray:
        """Cosine scores of all items against one (ALS-space similarity).

        einsum for the same reason as ``score_items_for_user``: the mips
        shortlist replays this row arithmetic and must land bitwise."""
        v = self.item_factors[item_index]
        norms = self.item_norms * (self.item_norms[item_index] + 1e-12)
        return np.einsum("ik,k->i", self.item_factors, v) / np.maximum(norms, 1e-12)


def _block_shapes(side) -> list[tuple[int, int]]:
    """``(rows, pad_len)`` of each block of a resident side
    (``BucketedCSR``) or of a streamed one (``parallel.stream.
    StreamedSide``)."""
    specs = getattr(side, "specs", None)
    if specs is not None:
        return [(s.rows, s.pad_len) for s in specs]
    return [tuple(b.indices.shape) for b in side.blocks]


def modeled_bytes_per_iteration(
    data, rank: int, itemsize: int, fused: bool
) -> float:
    """Device bytes one full ALS iteration moves through its half-step
    tails (``ops.als_gram.half_step_bytes`` summed over both sides'
    buckets, or their streamed blocks)."""
    return sum(
        half_step_bytes(rows, pad_len, rank, itemsize, fused)
        for side in (data.by_row, data.by_col)
        for rows, pad_len in _block_shapes(side)
    )


def real_edges(data) -> int:
    """Real (unpadded) observations -- the edges/sec denominator (a
    block store's manifest counts them)."""
    if hasattr(data.by_row, "specs"):
        return int(data.by_row.real_edges)
    return int(sum(b.mask.sum() for b in data.by_row.blocks))


def _initial_side_factors(side, rank: int, seed: int) -> np.ndarray:
    """Seeded N(0, 1/sqrt(K)) init for one side, drawn in ORIGINAL entity
    order and scattered into factor slots: invariant to the bucket plan
    and to shard-count padding; phantom rows stay zero (invisible to the
    implicit-mode global Gram)."""
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(rank)
    real = rng.normal(size=(side.num_rows, rank)) * scale
    out = np.zeros((side.total_slots, rank))
    out[side.slot_of] = real
    return out


def _scatter_side_init(side, host: np.ndarray) -> np.ndarray:
    """Checkpointed factors (original entity order) -> slot order."""
    out = np.zeros((side.total_slots, host.shape[1]), dtype=np.float64)
    out[side.slot_of] = np.asarray(host)[: side.num_rows]
    return out


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def device_blocks(side: BucketedCSR, device) -> list[tuple]:
    """Each bucket block as its device triple (indices i32, values f32,
    n_obs f32). The ``[R, L]`` mask never crosses to the device: the
    padding invariant reduces it to the per-row observation count."""
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return [
        (put(b.indices), put(b.values), put(b.mask.sum(axis=1)))
        for b in side.blocks
    ]


def _side_buffer(slot_factors: np.ndarray, dtype, device) -> torch.Tensor:
    """``[S + 1, K]`` device buffer of one side in slot order, zero row
    last (the padding sentinel's gather target)."""
    host = np.concatenate(
        [slot_factors, np.zeros((1, slot_factors.shape[1]))], axis=0
    )
    # float64 -> float32 -> dtype: the reference casts the float64 init
    # straight to the factor dtype, which rounds the same way for f32 and,
    # through float32, for bf16
    return torch.from_numpy(host.astype(np.float32)).to(device=device, dtype=dtype)


def _fit_device(mesh: Mesh | None, device) -> torch.device:
    """The fit's device: the mesh's when one is given (a ``device`` of
    another kind is refused), else ``resolve_device(device)``."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device).type != mesh.device.type:
        raise ValueError(f"the mesh runs on {mesh.device}; a fit on {device} cannot use it")
    return mesh.device


def _check_config(config: ALSConfig) -> None:
    if config.dtype not in _DTYPES:
        # e.g. an integer dtype would truncate the N(0, 1/sqrt(K)) init to
        # all zeros -- a fixed point of the update
        raise ValueError(
            f"ALSConfig.dtype must be 'float32' or 'bfloat16', got"
            f" {config.dtype!r}"
        )
    if config.factor_sharding not in ("replicated", "model"):
        raise ValueError(
            "ALSConfig.factor_sharding must be 'replicated' or 'model', "
            f"got {config.factor_sharding!r} (the template resolves 'auto')"
        )


def _local_blocks(side: BucketedCSR, sharding: _Sharding, device) -> list[tuple]:
    """``(offset, rows, (indices, values, n_obs))`` of each bucket: its
    first slot, its global row count and this rank's data shard of it on
    the device. Sides built by the sharded reader (``global_rows`` set)
    already hold only this rank's rows."""
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    out, off = [], 0
    for b, block in enumerate(side.blocks):
        rows = block.indices.shape[0] if side.global_rows is None else side.global_rows[b]
        if side.global_rows is None:
            lo, hi = sharding.local_rows(rows)
            idx, val, mask = block.indices[lo:hi], block.values[lo:hi], block.mask[lo:hi]
        elif block.indices.shape[0] * sharding.d != rows:
            raise ValueError(
                f"a sharded reader block of {block.indices.shape[0]} rows is not the "
                f"{sharding.d}-way data shard of {rows}; build it with this mesh"
            )
        else:
            idx, val, mask = block.indices, block.values, block.mask
        out.append((off, rows, (put(idx), put(val), put(mask.sum(axis=1)))))
        off += rows
    return out


def als_fit(
    data: ALSData,
    config: ALSConfig,
    device=None,
    callback=None,
    callback_interval: int = 1,
    init: tuple[np.ndarray, np.ndarray] | None = None,
    start_iteration: int = 0,
    telemetry=None,
    *,
    mesh: Mesh | None = None,
) -> ALSModel:
    """Run ALS for ``config.iterations``; returns host-side f32 factors in
    original entity order.

    ``device`` is ``cuda`` unless the caller names ``"cpu"``; with a
    ``mesh`` (``parallel.mesh.Mesh``, reference ``:896``) the fit runs on
    every rank of it, on the mesh's device, each rank solving its data
    shard of each bucket (``_Sharding``), and every rank returns the
    whole model. ``data`` is ``build_als_data``'s (every rank packed the
    same edges; it takes its rows) or the sharded reader's (this rank's
    rows only); either way packed with ``num_shards`` = the data axis and,
    for ``factor_sharding="model"``, ``model_shards`` = the model axis.
    ``callback(iteration, user_factors, item_factors)`` runs every
    ``callback_interval`` iterations (skipping the final one, whose result
    als_fit returns anyway) with HOST numpy copies in ORIGINAL entity
    order (the checkpointing hook; on a mesh the ranks gather the copies
    together when any rank has a callback). ``init``/``start_iteration``
    resume from checkpointed factors (original order): the remaining
    iterations run, which is exact for ALS (each iteration depends only on
    the previous factors). Factors are stored in ``config.dtype`` (f32 or
    bf16) on the device; Gram and solve run in f32.

    ``telemetry`` (any object with ``record_step(iteration, seconds)``)
    gets each iteration's wall time; it synchronizes the device after
    every iteration, so it is paid only when asked for, and marks each
    iteration (``als.iteration``) and each half-step's Gram and solve as
    ranges for a profiler trace.
    """
    device = _fit_device(mesh, device)
    _check_config(config)
    gram_fn = half_step_fn(config.solver)
    dtype = _DTYPES[config.dtype]
    sharding = _Sharding(mesh, config.factor_sharding)
    for side, name in ((data.by_row, "user"), (data.by_col, "item")):
        sharding.check(side, name, side.global_rows or
                       [b.indices.shape[0] for b in side.blocks])

    if init is not None:
        users0 = _scatter_side_init(data.by_row, init[0])
        items0 = _scatter_side_init(data.by_col, init[1])
    else:
        users0 = _initial_side_factors(data.by_row, config.rank, config.seed)
        items0 = _initial_side_factors(data.by_col, config.rank, config.seed + 1)

    u_blocks = _local_blocks(data.by_row, sharding, device)
    i_blocks = _local_blocks(data.by_col, sharding, device)
    users = sharding.table(users0, dtype, device)
    items = sharding.table(items0, dtype, device)
    zero_yty = torch.zeros((config.rank, config.rank), device=device)
    # a telemetered run names each iteration and each half-step's Gram and
    # solve in a profiler trace (``pio train --profile``)
    mark = torch.profiler.record_function if telemetry is not None else _no_mark
    host_copies = sharding.any_rank(callback is not None)

    def solve_side(blocks, buf, opp):
        # the global Gram excludes the zero row; phantom rows are zero too
        yty = sharding.yty(opp) if config.implicit else zero_yty
        for off, rows, block in blocks:
            sharding.write(buf, off, sharding.solve(gram_fn, block, opp, yty, config,
                                                    dtype, mark))

    for it in range(start_iteration, config.iterations):
        t0 = time.perf_counter()
        with mark("als.iteration"):
            solve_side(u_blocks, users, items)
            solve_side(i_blocks, items, users)
            if telemetry is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                telemetry.record_step(it, time.perf_counter() - t0)
        if (
            host_copies
            and (it + 1) % callback_interval == 0
            and it + 1 < config.iterations
        ):
            u_host = sharding.to_host(users, data.by_row)
            i_host = sharding.to_host(items, data.by_col)
            if callback is not None:
                callback(it, u_host, i_host)

    return ALSModel(
        user_factors=sharding.to_host(users, data.by_row),
        item_factors=sharding.to_host(items, data.by_col),
    )


# --------------------------------------------------------------------------
# streamed epochs over a block store (ALX, arxiv 2112.02194)
# --------------------------------------------------------------------------


def _check_block_layout(data, sharding: _Sharding) -> None:
    """Every block of a store must tile its side's factor table in whole
    multiples of the store's row multiple (8 x its data axis, x its model
    axis), inside the table: B1 writes each block's solved rows at
    ``spec.offset``. Over a mesh every block shards evenly over its data
    axis (and the model axis too, with ``factor_sharding="model"``)."""
    rm = int(data.row_multiple)
    for side in (data.by_row, data.by_col):
        for spec in side.specs:
            if spec.rows % rm or spec.pad_len % 8:
                raise ValueError(
                    f"streamed block {side.name}-{spec.index:05d} is {spec.rows} x "
                    f"{spec.pad_len}: rows must shard evenly over the store's data "
                    f"axis (row multiple {rm}) and the padded length be a multiple "
                    "of 8; rebuild the block store"
                )
            if spec.offset < 0 or spec.offset + spec.rows > side.total_slots:
                raise ValueError(
                    f"streamed block {side.name}-{spec.index:05d} covers rows "
                    f"{spec.offset}..{spec.offset + spec.rows} of a "
                    f"{side.total_slots}-slot table; rebuild the block store"
                )
        try:
            sharding.check(side, {"u": "user", "i": "item"}[side.name],
                           [spec.rows for spec in side.specs])
        except ValueError as exc:
            raise ValueError(
                f"{exc}; for a block store: build_streamed_als_data(..., "
                f"num_shards={sharding.d}, model_shards={sharding.m if sharding.model else 1})"
            ) from None


@dataclass
class _Block:
    """One block on the fit's device: indices, values (None: the spec's
    constant, made on the device), n_obs (None in implicit mode), and
    the copy's event (None on the CPU)."""

    idx: torch.Tensor
    val: torch.Tensor | None
    nobs: torch.Tensor | None
    event: object = None


class _BlockFeeder:
    """Host -> device feed of one fit's blocks (over a mesh: this rank's
    data shard of each block's rows, read from the block's files at
    their offset).

    Two staging buffers, each sized to the largest block, take every
    block's files by ``readinto`` (``StreamedSide.load_block_into``). On
    the card they are pinned, and each block's copy runs ``non_blocking``
    on a side stream: ``prefetch_blocks`` loads and ships block N+1 while
    the compute stream runs block N, and the compute stream waits on the
    copy's event before B1 reads the block. A staging buffer is refilled
    only after its last copy's event completed, and the device tensors,
    allocated on the side stream, are recorded on the compute stream, so
    the caching allocator reuses their memory only after B1 and the solve
    read them. Blocks pinned under ``device_budget_bytes`` are their own
    allocations (on the CPU, copies of the staging buffer)."""

    def __init__(self, data, device, implicit: bool, stats, budget: int,
                 sharding: _Sharding):
        from predictionio_tpu_torch.parallel.stream import FeedAccounting

        self.device = device
        self.implicit = implicit
        self.stats = stats
        self.sharding = sharding
        self.accounting = FeedAccounting()
        self.pinned: dict = {}
        self.budget_left = int(budget)
        self.cuda = device.type == "cuda"
        # this rank's rows of a block: its data shard (1/d of each stream)
        cap = max(
            s.idx_bytes() + s.val_bytes() + (0 if implicit else s.nobs_bytes())
            for side in (data.by_row, data.by_col) for s in side.specs
        ) // sharding.d
        if self.cuda:
            self.staging = [torch.empty(cap, dtype=torch.uint8, pin_memory=True)
                            for _ in range(2)]
            self.views = [t.numpy() for t in self.staging]
            self.copy_stream = torch.cuda.Stream(device)
        else:
            self.views = [np.empty(cap, dtype=np.uint8) for _ in range(2)]
        self.copied: list = [None, None]
        self.slot = 0

    def _device_view(self, k: int, host: np.ndarray | None):
        """The pinned staging tensor's slice under a numpy view of it."""
        if host is None:
            return None
        off = host.ctypes.data - self.views[k].ctypes.data
        flat = self.staging[k][off:off + host.nbytes]
        return flat.view(torch.int32 if host.dtype == np.int32 else torch.float32).view(
            host.shape)

    def _load(self, side, opp_slots: int, spec) -> tuple[_Block, int]:
        """Block ``spec`` read into the next staging buffer and shipped:
        ``(block, bytes moved)``."""
        k = self.slot
        self.slot ^= 1
        if self.copied[k] is not None:
            self.copied[k].synchronize()  # the buffer's last copy has landed
        idx, val, nobs = side.load_block_into(spec, self.views[k], with_nobs=not self.implicit,
                                              rows=self.sharding.local_rows(spec.rows))
        # B1 does not bounds-check: a torn or foreign store stops here
        if int(idx.view(np.uint32).max()) > opp_slots:
            raise ValueError(
                f"block {side.name}-{spec.index:05d} of {side.directory} indexes past "
                f"the opposite side's {opp_slots} slots: a torn or foreign block store"
            )
        host = (idx, val, nobs)
        moved = sum(a.nbytes for a in host if a is not None)
        keep = self.budget_left >= moved
        if self.cuda:
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.copy_stream):
                dev = [None if a is None else
                       self._device_view(k, a).to(self.device, non_blocking=True)
                       for a in host]
                event = torch.cuda.Event()
                event.record(self.copy_stream)
            for t in dev:
                if t is not None:
                    t.record_stream(compute)
            self.copied[k] = event
        else:
            event = None
            dev = [None if a is None else torch.from_numpy(a.copy() if keep else a)
                   for a in host]
        return _Block(dev[0], dev[1], dev[2], event), moved

    def feed(self, side, name: str, opp_slots: int):
        """``(spec, _Block)`` of every block of ``side``, one ahead of the
        consumer; blocks pinned on the device are taken from there."""
        from predictionio_tpu_torch.parallel.stream import prefetch_blocks

        acquired: set = set()

        def produce(spec):
            hit = self.pinned.get((name, spec.index))
            if hit is not None:
                self.stats.blocks_pinned += 1
                return hit
            self.accounting.acquire()
            acquired.add(spec.index)
            block, moved = self._load(side, opp_slots, spec)
            self.stats.h2d_block_bytes += moved
            if block.val is None:
                self.stats.h2d_scalar_bytes += 4  # the constant rides torch.full
            self.stats.blocks_streamed += 1
            if self.budget_left >= moved:
                self.pinned[(name, spec.index)] = block
                self.budget_left -= moved
                self.stats.pinned_bytes += moved
            return block

        def consumed(spec) -> None:
            if spec.index in acquired:
                acquired.discard(spec.index)
                self.accounting.release()

        return prefetch_blocks(side.specs, produce, consumed)

    def ready(self, spec, block: _Block) -> tuple:
        """The block's ``(indices, values, n_obs)`` for the compute
        stream, after its copy: a uniform-value block's values made with
        ``torch.full`` on the device (its value stream never shipped)."""
        if block.event is not None:
            torch.cuda.current_stream(self.device).wait_event(block.event)
        val = block.val
        if val is None:
            val = torch.full(tuple(block.idx.shape), float(spec.const),
                             dtype=torch.float32, device=block.idx.device)
        return block.idx, val, block.nobs


def als_fit_streamed(
    data,
    config: ALSConfig,
    device=None,
    callback=None,
    callback_interval: int = 1,
    init: tuple[np.ndarray, np.ndarray] | None = None,
    start_iteration: int = 0,
    telemetry=None,
    device_budget_bytes: int = 0,
    stats=None,
    *,
    mesh: Mesh | None = None,
) -> ALSModel:
    """``als_fit`` as ALX device-resident epochs over a block store
    (``parallel.stream.StreamedALSData``; reference
    ``parallel/als.py:1217``).

    Both factor tables go on ``device`` once, as ``[S + 1, K]`` buffers
    with the zero row last (with ``factor_sharding="model"`` each rank's
    ``[S/m + 1, K]`` slices), and stay there. Each half-step computes the
    opposite side's YtY once (implicit mode), then per block runs B1 and
    the batched solve (``_Sharding.solve``: ``solve_rows``, or over a
    model axis ``_sharded_block_body``) and writes the rows into the
    side's buffer at ``spec.offset``. The blocks stream from disk through
    ``_BlockFeeder`` one ahead of the compute (at most two host blocks
    alive); a uniform-value block ships no values and implicit mode no
    n_obs. Peak host memory is O(block): the edge ceiling is the disk,
    not twice the RAM.

    Over a ``mesh`` (the reference runs its streamed fit in one process
    over a device mesh; here each rank is a process) every rank reads
    only its data shard's rows of each block from the shared store, and
    the block's solved rows are gathered as in ``als_fit``; the store
    must be built with ``num_shards`` = the data axis (and
    ``model_shards`` = the model axis for ``factor_sharding="model"``).

    The arithmetic per row is ``als_fit``'s, so at equal block shapes the
    factors equal the resident fit's; a bucket cut into smaller blocks
    changes only the solve's batch sizes. ``callback``, ``init``,
    ``start_iteration`` and ``telemetry`` behave as in ``als_fit``.
    ``device_budget_bytes`` > 0 keeps streamed blocks on the device, in
    first-seen order until the budget runs out, so later iterations ship
    only the rest. ``stats`` (``parallel.stream.StreamStats``) receives
    the measured host -> device traffic of this rank."""
    from predictionio_tpu_torch.parallel.stream import StreamStats

    device = _fit_device(mesh, device)
    _check_config(config)
    sharding = _Sharding(mesh, config.factor_sharding)
    _check_block_layout(data, sharding)
    gram_fn = half_step_fn(config.solver)
    dtype = _DTYPES[config.dtype]
    stats = stats if stats is not None else StreamStats()

    if init is not None:
        users0 = _scatter_side_init(data.by_row, init[0])
        items0 = _scatter_side_init(data.by_col, init[1])
    else:
        users0 = _initial_side_factors(data.by_row, config.rank, config.seed)
        items0 = _initial_side_factors(data.by_col, config.rank, config.seed + 1)
    users = sharding.table(users0, dtype, device)
    items = sharding.table(items0, dtype, device)
    del users0, items0
    zero_yty = torch.zeros((config.rank, config.rank), device=device)
    mark = torch.profiler.record_function if telemetry is not None else _no_mark
    feeder = _BlockFeeder(data, device, bool(config.implicit), stats, device_budget_bytes,
                          sharding)
    host_copies = sharding.any_rank(callback is not None)

    def solve_side(side, name: str, buf, opp, opp_slots: int):
        yty = sharding.yty(opp) if config.implicit else zero_yty
        for spec, block in feeder.feed(side, name, opp_slots):
            rows = sharding.solve(gram_fn, feeder.ready(spec, block), opp, yty, config,
                                  dtype, mark)
            sharding.write(buf, spec.offset, rows)
        stats.half_steps += 1

    for it in range(start_iteration, config.iterations):
        t0 = time.perf_counter()
        with mark("als.iteration"):
            solve_side(data.by_row, "u", users, items, data.by_col.total_slots)
            solve_side(data.by_col, "i", items, users, data.by_row.total_slots)
            if telemetry is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                telemetry.record_step(it, time.perf_counter() - t0)
        if (
            host_copies
            and (it + 1) % callback_interval == 0
            and it + 1 < config.iterations
        ):
            u_host = sharding.to_host(users, data.by_row)
            i_host = sharding.to_host(items, data.by_col)
            if callback is not None:
                callback(it, u_host, i_host)

    stats.max_inflight_blocks = feeder.accounting.max_live
    return ALSModel(
        user_factors=sharding.to_host(users, data.by_row),
        item_factors=sharding.to_host(items, data.by_col),
    )
