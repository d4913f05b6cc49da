"""Shared pieces of the ALS-backed templates.

Port of ``predictionio_tpu/models/_als_common.py``. The training half:
CSR packing from the preparator's params (``prepare_als_data``), the
warning for packing knobs put in the algorithm block, and the fit
wrapped in fingerprinted step checkpoints (``fit_with_checkpoint``:
``als_fit`` over resident blocks, ``als_fit_streamed`` over the block
store the streaming reader packs with ``alsFeed: "streamed"``). The
serving half: the seen-items map, the mips ``Shortlist`` view and its
retrieval index, the known-user / similar-items scorers and the
rank+format tail of the ``itemScores`` responses (predict and the
vectorized batch path must rank identically).

With ``pio train --profile`` (runtime conf ``pio.profile``) the fit
writes the per-iteration telemetry journal
``<profile-dir>/<name>-telemetry.jsonl`` (``_telemetry_fields``,
reference ``:570-611``); a streamed fit's journal ends with a ``stream``
record of its ``StreamStats``.

Only the stage-1 search runs on the device. Every response score is
computed on the host with the same ``np.einsum`` row arithmetic as the
scan path, so mips responses are byte-identical to scan responses
whenever the shortlist holds the true top-k.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import logging

import numpy as np
import torch

from predictionio_tpu_torch.ops.mips import RetrievalConfig, RetrievalIndex
from predictionio_tpu_torch.parallel.als import (
    ALSConfig,
    ALSModel,
    als_fit,
    als_fit_streamed,
    build_als_data,
    modeled_bytes_per_iteration,
    real_edges,
)
from predictionio_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("pio.torch.als")


def prepare_als_data(
    ctx,
    params,
    users: np.ndarray,
    items: np.ndarray,
    values: np.ndarray,
    num_users: int,
    num_items: int,
    times: np.ndarray,
):
    """Pack COO interactions into padded CSR blocks per the preparator's
    params: ``maxEventsPerUser`` (history cap, most recent kept) and
    ``buckets`` (length-bucketed packing, default 1), sized for ctx's
    mesh (reference ``:39-67``): rows pad to multiples of 8 * data axis *
    model axis, so a model axis above 1 makes the blocks ready for the
    model-sharded fit ``resolve_factor_sharding`` then selects. One
    process (a 1 x 1 mesh): multiples of 8.

    The feed (``alsFeed``, or ``pio train --als-feed`` through
    ``ctx.runtime_conf``) is resolved here too, so a bad value fails the
    build. These arrays are already in host memory, so ``"streamed"``
    packs them resident, as the reference's materialized read does: the
    block store is the streaming reader's (``"reader": "streaming"``)."""
    from predictionio_tpu_torch.models._streaming import resolve_als_feed

    if resolve_als_feed(params, getattr(ctx, "runtime_conf", None)) == "streamed":
        logger.info(
            'alsFeed "streamed": the materialized reader holds the edges in '
            'host arrays, so they pack resident; "reader": "streaming" trains '
            "from the block store"
        )
    from predictionio_tpu_torch.controller.base import mesh_or_none

    config = ALSConfig(
        max_len=params.get_or("maxEventsPerUser", None),
        buckets=params.get_or("buckets", 1),
    )
    mesh = mesh_or_none(ctx)
    return build_als_data(
        users, items, values, num_users, num_items, config, times=times,
        num_shards=mesh.shape.get("data", 1) if mesh is not None else 1,
        model_shards=mesh.shape.get("model", 1) if mesh is not None else 1,
    )


#: packing knobs the PREPARATOR consumes; a natural mistake is putting
#: them in the algorithm block, where they would be silently ignored
PACKING_PARAM_KEYS = ("maxEventsPerUser", "buckets")


def warn_misplaced_packing_params(algo_params, template: str) -> None:
    misplaced = [
        k for k in PACKING_PARAM_KEYS
        if algo_params.get_or(k, None) is not None
    ]
    if misplaced:
        logger.warning(
            "%s: %s configure the PREPARATOR (put them under "
            '"preparator": {"params": {...}} in engine.json); they are '
            "ignored in the algorithm block",
            template, ", ".join(misplaced),
        )


def resolve_factor_sharding(config: ALSConfig, mesh=None) -> ALSConfig:
    """Resolve ``factor_sharding="auto"`` against the actual mesh
    (reference ``:109-127``).

    On a pure-ALS template a model axis > 1 has exactly one use -- ALX
    factor sharding -- so "auto" (the template default) selects it
    whenever ``pio.mesh_shape`` configures such an axis, and plain data
    parallelism otherwise. Explicit "replicated"/"model" pass through to
    the library untouched (als_fit validates them).
    """
    if config.factor_sharding != "auto":
        return config
    model = mesh.shape.get("model", 1) if mesh is not None else 1
    return dataclasses.replace(
        config, factor_sharding="model" if model > 1 else "replicated"
    )


def resolve_solver_override(config: ALSConfig, ctx) -> ALSConfig:
    """Apply the run-scoped ``pio.als_solver`` conf (``pio train
    --als-solver``, reference ``:91-106``) over the engine.json
    ``alsSolver`` param: the operator's choice wins over the variant
    file. "xla" trains through ``gram_rhs_plain``, "auto" and "pallas"
    through B1 (``parallel/als.py::half_step_fn`` validates the value)."""
    solver = getattr(ctx, "runtime_conf", None) or {}
    solver = solver.get("pio.als_solver")
    if not solver:
        return config
    return dataclasses.replace(config, solver=str(solver))


def _vocab_hash(ids: list[str]) -> str:
    h = hashlib.sha256()
    for s in ids:
        h.update(s.encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


def fit_with_checkpoint(
    ctx,
    als_data,
    config: ALSConfig,
    *,
    user_ids: list[str],
    item_ids: list[str],
    interval: int,
    name: str = "als",
    mesh=None,
) -> ALSModel:
    """``als_fit`` on ``ctx.device`` (over ``mesh``, the training mesh,
    when given) wrapped in fingerprinted step checkpoints
    (``ctx.checkpoint_manager``: in a multi-process launch rank 0 alone
    owns the checkpoint directory, and the other ranks join the fit's
    gathers at each checkpoint without writing).

    Checkpointed factors are only meaningful against the id vocabularies
    they were trained on: events that changed between crash and resume
    would misalign factor rows. Counts alone are not enough (delete one
    user + add another keeps the count but renumbers rows), so the
    vocabularies themselves are hashed too. A mismatch discards the
    checkpoints and trains fresh with a warning. ``interval`` <= 0
    disables checkpointing.

    ``ctx.telemetry`` gets each iteration's wall time; without one, a
    profiled run (``pio.profile`` in ``ctx.runtime_conf``) writes the
    telemetry journal (``ctx.journal`` with ``_telemetry_fields``).

    A ``parallel.stream.StreamedALSData`` (the streaming reader's block
    store) trains through ``als_fit_streamed`` with the same checkpoints
    and callback (reference ``:539-546``); the journal then closes with
    the fit's ``StreamStats``."""
    config = resolve_factor_sharding(config, mesh)
    config = resolve_solver_override(config, ctx)
    checkpoint = ctx.checkpoint_manager(name) if interval > 0 else None
    init, start_iteration, callback = None, 0, None
    if checkpoint is not None:
        num_users, num_items = len(user_ids), len(item_ids)
        fingerprint = {
            "num_users": num_users,
            "num_items": num_items,
            "user_vocab": _vocab_hash(user_ids),
            "item_vocab": _vocab_hash(item_ids),
            "rank": config.rank,
        }
        latest = checkpoint.latest_step()
        if latest is not None:  # only a resume run can see a step here
            meta = checkpoint.read_meta()
            if meta != fingerprint:
                logger.warning(
                    "%s checkpoint fingerprint %s does not match current"
                    " dataset %s (events changed between crash and resume?);"
                    " discarding checkpoints and training fresh",
                    name, meta, fingerprint,
                )
                checkpoint.reset()
            else:
                state = checkpoint.restore(
                    {
                        "users": np.zeros((num_users, config.rank), np.float32),
                        "items": np.zeros((num_items, config.rank), np.float32),
                        "iteration": 0,
                    }
                )
                init = (state["users"], state["items"])
                start_iteration = int(state["iteration"]) + 1
        checkpoint.write_meta(fingerprint)

        def callback(it, users_np, items_np):
            checkpoint.save(
                it, {"users": users_np, "items": items_np, "iteration": it}
            )

    if mesh is not None and mesh.size > 1:
        # rank 0 alone reads the checkpoints: every rank resumes from its
        # step, or the ranks' iteration counts (and collectives) diverge
        from predictionio_tpu_torch.parallel.mesh import broadcast_int, broadcast_rows

        start_iteration = broadcast_int(mesh, start_iteration)
        if start_iteration > 0:
            shapes = ((len(user_ids), config.rank), (len(item_ids), config.rank))
            init = tuple(
                broadcast_rows(mesh, torch.from_numpy(np.array(init[k], np.float32))
                               if init is not None else torch.empty(shapes[k])).numpy()
                for k in range(2))

    from predictionio_tpu_torch.parallel.stream import StreamedALSData, StreamStats

    streamed = isinstance(als_data, StreamedALSData)
    stats = StreamStats() if streamed else None
    with ctx.journal(name, lambda: _telemetry_fields(ctx, als_data, config)) as telemetry:
        fit = functools.partial(als_fit_streamed, stats=stats) if streamed else als_fit
        model = fit(
            als_data,
            config,
            ctx.device,
            callback=callback,
            callback_interval=interval,
            init=init,
            start_iteration=start_iteration,
            telemetry=telemetry,
            mesh=mesh,
        )
        if streamed and hasattr(telemetry, "record_stream"):
            telemetry.record_stream({
                **dataclasses.asdict(stats),
                "bytes_per_half_step": stats.bytes_per_half_step,
                "blocks": sum(len(s.specs) for s in (als_data.by_row, als_data.by_col)),
                "directory": als_data.directory,
            })
    if checkpoint is not None:
        checkpoint.close()
    return model


def _telemetry_fields(ctx, als_data, config: ALSConfig) -> dict:
    """The ALS journal's ``TrainTelemetry`` fields (``ctx.journal``):
    the edge count and the bytes model. ``solver`` is "pallas" when B1
    runs (on the card, any solver but "xla"), else "xla"; the bytes model
    counts the fused half-step then."""
    on_card = resolve_device(ctx.device).type != "cpu"
    solver = "pallas" if on_card and config.solver != "xla" else "xla"
    itemsize = 2 if config.dtype == "bfloat16" else 4
    return {
        "edges": real_edges(als_data),
        "modeled_bytes_per_iter": modeled_bytes_per_iteration(
            als_data, config.rank, itemsize, fused=solver == "pallas"
        ),
        "meta": {
            "rank": config.rank,
            "solver": solver,
            "dtype": config.dtype,
            "iterations": config.iterations,
        },
    }


def user_runs(users: np.ndarray, device=None) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(order, distinct users, starts, ends)``: the stable sort of
    ``users`` (``torch.sort`` on ``device``, the host by default: several
    times numpy's for tens of millions of rows) and each user's run of
    it, found by one O(n) boundary scan."""
    order = torch.sort(torch.as_tensor(np.asarray(users), device=resolve_device(device or "cpu")),
                       stable=True).indices.cpu().numpy()
    sorted_users = np.asarray(users)[order]
    starts = np.flatnonzero(np.r_[True, sorted_users[1:] != sorted_users[:-1]])
    ends = np.append(starts[1:], sorted_users.size)
    return order, sorted_users[starts], starts, ends


def build_seen(users: np.ndarray, items: np.ndarray) -> dict[int, set[int]]:
    """user index -> set of interacted item indices (serving-time filter).

    Sorted-split construction (``user_runs``), so interpreter time is
    O(distinct users), not O(events)."""
    users = np.asarray(users)
    if users.size == 0:
        return {}
    order, uniq, starts, bounds = user_runs(users)
    sorted_items = np.asarray(items)[order].tolist()
    return {
        u: set(sorted_items[s:e])
        for u, s, e in zip(uniq.tolist(), starts.tolist(), bounds.tolist())
    }


def score_buffer_rows(num_items: int, floor: int = 64, cap: int | None = None) -> int:
    """Rows per batch-predict slice so the host [rows, items] score buffer
    stays ~200 MB f32 regardless of catalog size, at most ``cap`` rows
    when given. One definition for every template's batch path."""
    rows = max(floor, 50_000_000 // max(num_items, 1))
    return min(rows, cap) if cap else rows


def partition_user_queries(user_index: dict[str, int], queries):
    """Split (qid, query) pairs into known-user rows [(qid, q, user_idx)]
    and fallback pairs [(qid, q)] -- the shared head of batch_predict."""
    user_rows, fallback = [], []
    for qid, q in queries:
        user_idx = (
            user_index.get(str(q["user"]))
            if isinstance(q, dict) and "user" in q
            else None
        )
        if user_idx is None:
            fallback.append((qid, q))
        else:
            user_rows.append((qid, q, user_idx))
    return user_rows, fallback


class Shortlist:
    """Compact view of one request's score vector: the stage-2 contract
    of the two-stage MIPS retrieval path (``ops/mips``).

    ``indices`` are ascending catalog indices, ``scores`` their EXACT f32
    re-ranked scores (writable copy -- the seen/blackList filters write
    -inf through ``__setitem__``). The ascending order is load-bearing:
    ``topk_order``'s stable sort over the compact array then breaks score
    ties by global catalog index, byte-matching the full scan. Items
    outside the shortlist silently absorb filter writes.
    """

    __slots__ = ("indices", "scores", "num_items")

    def __init__(self, indices: np.ndarray, scores: np.ndarray, num_items: int):
        self.indices = np.asarray(indices)
        self.scores = np.array(scores)  # writable copy: filters mutate it
        self.num_items = num_items

    @property
    def shape(self) -> tuple:
        """Mimics the dense score vector (``scores.shape[0]``)."""
        return (self.num_items,)

    def __setitem__(self, idx: int, value) -> None:
        pos = int(np.searchsorted(self.indices, idx))
        if pos < self.indices.size and self.indices[pos] == idx:
            self.scores[pos] = value

    def where_allowed(self, allowed: np.ndarray, sentinel=-np.inf) -> "Shortlist":
        """Apply a dense [num_items] bool mask (whiteList/categories) in
        O(shortlist); ``num_items`` sentinels (search padding) always mask
        to ``sentinel``."""
        valid = self.indices < self.num_items
        safe = np.minimum(self.indices, max(self.num_items - 1, 0))
        self.scores = np.where(valid & allowed[safe], self.scores, sentinel)
        return self

    def copy(self) -> "Shortlist":
        return Shortlist(self.indices, self.scores, self.num_items)


def resolve_retrieval(params) -> RetrievalConfig:
    """Parse the algorithm-params ``"retrieval"`` block (raising on
    unknown modes/knobs)."""
    return RetrievalConfig.from_params(params.get_or("retrieval", None))


def retrieval_index(als_model: ALSModel, retrieval, kind: str = "dot", device=None):
    """The lazily-built, model-cached ``RetrievalIndex`` on ``device``
    for mips mode, or None for scan mode. ``kind="cosine"`` indexes the
    norm-normalized item factors, so similar-items queries run as MIPS
    over unit vectors (sum of anchor cosines == dot with the summed
    normalized anchors). The cache lives on the model object and never
    serializes."""
    if retrieval is None or retrieval.mode != "mips":
        return None
    device = resolve_device(device)
    cache = als_model._retrieval_cache
    if cache is None:
        cache = {}
        als_model._retrieval_cache = cache
    key = (kind, retrieval, str(device))
    index = cache.get(key)
    if index is None:
        if kind == "cosine":
            norms = np.maximum(als_model.item_norms, 1e-12)
            table = als_model.item_factors / norms[:, None]
        else:
            table = als_model.item_factors
        index = RetrievalIndex(table, retrieval, device=device)
        cache[key] = index
    return index


def score_known_user(als_model: ALSModel, user_idx: int, retrieval=None, device=None):
    """One user's item scores: the dense vector (scan) or the stage-2
    ``Shortlist`` (mips), re-ranked on the host."""
    index = retrieval_index(als_model, retrieval, device=device)
    if index is None:
        return als_model.score_items_for_user(user_idx)
    idx, _ = index.search(als_model.user_factors[user_idx][None, :])
    return _host_rerank(als_model, idx[0], user_idx)


def _host_rerank(als_model: ALSModel, short: np.ndarray, user_idx: int) -> Shortlist:
    """Exact scores for one user's shortlist, as the scan path computes
    them: a gathered-row f32 matvec, bitwise equal to
    ``score_items_for_user`` at the shortlisted rows. Sentinel slots stay
    -inf and drop in the format tail."""
    num_items = als_model.item_factors.shape[0]
    in_range = short < num_items
    vals = np.einsum(
        "ik,k->i",
        als_model.item_factors[short[in_range]],
        als_model.user_factors[user_idx],
    )
    scores = np.full(short.shape, -np.inf, vals.dtype)
    scores[in_range] = vals
    return Shortlist(short, scores, num_items)


def similar_item_scores(als_model: ALSModel, anchors: list[int], retrieval=None, device=None):
    """Summed cosine similarity of all items against the anchors: dense
    (scan) or a ``Shortlist`` through the cosine index (mips), whose
    stage-1 query is the sum of the anchors' unit vectors. The shortlist
    re-ranks on the host by replaying the scan's per-anchor arithmetic,
    summed in anchor order."""
    index = retrieval_index(als_model, retrieval, kind="cosine", device=device)
    if index is None:
        sims = None
        for idx in anchors:
            s = als_model.similar_items(idx)
            sims = s if sims is None else sims + s
        return sims
    norms = np.maximum(als_model.item_norms[anchors], 1e-12)
    query = (als_model.item_factors[anchors] / norms[:, None]).sum(axis=0)
    idx, _ = index.search(query[None, :])
    short = idx[0]
    num_items = als_model.item_factors.shape[0]
    in_range = short < num_items
    rows = short[in_range]
    sims = None
    for a in anchors:
        v = als_model.item_factors[a]
        row_norms = als_model.item_norms[rows] * (als_model.item_norms[a] + 1e-12)
        s = np.einsum("ik,k->i", als_model.item_factors[rows], v) / np.maximum(
            row_norms, 1e-12
        )
        sims = s if sims is None else sims + s
    scores = np.full(short.shape, -np.inf, sims.dtype if sims is not None else np.float32)
    if sims is not None:
        scores[in_range] = sims
    return Shortlist(short, scores, num_items)


def batch_score_known_users(
    als_model: ALSModel, user_rows, respond, *, retrieval=None, device=None
) -> list:
    """Score known users in bounded slices; ``respond(scores_row, qid,
    query, user_idx)`` builds each response. Mips mode runs one device
    search per slice and hands ``respond`` a host re-ranked ``Shortlist``
    per row (the single-query matvec shape, so batched responses stay
    bitwise equal to unbatched ones)."""
    out = []
    index = retrieval_index(als_model, retrieval, device=device)
    if index is not None:
        rows_per_slice = score_buffer_rows(index.config.shortlist)
        for start in range(0, len(user_rows), rows_per_slice):
            part = user_rows[start : start + rows_per_slice]
            idxs = np.fromiter((u for _, _, u in part), dtype=np.int64)
            short_idx, _ = index.search(als_model.user_factors[idxs])
            out.extend(
                respond(
                    _host_rerank(als_model, short_idx[row], user_idx),
                    qid, q, user_idx,
                )
                for row, (qid, q, user_idx) in enumerate(part)
            )
        return out
    rows_per_slice = score_buffer_rows(als_model.item_factors.shape[0])
    for start in range(0, len(user_rows), rows_per_slice):
        part = user_rows[start : start + rows_per_slice]
        idxs = np.fromiter((u for _, _, u in part), dtype=np.int64)
        # einsum, not sgemm: the per-row reduction keeps every scoring
        # path (scan/mips, batched/unbatched) bitwise equal
        scores = np.einsum(
            "bk,ik->bi", als_model.user_factors[idxs], als_model.item_factors
        )
        out.extend(
            respond(scores[row], qid, q, user_idx)
            for row, (qid, q, user_idx) in enumerate(part)
        )
    return out


def topk_order(scores: np.ndarray, num: int) -> np.ndarray:
    """Indices of the top-``num`` scores, descending, ties by ascending
    position -- a pure function of the (score, position) multiset.

    O(items) argpartition + O(num log num) sort; threshold ties are
    re-selected by position explicitly so a dense vector and a mips
    ``Shortlist`` holding the same values order identically. NaN/-inf
    sentinels rank after every finite score."""
    n = scores.shape[0]
    if 0 < num < n:
        cand = np.argpartition(-scores, num - 1)[:num]
        vals = scores[cand]
        if not np.isnan(vals).any():
            t = vals.min()
            head = np.flatnonzero(scores > t)
            # lowest positions among scores == t fill the remaining slots
            ties = np.flatnonzero(scores == t)[: num - head.size]
            cand = np.concatenate([head, ties])
            return cand[np.lexsort((cand, -scores[cand]))]
        # NaN reached the top slice: fall through to the full stable sort
    return np.argsort(-scores, kind="stable")[:num]


def topk_item_scores(item_ids: list[str], scores, num: int) -> dict:
    """Rank + format tail shared by every response: descending
    top-``num``, excluded entries carried as -inf and dropped here. A
    ``Shortlist`` ranks over its compact arrays with the same
    ``topk_order``."""
    if isinstance(scores, Shortlist):
        order = topk_order(scores.scores, num)
        finite = np.isfinite(scores.scores[order])
        return {
            "itemScores": [
                {"item": item_ids[int(scores.indices[j])],
                 "score": float(scores.scores[j])}
                for j, ok in zip(order, finite)
                if ok
            ]
        }
    order = topk_order(scores, num)
    finite = np.isfinite(scores[order])
    return {
        "itemScores": [
            {"item": item_ids[j], "score": float(scores[j])}
            for j, ok in zip(order, finite)
            if ok
        ]
    }
