"""The sharded host-side event reader, in one process or across several.

Port of ``predictionio_tpu/parallel/reader.py``. The default ALS pack
(``build_als_data``) holds the whole edge set in host arrays; this module
is the scaling path the templates' ``"reader": "streaming"`` takes:

1. the chunk sources (``store_coo_chunks`` over a backend's chunked
   ``iter_interaction_chunks`` scan, ``snapshot_coo_chunks`` over a
   training snapshot's memmap columns, ``array_coo_chunks`` over arrays,
   and their per-event-type twins) replay the same deterministically
   ordered COO stream on every pass, one chunk of host memory at a time,
   the encoders stable across passes;
2. pass 1 counts interactions per entity; both sides' bucket plans follow
   from the counts alone;
3. pass 2 retains the edges of this process's rows and packs them into
   the same blocks ``build_als_data`` builds (``build_als_data_sharded``),
   or into the user-rows CSR of the cooccurrence templates
   (``build_cooc_csr_sharded``, ``ShardedPaddedCSR``);
4. ``snapshot_streamed_als_data`` packs a snapshot into the on-disk block
   store of ``parallel.stream``, under the snapshot generation's
   ``blocks/`` directory by default, for ``als_fit_streamed``.

Over a ``parallel.mesh.Mesh`` of ``torch.distributed`` ranks every rank
scans the same stream and derives the same plans; each retains only its
``data``-axis shard of each bucket (``_local_row_range``: rank ``i`` of
``d`` keeps rows ``[i * n / d, (i + 1) * n / d)``), and ``als_fit``
takes the blocks as that rank's rows. ``mesh=None`` is one process: its
rows are all rows. The cooccurrence CSR shards its user rows the same
way, and ``distinct_user_counts_sharded`` sums the per-item counts over
the data axis. ``snapshot_streamed_als_data`` packs the block store once
for the mesh (rank 0 first; the others then find it built) with the
mesh's shard counts. The chunk sources, the encoders and
``ShardedPaddedCSR`` are copies (``tests/test_torch_imports.py`` holds
them to the originals).
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator

import numpy as np

from predictionio_tpu_torch.ops.ragged import pack_padded_csr, round_up
from predictionio_tpu_torch.parallel.als import (
    ALSConfig,
    ALSData,
    BucketedCSR,
    _BucketPlan,
    _plan_buckets,
)
from predictionio_tpu_torch.parallel.mesh import all_reduce_sum, barrier

#: a chunk is (users, items, values, times-or-None), integer-encoded
Chunk = tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray | None]
#: zero-arg callable producing a fresh pass over the stream
ChunkSource = Callable[[], Iterable[Chunk]]


class IncrementalEncoder:
    """First-appearance string->int vocabulary, stable across passes.

    Every process consumes the same ordered stream, so ids agree across
    processes AND across the two passes (setdefault is idempotent).
    """

    def __init__(self) -> None:
        self.vocab: dict[str, int] = {}

    def encode(self, values) -> np.ndarray:
        v = self.vocab
        return np.fromiter(
            (v.setdefault(x, len(v)) for x in values),
            dtype=np.int64,
            count=len(values),
        )

    @property
    def ids(self) -> list[str]:
        return list(self.vocab)


def store_coo_chunks(
    l_events,
    app_id: int,
    channel_id: int | None = None,
    event_names: list[str] | None = None,
    rating_key: str = "rating",
    chunk_rows: int = 262_144,
    default_value: float = 1.0,
    event_values: dict[str, float] | None = None,
    until_time: _dt.datetime | None = None,
) -> tuple[ChunkSource, IncrementalEncoder, IncrementalEncoder]:
    """COO chunk source over a backend's columnar chunked scan.

    Returns ``(source, user_encoder, item_encoder)``; the encoders fill in
    stream order during the first pass and are the id<->index mapping the
    serving model needs. Rows with no numeric rating carry
    ``default_value`` (implicit-feedback events like "view"/"buy").
    ``event_values`` maps EVENT TYPE -> value instead (the e-commerce
    buy-weighted confidence scheme), ignoring per-row ratings entirely.
    Requires the backend to expose ``iter_interaction_chunks`` (the SQL
    family does); others can stream through any adapter that yields the
    same five columns.

    ``until_time`` bounds every pass to an identical event prefix. The
    event server accepts writes DURING ``pio train``, so without a bound
    pass 2 can see entities pass 1 never counted (an ``IndexError`` deep
    in the slot map), and in multi-host, processes scanning at different
    wall times would derive divergent layouts. Callers capture it once
    when the training handle is created and thread it through.
    """
    users_enc, items_enc = IncrementalEncoder(), IncrementalEncoder()

    def source() -> Iterator[Chunk]:
        for ents, tgts, names, times_iso, ratings in l_events.iter_interaction_chunks(
            app_id=app_id,
            channel_id=channel_id,
            event_names=event_names,
            rating_key=rating_key,
            chunk_rows=chunk_rows,
            until_time=until_time,
        ):
            keep = [i for i, t in enumerate(tgts) if t is not None]
            uu = users_enc.encode([ents[i] for i in keep])
            ii = items_enc.encode([tgts[i] for i in keep])
            def value_of(i):
                if event_values is not None:
                    return event_values.get(names[i], default_value)
                return default_value if ratings[i] is None else float(ratings[i])

            vals = np.fromiter(
                (value_of(i) for i in keep), dtype=np.float32, count=len(keep)
            )
            tt = np.fromiter(
                (
                    _dt.datetime.fromisoformat(times_iso[i]).timestamp()
                    for i in keep
                ),
                dtype=np.float64,
                count=len(keep),
            )
            yield uu, ii, vals, tt

    return source, users_enc, items_enc


def store_multi_event_chunks(
    l_events,
    app_id: int,
    event_names: list[str],
    channel_id: int | None = None,
    rating_key: str = "rating",
    chunk_rows: int = 262_144,
    default_value: float = 1.0,
    until_time: _dt.datetime | None = None,
) -> tuple[dict[str, ChunkSource], IncrementalEncoder, IncrementalEncoder]:
    """Per-event-type COO chunk sources over ONE shared entity universe.

    The Universal Recommender's cross-occurrence needs every event type's
    CSR row-indexed by the same user universe. Each returned source
    replays the SAME full multi-type scan and encodes EVERY row through
    the shared encoders (so ids are identical no matter which type's
    source runs first, or how often), emitting only its own type's rows.
    A per-type two-pass build therefore costs 2 * len(event_names) scans
    -- streaming-bounded memory is the trade. ``until_time`` bounds every
    scan to one identical prefix (see ``store_coo_chunks``): with
    2 * len(event_names) passes the mid-train-write window is widest here.
    """
    users_enc, items_enc = IncrementalEncoder(), IncrementalEncoder()

    def source_for(wanted: str) -> ChunkSource:
        def source() -> Iterator[Chunk]:
            for ents, tgts, names, times_iso, _ratings in (
                l_events.iter_interaction_chunks(
                    app_id=app_id,
                    channel_id=channel_id,
                    event_names=event_names,
                    rating_key=rating_key,
                    chunk_rows=chunk_rows,
                    until_time=until_time,
                )
            ):
                keep = [k for k, t in enumerate(tgts) if t is not None]
                uu = users_enc.encode([ents[k] for k in keep])
                ii = items_enc.encode([tgts[k] for k in keep])
                sel = np.fromiter(
                    (names[k] == wanted for k in keep),
                    dtype=bool,
                    count=len(keep),
                )
                if not sel.any():
                    continue
                tt = np.fromiter(
                    (
                        _dt.datetime.fromisoformat(times_iso[k]).timestamp()
                        for k, s in zip(keep, sel)
                        if s
                    ),
                    dtype=np.float64,
                    count=int(sel.sum()),
                )
                yield (
                    uu[sel], ii[sel],
                    np.full(int(sel.sum()), default_value, np.float32),
                    tt,
                )

        return source

    return {n: source_for(n) for n in event_names}, users_enc, items_enc


def _kept_user_remap(snapshot) -> tuple[np.ndarray, list[str]]:
    """Remap snapshot user codes to the ids the LIVE scan would assign.

    The snapshot encodes users by first appearance over ALL rows (the
    ``EventDataset`` contract); the COO readers encode by first appearance
    over rows WITH a target entity only. A user appearing first in a
    targetless row would get a different id, so replay re-derives the
    kept-rows-only first-appearance order vectorially and the streamed
    and snapshot-served builds stay bit-identical.
    Returns ``(remap, kept_vocab)`` with ``remap[old_code] -> new id``
    (-1 for users never kept).
    """
    kept_users = np.asarray(snapshot.column("users"))[
        np.asarray(snapshot.column("items")) >= 0
    ]
    uniq, first_idx = np.unique(kept_users, return_index=True)
    old_in_order = uniq[np.argsort(first_idx, kind="stable")]
    full_vocab = snapshot.vocab("users")
    remap = np.full(len(full_vocab), -1, dtype=np.int64)
    remap[old_in_order] = np.arange(old_in_order.size)
    return remap, [full_vocab[int(o)] for o in old_in_order]


def _prefilled(vocab: list[str]) -> IncrementalEncoder:
    enc = IncrementalEncoder()
    enc.vocab = {v: j for j, v in enumerate(vocab)}
    return enc


def snapshot_coo_chunks(
    snapshot,
    chunk_rows: int = 262_144,
    default_value: float = 1.0,
    event_values: dict[str, float] | None = None,
) -> tuple[ChunkSource, IncrementalEncoder, IncrementalEncoder]:
    """``store_coo_chunks``, served from a columnar snapshot's memmaps.

    Same contract, zero SQL: every pass replays the spilled column files
    with vectorized decode (value mapping via array lookup instead of a
    per-row python loop), and the returned encoders come back PRE-FILLED
    with the exact vocabularies the live scan would have produced --
    chunks, ids, values, and times are bit-identical to the streamed
    build over the same bounded prefix.
    """
    import time as _time

    from predictionio_tpu_torch.data.snapshot import record_replay_seconds

    remap, kept_users = _kept_user_remap(snapshot)
    users_enc = _prefilled(kept_users)
    items_enc = _prefilled(snapshot.vocab("items"))
    if event_values is not None:
        name_vals = np.fromiter(
            (
                event_values.get(nm, default_value)
                for nm in snapshot.vocab("names")
            ),
            dtype=np.float32,
            count=len(snapshot.vocab("names")),
        )

    def source() -> Iterator[Chunk]:
        t0 = _time.perf_counter()
        for uu_raw, ii_raw, nn_raw, tt_raw, rr_raw in snapshot.chunks(chunk_rows):
            sel = ii_raw >= 0
            uu = remap[uu_raw[sel]]
            ii = ii_raw[sel]
            if event_values is not None:
                vals = name_vals[nn_raw[sel]]
            else:
                rr = rr_raw[sel]
                vals = np.where(np.isnan(rr), default_value, rr).astype(
                    np.float32
                )
            yield uu, ii, vals, tt_raw[sel]
        record_replay_seconds(_time.perf_counter() - t0)

    return source, users_enc, items_enc


def snapshot_multi_event_chunks(
    snapshot,
    event_names: list[str],
    chunk_rows: int = 262_144,
    default_value: float = 1.0,
) -> tuple[dict[str, ChunkSource], IncrementalEncoder, IncrementalEncoder]:
    """``store_multi_event_chunks``, served from a snapshot's memmaps.

    The shared entity universe comes back pre-filled (it is fixed by the
    spilled stream), so the ``universe_pass`` priming scan and all
    2 * len(event_names) per-type SQL scans collapse into cheap memmap
    replays.
    """
    import time as _time

    from predictionio_tpu_torch.data.snapshot import record_replay_seconds

    remap, kept_users = _kept_user_remap(snapshot)
    users_enc = _prefilled(kept_users)
    items_enc = _prefilled(snapshot.vocab("items"))
    code_of = {nm: c for c, nm in enumerate(snapshot.vocab("names"))}

    def source_for(wanted: str) -> ChunkSource:
        code = code_of.get(wanted, -1)

        def source() -> Iterator[Chunk]:
            t0 = _time.perf_counter()
            for uu_raw, ii_raw, nn_raw, tt_raw, _rr in snapshot.chunks(
                chunk_rows
            ):
                sel = (ii_raw >= 0) & (nn_raw == code)
                if not sel.any():
                    continue
                yield (
                    remap[uu_raw[sel]],
                    ii_raw[sel],
                    np.full(int(sel.sum()), default_value, np.float32),
                    tt_raw[sel],
                )
            record_replay_seconds(_time.perf_counter() - t0)

        return source

    return {n: source_for(n) for n in event_names}, users_enc, items_enc


def snapshot_streamed_als_data(
    snapshot,
    config: ALSConfig,
    cache_dir: str | None = None,
    mesh=None,
    model_shards: int = 1,
    chunk_rows: int = 262_144,
    default_value: float = 1.0,
    event_values: dict[str, float] | None = None,
    block_rows: int | None = None,
    block_bytes: int | None = None,
) -> tuple[IncrementalEncoder, IncrementalEncoder, object]:
    """The streamed-epoch block store, packed straight from a columnar
    snapshot: both build passes (counts, spill) replay the snapshot's
    memmaps, and the blocks land under the snapshot generation's
    directory by default (``data.snapshot.snapshot_block_dir``), so the
    snapshot's GC reaps a stale block cache with its generation. Returns
    ``(users_enc, items_enc, StreamedALSData)`` with the encoders
    pre-filled as ``snapshot_coo_chunks`` fills them; feed the data to
    ``parallel.als.als_fit_streamed``. Over a ``mesh`` the store is laid
    out for its data axis and ``model_shards``; the mesh's rank 0 builds
    it, and the other ranks, past a barrier, load it (a rank on another
    host builds its own identical copy)."""
    from predictionio_tpu_torch.data.snapshot import snapshot_block_dir
    from predictionio_tpu_torch.parallel.stream import (
        DEFAULT_BLOCK_BYTES,
        build_streamed_als_data,
    )

    source, users_enc, items_enc = snapshot_coo_chunks(
        snapshot, chunk_rows, default_value, event_values
    )

    def build():
        return build_streamed_als_data(
            source,
            len(users_enc.vocab),
            len(items_enc.vocab),
            config,
            cache_dir or snapshot_block_dir(snapshot),
            num_shards=int(mesh.shape["data"]) if mesh is not None else 1,
            model_shards=model_shards,
            block_rows=block_rows,
            block_bytes=block_bytes or DEFAULT_BLOCK_BYTES,
        )

    if mesh is None or mesh.size == 1:
        return users_enc, items_enc, build()
    data = build() if mesh.rank == 0 else None
    barrier(mesh)
    return users_enc, items_enc, data if data is not None else build()


def universe_pass(sources: dict[str, ChunkSource]) -> None:
    """Drive one full scan through the shared encoders so the entity
    universe (len(encoder.ids)) is known before any per-type build.

    Any single source suffices: every source encodes ALL types' rows
    through the shared encoders regardless of which type it emits.
    """
    for _ in next(iter(sources.values()))():
        pass


def _local_row_range(mesh, nrows: int) -> tuple[int, int]:
    """This process's contiguous ``[lo, hi)`` slice of a dimension
    row-sharded over the mesh's ``data`` axis (the reference reads it off
    the sharding; a rank here is one device): ``None`` holds every row."""
    if mesh is None:
        return 0, nrows
    d, i = int(mesh.shape["data"]), mesh.axis_index("data")
    if nrows % d:
        raise ValueError(f"{nrows} rows do not shard over the {d}-way data axis")
    per = nrows // d
    return i * per, (i + 1) * per


@dataclass
class _SideAccumulator:
    """Pass-2 retention state for one orientation."""

    plan: _BucketPlan
    ranges: list[tuple[int, int]]  # local [lo, hi) per bucket, global slots
    rows: list[list[np.ndarray]]
    cols: list[list[np.ndarray]]
    vals: list[list[np.ndarray]]
    times: list[list[np.ndarray]]
    retained: int = 0

    def take(self, row_slots, col_slots, vals, times) -> None:
        for b, (lo, hi) in enumerate(self.ranges):
            off = self.plan.offsets[b]
            sel = (row_slots >= off + lo) & (row_slots < off + hi)
            if not sel.any():
                continue
            self.rows[b].append(row_slots[sel] - off - lo)
            self.cols[b].append(col_slots[sel])
            self.vals[b].append(vals[sel])
            if times is not None:
                self.times[b].append(times[sel])
            self.retained += int(sel.sum())


def _grow_bincount(cnt: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Accumulate a bincount whose extent grows with the observed ids."""
    if ids.size == 0:
        return cnt
    add = np.bincount(ids, minlength=cnt.size)
    if add.size > cnt.size:
        cnt = np.pad(cnt, (0, add.size - cnt.size))
        return cnt + add
    cnt[: add.size] += add
    return cnt


def build_als_data_sharded(
    chunks: ChunkSource,
    num_users: int | None,
    num_items: int | None,
    config: ALSConfig,
    mesh=None,
    model_shards: int = 1,
) -> ALSData:
    """Two-pass, retention-bounded ALSData for ``mesh`` (None: one
    process, whose rows are all rows).

    Equivalent layout to ``build_als_data(..., num_shards=data axis,
    model_shards)`` (same bucket plans, same slot maps, same padded
    lengths) but each process keeps only the edges its data-axis shard
    needs, per side. Feed the result straight to ``als_fit`` with the
    same mesh; ``global_rows`` holds each bucket's global padded row
    count, of which each block is this rank's share.

    ``num_users``/``num_items`` may be None: the store-backed path cannot
    know the distinct-entity counts before the first scan (the encoders
    fill in during it), so pass 1 grows the count arrays with the stream
    and the entity universe becomes whatever the stream contained. When
    given, they are lower-bounded by the stream (ids beyond them grow the
    arrays rather than crashing the bincount).
    """
    d = int(mesh.shape["data"]) if mesh is not None else 1
    rm = 8 * d * max(model_shards, 1)
    nb = max(int(config.buckets), 1)

    # -- pass 1: per-entity counts (O(entities) memory) --------------------
    cnt_u = np.zeros(num_users or 0, dtype=np.int64)
    cnt_i = np.zeros(num_items or 0, dtype=np.int64)
    for uu, ii, _vv, _tt in chunks():
        cnt_u = _grow_bincount(cnt_u, uu)
        cnt_i = _grow_bincount(cnt_i, ii)
    plan_u = _plan_buckets(cnt_u, config.max_len, nb, rm)
    plan_i = _plan_buckets(cnt_i, config.max_len, nb, rm)

    def side_acc(plan: _BucketPlan) -> _SideAccumulator:
        ranges = [
            _local_row_range(mesh, rows) for rows in plan.padded_rows
        ]
        k = len(plan.sizes)
        return _SideAccumulator(
            plan=plan,
            ranges=ranges,
            rows=[[] for _ in range(k)],
            cols=[[] for _ in range(k)],
            vals=[[] for _ in range(k)],
            times=[[] for _ in range(k)],
        )

    acc_u = side_acc(plan_u)
    acc_i = side_acc(plan_i)

    # -- pass 2: retain this process's rows only ---------------------------
    for uu, ii, vv, tt in chunks():
        u_slots = plan_u.slot_of[uu]
        i_slots = plan_i.slot_of[ii]
        acc_u.take(u_slots, i_slots, vv, tt)
        acc_i.take(i_slots, u_slots, vv, tt)

    def pack_side(acc: _SideAccumulator, opp_plan: _BucketPlan) -> BucketedCSR:
        blocks = []
        for b, (lo, hi) in enumerate(acc.ranges):
            cat = lambda parts, dt: (
                np.concatenate(parts) if parts else np.empty(0, dt)
            )
            times_b = cat(acc.times[b], np.float64) if acc.times[b] else None
            blocks.append(
                pack_padded_csr(
                    cat(acc.rows[b], np.int64),
                    cat(acc.cols[b], np.int64),
                    cat(acc.vals[b], np.float32),
                    num_rows=hi - lo,
                    num_cols=opp_plan.total_slots,
                    max_len=config.max_len,
                    times=times_b,
                    row_multiple=8,
                    pad_len=acc.plan.lengths[b],
                )
            )
        return BucketedCSR(
            blocks=tuple(blocks),
            slot_of=acc.plan.slot_of,
            num_rows=int(acc.plan.slot_of.shape[0]),
            total_slots=acc.plan.total_slots,
            global_rows=tuple(acc.plan.padded_rows),
            retained_edges=acc.retained,
        )

    return ALSData(
        by_row=pack_side(acc_u, plan_i), by_col=pack_side(acc_i, plan_u)
    )


@dataclass
class ShardedPaddedCSR:
    """Process-local slice of a row-sharded PaddedCSR (+ global extent).

    The cooccurrence analogue of the bucketed ALS reader output: ``local``
    holds ONLY this process's user rows ``[row_lo, row_hi)`` of a global
    ``[global_rows, L]`` layout (plain user-id row order -- cooccurrence
    needs no length bucketing), and the ops layer assembles the device
    array via make_array_from_process_local_data. Duck-types the
    ``num_rows``/``num_cols`` surface the cooccurrence entry points check.
    """

    local: PaddedCSR
    global_rows: int
    row_lo: int
    row_hi: int
    num_rows: int   # real (global) user rows
    num_cols: int
    retained_edges: int
    #: GLOBAL edge count from the counts pass (identical on every
    #: process). Emptiness decisions MUST use this, never retained_edges:
    #: a per-process test diverges SPMD control flow around the
    #: collectives when one process's shard happens to hold no edges.
    global_edges: int = 0

    @property
    def max_len(self) -> int:
        return self.local.indices.shape[1]


def cooc_global_rows(num_users: int, mesh, chunk: int) -> int:
    """The global padded row count of the sharded cooccurrence layout:
    ``ops.cooccurrence``'s chunking, where each rank scans the same
    number of ``chunk``-row blocks, so rows = data * ceil(per_device /
    chunk_eff) * chunk_eff (``mesh`` None: data = 1). Builder and runner
    must agree, so this is THE shared definition."""
    data_size = int(mesh.shape["data"]) if mesh is not None else 1
    phys = max(round_up(num_users, 8), 8)
    per_device = -(-phys // data_size)
    chunk_eff = max(1, min(chunk, per_device))
    return data_size * (-(-per_device // chunk_eff)) * chunk_eff


def build_cooc_csr_sharded(
    chunks: ChunkSource,
    num_users: int | None,
    num_items: int | None,
    mesh=None,
    max_len: int | None = None,
    chunk: int = 4096,
) -> ShardedPaddedCSR:
    """Retention-bounded user-rows CSR for the cooccurrence/UR pipeline.

    Two passes like ``build_als_data_sharded``: counts first (so every
    process derives the same padded length), then retain only the edges
    whose user row falls in this process's data-axis shard. ``chunk``
    must match the ``chunk`` later passed to the cooccurrence entry
    points (it shapes the global row padding; the runner validates).
    """
    cnt_u = np.zeros(num_users or 0, dtype=np.int64)
    n_items = num_items or 0
    for uu, ii, _vv, _tt in chunks():
        cnt_u = _grow_bincount(cnt_u, uu)
        if ii.size:
            n_items = max(n_items, int(ii.max()) + 1)
    n_users = cnt_u.size
    if n_users == 0:
        raise ValueError(
            "no interactions in the stream and no entity counts given -- "
            "check appName/eventNames (an empty event store cannot build "
            "a cooccurrence model)"
        )
    capped = int(min(cnt_u.max(), max_len)) if max_len else int(cnt_u.max())
    pad_len = max(round_up(capped, 8), 8)

    rows = cooc_global_rows(n_users, mesh, chunk)
    lo, hi = _local_row_range(mesh, rows)

    keep_r: list[np.ndarray] = []
    keep_c: list[np.ndarray] = []
    keep_v: list[np.ndarray] = []
    keep_t: list[np.ndarray] = []
    retained = 0
    for uu, ii, vv, tt in chunks():
        sel = (uu >= lo) & (uu < hi)
        if not sel.any():
            continue
        keep_r.append(uu[sel] - lo)
        keep_c.append(ii[sel])
        keep_v.append(vv[sel])
        if tt is not None:
            keep_t.append(tt[sel])
        retained += int(sel.sum())

    cat = lambda parts, dt: np.concatenate(parts) if parts else np.empty(0, dt)
    local = pack_padded_csr(
        cat(keep_r, np.int64),
        cat(keep_c, np.int64),
        cat(keep_v, np.float32),
        num_rows=hi - lo,
        num_cols=n_items,
        max_len=max_len,
        times=cat(keep_t, np.float64) if keep_t else None,
        # the local block matches the shard span EXACTLY (the cooc
        # layout's chunk-based spans are not 8-aligned)
        row_multiple=1,
        pad_len=pad_len,
    )
    return ShardedPaddedCSR(
        local=local,
        global_rows=rows,
        row_lo=lo,
        row_hi=hi,
        num_rows=n_users,
        num_cols=n_items,
        retained_edges=retained,
        global_edges=int(cnt_u.sum()),
    )


def distinct_user_counts_sharded(s: ShardedPaddedCSR, mesh=None) -> np.ndarray:
    """Global per-item distinct-user counts from process-local rows.
    User rows partition over the mesh's data axis, so the counts are
    additive: the local counts summed over ``data`` reproduce
    ``ops.cooccurrence.distinct_user_counts`` of the global CSR exactly
    (``mesh`` None: the local counts are the global ones)."""
    import torch

    from predictionio_tpu_torch.ops.cooccurrence import distinct_user_counts

    local = distinct_user_counts(s.local)
    if mesh is None or mesh.axis_size("data") == 1:
        return local
    total = all_reduce_sum(mesh, ("data",), torch.from_numpy(local.astype(np.float64)))
    return total.numpy().astype(np.float32)


def array_coo_chunks(
    users: np.ndarray,
    items: np.ndarray,
    values: np.ndarray,
    times: np.ndarray | None = None,
    chunk_rows: int = 262_144,
) -> ChunkSource:
    """ChunkSource over in-memory COO arrays (tests / already-loaded data)."""

    def source() -> Iterator[Chunk]:
        for lo in range(0, len(users), chunk_rows):
            hi = lo + chunk_rows
            yield (
                np.asarray(users[lo:hi], np.int64),
                np.asarray(items[lo:hi], np.int64),
                np.asarray(values[lo:hi], np.float32),
                None if times is None else np.asarray(times[lo:hi], np.float64),
            )

    return source
