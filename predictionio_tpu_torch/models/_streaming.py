"""The templates' streaming reader: the scan descriptor, its sources and
the serving-time live event-store lookups.

Port of ``predictionio_tpu/models/_streaming.py``:

- ``StreamingHandle``, ``build_streaming_handle`` and
  ``streaming_handle_or_none`` (``:23-117``): where and what a template
  scans (app, channel, event names, rating key), pinned at an exclusive
  ``until_time``. ``streaming_handle_or_none`` is the DataSources' opt-in
  gate (``"reader": "streaming"``); ``DataSource.online_handle`` builds
  one for the continuous-learning loop (``online/loop.py``), which keys
  its snapshot and WAL filter on it.
- ``live_target_events`` and ``live_seen_indices`` (``:118-169``): a
  query reads the user's item-target events from the store (through
  ``LEventStore``), so events ingested after training filter at once
  and the model stays O(entities). They serve ``seenFilter: "live"``
  (ALS, NCF, e-commerce) and ``historyMode: "live"`` (SASRec), and the
  streamed models' user histories.
- ``:172-427``: the handle's chunk sources (``streaming_coo_source``,
  ``streaming_multi_event_sources``: a training snapshot's memmap replay
  under ``--snapshot-mode use|refresh``, else the bounded store scan),
  ``snapshot_ratings_arrays``, the ALS feed (``resolve_als_feed``:
  ``pio train --als-feed`` over the preparator's ``alsFeed``) and the
  shared ALS build (``build_streaming_als``, which packs for the
  training mesh). In a multi-process launch every rank adopts rank 0's
  scan bound (``_agree_until_time``), rank 0 readies the training
  snapshot before the others load it, and all ranks read the snapshot
  or all scan the store (``_snapshot_for_handle``); a failed agreement
  fails the run.
"""

from __future__ import annotations

import datetime as _dt
import logging
from dataclasses import dataclass, field

from predictionio_tpu_torch.controller.base import SanityCheck

logger = logging.getLogger("pio.streaming")

@dataclass
class StreamingHandle(SanityCheck):
    """Lazy training handle: no arrays, just where/what to stream."""

    app_name: str
    app_id: int
    channel_id: int | None
    channel_name: str | None
    event_names: list[str]
    rating_key: str = "rating"
    chunk_rows: int = 262_144
    #: events whose absence means "no data"; None probes all of event_names
    probe_event_names: list[str] | None = None
    empty_message: str = "no events found -- check appName and eventNames"
    #: template-specific DATASOURCE knobs the preparator/algorithm need:
    #: DASE keeps per-component params separate, so values configured on
    #: the datasource ride the handle
    extras: dict = field(default_factory=dict)
    #: EXCLUSIVE scan bound captured when the handle is created; also the
    #: snapshot layer's coverage boundary
    until_time: _dt.datetime = field(
        default_factory=lambda: _dt.datetime.now(_dt.timezone.utc)
    )

    def sanity_check(self) -> None:
        from predictionio_tpu_torch.data import storage

        probe = list(
            storage.get_l_events().find(
                app_id=self.app_id,
                channel_id=self.channel_id,
                event_names=self.probe_event_names or self.event_names,
                limit=1,
            )
        )
        if not probe:
            raise ValueError(self.empty_message)


def build_streaming_handle(
    params,
    default_event_names: list[str],
    probe_primary_only: bool = False,
    empty_message: str | None = None,
) -> StreamingHandle:
    """Build the scan descriptor a datasource's params pin down --
    unconditionally. The continuous-learning loop
    (``DataSource.online_handle``) builds one regardless of the reader
    opt-in, because the handle is also the identity of the snapshot the
    loop refreshes and the WAL filter it follows."""
    from predictionio_tpu_torch.data.store import resolve_app_channel

    event_names = params.get_or("eventNames", default_event_names)
    app_id, channel_id = resolve_app_channel(
        params.appName, params.get_or("channelName", None)
    )
    return StreamingHandle(
        app_name=params.appName,
        app_id=app_id,
        channel_id=channel_id,
        channel_name=params.get_or("channelName", None),
        event_names=list(event_names),
        rating_key=params.get_or("ratingKey", "rating"),
        chunk_rows=params.get_or("chunkRows", 262_144),
        probe_event_names=[event_names[0]] if probe_primary_only else None,
        empty_message=empty_message
        or "no events found -- check appName and eventNames",
    )


def streaming_handle_or_none(
    params,
    default_event_names: list[str],
    probe_primary_only: bool = False,
    empty_message: str | None = None,
) -> StreamingHandle | None:
    """The shared ``read_training`` branch: a StreamingHandle when the
    datasource params opt in (``"reader": "streaming"``), else None."""
    if params.get_or("reader", "materialized") != "streaming":
        return None
    return build_streaming_handle(
        params, default_event_names, probe_primary_only, empty_message
    )


def refuse_streaming_file(params, events_path: str | None) -> None:
    """A DataSource reading a JSON-lines events file (``pio train
    --events``) has no chunked store scan to stream, so it refuses
    ``"reader": "streaming"`` with ``ValueError``."""
    if events_path is not None and params.get_or("reader", "materialized") == "streaming":
        raise ValueError(
            '"reader": "streaming" streams the event store\'s chunked scan; an '
            "events file is read whole. `pio import` it and train from the "
            'store, or leave "reader" out'
        )


def live_target_events(model, user: str) -> list:
    """The query user's item-target events, read live from the store.

    Reads the model's ``app_name``/``channel_name``/``event_names``
    (getattr-safe: pickled models may predate the fields). Degrades to an
    empty list -- with one warning -- on any store error: serving must
    not 500 because a backend blinked. An unresolvable app short-circuits
    without a per-request failing lookup.
    """
    app_name = getattr(model, "app_name", "")
    if not user or not app_name:
        return []
    from predictionio_tpu_torch.data.store import LEventStore

    try:
        return list(
            LEventStore.find(
                app_name,
                entity_type="user",
                entity_id=user,
                channel_name=getattr(model, "channel_name", None),
                event_names=getattr(model, "event_names", None) or None,
                target_entity_type="item",
            )
        )
    except Exception:
        logger.warning(
            "live history lookup failed; serving without user history",
            exc_info=True,
        )
        return []


def live_seen_indices(model, user: str, cache: dict | None = None) -> set[int]:
    """The user's already-interacted item indices, read live.

    THE live seen-lookup (recommendation, NCF, and e-commerce all filter
    through it): item ids map through ``model.item_index``; ``cache``
    memoizes per user for bulk paths. Store errors degrade inside
    live_target_events.
    """
    key = user
    if cache is not None and key in cache:
        return cache[key]
    out = {
        model.item_index[e.target_entity_id]
        for e in live_target_events(model, user)
        if e.target_entity_id in model.item_index
    }
    if cache is not None:
        cache[key] = out
    return out


def _agree_until_time(handle: StreamingHandle) -> None:
    """Multi-process launches: adopt rank 0's captured scan bound
    (reference ``:172-210``).

    Each process captures ``until_time`` at its own handle creation, so
    wall-clock skew between launches would bound their scans differently
    -- exactly the divergent-layout bug the bound exists to kill. The
    bound is broadcast as integer microseconds and reconstructed with
    integer arithmetic, so every process derives a bit-identical datetime
    (and therefore an identical ``event_time_ms`` cutoff). Unlike the
    reference, a failed broadcast raises: ranks scanning different
    prefixes would train different layouts."""
    from predictionio_tpu_torch.parallel.mesh import broadcast_int, world_mesh

    until = getattr(handle, "until_time", None)
    world = world_mesh()
    if until is None or world.size == 1:
        return
    agreed_us = broadcast_int(world, int(until.timestamp() * 1e6))
    # EVERY rank adopts the reconstructed value -- rank 0 included:
    # int(timestamp()*1e6) can truncate 1us below the original datetime
    handle.until_time = _dt.datetime.fromtimestamp(
        agreed_us // 10**6, tz=_dt.timezone.utc
    ) + _dt.timedelta(microseconds=agreed_us % 10**6)


def _snapshot_for_handle(handle: StreamingHandle, runtime_conf):
    """The handle's ready training snapshot, or None (mode off, backend
    without the columnar scan, or any snapshot-layer failure -- training
    must degrade to the direct scan, never die on a cache).

    In a multi-process launch rank 0 readies the snapshot (``refresh``
    builds a generation once), then the others load it (``use``), and
    the snapshot serves only if it served every rank: the ranks must read
    one stream, not some the snapshot and some the store."""
    from predictionio_tpu_torch.parallel.mesh import all_reduce_min, barrier, world_mesh

    world = world_mesh()
    if world.size == 1:
        return _ensure_snapshot(handle, runtime_conf)
    snap = _ensure_snapshot(handle, runtime_conf) if world.rank == 0 else None
    barrier(world)  # rank 0's snapshot is ready before the others look
    if world.rank != 0:
        from predictionio_tpu_torch.data.snapshot import snapshot_settings

        conf = dict(runtime_conf or {})
        if snapshot_settings(conf)[0] == "refresh":
            conf["pio.snapshot_mode"] = "use"
        snap = _ensure_snapshot(handle, conf)
    return snap if all_reduce_min(world, snap is not None) else None


def _ensure_snapshot(handle: StreamingHandle, runtime_conf):
    """One process's ``SnapshotStore.ensure`` for the handle, or None."""
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.data.snapshot import (
        SnapshotSpec,
        SnapshotStore,
        snapshot_settings,
    )

    mode, root = snapshot_settings(runtime_conf)
    if mode == "off":
        return None
    le = storage.get_l_events()
    spec = SnapshotSpec(
        app_id=handle.app_id,
        channel_id=handle.channel_id,
        event_names=tuple(handle.event_names) if handle.event_names else None,
        rating_key=handle.rating_key,
    )
    try:
        return SnapshotStore(root, spec).ensure(
            le,
            mode,
            until_time=getattr(handle, "until_time", None),
            chunk_rows=handle.chunk_rows,
        )
    except Exception:
        logger.warning(
            "training snapshot unavailable for app %r; falling back to the"
            " direct store scan",
            handle.app_name,
            exc_info=True,
        )
        return None


def snapshot_ratings_arrays(handle: StreamingHandle, runtime_conf=None):
    """Materialized COO arrays replayed from the handle's ready snapshot
    generation, or None when snapshots are off/unavailable.

    Returns ``(users, items, ratings, times, user_ids, item_ids)`` --
    the exact shape a datasource's materialized ``_read`` produces, but
    served from the PR-3 memmap columns: a replay evaluation under
    ``--snapshot-mode use`` trains its prefix with zero SQL scans, and a
    second run replays the same pinned generation bit-for-bit.
    """
    import numpy as np

    snap = _snapshot_for_handle(handle, runtime_conf)
    if snap is None:
        return None
    from predictionio_tpu_torch.parallel.reader import snapshot_coo_chunks

    source, users_enc, items_enc = snapshot_coo_chunks(
        snap, chunk_rows=handle.chunk_rows
    )
    chunks = list(source())
    if chunks:
        users = np.concatenate([c[0] for c in chunks])
        items = np.concatenate([c[1] for c in chunks])
        ratings = np.concatenate([c[2] for c in chunks])
        times = np.concatenate([c[3] for c in chunks])
    else:
        users = np.empty(0, np.int64)
        items = np.empty(0, np.int64)
        ratings = np.empty(0, np.float32)
        times = np.empty(0, np.float64)
    return users, items, ratings, times, list(users_enc.ids), list(items_enc.ids)


def streaming_coo_source(
    handle: StreamingHandle,
    runtime_conf=None,
    event_values: dict[str, float] | None = None,
):
    """(source, users_enc, items_enc) for a handle: snapshot-served memmap
    replay when ``--snapshot-mode`` enables it, else the bounded store
    scan. Both yield bit-identical chunk streams over the same prefix."""
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.parallel.reader import (
        snapshot_coo_chunks,
        store_coo_chunks,
    )

    _agree_until_time(handle)
    snap = _snapshot_for_handle(handle, runtime_conf)
    if snap is not None:
        return snapshot_coo_chunks(
            snap, chunk_rows=handle.chunk_rows, event_values=event_values
        )
    return store_coo_chunks(
        storage.get_l_events(),
        handle.app_id,
        channel_id=handle.channel_id,
        event_names=handle.event_names,
        rating_key=handle.rating_key,
        chunk_rows=handle.chunk_rows,
        event_values=event_values,
        until_time=getattr(handle, "until_time", None),
    )


def streaming_multi_event_sources(handle: StreamingHandle, runtime_conf=None):
    """Per-event-type sources over one shared universe (the UR build):
    snapshot replay when enabled, else the bounded multi-type store scan.
    Returns ``(sources, users_enc, items_enc, universe_ready)`` --
    ``universe_ready`` is True when the encoders are already complete
    (snapshot replay), letting the caller skip the priming scan."""
    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.parallel.reader import (
        snapshot_multi_event_chunks,
        store_multi_event_chunks,
    )

    _agree_until_time(handle)
    snap = _snapshot_for_handle(handle, runtime_conf)
    if snap is not None:
        sources, users_enc, items_enc = snapshot_multi_event_chunks(
            snap, handle.event_names, chunk_rows=handle.chunk_rows
        )
        return sources, users_enc, items_enc, True
    sources, users_enc, items_enc = store_multi_event_chunks(
        storage.get_l_events(),
        handle.app_id,
        handle.event_names,
        channel_id=handle.channel_id,
        chunk_rows=handle.chunk_rows,
        until_time=getattr(handle, "until_time", None),
    )
    return sources, users_enc, items_enc, False


def resolve_als_feed(preparator_params, runtime_conf=None) -> str:
    """The ALS feed mode: ``pio train --als-feed`` (runtime conf
    ``pio.als_feed``) overrides the engine's ``alsFeed`` preparator param;
    default ``resident`` (device-resident edge arrays, the pre-PR-10
    path). ``streamed`` packs a disk block store and trains through
    ALX device-resident epochs (``als_fit_streamed``)."""
    conf = runtime_conf or {}
    feed = (
        conf.get("pio.als_feed")
        or preparator_params.get_or("alsFeed", "resident")
    )
    if feed not in ("resident", "streamed"):
        raise ValueError(
            f"alsFeed must be 'resident' or 'streamed', got {feed!r}"
        )
    return feed


def build_streaming_als(handle: StreamingHandle, preparator_params, mesh=None,
                        event_values: dict[str, float] | None = None,
                        runtime_conf=None):
    """The shared streaming ALS build of both ALS templates: the chunked
    store scan (or the snapshot's memmap replay) packed by the
    retention-bounded reader. Returns ``(users_enc, items_enc,
    als_data)``. ``runtime_conf`` carries ``pio.snapshot_mode`` /
    ``pio.snapshot_dir`` and ``pio.als_feed``.

    With ``alsFeed: streamed`` (or ``pio train --als-feed streamed``) and
    a ready snapshot, ``als_data`` is a ``parallel.stream.StreamedALSData``
    block store packed from the snapshot's columns under its generation's
    ``blocks/`` directory (``reader.snapshot_streamed_als_data``), which
    ``fit_with_checkpoint`` trains through ``als_fit_streamed``. Without a
    snapshot the streamed feed falls back to the resident pack with a
    warning: the feed tunes memory and must never fail a train. ``mesh``
    (the training mesh, None for one process) lays both out for its data
    and model axes."""
    from predictionio_tpu_torch.parallel.als import ALSConfig
    from predictionio_tpu_torch.parallel.reader import (
        build_als_data_sharded,
        snapshot_streamed_als_data,
    )

    config = ALSConfig(
        max_len=preparator_params.get_or("maxEventsPerUser", None),
        buckets=preparator_params.get_or("buckets", 1),
    )
    if resolve_als_feed(preparator_params, runtime_conf) == "streamed":
        _agree_until_time(handle)
        snap = _snapshot_for_handle(handle, runtime_conf)
        if snap is not None:
            return snapshot_streamed_als_data(
                snap, config, mesh=mesh,
                model_shards=mesh.shape.get("model", 1) if mesh is not None else 1,
                chunk_rows=handle.chunk_rows,
                event_values=event_values,
            )
        logger.warning(
            "alsFeed 'streamed' needs a training snapshot (--snapshot-mode"
            " use|refresh); falling back to the resident feed"
        )
    source, users_enc, items_enc = streaming_coo_source(
        handle, runtime_conf=runtime_conf, event_values=event_values
    )
    als_data = build_als_data_sharded(
        source, None, None, config, mesh,
        model_shards=mesh.shape.get("model", 1) if mesh is not None else 1,
    )
    return users_enc, items_enc, als_data
