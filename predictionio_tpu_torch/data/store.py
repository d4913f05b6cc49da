"""Event store facades: the API engine templates call, and the events file.

Copy of ``predictionio_tpu/data/store.py`` (framework-free numpy):

- ``resolve_app_channel``: appName (+ channel) -> (appId, channelId);
- ``EventDataset``: the columnar view of a query result, built from
  events (``from_events``), from a backend's columnar fast scan
  (``from_columns``, no Event per row) or from a training snapshot
  (``from_snapshot``, ``data/snapshot.py``);
- ``LEventStore``: blocking serving-time reads by app name (the live
  seen filters of ``models/_streaming.py`` read through it);
- ``PEventStore``: the training reads, ``find``, ``dataset`` and
  ``aggregate_properties``. ``dataset`` serves a compatible query from
  the on-disk training snapshot when ``snapshot_mode`` /
  ``PIO_SNAPSHOT_MODE`` is ``use`` or ``refresh``; else (or when the
  snapshot layer fails, with a warning) the columnar scan when the
  backend has ``scan_interactions`` and the filters allow it, else the
  row path (a failed fast scan falls back to it with a warning), as the
  reference's does.

``read_events_file`` is the port's stand-in for ``pio import`` + the
store + ``PEventStore.dataset`` over a JSON-lines file in the ``pio
import`` wire shape (one event object per line,
``docs/quickstart-recommendation.md``): it keeps the events the store's
query would return -- names in ``event_names``, target type
``target_entity_type`` -- in event-time order at the store's millisecond
resolution, ties in file order, and encodes them. The store's columnar
scan breaks ties by event id instead, so only events without time ties
encode alike through both.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from predictionio_tpu_torch.data import storage as storage_registry
from predictionio_tpu_torch.data.datamap import PropertyMap
from predictionio_tpu_torch.data.event import Event

logger = logging.getLogger("pio.store")


class AppNotFoundError(LookupError):
    pass


class ChannelNotFoundError(LookupError):
    pass


def resolve_app_channel(
    app_name: str, channel_name: str | None = None
) -> tuple[int, int | None]:
    """appName (+channel) -> (appId, channelId), as LEventStore/Common does."""
    apps = storage_registry.get_meta_data_apps()
    app = apps.get_by_name(app_name)
    if app is None:
        raise AppNotFoundError(f"app {app_name!r} not found")
    if channel_name is None:
        return app.id, None
    channels = storage_registry.get_meta_data_channels()
    for ch in channels.get_by_app(app.id):
        if ch.name == channel_name:
            return app.id, ch.id
    raise ChannelNotFoundError(f"channel {channel_name!r} not found in app {app_name!r}")


@dataclass
class EventDataset:
    """Columnar view of an event query result.

    String-valued columns are dictionary-encoded: ``entity_ids[i]`` indexes
    into ``entity_id_vocab``. Numeric columns are dense numpy arrays.
    ``events`` retains the row objects -- it is EMPTY when the dataset
    came through a backend's columnar fast scan (``from_columns``), which
    skips Event construction entirely.
    """

    events: list[Event]
    entity_id_vocab: list[str]
    target_entity_id_vocab: list[str]
    event_name_vocab: list[str]
    entity_ids: np.ndarray        # int32 [n]
    target_entity_ids: np.ndarray # int32 [n], -1 when absent
    event_names: np.ndarray       # int32 [n]
    event_times: np.ndarray       # float64 [n], epoch seconds
    ratings: np.ndarray           # float32 [n], properties["rating"] or NaN

    def __len__(self) -> int:
        return int(self.entity_ids.size)

    @classmethod
    def from_events(cls, events: list[Event], rating_key: str = "rating") -> "EventDataset":
        ent_vocab: dict[str, int] = {}
        tgt_vocab: dict[str, int] = {}
        name_vocab: dict[str, int] = {}
        n = len(events)
        ent = np.empty(n, dtype=np.int32)
        tgt = np.full(n, -1, dtype=np.int32)
        names = np.empty(n, dtype=np.int32)
        times = np.empty(n, dtype=np.float64)
        ratings = np.full(n, np.nan, dtype=np.float32)
        for i, ev in enumerate(events):
            ent[i] = ent_vocab.setdefault(ev.entity_id, len(ent_vocab))
            if ev.target_entity_id is not None:
                tgt[i] = tgt_vocab.setdefault(ev.target_entity_id, len(tgt_vocab))
            names[i] = name_vocab.setdefault(ev.event, len(name_vocab))
            times[i] = ev.event_time.timestamp()
            r = ev.properties.get_opt(rating_key)
            if isinstance(r, (int, float)) and not isinstance(r, bool):
                ratings[i] = float(r)
        return cls(
            events=events,
            entity_id_vocab=list(ent_vocab),
            target_entity_id_vocab=list(tgt_vocab),
            event_name_vocab=list(name_vocab),
            entity_ids=ent,
            target_entity_ids=tgt,
            event_names=names,
            event_times=times,
            ratings=ratings,
        )

    @classmethod
    def from_columns(
        cls, entity_ids, target_entity_ids, event_names, event_times_iso, ratings_raw
    ) -> "EventDataset":
        """Build from a backend columnar scan (``scan_interactions``) --
        no Event objects, no per-row JSON parse. Matches ``from_events``
        output exactly: first-appearance vocabulary order (None targets ->
        the -1 sentinel), microsecond-precision timestamps from the stored
        ISO strings, and ratings pre-filtered to JSON numbers by the
        backend. pandas accelerates the encoding when present (it is not a
        declared dependency); pure-python fallbacks match it bit-for-bit.
        """
        try:
            import pandas as pd
        except ImportError:
            pd = None

        def encode(values) -> tuple[np.ndarray, list[str]]:
            if pd is not None:
                codes, vocab = pd.factorize(np.asarray(values, dtype=object))
                return codes.astype(np.int32), [str(v) for v in vocab]
            vocab_map: dict[str, int] = {}
            codes = np.empty(len(values), dtype=np.int32)
            for i, v in enumerate(values):
                codes[i] = (
                    -1 if v is None else vocab_map.setdefault(v, len(vocab_map))
                )
            return codes, list(vocab_map)

        ent, ent_vocab = encode(entity_ids)
        tgt, tgt_vocab = encode(target_entity_ids)
        names, name_vocab = encode(event_names)

        n = len(entity_ids)
        times = None
        if pd is not None:
            try:
                # as_unit("ns"): pandas 2 may parse into us/ms resolution,
                # and asi8 reports in whatever unit the index landed in.
                # format="ISO8601" and as_unit are pandas>=2 API -- any
                # older-pandas failure drops to the stdlib loop below
                times = (
                    pd.DatetimeIndex(
                        pd.to_datetime(event_times_iso, utc=True, format="ISO8601")
                    )
                    .as_unit("ns")
                    .asi8
                    / 1e9
                )
            except Exception:
                times = None
        if times is None:
            times = np.fromiter(
                (_dt.datetime.fromisoformat(s).timestamp() for s in event_times_iso),
                dtype=np.float64,
                count=n,
            )

        def to_float(v) -> float:
            if v is None:
                return np.nan
            try:
                return float(v)  # drivers may hand numbers back as str/Decimal
            except (TypeError, ValueError):
                return np.nan

        ratings = np.fromiter(
            (to_float(v) for v in ratings_raw), dtype=np.float32, count=n
        )
        return cls(
            events=[],
            entity_id_vocab=ent_vocab,
            target_entity_id_vocab=tgt_vocab,
            event_name_vocab=name_vocab,
            entity_ids=ent,
            target_entity_ids=tgt,
            event_names=names,
            event_times=np.asarray(times, np.float64),
            ratings=ratings,
        )

    @classmethod
    def from_snapshot(cls, snapshot) -> "EventDataset":
        """Build from a columnar training snapshot (``data/snapshot``) --
        zero SQL, zero parsing: the snapshot already holds exactly this
        class's encoding (full-stream first-appearance vocabularies, -1
        sentinel targets, float64 epoch times, NaN-for-absent ratings).
        Columns are copied out of the memmaps so the dataset outlives the
        snapshot files (a later refresh GCs old generations).
        """
        return cls(
            events=[],
            entity_id_vocab=list(snapshot.vocab("users")),
            target_entity_id_vocab=list(snapshot.vocab("items")),
            event_name_vocab=list(snapshot.vocab("names")),
            entity_ids=np.asarray(snapshot.column("users")).astype(np.int32),
            target_entity_ids=np.asarray(snapshot.column("items")).astype(
                np.int32
            ),
            event_names=np.array(snapshot.column("names"), np.int32),
            event_times=np.array(snapshot.column("times"), np.float64),
            ratings=np.asarray(snapshot.column("ratings")).astype(np.float32),
        )


class LEventStore:
    """Blocking serving-time event reads, resolved by app name."""

    @staticmethod
    def find(
        app_name: str,
        entity_type: str | None = None,
        entity_id: str | None = None,
        channel_name: str | None = None,
        event_names: list[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        limit: int | None = None,
        latest: bool = True,
    ) -> Iterator[Event]:
        app_id, channel_id = resolve_app_channel(app_name, channel_name)
        return storage_registry.get_l_events().find(
            app_id=app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=entity_type,
            entity_id=entity_id,
            event_names=event_names,
            target_entity_type=target_entity_type,
            target_entity_id=target_entity_id,
            limit=limit,
            reversed=latest,
        )

    @staticmethod
    def find_by_entity(
        app_name: str,
        entity_type: str,
        entity_id: str,
        channel_name: str | None = None,
        **kwargs,
    ) -> Iterator[Event]:
        return LEventStore.find(
            app_name,
            entity_type=entity_type,
            entity_id=entity_id,
            channel_name=channel_name,
            **kwargs,
        )


class PEventStore:
    """Training-time bulk reads -> columnar EventDataset."""

    @staticmethod
    def find(
        app_name: str,
        channel_name: str | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        entity_type: str | None = None,
        entity_id: str | None = None,
        event_names: list[str] | None = None,
        target_entity_type=...,
        target_entity_id=...,
    ) -> list[Event]:
        app_id, channel_id = resolve_app_channel(app_name, channel_name)
        return list(
            storage_registry.get_l_events().find(
                app_id=app_id,
                channel_id=channel_id,
                start_time=start_time,
                until_time=until_time,
                entity_type=entity_type,
                entity_id=entity_id,
                event_names=event_names,
                target_entity_type=target_entity_type,
                target_entity_id=target_entity_id,
            )
        )

    #: dataset() filters the columnar fast scan understands; anything else
    #: (entity filters, exotic target matching) falls back to the row path
    _FAST_SCAN_FILTERS = frozenset(
        {"event_names", "target_entity_type", "start_time", "until_time"}
    )

    #: dataset() filters a training snapshot can key on (time filters are
    #: excluded: a snapshot's coverage boundary is its own until bound)
    _SNAPSHOT_FILTERS = frozenset({"event_names", "target_entity_type"})

    @staticmethod
    def dataset(
        app_name: str,
        rating_key: str = "rating",
        channel_name: str | None = None,
        snapshot_mode: str | None = None,
        snapshot_dir: str | None = None,
        **kwargs,
    ) -> EventDataset:
        """Columnar training read. With snapshots enabled (explicit args,
        ``pio.snapshot_*`` runtime conf via ``pio train``, or the
        ``PIO_SNAPSHOT_MODE``/``PIO_SNAPSHOT_DIR`` env), a compatible
        query is served from the on-disk training snapshot: ``use`` mode
        replays the existing spill as-is (bounded at ITS time coverage --
        stale-but-fast by contract), ``refresh`` first appends the events
        since. Everything else falls through to the live scan paths.
        """
        le = storage_registry.get_l_events()
        ds = PEventStore._dataset_from_snapshot(
            le, app_name, rating_key, channel_name,
            snapshot_mode, snapshot_dir, kwargs,
        )
        if ds is not None:
            return ds
        if (
            hasattr(le, "scan_interactions")
            and set(kwargs) <= PEventStore._FAST_SCAN_FILTERS
        ):
            app_id, channel_id = resolve_app_channel(app_name, channel_name)
            try:
                return EventDataset.from_columns(
                    *le.scan_interactions(
                        app_id, channel_id, rating_key=rating_key, **kwargs
                    )
                )
            except Exception:
                # e.g. a stored properties blob the DB's JSON functions
                # reject (python's json accepts NaN, SQL JSON does not):
                # the row path parses it fine, so degrade instead of
                # failing training for the whole app
                logger.warning(
                    "columnar fast scan failed for app %r; falling back to"
                    " the row path",
                    app_name,
                    exc_info=True,
                )
        return EventDataset.from_events(
            PEventStore.find(app_name, channel_name=channel_name, **kwargs),
            rating_key=rating_key,
        )

    @staticmethod
    def _dataset_from_snapshot(
        le, app_name, rating_key, channel_name, snapshot_mode, snapshot_dir,
        kwargs,
    ) -> EventDataset | None:
        """The snapshot-served fast path of :meth:`dataset`, or None when
        snapshots are off / the query or backend is incompatible / the
        snapshot layer fails (training must degrade to the scan)."""
        from predictionio_tpu_torch.data.snapshot import (
            SnapshotSpec,
            SnapshotStore,
            snapshot_settings,
        )

        mode, root = snapshot_settings(
            mode=snapshot_mode, snapshot_dir=snapshot_dir
        )
        if mode == "off" or not set(kwargs) <= PEventStore._SNAPSHOT_FILTERS:
            return None
        if not hasattr(le, "iter_interaction_chunks"):
            return None
        try:
            app_id, channel_id = resolve_app_channel(app_name, channel_name)
            event_names = kwargs.get("event_names")
            spec = SnapshotSpec(
                app_id=app_id,
                channel_id=channel_id,
                event_names=tuple(event_names) if event_names else None,
                rating_key=rating_key,
                target_entity_type=kwargs.get("target_entity_type", ...),
            )
            snap = SnapshotStore(root, spec).ensure(le, mode)
            if snap is None:
                return None
            return EventDataset.from_snapshot(snap)
        except Exception:
            logger.warning(
                "snapshot-served dataset failed for app %r; falling back to"
                " the live scan",
                app_name,
                exc_info=True,
            )
            return None

    @staticmethod
    def aggregate_properties(
        app_name: str,
        entity_type: str,
        channel_name: str | None = None,
        start_time: _dt.datetime | None = None,
        until_time: _dt.datetime | None = None,
        required: list[str] | None = None,
    ) -> dict[str, PropertyMap]:
        app_id, channel_id = resolve_app_channel(app_name, channel_name)
        return storage_registry.get_l_events().aggregate_properties(
            app_id=app_id,
            entity_type=entity_type,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            required=required,
        )


def read_events(path: str) -> list[Event]:
    """Every event of a JSON-lines file (blank lines skipped), validated
    by ``Event.from_json_obj``; a bad line raises with its line number."""
    events = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            try:
                events.append(Event.from_json_obj(json.loads(line)))
            except ValueError as exc:
                raise ValueError(f"{path}:{lineno}: {exc}") from None
    return events


def read_item_properties(path: str) -> dict[str, PropertyMap]:
    """item id -> ``PropertyMap`` folded from an events file's item
    ``$set`` / ``$unset`` / ``$delete`` events in event-time order: what
    ``PEventStore.aggregate_properties(app, "item")`` answers for a store
    holding the file."""
    from predictionio_tpu_torch.data.aggregation import aggregate_properties

    events = [e for e in read_events(path) if e.entity_type == "item"]
    events.sort(key=lambda e: int(e.event_time.timestamp() * 1000))
    return aggregate_properties(events)


def read_events_file(
    path: str,
    *,
    event_names: list[str] | None = None,
    target_entity_type: str | None = "item",
    rating_key: str = "rating",
) -> EventDataset:
    """The training read of ``PEventStore.dataset(..., event_names=...,
    target_entity_type=...)`` over an events file: filter first, then
    encode, so vocabularies hold only the entities of the kept events."""
    kept = [
        ev for ev in read_events(path)
        if (event_names is None or ev.event in event_names)
        and (target_entity_type is None or ev.target_entity_type == target_entity_type)
    ]
    # the store scans by event time (millisecond resolution); sorted() is
    # stable, so ties keep their file order
    kept = sorted(kept, key=lambda ev: int(ev.event_time.timestamp() * 1000))
    return EventDataset.from_events(kept, rating_key=rating_key)
