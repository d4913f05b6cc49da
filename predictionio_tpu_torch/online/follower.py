"""WAL tail follower: detect new interactions without rescanning SQL.

The ingest WAL (``data/wal``) already knows exactly what is new -- every
acknowledged event is a framed record with a monotonic seqno. The follower
keeps its OWN durable cursor (independent of the WAL's storage checkpoint,
which tracks the event-store flush) and, each poll, reads only the frames
in ``(cursor, storage-checkpoint]``:

- the upper bound is the WAL's storage high-water mark, NOT the append
  head: a record is acked at WAL durability but the snapshot refresh scans
  SQL, so acting on a record before its storage flush could fold in an
  event the refresh cannot see yet (it waits one poll instead);
- the lower bound is this follower's cursor, which the retrain loop
  advances only after the model reflecting those records was published
  AND swapped -- a crash at any stage replays the same window, and
  fold-in is insensitive to replay (it re-solves from full history).

Segment GC can outrun a follower that was down for a long time (the WAL
only retains segments past ITS checkpoint). That is reported as a ``gap``:
the loop then resynchronizes by refreshing the snapshot to "now" -- the
events are all in the store, only the cheap change detection was lost.

Against a PARTITIONED WAL (``data/wal.PartitionedWal``) the retrain loop
runs one tail + one durable cursor per partition (:func:`partition_tails`
discovers the layout off disk). Every invariant above -- storage-bounded
upper end, advance-after-swap, R003's fsync-before-rename cursor write --
holds independently in each partition; :func:`merge_batches` unions the
per-partition deltas (touched rows, vocab, event-time bounds) into the
single fold-in the loop publishes.

Port copy: ``predictionio_tpu/online/follower.py`` (framework-free), verbatim
under the port's package name; ``tests/test_torch_imports.py`` holds
it to the original.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import time
from dataclasses import dataclass, field

from predictionio_tpu_torch.data import wal as wal_mod
from predictionio_tpu_torch.data.ingest import wal_parse

logger = logging.getLogger("pio.online.follower")


class TailCursor:
    """Durable follower position: one JSON file, atomically replaced.

    Holds the last WAL seqno whose effects are reflected in a SWAPPED
    model, plus the snapshot bound (``until_ms``) and row count that model
    was folded against -- the three facts recovery needs. ``advance`` is
    tmp+fsync+rename (the ``data/snapshot`` manifest discipline): a torn
    write can only leave the previous value, which merely re-replays.
    """

    def __init__(self, path: str):
        self.path = path
        self.seqno = 0
        self.until_ms = 0
        self.snapshot_rows = 0
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                obj = json.load(f)
            self.seqno = int(obj.get("seqno", 0))
            self.until_ms = int(obj.get("until_ms", 0))
            self.snapshot_rows = int(obj.get("snapshot_rows", 0))
        except (OSError, ValueError, json.JSONDecodeError):
            pass  # fresh cursor: everything replays, which is safe

    def advance(self, seqno: int, until_ms: int, snapshot_rows: int) -> None:
        self.seqno = max(self.seqno, int(seqno))
        self.until_ms = max(self.until_ms, int(until_ms))
        self.snapshot_rows = int(snapshot_rows)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = f"{self.path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(
                {
                    "seqno": self.seqno,
                    "until_ms": self.until_ms,
                    "snapshot_rows": self.snapshot_rows,
                    "updated_at": _dt.datetime.now(
                        _dt.timezone.utc
                    ).isoformat(),
                },
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)


@dataclass
class TailBatch:
    """One poll's worth of newly-flushed interactions (already filtered to
    the followed app/channel/event-name set)."""

    last_seqno: int = 0            # highest seqno examined (filtered or not)
    records: int = 0               # matching interaction records
    touched_users: set = field(default_factory=set)   # entity ids (strings)
    touched_items: set = field(default_factory=set)   # target ids (strings)
    #: ``$set``/``$unset``/``$delete`` property records on the followed
    #: app/channel, by entity TYPE. Property events are not interactions
    #: (they never enter the snapshot window or the lag clock -- the
    #: aggregate they change is read LIVE), but a fold-in must know they
    #: happened: the e-commerce category index comes from the item ``$set``
    #: aggregate and served stale until the next full retrain before this.
    set_records: int = 0
    touched_set_types: set = field(default_factory=set)
    min_event_ms: int | None = None
    max_event_ms: int | None = None
    #: cursor trails the oldest retained segment: records were GC'd before
    #: this follower saw them -- resync from the store, don't trust counts
    gap: bool = False

    @property
    def empty(self) -> bool:
        return self.records == 0 and self.set_records == 0 and not self.gap

    def lag_seconds(self, now: float | None = None) -> float:
        """Age of the OLDEST event in this unreflected window -- the
        ``pio_foldin_lag_seconds`` number (0 when nothing is pending)."""
        if self.min_event_ms is None:
            return 0.0
        now = time.time() if now is None else now
        return max(0.0, now - self.min_event_ms / 1000.0)


class WalTail:
    """Read-only view over another process's WAL directory.

    ``event_names``/``app_id``/``channel_id`` filter the followed scan the
    same way the snapshot spec does, so the tail's touched-user set and
    the refresh's appended rows describe the same events. ``channel_id``
    None follows the default channel (matching the scan semantics where a
    None channel filter means default-channel rows).
    """

    def __init__(
        self,
        directory: str,
        app_id: int,
        channel_id: int | None = None,
        event_names: list[str] | None = None,
    ):
        self.directory = directory
        self.app_id = int(app_id)
        self.channel_id = channel_id
        self.event_names = set(event_names) if event_names else None

    def committed_seqno(self) -> int:
        return wal_mod.read_checkpoint(self.directory)

    def poll(self, after_seqno: int, upto_seqno: int | None = None) -> TailBatch:
        """Scan ``(after_seqno, upto_seqno]`` (default: the storage
        checkpoint) and summarize the matching interactions. Torn or
        unparseable payloads are skipped with a warning -- the snapshot
        refresh (SQL-exact) is the correctness layer; the tail is the
        change detector."""
        batch = TailBatch(last_seqno=after_seqno)
        if upto_seqno is None:
            upto_seqno = self.committed_seqno()
        oldest = wal_mod.oldest_seqno(self.directory)
        if oldest is not None and after_seqno + 1 < oldest:
            # seqnos in (after_seqno, oldest) were GC'd unseen
            batch.gap = True
        for seqno, payload in wal_mod.iter_log_records(
            self.directory, after_seqno=after_seqno, upto_seqno=upto_seqno
        ):
            batch.last_seqno = max(batch.last_seqno, seqno)
            try:
                event, app_id, channel_id, _trace = wal_parse(payload)
            except Exception:
                logger.warning(
                    "skipping unparseable WAL record %d", seqno, exc_info=True
                )
                continue
            if app_id != self.app_id or channel_id != self.channel_id:
                continue
            if event.event.startswith("$"):
                # property records ($set/$unset/$delete): tracked by
                # entity type so fold-in can refresh property-derived
                # indexes (e.g. e-commerce categories); never counted as
                # interactions and never part of the snapshot window
                batch.set_records += 1
                batch.touched_set_types.add(event.entity_type)
                continue
            if self.event_names is not None and event.event not in self.event_names:
                continue
            batch.records += 1
            batch.touched_users.add(event.entity_id)
            if event.target_entity_id is not None:
                batch.touched_items.add(event.target_entity_id)
            ms = int(event.event_time.timestamp() * 1000)
            if batch.min_event_ms is None or ms < batch.min_event_ms:
                batch.min_event_ms = ms
            if batch.max_event_ms is None or ms > batch.max_event_ms:
                batch.max_event_ms = ms
        return batch


def partition_tails(
    directory: str,
    app_id: int,
    channel_id: int | None = None,
    event_names: list[str] | None = None,
) -> list[WalTail]:
    """One :class:`WalTail` per WAL partition, in partition order. The
    layout is read off disk (``data/wal.partition_count``), NOT configured:
    the follower runs in a different process than the ingest writer, and
    trusting a flag over the marker file would tail directories the writer
    never fills. A flat P=1 log yields a single tail on the root."""
    return [
        WalTail(part_dir, app_id, channel_id, event_names)
        for part_dir in wal_mod.partition_dirs(directory)
    ]


def merge_batches(batches: list[TailBatch]) -> TailBatch:
    """Union per-partition poll results into the ONE delta the loop folds:
    touched users/items/set-types union, record counts sum, event-time
    window spans the widest bounds, and any partition's GC gap poisons the
    merge (lost records may touch anything). ``last_seqno`` is the max
    across INDEPENDENT per-partition seqno spaces -- diagnostic only
    (registry metadata); cursor advancement is always per-partition."""
    merged = TailBatch()
    for b in batches:
        merged.last_seqno = max(merged.last_seqno, b.last_seqno)
        merged.records += b.records
        merged.set_records += b.set_records
        merged.touched_users |= b.touched_users
        merged.touched_items |= b.touched_items
        merged.touched_set_types |= b.touched_set_types
        merged.gap = merged.gap or b.gap
        for bound in ("min_event_ms", "max_event_ms"):
            val = getattr(b, bound)
            if val is None:
                continue
            cur = getattr(merged, bound)
            if cur is None:
                setattr(merged, bound, val)
            elif bound == "min_event_ms":
                setattr(merged, bound, min(cur, val))
            else:
                setattr(merged, bound, max(cur, val))
    return merged
