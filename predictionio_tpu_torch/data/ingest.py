"""Durable group-commit ingestion pipeline for the Event Server.

Per-record storage commits are the canonical ingestion bottleneck (each
``POST /events.json`` paying one transaction); the pipeline replaces them
with the classic WAL + group-commit design:

1. request threads park on a bounded queue (full queue -> 429 backpressure
   via :class:`IngestOverload`, instead of unbounded thread pile-up);
2. a single background writer drains the queue in batches bounded by
   ``max_batch`` / ``group_commit_ms``, frames the batch into the WAL
   (``data/wal.py``) and makes it durable with ONE fsync;
3. requests are acknowledged at that point -- durability comes from the
   WAL, not the store;
4. the batch is flushed into the event store through
   ``LEvents.insert_batch`` (single transaction / ``executemany`` on the
   SQL backends), after which the WAL checkpoint advances.

A crash anywhere between ack and checkpoint is recovered by
:func:`replay_wal_into_storage` at startup: event ids are assigned BEFORE
the WAL append, and replay inserts with ``on_duplicate="ignore"``, so the
cycle is exactly-once -- nothing acked is lost, nothing is double-applied.
(Process crashes are covered unconditionally; surviving host power loss
additionally requires the event store's own commits to be durable --
postgres/mysql defaults, or sqlite with ``SYNCHRONOUS=FULL`` -- because
the checkpoint advances once the store COMMITS, not once it fsyncs.)

With ``wal_partitions`` P > 1, :class:`PartitionedIngestPipeline` runs P
of these single-writer pipelines side by side, one per WAL partition
(``data/wal.PartitionedWal``), routing each event by the stable entity
hash shared with the serving tier (``utils/stablehash``). Per-entity
ordering holds (one entity -> one partition -> one writer thread) while
the P fsync streams proceed in parallel -- the group-commit latency stops
being a serial bottleneck. Every durability invariant above applies
per partition unchanged; there is deliberately NO cross-partition
protocol to reason about.

Port copy: ``predictionio_tpu/data/ingest.py`` (framework-free), verbatim
under the port's package name; ``tests/test_torch_imports.py`` holds
it to the original.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

from predictionio_tpu_torch.data.event import Event
from predictionio_tpu_torch.data.wal import PartitionedWal, WriteAheadLog
from predictionio_tpu_torch.obs.trace import NULL_TRACER, current_context
from predictionio_tpu_torch.utils.stablehash import stable_bucket

logger = logging.getLogger("pio.ingest")

#: batch-size histogram buckets (events per group commit)
BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0)


@dataclass
class IngestConfig:
    """CLI/server-facing knobs (``pio eventserver --ingest-*``)."""

    mode: str = "sync"            # sync | wal
    queue_size: int = 2048
    group_commit_ms: float = 5.0
    max_batch: int = 256
    fsync_policy: str = "always"  # always | interval | never
    wal_dir: str | None = None    # default: $PIO_FS_BASEDIR/wal
    segment_bytes: int = 64 << 20
    wal_partitions: int = 1       # hash-sharded durability streams

    def resolved_wal_dir(self) -> str:
        if self.wal_dir:
            return self.wal_dir
        import os

        from predictionio_tpu_torch.data.storage import base_dir

        return os.path.join(base_dir(), "wal")


class IngestOverload(Exception):
    """Bounded ingest queue is full; callers map this to HTTP 429."""

    def __init__(self, retry_after_s: float = 1.0):
        super().__init__("ingestion queue full")
        self.retry_after_s = retry_after_s


@dataclass
class _Pending:
    event: Event
    app_id: int
    channel_id: int | None
    future: Future = field(default_factory=Future)
    #: (trace_id, span_id) of the submitting request, for span fan-out
    trace_ctx: tuple | None = None
    submitted: float = field(default_factory=time.perf_counter)


def _wal_payload(
    event: Event, app_id: int, channel_id: int | None,
    trace_id: str | None = None,
) -> bytes:
    obj = {"e": event.to_json_obj(), "a": app_id, "c": channel_id}
    if trace_id:
        # the trace rides the durable record: a post-crash replay can
        # attach its span to the ORIGINAL ingest trace
        obj["t"] = trace_id
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")


def _wal_parse(payload: bytes) -> tuple[Event, int, int | None, str | None]:
    obj = json.loads(payload.decode("utf-8"))
    return Event.from_json_obj(obj["e"]), obj["a"], obj["c"], obj.get("t")


#: public names for the frame codec: the continuous-learning WAL tail
#: (``online.follower``) parses the same records from another process
wal_payload = _wal_payload
wal_parse = _wal_parse


class IngestPipeline:
    """Single-writer group-commit pipeline in front of ``LEvents``.

    ``l_events`` is a zero-arg callable returning the DAO (resolved per
    flush so tests/env changes that reset the storage registry keep
    working). With ``wal=None`` the pipeline still group-commits but acks
    only after the storage flush (no durability layer to ack from).
    """

    def __init__(
        self,
        wal: WriteAheadLog | None,
        l_events=None,
        queue_size: int = 2048,
        group_commit_ms: float = 5.0,
        max_batch: int = 256,
        metrics=None,
        tracer=None,
        part: int | None = None,
    ):
        if l_events is None:
            from predictionio_tpu_torch.data import storage as storage_registry

            l_events = storage_registry.get_l_events
        self.wal = wal
        self._l_events = l_events
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._queue: queue.Queue[_Pending] = queue.Queue(maxsize=queue_size)
        self.group_commit_s = group_commit_ms / 1000.0
        self.max_batch = max_batch
        self.metrics = metrics
        # partition index when owned by a PartitionedIngestPipeline: names
        # the writer thread and labels this writer's commit metrics with
        # {part=}; None = standalone single-stream pipeline (no labels, the
        # pre-partitioning exposition unchanged)
        self.part = part
        self._part_labels = None if part is None else {"part": str(part)}
        self._stopping = threading.Event()
        # serializes the stopping-check-then-enqueue in submit() against
        # stop()'s flag set: once the flag is visible, no further enqueue can
        # land, so the writer's final queue-empty check is race-free and no
        # future is ever stranded unresolved
        self._submit_gate = threading.Lock()
        self._thread = threading.Thread(
            target=self._writer_loop,
            name="pio-ingest-writer" if part is None
            else f"pio-ingest-writer-p{part}",
            daemon=True,
        )
        self.retry_after_s = max(1.0, group_commit_ms / 1000.0)
        self.storage_errors = 0
        # WAL-acked batches whose storage flush failed, oldest first as
        # (items, last_seqno). The writer re-flushes them in order and the
        # checkpoint NEVER advances past them -- otherwise a later healthy
        # batch's checkpoint would strand (then GC) acked records. Bounded:
        # past _retry_cap events, submit() applies backpressure.
        self._retry_batches: list[tuple[list, int]] = []
        self._retry_events = 0
        self._retry_cap = max(queue_size, 1024)
        self._last_retry = 0.0

    # -- request side ---------------------------------------------------------
    def start(self) -> "IngestPipeline":
        self._thread.start()
        return self

    def submit(self, event: Event, app_id: int, channel_id: int | None) -> Future:
        """Enqueue one event; the returned future resolves to its eventId
        once the record is durable. Raises :class:`IngestOverload` when the
        queue is full (the backpressure contract)."""
        if self._retry_events > self._retry_cap:
            # storage has been down long enough to back up the retry
            # backlog: stop acking new work instead of buffering unboundedly
            raise IngestOverload(self.retry_after_s)
        # the id is assigned BEFORE the WAL append so replay after a crash
        # re-applies the same identity (exactly-once via duplicate skip)
        pending = _Pending(
            event if event.event_id else event.with_id(), app_id, channel_id
        )
        if self.tracer.enabled:
            pending.trace_ctx = current_context()
        with self._submit_gate:
            if self._stopping.is_set():
                raise IngestOverload(self.retry_after_s)
            try:
                self._queue.put_nowait(pending)
            except queue.Full:
                raise IngestOverload(self.retry_after_s) from None
        return pending.future

    def depth(self) -> int:
        return self._queue.qsize()

    # -- writer side ----------------------------------------------------------
    def _collect_batch(self) -> list[_Pending]:
        """Block for the first item, then gather until the group-commit
        deadline or the batch cap. During shutdown, drain without waiting."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.group_commit_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if self._stopping.is_set():
                remaining = 0.0
            try:
                if remaining > 0:
                    batch.append(self._queue.get(timeout=remaining))
                else:
                    batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return batch

    def _writer_loop(self) -> None:
        while True:
            batch = self._collect_batch()
            if not batch:
                self._flush_retries()
                if self._stopping.is_set() and self._queue.empty():
                    self._flush_retries(force=True)  # last chance pre-exit;
                    # anything still parked survives in the WAL for replay
                    return
                continue
            try:
                self._commit(batch)
            except Exception as exc:  # a poisoned batch must not kill the writer
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(exc)

    def _flush_retries(self, force: bool = False) -> None:
        """Re-flush parked batches IN ORDER, advancing the checkpoint as each
        lands; stop at the first failure (ordering preserves the contiguous-
        prefix invariant the checkpoint depends on)."""
        if not self._retry_batches:
            return
        if not force and time.monotonic() - self._last_retry < 0.25:
            return
        self._last_retry = time.monotonic()
        while self._retry_batches:
            items, last_seqno = self._retry_batches[0]
            try:
                self._l_events().insert_batch(items, on_duplicate="ignore")
            except Exception:
                return
            self._retry_batches.pop(0)
            self._retry_events -= len(items)
            if self.wal is not None:
                self.wal.checkpoint(last_seqno)

    def _commit(self, batch: list[_Pending]) -> None:
        # the writer thread's own root span: every group commit is one
        # trace (op "ingest.commit" -- the --slow-commit-ms target), and
        # its WAL/storage stages fan out to each request's trace too
        with self.tracer.span(
            "ingest.commit", attrs={"batch_size": len(batch)}
        ) as commit_span:
            self._commit_traced(batch, commit_span)

    def _commit_traced(self, batch: list[_Pending], commit_span) -> None:
        t0 = time.perf_counter()
        last_seqno = None
        if self.wal is not None:
            for p in batch:
                last_seqno = self.wal.append(
                    _wal_payload(
                        p.event, p.app_id, p.channel_id,
                        p.trace_ctx[0] if p.trace_ctx else None,
                    )
                )
            sync0 = time.perf_counter()
            self.wal.sync()
            sync1 = time.perf_counter()
            # span-list refs captured while the request roots are still
            # guaranteed open (their threads are parked on the futures);
            # the fan-out itself runs only after every ack below
            traced = [
                (p.trace_ctx, p.submitted,
                 self.tracer.live_spans(p.trace_ctx[0]))
                for p in batch if p.trace_ctx is not None
            ] if self.tracer.enabled else []
            # ack at the durability point: the WAL holds the records even if
            # the storage flush below fails or the process dies
            for p in batch:
                p.future.set_result(p.event.event_id)
            self._trace_fanout(traced, len(batch), t0, sync0, sync1,
                               commit_span)
        items = [(p.event, p.app_id, p.channel_id) for p in batch]
        if self.wal is None:
            # no durability layer: ack only after the store has the events,
            # and surface flush errors to the parked request threads
            with self.tracer.span("storage.flush", attrs={"events": len(items)}):
                self._l_events().insert_batch(items)
            for p in batch:
                p.future.set_result(p.event.event_id)
            self._observe(batch, time.perf_counter() - t0)
            return
        # older failed batches flush first; while any remain, this batch must
        # park behind them -- checkpointing it now would strand (and GC) the
        # acked records still awaiting their flush
        self._flush_retries(force=True)
        if self._retry_batches:
            self._park(items, last_seqno, "storage still unavailable")
        else:
            try:
                # "ignore", not "error": ids are assigned pre-WAL precisely so
                # duplicate application is a no-op. A client-supplied eventId
                # that already exists dedupes alone instead of aborting the
                # whole multi-tenant transaction (and it makes crash replay
                # and client retries idempotent).
                with self.tracer.span(
                    "storage.flush", attrs={"events": len(items)}
                ):
                    self._l_events().insert_batch(items, on_duplicate="ignore")
                self.wal.checkpoint(last_seqno)
            except Exception as exc:
                self._park(items, last_seqno, repr(exc))
        self._observe(batch, time.perf_counter() - t0)

    def _trace_fanout(
        self, traced: list, n_records: int, t0: float, sync0: float,
        sync1: float, commit_span,
    ) -> None:
        """Record per-request queue-wait plus SHARED wal.append/wal.fsync
        spans (one span id across the whole batch) into every traced
        request's trace, and the same stages into the writer's commit
        trace. Runs AFTER the durability acks (tracing must never delay
        an ack; the span lists in ``traced`` were captured while the
        roots were still open), and each physical WAL stage bridges into
        the span histogram exactly once per commit -- not once per
        coalesced request."""
        tracer = self.tracer
        if not tracer.enabled:
            return
        try:
            extra = None
            if commit_span.trace_id is not None:
                extra = (commit_span.trace_id, commit_span.span_id,
                         tracer.live_spans(commit_span.trace_id))
            tracer.record_fanout(
                traced,
                [
                    ("wal.append", t0, sync0, {"records": n_records}),
                    ("wal.fsync", sync0, sync1),
                ],
                queue_op="ingest.queue_wait",
                bridge_queue=True,
                extra=extra,
            )
        except Exception:
            logger.warning("ingest trace recording failed", exc_info=True)

    def _park(self, items: list, last_seqno: int, reason: str) -> None:
        self._retry_batches.append((items, last_seqno))
        self._retry_events += len(items)
        self.storage_errors += 1
        logger.error(
            "storage flush failed for %d acked event(s); parked for"
            " in-process retry (WAL-durable): %s",
            len(items),
            reason,
        )

    def _observe(self, batch: list[_Pending], seconds: float) -> None:
        if self.metrics is None:
            return
        self.metrics.inc(
            "pio_ingest_events_total",
            labels=self._part_labels,
            amount=float(len(batch)),
            help="Events committed through the ingest pipeline",
        )
        self.metrics.observe(
            "pio_ingest_commit_seconds",
            seconds,
            labels=self._part_labels,
            help="Group-commit latency (WAL sync + storage flush)",
        )
        self.metrics.observe(
            "pio_ingest_batch_size",
            float(len(batch)),
            labels=self._part_labels,
            buckets=BATCH_BUCKETS,
            help="Events per group commit",
        )
        if self.storage_errors:
            self.metrics.set_counter(
                "pio_ingest_storage_errors_total",
                float(self.storage_errors),
                labels=self._part_labels,
                help="Batches whose storage flush failed (recovered via WAL replay)",
            )

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the writer. With ``drain`` (default) every queued event is
        committed first -- the graceful-shutdown contract."""
        with self._submit_gate:
            self._stopping.set()
        if not drain:
            # reject queued work so request threads don't hang on futures
            self._reject_queued()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        # belt-and-braces for the join-timeout path (a wedged writer leaves
        # the queue populated); the submit gate guarantees nothing NEW lands
        # after the flag, so this cannot race fresh enqueues
        self._reject_queued()

    def _reject_queued(self) -> None:
        while True:
            try:
                p = self._queue.get_nowait()
            except queue.Empty:
                return
            if not p.future.done():
                p.future.set_exception(IngestOverload(self.retry_after_s))


def replay_wal_into_storage(
    wal: WriteAheadLog, l_events=None, batch_size: int = 500, tracer=None
) -> int:
    """Re-apply every un-checkpointed WAL record to the event store;
    returns the number of records examined. Duplicate records (crash
    between storage flush and checkpoint) are skipped by the store
    (``on_duplicate="ignore"``), making replay idempotent.

    WAL records carry their originating trace id: with a ``tracer``, each
    distinct replayed trace gains a ``wal.replay`` span, so the original
    ingest trace shows its post-crash completion instead of dead-ending
    at the ack."""
    if l_events is None:
        from predictionio_tpu_torch.data import storage as storage_registry

        l_events = storage_registry.get_l_events
    tracer = tracer if tracer is not None else NULL_TRACER
    count = 0
    last_seqno = 0
    pending: list[tuple[Event, int, int | None]] = []
    replayed_traces: set[str] = set()
    t_start = time.perf_counter()

    def flush() -> None:
        if pending:
            l_events().insert_batch(pending, on_duplicate="ignore")
            pending.clear()

    for seqno, payload in wal.replay():
        event, app_id, channel_id, trace_id = _wal_parse(payload)
        pending.append((event, app_id, channel_id))
        if trace_id and tracer.enabled:
            replayed_traces.add(trace_id)
        last_seqno = seqno
        count += 1
        if len(pending) >= batch_size:
            flush()
    flush()
    if last_seqno:
        wal.checkpoint(last_seqno)
    t_end = time.perf_counter()
    for trace_id in replayed_traces:
        tracer.record_span(
            trace_id, "wal.replay", t_start, t_end,
            attrs={"records_total": count},
        )
    return count


def partition_of(event: Event, partitions: int) -> int:
    """The WAL partition that owns ``event`` -- the ONE routing rule.

    Buckets by ``entity_id`` with the exact hash the serving fabric
    shards user factors by (``serving/shardmap.shard_of`` is the same
    function): every record an entity ever writes lands in one
    partition, so per-entity ordering is preserved by that partition's
    single writer thread, and the ingest stream for an entity lives
    where the serving tier expects its state.
    """
    return stable_bucket(event.entity_id, partitions)


def replay_partitioned_wal(
    wal: PartitionedWal, l_events=None, batch_size: int = 500, tracer=None
) -> int:
    """Startup replay over every partition; returns total records
    examined. Each partition replays against its OWN checkpoint and
    advances it independently (exactly-once per partition, the
    single-log contract of :func:`replay_wal_into_storage` applied P
    times); records cannot cross partitions because replay never
    re-routes -- it re-applies each partition's log verbatim."""
    return sum(
        replay_wal_into_storage(
            part, l_events=l_events, batch_size=batch_size, tracer=tracer
        )
        for part in wal.parts
    )


class PartitionedIngestPipeline:
    """P single-writer :class:`IngestPipeline` streams behind one submit.

    Each partition owns a complete pipeline -- bounded queue, writer
    thread, WAL stream, retry parking -- so the fsync/storage-flush
    stages of different partitions overlap freely; the only shared code
    path is the stateless hash in :func:`partition_of`. The per-partition
    queues split the configured ``queue_size`` so total buffered work
    (and thus worst-case replay) stays bounded by the same knob as the
    single-stream pipeline.
    """

    def __init__(
        self,
        wal: PartitionedWal,
        l_events=None,
        queue_size: int = 2048,
        group_commit_ms: float = 5.0,
        max_batch: int = 256,
        metrics=None,
        tracer=None,
    ):
        self.wal = wal
        self.partitions = wal.partitions
        per_part_queue = max(64, queue_size // self.partitions)
        # P=1 passes part=None: metrics stay unlabeled and the writer
        # thread keeps its pre-partitioning name -- the degenerate case is
        # observably identical to the original single-stream pipeline
        self.pipes: list[IngestPipeline] = [
            IngestPipeline(
                wal.part(k),
                l_events=l_events,
                queue_size=per_part_queue,
                group_commit_ms=group_commit_ms,
                max_batch=max_batch,
                metrics=metrics,
                tracer=tracer,
                part=None if self.partitions == 1 else k,
            )
            for k in range(self.partitions)
        ]

    # -- request side -------------------------------------------------------
    def start(self) -> "PartitionedIngestPipeline":
        for pipe in self.pipes:
            pipe.start()
        return self

    def submit(self, event: Event, app_id: int, channel_id: int | None) -> Future:
        return self.pipes[partition_of(event, self.partitions)].submit(
            event, app_id, channel_id
        )

    def depth(self) -> int:
        return sum(pipe.depth() for pipe in self.pipes)

    def depth_of(self, part: int) -> int:
        return self.pipes[part].depth()

    @property
    def retry_after_s(self) -> float:
        return max(pipe.retry_after_s for pipe in self.pipes)

    @property
    def storage_errors(self) -> int:
        return sum(pipe.storage_errors for pipe in self.pipes)

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop every partition writer CONCURRENTLY: a drain is dominated
        by fsync + storage-flush latency, and serializing P drains would
        multiply shutdown time by exactly the factor the partitions were
        added to divide."""
        stoppers = [
            threading.Thread(
                target=pipe.stop, kwargs={"drain": drain, "timeout": timeout}
            )
            for pipe in self.pipes
        ]
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join(timeout=timeout + 5.0)
