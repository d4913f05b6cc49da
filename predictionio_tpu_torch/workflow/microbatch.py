"""Dynamic micro-batching: coalesce concurrent queries into padded batches.

The query server dispatches every HTTP request as an individual model call,
so under concurrent load the accelerator (or the vectorized host path) sees
batch size 1 no matter the offered traffic. ALX (arXiv:2112.02194) wins TPU
matrix-factorization throughput by keeping work in large padded batches
with static shapes; this module applies the same principle to the serving
hot path.

``MicroBatcher`` owns a queue and one flush thread. Request threads
``submit()`` a query and block on a future; the flusher coalesces whatever
is in flight into one batch and hands it to the ``execute`` callback, then
scatters results back to the per-request futures. A batch closes on
whichever comes first:

- **size**: ``max_batch_size`` queries are waiting, or
- **deadline**: ``window_ms`` elapsed since the batch's FIRST query was
  enqueued (the latency budget a request can pay for batching), or
- **idle**: no new query arrived for ``idle_ms`` -- the burst that is
  going to coalesce has coalesced, and waiting out the rest of the
  window would buy nothing but latency (closed-loop clients park until
  this batch answers, so nothing else is coming), or
- **drain**: the server is stopping and flushes everything in flight.

Batches are padded up to a fixed ladder of **bucket sizes** (default
1/4/16/64/128) by repeating the last query, so jitted batched scorers see
one static shape per bucket and compile once per bucket instead of once
per distinct batch length. Padding results are dropped on scatter.

Per-request error isolation is the ``execute`` callback's contract: it
returns one entry per query, and an entry that is an ``Exception`` instance
fails only its own future (one bad query must not fail its batchmates).
If ``execute`` itself raises, every future in the batch gets the exception
-- callbacks that can fail partially should catch and degrade internally
(see ``QueryService._predict_batch``).

With a ``MetricsRegistry`` attached, every flush records:

- ``pio_serving_batch_size`` (histogram): real (unpadded) batch sizes,
- ``pio_serving_batch_queue_wait_seconds`` (histogram): per-query wait
  between enqueue and flush,
- ``pio_serving_batch_flush_total{reason="size"|"deadline"|"idle"|"drain"}``,
- ``pio_serving_batch_padding_rows_total``: padded slots executed.

With a ``Tracer`` attached (``obs.trace``), every flush fans spans out to
each coalesced request's trace: a per-request ``batch.queue_wait`` span
(enqueue -> flush) plus batch-level ``batch.assemble`` and
``batch.execute`` spans whose span ids are SHARED across the batch -- the
join key that answers "which requests rode the batch my request rode".

**Done-callback contract (the async serving fast path).** ``submit``'s
future supports ``add_done_callback``; the multi-process scorer uses it
to serialize and push each response from the flusher thread with ZERO
dispatcher threads on the query path. Callbacks fire synchronously
inside ``_flush`` as each future resolves, ON THE FLUSHER THREAD: a
callback that blocks (fsync, SQL, socket I/O, another future's
``.result()``, a timeout-less queue op) stalls every in-flight and
future batch, not one request. ``pio check`` C005 statically enforces
this; overflow work (e.g. a full completion ring) must be parked on
another thread, never waited for here.

Port copy: ``predictionio_tpu/workflow/microbatch.py`` (framework-free), verbatim,
under the port's package name; ``tests/test_torch_imports.py`` holds it
to the original.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from queue import Empty, Queue
from typing import Any, Callable, Sequence

from predictionio_tpu_torch.obs.trace import NULL_TRACER, current_context

logger = logging.getLogger("pio.microbatch")

#: compile-once bucket ladder (see module docstring)
DEFAULT_BUCKETS = (1, 4, 16, 64, 128)

#: histogram buckets for batch-size observations (powers of two up to the
#: largest default bucket ladder entry x2)
SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)

#: histogram buckets for queue-wait observations (sub-ms up to a slow
#: window; anything beyond means the flusher itself was busy)
WAIT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 1.0,
)


class BatcherStopped(RuntimeError):
    """Raised by ``submit`` after ``close()``: the server is draining."""


@dataclass
class BatchConfig:
    """Serving-side micro-batching knobs (CLI: ``pio deploy
    --batch-window-ms/--max-batch-size/--batch-buckets``)."""

    max_batch_size: int = 64
    window_ms: float = 2.0
    buckets: tuple = DEFAULT_BUCKETS
    #: early-flush threshold: a batch closes once the queue has been quiet
    #: this long (<= window_ms; the window stays the hard latency cap)
    idle_ms: float = 0.5

    @property
    def enabled(self) -> bool:
        # a 1-query "batch" or a zero window degenerates to the unbatched
        # path with extra queue hops; treat both as explicit opt-outs
        return self.max_batch_size > 1 and self.window_ms > 0


@dataclass
class _Pending:
    query: Any
    future: Future = field(default_factory=Future)
    enqueued: float = field(default_factory=time.perf_counter)
    #: (trace_id, span_id) captured on the request thread at submit; the
    #: flusher fans batch-level spans out to these traces
    trace_ctx: tuple | None = None
    #: the live trace's span list, captured at submit while the root is
    #: guaranteed open -- lets the fan-out run AFTER the future resolves
    #: (off the ack latency path) and still land in the right trace
    trace_spans: list | None = None


class MicroBatcher:
    """Coalesce concurrent ``submit`` calls into padded ``execute`` batches.

    ``execute(queries)`` receives the padded query list and must return one
    result per entry (aligned); ``Exception`` instances as entries are
    delivered as per-request failures.
    """

    def __init__(
        self,
        execute: Callable[[Sequence[Any]], Sequence[Any]],
        config: BatchConfig | None = None,
        metrics=None,
        tracer=None,
    ):
        self._execute = execute
        self._config = config = config or BatchConfig()
        self._metrics = metrics
        self._tracer = tracer if tracer is not None else NULL_TRACER
        if config.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        # the effective ladder: configured buckets capped by max_batch_size,
        # which is always itself a bucket (the "size" flush shape)
        self._buckets = tuple(
            sorted(
                {int(b) for b in config.buckets if 0 < b < config.max_batch_size}
                | {int(config.max_batch_size)}
            )
        )
        self._window_s = config.window_ms / 1000.0
        self._idle_s = min(config.idle_ms, config.window_ms) / 1000.0
        self._queue: Queue = Queue()
        self._closed = False
        #: serializes submit's check-then-put against close's transition:
        #: without it a submit racing close() could enqueue into a queue
        #: whose flusher already drained and exited, stranding the future
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._run, name="pio-microbatcher", daemon=True
        )
        self._worker.start()

    # -- client side --------------------------------------------------------
    def submit(self, query: Any) -> Future:
        """Enqueue one query; the returned future resolves to its result
        (or raises its per-request error)."""
        with self._submit_lock:
            if self._closed:
                raise BatcherStopped(
                    "micro-batcher is draining; server stopping"
                )
            # put_nowait: the queue is unbounded, so this can never block,
            # and saying so keeps the enqueue-under-lock visibly
            # non-blocking (pio check C002)
            item = _Pending(query)
            if self._tracer.enabled:
                item.trace_ctx = current_context()
                if item.trace_ctx is not None:
                    item.trace_spans = self._tracer.live_spans(
                        item.trace_ctx[0]
                    )
            self._queue.put_nowait(item)
        return item.future

    def depth(self) -> int:
        """Approximate queries waiting for a flush -- the serving-tier
        backlog gauge (``pio_serving_queue_depth``) mirrored into
        ``/metrics`` at scrape time. Approximate by design: ``qsize`` is
        racy, and a gauge read between enqueue and flush needs no lock."""
        return self._queue.qsize()

    def close(self) -> None:
        """Stop accepting queries, flush everything in flight, join the
        flusher. Idempotent; safe to call from any thread."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            # under the lock: every accepted submit has already put its
            # item, so the sentinel is guaranteed to sit behind all of them
            # (put_nowait: unbounded queue, cannot block)
            self._queue.put_nowait(None)
        self._worker.join(timeout=30.0)

    # -- flusher ------------------------------------------------------------
    def pad_to(self, n: int) -> int:
        """The bucket the batch pads up to: smallest ladder entry >= n."""
        for b in self._buckets:
            if n <= b:
                return b
        return n  # n > max_batch_size never happens; defensive only

    def _drain_queue(self) -> list[_Pending]:
        out: list[_Pending] = []
        while True:
            try:
                item = self._queue.get_nowait()
            except Empty:
                return out
            if item is not None:
                out.append(item)

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                # drain: everything still queued goes out as one final batch
                leftovers = self._drain_queue()
                if leftovers:
                    self._flush(leftovers, reason="drain")
                return
            batch = [item]
            stopping = False
            try:
                reason, stopping = self._collect(batch)
            except Exception:
                # the flusher is the ONLY serving thread: an unexpected
                # collection bug must flush what it has and keep running,
                # never die silently and wedge every future request
                logger.exception(
                    "batch collection failed; flushing %d queries", len(batch)
                )
                reason = "deadline"
            self._flush(batch, "drain" if stopping else reason)
            if stopping:
                return

    def _collect(self, batch: list[_Pending]) -> tuple[str, bool]:
        """Grow ``batch`` until a flush condition; returns (reason,
        stopping) where stopping means the close() sentinel was seen (the
        remaining queue is already swept into ``batch``)."""
        # sweep the backlog WITHOUT waiting first: if the flusher fell
        # behind (previous batch still executing while traffic queued),
        # everything already waiting coalesces into this batch -- the
        # window bounds waiting for FUTURE arrivals, it must never make
        # an existing backlog trickle out one query at a time
        while len(batch) < self._config.max_batch_size:
            try:
                nxt = self._queue.get_nowait()
            except Empty:
                break
            if nxt is None:
                batch.extend(self._drain_queue())
                return "drain", True
            batch.append(nxt)
        if len(batch) >= self._config.max_batch_size:
            return "size", False
        # the deadline is anchored on the FIRST query's enqueue time, not
        # on "now": if queries already spent their latency budget waiting,
        # the batch they formed flushes immediately
        deadline = batch[0].enqueued + self._window_s
        while True:
            if len(batch) >= self._config.max_batch_size:
                return "size", False
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return "deadline", False
            try:
                nxt = self._queue.get(timeout=min(remaining, self._idle_s))
            except Empty:
                # the arrival gap exceeded idle_ms before the window
                # closed: the coalescing burst is over, flush early
                if deadline - time.perf_counter() <= 0:
                    return "deadline", False
                return "idle", False
            if nxt is None:
                batch.extend(self._drain_queue())
                return "drain", True
            batch.append(nxt)

    def _flush(self, batch: list[_Pending], reason: str) -> None:
        flush_pc = time.perf_counter()
        try:
            self._observe(batch, reason, flush_pc)
        except Exception:
            # telemetry must never take serving down (or kill the flusher)
            logger.warning("batch metrics recording failed", exc_info=True)
        exec_pc = flush_pc
        pad = 0
        try:
            padded = [p.query for p in batch]
            pad = self.pad_to(len(batch)) - len(batch)
            if pad > 0:
                padded.extend([batch[-1].query] * pad)
            exec_pc = time.perf_counter()
            results = self._execute(padded)
            if len(results) != len(padded):
                raise RuntimeError(
                    f"batch execute returned {len(results)} results for "
                    f"{len(padded)} queries"
                )
        except Exception as exc:
            # the execute callback is expected to isolate per-request
            # failures itself; reaching here is a systemic failure and the
            # whole batch reports it
            logger.warning("batch execution failed wholesale", exc_info=True)
            for p in batch:
                p.future.set_exception(exc)
            # the error traces are exactly the ones tail-based retention
            # exists to keep: they still get their queue-wait and batch
            # spans, with the execute stage marked as the failure
            self._trace_fanout(
                batch, reason, pad, flush_pc, exec_pc, status="error"
            )
            return
        # set_result/set_exception run any add_done_callback INLINE on
        # this flusher thread (the async serving tier's completion push
        # rides exactly this); callbacks must follow the module's
        # no-blocking contract or they stall every batch behind them
        for p, result in zip(batch, results):  # padding tail dropped
            if isinstance(result, Exception):
                p.future.set_exception(result)
            else:
                p.future.set_result(result)
        # AFTER the futures: every waiting request thread is already
        # woken; the fan-out's python burns flusher time, not ack latency
        self._trace_fanout(batch, reason, pad, flush_pc, exec_pc)

    def _trace_fanout(
        self,
        batch: list[_Pending],
        reason: str,
        pad: int,
        flush_pc: float,
        exec_pc: float,
        status: str = "ok",
    ) -> None:
        """Write the batch-level spans into every coalesced request's
        trace (shared span ids). Called right after execute returns;
        internally exception-safe -- tracing must never fail a batch."""
        tracer = self._tracer
        if not tracer.enabled:
            return
        try:
            done_pc = time.perf_counter()
            traced = [
                (p.trace_ctx, p.enqueued, p.trace_spans)
                for p in batch if p.trace_ctx is not None
            ]
            if not traced:
                return
            attrs = {
                "batch_size": len(batch),
                "padded_to": len(batch) + pad,
                "reason": reason,
            }
            tracer.record_fanout(
                traced,
                [
                    ("batch.assemble", flush_pc, exec_pc),
                    ("batch.execute", exec_pc, done_pc),
                ],
                attrs=attrs,
                status=status,
            )
        except Exception:
            logger.warning("batch trace recording failed", exc_info=True)

    def _observe(self, batch: list[_Pending], reason: str, now: float) -> None:
        if self._metrics is None:
            return
        self._metrics.observe(
            "pio_serving_batch_size", len(batch), buckets=SIZE_BUCKETS,
            help="Coalesced queries per flush (before bucket padding)",
        )
        for p in batch:
            self._metrics.observe(
                "pio_serving_batch_queue_wait_seconds",
                max(now - p.enqueued, 0.0),
                buckets=WAIT_BUCKETS,
                help="Per-query wait between enqueue and batch flush",
            )
        self._metrics.inc(
            "pio_serving_batch_flush_total", {"reason": reason},
            help="Batch flushes by closing reason (size|deadline|idle|drain)",
        )
        pad = self.pad_to(len(batch)) - len(batch)
        if pad:
            self._metrics.inc(
                "pio_serving_batch_padding_rows_total", amount=pad,
                help="Padded (wasted) slots executed to hit a bucket shape",
            )
