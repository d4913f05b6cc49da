"""Scorer-side bridge of the multi-process serving tier.

The scorer process (the one that owns the device, the models, and the
``MicroBatcher``) runs a :class:`ScorerBridge` instead of an HTTP
listener: it spawns N frontend worker processes (fresh interpreters via
``subprocess`` -- never ``fork()``: this process is full of threads and
locks, the exact hazard ``pio check`` C004 exists for), consumes their
request rings, and answers through two dispatch paths:

- **The async fast path** (``dispatch="async"``, the default with
  batching on): the ring consumer itself parses a ``POST /queries.json``
  frame and submits it straight into the micro-batcher
  (``QueryService.submit_query_async``); a ``Future.add_done_callback``
  running on the batcher's FLUSHER thread serializes the response and
  pushes the completion ring entry. Zero dispatcher threads touch the
  query path, and a request costs TWO cross-thread wakeups (consumer
  eventfd wake + completion eventfd) instead of the sync chain's five
  (consumer wake -> SimpleQueue handoff -> dispatcher -> flusher ->
  future wake -> completion push). Because the pushing thread is the
  flusher, a full completion ring must NEVER park it -- overflow lands
  on a timer-driven retry queue (:class:`_CompletionRetry`) and the
  flusher moves on. ``pio check`` C005 statically gates the
  no-blocking-in-done-callbacks contract this creates.
- **The dispatcher pool** survives for control routes (``/metrics``,
  ``/models/*``, ``/reload``, ``/stop``, the info page -- everything
  that is not a query) and as the whole dispatch model when
  ``dispatch="sync"`` or batching is off: frames go through the
  unchanged :class:`~predictionio_tpu_torch.utils.http.Router` on pool
  threads, exactly the pre-async tier.

Either way responses are produced by the same router/service code, so
bodies stay byte-identical across dispatch modes and vs single-process.

Port discovery without a blackhole window: the bridge binds ONE
``SO_REUSEPORT`` socket on the requested port (port 0 resolves to a real
ephemeral port) and keeps it bound but **never listening** -- a TCP
socket that has not called ``listen()`` is not in the kernel's
``SO_REUSEPORT`` delivery group, so it reserves the port for respawns
without stealing SYNs from the workers.

Supervision: a SIGKILLed worker is respawned with a fresh ring file under
a bumped generation; completions addressed to the dead generation are
dropped (its clients are gone with its sockets), and everything else
keeps serving. Backpressure: the bridge admits at most ``max_inflight``
requests into the scorer (fast path and pool alike); beyond that it
simply stops popping, the rings fill, and the frontends answer 429 --
the ingest pipeline's bounded-queue contract at the serving tier.

The wakeup budget is MEASURED, not asserted: eventfd wakes and thread
handoffs on the query path feed ``pio_scorer_wakeups_per_request`` (and
``pio_scorer_dispatch_threads``), rendered by ``pio top`` -- the gauges
behind the 5-to-2 claim.

Port copy: ``predictionio_tpu/serving/procserver.py`` (framework-free), verbatim,
under the port's package name; ``tests/test_torch_imports.py`` holds it
to the original.
"""

from __future__ import annotations

import logging
import os
import queue
import select
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from urllib.parse import parse_qs, urlsplit

from predictionio_tpu_torch.serving import shmring
from predictionio_tpu_torch.utils.http import Request

logger = logging.getLogger("pio.procserver")


@dataclass
class FrontendConfig:
    """Process-tier knobs (CLI: ``pio deploy --frontend-workers N``)."""

    workers: int = 2
    #: per-direction ring capacity (messages); the backpressure horizon
    ring_slots: int = 128
    #: per-slot byte budget; bigger messages spill to one-off files
    slot_bytes: int = 32768
    #: concurrent requests admitted into the scorer (the backpressure
    #: horizon and, with batching, the micro-batcher's coalescing
    #: ceiling). Under ``dispatch="sync"`` it is ALSO the dispatcher
    #: thread count -- and must stay small there: measured on the 2-core
    #: box, 64 dispatcher threads collapsed throughput 13x (every batch
    #: completion woke a thread herd that thrashed the GIL and
    #: scheduler). The async fast path has no per-request threads, so
    #: this is pure admission control.
    max_inflight: int = 16
    #: dispatch model: "async" (ring consumer -> micro-batcher future ->
    #: flusher callback; zero dispatcher threads on the query path) or
    #: "sync" (the dispatcher-pool tier, kept for A/B and for
    #: batching-disabled deploys, which always use the pool)
    dispatch: str = "async"
    #: pool threads kept for CONTROL routes under async dispatch
    #: (/metrics, /models/*, /reload, ...); query traffic never uses them
    control_threads: int = 2
    #: ``sched_setaffinity`` pinning: frontend workers get one core each
    #: from the top of the process affinity set, the scorer keeps the
    #: rest (CLI --pin-cpus / PIO_PIN_CPUS=1). No-op with <2 cores or on
    #: platforms without sched_setaffinity.
    pin_cpus: bool = False
    #: how often a worker publishes its metrics snapshot
    stats_flush_s: float = 0.25
    #: how long to wait for a spawned worker to reach READY
    spawn_timeout_s: float = 40.0

    def __post_init__(self) -> None:
        if self.dispatch not in ("async", "sync"):
            raise ValueError(
                f"dispatch must be 'async' or 'sync', got {self.dispatch!r}"
            )

    def describe(self) -> dict:
        return {
            "workers": self.workers,
            "ringSlots": self.ring_slots,
            "slotBytes": self.slot_bytes,
            "maxInflight": self.max_inflight,
            "dispatch": self.dispatch,
            "pinCpus": self.pin_cpus,
        }


class _Worker:
    """One spawned frontend: its ring, process handle, and generation.
    Under the sharded fabric's ATTACHED bridges the ring belongs to a
    frontend some other process supervises, so ``proc`` is None."""

    def __init__(self, index: int, generation: int, ring: shmring.RingFile,
                 proc: subprocess.Popen | None = None):
        self.index = index
        self.generation = generation
        self.ring = ring
        self.proc = proc
        self.dead = False
        #: serializes pool threads producing into the SPSC completion ring
        self.cmp_lock = threading.Lock()


class _CompletionRetry:
    """Timer-driven retry for completions that hit a full completion
    ring. The sync tier parked the dispatcher thread that hit
    ``RingFull`` (bounded at 5 s); on the async fast path the pushing
    thread is the micro-batcher's FLUSHER, and parking it would stall
    every in-flight batch behind one briefly-descheduled worker. So
    full-ring completions are parked here instead and one timer thread
    retries them every couple of milliseconds until the worker drains a
    slot, the worker dies (respawn: its clients are gone), or the
    deadline expires and the response is dropped with a warning --
    exactly the sync tier's bounded-retry contract, minus the parked
    thread. The thread sleeps on a condition variable whenever the queue
    is empty, so the common case (rings never full) costs nothing.

    Each parked entry still owns its admission permit
    (``ScorerBridge._inflight``); the permit is released when the entry
    resolves, so a backed-up worker keeps exerting backpressure."""

    _INTERVAL_S = 0.002
    _DEADLINE_S = 5.0

    def __init__(self, bridge: "ScorerBridge"):
        self._bridge = bridge
        self._cv = threading.Condition()
        #: [worker, rmeta, payload, is_query, deadline]
        self._entries: list = []
        self._stopped = False
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="pio-scorer-cmp-retry", daemon=True
        )
        self._thread.start()

    def depth(self) -> int:
        with self._cv:
            return len(self._entries)

    def add(self, w: _Worker, rmeta: dict, payload: bytes,
            is_query: bool) -> None:
        with self._cv:
            if not self._stopped:
                self._entries.append(
                    (w, rmeta, payload, is_query,
                     time.monotonic() + self._DEADLINE_S)
                )
                self._cv.notify()
                return
        # stopped: the tier is tearing down; drop, release the permit
        self._bridge._inflight.release()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            leftovers = len(self._entries)
            self._entries.clear()
            self._cv.notify()
        for _ in range(leftovers):
            self._bridge._inflight.release()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._entries and not self._stopped:
                    self._cv.wait()
                if self._stopped:
                    return
                entries = self._entries
                self._entries = []
            keep = []
            for entry in entries:
                w, rmeta, payload, is_query, deadline = entry
                pushed = dead = False
                with w.cmp_lock:
                    if w.dead:
                        dead = True
                    else:
                        try:
                            w.ring.completions.push(rmeta, payload)
                            pushed = True
                        except shmring.RingFull:
                            pass
                if dead:
                    self._bridge._inflight.release()
                    continue
                self._bridge._wakes[w.index][1].signal()
                if pushed:
                    if is_query:
                        self._bridge._n_signals += 1
                    self._bridge._inflight.release()
                elif time.monotonic() > deadline:
                    logger.warning(
                        "completion ring full for worker %d for >%.0fs; "
                        "dropping response", w.index, self._DEADLINE_S,
                    )
                    self._bridge._inflight.release()
                else:
                    keep.append(entry)
            if keep:
                with self._cv:
                    if self._stopped:
                        for _ in keep:
                            self._bridge._inflight.release()
                        return
                    self._entries = keep + self._entries
                time.sleep(self._INTERVAL_S)


class ScorerBridge:
    """Spawn/supervise frontends; pump rings through the router (control
    routes / sync mode) or straight into the micro-batcher (the async
    query fast path)."""

    def __init__(
        self,
        router,
        host: str,
        port: int,
        config: FrontendConfig | None = None,
        server_name: str = "pio-queryserver",
        registry=None,
        async_query=None,
        attach: list | None = None,
    ):
        self._router = router
        self._host = host
        self._requested_port = port
        self.config = config or FrontendConfig()
        #: ATTACHED mode (the sharded fabric): ``attach`` is a list of
        #: ``(RingFile, wake_req, wake_cmp)`` triples for rings some
        #: OTHER process created and whose producers it supervises. The
        #: bridge only pumps: no port reservation, no spawning, no
        #: respawn supervision, no cpu pinning -- teardown closes this
        #: process's mappings and stops its threads, nothing else.
        self._attach = attach
        if attach is None and self.config.workers < 1:
            raise ValueError("frontend workers must be >= 1")
        self._server_name = server_name
        self._registry = registry
        self._reserve: socket.socket | None = None
        self.port: int | None = None
        self._dir: str | None = None
        #: index -> (req, cmp, stop) wakeups; created once, reused across
        #: respawns so the consumer's select set never churns
        self._wakes: dict[int, tuple] = {}
        self._workers: list[_Worker] = []
        self._lock = threading.Lock()
        self._inflight = threading.Semaphore(self.config.max_inflight)
        self._draining = False
        self._stopping = False
        #: consumer -> dispatcher hand-off; SimpleQueue's C put/get is the
        #: cheapest in-process wakeup available (no Future allocation)
        self._work: queue.SimpleQueue = queue.SimpleQueue()
        self._dispatchers: list[threading.Thread] = []
        self._consumer: threading.Thread | None = None
        self._supervisor: threading.Thread | None = None
        self._respawns = 0
        #: serializes stop() callers end-to-end (idempotent teardown)
        self._stop_lock = threading.Lock()
        #: the async fast path: ``(request, on_done)`` submitter
        #: (``QueryService.submit_query_async``); None = every frame goes
        #: through the dispatcher pool (the sync tier)
        self._async_query = async_query
        self._retry = _CompletionRetry(self)
        #: worker index -> cpu core, fixed at start() so respawns re-pin
        self._pin_map: dict[int, int] | None = None
        #: the process affinity before --pin-cpus narrowed it; restored
        #: at teardown
        self._orig_affinity: set | None = None
        # -- measured wakeup budget (query path only; plain ints, +=
        # is GIL-atomic enough for telemetry) --------------------------
        #: query frames popped from the rings
        self._n_query = 0
        #: consumer select-wakes consumed by a query frame (the first
        #: frame popped after a wake claims it; the rest of the drain is
        #: the amortization the batching design pays for)
        self._n_wakes_query = 0
        #: query frames handed to the dispatcher pool (sync mode only)
        self._n_handoffs = 0
        #: completion-ring signal()s for query responses
        self._n_signals = 0
        #: worker index -> "a req-eventfd wake is unclaimed" flag
        self._wake_pending: dict[int, bool] = {}

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ScorerBridge":
        if self._attach is not None:
            return self._start_attached()
        if not hasattr(socket, "SO_REUSEPORT"):
            raise RuntimeError(
                "multi-process serving needs SO_REUSEPORT (Linux/BSD); "
                "deploy without --frontend-workers on this platform"
            )
        try:
            self._reserve = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._reserve.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            self._reserve.bind((self._host, self._requested_port))
            self.port = self._reserve.getsockname()[1]
            self._dir = tempfile.mkdtemp(prefix="pio-frontend-")
            self._pin_map = self._pin_plan()
            if self._pin_map is not None:
                try:
                    # remember the pre-pin mask: teardown restores it, so
                    # back-to-back pinned bridges in one process (the
                    # bench's A/B arms, the sweep test) each plan from
                    # the FULL affinity set instead of the previous arm's
                    # shrunken one
                    self._orig_affinity = os.sched_getaffinity(0)
                    os.sched_setaffinity(0, self._pin_map["scorer"])
                    logger.info(
                        "pinned scorer to cpus %s",
                        sorted(self._pin_map["scorer"]),
                    )
                except OSError:
                    logger.warning(
                        "cpu pinning failed for scorer", exc_info=True
                    )
            # async fast path: the pool only ever sees control routes, so
            # a couple of threads suffice; sync mode keeps the full
            # max_inflight-wide pool (= the query dispatch concurrency)
            n_dispatch = (
                self.config.max_inflight
                if self._async_query is None
                else max(1, min(self.config.control_threads,
                                self.config.max_inflight))
            )
            for k in range(n_dispatch):
                t = threading.Thread(
                    target=self._dispatch_loop, name=f"pio-scorer-{k}",
                    daemon=True,
                )
                t.start()
                self._dispatchers.append(t)
            self._retry.start()
            for i in range(self.config.workers):
                self._wakes[i] = (
                    shmring.Wakeup.create(self._dir, f"req-{i}"),
                    shmring.Wakeup.create(self._dir, f"cmp-{i}"),
                    shmring.Wakeup.create(self._dir, f"stop-{i}"),
                )
                self._workers.append(self._launch(i, generation=1))
            self._await_ready(self._workers)
        except BaseException:
            # a half-started tier must not outlive this call: workers
            # that already reached READY are listening on the port with
            # no consumer behind them -- clients would hang, and the
            # orphans would hold the port after the parent dies
            self._teardown(kill=True)
            raise
        self._start_consumer()
        self._supervisor = threading.Thread(
            target=self._supervise, name="pio-scorer-supervisor", daemon=True
        )
        self._supervisor.start()
        self._gauge_workers()
        return self

    def _start_consumer(self) -> None:
        # ONE creation site for the consumer role: `_wake_pending` (and
        # the wakeup-budget counters) are confined to this thread, and
        # both the spawned and the attached start paths must share that
        # confinement
        self._consumer = threading.Thread(
            target=self._consume, name="pio-scorer-consumer", daemon=True
        )
        self._consumer.start()

    def _start_attached(self) -> "ScorerBridge":
        """Start over pre-created rings: dispatcher pool + retry timer +
        consumer, nothing that owns processes or sockets. The same
        wake_req object may back several ring indexes (one shard's
        request eventfd is signalled by every frontend); duplicate fds in
        the consumer's select set are harmless, and ``Wakeup.close`` is
        idempotent per object."""
        for i, (ring, wake_req, wake_cmp) in enumerate(self._attach):
            self._wakes[i] = (wake_req, wake_cmp)
            self._workers.append(_Worker(i, ring.generation, ring))
        n_dispatch = (
            self.config.max_inflight
            if self._async_query is None
            else max(1, min(self.config.control_threads,
                            self.config.max_inflight))
        )
        for k in range(n_dispatch):
            t = threading.Thread(
                target=self._dispatch_loop, name=f"pio-scorer-{k}",
                daemon=True,
            )
            t.start()
            self._dispatchers.append(t)
        self._retry.start()
        self._start_consumer()
        return self

    def _stop_attached(self) -> None:
        with self._lock:
            if self._stopping:
                return
            self._draining = True
            self._stopping = True
        if self._consumer is not None:
            self._consumer.join(timeout=5.0)
        for _ in self._dispatchers:
            self._work.put(None)
        for t in self._dispatchers:
            t.join(timeout=10.0)
        self._retry.stop()
        # snapshot under the bridge lock: in spawned mode the supervisor
        # swaps _workers slots on respawn under this lock (attached mode
        # has no supervisor, but the discipline is one lock for the list)
        with self._lock:
            workers = list(self._workers)
        seen: set[int] = set()
        for w in workers:
            with w.cmp_lock:
                w.dead = True
            w.ring.close()
        for wakes in self._wakes.values():
            for wake in wakes:
                if id(wake) not in seen:
                    seen.add(id(wake))
                    wake.close()

    def _pin_plan(self) -> dict | None:
        """The --pin-cpus core assignment: frontends take one core each
        from the TOP of the process affinity set, the scorer keeps the
        rest (its consumer, flusher, and BLAS threads want headroom).
        With fewer spare cores than workers, workers share the spare set
        round-robin (the 2-core box: scorer on core 0, every frontend on
        core 1). Skipped -- loudly -- when pinning cannot help."""
        if not self.config.pin_cpus:
            return None
        if not hasattr(os, "sched_setaffinity"):
            logger.warning("--pin-cpus unsupported on this platform")
            return None
        try:
            cores = sorted(os.sched_getaffinity(0))
        except OSError:
            logger.warning("--pin-cpus skipped: affinity unreadable")
            return None
        if len(cores) < 2:
            logger.warning(
                "--pin-cpus skipped: only %d cpu(s) available", len(cores)
            )
            return None
        n_frontend = min(self.config.workers, len(cores) - 1)
        frontend = cores[len(cores) - n_frontend:]
        return {
            "scorer": set(cores[: len(cores) - n_frontend]),
            "workers": {
                i: frontend[i % n_frontend]
                for i in range(self.config.workers)
            },
        }

    def _launch(self, index: int, generation: int) -> _Worker:
        path = os.path.join(self._dir, f"worker-{index}.ring")
        ring = shmring.RingFile.create(
            path, self.config.ring_slots, self.config.slot_bytes, generation
        )
        wake_req, wake_cmp, wake_stop = self._wakes[index]
        cmd = [
            sys.executable, "-m", "predictionio_tpu_torch.serving.frontend",
            "--ring", path,
            "--host", self._host,
            "--port", str(self.port),
            "--worker", str(index),
            "--wake-req", wake_req.spec(),
            "--wake-cmp", wake_cmp.spec(),
            "--wake-stop", wake_stop.spec(),
            "--server-name", self._server_name,
            "--stats-flush-s", str(self.config.stats_flush_s),
        ]
        if self._pin_map is not None:
            cmd += ["--pin-cpu", str(self._pin_map["workers"][index])]
        env = dict(os.environ)
        # the worker interpreter must find this package without an install
        pkg_parent = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
        pass_fds = tuple(
            fd for w in (wake_req, wake_cmp, wake_stop)
            if (fd := w.pass_fd) is not None
        )
        log = open(os.path.join(self._dir, f"worker-{index}.log"), "ab")
        try:
            proc = subprocess.Popen(
                cmd, pass_fds=pass_fds, env=env,
                stdout=log, stderr=subprocess.STDOUT,
            )
        finally:
            log.close()
        logger.info(
            "frontend worker %d spawned (pid %d, generation %d)",
            index, proc.pid, generation,
        )
        return _Worker(index, generation, ring, proc)

    def _await_ready(self, workers: list[_Worker]) -> None:
        deadline = time.monotonic() + self.config.spawn_timeout_s
        pending = list(workers)
        while pending:
            pending = [
                w for w in pending if w.ring.state == shmring.STATE_INIT
            ]
            if not pending:
                return
            for w in pending:
                if w.proc.poll() is not None:
                    raise RuntimeError(
                        f"frontend worker {w.index} exited "
                        f"rc={w.proc.returncode} before READY "
                        f"(log: {self._worker_log_tail(w.index)!r})"
                    )
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"frontend worker(s) "
                    f"{[w.index for w in pending]} not READY within "
                    f"{self.config.spawn_timeout_s}s"
                )
            time.sleep(0.02)

    def _worker_log_tail(self, index: int, limit: int = 500) -> str:
        try:
            with open(os.path.join(self._dir, f"worker-{index}.log"), "rb") as f:
                return f.read()[-limit:].decode("utf-8", "replace")
        except OSError:
            return ""

    def stop(self) -> None:
        """Graceful drain: workers stop accepting and finish in-flight
        requests (the bridge keeps dispatching while they do), then the
        pool drains and everything is torn down. Idempotent; concurrent
        callers serialize and the second is a no-op."""
        with self._stop_lock:
            if self._attach is not None:
                self._stop_attached()
            else:
                self._stop_locked()

    def _stop_locked(self) -> None:
        with self._lock:
            if self._stopping:
                return
            self._draining = True
        for _, _, wake_stop in self._wakes.values():
            wake_stop.signal()
        # a draining worker legitimately waits up to the frontend's
        # forward timeout for an in-flight answer (first-bucket jit
        # compiles are the sized-for case); killing it sooner would drop
        # exactly the requests the drain contract promises to answer
        from predictionio_tpu_torch.serving.frontend import FORWARD_TIMEOUT_S

        deadline = time.monotonic() + FORWARD_TIMEOUT_S + 5.0
        with self._lock:
            # the supervisor may have been mid-respawn when _draining
            # flipped: its install runs under this lock, so snapshot
            # under it too (pio check C006)
            workers = list(self._workers)
        for w in workers:
            timeout = max(deadline - time.monotonic(), 0.1)
            try:
                w.proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                logger.warning(
                    "frontend worker %d did not drain; killing", w.index
                )
                w.proc.kill()
                try:
                    w.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass
        with self._lock:
            self._stopping = True
        if self._consumer is not None:
            self._consumer.join(timeout=5.0)
        if self._supervisor is not None:
            self._supervisor.join(timeout=5.0)
        self._teardown()

    def _teardown(self, kill: bool = False) -> None:
        """Release every tier resource; with ``kill`` the workers are
        SIGKILLed first (the start()-failed path, where a graceful drain
        has nothing to drain and orphans must not survive)."""
        with self._lock:
            self._draining = True
            self._stopping = True
            # snapshot under the lock: the supervisor may still be
            # installing a respawned worker into the list (pio check
            # C006 -- the write side holds this lock too)
            workers = list(self._workers)
        for w in workers:
            if kill and w.proc.poll() is None:
                w.proc.kill()
        for w in workers:
            try:
                w.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                pass
        # sentinels queue BEHIND any in-flight work: dispatchers finish
        # the stragglers, then exit
        for _ in self._dispatchers:
            self._work.put(None)
        for t in self._dispatchers:
            t.join(timeout=10.0)
        self._retry.stop()
        for w in workers:
            # a straggler async callback (flusher-side) racing this
            # teardown must see dead and drop, not push into a closed
            # mapping -- the same dead-before-close protocol the
            # supervisor uses on respawn
            with w.cmp_lock:
                w.dead = True
            w.ring.close()
        for wakes in self._wakes.values():
            for wake in wakes:
                wake.close()
        if self._reserve is not None:
            self._reserve.close()
            self._reserve = None
        if self._orig_affinity is not None:
            try:
                os.sched_setaffinity(0, self._orig_affinity)
            except OSError:
                pass
            self._orig_affinity = None
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)

    # -- request pump -------------------------------------------------------
    def _consume(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    return
                workers = list(self._workers)
            progressed = False
            for w in workers:
                if w.dead:
                    continue
                try:
                    while w.ring.requests.pending():
                        # admission control: no permit -> stop popping;
                        # the ring backs up and the frontend answers 429
                        if not self._inflight.acquire(timeout=0.5):
                            with self._lock:
                                if self._stopping:
                                    return
                            break
                        try:
                            msg = w.ring.requests.pop()
                        except BaseException:
                            # the supervisor can close a retired worker's
                            # ring between the acquire and this read; the
                            # permit must ride every exit out of the pop,
                            # or each lost race permanently shrinks
                            # max_inflight (pio check R001)
                            self._inflight.release()
                            raise
                        if msg is None:
                            self._inflight.release()
                            break
                        progressed = True
                        self._route(w, msg)
                except (ValueError, OSError):
                    # the supervisor retired this worker and closed its
                    # ring between our dead-check and the read; the ONLY
                    # popping thread must survive the race, not die on it
                    if not w.dead:
                        logger.exception(
                            "request ring read failed for live worker %d",
                            w.index,
                        )
                    continue
            if progressed:
                continue
            fds = [wakes[0].fileno() for wakes in self._wakes.values()]
            try:
                ready, _, _ = select.select(fds, [], [], 0.25)
            except OSError:
                ready = []
            for index, wakes in self._wakes.items():
                if wakes[0].fileno() in ready:
                    wakes[0].drain()
                    self._wake_pending[index] = True

    @staticmethod
    def _is_query(meta: dict) -> bool:
        return (
            meta.get("m") == "POST"
            and meta.get("t", "").split("?", 1)[0] == "/queries.json"
        )

    def _route(self, w: _Worker, msg: tuple) -> None:
        """Classify one popped frame: ``POST /queries.json`` takes the
        async fast path ON THIS THREAD (when wired); everything else --
        and every frame in sync mode -- goes to the dispatcher pool. The
        frame that claims a pending eventfd wake also books it against
        its path's wakeup budget."""
        meta = msg[0]
        is_query = self._is_query(meta)
        woke = bool(self._wake_pending.get(w.index))
        if woke:
            self._wake_pending[w.index] = False
        if is_query:
            self._n_query += 1
            if woke:
                self._n_wakes_query += 1
            if self._async_query is not None:
                self._submit_query(w, msg)
                return
            self._n_handoffs += 1
        self._work.put((w, msg))

    def _build_request(self, meta: dict, body: bytes) -> Request:
        parsed = urlsplit(meta["t"])
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        return Request(
            method=meta["m"],
            path=parsed.path,
            query=query,
            headers=dict(meta.get("h") or {}),
            body=body,
            path_params={},
            frontend_pc=(
                meta["p"], time.perf_counter(), meta.get("w", "?")
            ),
        )

    def _submit_query(self, w: _Worker, msg: tuple) -> None:
        """The async fast path entry: build the Request and hand it to
        ``submit_query_async`` with this frame's completion continuation.
        ``on_done`` fires exactly once -- synchronously for immediate
        errors, from the micro-batcher's flusher otherwise."""
        meta, body = msg
        try:
            request = self._build_request(meta, body)
            self._async_query(
                request,
                lambda response, w=w, meta=meta: self._complete_query(
                    w, meta, response
                ),
            )
        except Exception:
            # submit_query_async answers its own failures; anything
            # reaching here happened BEFORE the hand-off, so the frame
            # still owes its frontend an answer (and its permit back)
            logger.exception("async submit failed for %s", meta.get("t"))
            from predictionio_tpu_torch.utils.http import Response

            self._complete_query(
                w, meta, Response(500, {"message": "internal server error"})
            )

    def _complete_query(self, w: _Worker, meta: dict, response) -> None:
        """Terminal continuation of the async fast path. Usually runs on
        the micro-batcher's flusher thread, so it MUST NOT block: one
        non-blocking ring push; overflow parks on the timer retry queue
        (``pio check`` C005 gates this contract)."""
        try:
            payload = response.payload()
            rmeta = {
                "i": meta["i"],
                "s": response.status,
                "c": response.content_type,
                "h": response.headers,
            }
        except Exception:
            logger.exception("completion serialization failed")
            self._inflight.release()
            return
        self._deliver(w, rmeta, payload, is_query=True)

    def _dispatch_loop(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            self._handle(*item)

    def _handle(self, w: _Worker, msg: tuple) -> None:
        delivered = False
        try:
            meta, body = msg
            request = self._build_request(meta, body)
            try:
                response = self._router.dispatch(request)
            except Exception:
                # the router has its own backstops; anything escaping is a
                # dispatch-layer bug, answered like make_server would
                logger.exception("dispatch failed for %s", request.path)
                from predictionio_tpu_torch.utils.http import Response

                response = Response(500, {"message": "internal server error"})
            payload = response.payload()
            rmeta = {
                "i": meta["i"],
                "s": response.status,
                "c": response.content_type,
                "h": response.headers,
            }
            delivered = True  # _deliver owns the permit from here on
            self._deliver(w, rmeta, payload, is_query=self._is_query(meta))
        except Exception:
            logger.exception("completion delivery failed")
        finally:
            if not delivered:
                self._inflight.release()

    def _deliver(
        self, w: _Worker, rmeta: dict, payload: bytes, is_query: bool
    ) -> None:
        """Push one completion toward its worker. Never blocks, never
        raises; owns the inflight permit (released on success, drop, or
        handed to the retry queue with the parked entry).

        A briefly-descheduled worker (measured: ~300 ms scheduler stalls
        under load on sandboxed kernels) can leave its completion ring
        momentarily full; DROPPING would turn that stall into a client
        timeout, so the overflow is parked on the timer retry queue with
        the same 5 s bound the sync tier used -- the worker only has to
        run once within it to drain 128 slots."""
        try:
            pushed = False
            with w.cmp_lock:
                if w.dead:
                    # a respawn retired this worker mid-score: its
                    # clients died with its sockets, drop the answer
                    self._inflight.release()
                    return
                try:
                    w.ring.completions.push(rmeta, payload)
                    pushed = True
                except shmring.RingFull:
                    pass
            self._wakes[w.index][1].signal()
            if pushed:
                if is_query:
                    self._n_signals += 1
                self._inflight.release()
            else:
                self._retry.add(w, rmeta, payload, is_query)
        except Exception:
            logger.exception(
                "completion delivery failed for worker %d", w.index
            )
            self._inflight.release()

    def wakeup_stats(self) -> dict:
        """Measured wakeup/handoff counters for the QUERY path -- the
        source of the ``pio_scorer_wakeups_per_request`` and
        ``pio_scorer_dispatch_threads`` gauges (mirrored into /metrics by
        the query service). ``wake_events`` counts consumer eventfd wakes
        CLAIMED by a query frame (the first frame popped after a wake;
        later frames in the same drain ride it for free -- that
        amortization is real, so it is measured, not assumed)."""
        return {
            "query_requests": self._n_query,
            "wake_events": self._n_wakes_query,
            "handoffs": self._n_handoffs,
            "completion_signals": self._n_signals,
            "dispatch_threads": (
                0 if self._async_query is not None else len(self._dispatchers)
            ),
            "retry_depth": self._retry.depth(),
            "eventfd_signals": sum(
                wakes[1].signals for wakes in self._wakes.values()
            ),
            "eventfd_wakes": sum(
                wakes[0].wakes for wakes in self._wakes.values()
            ),
        }

    # -- supervision --------------------------------------------------------
    #: consecutive failed respawns of one worker index before giving up
    #: (the index stays down; serving continues on surviving workers)
    _MAX_RESPAWN_FAILURES = 6

    def _supervise(self) -> None:
        #: index -> (consecutive failures, next attempt monotonic time)
        backoff: dict[int, tuple[int, float]] = {}
        while True:
            time.sleep(0.2)
            with self._lock:
                if self._stopping or self._draining:
                    return
                workers = list(self._workers)
            for w in workers:
                if w.proc.poll() is None or w.dead:
                    continue
                logger.warning(
                    "frontend worker %d died (rc=%s); respawning",
                    w.index, w.proc.returncode,
                )
                w.dead = True
                backoff.setdefault(w.index, (0, time.monotonic()))
            for index in sorted(backoff):
                failures, next_try = backoff[index]
                if time.monotonic() < next_try:
                    continue
                with self._lock:
                    old = self._workers[index]
                replacement = self._launch(index, old.generation + 1)
                try:
                    self._await_ready([replacement])
                except RuntimeError:
                    # a replacement that never reached READY must NOT be
                    # installed (the next sweep would respawn it at 5/s
                    # forever); back off exponentially, then give up loud
                    logger.exception(
                        "respawned frontend worker %d failed to start "
                        "(attempt %d)", index, failures + 1,
                    )
                    replacement.proc.kill()
                    replacement.ring.close()
                    failures += 1
                    if failures >= self._MAX_RESPAWN_FAILURES:
                        logger.error(
                            "giving up on frontend worker %d after %d "
                            "failed respawns; serving continues on the "
                            "remaining workers", index, failures,
                        )
                        del backoff[index]
                    else:
                        backoff[index] = (
                            failures,
                            time.monotonic() + min(0.5 * 2 ** failures, 30.0),
                        )
                    continue
                with self._lock:
                    if self._draining or self._stopping:
                        replacement.proc.kill()
                        return
                    self._workers[index] = replacement
                    self._respawns += 1
                del backoff[index]
                with old.cmp_lock:
                    # dead=True is already visible: in-flight completions
                    # skip the push, so nobody holds the mapping we close
                    old.ring.close()
                self._gauge_workers()

    def _gauge_workers(self) -> None:
        if self._registry is None:
            return
        self._registry.set_gauge(
            "pio_frontend_workers", float(self.config.workers),
            help="Configured frontend worker processes",
        )
        self._registry.set_counter(
            "pio_frontend_respawns_total", float(self._respawns),
            help="Frontend workers respawned after unexpected exit",
        )

    # -- metrics aggregation ------------------------------------------------
    def metric_snapshots(self) -> list[dict]:
        """Every live worker's published registry snapshot (the
        ``extra_snapshots`` hook of ``instrumented_router``)."""
        with self._lock:
            workers = list(self._workers)
        out = []
        for w in workers:
            if w.dead:
                continue
            try:
                snap = w.ring.read_stats()
            except (ValueError, OSError):
                continue  # retired ring closed mid-scrape
            if snap:
                out.append(snap)
        return out
