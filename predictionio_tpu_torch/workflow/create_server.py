"""Query server of the port: the reference's ``QueryService`` on its router.

Port of ``predictionio_tpu/workflow/create_server.py`` over the variant's
``Engine`` (``workflow/json_extractor.py::build_engine``), on
``utils/http.py``'s ``instrumented_router`` and ``make_server``. An
epoch is the engine's algorithms, their models (``Engine.prepare_deploy``:
rehydrated from a blob, retrained at deploy for ``persist_model =
False``, partitioned for a shard, warmed up) and its Serving:

- ``POST /queries.json``: JSON query -> every algorithm's ``predict`` ->
  ``serving.serve`` -> JSON result (+ ``prId`` with feedback on), through the micro-batcher
  by default (``workflow/microbatch.py``: at most 64 queries, a 2 ms
  window, buckets 1/4/16/64/128). Concurrent queries become one
  ``batch_predict`` of each algorithm and one ``serve_batch``; on the
  recommendation template with ``"retrieval":
  {"mode": "mips"}`` that is one B2 launch per flushed batch of known
  users. Bodies are byte-identical to the unbatched path
  (``max_batch_size=1`` or ``window_ms=0``), which answers one
  ``predict`` per request;
- ``GET /`` (status), ``GET /models.json`` (the registry's versions),
  ``GET /reload`` (the latest COMPLETED instance), ``POST /stop``,
  ``POST /models/swap`` (the swap epoch) and ``POST /models/lag``;
  ``GET /metrics`` and ``GET /traces.json`` from the router;
- plugins (``EngineServerPlugin``), the feedback loop to the event
  server (``FeedbackConfig``), the async fast path of the multi-process
  tier (``submit_query_async``), the per-shard memory budget
  (``PIO_SHARD_BUDGET_BYTES``) and the shard identity of the sharded
  fabric (``shard`` / ``num_shards``: ``Engine.shard_models``, or a
  registry version's per-shard blob);
- ``create_query_server``, ``create_multiproc_query_server`` (the
  ``SO_REUSEPORT`` frontend tier, ``serving/procserver.py``),
  ``create_sharded_query_server`` (``serving/fabric.py``) and
  ``run_query_server``, the blocking entry point of ``pio deploy``.

What the port keeps of its own: an explicit ``device`` (``cuda`` unless
the caller names ``"cpu"``; with no card and no such request the load
raises -- the reference's fallback to the host backend is not copied),
the engine.json's algorithm params for serving (so a serving knob such as
``retrieval`` may change after training; each blob entry must name the
block it serves), and three loaders: a model directory (``model_path``,
one algorithm block with ``model_files``), an engine instance's blob, or
a registry version (``model_version``). A ``warm_up`` that raises fails
the load (the reference logs it and serves on). ``/metrics`` also
carries the launch count of every kernel wrapper this process imported
(``pio_kernel_launches_total{kernel="mips_block_topk"}``, ...:
``ops/launches.py``), which is how a deployed or shard process's
launches are read from outside it.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import threading
import time as _time
import uuid
from concurrent.futures import TimeoutError as _FutureTimeout
from dataclasses import dataclass
from typing import Any

from predictionio_tpu_torch.controller.base import TrainContext
from predictionio_tpu_torch.obs.trace import (
    NULL_SPAN,
    SAMPLED_OUT_ROOT,
    format_traceparent,
)
from predictionio_tpu_torch.ops import launches
from predictionio_tpu_torch.utils.http import (
    Request,
    Response,
    ServiceThread,
    instrumented_router,
    make_server,
)
from predictionio_tpu_torch.workflow.microbatch import (
    BatchConfig,
    BatcherStopped,
    MicroBatcher,
)
from predictionio_tpu_torch.utils.device import resolve_device
from predictionio_tpu_torch.workflow.core_workflow import resolve_engine_instance
from predictionio_tpu_torch.workflow.json_extractor import EngineVariant, build_engine

logger = logging.getLogger("pio.server")

DEFAULT_PORT = 8000


class EngineServerPlugin:
    """Output blocker/sniffer hook points (reference EngineServerPlugin)."""

    def output_blocker(self, query: Any, prediction: Any) -> None:
        pass

    def output_sniffer(self, query: Any, prediction: Any) -> None:
        pass


class ServerRejection(Exception):
    def __init__(self, message: str, status: int = 403):
        super().__init__(message)
        self.status = status


@dataclass
class FeedbackConfig:
    event_server_url: str
    access_key: str


class QueryService:
    """Holds the deployed engine state; hot-swappable via /reload.

    ``device`` is where every algorithm of every epoch scores (``cuda``
    unless ``"cpu"``). The initial epoch comes from ``model_version`` (a
    registry version), else ``model_path`` (a ``save_model`` directory),
    else the engine instance ``instance_id`` (default: the variant's
    latest COMPLETED one). ``engine`` defaults to the variant's
    (``build_engine``)."""

    def __init__(
        self,
        variant: EngineVariant,
        device=None,
        model_path: str | None = None,
        instance_id: str | None = None,
        feedback: FeedbackConfig | None = None,
        plugins: list[EngineServerPlugin] | None = None,
        batching: BatchConfig | None = None,
        tracing: bool | None = None,
        trace_sample: float | None = None,
        slow_query_ms: float | None = None,
        extra_metrics_snapshots=None,
        model_version: int | None = None,
        registry=None,
        shard: int | None = None,
        num_shards: int = 1,
        engine=None,
    ):
        self.variant = variant
        self.engine = engine or build_engine(variant)
        self.device = resolve_device(device)
        self.model_path = model_path
        self.requested_instance_id = instance_id
        self.requested_model_version = model_version
        self._registry = registry  # lazily resolved from the variant
        #: sharded serving fabric identity: this scorer owns the user rows
        #: whose ``shardmap.shard_of(user) == shard`` out of ``num_shards``
        #: partitions (item-side and replicated state stay whole). A plain
        #: deploy is shard None / num_shards 1 and loads full models.
        self.shard = shard
        self.num_shards = int(num_shards or 1)
        if self.num_shards > 1 and not (
            isinstance(shard, int) and 0 <= shard < self.num_shards
        ):
            raise ValueError(
                f"shard must be in [0, {self.num_shards}) when"
                f" num_shards={self.num_shards}, got {shard!r}"
            )
        self.feedback = feedback
        self.plugins = list(plugins or [])
        self.batching = BatchConfig() if batching is None else batching
        #: set by the multi-process tier: {"workers": N, ...} for the info
        #: page (``pio top``/operators see the process model at a glance)
        self.frontend_info: dict | None = None
        #: set by the multi-process tier: the scorer bridge's
        #: ``wakeup_stats`` callable; the /metrics mirror turns it into
        #: the wakeup-budget gauges (``pio_scorer_wakeups_per_request``,
        #: ``pio_scorer_dispatch_threads``)
        self.scorer_stats = None
        #: measured future-park wakeups: sync ring dispatches that had to
        #: block a dispatcher thread on the batcher future (the async
        #: fast path never parks). Plain int: += is GIL-atomic enough for
        #: a telemetry counter
        self._future_parks = 0
        #: async fast-path timeout backstop: same budget as the sync
        #: path's bounded future wait (window + execution allowance); a
        #: wedged batch answers 503 instead of holding admission permits
        #: forever. Enforced by a lazy 1 Hz watchdog thread.
        self._async_timeout_s = (
            self.batching.window_ms / 1000.0 + 30.0
            if self.batching.enabled else 30.0
        )
        self._async_lock = threading.Lock()
        #: in-flight async queries: dicts with future/request/span/t0/
        #: on_done/deadline/claimed; ``claimed`` is the exactly-once gate
        #: between the future callback and the watchdog's 503. Entries
        #: leave the list at claim time, so it only ever holds truly
        #: in-flight requests (bounded by the bridge's admission limit).
        self._async_pending: list = []
        self._async_watchdog: threading.Thread | None = None
        self._async_stop = False
        self._lock = threading.RLock()
        #: serializes whole swap operations (rehydrate + bind): without it
        #: two concurrent swaps bind in COMPLETION order, so a slow
        #: rollback rehydrate could silently overwrite a newer version
        #: that already reported success. Queries never take this lock.
        self._swap_lock = threading.Lock()
        self._served = 0
        self._started = _dt.datetime.now(_dt.timezone.utc)
        #: swap-epoch state: which registry version is live (None = plain
        #: instance deploy), when it was swapped in, and the last fold-in
        #: lag the retrain loop pushed (``online.loop``)
        self.model_version: int | None = None
        self.last_swap_ts: float | None = None
        self.foldin_lag_s: float | None = None
        self._load_models()

        # _served stays the single source of truth (handle_info reads it);
        # the registry only mirrors it at scrape time
        def mirror(registry):
            with self._lock:
                served = self._served
                version = self.model_version
                swap_ts = self.last_swap_ts
                lag = self.foldin_lag_s
            registry.set_counter(
                "pio_queries_served_total", served,
                help="Queries answered successfully",
            )
            if self._batcher is not None:
                registry.set_gauge(
                    "pio_serving_queue_depth", self._batcher.depth(),
                    help="Queries waiting in the micro-batcher queue",
                )
            if version is not None:
                registry.set_gauge(
                    "pio_model_version", float(version),
                    help="Registry model version currently serving",
                )
            if self.num_shards > 1:
                registry.set_gauge(
                    "pio_scorer_shard_index", float(self.shard),
                    help="This scorer's shard index in the serving fabric",
                )
                registry.set_gauge(
                    "pio_scorer_shard_count", float(self.num_shards),
                    help="Scorer shard count of the serving fabric",
                )
            if swap_ts is not None:
                registry.set_gauge(
                    "pio_model_last_swap_timestamp_seconds", swap_ts,
                    help="Unix time of the last model hot swap",
                )
            if lag is not None:
                registry.set_gauge(
                    "pio_foldin_lag_seconds", lag,
                    help="Seconds of ingested events not yet reflected in"
                    " the serving model (pushed by pio retrain --follow)",
                )
            for name, wrapper in sorted(launches.KERNELS.items()):
                registry.set_counter(
                    "pio_kernel_launches_total", float(wrapper.launches),
                    {"kernel": name},
                    help="Launches of each hand-written kernel by its"
                    " wrapper in this process (0 on the CPU)",
                )
            stats_fn = self.scorer_stats
            if stats_fn is not None:
                try:
                    s = stats_fn()
                except Exception:
                    s = None
                if s:
                    total = (
                        s["wake_events"] + s["handoffs"]
                        + s["completion_signals"] + self._future_parks
                    )
                    n = s["query_requests"]
                    registry.set_counter(
                        "pio_scorer_wakeups_total", float(total),
                        help="Cross-thread wakeups on the scorer's query"
                        " path (consumer eventfd wakes + dispatcher"
                        " handoffs + future parks + completion signals)",
                    )
                    registry.set_counter(
                        "pio_scorer_query_requests_total", float(n),
                        help="Query frames popped from the frontend rings",
                    )
                    registry.set_gauge(
                        "pio_scorer_wakeups_per_request",
                        round(total / n, 3) if n else 0.0,
                        help="Measured query-path wakeups per request"
                        " (sync dispatch ~4, async fast path <= 2)",
                    )
                    registry.set_gauge(
                        "pio_scorer_dispatch_threads",
                        float(s["dispatch_threads"]),
                        help="Dispatcher threads serving the query path"
                        " (0 = async fast path; control routes keep a"
                        " separate small pool)",
                    )
                    registry.set_gauge(
                        "pio_scorer_completion_retry_depth",
                        float(s["retry_depth"]),
                        help="Completions parked on the ring-full timer"
                        " retry queue",
                    )

        self.router, self.metrics = instrumented_router(
            before_scrape=mirror, tracing=tracing,
            trace_sample=trace_sample,
            extra_snapshots=extra_metrics_snapshots,
        )
        if slow_query_ms is not None:
            # one summary log line per query trace over the threshold
            self.router.tracer.set_slow_threshold(
                "POST /queries.json", slow_query_ms / 1000.0
            )
        self.router.add("GET", "/", self.handle_info)
        self.router.add("POST", "/queries.json", self.handle_query)
        self.router.add("GET", "/reload", self.handle_reload)
        self.router.add("POST", "/stop", self.handle_stop)
        self.router.add("POST", "/models/swap", self.handle_model_swap)
        self.router.add("POST", "/models/lag", self.handle_model_lag)
        self.router.add("GET", "/models.json", self.handle_models)
        self._stop_event = threading.Event()
        # the batcher captures engine state per flush (under self._lock),
        # so /reload hot-swaps apply to the very next batch; it fans
        # batch-level spans back out to each coalesced request's trace
        self._batcher = (
            MicroBatcher(
                self._predict_batch, self.batching,
                metrics=self.metrics, tracer=self.router.tracer,
            )
            if self.batching.enabled
            else None
        )

    # -- model lifecycle ----------------------------------------------------
    def registry(self):
        """The variant's model registry (``online.registry``), resolved
        lazily so plain deploys never touch the registry tree."""
        if self._registry is None:
            from predictionio_tpu_torch.online.registry import ModelRegistry

            self._registry = ModelRegistry.for_variant(self.variant)
        return self._registry

    def _enforce_shard_budget(self, nbytes: int, what: str) -> None:
        """``PIO_SHARD_BUDGET_BYTES``: the per-shard memory contract of the
        sharded fabric. A shard REFUSES to materialize any model blob
        larger than its configured budget -- the guarantee that lets
        operators size shards below the full table: a generation with
        per-shard blobs serves a model N times the budget because each
        scorer only ever touches its own slice, while a fallback load of
        the full blob fails loudly instead of silently blowing the shard's
        memory envelope. No-op outside sharded mode or without the env."""
        if self.num_shards <= 1:
            return
        import os

        raw = os.environ.get("PIO_SHARD_BUDGET_BYTES", "").strip()
        if not raw:
            return
        try:
            budget = int(raw)
        except ValueError:
            logger.warning("ignoring non-integer PIO_SHARD_BUDGET_BYTES=%r", raw)
            return
        if budget > 0 and nbytes > budget:
            raise RuntimeError(
                f"shard {self.shard}/{self.num_shards}: {what} is"
                f" {nbytes} bytes, over the shard budget of {budget}"
                " (PIO_SHARD_BUDGET_BYTES); publish per-shard blobs"
                " (scorer_shards on the retrain loop) or raise the budget"
            )

    def _serving_epoch(self, instance_id: str, source: bytes | str,
                       shard_filter: int | None):
        """``(algorithms, models, serving)`` of one epoch: the engine's
        algorithms with the engine.json's params on ``device``, the
        models of ``source`` (a blob, or the ``model_path`` directory)
        restricted to partition ``shard_filter`` when one is given, their
        serving state built (``warm_up``: the retrieval index packed and
        searched once, so no query pays it), and the engine's Serving;
        all through ``Engine.prepare_deploy``."""
        engine_params = self.variant.engine_params
        ctx = TrainContext(device=self.device,
                           runtime_conf=dict(self.variant.runtime_conf))
        models = self.engine.prepare_deploy(
            ctx, engine_params, instance_id, source,
            shard=shard_filter, num_shards=self.num_shards,
        )
        algorithms = self.engine._algorithms(engine_params, self.device)
        return algorithms, models, self.engine.serving(engine_params)

    def _load_models(self) -> None:
        from predictionio_tpu_torch.data import storage
        from predictionio_tpu_torch.data.storage.base import STATUS_COMPLETED

        if self.requested_model_version is not None:
            # pinned registry deploy / rollback: the version's manifest is
            # self-contained (params + blob); a missing or corrupt version
            # raises RegistryError verbatim -- deploy must fail loudly,
            # never silently serve a different model than the one named
            self._swap_to_version(self.requested_model_version)
            return
        if self.model_path is not None:
            instance, source = None, self.model_path
        else:
            instance = resolve_engine_instance(
                self.variant, self.requested_instance_id
            )
            if instance.status != STATUS_COMPLETED:
                raise LookupError(
                    f"engine instance {instance.id!r} is {instance.status},"
                    " not COMPLETED"
                )
            blob_record = storage.get_model_data_models().get(instance.id)
            if blob_record is None:
                raise LookupError(
                    f"engine instance {instance.id!r} has no model blob"
                )
            source = blob_record.models
            self._enforce_shard_budget(len(source), f"instance {instance.id} blob")
        algorithms, models, serving = self._serving_epoch(
            "" if instance is None else instance.id, source,
            self.shard if self.num_shards > 1 else None,
        )
        with self._lock:
            self.instance = instance
            self.engine_params = self.variant.engine_params
            self.models = models
            self.algorithms = algorithms
            self.serving_instance = serving
            self.model_version = None
        logger.info(
            "deployed %s (%d algorithm(s))",
            f"engine instance {instance.id}" if instance is not None
            else f"model directory {self.model_path}", len(models),
        )

    def _swap_to_version(self, version: int | None) -> int:
        """THE hot-swap epoch protocol: rehydrate a registry version
        OUTSIDE the lock (deserialization and warm-up are slow), then bind
        the whole epoch -- instance, params, models, algorithms, serving,
        version -- in ONE locked assignment. Query paths snapshot the
        epoch under the same lock (``_predict_batch``/``_predict_one``),
        so every in-flight batch finishes on the handle it captured, every
        later submission binds the new one, and no response is ever
        computed from a mixed-version epoch. Returns the swapped version;
        raises ``online.registry.RegistryError`` on a missing/corrupt one
        (the old epoch keeps serving untouched). Swaps are serialized
        against each other (``_swap_lock``) so they take effect in
        REQUEST order, not rehydrate-completion order."""
        with self._swap_lock:
            return self._swap_to_version_locked(version)

    def _swap_to_version_locked(self, version: int | None) -> int:
        registry = self.registry()
        entry = registry.get(version) if version is not None else registry.latest()
        if entry is None:
            from predictionio_tpu_torch.online.registry import RegistryError

            raise RegistryError(
                f"model registry is empty under {registry.dir}; run"
                " `pio train` or `pio retrain` first"
            )
        shard_filter: int | None = None
        if self.num_shards > 1 and entry.shard_count == self.num_shards:
            # the generation was published with matching per-shard blobs:
            # load ONLY this shard's slice -- the fabric's memory contract
            blob = entry.load_blob(shard=self.shard)  # CRC-verified
        else:
            if self.num_shards > 1:
                logger.info(
                    "version %d has %d shard blob(s) for a %d-shard"
                    " deploy; loading the full blob and partitioning"
                    " in-process", entry.version, entry.shard_count,
                    self.num_shards,
                )
                shard_filter = self.shard
            blob = entry.load_blob()  # CRC-verified
        self._enforce_shard_budget(
            len(blob), f"registry version {entry.version} blob"
        )
        # a per-shard blob holds the shard's own compacted model: it
        # rehydrates like a full one, with no further filter
        algorithms, models, serving = self._serving_epoch(
            entry.instance_id or "", blob, shard_filter
        )
        engine_params = self.variant.engine_params
        instance = None
        if entry.instance_id:
            try:
                instance = resolve_engine_instance(self.variant, entry.instance_id)
            except LookupError:
                instance = None
        if instance is None and getattr(self, "instance", None) is None:
            # registry-only deploy whose meta row is gone: a stub keeps the
            # info page honest instead of crashing it
            from predictionio_tpu_torch.data.storage.base import EngineInstance

            instance = EngineInstance(
                id=entry.instance_id or f"registry-v{entry.version}",
                status="COMPLETED",
                start_time=self._started,
                engine_id=self.variant.variant_id,
                engine_version=self.variant.engine_version,
                engine_variant=self.variant.path,
                engine_factory=self.variant.engine_factory,
            )
        with self._lock:
            if instance is not None:
                self.instance = instance
            self.engine_params = engine_params
            self.models = models
            self.algorithms = algorithms
            self.serving_instance = serving
            self.model_version = entry.version
            self.last_swap_ts = _time.time()
        logger.info(
            "hot-swapped model version %d (%s, instance %s)",
            entry.version, entry.source, entry.instance_id or "?",
        )
        return entry.version

    def describe_source(self) -> str:
        """Where the live epoch came from, and the device it scores on."""
        with self._lock:
            instance = self.instance
            version = self.model_version
            device = getattr(self.algorithms[0], "device", "cpu")
        if version is not None:
            source = f"model version {version}"
        elif instance is not None:
            source = f"engine instance {instance.id}"
        else:
            source = f"model directory {self.model_path}"
        return f"{source}, {device}"

    # -- handlers -----------------------------------------------------------
    def handle_info(self, request: Request) -> Response:
        with self._lock:
            instance = self.instance
            body = {
                "status": "alive",
                # a model-directory deploy has no engine instance
                "engineInstance": None if instance is None else {
                    "id": instance.id,
                    "engineVariant": self.variant.variant_id,
                    "startTime": instance.start_time.isoformat(),
                },
                "algorithms": [type(a).__name__ for a in self.algorithms],
                "devices": [str(getattr(a, "device", "cpu")) for a in self.algorithms],
                "modelVersion": self.model_version,
                "startTime": self._started.isoformat(),
                "serverStats": {"queryCount": self._served},
                "batching": {
                    "enabled": self._batcher is not None,
                    "maxBatchSize": self.batching.max_batch_size,
                    "windowMs": self.batching.window_ms,
                    "buckets": list(self.batching.buckets),
                },
            }
            if self.num_shards > 1:
                body["shard"] = {
                    "shard": self.shard, "numShards": self.num_shards,
                }
            if self.frontend_info is not None:
                body["frontend"] = self.frontend_info
            return Response(200, body)

    def _predict_one(self, query_obj) -> Any:
        """The unbatched predict -> serve chain for one raw query dict;
        returns ``(result, model_version)`` -- the version is the epoch's,
        captured in the SAME lock acquisition as the model handles, so a
        concurrent hot swap can never mislabel a response."""
        with self._lock:
            algorithms = self.algorithms
            models = self.models
            serving = self.serving_instance
            version = self.model_version
        predictions = []
        typed_query = algorithms[0].query_from_json(query_obj)
        for algorithm, model in zip(algorithms, models):
            query = algorithm.query_from_json(query_obj)
            predictions.append(algorithm.predict(model, query))
        # serving receives the typed query, matching Engine.eval's contract
        return serving.serve(typed_query, predictions), version

    def _predict_batch(self, query_objs: list) -> list:
        """MicroBatcher execute callback: raw query dicts in, one
        ``(result, model_version)`` OR ``Exception`` per slot out
        (aligned). Per-request isolation: the batched hooks run
        optimistically for the whole batch; if one raises, the batch
        degrades to per-query scoring so only the failing queries carry
        their error (the ``workflow/batch_predict`` chunk-fallback
        pattern, on the serving path). The whole batch binds ONE epoch --
        the swap protocol's no-mixed-version guarantee."""
        with self._lock:
            algorithms = self.algorithms
            models = self.models
            serving = self.serving_instance
            version = self.model_version
        n = len(query_objs)
        errors: dict[int, Exception] = {}
        typed: dict[int, Any] = {}
        for i, obj in enumerate(query_objs):
            try:
                typed[i] = algorithms[0].query_from_json(obj)
            except Exception as exc:
                errors[i] = exc
        per_algo: list[dict[int, Any]] = []
        for algorithm, model in zip(algorithms, models):
            pairs = []
            for i in range(n):
                if i in errors:
                    continue
                try:
                    pairs.append((i, algorithm.query_from_json(query_objs[i])))
                except Exception as exc:
                    errors[i] = exc
            try:
                preds = dict(algorithm.batch_predict(model, pairs))
            except Exception:
                logger.warning(
                    "batched predict failed for a %d-query batch; "
                    "rescoring per query", len(pairs), exc_info=True,
                )
                preds = {}
                for i, q in pairs:
                    try:
                        preds[i] = algorithm.predict(model, q)
                    except Exception as exc:
                        errors[i] = exc
            for i, _ in pairs:
                if i not in preds and i not in errors:
                    errors[i] = RuntimeError(
                        f"{type(algorithm).__name__}.batch_predict returned "
                        f"no result for query {i}"
                    )
            per_algo.append(preds)
        ok = [i for i in range(n) if i not in errors]
        served: dict[int, Any] = {}
        if ok:
            try:
                out = serving.serve_batch(
                    [typed[i] for i in ok],
                    [[preds[i] for preds in per_algo] for i in ok],
                )
                if len(out) != len(ok):
                    raise RuntimeError(
                        f"serve_batch returned {len(out)} results for "
                        f"{len(ok)} queries"
                    )
                served = dict(zip(ok, out))
            except Exception:
                served = {}
                for i in ok:
                    try:
                        served[i] = serving.serve(
                            typed[i], [preds[i] for preds in per_algo]
                        )
                    except Exception as exc:
                        errors[i] = exc
        return [
            errors[i] if i in errors else (served[i], version)
            for i in range(n)
        ]

    def handle_query(self, request: Request) -> Response:
        tracer = self.router.tracer
        try:
            with tracer.span("query.parse"):
                query_obj = request.json()
        except json.JSONDecodeError:
            return Response(400, {"message": "malformed JSON query"})
        try:
            if self._batcher is not None:
                # the window is how long a query may WAIT; the allowance on
                # top covers execution (first-bucket jit compiles included)
                wait_s = self.batching.window_ms / 1000.0 + 30.0
                try:
                    fut = self._batcher.submit(query_obj)
                    if request.frontend_pc is not None and not fut.done():
                        # a ring-dispatched request about to park a
                        # dispatcher thread on the future: one measured
                        # wakeup the async fast path does not pay
                        self._future_parks += 1
                    result, version = fut.result(wait_s)
                except BatcherStopped:
                    return Response(503, {"message": "server is stopping"})
                except _FutureTimeout:
                    return Response(
                        503, {"message": "batched predict timed out"}
                    )
            else:
                with tracer.span("query.predict"):
                    result, version = self._predict_one(query_obj)
            for plugin in self.plugins:
                plugin.output_blocker(query_obj, result)
        except ServerRejection as exc:
            return Response(exc.status, {"message": str(exc)})
        except (KeyError, TypeError, ValueError) as exc:
            return Response(400, {"message": f"bad query: {exc}"})
        return self._respond(query_obj, result, version)

    def _respond(self, query_obj, result, version) -> Response:
        """The shared post-predict completion tail -- sniffer plugins,
        serialization, feedback, served count, version header -- used by
        BOTH the sync request-thread path (``handle_query``) and the
        async flusher-callback path (``_finish_async_query``), so the
        tier's byte-identity contract cannot drift between them. Callers
        must have the request's trace context active on the calling
        thread (a request-thread dispatch span, or the async path's
        attached handle) so ``query.respond`` lands in the right trace."""
        tracer = self.router.tracer
        for plugin in self.plugins:
            plugin.output_sniffer(query_obj, result)
        with self._lock:
            serializer = self.algorithms[0]
        with tracer.span("query.respond"):
            result_json = serializer.result_to_json(result)
            if not isinstance(result_json, (dict, list)):
                result_json = {"result": result_json}
        if self.feedback:
            pr_id = uuid.uuid4().hex
            if isinstance(result_json, dict):
                result_json = {**result_json, "prId": pr_id}
            # off the request path: feedback latency must not touch query p50
            threading.Thread(
                target=self._send_feedback,
                args=(query_obj, result_json, pr_id),
                daemon=True,
            ).start()
        with self._lock:
            self._served += 1
        response = Response(200, result_json)
        if version is not None:
            # attribution header: which registry version computed THIS
            # response (captured in the predict path's epoch snapshot, so
            # it is exact across concurrent hot swaps). Bodies stay
            # byte-identical to a plain deploy; the header only exists
            # once the registry/swap subsystem is in play.
            response.headers["x-pio-model-version"] = str(version)
        return response

    # -- async fast path (multi-process tier, dispatcherless dispatch) ------
    #: the fast path bypasses Router.dispatch, so it pins the route label
    #: its metrics/spans use to the registered pattern
    _QUERY_ROUTE = "/queries.json"

    def submit_query_async(self, request: Request, on_done) -> None:
        """The dispatcher-less fast path of the multi-process tier: the
        scorer bridge's ring consumer calls this for ``POST
        /queries.json`` frames instead of routing them through the
        dispatcher pool. Parse + micro-batcher submit happen on the
        CALLING (consumer) thread; everything after the model answers --
        plugin hooks, serialization, feedback, route metrics, the trace
        root -- runs in a ``Future.add_done_callback`` on the batcher's
        flusher thread. ``on_done(response)`` is called exactly once
        (synchronously for immediate errors) and must never block: the
        bridge's continuation does one non-blocking ring push and parks
        overflow on a timer-driven retry queue (``pio check`` C005 is
        the static gate for this contract).

        Trace spans are explicit handles here: the root starts on the
        consumer, is attached around ``submit`` so the batcher captures
        the context, and finishes in the callback -- the
        ``frontend.ring_wait``/``query.parse``/shared batch spans land in
        the same trace shape as the sync path. Every response is built by
        the same code as :meth:`handle_query`, so bodies stay
        byte-identical across dispatch modes."""
        t0 = _time.perf_counter()
        tracer = self.router.tracer
        span = None
        guard = NULL_SPAN
        if tracer.enabled:
            traceparent = next(
                (
                    v for k, v in request.headers.items()
                    if k.lower() == "traceparent"
                ),
                None,
            )
            root = tracer.start_remote(
                f"POST {self._QUERY_ROUTE}", traceparent
            )
            if root.trace_id is not None:  # sampled-out roots record nothing
                span = root
                guard = root
            else:
                # suppress nested span() calls exactly as the sync
                # path's sampled-out root does on its dispatch thread
                guard = SAMPLED_OUT_ROOT
        guard.attach()
        try:
            if span is not None and request.frontend_pc is not None:
                recv_pc, dispatch_pc, worker = request.frontend_pc
                tracer.record_span(
                    span.trace_id, "frontend.ring_wait", recv_pc,
                    dispatch_pc, parent_id=span.span_id,
                    attrs={"worker": worker},
                )
            try:
                with tracer.span("query.parse"):
                    query_obj = request.json()
            except json.JSONDecodeError:
                self._finish_async_response(
                    request,
                    Response(400, {"message": "malformed JSON query"}),
                    span, t0, on_done,
                )
                return
            batcher = self._batcher
            if batcher is None:
                # the bridge only wires this path with batching enabled;
                # answered (not raised) so a misconfiguration stays visible
                self._finish_async_response(
                    request,
                    Response(
                        503, {"message": "async dispatch requires batching"}
                    ),
                    span, t0, on_done,
                )
                return
            try:
                # submit captures current_context() from the attached guard
                future = batcher.submit(query_obj)
            except BatcherStopped:
                self._finish_async_response(
                    request, Response(503, {"message": "server is stopping"}),
                    span, t0, on_done,
                )
                return
            entry = {
                "future": future,
                "query_obj": query_obj,
                "request": request,
                "span": span,
                "t0": t0,
                "on_done": on_done,
                "deadline": t0 + self._async_timeout_s,
                "claimed": False,
            }
            with self._async_lock:
                self._async_pending.append(entry)
                if self._async_watchdog is None and not self._async_stop:
                    self._async_watchdog = threading.Thread(
                        target=self._async_watch,
                        name="pio-async-watchdog", daemon=True,
                    )
                    self._async_watchdog.start()
            future.add_done_callback(
                lambda f: self._finish_async_query(entry, f)
            )
        except Exception:
            # the Router._dispatch backstop contract (e.g. a non-UTF-8
            # body raising UnicodeDecodeError in parse): the request
            # still gets its 500, envelope, metrics, and span finish
            logger.exception("async query submission failed")
            self._finish_async_response(
                request, Response(500, {"message": "internal server error"}),
                span, t0, on_done,
            )
        finally:
            guard.detach()

    def _claim_async(self, entry: dict) -> bool:
        """Exactly-once gate between the future callback and the
        watchdog's timeout 503: first claimer finishes the request (and
        removes the entry, so the pending list holds only live ones)."""
        with self._async_lock:
            if entry["claimed"]:
                return False
            entry["claimed"] = True
            try:
                self._async_pending.remove(entry)
            except ValueError:
                pass
            return True

    def _async_watch(self) -> None:
        """1 Hz sweep over in-flight async queries: a future that blew
        the sync path's wait budget answers 503 "batched predict timed
        out" (releasing its admission permit through on_done) instead of
        holding the permit until a wedged batch resolves -- the sync
        dispatcher's ``result(wait_s)`` backstop, off-thread. Exits
        within a tick of ``close()``."""
        while True:
            with self._async_lock:
                if self._async_stop:
                    return
            _time.sleep(1.0)
            now = _time.perf_counter()
            fire = []
            with self._async_lock:
                keep = []
                for entry in self._async_pending:
                    if entry["claimed"]:
                        continue
                    if now >= entry["deadline"] and not entry["future"].done():
                        entry["claimed"] = True
                        fire.append(entry)
                    else:
                        keep.append(entry)
                self._async_pending = keep
            for entry in fire:
                self._finish_async_response(
                    entry["request"],
                    Response(503, {"message": "batched predict timed out"}),
                    entry["span"], entry["t0"], entry["on_done"],
                )

    def _finish_async_query(self, entry: dict, future) -> None:
        """The flusher-thread continuation: exactly ``handle_query``'s
        post-predict semantics (plugin rejection -> status, bad query ->
        400, anything unexpected -> the dispatch backstop's 500) via the
        shared ``_respond`` tail, then the response envelope. ``future``
        is this callback's own argument and is already resolved --
        ``.result()`` here cannot block. No-op if the watchdog already
        answered the request's timeout 503."""
        if not self._claim_async(entry):
            return
        query_obj = entry["query_obj"]
        span = entry["span"]
        tracer = self.router.tracer
        guard = span
        if guard is None:
            guard = SAMPLED_OUT_ROOT if tracer.enabled else NULL_SPAN
        result = None
        version = None
        response = None
        guard.attach()
        try:
            try:
                result, version = future.result()
                for plugin in self.plugins:
                    plugin.output_blocker(query_obj, result)
            except BatcherStopped:
                response = Response(503, {"message": "server is stopping"})
            except ServerRejection as exc:
                response = Response(exc.status, {"message": str(exc)})
            except (KeyError, TypeError, ValueError) as exc:
                response = Response(400, {"message": f"bad query: {exc}"})
            if response is None:
                response = self._respond(query_obj, result, version)
        except Exception:
            # the Router._dispatch backstop contract, off-router
            logger.exception("async query completion failed")
            response = Response(500, {"message": "internal server error"})
        finally:
            guard.detach()
        self._finish_async_response(
            entry["request"], response, span, entry["t0"], entry["on_done"]
        )

    def _finish_async_response(
        self, request: Request, response: Response, span, t0: float, on_done
    ) -> None:
        """Stamp the routing envelope Router.dispatch would have (trace
        attrs, response ``traceparent``, error-body ``traceId``, route
        metrics), finish the root span, hand off. Never raises."""
        if span is not None:
            span.set_attr("status", response.status)
            if response.status >= 500:
                span.set_status("error")
            response.headers.setdefault(
                "traceparent",
                format_traceparent(span.trace_id, span.span_id),
            )
            if response.status >= 400 and isinstance(response.body, dict):
                response.body.setdefault("traceId", span.trace_id)
            span.finish()
        try:
            self.router.record_route(
                request, self._QUERY_ROUTE, response.status, t0
            )
        except Exception:
            logger.warning("route metrics recording failed", exc_info=True)
        try:
            on_done(response)
        except Exception:
            logger.exception("async completion delivery failed")

    def handle_model_swap(self, request: Request) -> Response:
        """``POST /models/swap {"version": N?}``: hot-swap a registry
        version (default: latest) into the live epoch. The retrain loop's
        notify target; also the runtime rollback lever -- POST an older
        retained version to roll back with zero downtime."""
        from predictionio_tpu_torch.online.registry import RegistryError

        try:
            body = request.json() or {}
        except json.JSONDecodeError:
            return Response(400, {"message": "malformed JSON body"})
        version = body.get("version")
        if version is not None:
            try:
                version = int(version)
            except (TypeError, ValueError):
                return Response(400, {"message": f"bad version {version!r}"})
        try:
            swapped = self._swap_to_version(version)
        except RegistryError as exc:
            return Response(404, {"message": str(exc)})
        except Exception as exc:
            logger.exception("model swap failed")
            return Response(500, {"message": f"swap failed: {exc}"})
        lag = body.get("foldinLagSeconds")
        if isinstance(lag, (int, float)):
            with self._lock:
                self.foldin_lag_s = float(lag)
        return Response(200, {"status": "swapped", "modelVersion": swapped})

    def handle_model_lag(self, request: Request) -> Response:
        """Fold-in lag heartbeat from the retrain loop (keeps `pio top`'s
        LAG column live between swaps)."""
        try:
            body = request.json() or {}
        except json.JSONDecodeError:
            return Response(400, {"message": "malformed JSON body"})
        lag = body.get("foldinLagSeconds")
        if not isinstance(lag, (int, float)):
            return Response(400, {"message": "foldinLagSeconds required"})
        with self._lock:
            self.foldin_lag_s = float(lag)
        return Response(200, {"status": "ok"})

    def handle_models(self, request: Request) -> Response:
        """``GET /models.json``: the registry's retained versions plus the
        live one -- the operator's rollback menu."""
        with self._lock:
            current = self.model_version
        try:
            versions = [
                {
                    "version": v.version,
                    "source": v.source,
                    "engineInstanceId": v.instance_id,
                    "createdAt": v.manifest.get("created_at"),
                    "untilMs": v.manifest.get("until_ms"),
                }
                for v in self.registry().versions()
            ]
        except Exception as exc:
            return Response(500, {"message": f"registry unavailable: {exc}"})
        return Response(
            200, {"currentVersion": current, "versions": versions}
        )

    def handle_reload(self, request: Request) -> Response:
        # /reload re-resolves the LATEST completed instance (hot-swap), even
        # if the server was started pinned to an explicit instance id OR a
        # registry version -- un-pin both, or a pinned deploy would re-load
        # its startup version forever (and a GC'd one would 500 here); a
        # model-directory deploy re-reads its directory
        self.requested_instance_id = None
        self.requested_model_version = None
        self._load_models()
        instance = self.instance
        return Response(200, {
            "status": "reloaded",
            "engineInstanceId": None if instance is None else instance.id,
        })

    def handle_stop(self, request: Request) -> Response:
        self._stop_event.set()
        return Response(200, {"status": "stopping"})

    def close(self) -> None:
        """Graceful drain: flush every in-flight batched query (their
        request threads are parked on futures and still get answers), then
        stop the flusher. Call AFTER the HTTP listener stops accepting.
        The async watchdog (if the multi-process fast path started one)
        exits within a tick, so a closed service is fully collectable."""
        if self._batcher is not None:
            self._batcher.close()
        with self._async_lock:
            # stop flag and watchdog handle share the async lock with
            # their writers (pio check C006); the join happens OUTSIDE
            # it -- the watchdog's loop takes this lock every tick
            self._async_stop = True
            watchdog = self._async_watchdog
            self._async_watchdog = None
        if watchdog is not None:
            watchdog.join(timeout=2.0)
        with self._async_lock:
            self._async_pending.clear()

    # -- feedback loop ------------------------------------------------------
    def _send_feedback(self, query: Any, prediction: Any, pr_id: str) -> None:
        """POST query/prediction back to the Event Server (reference
        --feedback). Failures are logged, never surfaced to the client."""
        import urllib.request

        event = {
            "event": "predict",
            "entityType": "pio_pr",
            "entityId": pr_id,
            "properties": {"query": query, "prediction": prediction},
            "prId": pr_id,
        }
        url = (
            f"{self.feedback.event_server_url}/events.json"
            f"?accessKey={self.feedback.access_key}"
        )
        try:
            req = urllib.request.Request(
                url,
                data=json.dumps(event).encode("utf-8"),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            urllib.request.urlopen(req, timeout=2)
        except Exception as exc:
            logger.warning("feedback event failed: %s", exc)


def create_query_server(
    variant: EngineVariant,
    host: str = "0.0.0.0",
    port: int = DEFAULT_PORT,
    ssl_cert: str | None = None,
    ssl_key: str | None = None,
    **service_kwargs,
) -> tuple[ServiceThread, QueryService]:
    service = QueryService(variant, **service_kwargs)
    server = make_server(
        service.router, host, port, "pio-queryserver",
        ssl_cert=ssl_cert, ssl_key=ssl_key,
    )
    return ServiceThread(server), service


class MultiprocServiceHandle:
    """The multi-process analogue of :class:`ServiceThread`: same
    ``start()/stop()/port`` surface, so benches and tests treat both
    tiers uniformly. ``stop()`` drains the frontends (in-flight requests
    are answered) before the scorer bridge tears down."""

    def __init__(self, bridge, service: QueryService):
        self.bridge = bridge
        self.service = service

    @property
    def port(self) -> int:
        return self.bridge.port

    def start(self) -> "MultiprocServiceHandle":
        self.bridge.start()
        return self

    def stop(self) -> None:
        self.bridge.stop()


def create_multiproc_query_server(
    variant: EngineVariant,
    host: str = "0.0.0.0",
    port: int = DEFAULT_PORT,
    frontend=None,
    **service_kwargs,
) -> tuple[MultiprocServiceHandle, QueryService]:
    """The multi-process serving tier: this process becomes the scorer
    (models + micro-batcher + router, exactly the single-process
    ``QueryService``); ``frontend`` (a ``FrontendConfig`` or a worker
    count) sizes the ``SO_REUSEPORT`` frontend processes that do the
    HTTP. Responses are byte-identical to the single-process server
    because every body is produced by the same router in the scorer.

    TLS is not supported at the frontend tier (terminate it in front, or
    deploy single-process with ``--ssl-cert``).
    """
    from predictionio_tpu_torch.serving.procserver import FrontendConfig, ScorerBridge

    if service_kwargs.pop("ssl_cert", None) or service_kwargs.pop("ssl_key", None):
        raise ValueError(
            "--frontend-workers does not support --ssl-cert/--ssl-key; "
            "terminate TLS in front of the frontend tier"
        )
    if isinstance(frontend, int):
        frontend = FrontendConfig(workers=frontend)
    frontend = frontend or FrontendConfig()
    # the bridge exists only after the service (it needs the router), but
    # the service's /metrics hook needs the bridge: late-bind via a cell
    bridge_cell: list = []

    def worker_snapshots() -> list[dict]:
        return bridge_cell[0].metric_snapshots() if bridge_cell else []

    service = QueryService(
        variant, extra_metrics_snapshots=worker_snapshots, **service_kwargs
    )
    # the async fast path needs a future per query, i.e. the batcher; a
    # batching-disabled deploy (or an explicit dispatch="sync") keeps the
    # dispatcher-pool model
    async_query = None
    if frontend.dispatch == "async" and service._batcher is not None:
        async_query = service.submit_query_async
    bridge = ScorerBridge(
        service.router, host, port, frontend, registry=service.metrics,
        async_query=async_query,
    )
    bridge_cell.append(bridge)
    service.scorer_stats = bridge.wakeup_stats
    service.frontend_info = frontend.describe()
    return MultiprocServiceHandle(bridge, service), service


def create_sharded_query_server(
    variant: EngineVariant,
    host: str = "0.0.0.0",
    port: int = DEFAULT_PORT,
    scorer_shards: int = 2,
    frontend=None,
    model_version: int | None = None,
    instance_id: str | None = None,
    batching=None,
    device=None,
):
    """The sharded serving fabric: ``scorer_shards`` scorer processes,
    each holding one hash partition of the user factor table (item-side
    state replicated), behind the same ``SO_REUSEPORT`` frontend tier.
    Returns an unstarted ``ShardFabric`` with the
    ``start()/stop()/port`` surface of :class:`MultiprocServiceHandle`.
    Every shard process scores on ``device`` (``cuda`` unless "cpu"),
    each with its own CUDA context.
    """
    from predictionio_tpu_torch.serving.fabric import ShardFabric
    from predictionio_tpu_torch.serving.procserver import FrontendConfig

    if isinstance(frontend, int):
        frontend = FrontendConfig(workers=frontend)
    return ShardFabric(
        variant,
        host=host,
        port=port,
        num_shards=scorer_shards,
        frontend=frontend,
        model_version=model_version,
        instance_id=instance_id,
        batch_window_ms=batching.window_ms if batching else None,
        max_batch_size=batching.max_batch_size if batching else None,
        device=str(device or "cuda"),
    )


def run_query_server(
    variant: EngineVariant,
    host: str = "0.0.0.0",
    port: int = DEFAULT_PORT,
    frontend_workers: int = 0,
    frontend=None,
    scorer_shards: int = 0,
    **kw,
) -> None:
    """Blocking entry point used by ``pio deploy``. With
    ``frontend_workers`` > 0 (or an explicit ``frontend`` config) the
    server runs as the multi-process tier: N ``SO_REUSEPORT`` frontend
    processes feeding this process's scorer through shared-memory rings.
    ``scorer_shards`` > 1 instead runs the sharded fabric: the user
    factor table hash-partitioned across that many scorer processes.
    """
    if scorer_shards > 1:
        if kw.pop("ssl_cert", None) or kw.pop("ssl_key", None):
            raise ValueError(
                "--scorer-shards does not support --ssl-cert/--ssl-key;"
                " terminate TLS in front of the frontend tier"
            )
        if kw.pop("feedback", None) is not None:
            raise ValueError(
                "--scorer-shards does not support --feedback yet;"
                " run the feedback loop against an unsharded deploy"
            )
        if kw.pop("model_path", None) is not None:
            raise ValueError(
                "--scorer-shards serves an engine instance or a registry"
                " version; deploy a --model directory unsharded"
            )
        dropped = {
            k: v
            for k in ("tracing", "trace_sample", "slow_query_ms")
            if (v := kw.pop(k, None)) is not None
        }
        if dropped:
            logger.info(
                "sharded deploy: shard processes use their own defaults"
                " for %s", sorted(dropped),
            )
        fabric = create_sharded_query_server(
            variant, host, port, scorer_shards=scorer_shards,
            frontend=frontend, **kw,
        )
        fabric.start()
        print(
            f"Query Server listening on http://{host}:{fabric.port}"
            f" ({scorer_shards} scorer shard(s),"
            f" {fabric.config.workers} frontend worker(s))",
            flush=True,
        )
        try:
            fabric.wait()
        finally:
            fabric.stop()
        return
    if frontend_workers or frontend is not None:
        from predictionio_tpu_torch.serving.procserver import FrontendConfig

        if frontend is None:
            frontend = FrontendConfig(workers=frontend_workers)
        handle, service = create_multiproc_query_server(
            variant, host, port, frontend=frontend, **kw
        )
        handle.start()
        print(
            f"Query Server listening on http://{host}:{handle.port}"
            f" ({frontend.workers} frontend worker(s),"
            f" {service.describe_source()})",
            flush=True,
        )
        try:
            service._stop_event.wait()
        except KeyboardInterrupt:
            pass
        handle.stop()   # frontends drain first (in-flight answered) ...
        service.close()  # ... then the micro-batcher flushes
        return
    thread, service = create_query_server(variant, host, port, **kw)
    scheme = "https" if kw.get("ssl_cert") else "http"
    thread.start()
    print(
        f"Query Server listening on {scheme}://{host}:{thread.port}"
        f" ({service.describe_source()})",
        flush=True,
    )
    try:
        service._stop_event.wait()
    except KeyboardInterrupt:
        pass
    thread.stop()
    service.close()  # drain in-flight batches after the listener stops
