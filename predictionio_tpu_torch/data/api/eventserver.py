"""Event Server: REST ingestion into the append-only event store.

Behavioral model: reference ``data/.../api/EventServer.scala`` (apache/
predictionio layout, unverified -- SURVEY.md section 2.2 #15 and Appendix A).
Wire contract kept:

- ``POST /events.json?accessKey=K[&channel=ch]`` -> ``201 {"eventId": ...}``
- ``GET  /events.json`` with filters (startTime/untilTime/entityType/entityId/
  event/targetEntityType/targetEntityId/limit/reversed)
- ``GET|DELETE /events/<id>.json``
- ``POST /batch/events.json`` (<=50 per request, per-item status array)
- ``GET  /stats.json`` (when ``--stats``)
- ``POST /webhooks/<connector>.json`` (+ form variant), ``GET`` for status
- auth via ``accessKey`` query param or ``Authorization`` header; per-key
  event whitelists; channels resolved by name
- plugin hook points: input blockers / input sniffers
  (``EventServerPlugin`` parity role)

Default port 7070.

Copy of ``predictionio_tpu/data/api/eventserver.py`` (framework-free):
every route above, the 50-event batch limit, auth, whitelists, channels,
stats, plugins and webhooks, in both ingest modes:

- ``sync``: one storage insert per event on the request thread;
- ``wal`` (``EventService._start_ingest`` / ``shutdown_ingest``,
  reference ``:142-195``): the group-commit pipeline of
  ``data/ingest.py`` over ``wal_partitions`` WAL partitions
  (``data/wal.py``). The un-flushed tail a crash left is replayed into
  the store at start; an event is acknowledged after its WAL fsync, a
  batch request rides one group commit, a full queue answers 429 with
  ``Retry-After``, and ``/metrics`` carries the ``pio_ingest_*`` and
  ``pio_wal_*`` gauges. ``pio retrain --follow`` tails this WAL
  (``online/follower.py``).

With ``frontend_workers > 0`` (``pio eventserver --frontend-workers M``)
it runs as the reference's multi-process tier
(``create_multiproc_event_server``, reference ``:580-726``): M
``SO_REUSEPORT`` frontend processes (``serving/frontend.py``) parse HTTP
and forward each request over a shared-memory ring to this process's
router, through the sync dispatcher pool with 32 requests in flight
(``serving/procserver.py``).
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from dataclasses import dataclass, field
from typing import Any

from predictionio_tpu_torch.data import storage as storage_registry
from predictionio_tpu_torch.data.event import (
    Event,
    EventValidationError,
    parse_event_time,
)
from predictionio_tpu_torch.data.ingest import (
    IngestConfig,
    IngestOverload,
    IngestPipeline,
    PartitionedIngestPipeline,
    replay_partitioned_wal,
)
from predictionio_tpu_torch.data.storage.base import AccessKey
from predictionio_tpu_torch.data.wal import PartitionedWal
from predictionio_tpu_torch.data import webhooks as webhook_registry
from predictionio_tpu_torch.utils.http import (
    Request,
    Response,
    ServiceThread,
    instrumented_router,
    make_server,
)

DEFAULT_PORT = 7070

#: how long a request thread waits for its group-commit ack before giving up
#: with a 503 (a stalled storage backend must not hold sockets forever)
ACK_TIMEOUT_S = 30.0


class EventServerPlugin:
    """Hook points mirroring the reference's EventServerPlugin contract.

    ``input_blocker`` may raise :class:`PluginRejection` to reject an event;
    ``input_sniffer`` observes accepted events.
    """

    def input_blocker(self, event: Event, app_id: int, channel_id: int | None) -> None:
        pass

    def input_sniffer(self, event: Event, app_id: int, channel_id: int | None) -> None:
        pass


class PluginRejection(Exception):
    def __init__(self, message: str, status: int = 403):
        super().__init__(message)
        self.status = status


@dataclass
class _Stats:
    """Per-app event counters since server start (reference Stats actor)."""

    start_time: float = field(default_factory=time.time)
    lock: threading.Lock = field(default_factory=threading.Lock)
    # (app_id, event_name, status) -> count
    counts: dict[tuple[int, str, int], int] = field(default_factory=dict)

    def record(self, app_id: int, event_name: str, status: int) -> None:
        with self.lock:
            key = (app_id, event_name, status)
            self.counts[key] = self.counts.get(key, 0) + 1

    def to_json(self) -> dict[str, Any]:
        with self.lock:
            per_app: dict[int, list[dict[str, Any]]] = {}
            for (app_id, name, status), count in sorted(self.counts.items()):
                per_app.setdefault(app_id, []).append(
                    {"event": name, "status": status, "count": count}
                )
        return {
            "uptime": time.time() - self.start_time,
            "appStatistics": [
                {"appId": app_id, "events": events}
                for app_id, events in per_app.items()
            ],
        }


class EventService:
    """Route handlers bound to the storage registry; server-framework free.

    ``ingest_config`` (``data/ingest.IngestConfig``, the reference's
    ``pio eventserver`` knobs) with ``mode="wal"`` starts the group-commit
    pipeline; without one, ``ingest_mode="wal"`` starts it over
    ``wal_partitions`` partitions under ``$PIO_FS_BASEDIR/wal`` with the
    reference's default knobs. ``slow_commit_ms`` logs one span summary
    for each group commit slower than it (reference ``:137-141``)."""

    def __init__(
        self,
        stats: bool = False,
        plugins: list[EventServerPlugin] | None = None,
        ingest_mode: str = "sync",
        tracing: bool | None = None,
        trace_sample: float | None = None,
        wal_partitions: int = 1,
        extra_metrics_snapshots=None,
        ingest_config: IngestConfig | None = None,
        slow_commit_ms: float | None = None,
    ):
        if ingest_config is None:
            ingest_config = IngestConfig(mode=ingest_mode, wal_partitions=wal_partitions)
        check_ingest_mode(ingest_config.mode)
        self.stats_enabled = stats
        self.stats = _Stats()
        self.plugins = list(plugins or [])
        self.ingest: PartitionedIngestPipeline | IngestPipeline | None = None
        self._wal: PartitionedWal | None = None
        self.router, self.metrics = instrumented_router(
            before_scrape=self._before_scrape, tracing=tracing,
            trace_sample=trace_sample,
            extra_snapshots=extra_metrics_snapshots,
        )
        if slow_commit_ms is not None:
            # one summary line per group commit over the threshold
            self.router.tracer.set_slow_threshold(
                "ingest.commit", slow_commit_ms / 1000.0
            )
        if ingest_config.mode == "wal":
            self._start_ingest(ingest_config)
        r = self.router
        r.add("GET", "/", self.handle_root)
        r.add("POST", "/events.json", self.handle_create_event)
        r.add("GET", "/events.json", self.handle_find_events)
        r.add("GET", "/events/<event_id>.json", self.handle_get_event)
        r.add("DELETE", "/events/<event_id>.json", self.handle_delete_event)
        r.add("POST", "/batch/events.json", self.handle_batch)
        r.add("GET", "/stats.json", self.handle_stats)
        r.add("POST", "/webhooks/<connector>.json", self.handle_webhook_post)
        r.add("GET", "/webhooks/<connector>.json", self.handle_webhook_get)

    # -- ingest pipeline lifecycle ------------------------------------------
    def _start_ingest(self, config: IngestConfig) -> None:
        """WAL + group-commit mode: replay the un-flushed tail left by a
        previous crash (exactly-once PER PARTITION -- each stream has its
        own checkpoint), then start the partition writers. P=1 opens the
        flat single-log layout."""
        self._wal = PartitionedWal(
            config.resolved_wal_dir(),
            partitions=config.wal_partitions,
            segment_bytes=config.segment_bytes,
            fsync_policy=config.fsync_policy,
        )
        replayed = replay_partitioned_wal(
            self._wal, tracer=self.router.tracer
        )
        if replayed:
            logging.getLogger("pio.ingest").warning(
                "replayed %d WAL record(s) into the event store", replayed
            )
        self.ingest = PartitionedIngestPipeline(
            self._wal,
            queue_size=config.queue_size,
            group_commit_ms=config.group_commit_ms,
            max_batch=config.max_batch,
            metrics=self.metrics,
            tracer=self.router.tracer,
        ).start()

    def shutdown_ingest(self) -> None:
        """Drain the queue (every accepted event reaches the WAL + store)
        and close the WAL. Safe to call in sync mode or twice.

        ``self.ingest`` deliberately stays set: handler threads can still be
        mid-request after the listener closes (daemon handler threads), and a
        stopped pipeline answers their submits with IngestOverload -> 429
        rather than an attribute race."""
        if self.ingest is not None:
            self.ingest.stop(drain=True)
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    def _before_scrape(self, registry) -> None:
        ingest = self.ingest
        if ingest is not None:
            registry.set_gauge(
                "pio_ingest_queue_depth",
                float(ingest.depth()),
                help="Events parked in the ingest queue awaiting group commit",
            )
            partitions = getattr(ingest, "partitions", 1)
            registry.set_gauge(
                "pio_ingest_partitions",
                float(partitions),
                help="WAL partition count (hash-sharded durability streams)",
            )
            if hasattr(ingest, "depth_of"):
                for k in range(partitions):
                    registry.set_gauge(
                        "pio_ingest_partition_depth",
                        float(ingest.depth_of(k)),
                        labels={"part": str(k)},
                        help="Events parked per WAL partition awaiting"
                        " group commit",
                    )
        wal = self._wal
        if wal is not None:
            registry.set_counter(
                "pio_wal_appends_total", float(wal.append_count),
                help="Records framed into the WAL",
            )
            registry.set_counter(
                "pio_wal_fsyncs_total", float(wal.fsync_count),
                help="WAL fsync calls (one per group commit under policy"
                " 'always')",
            )
            registry.set_gauge(
                "pio_wal_last_fsync_seconds", wal.last_fsync_s,
                help="Duration of the most recent WAL fsync",
            )

    # -- auth ---------------------------------------------------------------
    def _access_key(self, request: Request) -> str | None:
        if "accessKey" in request.query:
            return request.query["accessKey"]
        auth = request.headers.get("Authorization", "")
        # SDKs send the key as the basic-auth username with empty password
        if auth.startswith("Basic "):
            import base64

            try:
                decoded = base64.b64decode(auth[6:]).decode("utf-8")
                return decoded.split(":", 1)[0]
            except Exception:
                return None
        if auth.startswith("Bearer "):
            return auth[7:]
        return None

    def _authorize(self, request: Request) -> tuple[AccessKey, int | None]:
        """Return (access key record, channel id) or raise _AuthError."""
        key = self._access_key(request)
        if not key:
            raise _AuthError(401, "missing accessKey")
        record = storage_registry.get_meta_data_access_keys().get(key)
        if record is None:
            raise _AuthError(401, "invalid accessKey")
        channel_id = None
        channel_name = request.query.get("channel")
        if channel_name:
            channels = storage_registry.get_meta_data_channels().get_by_app(
                record.app_id
            )
            match = [c for c in channels if c.name == channel_name]
            if not match:
                raise _AuthError(400, f"invalid channel {channel_name!r}")
            channel_id = match[0].id
        return record, channel_id

    def _check_event_allowed(self, record: AccessKey, event_name: str) -> None:
        if record.events and event_name not in record.events:
            raise _AuthError(
                403, f"accessKey is not allowed to write event {event_name!r}"
            )

    # -- handlers -----------------------------------------------------------
    def handle_root(self, request: Request) -> Response:
        return Response(200, {"status": "alive"})

    def _prepare(
        self, obj: Any, record: AccessKey, channel_id: int | None
    ) -> Event | tuple[int, dict[str, Any]]:
        """Validate + authorize + run input blockers on the request thread;
        returns the Event, or the (status, body) rejection."""
        try:
            with self.router.tracer.span("ingest.parse"):
                return self._prepare_inner(obj, record, channel_id)
        except EventValidationError as exc:
            if self.stats_enabled:
                name = obj.get("event", "<invalid>") if isinstance(obj, dict) else "<invalid>"
                self.stats.record(record.app_id, str(name), 400)
            return 400, {"message": str(exc)}
        except _AuthError as exc:
            # whitelist denial: surface in /stats.json like any other outcome
            if self.stats_enabled and isinstance(obj, dict):
                self.stats.record(record.app_id, str(obj.get("event")), exc.status)
            return exc.status, {"message": str(exc)}
        except PluginRejection as exc:
            if self.stats_enabled and isinstance(obj, dict):
                self.stats.record(record.app_id, str(obj.get("event")), exc.status)
            return exc.status, {"message": str(exc)}

    def _prepare_inner(
        self, obj: Any, record: AccessKey, channel_id: int | None
    ) -> Event:
        if isinstance(obj, dict):
            # creationTime is server-assigned on the ingest path; a client
            # (unlike pio import) may not spoof it
            obj = {k: v for k, v in obj.items() if k != "creationTime"}
        event = Event.from_json_obj(obj)
        self._check_event_allowed(record, event.event)
        for plugin in self.plugins:
            plugin.input_blocker(event, record.app_id, channel_id)
        return event

    def _ack(
        self, event: Event, record: AccessKey, channel_id: int | None, event_id: str
    ) -> tuple[int, dict[str, Any]]:
        for plugin in self.plugins:
            plugin.input_sniffer(event, record.app_id, channel_id)
        if self.stats_enabled:
            self.stats.record(record.app_id, event.event, 201)
        self.metrics.inc(
            "pio_events_ingested_total",
            {"app_id": str(record.app_id)},
            help="Events accepted into the event store",
        )
        return 201, {"eventId": event_id}

    def _insert_prepared(
        self, events: list[Event], record: AccessKey, channel_id: int | None
    ) -> list[tuple[int, dict[str, Any]]]:
        """Commit already-validated events. Sync mode: one storage insert
        per event on the request thread. WAL mode: submit ALL of them
        before waiting, so a batch request rides a single group commit; a
        full queue yields per-item 429s."""
        if self.ingest is None:
            out = []
            for ev in events:
                with self.router.tracer.span("storage.insert"):
                    event_id = storage_registry.get_l_events().insert(
                        ev, record.app_id, channel_id
                    )
                out.append(self._ack(ev, record, channel_id, event_id))
            return out
        submitted: list[Any] = []
        for ev in events:
            try:
                submitted.append(self.ingest.submit(ev, record.app_id, channel_id))
            except IngestOverload as exc:
                submitted.append(exc)
        results = []
        # one shared deadline for the whole request: a stalled pipeline must
        # bound the socket hold at ACK_TIMEOUT_S total, not per item
        deadline = time.monotonic() + ACK_TIMEOUT_S
        for ev, fut in zip(events, submitted):
            if isinstance(fut, IngestOverload):
                results.append(
                    (429, {"message": "ingestion queue full, retry later"})
                )
                continue
            try:
                event_id = fut.result(
                    timeout=max(0.0, deadline - time.monotonic())
                )
            except _FutureTimeout:
                results.append(
                    (503, {"message": "ingestion pipeline stalled, retry later"})
                )
                continue
            except IngestOverload:
                results.append(
                    (429, {"message": "ingestion queue full, retry later"})
                )
                continue
            except Exception as exc:
                results.append(
                    (500, {"message": f"ingestion failed: {exc}"})
                )
                continue
            results.append(self._ack(ev, record, channel_id, event_id))
        return results

    def _insert_one(
        self, obj: Any, record: AccessKey, channel_id: int | None
    ) -> tuple[int, dict[str, Any]]:
        prepared = self._prepare(obj, record, channel_id)
        if not isinstance(prepared, Event):
            return prepared
        return self._insert_prepared([prepared], record, channel_id)[0]

    def _retry_after_headers(self, status: int) -> dict[str, str]:
        if status != 429 or self.ingest is None:
            return {}
        return {"Retry-After": str(max(1, math.ceil(self.ingest.retry_after_s)))}

    def handle_create_event(self, request: Request) -> Response:
        try:
            record, channel_id = self._authorize(request)
        except _AuthError as exc:
            return Response(exc.status, {"message": str(exc)})
        try:
            obj = request.json()
        except json.JSONDecodeError:
            return Response(400, {"message": "malformed JSON body"})
        status, body = self._insert_one(obj, record, channel_id)
        return Response(status, body, headers=self._retry_after_headers(status))

    def handle_batch(self, request: Request) -> Response:
        try:
            record, channel_id = self._authorize(request)
        except _AuthError as exc:
            return Response(exc.status, {"message": str(exc)})
        try:
            objs = request.json()
        except json.JSONDecodeError:
            return Response(400, {"message": "malformed JSON body"})
        if not isinstance(objs, list):
            return Response(400, {"message": "request body must be a JSON array"})
        if len(objs) > 50:
            return Response(
                400, {"message": "batch size must be <= 50 events per request"}
            )
        # two-phase so the whole request rides one group commit in WAL mode:
        # prepare (reject invalid items individually), submit the valid ones
        # together, then stitch per-item statuses back in request order
        prepared: list[Event | tuple[int, dict[str, Any]]] = [
            self._prepare(obj, record, channel_id) for obj in objs
        ]
        valid = [p for p in prepared if isinstance(p, Event)]
        committed = iter(self._insert_prepared(valid, record, channel_id))
        results = []
        for p in prepared:
            status, body = next(committed) if isinstance(p, Event) else p
            results.append({"status": status, **body})
        return Response(200, results)

    def handle_get_event(self, request: Request) -> Response:
        try:
            record, channel_id = self._authorize(request)
        except _AuthError as exc:
            return Response(exc.status, {"message": str(exc)})
        event = storage_registry.get_l_events().get(
            request.path_params["event_id"], record.app_id, channel_id
        )
        if event is None:
            return Response(404, {"message": "event not found"})
        return Response(200, event.to_json_obj())

    def handle_delete_event(self, request: Request) -> Response:
        try:
            record, channel_id = self._authorize(request)
        except _AuthError as exc:
            return Response(exc.status, {"message": str(exc)})
        found = storage_registry.get_l_events().delete(
            request.path_params["event_id"], record.app_id, channel_id
        )
        if not found:
            return Response(404, {"message": "event not found"})
        return Response(200, {"message": "deleted"})

    def handle_find_events(self, request: Request) -> Response:
        try:
            record, channel_id = self._authorize(request)
        except _AuthError as exc:
            return Response(exc.status, {"message": str(exc)})
        q = request.query
        try:
            start_time = parse_event_time(q["startTime"]) if "startTime" in q else None
            until_time = parse_event_time(q["untilTime"]) if "untilTime" in q else None
        except EventValidationError as exc:
            return Response(400, {"message": str(exc)})
        limit = None
        if "limit" in q:
            try:
                limit = int(q["limit"])
            except ValueError:
                return Response(400, {"message": "limit must be an integer"})
            if limit < -1:
                return Response(
                    400, {"message": "limit must be -1 (unlimited) or >= 0"}
                )
        event_names = q["event"].split(",") if "event" in q else None
        kwargs: dict[str, Any] = {}
        if "targetEntityType" in q:
            kwargs["target_entity_type"] = q["targetEntityType"]
        if "targetEntityId" in q:
            kwargs["target_entity_id"] = q["targetEntityId"]
        events = storage_registry.get_l_events().find(
            app_id=record.app_id,
            channel_id=channel_id,
            start_time=start_time,
            until_time=until_time,
            entity_type=q.get("entityType"),
            entity_id=q.get("entityId"),
            event_names=event_names,
            # upstream parity: limit=-1 means unlimited (None to the DAO);
            # absent means the default page of 20
            limit=20 if limit is None else (None if limit == -1 else limit),
            reversed=q.get("reversed", "false").lower() == "true",
            **kwargs,
        )
        return Response(200, [e.to_json_obj() for e in events])

    def handle_stats(self, request: Request) -> Response:
        if not self.stats_enabled:
            return Response(
                404, {"message": "stats not enabled (start server with --stats)"}
            )
        return Response(200, self.stats.to_json())

    # -- webhooks -----------------------------------------------------------
    def handle_webhook_post(self, request: Request) -> Response:
        try:
            record, channel_id = self._authorize(request)
        except _AuthError as exc:
            return Response(exc.status, {"message": str(exc)})
        name = request.path_params["connector"]
        content_type = request.headers.get("Content-Type", "")
        try:
            if "application/x-www-form-urlencoded" in content_type:
                connector = webhook_registry.FORM_CONNECTORS.get(name)
                if connector is None:
                    return Response(404, {"message": f"unknown form connector {name!r}"})
                event = connector.to_event(request.form())
            else:
                connector = webhook_registry.JSON_CONNECTORS.get(name)
                if connector is None:
                    return Response(404, {"message": f"unknown connector {name!r}"})
                payload = request.json()
                if not isinstance(payload, dict):
                    return Response(400, {"message": "webhook body must be a JSON object"})
                event = connector.to_event(payload)
        except webhook_registry.ConnectorError as exc:
            return Response(400, {"message": str(exc)})
        except json.JSONDecodeError:
            return Response(400, {"message": "malformed JSON body"})
        status, body = self._insert_one(event.to_json_obj(), record, channel_id)
        return Response(status, body)

    def handle_webhook_get(self, request: Request) -> Response:
        name = request.path_params["connector"]
        known = name in webhook_registry.JSON_CONNECTORS or name in webhook_registry.FORM_CONNECTORS
        if not known:
            return Response(404, {"message": f"unknown connector {name!r}"})
        return Response(200, {"connector": name, "status": "ready"})


class _AuthError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def check_ingest_mode(ingest_mode: str = "sync") -> None:
    """Refuse an ingest mode the event server does not have."""
    if ingest_mode not in ("sync", "wal"):
        raise ValueError(f"ingest mode must be sync or wal, got {ingest_mode!r}")


def create_event_server(
    host: str = "0.0.0.0",
    port: int = DEFAULT_PORT,
    stats: bool = False,
    plugins: list[EventServerPlugin] | None = None,
    ingest_mode: str = "sync",
    tracing: bool | None = None,
    trace_sample: float | None = None,
    wal_partitions: int = 1,
    ingest_config: IngestConfig | None = None,
    slow_commit_ms: float | None = None,
) -> ServiceThread:
    service = EventService(
        stats=stats, plugins=plugins, ingest_mode=ingest_mode,
        tracing=tracing, trace_sample=trace_sample, wal_partitions=wal_partitions,
        ingest_config=ingest_config, slow_commit_ms=slow_commit_ms,
    )
    server = make_server(service.router, host, port, "pio-eventserver")
    # drain the group-commit queue on stop: every acknowledged event reaches
    # the WAL and the store before the thread reports stopped
    return ServiceThread(server, on_stop=service.shutdown_ingest)


class MultiprocEventServerHandle:
    """Lifecycle wrapper for the multi-process event-server tier: M
    SO_REUSEPORT frontend workers (``ScorerBridge`` is generic over any
    Router) feeding this process's ingest pipeline through the dispatcher
    pool. Defined here, NOT in ``workflow/create_server`` -- that module
    drags in the torch engine stack, which an event server must never
    import."""

    def __init__(self, bridge, service: EventService):
        self._bridge = bridge
        self.service = service

    @property
    def port(self) -> int | None:
        return self._bridge.port

    def stop(self) -> None:
        """Drain frontends FIRST (no new submits can arrive once the
        workers are gone), then drain the group-commit queues -- the
        reverse order would strand in-flight requests on a stopped
        pipeline's 429s mid-drain."""
        self._bridge.stop()
        self.service.shutdown_ingest()


def create_multiproc_event_server(
    host: str = "0.0.0.0",
    port: int = DEFAULT_PORT,
    stats: bool = False,
    plugins: list[EventServerPlugin] | None = None,
    ingest_config: IngestConfig | None = None,
    tracing: bool | None = None,
    trace_sample: float | None = None,
    slow_commit_ms: float | None = None,
    frontend_config=None,
) -> MultiprocEventServerHandle:
    """Multi-process event server: frontends parse HTTP and forward over
    shared-memory rings; this process runs the routes (and, in WAL mode,
    the WAL partitions). Dispatch is the SYNC pool (``async_query=None``):
    an ingest request legitimately parks its dispatcher thread on the
    group-commit future, so ``max_inflight`` is the tier's
    ingest-concurrency bound.

    The returned handle is started; callers print/wait/stop."""
    from predictionio_tpu_torch.serving.procserver import (
        FrontendConfig,
        ScorerBridge,
    )

    if frontend_config is None:
        frontend_config = FrontendConfig(dispatch="sync", max_inflight=32)
    # late-bound cell: the service's /metrics scrape merges worker
    # snapshots, but the bridge needs the service's router first
    bridge_cell: list = []

    def worker_snapshots() -> list[dict]:
        return bridge_cell[0].metric_snapshots() if bridge_cell else []

    service = EventService(
        stats=stats, plugins=plugins, ingest_config=ingest_config,
        tracing=tracing, trace_sample=trace_sample,
        slow_commit_ms=slow_commit_ms,
        extra_metrics_snapshots=worker_snapshots,
    )
    bridge = ScorerBridge(
        service.router, host, port, frontend_config,
        server_name="pio-eventserver", registry=service.metrics,
    )
    bridge_cell.append(bridge)
    try:
        bridge.start()
    except Exception:
        service.shutdown_ingest()
        raise
    return MultiprocEventServerHandle(bridge, service)


def run_event_server(
    host: str = "0.0.0.0",
    port: int = DEFAULT_PORT,
    stats: bool = False,
    ssl_cert: str | None = None,
    ssl_key: str | None = None,
    plugins: list[EventServerPlugin] | None = None,
    ingest_config: IngestConfig | None = None,
    tracing: bool | None = None,
    trace_sample: float | None = None,
    slow_commit_ms: float | None = None,
    frontend_workers: int = 0,
) -> None:
    """Blocking entry point used by ``pio eventserver``; with
    ``frontend_workers`` > 0 the multi-process tier."""
    if frontend_workers > 0:
        if ssl_cert or ssl_key:
            # TLS terminates in the worker processes or nowhere; the rings
            # carry parsed frames, not TLS streams
            raise ValueError(
                "--frontend-workers does not support --ssl-cert/--ssl-key;"
                " terminate TLS in front of the frontends"
            )
        from predictionio_tpu_torch.serving.procserver import FrontendConfig

        handle = create_multiproc_event_server(
            host=host, port=port, stats=stats, plugins=plugins,
            ingest_config=ingest_config, tracing=tracing,
            trace_sample=trace_sample, slow_commit_ms=slow_commit_ms,
            frontend_config=FrontendConfig(
                workers=frontend_workers, dispatch="sync", max_inflight=32,
            ),
        )
        service = handle.service
        mode = "wal" if service.ingest is not None else "sync"
        parts = getattr(service.ingest, "partitions", 1)
        print(
            f"Event Server listening on http://{host}:{handle.port}"
            f" (stats={'on' if stats else 'off'}, ingest={mode},"
            f" wal-partitions={parts},"
            f" frontend-workers={frontend_workers},"
            f" plugins={len(service.plugins)})",
            flush=True,
        )
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
        finally:
            handle.stop()
        return
    service = EventService(
        stats=stats, plugins=plugins, ingest_config=ingest_config,
        tracing=tracing, trace_sample=trace_sample,
        slow_commit_ms=slow_commit_ms,
    )
    server = make_server(
        service.router, host, port, "pio-eventserver",
        ssl_cert=ssl_cert, ssl_key=ssl_key,
    )
    scheme = "https" if ssl_cert else "http"
    mode = "wal" if service.ingest is not None else "sync"
    parts = getattr(service.ingest, "partitions", 1)
    print(
        f"Event Server listening on {scheme}://{host}:{server.server_address[1]}"
        f" (stats={'on' if stats else 'off'}, ingest={mode},"
        f" wal-partitions={parts}, plugins={len(service.plugins)})",
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.shutdown_ingest()
