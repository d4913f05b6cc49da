"""Query server of the port: queries, status and the model hot swap.

A compact counterpart of ``predictionio_tpu/workflow/create_server.py``
on stdlib ``http.server.ThreadingHTTPServer``:

- ``GET /`` returns the status body (after ``QueryService.handle_info``),
  with ``modelVersion``: the registry version serving, or null for an
  instance or model-directory deploy;
- ``POST /queries.json`` runs predict -> serving for one query (after
  ``QueryService._predict_one``) and answers the serialized result, with
  the ``x-pio-model-version`` header once a registry version serves;
  malformed JSON and bad queries (``KeyError``/``TypeError``/
  ``ValueError`` out of predict) answer 400, as the reference does;
- ``POST /models/swap {"version": N?}`` hot-swaps a model-registry
  version (default: the latest) into the live epoch (reference
  ``:919-947``): the retrain loop's notify target and the rollback
  lever. A missing or corrupt version answers 404 and the old epoch
  keeps serving;
- ``POST /models/lag {"foldinLagSeconds": x}``: the retrain loop's lag
  heartbeat (reference ``:949``).

The swap epoch (reference ``:377-470``): a version is rehydrated OUTSIDE
the lock -- blob read and CRC-checked, deserialized, its serving state
built (``warm_up`` packs the retrieval index) -- then algorithms,
models, serving and version are bound in ONE locked assignment. Query
paths snapshot the epoch under the same lock, so no response is
computed from a mixed-version epoch; swaps are serialized against each
other, so they take effect in request order.

The micro-batcher, plugins, feedback, ``GET /models.json``, scorer
shards and the multi-process tier are not ported yet (ROADMAP.md Queue
A item 4).
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Sequence

from predictionio_tpu_torch.online.registry import RegistryError

logger = logging.getLogger("pio.torch.server")


class QueryService:
    """Deployed algorithms + their models + the serving combinator.

    ``registry`` (an ``online.registry.ModelRegistry``) and ``loader``
    (a registry version -> ``(algorithms, models, serving)``, warmed up)
    enable ``POST /models/swap``; ``model_version`` names the registry
    version the initial epoch came from, if any.
    """

    def __init__(self, algorithms: Sequence, models: Sequence, serving, *,
                 registry=None, loader: Callable | None = None,
                 model_version: int | None = None):
        if len(algorithms) != len(models) or not algorithms:
            raise ValueError("one model per algorithm, at least one of each")
        self.algorithms = list(algorithms)
        self.models = list(models)
        self.serving = serving
        self.registry = registry
        self._loader = loader
        self._started = _dt.datetime.now(_dt.timezone.utc)
        #: guards the epoch (algorithms, models, serving, version) and the
        #: counters; queries hold it only to snapshot the epoch
        self._lock = threading.Lock()
        #: serializes swaps, so they take effect in request order, not in
        #: rehydrate-completion order; queries never take it
        self._swap_lock = threading.Lock()
        self._served = 0
        self.model_version = model_version
        self.last_swap_ts: float | None = None
        self.foldin_lag_s: float | None = None

    def handle_info(self) -> tuple[int, dict]:
        with self._lock:
            algorithms = self.algorithms
            served = self._served
            version = self.model_version
        return 200, {
            "status": "alive",
            "algorithms": [type(a).__name__ for a in algorithms],
            "devices": [str(getattr(a, "device", "cpu")) for a in algorithms],
            "modelVersion": version,
            "startTime": self._started.isoformat(),
            "serverStats": {"queryCount": served},
        }

    def _predict_one(self, query_obj) -> tuple[Any, Any, int | None]:
        """The predict -> serve chain for one raw query dict; returns
        ``(result, serializer, model_version)`` -- all of one epoch,
        captured in ONE lock acquisition, so a concurrent hot swap can
        never mix versions in (or mislabel) a response."""
        with self._lock:
            algorithms = self.algorithms
            models = self.models
            serving = self.serving
            version = self.model_version
        typed_query = algorithms[0].query_from_json(query_obj)
        predictions = [
            algorithm.predict(model, algorithm.query_from_json(query_obj))
            for algorithm, model in zip(algorithms, models)
        ]
        return serving.serve(typed_query, predictions), algorithms[0], version

    def handle_query(self, body: bytes) -> tuple[int, Any, dict]:
        try:
            query_obj = json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return 400, {"message": "malformed JSON query"}, {}
        try:
            result, serializer, version = self._predict_one(query_obj)
        except (KeyError, TypeError, ValueError) as exc:
            return 400, {"message": f"bad query: {exc}"}, {}
        result_json = serializer.result_to_json(result)
        if not isinstance(result_json, (dict, list)):
            result_json = {"result": result_json}
        with self._lock:
            self._served += 1
        # attribution header: which registry version computed THIS response
        headers = {} if version is None else {"x-pio-model-version": str(version)}
        return 200, result_json, headers

    # -- the swap epoch ------------------------------------------------------
    def swap_to_version(self, version: int | None) -> int:
        """Hot-swap registry ``version`` (None: the latest) into the live
        epoch; returns the swapped version. Raises ``RegistryError`` on a
        missing or corrupt version (the old epoch keeps serving)."""
        with self._swap_lock:
            registry = self.registry
            if registry is None or self._loader is None:
                raise RegistryError("this server was deployed without a model registry")
            entry = registry.get(version) if version is not None else registry.latest()
            if entry is None:
                raise RegistryError(
                    f"model registry is empty under {registry.dir}; run"
                    " `pio retrain` first"
                )
            # slow work outside the epoch lock: queries keep being answered
            algorithms, models, serving = self._loader(entry)
            with self._lock:
                self.algorithms = list(algorithms)
                self.models = list(models)
                self.serving = serving
                self.model_version = entry.version
                self.last_swap_ts = time.time()
        logger.info(
            "hot-swapped model version %d (%s, instance %s)",
            entry.version, entry.source, entry.instance_id or "?",
        )
        return entry.version

    def handle_model_swap(self, body: bytes) -> tuple[int, dict]:
        """``POST /models/swap {"version": N?}``: 404 for a missing or
        corrupt version, 500 when rehydrating fails; either way the old
        epoch keeps serving."""
        try:
            obj = json.loads(body or b"{}") or {}
        except (json.JSONDecodeError, UnicodeDecodeError):
            return 400, {"message": "malformed JSON body"}
        version = obj.get("version")
        if version is not None:
            try:
                version = int(version)
            except (TypeError, ValueError):
                return 400, {"message": f"bad version {version!r}"}
        try:
            swapped = self.swap_to_version(version)
        except RegistryError as exc:
            return 404, {"message": str(exc)}
        except Exception as exc:
            logger.exception("model swap failed")
            return 500, {"message": f"swap failed: {exc}"}
        lag = obj.get("foldinLagSeconds")
        if isinstance(lag, (int, float)):
            with self._lock:
                self.foldin_lag_s = float(lag)
        return 200, {"status": "swapped", "modelVersion": swapped}

    def handle_model_lag(self, body: bytes) -> tuple[int, dict]:
        """The retrain loop's fold-in lag heartbeat."""
        try:
            obj = json.loads(body or b"{}") or {}
        except (json.JSONDecodeError, UnicodeDecodeError):
            return 400, {"message": "malformed JSON body"}
        lag = obj.get("foldinLagSeconds")
        if not isinstance(lag, (int, float)):
            return 400, {"message": "foldinLagSeconds required"}
        with self._lock:
            self.foldin_lag_s = float(lag)
        return 200, {"status": "ok"}


class _Handler(BaseHTTPRequestHandler):
    service: QueryService  # bound per server by create_query_server
    # the reference's socket contract (utils/http.py make_server): HTTP/1.1
    # keep-alive, and one TCP segment per response -- a buffered wfile
    # (flushed by handle_one_request) plus NODELAY, so headers and body
    # never wait on Nagle and the client's delayed ACK
    protocol_version = "HTTP/1.1"
    wbufsize = -1
    disable_nagle_algorithm = True

    def _send(self, status: int, body: Any, headers: dict | None = None) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=UTF-8")
        self.send_header("Content-Length", str(len(data)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 (http.server's naming)
        if self.path.split("?", 1)[0] == "/":
            self._send(*self.service.handle_info())
        else:
            self._send(404, {"message": f"no route for GET {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length)
        route = {
            "/queries.json": self.service.handle_query,
            "/models/swap": self.service.handle_model_swap,
            "/models/lag": self.service.handle_model_lag,
        }.get(self.path.split("?", 1)[0])
        if route is None:
            self._send(404, {"message": f"no route for POST {self.path}"})
            return
        try:
            self._send(*route(body))
        except Exception:
            # a server boundary: record the fault, answer 500, keep serving
            logger.exception("request failed")
            self._send(500, {"message": "internal error"})

    def log_message(self, fmt: str, *args) -> None:
        logger.debug("%s " + fmt, self.address_string(), *args)


def create_query_server(
    service: QueryService, host: str = "127.0.0.1", port: int = 8000
) -> ThreadingHTTPServer:
    """A bound (not yet serving) HTTP server for ``service``; port 0
    picks a free port (``server.server_address[1]``). Call
    ``serve_forever()`` to serve and ``shutdown()`` + ``server_close()``
    to stop."""
    handler = type("QueryHandler", (_Handler,), {"service": service})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server
