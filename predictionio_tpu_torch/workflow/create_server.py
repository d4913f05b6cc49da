"""Query server of the port: ``GET /`` and ``POST /queries.json``.

A compact counterpart of ``predictionio_tpu/workflow/create_server.py``
on stdlib ``http.server.ThreadingHTTPServer``:

- ``GET /`` returns the status body (after ``QueryService.handle_info``);
- ``POST /queries.json`` runs predict -> serving for one query (after
  ``QueryService._predict_one``) and answers the serialized result;
- malformed JSON and bad queries (``KeyError``/``TypeError``/
  ``ValueError`` out of predict) answer 400, as the reference does.

The micro-batcher, plugins, feedback, hot swap, scorer shards and the
multi-process tier are not ported yet.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Sequence

logger = logging.getLogger("pio.torch.server")


class QueryService:
    """Deployed algorithms + their models + the serving combinator."""

    def __init__(self, algorithms: Sequence, models: Sequence, serving):
        if len(algorithms) != len(models) or not algorithms:
            raise ValueError("one model per algorithm, at least one of each")
        self.algorithms = list(algorithms)
        self.models = list(models)
        self.serving = serving
        self._started = _dt.datetime.now(_dt.timezone.utc)
        self._lock = threading.Lock()
        self._served = 0

    def handle_info(self) -> tuple[int, dict]:
        with self._lock:
            served = self._served
        return 200, {
            "status": "alive",
            "algorithms": [type(a).__name__ for a in self.algorithms],
            "devices": [str(getattr(a, "device", "cpu")) for a in self.algorithms],
            "startTime": self._started.isoformat(),
            "serverStats": {"queryCount": served},
        }

    def _predict_one(self, query_obj) -> Any:
        """The predict -> serve chain for one raw query dict."""
        typed_query = self.algorithms[0].query_from_json(query_obj)
        predictions = [
            algorithm.predict(model, algorithm.query_from_json(query_obj))
            for algorithm, model in zip(self.algorithms, self.models)
        ]
        return self.serving.serve(typed_query, predictions)

    def handle_query(self, body: bytes) -> tuple[int, Any]:
        try:
            query_obj = json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return 400, {"message": "malformed JSON query"}
        try:
            result = self._predict_one(query_obj)
        except (KeyError, TypeError, ValueError) as exc:
            return 400, {"message": f"bad query: {exc}"}
        result_json = self.algorithms[0].result_to_json(result)
        if not isinstance(result_json, (dict, list)):
            result_json = {"result": result_json}
        with self._lock:
            self._served += 1
        return 200, result_json


class _Handler(BaseHTTPRequestHandler):
    service: QueryService  # bound per server by create_query_server
    # the reference's socket contract (utils/http.py make_server): HTTP/1.1
    # keep-alive, and one TCP segment per response -- a buffered wfile
    # (flushed by handle_one_request) plus NODELAY, so headers and body
    # never wait on Nagle and the client's delayed ACK
    protocol_version = "HTTP/1.1"
    wbufsize = -1
    disable_nagle_algorithm = True

    def _send(self, status: int, body: Any) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=UTF-8")
        self.send_header("Content-Length", str(len(data)))
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
        if self.path.split("?", 1)[0] == "/queries.json":
            try:
                self._send(*self.service.handle_query(body))
            except Exception:
                # a server boundary: record the fault, answer 500, keep serving
                logger.exception("query failed")
                self._send(500, {"message": "internal error"})
        else:
            self._send(404, {"message": f"no route for POST {self.path}"})

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
