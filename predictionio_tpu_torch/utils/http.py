"""Minimal threaded HTTP service toolkit over the standard library.

The reference serves REST with akka-http actors (SURVEY.md section 2.2 #15,
#25); here a ``ThreadingHTTPServer`` + route table plays that role -- no
external web framework is required. CORS and JSON envelopes are handled
centrally so every service (event server, query server, dashboard, admin)
shares behavior.

Port copy: ``predictionio_tpu/utils/http.py`` (framework-free), verbatim,
under the port's package name; ``tests/test_torch_imports.py`` holds it
to the original.
"""

from __future__ import annotations

import json
import re
import threading
import time
import traceback
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import parse_qs, urlparse

from predictionio_tpu_torch.obs.trace import format_traceparent


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes
    path_params: dict[str, str]
    #: set by the multi-process serving tier: ``(recv_pc, dispatch_pc,
    #: worker)`` -- the frontend worker's perf_counter timestamps (Linux
    #: CLOCK_MONOTONIC is system-wide, so they share the scorer's clock)
    #: bracketing the ring hop; the dispatch root records them as a
    #: ``frontend.ring_wait`` span so traces stitch across the process
    #: boundary
    frontend_pc: tuple | None = None

    def json(self) -> Any:
        if not self.body:
            return None
        return json.loads(self.body.decode("utf-8"))

    def form(self) -> dict[str, str]:
        parsed = parse_qs(self.body.decode("utf-8"), keep_blank_values=True)
        return {k: v[0] for k, v in parsed.items()}


@dataclass
class Response:
    status: int = 200
    body: Any = None
    content_type: str = "application/json; charset=utf-8"
    #: extra response headers (e.g. Retry-After on 429 backpressure)
    headers: dict[str, str] = field(default_factory=dict)

    def payload(self) -> bytes:
        if self.body is None:
            return b""
        if isinstance(self.body, bytes):
            return self.body
        if isinstance(self.body, str):
            return self.body.encode("utf-8")
        return json.dumps(self.body).encode("utf-8")


Handler = Callable[[Request], Response]


class Router:
    """Route table: (method, path regex with <name> captures) -> handler.

    With a ``metrics`` registry attached (``utils.metrics``), every dispatch
    records ``pio_http_requests_total{method,route,status}`` and a
    ``pio_http_request_duration_seconds`` histogram, labeled by the ROUTE
    PATTERN (bounded cardinality), not the raw path.

    With a ``tracer`` attached (``obs.trace``), every dispatch runs under
    a root span named by the route pattern: an inbound W3C ``traceparent``
    header joins the caller's trace, the response carries ``traceparent``
    out, error-status JSON bodies gain a ``traceId`` field, and handler
    exceptions become a 500 WITH the trace id (traceback still printed --
    the ``make_server`` backstop behavior, moved here so the trace id
    exists when the response is built).
    """

    def __init__(self, metrics=None, tracer=None):
        self._routes: list[tuple[str, str, re.Pattern, Handler]] = []
        self.metrics = metrics
        self.tracer = tracer

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        regex = re.sub(r"<([a-zA-Z_]+)>", r"(?P<\1>[^/]+)", pattern)
        self._routes.append(
            (method.upper(), pattern, re.compile(f"^{regex}$"), handler)
        )

    def route(self, method: str, pattern: str):
        def deco(fn: Handler) -> Handler:
            self.add(method, pattern, fn)
            return fn

        return deco

    #: never traced: a scrape loop (Prometheus, `pio top`) would otherwise
    #: flood the ring buffers with its own polling traffic
    UNTRACED_PATHS = ("/metrics", "/traces.json")

    def dispatch(self, request: Request) -> Response:
        tracer = self.tracer
        if (
            tracer is None
            or not tracer.enabled
            or request.path in self.UNTRACED_PATHS
        ):
            return self._dispatch(request, None)
        traceparent = next(
            (
                v
                for k, v in request.headers.items()
                if k.lower() == "traceparent"
            ),
            None,
        )
        with tracer.start_remote(
            f"{request.method} {request.path}", traceparent
        ) as span:
            # a sampled-out root (trace_id None) suppresses all span work
            # for the request; it must also not emit ids it never made
            sampled = span.trace_id is not None
            if sampled and request.frontend_pc is not None:
                recv_pc, dispatch_pc, worker = request.frontend_pc
                tracer.record_span(
                    span.trace_id, "frontend.ring_wait",
                    recv_pc, dispatch_pc,
                    parent_id=span.span_id, attrs={"worker": worker},
                )
            response = self._dispatch(request, span if sampled else None)
            if sampled:
                span.set_attr("status", response.status)
                if response.status >= 500:
                    span.set_status("error")
                response.headers.setdefault(
                    "traceparent",
                    format_traceparent(span.trace_id, span.span_id),
                )
                # error bodies carry the trace id so a client report ("here
                # is the 429 I got") joins directly to the server-side trace
                if response.status >= 400 and isinstance(response.body, dict):
                    response.body.setdefault("traceId", span.trace_id)
        return response

    def _dispatch(self, request: Request, span) -> Response:
        t0 = time.perf_counter()
        route_label = "<unmatched>"
        path_matched = False
        response = None
        for method, pattern, regex, handler in self._routes:
            m = regex.match(request.path)
            if not m:
                continue
            if not path_matched:
                path_matched = True
                route_label = pattern  # known even for a 405 below
            if method != request.method:
                continue
            request.path_params = m.groupdict()
            route_label = pattern
            if span is not None:
                # route pattern, not raw path: bounded op cardinality
                span.set_op(f"{request.method} {pattern}")
            try:
                response = handler(request)
            except json.JSONDecodeError:
                # same mapping the server backstop applies -- handled here
                # so the metric records the 400 the client actually gets
                response = Response(400, {"message": "malformed JSON body"})
            except Exception:
                # same backstop contract as make_server (traceback printed,
                # generic 500), handled here so the active span can stamp
                # its trace id onto the response
                traceback.print_exc()
                response = Response(500, {"message": "internal server error"})
            except BaseException:
                self._record(request, route_label, 500, t0)
                raise
            break
        if response is None:
            response = (
                Response(405, {"message": "method not allowed"})
                if path_matched
                else Response(404, {"message": "not found"})
            )
            if span is not None:
                # no handler ran, so the span still carries the raw client
                # path as its op; rename to the bounded route label or the
                # span->histogram bridge mints one series per scanner probe
                span.set_op(f"{request.method} {route_label}")
        self._record(request, route_label, response.status, t0)
        return response

    def record_route(
        self, request: Request, route: str, status: int, t0: float
    ) -> None:
        """Record the per-route request metrics for a request answered
        OUTSIDE ``dispatch`` -- the async scorer fast path submits
        ``/queries.json`` straight into the micro-batcher and finishes in
        a future callback, but its requests must land in the same
        ``pio_http_requests_total``/duration series with the same bounded
        route label."""
        self._record(request, route, status, t0)

    def _record(self, request: Request, route: str, status: int, t0: float) -> None:
        if self.metrics is None:
            return
        labels = {"method": request.method, "route": route, "status": str(status)}
        self.metrics.inc(
            "pio_http_requests_total", labels, help="HTTP requests served"
        )
        self.metrics.observe(
            "pio_http_request_duration_seconds",
            time.perf_counter() - t0,
            {"route": route},
            help="Request handling latency",
        )


def instrumented_router(
    before_scrape=None,
    tracing: bool | None = None,
    trace_sample: float | None = None,
    extra_snapshots=None,
) -> tuple[Router, "object"]:
    """(router, registry): a Router wired to a fresh MetricsRegistry with
    the ``GET /metrics`` Prometheus exposition route installed -- the one
    definition every service (event, query, dashboard, admin) shares --
    plus a span tracer (``router.tracer``) exposing ``GET /traces.json``
    (recent + slowest + error traces; ``?op=substr&min_ms=N&limit=N``).

    ``before_scrape(registry)`` runs on every /metrics request, letting a
    service mirror externally-tracked state (e.g. the query server's
    served-count) into the registry without maintaining it in two places.

    ``tracing`` defaults to on unless ``PIO_TRACING=0``; pass False for
    an A/B arm or a zero-overhead deployment (the disabled path hands out
    one shared no-op span and allocates nothing). ``trace_sample``
    defaults to ``PIO_TRACE_SAMPLE`` (1-in-8): headerless roots -- and
    ``traceparent`` headers with the W3C sampled flag clear (``-00``) --
    sample at that rate, while a header with the flag set always traces;
    pass 1.0 to trace everything.

    ``extra_snapshots()`` (optional) returns a list of
    ``MetricsRegistry.snapshot()`` dicts from OTHER processes -- the
    multi-process serving tier's frontend workers -- merged into every
    ``/metrics`` scrape so the deployed server exposes ONE aggregated
    view (counters/histograms sum across workers; gauges last-wins).
    """
    from predictionio_tpu_torch.obs.trace import (
        Tracer,
        tracing_enabled_default,
        tracing_sample_default,
    )
    from predictionio_tpu_torch.utils.metrics import (
        CONTENT_TYPE,
        MetricsRegistry,
        build_info_labels,
        global_registry,
        span_bridge,
    )

    registry = MetricsRegistry()
    if tracing is None:
        tracing = tracing_enabled_default()
    if trace_sample is None:
        trace_sample = tracing_sample_default()
    router = Router(
        metrics=registry,
        tracer=Tracer(
            enabled=tracing,
            on_spans=span_bridge(registry),
            sample=trace_sample,
        ),
    )
    # build-info labels can change exactly once per fact (backend resolves,
    # torch gets imported); zero out a superseded series so dashboards see
    # one live build_info row, then freeze once everything is resolved
    build_state = {"labels": None, "frozen": False}

    def refresh_build_info() -> None:
        if build_state["frozen"]:
            return
        labels = build_info_labels()
        prev = build_state["labels"]
        if prev is not None and prev != labels:
            registry.set_gauge("pio_build_info", 0.0, prev)
        registry.set_gauge(
            "pio_build_info", 1.0, labels,
            help="Build/runtime identity (value is always 1)",
        )
        build_state["labels"] = labels
        build_state["frozen"] = not (
            "not-imported" in labels.values()
            or labels.get("backend") == "uninitialized"
        )

    def handle_metrics(request: Request) -> Response:
        refresh_build_info()
        if before_scrape is not None:
            before_scrape(registry)
        snapshots = extra_snapshots() if extra_snapshots is not None else ()
        if snapshots:
            merged = MetricsRegistry()
            merged.merge_snapshot(registry.snapshot())
            for snap in snapshots:
                try:
                    merged.merge_snapshot(snap)
                except Exception:
                    # one worker's torn/garbled snapshot must not take the
                    # whole scrape down; its series are simply absent
                    continue
            body = merged.exposition()
        else:
            body = registry.exposition()
        # process-global series (training-snapshot cache etc.) ride every
        # service's scrape; names are disjoint from per-service ones
        shared = global_registry().exposition().strip()
        if shared:
            body = body.rstrip("\n") + "\n" + shared + "\n"
        return Response(200, body, content_type=CONTENT_TYPE)

    def handle_traces(request: Request) -> Response:
        q = request.query
        try:
            min_ms = float(q["min_ms"]) if "min_ms" in q else None
            limit = int(q.get("limit", 50))
        except ValueError:
            return Response(
                400, {"message": "min_ms must be a number, limit an integer"}
            )
        return Response(
            200, router.tracer.snapshot(op=q.get("op"), min_ms=min_ms, limit=limit)
        )

    router.add("GET", "/metrics", handle_metrics)
    router.add("GET", "/traces.json", handle_traces)
    return router, registry


_CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "GET, POST, DELETE, OPTIONS",
    "Access-Control-Allow-Headers": "Content-Type, Authorization",
}


# --------------------------------------------------------------------------
# lean HTTP/1.1 connection primitives (the multi-process frontend loop)
# --------------------------------------------------------------------------
#
# ``BaseHTTPRequestHandler`` costs ~1 ms of python per request (a handler
# object per REQUEST, header parsing through the email package, per-header
# send calls). The multi-process frontend workers instead run a
# single-threaded non-blocking loop over these primitives: ONE incremental
# parser buffer per connection, byte-exact Content-Length handling, and a
# single pre-serialized write per response.

MAX_REQUEST_LINE = 8192
MAX_HEADER_BYTES = 65536
MAX_HEADER_COUNT = 100
#: request bodies beyond this 413 at the frontend (queries are KBs; this
#: exists so a hostile stream cannot balloon the ring spill directory)
MAX_BODY_BYTES = 32 * 1024 * 1024

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 413: "Payload Too Large",
    414: "URI Too Long", 429: "Too Many Requests",
    431: "Request Header Fields Too Large",
    500: "Internal Server Error", 501: "Not Implemented",
    503: "Service Unavailable", 505: "HTTP Version Not Supported",
}


class HTTPParseError(Exception):
    """Malformed/unsupported inbound HTTP; carries the status to answer
    with before closing the connection."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


@dataclass
class ParsedRequest:
    """One wire-parsed request (pre-routing; the frontend's unit of work)."""

    method: str
    target: str               # raw request-target (path + query string)
    headers: dict[str, str]
    body: bytes
    keep_alive: bool


def _header(headers: dict[str, str], name: str) -> str | None:
    lname = name.lower()
    for k, v in headers.items():
        if k.lower() == lname:
            return v
    return None


class RequestParser:
    """Incremental HTTP/1.1 request parser for a non-blocking loop.

    ``feed()`` appends received bytes; ``next_request()`` returns one
    complete :class:`ParsedRequest` (pipelined requests come out one per
    call, in order), ``None`` while more bytes are needed, and raises
    :class:`HTTPParseError` on anything malformed -- the caller answers
    with its status and closes. A parsed header block is cached across
    calls, so a body arriving in many segments never re-parses headers.
    """

    __slots__ = ("_buf", "_head")

    def __init__(self):
        self._buf = bytearray()
        self._head: tuple | None = None  # (method, target, headers, length, keep)

    def feed(self, data: bytes) -> None:
        self._buf += data

    def buffered(self) -> int:
        return len(self._buf)

    def next_request(self) -> ParsedRequest | None:
        if self._head is None:
            end = self._buf.find(b"\r\n\r\n")
            if end < 0:
                if len(self._buf) > MAX_HEADER_BYTES:
                    raise HTTPParseError(431, "header block too large")
                return None
            self._head = self._parse_head(bytes(self._buf[:end]))
            del self._buf[:end + 4]
        method, target, headers, length, keep = self._head
        if len(self._buf) < length:
            return None
        body = bytes(self._buf[:length])
        del self._buf[:length]
        self._head = None
        return ParsedRequest(method, target, headers, body, keep)

    @staticmethod
    def _parse_head(block: bytes) -> tuple:
        lines = block.decode("latin-1").split("\r\n")
        parts = lines[0].split()
        if len(parts) != 3:
            raise HTTPParseError(400, "malformed request line")
        method, target, version = parts
        if len(lines[0]) > MAX_REQUEST_LINE:
            raise HTTPParseError(414, "request line too long")
        if version not in ("HTTP/1.1", "HTTP/1.0"):
            raise HTTPParseError(505, f"unsupported version {version}")
        if len(lines) - 1 > MAX_HEADER_COUNT:
            raise HTTPParseError(431, "too many headers")
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            key, sep, value = line.partition(":")
            if not sep or not key.strip():
                raise HTTPParseError(400, "malformed header line")
            headers[key.strip()] = value.strip()
        if _header(headers, "Transfer-Encoding") is not None:
            # same capability envelope as the single-process server (it
            # reads Content-Length only); 501 beats silent mis-framing
            raise HTTPParseError(501, "Transfer-Encoding not supported")
        raw_length = _header(headers, "Content-Length")
        try:
            length = int(raw_length) if raw_length else 0
        except ValueError:
            raise HTTPParseError(400, "bad Content-Length")
        if length < 0:
            raise HTTPParseError(400, "bad Content-Length")
        if length > MAX_BODY_BYTES:
            raise HTTPParseError(413, "request body too large")
        connection = (_header(headers, "Connection") or "").lower()
        if version == "HTTP/1.1":
            keep_alive = connection != "close"
        else:
            keep_alive = connection == "keep-alive"
        return method, target, headers, length, keep_alive


#: Date header cache: one strftime per wall-clock second, not per request
_date_cache: tuple[int, str] = (0, "")


def _http_date() -> str:
    global _date_cache
    now = int(time.time())
    if _date_cache[0] != now:
        _date_cache = (
            now,
            time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime(now)),
        )
    return _date_cache[1]


def build_http_response(
    status: int,
    payload: bytes,
    content_type: str = "application/json; charset=utf-8",
    headers: dict[str, str] | None = None,
    server_name: str = "pio",
    keep_alive: bool = True,
) -> bytes:
    """Serialize one response to a single buffer (headers + body), ready
    for one non-blocking send -- one segment + NODELAY, the same
    anti-Nagle contract as ``make_server``'s buffered wfile."""
    out = [
        f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}\r\n"
        f"Server: {server_name}\r\n"
        f"Date: {_http_date()}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(payload)}\r\n"
    ]
    for k, v in _CORS_HEADERS.items():
        out.append(f"{k}: {v}\r\n")
    for k, v in (headers or {}).items():
        out.append(f"{k}: {v}\r\n")
    # explicit in both directions: HTTP/1.0 keep-alive only works if the
    # server SAYS keep-alive (default is close), and the header is
    # harmless redundancy for HTTP/1.1 peers
    out.append(
        "Connection: keep-alive\r\n" if keep_alive
        else "Connection: close\r\n"
    )
    out.append("\r\n")
    return "".join(out).encode("latin-1") + payload


def make_server(
    router: Router,
    host: str,
    port: int,
    server_name: str,
    ssl_cert: str | None = None,
    ssl_key: str | None = None,
) -> ThreadingHTTPServer:
    """Build the threaded server; with ``ssl_cert``/``ssl_key`` it serves
    HTTPS (parity role of the reference query server's ``--key-store`` TLS,
    SURVEY.md section 2.3 #25)."""
    class _RequestHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = server_name
        # one TCP segment per response: buffered wfile (handle_one_request
        # flushes it) + NODELAY. Without these, headers and body go out as
        # separate small segments and Nagle + client delayed-ACK adds ~40ms
        # to EVERY keep-alive request -- the difference between a 1ms and a
        # 44ms p50 on /queries.json
        wbufsize = -1
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet by default; services log themselves
            pass

        def _handle(self):
            parsed = urlparse(self.path)
            query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            request = Request(
                method=self.command,
                path=parsed.path,
                query=query,
                headers={k: v for k, v in self.headers.items()},
                body=body,
                path_params={},
            )
            if self.command == "OPTIONS":
                response = Response(200, "")
            else:
                try:
                    response = router.dispatch(request)
                except json.JSONDecodeError:
                    response = Response(400, {"message": "malformed JSON body"})
                except Exception:
                    traceback.print_exc()
                    response = Response(500, {"message": "internal server error"})
            payload = response.payload()
            self.send_response(response.status)
            self.send_header("Content-Type", response.content_type)
            self.send_header("Content-Length", str(len(payload)))
            for k, v in _CORS_HEADERS.items():
                self.send_header(k, v)
            for k, v in response.headers.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(payload)

        do_GET = do_POST = do_DELETE = do_PUT = do_OPTIONS = _handle

    if ssl_key and not ssl_cert:
        raise ValueError("ssl_key given without ssl_cert; TLS not enabled")

    class _Server(ThreadingHTTPServer):
        # socketserver's default listen backlog is 5: a burst of N>5
        # simultaneous connects (every load balancer health-check +
        # client-pool refill looks like this) overflows it and the kernel
        # drops SYNs, surfacing as 1s/3s/7s retransmit spikes in p99
        request_queue_size = 128

    server = _Server((host, port), _RequestHandler)
    if ssl_cert:
        import ssl

        context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        context.load_cert_chain(certfile=ssl_cert, keyfile=ssl_key or None)
        # handshake on first read, NOT in accept(): with on-connect handshake
        # a stalled client would block the single accept loop and freeze the
        # whole server; deferred, it runs in the per-connection thread
        server.socket = context.wrap_socket(
            server.socket, server_side=True, do_handshake_on_connect=False
        )
    return server


class ServiceThread:
    """Run an HTTP server on a daemon thread (tests / embedded use).

    ``on_stop`` runs after the listener closes -- the hook services use to
    drain background pipelines (e.g. the event server's ingest writer).
    """

    def __init__(self, server: ThreadingHTTPServer, on_stop: Callable[[], None] | None = None):
        self.server = server
        self.on_stop = on_stop
        self._thread = threading.Thread(target=server.serve_forever, daemon=True)

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    def start(self) -> "ServiceThread":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self.on_stop is not None:
            self.on_stop()
