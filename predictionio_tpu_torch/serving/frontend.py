"""HTTP frontend worker: one ``SO_REUSEPORT`` accept/parse/validate loop.

Runs as its own process (``python -m predictionio_tpu_torch.serving.frontend``),
spawned and supervised by the scorer's
:class:`~predictionio_tpu_torch.serving.procserver.ScorerBridge`. The worker
binds its OWN listening socket with ``SO_REUSEPORT`` on the shared port
(the kernel load-balances new connections across workers) and runs a
SINGLE-THREADED non-blocking event loop: accept, parse (incremental
``utils.http.RequestParser`` -- one buffer per connection, byte-exact
Content-Length, correct keep-alive/close handling), validate, forward
through the shared-memory ring to the scorer, and write completed
responses back -- in per-connection order, so HTTP/1.1 pipelining can
never interleave answers.

One thread is a deliberate choice, not a simplification: a
thread-per-connection frontend pays two extra in-process wakeups per
request (request thread -> completion thread -> request thread), and on a
small box every wakeup is a scheduler hop that under load costs
milliseconds, not microseconds. Here the completion ring's wakeup fd sits
in the SAME epoll as the sockets, so one ``select`` wake services
everything the worker has to do.

The worker is deliberately dumb: no routing, no JSON, no engine, no jax
-- importing this module must stay light so a SIGKILLed worker's
replacement is accepting again in well under a second. Everything that
can change a response body lives in the scorer, which is what keeps
multi-process responses byte-identical to the single-process server.

Backpressure: a full request ring (the scorer is a whole ring behind)
answers ``429`` with ``Retry-After`` -- the same contract the ingest
pipeline's bounded queue presents (``docs/operations.md``).

Per-worker metrics land in a private ``MetricsRegistry`` published
through the ring's seqlock'd stats region (flushed at most every
``stats_flush_s`` under traffic, synchronously when this worker forwards
a ``/metrics`` scrape, and once at drain); the scorer merges every
worker's snapshot into the deployed server's aggregated ``/metrics``.

Port copy: ``predictionio_tpu/serving/frontend.py`` (framework-free), verbatim,
under the port's package name; ``tests/test_torch_imports.py`` holds it
to the original.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import selectors
import socket
import time
from collections import deque

from predictionio_tpu_torch.serving import shardmap, shmring
from predictionio_tpu_torch.utils.http import (
    HTTPParseError,
    RequestParser,
    build_http_response,
)
from predictionio_tpu_torch.utils.metrics import MetricsRegistry

logger = logging.getLogger("pio.frontend")

#: idle keep-alive connections are reaped after this
KEEPALIVE_TIMEOUT_S = 65.0
#: how long a forwarded request may wait for the scorer before the worker
#: answers 503 on its behalf (covers first-bucket jit compiles, same
#: allowance as the single-process batched path)
FORWARD_TIMEOUT_S = 35.0

#: histogram buckets for the ring round-trip (sub-ms through jit compiles)
_FORWARD_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0, 5.0,
    30.0,
)


def reuseport_listener(host: str, port: int, backlog: int = 128) -> socket.socket:
    """A listening socket in the port's ``SO_REUSEPORT`` group."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.bind((host, port))
        sock.listen(backlog)
        sock.setblocking(False)
    except BaseException:
        # a bind/listen failure (port stolen between reserve and spawn)
        # must not leak the descriptor into the worker's retry loop
        sock.close()
        raise
    return sock


class _Conn:
    """Per-connection state: parser buffer, ordered in-flight requests,
    pending output."""

    __slots__ = (
        "sock", "parser", "out", "order", "ready", "close_after",
        "last_pc", "want_write", "dead", "discard_input",
    )

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.parser = RequestParser()
        self.out = bytearray()
        #: request ids in arrival order -- responses flush in THIS order
        self.order: deque[int] = deque()
        #: request id -> serialized response waiting for its turn
        self.ready: dict[int, bytes] = {}
        self.close_after = False
        self.last_pc = time.perf_counter()
        self.want_write = False
        self.dead = False
        #: set after a parse error: the stream is desynced, so further
        #: bytes are drained and dropped while queued responses flush
        self.discard_input = False


class FrontendWorker:
    """The single-threaded per-process serving loop around one ring (or,
    under the sharded fabric, one ring PER scorer shard plus a control
    ring). With multiple rings the worker routes each ``POST
    /queries.json`` frame by the query's user id --
    ``shardmap.shard_of(user) % num_shards`` picks the owning shard's
    ring -- while every non-query frame (and stats publication) rides the
    LAST ring, which the fabric supervisor consumes. One ring is exactly
    the pre-shard tier: all traffic on ring 0."""

    def __init__(
        self,
        rings: "shmring.RingFile | list[shmring.RingFile]",
        listener: socket.socket,
        wake_reqs: "shmring.Wakeup | list[shmring.Wakeup]",
        wake_cmp: shmring.Wakeup,
        wake_stop: shmring.Wakeup,
        index: int,
        server_name: str = "pio-queryserver",
        stats_flush_s: float = 0.25,
        rid_base: int = 0,
    ):
        self.rings = (
            list(rings) if isinstance(rings, (list, tuple)) else [rings]
        )
        self._wake_reqs = (
            list(wake_reqs)
            if isinstance(wake_reqs, (list, tuple)) else [wake_reqs]
        )
        if len(self._wake_reqs) != len(self.rings):
            raise ValueError(
                f"{len(self.rings)} ring(s) need {len(self.rings)} request"
                f" wakeup(s), got {len(self._wake_reqs)}"
            )
        #: query rings = every ring but the control ring; with one ring
        #: the single ring plays both roles (the unsharded tier)
        self._num_shards = max(1, len(self.rings) - 1)
        self._listener = listener
        self._wake_cmp = wake_cmp
        self._wake_stop = wake_stop
        self.index = index
        self._label = str(index)
        self._server_name = server_name
        self._stats_flush_s = stats_flush_s
        self.registry = MetricsRegistry()
        self._sel = selectors.DefaultSelector()
        #: rid_base keeps request ids DISJOINT across respawn generations:
        #: the fabric reuses ring files over a respawn, so a completion
        #: addressed to the dead generation must never alias a live rid
        self._next_id = rid_base + 1
        #: request id -> (conn, recv_pc, deadline_pc, keep_alive)
        self._pending: dict[int, tuple] = {}
        self._draining = False
        self._stats_last = 0.0
        self._stats_dirty = False

    # -- main loop ----------------------------------------------------------
    def serve(self) -> None:
        self._sel.register(self._listener, selectors.EVENT_READ, "accept")
        self._sel.register(
            self._wake_cmp.fileno(), selectors.EVENT_READ, "completions"
        )
        self._sel.register(
            self._wake_stop.fileno(), selectors.EVENT_READ, "stop"
        )
        for ring in self.rings:
            ring.set_state(shmring.STATE_READY)
        next_sweep = time.perf_counter() + 1.0
        while True:
            for key, _mask in self._sel.select(timeout=0.5):
                data = key.data
                if data == "accept":
                    self._accept()
                elif data == "completions":
                    self._wake_cmp.drain()
                    self._pump_completions()
                elif data == "stop":
                    self._wake_stop.drain()
                    self._begin_drain()
                elif isinstance(data, _Conn):
                    self._service_conn(data)
            # opportunistic: completions that landed while we serviced
            # sockets get written without waiting for the next epoll wake
            self._pump_completions()
            now = time.perf_counter()
            if now >= next_sweep:
                next_sweep = now + 1.0
                self._sweep_timeouts(now)
            self._maybe_flush_stats()
            if self._draining and not self._pending and not any(
                isinstance(k.data, _Conn) and k.data.out
                for k in list(self._sel.get_map().values())
            ):
                break
        self._flush_stats(force=True)
        for ring in self.rings:
            ring.set_state(shmring.STATE_DONE)

    def _begin_drain(self) -> None:
        if self._draining:
            return
        self._draining = True
        for ring in self.rings:
            ring.set_state(shmring.STATE_DRAINING)
        try:
            self._sel.unregister(self._listener)
        except KeyError:
            pass
        self._listener.close()
        # connections with nothing in flight close now; in-flight ones
        # close right after their last response flushes
        for key in list(self._sel.get_map().values()):
            conn = key.data
            if not isinstance(conn, _Conn):
                continue
            conn.close_after = True
            if not conn.order and not conn.out:
                self._close_conn(conn)

    # -- socket events ------------------------------------------------------
    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock)
            self._sel.register(sock, selectors.EVENT_READ, conn)
            self._count("pio_frontend_connections_total")

    def _service_conn(self, conn: _Conn) -> None:
        if conn.dead:
            return
        if conn.want_write:
            self._flush_out(conn)
        try:
            data = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close_conn(conn)
            return
        if not data:
            # peer closed its write side; anything still in flight is
            # answered into the void, so just drop the connection unless
            # responses are mid-flush
            if not conn.order and not conn.out:
                self._close_conn(conn)
            else:
                conn.close_after = True
            return
        if conn.discard_input:
            return  # stream already desynced by a parse error; drop
        conn.last_pc = time.perf_counter()
        conn.parser.feed(data)
        while True:
            try:
                parsed = conn.parser.next_request()
            except HTTPParseError as exc:
                self._count(
                    "pio_frontend_http_errors_total",
                    {"kind": str(exc.status)},
                )
                # the buffer is mid-garbage: one error response for the
                # one bad request, then never parse this stream again (a
                # re-parse per arriving segment would enqueue duplicate
                # errors behind any still-pending pipelined answers)
                conn.discard_input = True
                try:
                    conn.sock.shutdown(socket.SHUT_RD)
                except OSError:
                    pass
                self._enqueue_local(
                    conn, exc.status, {"message": exc.message}, close=True
                )
                return
            if parsed is None:
                return
            self._handle_request(conn, parsed)
            if conn.dead or conn.close_after:
                return

    def _handle_request(self, conn: _Conn, parsed) -> None:
        if not parsed.keep_alive or self._draining:
            conn.close_after = True
        if parsed.method == "OPTIONS":
            # CORS preflight: answered at the edge, exactly as the
            # single-process server bypasses its router
            self._enqueue_local(conn, 200)
            return
        recv_pc = time.perf_counter()
        rid = self._alloc_id()
        path = parsed.target.split("?", 1)[0]
        if path == "/metrics":
            # the scrape that is about to aggregate worker snapshots must
            # see THIS worker's counters current up to this very request
            self._flush_stats(force=True)
        ring_idx = self._route_ring(parsed, path, rid)
        meta = {
            "i": rid,
            "m": parsed.method,
            "t": parsed.target,
            "h": parsed.headers,
            "p": recv_pc,
            "w": self._label,
        }
        try:
            self.rings[ring_idx].requests.push(meta, parsed.body)
        except shmring.RingFull:
            self._count("pio_frontend_ring_full_total")
            # backpressure parity with the ingest pipeline's bounded
            # queue: 429 + Retry-After, body shape identical
            conn.order.append(rid)
            self._enqueue_local(
                conn, 429, {"message": "serving queue full, retry later"},
                headers={"Retry-After": "1"}, rid=rid, count_status=True,
            )
            return
        conn.order.append(rid)
        self._pending[rid] = (
            conn, recv_pc, recv_pc + FORWARD_TIMEOUT_S,
            not conn.close_after,
        )
        self._wake_reqs[ring_idx].signal()

    def _route_ring(self, parsed, path: str, rid: int) -> int:
        """Pick the destination ring for one parsed request. Single-ring
        deploys (the pre-shard tier) send everything to ring 0. Under the
        sharded fabric, a query routes to its user's owning shard
        (``shardmap.shard_of``); a query with no extractable user is
        spread ``rid % num_shards`` (every shard answers user-less
        queries identically: the item-side state is replicated);
        everything else -- control routes, scrapes -- rides the LAST
        ring to the fabric supervisor."""
        if len(self.rings) == 1:
            return 0
        if parsed.method == "POST" and path == "/queries.json":
            user = shardmap.extract_user(parsed.body)
            if user is None:
                return rid % self._num_shards
            return shardmap.shard_of(user, self._num_shards)
        return len(self.rings) - 1

    def _enqueue_local(
        self,
        conn: _Conn,
        status: int,
        body: dict | None = None,
        headers: dict | None = None,
        close: bool = False,
        rid: int | None = None,
        count_status: bool = False,
    ) -> None:
        """Answer a request from the frontend itself (CORS preflight,
        ring-full 429, parse errors, scorer-timeout 503): one shared
        path allocates the slot (or reuses an already-ordered ``rid``),
        serializes, and flushes in connection order."""
        if rid is None:
            rid = self._alloc_id()
            conn.order.append(rid)
        if close:
            conn.close_after = True
        conn.ready[rid] = build_http_response(
            status,
            b"" if body is None else json.dumps(body).encode("utf-8"),
            headers=headers,
            server_name=self._server_name,
            keep_alive=not conn.close_after,
        )
        if count_status:
            self._count(
                "pio_frontend_requests_total",
                {"status": f"{status // 100}xx"},
            )
        self._flush_ready(conn)

    def _alloc_id(self) -> int:
        rid = self._next_id
        self._next_id += 1
        return rid

    # -- completion side ----------------------------------------------------
    def _pump_completions(self) -> None:
        for ring in self.rings:
            self._pump_ring(ring)

    def _pump_ring(self, ring: shmring.RingFile) -> None:
        while True:
            msg = ring.completions.pop()
            if msg is None:
                return
            meta, body = msg
            entry = self._pending.pop(meta["i"], None)
            if entry is None:
                continue  # already timed out locally
            conn, recv_pc, _deadline, keep = entry
            status = meta["s"]
            self.registry.observe(
                "pio_frontend_dispatch_seconds",
                time.perf_counter() - recv_pc,
                {"worker": self._label},
                buckets=_FORWARD_BUCKETS,
                help="Ring round-trip: request forwarded until response ready",
            )
            self._count(
                "pio_frontend_requests_total",
                {"status": f"{status // 100}xx"},
            )
            if conn.dead:
                continue
            conn.ready[meta["i"]] = build_http_response(
                status, body,
                content_type=meta.get("c") or "application/json",
                headers=meta.get("h") or {},
                server_name=self._server_name,
                keep_alive=keep and not conn.close_after,
            )
            self._flush_ready(conn)

    def _flush_ready(self, conn: _Conn) -> None:
        """Move completed responses into the output buffer IN ARRIVAL
        ORDER (a pipelined request that finished early waits for its
        predecessors), then write as much as the socket accepts."""
        while conn.order and conn.order[0] in conn.ready:
            conn.out += conn.ready.pop(conn.order.popleft())
        self._flush_out(conn)

    def _flush_out(self, conn: _Conn) -> None:
        if conn.dead:
            return
        while conn.out:
            try:
                sent = conn.sock.send(conn.out)
            except (BlockingIOError, InterruptedError):
                if not conn.want_write:
                    conn.want_write = True
                    self._sel.modify(
                        conn.sock,
                        selectors.EVENT_READ | selectors.EVENT_WRITE,
                        conn,
                    )
                return
            except OSError:
                self._close_conn(conn)
                return
            del conn.out[:sent]
        if conn.want_write:
            conn.want_write = False
            try:
                self._sel.modify(conn.sock, selectors.EVENT_READ, conn)
            except KeyError:
                pass
        if conn.close_after and not conn.order:
            self._close_conn(conn)

    def _close_conn(self, conn: _Conn) -> None:
        if conn.dead:
            return
        conn.dead = True
        # in-flight scorer answers for this connection go nowhere now
        for rid in conn.order:
            self._pending.pop(rid, None)
        conn.order.clear()
        conn.ready.clear()
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    # -- periodic sweeps ----------------------------------------------------
    def _sweep_timeouts(self, now: float) -> None:
        for rid, (conn, _recv, deadline, keep) in list(self._pending.items()):
            if now < deadline:
                continue
            self._pending.pop(rid, None)
            self._count("pio_frontend_scorer_timeouts_total")
            if conn.dead:
                continue
            self._enqueue_local(
                conn, 503, {"message": "scorer timed out"},
                close=True, rid=rid, count_status=True,
            )
        if self._draining:
            return
        for key in list(self._sel.get_map().values()):
            conn = key.data
            if not isinstance(conn, _Conn) or conn.dead:
                continue
            if not conn.order and now - conn.last_pc > KEEPALIVE_TIMEOUT_S:
                self._close_conn(conn)

    # -- metrics publication ------------------------------------------------
    def _count(self, name: str, labels: dict | None = None) -> None:
        all_labels = {"worker": self._label}
        if labels:
            all_labels.update(labels)
        self.registry.inc(name, all_labels, help=_HELP.get(name, ""))
        self._stats_dirty = True

    def _maybe_flush_stats(self) -> None:
        if not self._stats_dirty:
            return
        if time.monotonic() - self._stats_last < self._stats_flush_s:
            return
        self._flush_stats()

    def _flush_stats(self, force: bool = False) -> None:
        if not (self._stats_dirty or force):
            return
        self._stats_dirty = False
        self._stats_last = time.monotonic()
        # the control ring under the fabric (rings[-1] IS ring 0 on a
        # single-ring deploy): whoever supervises reads snapshots there
        self.rings[-1].write_stats(self.registry.snapshot())


_HELP = {
    "pio_frontend_connections_total": "TCP connections accepted by frontend workers",
    "pio_frontend_requests_total": "Requests forwarded through the ring, by status class",
    "pio_frontend_http_errors_total": "Requests answered at the frontend for protocol errors",
    "pio_frontend_ring_full_total": "Requests 429'd because the request ring was full",
    "pio_frontend_scorer_timeouts_total": "Requests 503'd because the scorer never answered",
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--ring", required=True, action="append",
        help="ring file path; repeat under the sharded fabric (one per"
        " scorer shard, control ring LAST)",
    )
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--worker", type=int, required=True)
    ap.add_argument(
        "--wake-req", required=True, action="append",
        help="request wakeup spec, one per --ring in the same order",
    )
    ap.add_argument("--wake-cmp", required=True)
    ap.add_argument("--wake-stop", required=True)
    ap.add_argument(
        "--rid-base", type=int, default=0,
        help="request-id offset (the fabric passes generation<<33 so"
        " respawns over reused rings never alias in-flight ids)",
    )
    ap.add_argument("--server-name", default="pio-queryserver")
    ap.add_argument("--stats-flush-s", type=float, default=0.25)
    ap.add_argument(
        "--pin-cpu", type=int, default=-1, metavar="CORE",
        help="sched_setaffinity this worker to one core (-1 = unpinned);"
        " set by the scorer bridge under pio deploy --pin-cpus",
    )
    args = ap.parse_args(argv)

    if args.pin_cpu >= 0 and hasattr(os, "sched_setaffinity"):
        try:
            os.sched_setaffinity(0, {args.pin_cpu})
        except OSError:
            logger.warning(
                "could not pin frontend worker %d to cpu %d",
                args.worker, args.pin_cpu,
            )
    rings = [shmring.RingFile.attach(path) for path in args.ring]
    listener = reuseport_listener(args.host, args.port)
    worker = FrontendWorker(
        rings,
        listener,
        [shmring.Wakeup.from_spec(spec) for spec in args.wake_req],
        shmring.Wakeup.from_spec(args.wake_cmp),
        shmring.Wakeup.from_spec(args.wake_stop),
        index=args.worker,
        server_name=args.server_name,
        stats_flush_s=args.stats_flush_s,
        rid_base=args.rid_base,
    )
    worker.serve()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
