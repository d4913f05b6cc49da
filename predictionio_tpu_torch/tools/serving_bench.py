"""Concurrent-load latency benchmark for a deployed Query Server.

The reference's serving SLO story is N stateless query servers behind a
load balancer (SURVEY.md section 5.3); the <5 ms p50 target (BASELINE)
is only meaningful under concurrent keep-alive load, not a single
sequential client. This tool drives ``POST /queries.json`` from N
threads, each with its own persistent HTTP connection, and reports the
latency distribution plus aggregate throughput:

    python -m predictionio_tpu_torch.tools.serving_bench \
        --url http://127.0.0.1:8000 --concurrency 8 --requests 400 \
        --query '{"user": "u1", "num": 4}'

Without ``--url`` it runs the **self-contained micro-batching A/B**: a
synthetic catalog is ingested into a throwaway store, the named engine(s)
are trained, and the same concurrent load is driven against two local
servers -- micro-batching disabled vs enabled -- reporting both QPS /
latency distributions and the speedup:

    python -m predictionio_tpu_torch.tools.serving_bench \
        --concurrency 32 --engine both [--device cpu]

Prints one JSON line; also importable (``run_load`` / ``run_ab``) for
tests and ``bench.py``.

Port of ``predictionio_tpu/tools/serving_bench.py``, the reference's code
under the port's package name. Every A/B trains and serves on
``device`` (``cuda`` unless "cpu"; no card and no "cpu" raises before
any work): training the synthetic deployment runs B1
(``ops/als_gram.py::gram_rhs``), and the servers of every arm, the
sharded fabric's shard processes included, score on that device. The
``ncf`` arm keeps ``usePallas: False``, as the reference does, so B3 stays
off. The load clients (``_load_in_subprocess``) are this module's
``--url`` mode in a child interpreter that imports no torch and sees no
card (``CUDA_VISIBLE_DEVICES`` empty): starting a CUDA context costs a
process seconds. The OpenBLAS cap and the ``sched_setaffinity`` plan act
on the host, as in the reference.
"""

from __future__ import annotations

import argparse
import http.client
import json
import threading
import time
import urllib.parse
from contextlib import contextmanager as _contextmanager


def _percentile(sorted_ms: list[float], q: float) -> float | None:
    if not sorted_ms:
        return None  # JSON null: NaN is not valid RFC 8259 output
    idx = min(int(q * len(sorted_ms)), len(sorted_ms) - 1)
    return round(sorted_ms[idx], 3)


def run_load(
    url: str,
    query: dict | str,
    clients: int = 8,
    requests: int = 400,
    timeout: float = 30.0,
    client: str = "http",
) -> dict:
    """N keep-alive clients, ``requests`` total POSTs; latency stats in ms.

    Every client thread owns one persistent connection (the reference
    SDKs' connection-pool behavior); failures are counted, not raised,
    so a mid-run hiccup yields a truthful report instead of a stack
    trace.

    ``client="raw"`` swaps ``http.client`` for a minimal raw-socket
    client (~5x less python per request). The load generator shares the
    benchmarked box's cores with the server: with the default client the
    GENERATOR saturates around ~600 qps on the 2-core box, so any server
    faster than that measures the client, not the server. The
    multi-process serving A/B uses raw for exactly this reason; the
    single-process batching/tracing A/Bs keep the historical client so
    their BASELINE.md numbers stay comparable.
    """
    parsed = urllib.parse.urlsplit(url)
    body = query if isinstance(query, str) else json.dumps(query)
    payload = body.encode()
    clients = min(clients, requests) or 1
    base, extra = divmod(requests, clients)
    # distribute the remainder so exactly ``requests`` POSTs are sent
    counts = [base + (1 if k < extra else 0) for k in range(clients)]
    lat_ms: list[list[float]] = [[] for _ in range(clients)]
    failures = [0] * clients
    start_gate = threading.Event()

    def http_client(k: int) -> None:
        conn_cls = (
            http.client.HTTPSConnection
            if parsed.scheme == "https"
            else http.client.HTTPConnection
        )
        conn = conn_cls(parsed.hostname, parsed.port, timeout=timeout)
        start_gate.wait()
        for _ in range(counts[k]):
            t0 = time.perf_counter()
            try:
                conn.request(
                    "POST", "/queries.json", payload,
                    {"Content-Type": "application/json"},
                )
                resp = conn.getresponse()
                resp.read()
                if resp.status != 200:
                    failures[k] += 1
                    continue
            except (OSError, http.client.HTTPException):
                # HTTPException covers malformed responses (a garbled LB
                # status line) -- a dead thread would under-report silently
                failures[k] += 1
                conn.close()
                continue
            lat_ms[k].append((time.perf_counter() - t0) * 1000.0)
        conn.close()

    request_bytes = (
        f"POST /queries.json HTTP/1.1\r\n"
        f"Host: {parsed.hostname}:{parsed.port}\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(payload)}\r\n\r\n"
    ).encode() + payload

    def raw_client(k: int) -> None:
        import socket

        def connect():
            s = socket.create_connection(
                (parsed.hostname, parsed.port), timeout=timeout
            )
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return s

        sock = connect()
        buf = b""
        start_gate.wait()
        for _ in range(counts[k]):
            t0 = time.perf_counter()
            try:
                sock.sendall(request_bytes)
                while b"\r\n\r\n" not in buf:
                    chunk = sock.recv(65536)
                    if not chunk:
                        raise OSError("server closed connection")
                    buf += chunk
                head, _, buf = buf.partition(b"\r\n\r\n")
                status = int(head.split(b" ", 2)[1])
                length = 0
                for line in head.split(b"\r\n")[1:]:
                    if line[:15].lower() == b"content-length:":
                        length = int(line[15:])
                        break
                while len(buf) < length:
                    chunk = sock.recv(65536)
                    if not chunk:
                        raise OSError("truncated response body")
                    buf += chunk
                buf = buf[length:]
                if status != 200:
                    failures[k] += 1
                    continue
            except (OSError, ValueError):
                failures[k] += 1
                try:
                    sock.close()
                except OSError:
                    pass
                buf = b""
                try:
                    sock = connect()
                except OSError:
                    failures[k] += counts[k] - len(lat_ms[k]) - failures[k]
                    return
                continue
            lat_ms[k].append((time.perf_counter() - t0) * 1000.0)
        sock.close()

    worker = raw_client if client == "raw" else http_client
    threads = [
        threading.Thread(target=worker, args=(k,), daemon=True)
        for k in range(clients)
    ]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    start_gate.set()
    for t in threads:
        t.join()
    wall_s = time.perf_counter() - t0

    flat = sorted(x for per in lat_ms for x in per)
    return {
        "clients": clients,
        "requests_ok": len(flat),
        "failures": sum(failures),
        "p50_ms": _percentile(flat, 0.50),
        "p90_ms": _percentile(flat, 0.90),
        "p99_ms": _percentile(flat, 0.99),
        "qps": round(len(flat) / wall_s, 1) if wall_s > 0 else 0.0,
    }


# --------------------------------------------------------------------------
# self-contained micro-batching A/B
# --------------------------------------------------------------------------

#: engines the A/B knows how to train on a synthetic rating stream; params
#: and catalog sizes target the regime micro-batching exists for (scoring
#: cost comparable to or above the per-request HTTP stack cost); training
#: quality is not the point -- few iterations/epochs, serving-shaped catalog
AB_ENGINES: dict[str, dict] = {
    "recommendation": {
        "factory": "predictionio_tpu_torch.models.recommendation.engine.engine_factory",
        "algorithms": [
            {
                "name": "als",
                "params": {
                    "rank": 64,
                    "numIterations": 2,
                    "checkpointInterval": 0,
                },
            }
        ],
        # per-query serving cost is one [items, rank] gemv (a full factor-
        # matrix scan); the batched arm amortizes that scan across the batch
        "defaults": {"users": 500, "items": 100_000, "events": 150_000},
    },
    "ncf": {
        "factory": "predictionio_tpu_torch.models.ncf.engine.engine_factory",
        "algorithms": [
            {
                "name": "ncf",
                "params": {
                    "embedDim": 16,
                    "hidden": [32, 16],
                    "epochs": 1,
                    "usePallas": False,
                    "checkpoint": False,
                },
            }
        ],
        # NCF scores ALL items per query, so compute does not amortize with
        # batch size on CPU (it does on an accelerator, where the batch is
        # one device program); the CPU win is dispatch amortization, which
        # dominates at small catalogs and inverts past ~8k items
        "defaults": {"users": 500, "items": 4_000, "events": 30_000},
    },
}


def _responses_equivalent(a: bytes, b: bytes, rtol: float = 1e-5) -> bool:
    """Same ranking, scores equal up to float accumulation order.

    The ALS templates score a single query with a gemv and a batch with a
    multi-row gemm; BLAS accumulates those in different orders, so scores
    can drift at the ulp level (the same accepted semantic as
    ``batch_predict`` vs ``predict`` -- see test_ncf's batch contract).
    Item identity and order must still match exactly.
    """
    if a == b:
        return True
    try:
        ja, jb = json.loads(a), json.loads(b)
    except ValueError:
        return False
    sa, sb = ja.get("itemScores"), jb.get("itemScores")
    if not isinstance(sa, list) or not isinstance(sb, list):
        return ja == jb
    if [x.get("item") for x in sa] != [x.get("item") for x in sb]:
        return False
    import math

    return all(
        math.isclose(x["score"], y["score"], rel_tol=rtol, abs_tol=1e-8)
        for x, y in zip(sa, sb)
    )


def _ingest_synthetic(app_name: str, users: int, items: int, events: int):
    """Synthetic rating stream: zipf-ish item popularity, every item
    guaranteed at least one event (the vocab must span the catalog)."""
    import numpy as np

    from predictionio_tpu_torch.data import DataMap, Event, storage
    from predictionio_tpu_torch.data.storage.base import App

    apps = storage.get_meta_data_apps()
    app_id = apps.insert(App(name=app_name))
    le = storage.get_l_events()
    le.init_channel(app_id)
    rng = np.random.default_rng(7)
    events = max(events, items)  # coverage needs one event per item
    uu = rng.integers(0, users, size=events)
    ii = (np.minimum(rng.random(events) ** 2.0, 0.999999) * items).astype(int)
    ii[:items] = np.arange(items)  # full catalog coverage
    rr = rng.integers(1, 6, size=events)
    le.batch_insert(
        [
            Event(
                event="rate",
                entity_type="user",
                entity_id=f"u{int(u)}",
                target_entity_type="item",
                target_entity_id=f"i{int(i)}",
                properties=DataMap({"rating": float(r)}),
            )
            for u, i, r in zip(uu, ii, rr)
        ],
        app_id=app_id,
    )


@_contextmanager
def _synthetic_deployment(engine: str, users, items, events, device=None):
    """A throwaway store with ``engine`` trained on ``device`` on a
    synthetic catalog; yields ``(variant, sizes)``. Shared by every
    serving A/B harness."""
    import os
    import shutil
    import tempfile

    from predictionio_tpu_torch.data import storage
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    if engine not in AB_ENGINES:
        raise ValueError(
            f"unknown A/B engine {engine!r}; choose from {sorted(AB_ENGINES)}"
        )
    spec = AB_ENGINES[engine]
    users = users if users is not None else spec["defaults"]["users"]
    items = items if items is not None else spec["defaults"]["items"]
    events = events if events is not None else spec["defaults"]["events"]
    prev_basedir = os.environ.get("PIO_FS_BASEDIR")
    tmp = tempfile.mkdtemp(prefix="pio_serving_ab_")
    os.environ["PIO_FS_BASEDIR"] = tmp
    storage.reset()
    try:
        app_name = f"ServingAB-{engine}"
        _ingest_synthetic(app_name, users, items, events)
        variant_path = os.path.join(tmp, "engine.json")
        with open(variant_path, "w") as f:
            json.dump(
                {
                    "id": f"serving-ab-{engine}",
                    "engineFactory": spec["factory"],
                    "datasource": {"params": {"appName": app_name}},
                    "algorithms": spec["algorithms"],
                },
                f,
            )
        variant = load_engine_variant(variant_path)
        run_train(variant, device=device)
        yield variant, {"users": users, "items": items, "events": events}
    finally:
        if prev_basedir is None:
            os.environ.pop("PIO_FS_BASEDIR", None)
        else:
            os.environ["PIO_FS_BASEDIR"] = prev_basedir
        storage.reset()
        shutil.rmtree(tmp, ignore_errors=True)


def _load_in_subprocess(
    url: str, concurrency: int, n_requests: int, query: dict,
    client: str = "http",
    affinity: "set | None" = None,
) -> dict:
    """Drive ``run_load`` from a child interpreter: a co-resident client
    pool would fight the server threads for the GIL and understate every
    arm. ``affinity`` (the PRE-pin cpu mask, captured before any
    ``--pin-cpus`` arm narrowed this process) is re-applied in the
    child: without it the generator inherits the pinned scorer's
    shrunken mask and the bench measures the generator, not the
    server -- worst at high worker counts, inverting the sweep."""
    import os
    import subprocess
    import sys

    # the load client is host code: no torch import, and no card to touch
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    # the child interpreter must find this package without an install
    pkg_parent = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
    if affinity is not None:
        # applied by the child's main() after exec -- a preexec_fn would
        # force a bare fork() inside this (torch-)threaded process
        env["PIO_BENCH_AFFINITY"] = ",".join(str(c) for c in sorted(affinity))
    proc = subprocess.run(
        [
            sys.executable, "-m",
            "predictionio_tpu_torch.tools.serving_bench",
            "--url", url,
            "--concurrency", str(concurrency),
            "--requests", str(n_requests),
            "--query", json.dumps(query),
            "--client", client,
        ],
        capture_output=True, text=True, timeout=600,
        env=env,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"load subprocess failed: {proc.stderr[-500:]}"
        )
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _concurrent_bodies(url: str, concurrency: int, users: int) -> list[bytes]:
    """One distinct-user query per client thread, fired together: on a
    batching arm these COALESCE, so comparing the bodies across arms
    checks batched result scattering (a per-slot misalignment would swap
    users' answers), not just the single-query path."""
    import urllib.request

    probes = [
        {"user": f"u{k % users}", "num": 10} for k in range(concurrency)
    ]
    bodies: list = [None] * len(probes)

    def worker(k: int) -> None:
        try:
            req = urllib.request.Request(
                f"{url}/queries.json",
                data=json.dumps(probes[k]).encode(),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urllib.request.urlopen(req, timeout=30) as resp:
                bodies[k] = resp.read()
        except Exception as exc:  # surfaced below, never swallowed
            bodies[k] = exc

    threads = [
        threading.Thread(target=worker, args=(k,))
        for k in range(len(probes))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    failed = [b for b in bodies if not isinstance(b, bytes)]
    if failed:
        # an unanswered probe must abort loudly, not compare
        # None==None as "identical"
        raise RuntimeError(
            f"{len(failed)} identity probe(s) failed against {url}: "
            f"{failed[0]!r}"
        )
    return bodies


def _sequential_bodies(url: str, users: int, n: int = 8) -> list[bytes]:
    """One query at a time (batch size 1 everywhere): across arms these
    must be BYTE-identical -- no gemv-vs-gemm accumulation drift excuse,
    because every arm scores the identical batch shape."""
    import urllib.request

    bodies = []
    for k in range(n):
        req = urllib.request.Request(
            f"{url}/queries.json",
            data=json.dumps({"user": f"u{k % users}", "num": 10}).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            bodies.append(resp.read())
    return bodies


def _measure_arms(
    variant,
    arms: dict[str, dict],
    concurrency: int,
    requests: int,
    query: dict,
    users: int,
    warmup: int,
    client: str = "http",
    device=None,
) -> tuple[dict, dict]:
    """Serve ``variant`` once per arm (``arms`` maps label ->
    ``create_query_server`` kwargs; a ``frontend_workers`` key routes the
    arm through the multi-process tier instead) and drive the identical
    concurrent load at each; returns (label -> run_load report, label ->
    identity probe bodies).

    Servers run in-process on ephemeral ports, scoring on ``device``; the
    load clients run in a subprocess. Each arm gets a warm-up pass first
    (each batch bucket's first launches must not land in the measured
    window) plus a coalescing identity probe.
    """
    import os as _os

    from predictionio_tpu_torch.workflow.create_server import (
        create_multiproc_query_server,
        create_query_server,
        create_sharded_query_server,
    )

    # captured BEFORE any pinned arm narrows this process's mask: the
    # load-generator children are re-widened to it (see
    # _load_in_subprocess)
    baseline_affinity = (
        _os.sched_getaffinity(0)
        if hasattr(_os, "sched_getaffinity") else None
    )

    def load_in_subprocess(url: str, n_requests: int) -> dict:
        return _load_in_subprocess(
            url, concurrency, n_requests, query, client=client,
            affinity=baseline_affinity,
        )

    def concurrent_bodies(url: str) -> list[bytes]:
        return _concurrent_bodies(url, concurrency, users)

    reports: dict[str, dict] = {}
    responses: dict[str, list[bytes]] = {}
    sequential: dict[str, list[bytes]] = {}
    for label, server_kwargs in arms.items():
        server_kwargs = dict(server_kwargs)
        workers = server_kwargs.pop("frontend_workers", 0)
        shards = server_kwargs.pop("scorer_shards", 0)
        if shards:
            # the sharded fabric owns its scorer subprocesses end to end;
            # there is no in-process service handle to close
            handle = create_sharded_query_server(
                variant, host="127.0.0.1", port=0, scorer_shards=shards,
                frontend=workers or None, device=device, **server_kwargs,
            )
            service = None
        elif workers:
            handle, service = create_multiproc_query_server(
                variant, host="127.0.0.1", port=0, frontend=workers,
                device=device, **server_kwargs,
            )
        else:
            handle, service = create_query_server(
                variant, host="127.0.0.1", port=0, device=device,
                **server_kwargs
            )
        handle.start()
        url = f"http://127.0.0.1:{handle.port}"
        try:
            # warm-up: compile every batch bucket outside the clock
            load_in_subprocess(url, warmup)
            # identity probes (outside the clock): sequential = byte
            # identity at batch size 1, concurrent = scatter check under
            # coalescing (documented ulp drift across batch shapes)
            sequential[label] = _sequential_bodies(url, users)
            responses[label] = concurrent_bodies(url)
            reports[label] = load_in_subprocess(url, requests)
            if service is not None and service.scorer_stats is not None:
                # the measured wakeup budget: the async arm must show
                # <=2 wakeups/request and zero query-path dispatcher
                # threads. Read from the served /metrics gauges -- the
                # bench records the exact number operators see, with ONE
                # definition of the formula (the service's mirror hook)
                gauges = _scorer_gauges(url)
                reports[label]["wakeups_per_request"] = gauges.get(
                    "pio_scorer_wakeups_per_request"
                )
                threads = gauges.get("pio_scorer_dispatch_threads")
                reports[label]["dispatch_threads"] = (
                    int(threads) if threads is not None else None
                )
        finally:
            handle.stop()
            if service is not None:
                service.close()
    return reports, responses, sequential


def _scorer_gauges(url: str) -> dict[str, float]:
    """The scorer's wakeup-budget gauges from its live /metrics."""
    import urllib.request

    try:
        with urllib.request.urlopen(f"{url}/metrics", timeout=10) as resp:
            text = resp.read().decode("utf-8", "replace")
    except Exception:
        return {}
    out: dict[str, float] = {}
    for line in text.splitlines():
        for name in (
            "pio_scorer_wakeups_per_request", "pio_scorer_dispatch_threads"
        ):
            if line.startswith(name + " "):
                try:
                    out[name] = float(line.rsplit(" ", 1)[1])
                except ValueError:
                    pass
    return out


def run_ab(
    engine: str = "recommendation",
    concurrency: int = 32,
    requests: int = 960,
    users: int | None = None,
    items: int | None = None,
    events: int | None = None,
    window_ms: float = 5.0,
    max_batch_size: int = 64,
    device=None,
) -> dict:
    """Train ``engine`` on a synthetic catalog in a throwaway store, then
    measure the same concurrent load with micro-batching off vs on.
    Returns both ``run_load`` reports plus ``qps_speedup``. Responses are
    identical across arms by construction (same model, same query), which
    the identity probe spot-checks under coalescing load."""
    from predictionio_tpu_torch.utils.device import resolve_device
    from predictionio_tpu_torch.workflow.microbatch import BatchConfig

    device = resolve_device(device)
    with _synthetic_deployment(
        engine, users, items, events, device
    ) as (variant, sizes):
        arms = {
            "batching_off": {"batching": BatchConfig(window_ms=0.0)},
            "batching_on": {
                "batching": BatchConfig(
                    window_ms=window_ms, max_batch_size=max_batch_size
                )
            },
        }
        reports, responses, _sequential = _measure_arms(
            variant, arms, concurrency, requests,
            {"user": "u1", "num": 10}, sizes["users"],
            warmup=max(4 * max_batch_size, concurrency), device=device,
        )
    out: dict = {
        "engine": engine,
        "concurrency": concurrency,
        "requests": requests,
        **sizes,
        "window_ms": window_ms,
        "max_batch_size": max_batch_size,
        **reports,
    }
    out["responses_identical"] = (
        responses["batching_off"] == responses["batching_on"]
    )
    out["responses_equivalent"] = all(
        _responses_equivalent(a, b)
        for a, b in zip(responses["batching_off"], responses["batching_on"])
    )
    off, on = out["batching_off"]["qps"], out["batching_on"]["qps"]
    out["qps_speedup"] = round(on / off, 2) if off else None
    return out


def _set_blas_threads(n: int) -> "int | None":
    """Best-effort runtime OpenBLAS thread cap; returns the previous
    value (to restore) or None when no OpenBLAS is loaded.

    Why the serving A/B caps BLAS at 1: OpenBLAS worker threads
    BUSY-SPIN between gemms, and on the 2-core box that spin (from the
    scorer's per-batch factor-matrix gemm) stole whole scheduler quanta
    from the frontend worker processes -- measured as a 3-8x qps
    collapse of the process tier with multi-second completion-ring
    backups. Capped to 1 the gemm runs on the dispatching thread and
    every process gets scheduled. Applied identically to every arm.
    """
    import ctypes
    import re

    try:
        with open("/proc/self/maps") as f:
            paths = sorted({
                m.group(1)
                for line in f
                if (m := re.search(r"(/\S*openblas\S*\.so\S*)", line))
            })
        for path in paths:
            lib = ctypes.CDLL(path)
            for suffix in ("64_", "64", "_", ""):
                get = getattr(lib, f"openblas_get_num_threads{suffix}", None)
                set_ = getattr(lib, f"openblas_set_num_threads{suffix}", None)
                if get is not None and set_ is not None:
                    prev = int(get())
                    set_(int(n))
                    return prev
    except Exception:
        pass
    return None


def run_multiproc_ab(
    engine: str = "recommendation",
    concurrency: int = 32,
    requests: int = 2000,
    workers: tuple = (1, 2),
    users: int | None = None,
    items: int | None = None,
    events: int | None = None,
    window_ms: float = 2.0,
    max_batch_size: int = 64,
    max_inflight: int | None = None,
    dispatch: "str | tuple" = "async",
    pin_cpus: bool = False,
    device=None,
) -> dict:
    """The multi-process serving A/B: the single-process
    ``ThreadingHTTPServer`` tier vs N ``SO_REUSEPORT`` frontend workers
    feeding the shared-memory ring, identical micro-batched scorer and
    identical concurrent load (raw-socket clients -- the stock
    ``http.client`` generator saturates around ~600 qps on the 2-core
    box, below the process tier's ceiling, so it would measure itself).
    Reports per-arm ``run_load`` stats, per-worker-count speedups, and
    the coalescing identity probe (bodies must be byte-identical across
    every arm: all of them are produced by the same scorer router).

    ``dispatch`` picks the scorer dispatch model per process-tier arm:
    ``"async"`` (ring consumer -> micro-batcher future -> flusher
    callback; zero dispatcher threads), ``"sync"`` (the dispatcher-pool
    tier), or a tuple of both for the sync-vs-async A/B -- arms are then
    labeled ``workers_N_sync`` / ``workers_N_async`` and the report adds
    ``qps_async_over_sync_workers_N``. ``pin_cpus`` turns on the
    ``sched_setaffinity`` plan (frontends one core each off the top,
    scorer keeps the rest) for every process-tier arm; combine with a
    ``workers`` sweep like ``(1, 2, 4, 8)`` on real multi-core hardware.
    """
    from predictionio_tpu_torch.serving.procserver import FrontendConfig
    from predictionio_tpu_torch.utils.device import resolve_device
    from predictionio_tpu_torch.workflow.microbatch import BatchConfig

    device = resolve_device(device)
    modes = (dispatch,) if isinstance(dispatch, str) else tuple(dispatch)
    batching = BatchConfig(window_ms=window_ms, max_batch_size=max_batch_size)
    arms: dict[str, dict] = {"singleproc": {"batching": batching}}
    for n in sorted(set(int(w) for w in workers if int(w) > 0)):
        for mode in modes:
            fe = FrontendConfig(workers=n, dispatch=mode, pin_cpus=pin_cpus)
            if max_inflight is not None:
                fe.max_inflight = max_inflight
            label = (
                f"workers_{n}" if len(modes) == 1 else f"workers_{n}_{mode}"
            )
            arms[label] = {
                "batching": batching, "frontend_workers": fe,
            }
    prev_blas = _set_blas_threads(1)
    try:
        with _synthetic_deployment(
            engine, users, items, events, device
        ) as (variant, sizes):
            reports, responses, sequential = _measure_arms(
                variant, arms, concurrency, requests,
                {"user": "u1", "num": 10}, sizes["users"],
                warmup=max(4 * max_batch_size, concurrency, 256),
                client="raw", device=device,
            )
    finally:
        if prev_blas is not None:
            _set_blas_threads(prev_blas)
    out: dict = {
        "engine": engine,
        "concurrency": concurrency,
        "requests": requests,
        **sizes,
        "window_ms": window_ms,
        "max_batch_size": max_batch_size,
        **reports,
    }
    # batch-size-1 probes: byte identity is REQUIRED across arms (every
    # arm's body is produced by the same scorer code over the same shape)
    seq_base = sequential["singleproc"]
    out["responses_identical"] = all(
        sequential[label] == seq_base for label in arms
    )
    # coalescing probes: scatter correctness; across arms batch
    # composition is timing-dependent, so scores may carry the
    # documented ulp-level gemv-vs-gemm accumulation drift
    base = responses["singleproc"]
    out["responses_equivalent"] = all(
        _responses_equivalent(a, b)
        for label in arms
        for a, b in zip(base, responses[label])
    ) and all(
        _responses_equivalent(a, b)
        for label in arms
        for a, b in zip(seq_base, sequential[label])
    )
    sp = reports["singleproc"]["qps"]
    for label in arms:
        if label == "singleproc" or not sp:
            continue
        out[f"qps_speedup_{label}"] = round(reports[label]["qps"] / sp, 2)
    if len(modes) > 1:
        # the dispatch-model A/B: async over sync at identical worker count
        for n in sorted(set(int(w) for w in workers if int(w) > 0)):
            sync_qps = reports.get(f"workers_{n}_sync", {}).get("qps")
            async_qps = reports.get(f"workers_{n}_async", {}).get("qps")
            if sync_qps and async_qps:
                out[f"qps_async_over_sync_workers_{n}"] = round(
                    async_qps / sync_qps, 2
                )
    best = max(
        (reports[label]["qps"] for label in arms if label != "singleproc"),
        default=0.0,
    )
    out["qps_speedup"] = round(best / sp, 2) if sp else None
    out["dispatch"] = list(modes)
    out["pin_cpus"] = pin_cpus
    return out


def run_sharded_ab(
    engine: str = "recommendation",
    concurrency: int = 32,
    requests: int = 2000,
    shards: tuple = (1, 2, 4),
    users: int | None = None,
    items: int | None = None,
    events: int | None = None,
    window_ms: float = 2.0,
    max_batch_size: int = 64,
    frontend_workers: int = 1,
    device=None,
) -> dict:
    """The sharded serving sweep: one arm per scorer shard count. Shard
    count 1 is the single-process ``ThreadingHTTPServer`` tier (the
    fabric's floor is 2 -- one shard IS the unsharded server); each
    n >= 2 arm is a full fabric: ``frontend_workers`` SO_REUSEPORT
    frontends routing ``hash(user) % n`` over n scorer shard processes,
    each holding one partition of the user factor table with the item
    side replicated. Identical raw-socket load at every arm.

    Batch-size-1 probe bodies must be BYTE-identical across every arm:
    a shard scores its partition's users with the same code over the
    same shapes as the unsharded scorer (partitioning selects rows, it
    never changes arithmetic), so any divergence is a routing or
    scatter bug, not drift. Coalescing probes use the equivalence check
    (batch composition is timing-dependent per arm, same as the
    multi-process A/B).

    OpenBLAS is capped at 1 thread in this process (parent-side arms)
    AND via ``OPENBLAS_NUM_THREADS`` for the shard children -- the
    shard processes each load their own BLAS, and n spinning pools on a
    small box would measure scheduler thrash, not sharding.
    """
    import os

    from predictionio_tpu_torch.serving.procserver import FrontendConfig
    from predictionio_tpu_torch.utils.device import resolve_device
    from predictionio_tpu_torch.workflow.microbatch import BatchConfig

    device = resolve_device(device)
    batching = BatchConfig(window_ms=window_ms, max_batch_size=max_batch_size)
    counts = sorted(set(int(n) for n in shards if int(n) > 0))
    arms: dict[str, dict] = {}
    for n in counts:
        if n == 1:
            arms["shards_1"] = {"batching": batching}
        else:
            arms[f"shards_{n}"] = {
                "batching": batching,
                "scorer_shards": n,
                "frontend_workers": FrontendConfig(
                    workers=frontend_workers, spawn_timeout_s=180.0
                ),
            }
    if "shards_1" not in arms:
        # the sweep is meaningless without the unsharded baseline
        arms = {"shards_1": {"batching": batching}, **arms}
        counts = [1] + counts
    prev_blas = _set_blas_threads(1)
    prev_env = os.environ.get("OPENBLAS_NUM_THREADS")
    os.environ["OPENBLAS_NUM_THREADS"] = "1"
    try:
        with _synthetic_deployment(
            engine, users, items, events, device
        ) as (variant, sizes):
            reports, responses, sequential = _measure_arms(
                variant, arms, concurrency, requests,
                {"user": "u1", "num": 10}, sizes["users"],
                warmup=max(4 * max_batch_size, concurrency, 256),
                client="raw", device=device,
            )
    finally:
        if prev_env is None:
            os.environ.pop("OPENBLAS_NUM_THREADS", None)
        else:
            os.environ["OPENBLAS_NUM_THREADS"] = prev_env
        if prev_blas is not None:
            _set_blas_threads(prev_blas)
    out: dict = {
        "engine": engine,
        "concurrency": concurrency,
        "requests": requests,
        **sizes,
        "window_ms": window_ms,
        "max_batch_size": max_batch_size,
        "frontend_workers": frontend_workers,
        "shards": counts,
        **reports,
    }
    seq_base = sequential["shards_1"]
    out["responses_identical"] = all(
        sequential[label] == seq_base for label in arms
    )
    base = responses["shards_1"]
    out["responses_equivalent"] = all(
        _responses_equivalent(a, b)
        for label in arms
        for a, b in zip(base, responses[label])
    ) and all(
        _responses_equivalent(a, b)
        for label in arms
        for a, b in zip(seq_base, sequential[label])
    )
    sp = reports["shards_1"]["qps"]
    for label in arms:
        if label == "shards_1" or not sp:
            continue
        out[f"qps_speedup_{label}"] = round(reports[label]["qps"] / sp, 2)
    best = max(
        (reports[label]["qps"] for label in arms if label != "shards_1"),
        default=0.0,
    )
    out["qps_speedup"] = round(best / sp, 2) if sp and best else None
    return out


def run_trace_ab(
    engine: str = "recommendation",
    concurrency: int = 32,
    requests: int = 960,
    users: int | None = None,
    items: int | None = None,
    events: int | None = None,
    window_ms: float = 5.0,
    max_batch_size: int = 64,
    rounds: int = 3,
    device=None,
) -> dict:
    """The tracing-overhead A/B: identical micro-batched serving with the
    span tracer disabled vs enabled in its PRODUCTION DEFAULT config —
    headerless roots head-sampled at ``PIO_TRACE_SAMPLE`` (1-in-8), the
    load clients sending no ``traceparent`` (a real internet-facing
    workload's shape) — same concurrent load. ``overhead_pct`` is the qps
    cost of tracing; the acceptance bar is < 2% at 32 clients (bench
    secondary ``trace_overhead_pct``). Full always-on tracing
    (``--trace-sample 1``) measures ~10% on the 2-core box — that is the
    number sampling exists to amortize.

    Methodology: the box's throughput DRIFTS upward across sequential
    measurements (in the reference the in-process jax compile cache and
    CPython warm up across server instances -- measured ~20%+ from first
    arm to last, 10x the effect under test; in the port the CUDA context,
    the kernels' first build and load and the allocator's pools warm up
    the same way), so a single off-then-on pass attributes
    the drift to whichever arm ran first. Both servers are therefore
    kept alive side by side, warmed identically, and measured in
    ``rounds`` interleaved pairs whose within-round order alternates;
    ``overhead_pct`` is the median of the per-round ratios, which
    cancels any drift slower than one round.

    Tracing may only add headers, never bodies. Bodies across arms are
    compared with the batching A/B's equivalence check rather than
    bytewise: batch-bucket composition is timing-dependent, and bucket
    size reaches the scores as the documented ulp-level gemv-vs-gemm
    accumulation drift (``responses_identical`` would flap on scheduling
    noise even with tracing compiled out entirely).
    """
    from predictionio_tpu_torch.utils.device import resolve_device
    from predictionio_tpu_torch.workflow.create_server import create_query_server
    from predictionio_tpu_torch.workflow.microbatch import BatchConfig

    device = resolve_device(device)
    query = {"user": "u1", "num": 10}
    batching = BatchConfig(window_ms=window_ms, max_batch_size=max_batch_size)
    arms = {"tracing_off": False, "tracing_on": True}
    warmup = max(4 * max_batch_size, concurrency)
    qps: dict[str, list[float]] = {label: [] for label in arms}
    reports: dict[str, dict] = {}
    responses: dict[str, list[bytes]] = {}

    with _synthetic_deployment(
        engine, users, items, events, device
    ) as (variant, sizes):
        servers = {}
        try:
            for label, tracing in arms.items():
                thread, service = create_query_server(
                    variant, host="127.0.0.1", port=0,
                    batching=batching, tracing=tracing, device=device,
                )
                thread.start()
                servers[label] = (
                    thread, service, f"http://127.0.0.1:{thread.port}"
                )
            for label, (_, _, url) in servers.items():
                _load_in_subprocess(url, concurrency, warmup, query)
                responses[label] = _concurrent_bodies(
                    url, concurrency, sizes["users"]
                )
            # one unmeasured priming pair at full load: the first measured
            # pass after warmup consistently spikes (allocator/scheduler
            # settling), and a transient in either arm lands straight in
            # the round-0 ratio
            for label in arms:
                _load_in_subprocess(
                    servers[label][2], concurrency, requests, query
                )
            for r in range(rounds):
                order = list(arms)
                if r % 2:
                    order.reverse()
                for label in order:
                    rep = _load_in_subprocess(
                        servers[label][2], concurrency, requests, query
                    )
                    qps[label].append(rep["qps"])
                    reports[label] = rep  # last round's latency profile
        finally:
            for thread, service, _ in servers.values():
                thread.stop()
                service.close()

    for label in arms:
        reports[label]["qps_rounds"] = qps[label]
        reports[label]["qps"] = sorted(qps[label])[len(qps[label]) // 2]
    out: dict = {
        "engine": engine,
        "concurrency": concurrency,
        "requests": requests,
        "rounds": rounds,
        **sizes,
        **reports,
    }
    out["responses_identical"] = (
        responses["tracing_off"] == responses["tracing_on"]
    )
    out["responses_equivalent"] = all(
        _responses_equivalent(a, b)
        for a, b in zip(responses["tracing_off"], responses["tracing_on"])
    )
    per_round = [
        round((off - on) / off * 100.0, 2)
        for off, on in zip(qps["tracing_off"], qps["tracing_on"])
        if off
    ]
    out["overhead_pct_rounds"] = per_round
    out["overhead_pct"] = (
        sorted(per_round)[len(per_round) // 2] if per_round else None
    )
    return out


def main(argv: list[str] | None = None) -> int:
    import os

    mask = os.environ.get("PIO_BENCH_AFFINITY")
    if mask and hasattr(os, "sched_setaffinity"):
        # the load-generator child of a --pin-cpus A/B: re-widen to the
        # pre-pin mask the parent recorded, so the generator never
        # measures itself time-slicing the pinned scorer's cores
        try:
            os.sched_setaffinity(0, {int(c) for c in mask.split(",")})
        except (OSError, ValueError):
            pass
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--url", default=None,
        help="target server; omit to run the self-contained batching A/B",
    )
    ap.add_argument(
        "--clients", "--concurrency", dest="clients", type=int, default=None,
        help="concurrent keep-alive clients (default: 8 load / 32 A/B)",
    )
    ap.add_argument("--requests", type=int, default=None,
                    help="total POSTs (default: 400 load / 960 A/B)")
    ap.add_argument("--query", default='{"user": "u1", "num": 4}')
    ap.add_argument(
        "--engine", default="both",
        choices=tuple(AB_ENGINES) + ("both",),
        help="A/B mode: which engine(s) to train and serve",
    )
    ap.add_argument("--batch-window-ms", type=float, default=5.0)
    ap.add_argument("--max-batch-size", type=int, default=64)
    ap.add_argument("--users", type=int, default=None,
                    help="A/B catalog size override (default: per engine)")
    ap.add_argument("--items", type=int, default=None)
    ap.add_argument("--events", type=int, default=None)
    ap.add_argument(
        "--trace-overhead", action="store_true",
        help="run the tracing on/off overhead A/B instead of the"
        " batching A/B",
    )
    ap.add_argument(
        "--client", choices=("http", "raw"), default="http",
        help="load-generator flavor for --url mode: http.client (the"
        " historical baseline client) or a minimal raw-socket client"
        " (~5x less generator python; use when the server outruns the"
        " generator)",
    )
    ap.add_argument(
        "--frontend-workers", default=None, metavar="N[,N...]",
        help="run the multi-process serving sweep instead: single-process"
        " vs SO_REUSEPORT frontend tiers; a single N sweeps 1, 2 and N"
        " workers, a comma list (e.g. '1,2,4,8') sweeps exactly those",
    )
    ap.add_argument(
        "--scorer-shards", default=None, metavar="N[,N...]",
        help="run the sharded serving sweep instead: one arm per scorer"
        " shard count (1 = the single-process baseline; each N>=2 arm"
        " is a full hash-partitioned shard fabric); e.g. '1,2,4'",
    )
    ap.add_argument(
        "--dispatch", choices=("async", "sync", "both"), default="async",
        help="scorer dispatch model for the multi-process sweep arms:"
        " async fast path (default), the sync dispatcher pool, or both"
        " (the sync-vs-async A/B; labels arms workers_N_sync/_async)",
    )
    ap.add_argument(
        "--pin-cpus", action="store_true",
        help="pin frontend workers and scorer to disjoint cores"
        " (sched_setaffinity) in every multi-process sweep arm",
    )
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the A/Bs train and serve (the --url load client"
        " touches no device)",
    )
    args = ap.parse_args(argv)
    if args.url:
        print(
            json.dumps(
                run_load(
                    args.url, args.query, args.clients or 8,
                    args.requests or 400, client=args.client,
                )
            )
        )
        return 0
    if args.scorer_shards is not None:
        engines = (
            ["recommendation"] if args.engine == "both" else [args.engine]
        )
        try:
            sweep = tuple(
                int(n) for n in str(args.scorer_shards).split(",")
                if n.strip()
            )
        except ValueError:
            ap.error(
                f"--scorer-shards must be an int or comma list, got "
                f"{args.scorer_shards!r}"
            )
        if len(sweep) == 1:
            sweep = (1,) + sweep
        report = {
            name: run_sharded_ab(
                name,
                concurrency=args.clients or 32,
                requests=args.requests or 2000,
                shards=sweep,
                users=args.users,
                items=args.items,
                events=args.events,
                window_ms=args.batch_window_ms,
                max_batch_size=args.max_batch_size,
                device=args.device,
            )
            for name in engines
        }
        print(json.dumps(report))
        return 0
    if args.frontend_workers is not None:
        engines = (
            ["recommendation"] if args.engine == "both" else [args.engine]
        )
        try:
            sweep = tuple(
                int(w) for w in str(args.frontend_workers).split(",")
                if w.strip()
            )
        except ValueError:
            ap.error(
                f"--frontend-workers must be an int or comma list, got "
                f"{args.frontend_workers!r}"
            )
        if len(sweep) == 1:
            sweep = (1, 2) + sweep
        dispatch = (
            ("sync", "async") if args.dispatch == "both" else args.dispatch
        )
        report = {
            name: run_multiproc_ab(
                name,
                concurrency=args.clients or 32,
                requests=args.requests or 2000,
                workers=sweep,
                users=args.users,
                items=args.items,
                events=args.events,
                window_ms=args.batch_window_ms,
                max_batch_size=args.max_batch_size,
                dispatch=dispatch,
                pin_cpus=args.pin_cpus,
                device=args.device,
            )
            for name in engines
        }
        print(json.dumps(report))
        return 0
    engines = list(AB_ENGINES) if args.engine == "both" else [args.engine]
    ab = run_trace_ab if args.trace_overhead else run_ab
    report = {
        name: ab(
            name,
            concurrency=args.clients or 32,
            requests=args.requests or 960,
            users=args.users,
            items=args.items,
            events=args.events,
            window_ms=args.batch_window_ms,
            max_batch_size=args.max_batch_size,
            device=args.device,
        )
        for name in engines
    }
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
