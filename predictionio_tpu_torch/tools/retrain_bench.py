"""Continuous-learning freshness A/B: ingest -> visible-in-query latency.

Usage::

    python -m predictionio_tpu_torch.tools.retrain_bench [--probes 5]

Measures ``online_freshness_seconds`` -- the wall time between an event's
durable ingest (WAL append + storage flush + checkpoint, the exact cycle
the event server's group-commit pipeline runs) and the FIRST
``/queries.json`` response that reflects it -- under concurrent serving
load, for two arms sharing one deployment:

- **foldin**  -- ``pio retrain --follow`` semantics: the loop tails the
  WAL, refreshes the snapshot, fold-in-solves the touched user rows, and
  hot-swaps the query server (``online.loop``);
- **full**    -- the same loop forced to escalate (``max_touched_frac=0``):
  every delta triggers a complete ``run_train`` + swap, the pre-fold-in
  freshness floor.

Each probe ingests one event for a PREVIOUSLY UNKNOWN user and polls the
query server until that user's recommendations turn non-empty -- a
response only a model reflecting the event can produce. Load clients
hammer known users throughout; the report asserts their error count is
zero (hot swaps must drop nothing).

Port of ``predictionio_tpu/tools/retrain_bench.py``, the reference's code
under the port's package name, on ``device`` (``cuda`` unless "cpu"; no
card and no "cpu" raises before any work): the base train and every full
retrain run through B1 (``ops/als_gram.py::gram_rhs``), the follower's
fold-in solves through B1 too (``online/foldin.py``), and the query
server the arms share scores on the same device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

from predictionio_tpu_torch.data import storage as storage_registry
from predictionio_tpu_torch.tools.ingest_bench import _Env

APP = "RetrainBenchApp"
APP_ID = 1


def _engine_json(workdir: str, rank: int, iterations: int) -> str:
    path = os.path.join(workdir, "engine.json")
    with open(path, "w") as f:
        json.dump(
            {
                "id": "retrain-bench",
                "engineFactory": (
                    "predictionio_tpu_torch.models.recommendation.engine"
                    ".engine_factory"
                ),
                "datasource": {"params": {"appName": APP}},
                "algorithms": [
                    {
                        "name": "als",
                        "params": {
                            "rank": rank,
                            "numIterations": iterations,
                            "seed": 7,
                            "checkpointInterval": 0,
                        },
                    }
                ],
            },
            f,
        )
    return path


def _populate(le, events: int, users: int, items: int) -> None:
    import datetime as _dt

    from predictionio_tpu_torch.data import DataMap, Event

    rng = np.random.default_rng(17)
    base = _dt.datetime.now(_dt.timezone.utc) - _dt.timedelta(hours=1)
    le.batch_insert(
        [
            Event(
                event="rate",
                entity_type="user",
                entity_id=f"u{rng.integers(0, users)}",
                target_entity_type="item",
                target_entity_id=f"i{rng.integers(0, items)}",
                properties=DataMap({"rating": float(rng.integers(1, 6))}),
                event_time=base + _dt.timedelta(milliseconds=13 * k),
            )
            for k in range(events)
        ],
        app_id=APP_ID,
    )


def _timed_events(events: int, users: int, items: int) -> list:
    """The seeded rating stream with a FIXED time base (13 ms spacing):
    every index maps to one replayable timestamp, so the quality arm's
    split boundary is an exact `--split-time`, not a wall-clock race."""
    import datetime as _dt

    from predictionio_tpu_torch.data import DataMap, Event

    rng = np.random.default_rng(17)
    base = _dt.datetime(2024, 1, 1, tzinfo=_dt.timezone.utc)
    return [
        Event(
            event="rate",
            entity_type="user",
            entity_id=f"u{rng.integers(0, users)}",
            target_entity_type="item",
            target_entity_id=f"i{rng.integers(0, items)}",
            properties=DataMap({"rating": float(rng.integers(1, 6))}),
            event_time=base + _dt.timedelta(milliseconds=13 * k),
        )
        for k in range(events)
    ]


def _ingest_one(wal, le, user: str, item: str) -> float:
    """One durable ingest through the WAL pipeline's exact cycle; returns
    the ack time (the freshness clock's zero). Against a
    :class:`PartitionedWal` the event lands in the partition its entity
    hashes to -- the event server's routing rule."""
    from predictionio_tpu_torch.data import DataMap, Event
    from predictionio_tpu_torch.data.ingest import partition_of, wal_payload

    event = Event(
        event="rate",
        entity_type="user",
        entity_id=user,
        target_entity_type="item",
        target_entity_id=item,
        properties=DataMap({"rating": 5.0}),
    ).with_id()
    target = (
        wal.part(partition_of(event, wal.partitions))
        if hasattr(wal, "parts")
        else wal
    )
    seqno = target.append(wal_payload(event, APP_ID, None))
    target.sync()
    t_ack = time.perf_counter()
    le.insert_batch([(event, APP_ID, None)], on_duplicate="ignore")
    target.checkpoint(seqno)
    return t_ack


def _post_query(url: str, body: dict, timeout: float = 15.0):
    req = urllib.request.Request(
        f"{url}/queries.json",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def _measure_arm(
    label: str,
    server_url: str,
    variant,
    wal,
    budget,
    probes: int,
    load_clients: int,
    freshness_timeout_s: float,
    interval_s: float,
    ingest_load_clients: int = 0,
    device=None,
) -> dict:
    from predictionio_tpu_torch.online.loop import RetrainConfig, RetrainLoop

    loop = RetrainLoop(
        variant,
        RetrainConfig(
            interval_s=interval_s,
            notify_urls=[server_url],
            budget=budget,
        ),
        device=device,
    )
    loop_thread = threading.Thread(target=loop.run_follow, daemon=True)
    loop_thread.start()

    stop = threading.Event()
    load_errors = [0]
    load_count = [0]

    def load_worker(k: int) -> None:
        rng = np.random.default_rng(100 + k)
        while not stop.is_set():
            try:
                status, _ = _post_query(
                    server_url, {"user": f"u{rng.integers(0, 20)}", "num": 3}
                )
                if status != 200:
                    load_errors[0] += 1
            except Exception:
                load_errors[0] += 1
            load_count[0] += 1

    ingest_load_count = [0]
    ingest_load_errors = [0]

    def ingest_load_worker(k: int) -> None:
        """Sustained background write pressure on KNOWN users: every event
        rides the full durable cycle, so the follower must keep folding
        this stream while the probes measure freshness."""
        rng = np.random.default_rng(500 + k)
        le = storage_registry.get_l_events()
        while not stop.is_set():
            try:
                _ingest_one(
                    wal, le,
                    user=f"u{rng.integers(0, 20)}",
                    item=f"i{rng.integers(0, 10)}",
                )
                ingest_load_count[0] += 1
            except Exception:
                ingest_load_errors[0] += 1
            time.sleep(0.005)

    workers = [
        threading.Thread(target=load_worker, args=(k,), daemon=True)
        for k in range(load_clients)
    ] + [
        threading.Thread(target=ingest_load_worker, args=(k,), daemon=True)
        for k in range(ingest_load_clients)
    ]
    for w in workers:
        w.start()

    latencies = []
    timeouts = 0
    try:
        for k in range(probes):
            user = f"fresh-{label}-{k}"
            t_ack = _ingest_one(wal, le=storage_registry.get_l_events(),
                                user=user, item=f"i{k % 10}")
            deadline = t_ack + freshness_timeout_s
            seen = None
            while time.perf_counter() < deadline:
                try:
                    status, body = _post_query(server_url, {"user": user, "num": 3})
                except Exception:
                    time.sleep(0.05)
                    continue
                if status == 200 and body.get("itemScores"):
                    seen = time.perf_counter()
                    break
                time.sleep(0.05)
            if seen is None:
                timeouts += 1
            else:
                latencies.append(seen - t_ack)
    finally:
        stop.set()
        loop.stop()
        loop_thread.join(timeout=30)
        for w in workers:
            w.join(timeout=10)
    return {
        "probes": probes,
        "timeouts": timeouts,
        "freshness_s_median": (
            round(statistics.median(latencies), 3) if latencies else None
        ),
        "freshness_s_max": round(max(latencies), 3) if latencies else None,
        "load_requests": load_count[0],
        "load_errors": load_errors[0],
        "ingest_load_events": ingest_load_count[0],
        "ingest_load_errors": ingest_load_errors[0],
        "cycles": dict(loop.cycles),
    }


def run_ab(
    events: int = 2_000,
    users: int = 60,
    items: int = 30,
    rank: int = 8,
    iterations: int = 3,
    probes: int = 4,
    load_clients: int = 2,
    freshness_timeout_s: float = 30.0,
    interval_s: float = 0.2,
    workdir: str | None = None,
    full_retrain_arm: bool = True,
    wal_partitions: int = 1,
    ingest_load_clients: int = 0,
    device=None,
) -> dict:
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.wal import PartitionedWal
    from predictionio_tpu_torch.online.foldin import StalenessBudget
    from predictionio_tpu_torch.utils.device import resolve_device
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.create_server import create_query_server
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    device = resolve_device(device)
    report: dict = {
        "events": events, "users": users, "items": items, "rank": rank,
        "wal_partitions": wal_partitions,
        "ingest_load_clients": ingest_load_clients,
    }
    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="pio_retrain_bench_")
    with _Env(workdir):
        storage_registry.get_meta_data_apps().insert(App(name=APP))
        le = storage_registry.get_l_events()
        le.init_channel(APP_ID)
        _populate(le, events, users, items)
        variant = load_engine_variant(_engine_json(workdir, rank, iterations))
        t0 = time.perf_counter()
        run_train(variant, device=device)
        report["train_seconds"] = round(time.perf_counter() - t0, 3)

        wal = PartitionedWal(os.path.join(workdir, "wal"),
                             partitions=wal_partitions)
        thread, service = create_query_server(
            variant, host="127.0.0.1", port=0, device=device
        )
        thread.start()
        url = f"http://127.0.0.1:{thread.port}"
        try:
            report["foldin"] = _measure_arm(
                "fold", url, variant, wal, StalenessBudget(
                    max_touched_frac=1.0, max_item_growth_frac=1.0,
                    max_user_growth_frac=10.0,
                ),
                probes, load_clients, freshness_timeout_s, interval_s,
                ingest_load_clients=ingest_load_clients, device=device,
            )
            if full_retrain_arm:
                report["full_retrain"] = _measure_arm(
                    "full", url, variant, wal,
                    StalenessBudget(max_touched_frac=0.0),
                    probes, load_clients, freshness_timeout_s, interval_s,
                    ingest_load_clients=ingest_load_clients, device=device,
                )
                a = report["foldin"].get("freshness_s_median")
                b = report["full_retrain"].get("freshness_s_median")
                if a and b:
                    report["foldin_speedup"] = round(b / a, 2)
        finally:
            thread.stop()
            service.close()
            wal.close()
    if own_tmp:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return report


def run_quality(
    events: int = 2_000,
    users: int = 60,
    items: int = 30,
    rank: int = 8,
    iterations: int = 3,
    base_frac: float = 0.6,
    split_frac: float = 0.8,
    k: int = 10,
    workdir: str | None = None,
    device=None,
) -> dict:
    """The freshness A/B's quality counterpart: does fold-in COST accuracy?

    Leakage-free staging on one seeded, fixed-time-base stream:

    1. the prefix ``[0, base_frac)`` trains the base model (``run_train``);
    2. the window ``[base_frac, split_frac)`` arrives through the durable
       ingest cycle (store + WAL), and ONE ``pio retrain`` catch-up cycle
       folds it in, publishing a registry generation;
    3. the holdout ``[split_frac, 1)`` lands store-only -- the future
       neither arm may see at train time;
    4. ``pio eval --replay`` at the boundary scores the folded generation
       (``--model-version``) against a forced-full-retrain on the exact
       same prefix, reporting the NDCG@k the shortcut gave up.
    """
    from predictionio_tpu_torch.data.ingest import wal_payload
    from predictionio_tpu_torch.data.storage.base import App
    from predictionio_tpu_torch.data.wal import WriteAheadLog
    from predictionio_tpu_torch.eval.replay import run_replay_eval
    from predictionio_tpu_torch.online.foldin import StalenessBudget
    from predictionio_tpu_torch.online.loop import RetrainConfig, RetrainLoop
    from predictionio_tpu_torch.online.registry import ModelRegistry
    from predictionio_tpu_torch.utils.device import resolve_device
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.json_extractor import load_engine_variant

    device = resolve_device(device)
    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="pio_retrain_quality_")
    i_base = int(events * base_frac)
    i_split = int(events * split_frac)
    stream = _timed_events(events, users, items)
    t_split_iso = stream[i_split].event_time.isoformat()
    ndcg_key = f"ndcg_at_{k}"
    report: dict = {
        "events": events, "users": users, "items": items, "rank": rank,
        "base_events": i_base, "window_events": i_split - i_base,
        "holdout_events": events - i_split, "split_time": t_split_iso,
    }
    with _Env(workdir):
        storage_registry.get_meta_data_apps().insert(App(name=APP))
        le = storage_registry.get_l_events()
        le.init_channel(APP_ID)
        le.batch_insert(stream[:i_base], app_id=APP_ID)
        variant = load_engine_variant(_engine_json(workdir, rank, iterations))
        run_train(variant, device=device)

        wal = WriteAheadLog(os.path.join(workdir, "wal"))
        try:
            window = [e.with_id() for e in stream[i_base:i_split]]
            seqno = 0
            for event in window:
                seqno = wal.append(wal_payload(event, APP_ID, None))
            wal.sync()
            le.insert_batch([(e, APP_ID, None) for e in window],
                            on_duplicate="ignore")
            wal.checkpoint(seqno)
            loop = RetrainLoop(
                variant,
                RetrainConfig(
                    interval_s=0.1,
                    budget=StalenessBudget(
                        max_touched_frac=1.0,
                        max_item_growth_frac=1.0,
                        max_user_growth_frac=10.0,
                    ),
                    max_cycles=1,
                ),
                device=device,
            )
            report["cycles"] = loop.run_follow()
            entry = ModelRegistry.for_variant(variant).latest()
            if entry is None:
                raise RuntimeError(
                    "fold-in cycle published no registry generation"
                )
            report["folded_version"] = entry.version
            report["folded_source"] = entry.source
            # the future: store-only, invisible to both arms' training
            le.batch_insert(stream[i_split:], app_id=APP_ID)
            folded = run_replay_eval(
                variant, split_time=t_split_iso, k=k,
                model_version=entry.version, retrieval_guard=False,
                device=device,
            )
            full = run_replay_eval(
                variant, split_time=t_split_iso, k=k, retrieval_guard=False,
                device=device,
            )
        finally:
            wal.close()
    report["folded_metrics"] = folded["metrics"]
    report["full_retrain_metrics"] = full["metrics"]
    report["holdout_users"] = folded["split"]["holdout_users"]
    a, b = folded["metrics"][ndcg_key], full["metrics"][ndcg_key]
    report["ndcg_delta_full_minus_folded"] = (
        round(b - a, 6) if a is not None and b is not None else None
    )
    if own_tmp:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--events", type=int, default=2_000)
    parser.add_argument("--users", type=int, default=60)
    parser.add_argument("--items", type=int, default=30)
    parser.add_argument("--rank", type=int, default=8)
    parser.add_argument("--iterations", type=int, default=3)
    parser.add_argument("--probes", type=int, default=4)
    parser.add_argument("--load-clients", type=int, default=2)
    parser.add_argument("--wal-partitions", type=int, default=1,
                        help="ingest WAL partition count (the follower"
                        " discovers the layout off disk)")
    parser.add_argument("--ingest-load-clients", type=int, default=0,
                        help="background durable-ingest writer threads"
                        " running during each freshness arm")
    parser.add_argument("--no-full-retrain-arm", action="store_true")
    parser.add_argument(
        "--quality", action="store_true",
        help="measure fold-in accuracy instead of freshness: folded model"
        " vs forced-full-retrain on the same held-out replay split"
        " (NDCG delta)",
    )
    parser.add_argument("--split-frac", type=float, default=0.8,
                        help="--quality replay boundary (default 0.8)")
    parser.add_argument("--k", type=int, default=10,
                        help="--quality ranking cutoff (default 10)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    if args.quality:
        report = run_quality(
            events=args.events,
            users=args.users,
            items=args.items,
            rank=args.rank,
            iterations=args.iterations,
            split_frac=args.split_frac,
            k=args.k,
            device=args.device,
        )
    else:
        report = run_ab(
            events=args.events,
            users=args.users,
            items=args.items,
            rank=args.rank,
            iterations=args.iterations,
            probes=args.probes,
            load_clients=args.load_clients,
            full_retrain_arm=not args.no_full_retrain_arm,
            wal_partitions=args.wal_partitions,
            ingest_load_clients=args.ingest_load_clients,
            device=args.device,
        )
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
