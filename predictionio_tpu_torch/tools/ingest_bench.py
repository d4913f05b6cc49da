"""Ingestion A/B: per-request sync commits vs WAL + group-commit pipeline.

Usage::

    python -m predictionio_tpu_torch.tools.ingest_bench [--clients 32] [--events 50]

Two measured phases against a fresh file-backed sqlite store, plus a
kill-and-replay durability cycle:

- **sync**  -- N client threads, each ``POST``-shaped insert paying one
  storage transaction on the request thread (the pre-pipeline Event Server
  behavior);
- **wal**   -- the same load through :class:`IngestPipeline`: requests park
  on the queue, one WAL fsync + one ``executemany`` transaction per group
  commit;
- **crash** -- a subprocess ingests through the pipeline (fsync=always)
  while logging every acknowledged eventId, is SIGKILLed mid-stream, and
  the parent replays the WAL tail and asserts zero lost / zero duplicated
  acknowledged events (run twice to prove replay idempotence).

``--wal-partitions`` takes either one value (the WAL phase and crash
cycle run at that partition count) or a comma list (``1,2,4,8``), which
switches to a sweep: the same group-commit load is re-driven at each
partition count and the report shows eps per P plus scaling vs P=1. The
partitioned crash cycle additionally audits that every surviving WAL
frame lives in the partition its entity hashes to (zero cross-partition
routing drift) and that each partition's second replay is a no-op.

Load is driven at the ``EventService`` layer (``_insert_one``), not over
HTTP: this box's HTTP envelope saturates around a few hundred req/s and
would mask the storage-commit effect under test (``serving_bench`` owns
the HTTP-envelope A/B). Both phases pay identical validation/serde costs.

Port of ``predictionio_tpu/tools/ingest_bench.py``, the reference's code
under the port's package name: the load runs through the port's
``data/api/eventserver.py``, ``data/ingest.py`` and ``data/wal.py``, and
the crash child is this module. Ingestion is host work: nothing here
touches a device, so the tool takes no ``--device``. ``_Env`` is shared
with ``train_bench``, ``eval_bench`` and ``retrain_bench``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

from predictionio_tpu_torch.data import storage as storage_registry
from predictionio_tpu_torch.data.storage.base import AccessKey

APP_ID = 1


def _event_obj(client_id: int, i: int) -> dict:
    return {
        "event": "view",
        "entityType": "user",
        "entityId": f"u{client_id}",
        "targetEntityType": "item",
        "targetEntityId": f"i{(client_id * 7919 + i) % 1000}",
        "properties": {"rating": (i % 5) + 1},
    }


#: sqlite synchronous pragma for the default PIO_SQLITE source
_SYNC_VAR = "PIO_STORAGE_SOURCES_PIO_SQLITE_SYNCHRONOUS"


class _Env:
    """Point the storage registry at a private basedir (optionally pinning
    the sqlite synchronous pragma); restore on exit."""

    def __init__(self, basedir: str, synchronous: str | None = None):
        self.env = {"PIO_FS_BASEDIR": basedir}
        if synchronous is not None:
            self.env[_SYNC_VAR] = synchronous

    def __enter__(self):
        self._saved = {k: os.environ.get(k) for k in (*self.env, _SYNC_VAR)}
        os.environ.pop(_SYNC_VAR, None)
        os.environ.update(self.env)
        storage_registry.reset()
        return self

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        storage_registry.reset()


def _drive(service, clients: int, events_per_client: int) -> dict:
    """Fan ``clients`` threads into ``service._insert_one``; returns eps."""
    record = AccessKey(key="bench", app_id=APP_ID)
    barrier = threading.Barrier(clients + 1)
    failures: list[int] = []

    def worker(cid: int) -> None:
        barrier.wait()
        for i in range(events_per_client):
            status, _ = service._insert_one(_event_obj(cid, i), record, None)
            if status != 201:
                failures.append(status)

    threads = [
        threading.Thread(target=worker, args=(c,), daemon=True)
        for c in range(clients)
    ]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    total = clients * events_per_client
    return {
        "seconds": round(seconds, 3),
        "eps": round(total / seconds, 1),
        "failures": len(failures),
    }


def _stored_count() -> int:
    return sum(1 for _ in storage_registry.get_l_events().find(app_id=APP_ID, limit=None))


def run_ab(
    clients: int = 32,
    events_per_client: int = 50,
    group_commit_ms: float = 5.0,
    fsync_policy: str = "always",
    crash_events: int = 200,
    workdir: str | None = None,
    wal_partitions: int = 1,
) -> dict:
    from predictionio_tpu_torch.data.api.eventserver import EventService
    from predictionio_tpu_torch.data.ingest import IngestConfig

    report: dict = {
        "clients": clients,
        "events_per_client": events_per_client,
        "group_commit_ms": group_commit_ms,
        "fsync_policy": fsync_policy,
        "wal_partitions": wal_partitions,
    }
    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="pio_ingest_bench_")

    # -- A: per-request sync commits, durability-matched (every commit
    # fsyncs, like the WAL phase's acks). This is THE baseline: sqlite's
    # default synchronous=NORMAL never fsyncs under a WAL journal, i.e. the
    # pre-pipeline ingest path was not actually durable per request.
    with _Env(os.path.join(workdir, "sync"), synchronous="FULL"):
        storage_registry.get_l_events().init_channel(APP_ID)
        service = EventService()
        report["sync"] = _drive(service, clients, events_per_client)
        report["sync"]["stored"] = _stored_count()

    # -- A': the non-durable sync reference (what the server shipped with)
    with _Env(os.path.join(workdir, "sync_fast")):
        storage_registry.get_l_events().init_channel(APP_ID)
        service = EventService()
        report["sync_nondurable"] = _drive(service, clients, events_per_client)

    # -- B: WAL + group commit ------------------------------------------------
    with _Env(os.path.join(workdir, "wal")):
        storage_registry.get_l_events().init_channel(APP_ID)
        service = EventService(
            ingest_config=IngestConfig(
                mode="wal",
                group_commit_ms=group_commit_ms,
                fsync_policy=fsync_policy,
                wal_partitions=wal_partitions,
            )
        )
        try:
            report["wal"] = _drive(service, clients, events_per_client)
        finally:
            service.shutdown_ingest()
        report["wal"]["stored"] = _stored_count()

    report["speedup"] = (
        round(report["wal"]["eps"] / report["sync"]["eps"], 2)
        if report["sync"]["eps"]
        else None
    )
    report["speedup_vs_nondurable_sync"] = (
        round(report["wal"]["eps"] / report["sync_nondurable"]["eps"], 2)
        if report["sync_nondurable"]["eps"]
        else None
    )

    # -- C: kill-and-replay durability cycle ----------------------------------
    if crash_events:
        report["crash_cycle"] = run_crash_cycle(
            os.path.join(workdir, "crash"),
            min_acked=crash_events,
            partitions=wal_partitions,
        )
    if own_tmp:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return report


def run_sweep(
    partitions: tuple[int, ...] = (1, 2, 4, 8),
    clients: int = 32,
    events_per_client: int = 50,
    group_commit_ms: float = 5.0,
    fsync_policy: str = "always",
    crash_partitions: int | None = None,
    crash_events: int = 200,
    workdir: str | None = None,
) -> dict:
    """Drive the SAME group-commit load at each partition count and report
    eps per P. Only the WAL arm runs (the sync baselines don't change with
    P); ``crash_partitions`` optionally tacks on one kill-and-replay cycle
    at that partition count."""
    from predictionio_tpu_torch.data.api.eventserver import EventService
    from predictionio_tpu_torch.data.ingest import IngestConfig

    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="pio_ingest_sweep_")
    report: dict = {
        "clients": clients,
        "events_per_client": events_per_client,
        "group_commit_ms": group_commit_ms,
        "fsync_policy": fsync_policy,
        "partitions": {},
    }
    for p in partitions:
        with _Env(os.path.join(workdir, f"p{p}")):
            storage_registry.get_l_events().init_channel(APP_ID)
            service = EventService(
                ingest_config=IngestConfig(
                    mode="wal",
                    group_commit_ms=group_commit_ms,
                    fsync_policy=fsync_policy,
                    wal_partitions=p,
                )
            )
            try:
                arm = _drive(service, clients, events_per_client)
            finally:
                service.shutdown_ingest()
            arm["stored"] = _stored_count()
            report["partitions"][str(p)] = arm
    base = report["partitions"][str(partitions[0])]["eps"]
    for p in partitions:
        arm = report["partitions"][str(p)]
        arm["scaling_vs_first"] = round(arm["eps"] / base, 2) if base else None
    eps_seq = [report["partitions"][str(p)]["eps"] for p in sorted(partitions)]
    # 10% jitter allowance: two cores + sqlite make exact monotonicity noisy
    report["monotonic"] = all(
        b >= a * 0.9 for a, b in zip(eps_seq, eps_seq[1:])
    )
    if crash_partitions:
        report["crash_cycle"] = run_crash_cycle(
            os.path.join(workdir, "crash"),
            min_acked=crash_events,
            partitions=crash_partitions,
        )
    if own_tmp:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return report


# -- crash cycle --------------------------------------------------------------

def _crash_child(workdir: str, partitions: int = 1) -> None:
    """Ingest forever through the pipeline (fsync=always), logging each
    acknowledged eventId; the parent SIGKILLs us mid-stream."""
    from predictionio_tpu_torch.data.ingest import PartitionedIngestPipeline
    from predictionio_tpu_torch.data.wal import PartitionedWal
    from predictionio_tpu_torch.data.event import Event

    os.environ["PIO_FS_BASEDIR"] = workdir
    storage_registry.reset()
    l_events = storage_registry.get_l_events()
    l_events.init_channel(APP_ID)

    real = l_events

    class _SlowEvents:
        """Widen the acked-but-not-yet-stored window so the SIGKILL
        reliably catches records whose only copy is the WAL."""

        def insert_batch(self, items, on_duplicate="error"):
            time.sleep(0.02)
            return real.insert_batch(items, on_duplicate=on_duplicate)

    wal = PartitionedWal(
        os.path.join(workdir, "wal"),
        partitions=partitions,
        fsync_policy="always",
    )
    pipeline = PartitionedIngestPipeline(
        wal, l_events=lambda: _SlowEvents(), group_commit_ms=2.0
    ).start()
    # spread entities so every partition takes writes (P=1 keeps the
    # original single-entity stream)
    entity_span = 1 if partitions <= 1 else 4 * partitions
    acked = open(os.path.join(workdir, "acked.txt"), "w", buffering=1)
    i = 0
    while True:  # until SIGKILL
        futs = []
        for _ in range(16):
            ev = Event.from_json_obj(_event_obj(i % entity_span, i))
            futs.append(pipeline.submit(ev, APP_ID, None))
            i += 1
        for f in futs:
            acked.write(f.result(timeout=30) + "\n")


def run_crash_cycle(
    workdir: str,
    min_acked: int = 200,
    timeout_s: float = 60.0,
    partitions: int = 1,
) -> dict:
    """SIGKILL a pipeline mid-ingest, replay the WAL, prove exactly-once
    (per partition when ``partitions`` > 1, with a routing audit on the
    surviving frames)."""
    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ)
    env["PIO_FS_BASEDIR"] = workdir
    # the child interpreter must find this package without an install
    pkg_parent = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.ingest_bench",
         "--crash-child", workdir, "--crash-partitions", str(partitions)],
        env=env,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
        text=True,
    )
    acked_path = os.path.join(workdir, "acked.txt")
    deadline = time.time() + timeout_s
    try:
        while time.time() < deadline:
            try:
                with open(acked_path) as f:
                    if sum(1 for _ in f) >= min_acked:
                        break
            except OSError:
                pass
            if proc.poll() is not None:
                raise RuntimeError(
                    f"crash child exited early rc={proc.returncode}:"
                    f" {(proc.stderr.read() or '')[-800:]}"
                )
            time.sleep(0.02)
        else:
            raise RuntimeError(f"crash child acked < {min_acked} in {timeout_s}s")
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.wait()

    # the acked log's last line can be torn by the kill; count only full lines
    with open(acked_path) as f:
        data = f.read()
    acked_ids = [line for line in data.split("\n")[:-1] if line]

    from predictionio_tpu_torch.data import wal as wal_mod
    from predictionio_tpu_torch.data.ingest import (
        partition_of,
        replay_wal_into_storage,
        wal_parse,
    )
    from predictionio_tpu_torch.data.wal import PartitionedWal

    with _Env(workdir):
        stored_before = _stored_count()
        wal = PartitionedWal(
            os.path.join(workdir, "wal"),
            partitions=partitions,
            fsync_policy="never",
        )
        per_part = [replay_wal_into_storage(p) for p in wal.parts]
        replayed = sum(per_part)
        stored_after = _stored_count()
        # second replay cycle (a second "restart") must change nothing,
        # independently in every partition
        per_part_again = [replay_wal_into_storage(p) for p in wal.parts]
        replayed_again = sum(per_part_again)
        # routing audit: a frame in partition k must hash to k -- any
        # miss means the router and the on-disk layout drifted apart
        misrouted = 0
        for k, part in enumerate(wal.parts):
            for _seqno, payload in wal_mod.iter_log_records(part.directory):
                event, _app, _chan, _trace = wal_parse(payload)
                if partition_of(event, wal.partitions) != k:
                    misrouted += 1
        wal.close()
        stored_ids = [
            e.event_id
            for e in storage_registry.get_l_events().find(app_id=APP_ID, limit=None)
        ]
    stored_set = set(stored_ids)
    lost = [i for i in acked_ids if i not in stored_set]
    return {
        "partitions": partitions,
        "acked": len(acked_ids),
        "stored_before_replay": stored_before,
        "replayed": replayed,
        "replayed_per_partition": per_part,
        "stored_after_replay": stored_after,
        "lost": len(lost),
        "duplicated": len(stored_ids) - len(stored_set),
        "misrouted": misrouted,
        "second_replay_records": replayed_again,
        "second_replay_delta": len(stored_ids) - stored_after,
        "exactly_once": not lost
        and len(stored_ids) == len(stored_set)
        and replayed_again == 0
        and misrouted == 0,
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--clients", type=int, default=32)
    parser.add_argument("--events", type=int, default=50, help="per client")
    parser.add_argument("--group-commit-ms", type=float, default=5.0)
    parser.add_argument("--fsync-policy", default="always",
                        choices=("always", "interval", "never"))
    parser.add_argument("--crash-events", type=int, default=200,
                        help="min acked events before the kill (0 disables)")
    parser.add_argument("--wal-partitions", default="1", metavar="P[,P...]",
                        help="WAL partition count; a comma list (1,2,4,8)"
                        " runs the partition sweep instead of the full A/B")
    parser.add_argument("--crash-child", metavar="DIR", default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--crash-partitions", type=int, default=1,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.crash_child:
        _crash_child(args.crash_child, partitions=args.crash_partitions)
        return 0
    part_list = [int(p) for p in str(args.wal_partitions).split(",") if p]
    if len(part_list) > 1:
        report = run_sweep(
            partitions=tuple(part_list),
            clients=args.clients,
            events_per_client=args.events,
            group_commit_ms=args.group_commit_ms,
            fsync_policy=args.fsync_policy,
            crash_partitions=max(part_list) if args.crash_events else None,
            crash_events=args.crash_events,
        )
    else:
        report = run_ab(
            clients=args.clients,
            events_per_client=args.events,
            group_commit_ms=args.group_commit_ms,
            fsync_policy=args.fsync_policy,
            crash_events=args.crash_events,
            wal_partitions=part_list[0] if part_list else 1,
        )
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
