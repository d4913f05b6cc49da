"""Training-data extraction A/B: cold SQL scan vs columnar snapshot replay.

Usage::

    python -m predictionio_tpu_torch.tools.train_bench [--events 2000000]

Three measured phases against a fresh file-backed sqlite store:

- **cold**    -- the pre-snapshot ``pio train`` input path: TWO full
  ``iter_interaction_chunks`` SQL scans (pass-1 counts + pass-2 retention)
  through ``store_coo_chunks``'s per-row python decode;
- **build**   -- ``SnapshotStore.build``: ONE bounded SQL scan spilled into
  memory-mapped column files (what the first snapshot-enabled train pays);
- **replay**  -- both passes replayed from the memmap through
  ``snapshot_coo_chunks``'s vectorized decode (what every later pass,
  process, and train pays) -- the ``train_data_eps`` headline number;

plus an exactness phase: build a snapshot, ingest more events,
**incrementally refresh**, and assert the refreshed snapshot's
``build_als_data_sharded`` output is BIT-identical (same vocab ids, same
bucketed CSR blocks) to a cold SQL rebuild over the same bounded prefix.

Extraction events/sec counts SOURCE rows per wall second for one full
two-pass read (both sides do two passes, so the ratio is the honest
train-input speedup). The synthetic stream mixes "rate" events carrying a
numeric rating with property-less "buy" events, exercising both the
rating and the default-value decode paths.

Port of ``predictionio_tpu/tools/train_bench.py``, the reference's code
under the port's package name but for the pack: the reference packs on
a 1 x 1 JAX mesh, the port packs one process's rows (``mesh=None``, the
same layout) through ``ops/ragged.py::pack_padded_csr``, whose native
packer (``native/``) raises when it does not build; ``PIO_NATIVE=0``
picks numpy. Extraction and packing are host work: nothing here touches
a device, so the tool takes no ``--device``.
"""

from __future__ import annotations

import argparse
import datetime as _dt
import json
import sys
import tempfile
import time

import numpy as np

from predictionio_tpu_torch.data import storage as storage_registry
from predictionio_tpu_torch.tools.ingest_bench import _Env

APP_ID = 1
EVENT_NAMES = ["rate", "buy"]


def _populate(
    le, n_events: int, n_users: int, n_items: int, seed: int = 7,
    start: _dt.datetime | None = None, batch: int = 20_000,
) -> float:
    """Insert ``n_events`` synthetic interactions with strictly increasing
    event times; returns insert seconds."""
    from predictionio_tpu_torch.data import DataMap, Event

    rng = np.random.default_rng(seed)
    base = start or _dt.datetime(2024, 1, 1, tzinfo=_dt.timezone.utc)
    t0 = time.perf_counter()
    for lo in range(0, n_events, batch):
        n = min(batch, n_events - lo)
        uu = rng.integers(0, n_users, n)
        ii = rng.integers(0, n_items, n)
        rr = rng.integers(1, 6, n)
        events = [
            Event(
                event="buy" if (lo + k) % 5 == 0 else "rate",
                entity_type="user",
                entity_id=f"u{uu[k]}",
                target_entity_type="item",
                target_entity_id=f"i{ii[k]}",
                properties=(
                    DataMap({})
                    if (lo + k) % 5 == 0
                    else DataMap({"rating": float(rr[k])})
                ),
                event_time=base + _dt.timedelta(milliseconds=37 * (lo + k)),
            )
            for k in range(n)
        ]
        le.batch_insert(events, app_id=APP_ID)
    return time.perf_counter() - t0


def _two_pass(source) -> tuple[float, int]:
    """One full two-pass read (counts, then consume): (seconds, edges)."""
    from predictionio_tpu_torch.parallel.reader import _grow_bincount

    t0 = time.perf_counter()
    cnt_u = np.zeros(0, np.int64)
    cnt_i = np.zeros(0, np.int64)
    for uu, ii, _vv, _tt in source():
        cnt_u = _grow_bincount(cnt_u, uu)
        cnt_i = _grow_bincount(cnt_i, ii)
    edges = 0
    for uu, _ii, vv, tt in source():
        edges += len(uu)
        float(vv[-1] if len(vv) else 0.0)
        float(tt[-1] if len(tt) else 0.0)
    return time.perf_counter() - t0, edges


def als_data_identical(a, b) -> list[str]:
    """Field-by-field bit-equality of two ALSData layouts; returns the
    list of differences (empty = identical)."""
    diffs: list[str] = []
    for side_name in ("by_row", "by_col"):
        sa, sb = getattr(a, side_name), getattr(b, side_name)
        for attr in ("num_rows", "total_slots", "global_rows", "retained_edges"):
            if getattr(sa, attr) != getattr(sb, attr):
                diffs.append(f"{side_name}.{attr}")
        if not np.array_equal(sa.slot_of, sb.slot_of):
            diffs.append(f"{side_name}.slot_of")
        if len(sa.blocks) != len(sb.blocks):
            diffs.append(f"{side_name}.blocks(len)")
            continue
        for bi, (ba, bb) in enumerate(zip(sa.blocks, sb.blocks)):
            for attr in ("indices", "values", "mask"):
                if not np.array_equal(getattr(ba, attr), getattr(bb, attr)):
                    diffs.append(f"{side_name}.blocks[{bi}].{attr}")
    return diffs


def _refresh_identity_check(
    workdir: str, n_events: int, n_users: int, n_items: int,
    chunk_rows: int,
) -> dict:
    """Snapshot -> ingest more -> refresh -> train must equal a cold
    bounded rebuild bit-for-bit."""
    from predictionio_tpu_torch.data.snapshot import SnapshotSpec, SnapshotStore
    from predictionio_tpu_torch.parallel.als import ALSConfig
    from predictionio_tpu_torch.parallel.reader import (
        build_als_data_sharded,
        snapshot_coo_chunks,
        store_coo_chunks,
    )

    report: dict = {"events_initial": n_events, "events_appended": n_events // 4}
    with _Env(workdir):
        le = storage_registry.get_l_events()
        le.init_channel(APP_ID)
        _populate(le, n_events, n_users, n_items, seed=11)
        t1 = _dt.datetime.now(_dt.timezone.utc)
        spec = SnapshotSpec(
            app_id=APP_ID, event_names=tuple(EVENT_NAMES)
        )
        store = SnapshotStore(workdir + "/snapshots", spec)
        store.build(le, t1, chunk_rows=chunk_rows)
        # second batch lands AFTER the first snapshot's coverage boundary
        # and strictly BEFORE the next bound t2 (bounds are arbitrary
        # instants, not wall-clock "now")
        _populate(
            le, n_events // 4, n_users, n_items, seed=13,
            start=t1 + _dt.timedelta(milliseconds=1),
        )
        t2 = t1 + _dt.timedelta(hours=12)
        t0 = time.perf_counter()
        snap = store.refresh(le, t2, chunk_rows=chunk_rows)
        report["refresh_seconds"] = round(time.perf_counter() - t0, 3)
        report["rows_after_refresh"] = len(snap)

        mesh = None  # one process: every row (the reference's 1 x 1 mesh)
        cfg = ALSConfig(rank=4, buckets=2, max_len=64)
        cold_src, cold_u, cold_i = store_coo_chunks(
            le, APP_ID, event_names=EVENT_NAMES, chunk_rows=chunk_rows,
            until_time=t2,
        )
        cold = build_als_data_sharded(cold_src, None, None, cfg, mesh)
        snap_src, snap_u, snap_i = snapshot_coo_chunks(
            snap, chunk_rows=chunk_rows
        )
        warm = build_als_data_sharded(snap_src, None, None, cfg, mesh)
        diffs = als_data_identical(cold, warm)
        if cold_u.ids != snap_u.ids:
            diffs.append("user_vocab")
        if cold_i.ids != snap_i.ids:
            diffs.append("item_vocab")
        report["differences"] = diffs
        report["bit_identical"] = not diffs
    return report


def run_ab(
    events: int = 2_000_000,
    users: int = 100_000,
    items: int = 20_000,
    identity_events: int = 200_000,
    chunk_rows: int = 262_144,
    workdir: str | None = None,
) -> dict:
    from predictionio_tpu_torch.data.snapshot import SnapshotSpec, SnapshotStore
    from predictionio_tpu_torch.parallel.reader import (
        snapshot_coo_chunks,
        store_coo_chunks,
    )

    report: dict = {"events": events, "users": users, "items": items}
    own_tmp = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="pio_train_bench_")

    with _Env(workdir + "/ab"):
        le = storage_registry.get_l_events()
        le.init_channel(APP_ID)
        report["populate_seconds"] = round(
            _populate(le, events, users, items), 3
        )
        until = _dt.datetime.now(_dt.timezone.utc)

        # -- A: cold SQL extraction (two scans, per-row decode) ------------
        source, _u, _i = store_coo_chunks(
            le, APP_ID, event_names=EVENT_NAMES, chunk_rows=chunk_rows,
            until_time=until,
        )
        seconds, edges = _two_pass(source)
        report["cold"] = {
            "seconds": round(seconds, 3),
            "eps": round(events / seconds, 1),
            "edges": edges,
        }

        # -- B: snapshot build (ONE scan + spill), then memmap replay ------
        spec = SnapshotSpec(app_id=APP_ID, event_names=tuple(EVENT_NAMES))
        store = SnapshotStore(workdir + "/ab/snapshots", spec)
        t0 = time.perf_counter()
        snap = store.build(le, until, chunk_rows=chunk_rows)
        report["snapshot_build"] = {
            "seconds": round(time.perf_counter() - t0, 3),
            "rows": len(snap),
        }
        source, _u, _i = snapshot_coo_chunks(snap, chunk_rows=chunk_rows)
        seconds, edges_replay = _two_pass(source)
        report["replay"] = {
            "seconds": round(seconds, 3),
            "eps": round(events / seconds, 1),
            "edges": edges_replay,
        }
        report["edges_match"] = edges_replay == edges
        report["eps_speedup"] = (
            round(report["replay"]["eps"] / report["cold"]["eps"], 2)
            if report["cold"]["eps"]
            else None
        )

    if identity_events:
        report["refresh_identity"] = _refresh_identity_check(
            workdir + "/identity", identity_events, max(users // 10, 50),
            max(items // 10, 20), chunk_rows,
        )

    if own_tmp:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    return report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--events", type=int, default=2_000_000)
    parser.add_argument("--users", type=int, default=100_000)
    parser.add_argument("--items", type=int, default=20_000)
    parser.add_argument("--identity-events", type=int, default=200_000,
                        help="events in the refresh bit-identity phase"
                        " (0 disables; the ALS pack runs the native packer)")
    parser.add_argument("--chunk-rows", type=int, default=262_144)
    args = parser.parse_args(argv)
    report = run_ab(
        events=args.events,
        users=args.users,
        items=args.items,
        identity_events=args.identity_events,
        chunk_rows=args.chunk_rows,
    )
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
