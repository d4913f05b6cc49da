"""On-disk columnar training snapshots: single-scan reads with memmap replay.

The training input spine streams the event table's deterministic
``(event_time_ms, event_id)``-ordered interaction scan TWICE per train
(pass 1 counts/vocab, pass 2 retention), every process in a multi-host mesh
repeats it, and repeated trains on the same app start from zero. ALX
(arxiv 2112.02194) is input-bound at scale exactly this way, and the
Spark-ML study (arxiv 1612.01437) pins most MLlib wall time on data prep,
not math. This module removes the repeated scans:

- :meth:`SnapshotStore.build` spills the ordered interaction stream ONCE
  into memory-mapped numpy column files (integer-encoded entities, epoch
  times, numeric ratings) plus first-appearance vocabularies;
- every later pass -- pass 1 counts, pass 2 retention, repeat trains,
  every process on a host -- replays the local memmap instead of SQL
  (``parallel.reader.snapshot_coo_chunks``);
- :meth:`SnapshotStore.refresh` extends an existing snapshot by scanning
  only ``event_time >= snapshot.until`` and appending: the scan order
  sorts strictly-later events after every snapshot row, so append-only
  refresh reproduces a cold bounded scan bit-for-bit. A cheap
  ``COUNT(*)`` over the covered prefix detects late-arriving or deleted
  rows and falls back to a full rebuild (exactness over cleverness).

Durability discipline matches ``data/wal.py``: generations are written to
a tmp dir, fsynced, and atomically renamed; every column file and the
vocabulary blob carry CRC32s in the manifest; a torn/truncated/corrupt
generation is rejected at load (and a valid older generation, if any, is
served instead); stale generations are GC'd after a successful commit.

On-disk layout (one key dir per scan spec, monotonically numbered
generations inside)::

    <root>/<key16>/
        gen-000001/
            manifest.json   # spec, time bound, row count, CRCs, version
            users.bin       # int64   full-stream entity codes
            items.bin       # int64   target codes; -1 = no target entity
            names.bin       # int32   event-name codes
            times.bin       # float64 epoch seconds (microsecond-exact)
            ratings.bin     # float64 JSON-number rating; NaN = absent
            vocabs.json     # {"users": [...], "items": [...], "names": [...]}
        gen-000002/...

The key hashes the scan spec (app/channel, event-name set, rating key,
target-entity filter, format version): any spec change lands in a fresh
key dir, so a stale snapshot can never serve a different scan's train.

Port copy: ``predictionio_tpu/data/snapshot.py`` (framework-free), verbatim
under the port's package name; ``tests/test_torch_imports.py`` holds
it to the original.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json
import logging
import os
import shutil
import time
import zlib
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from predictionio_tpu_torch.utils.metrics import global_registry

logger = logging.getLogger("pio.snapshot")

#: bump on any incompatible change to columns/manifest/vocab encoding
SNAPSHOT_FORMAT_VERSION = 1

#: modulus (ms per day) for the per-row event-time checksum shared with
#: ``sql_common.interaction_digest``: per-row values stay < 8.64e7 so a
#: 64-bit integer SUM cannot overflow (or fall back to float) in any
#: dialect at any realistic row count
TIME_DIGEST_MOD = 86_400_000

#: column name -> dtype; the fixed five-column interaction schema
COLUMN_DTYPES: dict[str, np.dtype] = {
    "users": np.dtype(np.int64),
    "items": np.dtype(np.int64),
    "names": np.dtype(np.int32),
    "times": np.dtype(np.float64),
    "ratings": np.dtype(np.float64),
}

#: duration buckets for scan/replay histograms: memmap replays land sub-
#: second, cold multi-million-row SQL scans take minutes
SCAN_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
    120.0, 300.0, 600.0,
)

_REQUESTS = "pio_snapshot_requests_total"
_REQUESTS_HELP = (
    "Training-snapshot lookups by outcome (hit|miss_build|refresh_append|"
    "refresh_noop|rebuild_drift|rebuild_bound|invalid|unsupported)"
)
_SCAN_SECONDS = "pio_snapshot_scan_seconds"
_REPLAY_SECONDS = "pio_snapshot_replay_seconds"


def record_outcome(result: str) -> None:
    global_registry().inc(_REQUESTS, {"result": result}, help=_REQUESTS_HELP)


def record_scan_seconds(kind: str, seconds: float) -> None:
    global_registry().observe(
        _SCAN_SECONDS,
        seconds,
        {"kind": kind},
        buckets=SCAN_BUCKETS,
        help="SQL scan+spill duration per snapshot build/refresh",
    )


def record_replay_seconds(seconds: float) -> None:
    global_registry().observe(
        _REPLAY_SECONDS,
        seconds,
        buckets=SCAN_BUCKETS,
        help="Memmap replay duration per full pass over a snapshot",
    )


def snapshot_settings(
    runtime_conf=None,
    mode: str | None = None,
    snapshot_dir: str | None = None,
) -> tuple[str, str]:
    """Resolve ``(mode, root_dir)`` from explicit args > runtime conf >
    environment > defaults.

    ``pio train --snapshot-mode/--snapshot-dir`` lands in both the runtime
    conf (``pio.snapshot_mode``/``pio.snapshot_dir``) and the
    ``PIO_SNAPSHOT_MODE``/``PIO_SNAPSHOT_DIR`` env, so layers without a
    RuntimeContext (``PEventStore.dataset``) see the same setting. Default
    mode is ``off``: snapshots change read-freshness semantics, so they
    are strictly opt-in.
    """
    conf = runtime_conf or {}
    resolved_mode = (
        mode
        or conf.get("pio.snapshot_mode")
        or os.environ.get("PIO_SNAPSHOT_MODE")
        or "off"
    )
    if resolved_mode not in ("off", "use", "refresh"):
        raise ValueError(
            f"snapshot mode must be off|use|refresh, got {resolved_mode!r}"
        )
    root = (
        snapshot_dir
        or conf.get("pio.snapshot_dir")
        or os.environ.get("PIO_SNAPSHOT_DIR")
    )
    if not root:
        from predictionio_tpu_torch.data.storage import base_dir

        root = os.path.join(base_dir(), "snapshots")
    return resolved_mode, root


def _now_utc() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def _ts_ms(ts: _dt.datetime) -> int:
    # THE ts_ms: manifest bounds and SQL scan bounds must agree
    # bit-for-bit, so share the definition rather than hand-copy it
    from predictionio_tpu_torch.data.storage.sql_common import ts_ms

    return ts_ms(ts)


@dataclass(frozen=True)
class SnapshotSpec:
    """What one snapshot covers: the identity of a bounded interaction scan.

    ``event_names=None`` means the unfiltered scan; ``target_entity_type``
    keeps the scan API's three-valued filter (``...`` = any, ``None`` =
    rows without a target, a string = that type).
    """

    app_id: int
    channel_id: int | None = None
    event_names: tuple[str, ...] | None = None
    rating_key: str = "rating"
    target_entity_type: object = ...

    def canonical(self) -> dict:
        if self.target_entity_type is ...:
            target = {"filter": "any", "type": None}
        elif self.target_entity_type is None:
            target = {"filter": "none", "type": None}
        else:
            target = {"filter": "type", "type": str(self.target_entity_type)}
        return {
            "format_version": SNAPSHOT_FORMAT_VERSION,
            "app_id": int(self.app_id),
            "channel_id": None if self.channel_id is None else int(self.channel_id),
            # the scan's IN-filter is a set: orderings must share a snapshot
            "event_names": (
                None if self.event_names is None else sorted(self.event_names)
            ),
            "rating_key": self.rating_key,
            "target": target,
        }

    def key(self) -> str:
        material = json.dumps(self.canonical(), sort_keys=True)
        return hashlib.sha256(material.encode()).hexdigest()[:16]

    def scan_kwargs(self) -> dict:
        """The iter_interaction_chunks filter kwargs this spec pins."""
        kwargs: dict = {
            "channel_id": self.channel_id,
            "event_names": (
                None if self.event_names is None else list(self.event_names)
            ),
            "rating_key": self.rating_key,
        }
        if self.target_entity_type is not ...:
            kwargs["target_entity_type"] = self.target_entity_type
        return kwargs


class SnapshotInvalid(Exception):
    """A generation failed validation (torn file, CRC mismatch, bad spec)."""


class Snapshot:
    """An opened, validated snapshot generation: memmap columns + vocabs."""

    def __init__(self, path: str, manifest: dict):
        self.path = path
        self.manifest = manifest
        self._columns: dict[str, np.ndarray] = {}
        self._vocabs: dict[str, list[str]] | None = None

    def __len__(self) -> int:
        return int(self.manifest["row_count"])

    @property
    def until_time(self) -> _dt.datetime:
        """The EXCLUSIVE upper time bound, as the exact datetime the build
        scan used (re-parsed from ISO so ``ts_ms`` reproduces the same
        millisecond -- reconstructing from the stored ms via float division
        can land one ms off)."""
        return _dt.datetime.fromisoformat(self.manifest["until"])

    def column(self, name: str) -> np.ndarray:
        """Read-only memmap of one column (zero rows -> empty array)."""
        if name not in self._columns:
            dtype = COLUMN_DTYPES[name]
            if len(self) == 0:
                self._columns[name] = np.empty(0, dtype)
            else:
                self._columns[name] = np.memmap(
                    os.path.join(self.path, f"{name}.bin"),
                    dtype=dtype,
                    mode="r",
                    shape=(len(self),),
                )
        return self._columns[name]

    def vocab(self, which: str) -> list[str]:
        if self._vocabs is None:
            with open(os.path.join(self.path, "vocabs.json")) as f:
                self._vocabs = json.load(f)
        return self._vocabs[which]

    def open_columns(self) -> "Snapshot":
        """Eagerly open every column memmap. Called before a snapshot is
        handed out: open file handles survive a concurrent writer's GC
        unlinking this generation (POSIX), so replay cannot crash on a
        file that vanished between ensure() and the first chunk."""
        for c in COLUMN_DTYPES:
            self.column(c)
        return self

    def chunks(
        self, chunk_rows: int = 262_144
    ) -> Iterator[tuple[np.ndarray, ...]]:
        """Replay ``(users, items, names, times, ratings)`` array chunks."""
        cols = [self.column(c) for c in COLUMN_DTYPES]
        n = len(self)
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            yield tuple(np.asarray(c[lo:hi]) for c in cols)


class _ColumnSpill:
    """Streams encoded column chunks to disk with running CRC32s.

    ``vocabs`` may be pre-seeded (refresh continues an existing
    vocabulary); CRCs may be pre-seeded with the copied prefix's CRCs
    (zlib.crc32 is resumable)."""

    def __init__(
        self,
        directory: str,
        vocabs: dict[str, dict[str, int]],
        crcs: dict[str, int] | None = None,
        time_digest: int = 0,
    ):
        self.dir = directory
        self.vocabs = vocabs
        self.crcs = dict(crcs or {c: 0 for c in COLUMN_DTYPES})
        self.rows = 0
        #: running sum of event_time_ms % TIME_DIGEST_MOD -- the cheap
        #: content fingerprint interaction_digest() re-derives in SQL
        self.time_digest = time_digest
        self._files = {
            c: open(os.path.join(directory, f"{c}.bin"), "ab")
            for c in COLUMN_DTYPES
        }

    def append_scan_chunk(self, ents, tgts, names, times_iso, ratings) -> None:
        n = len(ents)
        uv, iv, nv = (
            self.vocabs["users"], self.vocabs["items"], self.vocabs["names"]
        )

        def to_float(v) -> float:
            if v is None:
                return np.nan
            try:
                return float(v)  # drivers may hand numbers back as str/Decimal
            except (TypeError, ValueError):
                return np.nan

        arrays = {
            "users": np.fromiter(
                (uv.setdefault(e, len(uv)) for e in ents), np.int64, count=n
            ),
            "items": np.fromiter(
                (
                    -1 if t is None else iv.setdefault(t, len(iv))
                    for t in tgts
                ),
                np.int64,
                count=n,
            ),
            "names": np.fromiter(
                (nv.setdefault(x, len(nv)) for x in names), np.int32, count=n
            ),
            # the exact float64 the streaming reader computes per row, so
            # memmap replay is bit-identical to the live scan
            "times": np.fromiter(
                (
                    _dt.datetime.fromisoformat(s).timestamp()
                    for s in times_iso
                ),
                np.float64,
                count=n,
            ),
            "ratings": np.fromiter(
                (to_float(r) for r in ratings), np.float64, count=n
            ),
        }
        for c, arr in arrays.items():
            raw = arr.tobytes()
            self._files[c].write(raw)
            self.crcs[c] = zlib.crc32(raw, self.crcs[c])
        # (t * 1000).astype(int64) reproduces ts_ms()'s int(t*1000) per row
        # bit-for-bit (same float64 source, same multiply, same toward-zero
        # truncation), so this matches SQL's stored event_time_ms exactly.
        # fmod, not %: SQL modulo is TRUNCATED (sign of dividend) and
        # numpy's % is floored -- they disagree on pre-1970 event times
        ms = (arrays["times"] * 1000.0).astype(np.int64)
        self.time_digest += int(np.fmod(ms, TIME_DIGEST_MOD).sum())
        self.rows += n

    def close(self) -> None:
        for f in self._files.values():
            f.flush()
            os.fsync(f.fileno())
            f.close()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_json_crc(path: str, obj) -> int:
    raw = json.dumps(obj).encode()
    with open(path, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    return zlib.crc32(raw)


class SnapshotStore:
    """Build / load / refresh / GC snapshots for one scan spec."""

    def __init__(self, root: str, spec: SnapshotSpec):
        self.spec = spec
        self.dir = os.path.join(root, spec.key())

    # -- lookup ------------------------------------------------------------
    def _generations(self) -> list[tuple[int, str]]:
        try:
            entries = os.listdir(self.dir)
        except OSError:
            return []
        gens = []
        for name in entries:
            if name.startswith("gen-"):
                try:
                    gens.append((int(name[4:]), os.path.join(self.dir, name)))
                except ValueError:
                    continue
        return sorted(gens)

    def load(self) -> Snapshot | None:
        """Newest generation that survives validation; invalid ones are
        skipped (never deleted here -- a concurrent writer may still be
        committing) and counted."""
        for _, path in reversed(self._generations()):
            try:
                return self._validate(path)
            # OSError too: a concurrent builder's GC can unlink this
            # generation mid-validation (after the manifest/size probes) --
            # treat it as invalid and fall through to the next one rather
            # than failing the whole lookup
            except (SnapshotInvalid, OSError) as exc:
                record_outcome("invalid")
                logger.warning("rejecting snapshot %s: %s", path, exc)
        return None

    def _validate(self, gen_path: str) -> Snapshot:
        manifest_path = os.path.join(gen_path, "manifest.json")
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            raise SnapshotInvalid(f"unreadable manifest: {exc!r}")
        if manifest.get("format_version") != SNAPSHOT_FORMAT_VERSION:
            raise SnapshotInvalid(
                f"format_version {manifest.get('format_version')!r} !="
                f" {SNAPSHOT_FORMAT_VERSION}"
            )
        if manifest.get("spec") != self.spec.canonical():
            raise SnapshotInvalid(
                "manifest spec mismatch (changed event_names/rating_key/"
                "channel/target filter)"
            )
        rows = manifest.get("row_count")
        crcs = manifest.get("crc", {})
        if not isinstance(rows, int) or rows < 0:
            raise SnapshotInvalid(f"bad row_count {rows!r}")
        for c, dtype in COLUMN_DTYPES.items():
            path = os.path.join(gen_path, f"{c}.bin")
            want = rows * dtype.itemsize
            try:
                size = os.path.getsize(path)
            except OSError:
                size = -1
            if size != want:
                raise SnapshotInvalid(
                    f"column {c}: {size} bytes, want {want} (torn/truncated)"
                )
            if rows and _file_crc(path) != crcs.get(c):
                raise SnapshotInvalid(f"column {c}: CRC mismatch")
        vpath = os.path.join(gen_path, "vocabs.json")
        try:
            with open(vpath, "rb") as f:
                vraw = f.read()
        except OSError as exc:
            raise SnapshotInvalid(f"unreadable vocabs: {exc!r}")
        if zlib.crc32(vraw) != crcs.get("vocabs"):
            raise SnapshotInvalid("vocabs.json: CRC mismatch")
        vocabs = json.loads(vraw)
        for which, size in manifest.get("vocab_sizes", {}).items():
            if len(vocabs.get(which, ())) != size:
                raise SnapshotInvalid(f"vocab {which}: size mismatch")
        snap = Snapshot(gen_path, manifest)
        snap._vocabs = vocabs
        return snap.open_columns()

    # -- build / refresh ---------------------------------------------------
    def build(
        self,
        l_events,
        until_time: _dt.datetime,
        chunk_rows: int = 262_144,
        _start_snapshot: Snapshot | None = None,
    ) -> Snapshot:
        """Spill the bounded ordered scan into a new generation (ONE SQL
        round-trip). With ``_start_snapshot`` the new generation starts as
        a byte copy of it and the scan covers only ``[its until, ours)`` --
        the incremental-refresh fast path."""
        os.makedirs(self.dir, exist_ok=True)
        tmp = os.path.join(self.dir, f".tmp-{os.getpid()}-{time.monotonic_ns()}")
        os.makedirs(tmp)
        t0 = time.perf_counter()
        try:
            vocabs: dict[str, dict[str, int]] = {
                "users": {}, "items": {}, "names": {}
            }
            crcs = None
            scan_kwargs = self.spec.scan_kwargs()
            base_rows = 0
            base_digest = 0
            if _start_snapshot is not None:
                for c in COLUMN_DTYPES:
                    if len(_start_snapshot):
                        shutil.copyfile(
                            os.path.join(_start_snapshot.path, f"{c}.bin"),
                            os.path.join(tmp, f"{c}.bin"),
                        )
                crcs = {
                    c: _start_snapshot.manifest["crc"].get(c, 0)
                    for c in COLUMN_DTYPES
                }
                vocabs = {
                    which: {v: j for j, v in enumerate(_start_snapshot.vocab(which))}
                    for which in vocabs
                }
                base_rows = len(_start_snapshot)
                base_digest = int(_start_snapshot.manifest.get("time_digest", 0))
                scan_kwargs["start_time"] = _start_snapshot.until_time
            spill = _ColumnSpill(tmp, vocabs, crcs, time_digest=base_digest)
            spill.rows = base_rows
            for chunk in l_events.iter_interaction_chunks(
                app_id=self.spec.app_id,
                until_time=until_time,
                chunk_rows=chunk_rows,
                **scan_kwargs,
            ):
                spill.append_scan_chunk(*chunk)
            spill.close()
            scan_seconds = time.perf_counter() - t0
            kind = "build" if _start_snapshot is None else "refresh"
            record_scan_seconds(kind, scan_seconds)
            if _start_snapshot is not None and spill.rows == base_rows:
                # nothing new landed: keep serving the existing generation
                # (the next refresh re-scans the same empty window -- cheap)
                shutil.rmtree(tmp, ignore_errors=True)
                record_outcome("refresh_noop")
                return _start_snapshot
            vocab_lists = {
                which: list(mapping) for which, mapping in spill.vocabs.items()
            }
            vcrc = _write_json_crc(
                os.path.join(tmp, "vocabs.json"), vocab_lists
            )
            manifest = {
                "format_version": SNAPSHOT_FORMAT_VERSION,
                "spec": self.spec.canonical(),
                "until": until_time.isoformat(),
                "until_ms": _ts_ms(until_time),
                "row_count": spill.rows,
                "time_digest": spill.time_digest,
                "vocab_sizes": {w: len(v) for w, v in vocab_lists.items()},
                "crc": {**spill.crcs, "vocabs": vcrc},
                "created_at": _now_utc().isoformat(),
                "scan_seconds": round(scan_seconds, 3),
                "parent_rows": base_rows,
            }
            _write_json_crc(os.path.join(tmp, "manifest.json"), manifest)
            _fsync_dir(tmp)
            gen_path = self._commit(tmp)
            record_outcome("miss_build" if kind == "build" else "refresh_append")
            logger.info(
                "snapshot %s: %d rows (%+d) in %.2fs -> %s",
                kind, spill.rows, spill.rows - base_rows, scan_seconds,
                gen_path,
            )
            snap = Snapshot(gen_path, manifest)
            snap._vocabs = vocab_lists
            snap.open_columns()
            self.gc(keep=os.path.basename(gen_path))
            return snap
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _commit(self, tmp: str) -> str:
        """Atomically publish ``tmp`` as the next generation. A concurrent
        builder may claim a number first; retry with the next one."""
        for _ in range(100):
            gens = self._generations()
            number = (gens[-1][0] + 1) if gens else 1
            target = os.path.join(self.dir, f"gen-{number:06d}")
            try:
                os.rename(tmp, target)
            except OSError:
                continue
            _fsync_dir(self.dir)
            return target
        raise OSError(f"could not claim a snapshot generation under {self.dir}")

    def refresh(
        self,
        l_events,
        until_time: _dt.datetime,
        chunk_rows: int = 262_144,
    ) -> Snapshot:
        """Extend the newest valid snapshot to ``until_time`` by appending
        the ``[old until, until_time)`` scan -- exact because the ordered
        stream sorts every new event after every covered one. Late-arriving
        or deleted rows inside the covered prefix (detected by a cheap
        COUNT over it) force a full rebuild instead."""
        base = self.load()
        if base is None:
            return self.build(l_events, until_time, chunk_rows)
        if _ts_ms(until_time) == base.manifest["until_ms"]:
            record_outcome("hit")
            return base
        if _ts_ms(until_time) < base.manifest["until_ms"]:
            # the cached generation covers BEYOND the requested bound (a
            # concurrent later train under the same spec): serving it
            # would replay extra rows. Refresh promises the exact bound --
            # rebuild at it (multi-process layout agreement depends on
            # every process replaying the same prefix).
            record_outcome("rebuild_bound")
            return self.build(l_events, until_time, chunk_rows)
        filters = {
            k: v
            for k, v in self.spec.scan_kwargs().items()
            if k != "rating_key"
        }
        if hasattr(l_events, "interaction_digest"):
            covered, digest = l_events.interaction_digest(
                app_id=self.spec.app_id, until_time=base.until_time, **filters
            )
            drifted = covered != len(base) or digest != int(
                base.manifest.get("time_digest", -1)
            )
        elif hasattr(l_events, "count_interactions"):
            covered = l_events.count_interactions(
                app_id=self.spec.app_id, until_time=base.until_time, **filters
            )
            drifted = covered != len(base)
        else:
            covered, drifted = len(base), False
        if drifted:
            record_outcome("rebuild_drift")
            logger.warning(
                "snapshot %s: covered prefix drifted (%d stored rows vs"
                " %d in the event table, or time checksum mismatch) --"
                " late-arriving, deleted, or altered events; rebuilding"
                " from scratch",
                base.path, len(base), covered,
            )
            return self.build(l_events, until_time, chunk_rows)
        return self.build(
            l_events, until_time, chunk_rows, _start_snapshot=base
        )

    def ensure(
        self,
        l_events,
        mode: str,
        until_time: _dt.datetime | None = None,
        chunk_rows: int = 262_144,
    ) -> Snapshot | None:
        """The one call sites use: a ready snapshot per ``mode``, or None
        when snapshots don't apply (mode off, or a backend without the
        columnar chunk scan)."""
        if mode == "off":
            return None
        if not hasattr(l_events, "iter_interaction_chunks"):
            record_outcome("unsupported")
            logger.warning(
                "snapshot mode %r requested but the event backend has no"
                " columnar chunk scan; falling back to direct reads", mode
            )
            return None
        until_time = until_time or _now_utc()
        if mode == "use":
            snap = self.load()
            if snap is not None:
                record_outcome("hit")
                return snap
            return self.build(l_events, until_time, chunk_rows)
        if mode == "refresh":
            return self.refresh(l_events, until_time, chunk_rows)
        raise ValueError(f"snapshot mode must be off|use|refresh, got {mode!r}")

    # -- GC ----------------------------------------------------------------
    def gc(self, keep: str, tmp_ttl_s: float = 3600.0) -> None:
        """Remove generations OLDER than ``keep`` plus abandoned tmp dirs
        older than ``tmp_ttl_s`` (a live concurrent builder's tmp dir is
        younger than that). Newer generations are never touched: a
        concurrent builder may have committed one after ours, and two
        racing GCs that each keep their own would otherwise delete both."""
        try:
            keep_number = int(keep[4:])
        except ValueError:
            return
        for number, path in self._generations():
            if number < keep_number:
                shutil.rmtree(path, ignore_errors=True)
        now = time.time()
        try:
            entries = os.listdir(self.dir)
        except OSError:
            return
        for name in entries:
            if name.startswith(".tmp-"):
                path = os.path.join(self.dir, name)
                try:
                    # newest mtime INSIDE the dir, not the dir's own: a
                    # live builder only appends to files created at scan
                    # start, which never bumps the directory mtime
                    newest = max(
                        [os.path.getmtime(path)]
                        + [
                            os.path.getmtime(os.path.join(path, f))
                            for f in os.listdir(path)
                        ]
                    )
                    if now - newest > tmp_ttl_s:
                        shutil.rmtree(path, ignore_errors=True)
                except OSError:
                    pass


def snapshot_block_dir(snapshot: Snapshot) -> str:
    """Default home of a generation's streamed-ALS block caches
    (``parallel.stream``). Living INSIDE the generation directory ties
    the cache's lifetime to its source data: snapshot GC reaps the cache
    with the generation, and a refreshed generation starts clean. Extra
    files here never affect generation validation -- ``_validate`` checks
    only the manifest-named column files."""
    return os.path.join(snapshot.path, "blocks")


def _file_crc(path: str, bufsize: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb", buffering=0) as f:
        while True:
            block = f.read(bufsize)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)
