"""Segmented append-only write-ahead log for event ingestion.

The Spark-era reference delegated ingestion durability to external stores
(HBase WALs, ES translogs); the native rebuild needs its own. This WAL is
the durability point of the group-commit pipeline (``data/ingest.py``): a
``POST /events.json`` is acknowledged once its record is framed into the
current segment and the segment is synced per the fsync policy, and the
storage flush happens off the request path. On startup, the tail of the
log past the last storage checkpoint is replayed into the event store.

On-disk layout (one directory per log)::

    wal-00000000000000000001.log   segment files, named by FIRST seqno
    wal-00000000000000004096.log
    wal.ckpt                       last seqno known flushed to storage

Record frame (little-endian): ``uint32 payload_len | uint32 crc32 |
uint64 seqno | payload``, where the CRC covers the seqno bytes plus the
payload. A torn tail (partial frame, bad CRC, or an impossible length from
a crash mid-append) terminates the scan of that segment only; every
restart opens a fresh segment -- or, when the crash tore the very first
frame (so the restart re-derives the same segment name), truncates the
torn garbage first -- so intact records are never hidden behind a torn
frame.

Fsync policy trade-off (``always`` | ``interval`` | ``never``):

- ``always``  -- fsync on every :meth:`sync` (one per group commit, NOT
  one per record: the pipeline amortizes it over the batch);
- ``interval``-- fsync at most once per ``fsync_interval_ms``; bounds the
  post-crash loss window to that interval;
- ``never``   -- OS page cache only; survives process death, not host
  death.

Partitioned layout (``wal-partitions P`` with P > 1) shards the log by
entity hash into P fully independent sub-logs, each with its own seqno
space, segment files, checkpoint, and fsync stream::

    wal.parts                      partition count (the layout marker)
    part-00000/wal-...log          partition 0: a complete log as above
    part-00000/wal.ckpt
    part-00001/...

P = 1 is the degenerate case: no marker, no subdirectories -- the flat
single-log layout above, byte-for-byte what earlier releases wrote, so
old logs replay unchanged. :func:`resolve_partitions` adopts whatever
layout is on disk over the requested count (a WAL's partition count is
fixed at birth; re-routing a live log would strand records).

Port copy: ``predictionio_tpu/data/wal.py`` (framework-free), verbatim
under the port's package name; ``tests/test_torch_imports.py`` holds
it to the original.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
import zlib

logger = logging.getLogger("pio.wal")

#: frame header: payload length, crc32(seqno_bytes + payload), seqno
_FRAME = struct.Struct("<IIQ")

#: sanity ceiling on a single record; a longer length field means the
#: header bytes are garbage from a torn write, not a real record
MAX_RECORD_BYTES = 64 << 20

FSYNC_POLICIES = ("always", "interval", "never")

_SEGMENT_PREFIX = "wal-"
_SEGMENT_SUFFIX = ".log"
_CHECKPOINT_FILE = "wal.ckpt"
_PARTS_FILE = "wal.parts"
_PART_DIR_PREFIX = "part-"


def _part_dir_name(index: int) -> str:
    return f"{_PART_DIR_PREFIX}{index:05d}"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _segment_name(first_seqno: int) -> str:
    return f"{_SEGMENT_PREFIX}{first_seqno:020d}{_SEGMENT_SUFFIX}"


def _segment_first_seqno(name: str) -> int | None:
    if not (name.startswith(_SEGMENT_PREFIX) and name.endswith(_SEGMENT_SUFFIX)):
        return None
    digits = name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]
    return int(digits) if digits.isdigit() else None


def _scan_segment(path: str):
    """Yield ``(seqno, payload)`` for every intact frame; stop at the first
    torn or corrupt one (crash mid-append leaves at most one)."""
    for _, seqno, payload in _scan_frames(path):
        yield seqno, payload


def _scan_frames(path: str):
    """Like :func:`_scan_segment` but also yields each frame's end offset,
    so callers can truncate a torn tail."""
    offset = 0
    with open(path, "rb") as f:
        while True:
            header = f.read(_FRAME.size)
            if len(header) < _FRAME.size:
                return  # clean EOF or torn header
            length, crc, seqno = _FRAME.unpack(header)
            if length > MAX_RECORD_BYTES:
                return  # garbage length: torn frame
            payload = f.read(length)
            if len(payload) < length:
                return  # torn payload
            if zlib.crc32(header[8:] + payload) != crc:
                return  # bit rot / torn rewrite
            offset += _FRAME.size + length
            yield offset, seqno, payload


def _valid_prefix_length(path: str) -> int:
    """Byte length of the intact-frame prefix (0 for a fully torn file)."""
    end = 0
    for end, _, _ in _scan_frames(path):
        pass
    return end


def read_checkpoint(directory: str) -> int:
    """Last seqno known flushed to storage, read straight off disk (0 when
    absent/unreadable). The continuous-learning follower polls this from a
    DIFFERENT process than the ingest writer: a record is only safe to act
    on once it is in the event store (the ack point is the WAL, but the
    snapshot refresh scans SQL), so the follower bounds its tail at the
    storage high-water mark, not at the append head."""
    try:
        with open(os.path.join(directory, _CHECKPOINT_FILE)) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return 0


def oldest_seqno(directory: str) -> int | None:
    """First seqno of the oldest retained segment (None = empty log). A
    cross-process tail whose cursor trails this has a GC gap: records it
    never saw were collected after their storage flush, so it must
    resynchronize from the event store instead of the log."""
    firsts = []
    try:
        entries = os.listdir(directory)
    except OSError:
        return None
    for name in entries:
        first = _segment_first_seqno(name)
        if first is not None:
            firsts.append(first)
    return min(firsts) if firsts else None


def iter_log_records(
    directory: str, after_seqno: int = 0, upto_seqno: int | None = None
):
    """Yield ``(seqno, payload)`` for intact records with ``after_seqno <
    seqno <= upto_seqno`` in seqno order, reading the segment files
    directly (no :class:`WriteAheadLog` instance, no locks -- safe from a
    follower process while the owning writer keeps appending: frames are
    published by a single sequential write and the CRC scan stops at the
    first torn tail). Segments whose entire range is below ``after_seqno``
    are skipped via the layout invariant (a segment's name is its first
    record's seqno)."""
    names = []
    try:
        entries = os.listdir(directory)
    except OSError:
        return
    for name in entries:
        if _segment_first_seqno(name) is not None:
            names.append(name)
    names.sort()
    firsts = [_segment_first_seqno(n) for n in names]
    for i, name in enumerate(names):
        # every record in segment i has seqno < firsts[i + 1]
        if i + 1 < len(names) and firsts[i + 1] - 1 <= after_seqno:
            continue
        if upto_seqno is not None and firsts[i] > upto_seqno:
            return
        for seqno, payload in _scan_segment(os.path.join(directory, name)):
            if seqno <= after_seqno:
                continue
            if upto_seqno is not None and seqno > upto_seqno:
                return
            yield seqno, payload


def _flat_log_exists(directory: str) -> bool:
    """True when ``directory`` holds a single-partition log: segment files
    or a checkpoint directly at the root (the pre-partitioning layout)."""
    try:
        entries = os.listdir(directory)
    except OSError:
        return False
    for name in entries:
        if name == _CHECKPOINT_FILE or _segment_first_seqno(name) is not None:
            return True
    return False


def _marker_partitions(directory: str) -> int | None:
    """The ``wal.parts`` marker's count, or None when absent/unreadable."""
    try:
        with open(os.path.join(directory, _PARTS_FILE)) as f:
            on_disk = int(f.read().strip())
    except (OSError, ValueError):
        return None
    return on_disk if on_disk >= 1 else None


def resolve_partitions(directory: str, requested: int = 1) -> int:
    """The partition count a log at ``directory`` MUST be opened with.

    A WAL's partition count is fixed at birth: the entity->partition hash
    only recovers per-entity ordering if every record an entity ever
    wrote lives in one partition, so re-routing a live log would strand
    (or worse, reorder) records. On-disk evidence therefore wins over the
    requested count, with a warning on mismatch so the operator knows the
    flag was ignored rather than silently honored:

    1. a ``wal.parts`` marker pins the count it records;
    2. else a flat single-partition log at the root pins 1 (move the old
       log aside to re-partition);
    3. else (empty/new directory) the requested count stands.
    """
    if requested < 1:
        raise ValueError(f"wal partitions must be >= 1, got {requested}")
    on_disk = _marker_partitions(directory)
    if on_disk is not None:
        if on_disk != requested:
            logger.warning(
                "wal %s is partitioned P=%d on disk; ignoring requested "
                "P=%d (partition count is fixed at log creation)",
                directory, on_disk, requested,
            )
        return on_disk
    if _flat_log_exists(directory):
        if requested > 1:
            logger.warning(
                "wal %s holds an existing single-partition log; ignoring "
                "requested P=%d (move the old log aside to re-partition)",
                directory, requested,
            )
        return 1
    return requested


def partition_count(directory: str) -> int:
    """Partition count of the log at ``directory``, read straight off disk
    (1 when unmarked -- the flat layout). Cross-process safe: followers
    call this to discover how many tails to run. A pure read: unlike
    :func:`resolve_partitions` it never warns, because there is no
    requested count to mismatch."""
    return _marker_partitions(directory) or 1


def partition_dirs(directory: str, partitions: int | None = None) -> list[str]:
    """The per-partition log directories, in partition order. For the flat
    P=1 layout this is ``[directory]`` itself -- every consumer that maps
    over partitions handles old logs with zero special-casing."""
    n = partition_count(directory) if partitions is None else partitions
    if n <= 1:
        return [directory]
    return [os.path.join(directory, _part_dir_name(k)) for k in range(n)]


class WriteAheadLog:
    """Thread-safe via an internal lock; the ingest pipeline is the single
    writer in practice, but replay/checkpoint may come from other threads."""

    def __init__(
        self,
        directory: str,
        segment_bytes: int = 64 << 20,
        fsync_policy: str = "always",
        fsync_interval_ms: float = 100.0,
    ):
        if fsync_policy not in FSYNC_POLICIES:
            raise ValueError(
                f"fsync_policy must be one of {FSYNC_POLICIES}, got {fsync_policy!r}"
            )
        self.directory = directory
        self.segment_bytes = segment_bytes
        self.fsync_policy = fsync_policy
        self.fsync_interval_s = fsync_interval_ms / 1000.0
        self._lock = threading.Lock()
        self._last_fsync = 0.0
        #: observability counters (read without the lock: monotonic ints /
        #: a last-written float, mirrored into /metrics at scrape time)
        self.append_count = 0
        self.fsync_count = 0
        self.last_fsync_s = 0.0
        # collectible segments only appear on rotation (and at startup,
        # where prior-run segments may be replay-covered): gate GC on that
        # instead of paying a directory listing per group commit
        self._rotated_since_gc = True
        os.makedirs(directory, exist_ok=True)
        # the checkpoint is read once and cached: it only ever advances
        # through this instance, and a stale on-disk value is safe by design
        self._committed = self._read_checkpoint()
        # recover the seqno cursor: one past the last intact record anywhere
        # in the log (the checkpoint can trail behind after a crash)
        last = self._committed
        for path in self._segments():
            for seqno, _ in _scan_segment(path):
                if seqno > last:
                    last = seqno
        self._next_seqno = last + 1
        # always a fresh segment: appending after a torn frame would make the
        # torn bytes look like a mid-file corruption and hide the new records
        self._file = None
        self._segment_size = 0
        self._open_segment()

    # -- segments -----------------------------------------------------------
    def _segments(self) -> list[str]:
        names = [
            n
            for n in os.listdir(self.directory)
            if _segment_first_seqno(n) is not None
        ]
        names.sort()  # zero-padded first-seqno names sort chronologically
        return [os.path.join(self.directory, n) for n in names]

    def _open_segment(self) -> None:
        if self._file is not None:
            self._file.flush()
            if self.fsync_policy != "never":
                os.fsync(self._file.fileno())
            self._file.close()
        path = os.path.join(self.directory, _segment_name(self._next_seqno))
        # name collision means the existing file holds NO intact records
        # (any intact record would have advanced the seqno scan past this
        # name): a torn first frame from a crash mid-append. Appending after
        # torn bytes would hide the new records from replay -- truncate the
        # garbage away first.
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        if size:
            valid = _valid_prefix_length(path)
            if valid < size:
                with open(path, "r+b") as f:
                    f.truncate(valid)
        self._file = open(path, "ab")
        self._segment_size = self._file.tell()
        self._rotated_since_gc = True

    # -- write path ----------------------------------------------------------
    def append(self, payload: bytes) -> int:
        """Frame and buffer one record; returns its seqno. Durability comes
        from the following :meth:`sync` (the group-commit boundary)."""
        with self._lock:
            frame_len = _FRAME.size + len(payload)
            # rotate BEFORE taking the seqno so the fresh segment's name
            # equals its first record's seqno (the layout invariant _gc and
            # replay lower-bounding rely on)
            if self._segment_size + frame_len > self.segment_bytes and self._segment_size:
                self._open_segment()
            seqno = self._next_seqno
            self._next_seqno += 1
            seq_bytes = struct.pack("<Q", seqno)
            frame = (
                _FRAME.pack(len(payload), zlib.crc32(seq_bytes + payload), seqno)
                + payload
            )
            self._file.write(frame)
            self._segment_size += frame_len
            self.append_count += 1
            return seqno

    def sync(self) -> None:
        """Make buffered records durable per the fsync policy.

        The fsync runs OUTSIDE the writer lock (``pio check`` C002):
        holding it across the disk flush would park every concurrent
        ``append`` behind disk latency once per group commit -- the lock
        protects in-memory framing state, not the disk. The fd is dup'd
        under the lock so a rotation closing the segment concurrently
        cannot invalidate it mid-fsync (fsync on a dup flushes the same
        open file description), and records appended after the dup only
        ever gain durability early."""
        with self._lock:
            self._file.flush()
            if self.fsync_policy == "never":
                return
            if self.fsync_policy == "interval":
                if time.monotonic() - self._last_fsync < self.fsync_interval_s:
                    return
            fd = os.dup(self._file.fileno())
        t0 = time.monotonic()
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        self.fsync_count += 1
        self.last_fsync_s = time.monotonic() - t0
        # only a SUCCESSFUL fsync consumes the interval slot -- if it
        # raised, the caller's retry must actually hit the disk instead of
        # short-circuiting on a pre-advanced timestamp (benign unlocked
        # write: worst case between racing syncs is one extra fsync)
        if self.fsync_policy == "interval":
            self._last_fsync = time.monotonic()

    # -- checkpoint / replay --------------------------------------------------
    def _read_checkpoint(self) -> int:
        # ONE definition of the checkpoint file format (the follower's
        # cross-process read shares it)
        return read_checkpoint(self.directory)

    def committed(self) -> int:
        """Last seqno known flushed to storage (0 = nothing)."""
        return self._committed

    def checkpoint(self, seqno: int) -> None:
        """Advance the storage high-water mark; periodically drop fully-
        covered segments. This runs once per group commit, so it stays
        cheap: no fsync (the checkpoint is an optimization hint -- a stale
        or torn one after a crash only means extra idempotent replay, never
        loss) and segment GC is amortized."""
        with self._lock:
            if seqno <= self._committed:
                return
            self._committed = seqno
            path = os.path.join(self.directory, _CHECKPOINT_FILE)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(seqno))
            os.replace(tmp, path)
            if self._rotated_since_gc:
                self._rotated_since_gc = False
                self._gc(seqno)

    def _gc(self, committed: int) -> None:
        segments = self._segments()
        current = os.path.join(
            self.directory, os.path.basename(self._file.name)
        )
        for path, next_path in zip(segments, segments[1:]):
            if path == current:
                continue
            next_first = _segment_first_seqno(os.path.basename(next_path))
            # every record in `path` has seqno < next_first; fully committed
            # segments are dead weight
            if next_first is not None and next_first - 1 <= committed:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def replay(self):
        """Yield ``(seqno, payload)`` for every record past the checkpoint,
        in seqno order. Safe against torn tails; duplicate delivery is
        possible (crash between storage flush and checkpoint), so consumers
        must apply records idempotently."""
        committed = self.committed()
        for path in self._segments():
            for seqno, payload in _scan_segment(path):
                if seqno > committed:
                    yield seqno, payload

    def pending(self) -> int:
        """Count of un-checkpointed records on disk (replay cost estimate)."""
        return sum(1 for _ in self.replay())

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()
                if self.fsync_policy != "never":
                    os.fsync(self._file.fileno())
                self._file.close()
                self._file = None


class PartitionedWal:
    """P independent :class:`WriteAheadLog` streams under one root.

    Each partition is a COMPLETE log -- own seqno space, own segments,
    own checkpoint, own group-commit fsync stream -- so P writer threads
    fsync in parallel with zero shared write state, and replay/durability
    invariants (R003: fsync before cursor) hold per partition with no
    cross-partition protocol at all. Routing (which entity goes to which
    partition) is the caller's job via ``utils.stablehash``; this class
    only owns the layout.

    P = 1 opens one inner log rooted at ``directory`` itself: the on-disk
    bytes are identical to a plain :class:`WriteAheadLog`, old flat logs
    replay unchanged, and no marker file is written. P > 1 stamps
    ``wal.parts`` FIRST (fsync'd: the marker is the layout's source of
    truth for every later open and for cross-process followers -- a crash
    between subdir creation and an unmarked marker must not make the same
    directory resolve to P=1 on restart).
    """

    def __init__(
        self,
        directory: str,
        partitions: int = 1,
        segment_bytes: int = 64 << 20,
        fsync_policy: str = "always",
        fsync_interval_ms: float = 100.0,
    ):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.partitions = resolve_partitions(directory, partitions)
        if self.partitions > 1:
            self._write_marker(self.partitions)
        self.parts: list[WriteAheadLog] = [
            WriteAheadLog(
                part_dir,
                segment_bytes=segment_bytes,
                fsync_policy=fsync_policy,
                fsync_interval_ms=fsync_interval_ms,
            )
            for part_dir in partition_dirs(directory, self.partitions)
        ]

    def _write_marker(self, partitions: int) -> None:
        path = os.path.join(self.directory, _PARTS_FILE)
        try:
            with open(path) as f:
                if int(f.read().strip()) == partitions:
                    return
        except (OSError, ValueError):
            pass
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(partitions))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # the marker is the layout's source of truth: without a directory
        # fsync the new entry itself can vanish at a power cut, and a
        # restarted reader would resolve a different partition count
        _fsync_dir(self.directory)

    def part(self, index: int) -> WriteAheadLog:
        return self.parts[index]

    def part_dirs(self) -> list[str]:
        return partition_dirs(self.directory, self.partitions)

    # -- aggregate observability (mirrors WriteAheadLog's counters so the
    # -- event server's scrape hook works against either) -------------------
    @property
    def append_count(self) -> int:
        return sum(p.append_count for p in self.parts)

    @property
    def fsync_count(self) -> int:
        return sum(p.fsync_count for p in self.parts)

    @property
    def last_fsync_s(self) -> float:
        return max((p.last_fsync_s for p in self.parts), default=0.0)

    def pending(self) -> int:
        return sum(p.pending() for p in self.parts)

    def close(self) -> None:
        for p in self.parts:
            p.close()
