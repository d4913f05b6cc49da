"""Fixed-slot shared-memory message rings + eventfd/FIFO wakeups.

The IPC substrate of the multi-process serving tier: each frontend worker
shares ONE mmap'd ring file with the scorer process, holding two
single-producer/single-consumer message rings (requests: worker -> scorer;
completions: scorer -> worker), a seqlock-guarded stats region the worker
publishes its metrics snapshot through, and a small header (generation,
worker state) the supervisor uses to track respawns.

Design points:

- **Fixed slots, monotonic counters.** Each ring is ``slots`` slots of
  ``slot_bytes``; ``head``/``tail`` are free-running u64 sequence numbers
  (slot index = seq % slots), so full/empty tests are plain subtraction
  and a torn counter can never alias a wrapped ring. The producer writes
  the slot payload FIRST and publishes by storing ``head`` after -- on
  x86-64 (TSO: stores are not reordered with earlier stores, loads not
  reordered with earlier loads) that is release/acquire for free. Each
  side's in-process callers serialize with their own ``threading.Lock``;
  the cross-process contract is strictly SPSC.
- **Oversize spill.** A message that does not fit a slot (large query
  body, big response page) spills to a one-off file next to the ring and
  the slot carries only the file name -- the ring never blocks on or
  fragments for a rare large payload. The consumer unlinks the spill.
- **Futex-style wakeups.** Blocking "ring has work" waits ride an
  ``eventfd`` (inherited across the spawn via ``pass_fds``; one fd, both
  directions of ownership work because eventfd is just a kernel counter)
  with a named-FIFO fallback for platforms without ``os.eventfd``. Waits
  always carry a timeout: a lost wakeup degrades to one poll interval,
  never a hang.

Durability is explicitly NOT a goal (unlike ``data/wal.py``): rings hold
in-flight RPCs whose clients are waiting on open sockets; a crash loses
exactly the in-flight window and nothing else.

Port copy: ``predictionio_tpu/serving/shmring.py`` (framework-free), verbatim,
under the port's package name, but for one line; ``tests/test_torch_imports.py``
holds it to the original. ``MessageRing._set`` stores a counter with one
8-byte write through a ``memoryview`` (native byte order, little-endian on
x86-64 and aarch64), where the original's ``struct.pack_into`` first zeroes
the field and then writes it. A process polling the other side's counter
could read the zero: a consumer's tail read as 0 made the producer see a
full ring and answer 429 with one request in flight, and a producer's head
read as 0 made the consumer sleep out a poll interval
(``tests/test_torch_fabric.py::test_ring_counters_read_whole_across_processes``).
"""

from __future__ import annotations

import json
import mmap
import os
import select
import struct

MAGIC = 0x5049_4F52  # "PIOR"
VERSION = 1

#: header field offsets (u32 unless noted)
_OFF_MAGIC = 0
_OFF_VERSION = 4
_OFF_GENERATION = 8     # u64
_OFF_STATE = 16
_OFF_REQ_HEAD = 24      # u64; producer = worker
_OFF_REQ_TAIL = 32      # u64; consumer = scorer
_OFF_CMP_HEAD = 40      # u64; producer = scorer
_OFF_CMP_TAIL = 48      # u64; consumer = worker
_OFF_STATS_SEQ = 56     # u64; seqlock (odd = write in progress)
_OFF_STATS_LEN = 64

HEADER_BYTES = 4096
STATS_BYTES = 65536

#: worker lifecycle states (header ``state`` field)
STATE_INIT = 0
STATE_READY = 1
STATE_DRAINING = 2
STATE_DONE = 3

#: per-slot header: u32 meta_len, u32 body_len, u32 flags
_SLOT_HEADER = struct.Struct("<III")
_FLAG_SPILLED = 1


class RingFull(Exception):
    """Raised by ``push`` when the consumer is ``slots`` messages behind;
    callers map this to backpressure (the frontend's 429)."""


class Wakeup:
    """Cross-process wake signal: eventfd when available, named FIFO else.

    ``create()`` in the parent; the child reconstructs from ``spec()``
    (``fd:N`` specs require the fd in the child's ``pass_fds``). Both
    processes may ``signal()`` and ``wait()`` the same object -- it is a
    counter, not a channel.
    """

    def __init__(self, fd: int | None = None, fifo_path: str | None = None):
        self._fd = fd
        self._fifo_path = fifo_path
        self._fifo_rfd: int | None = None
        self._fifo_wfd: int | None = None
        #: cumulative wake accounting, per PROCESS-LOCAL object (the fd is
        #: shared across the spawn; these counters are not): ``signals`` =
        #: signal() calls issued from this side, ``wakes`` = drain() calls
        #: (each one a real "this side was woken / serviced the fd"
        #: event). The scorer aggregates them into the wakeup-budget
        #: gauges (``pio_scorer_wakeups_per_request``).
        self.signals = 0
        self.wakes = 0

    @classmethod
    def create(cls, fifo_dir: str, name: str) -> "Wakeup":
        if hasattr(os, "eventfd"):
            fd = os.eventfd(0, os.EFD_NONBLOCK)
            os.set_inheritable(fd, True)
            return cls(fd=fd)
        path = os.path.join(fifo_dir, f"{name}.fifo")
        os.mkfifo(path)
        return cls(fifo_path=path)

    def spec(self) -> str:
        if self._fd is not None:
            return f"fd:{self._fd}"
        return f"fifo:{self._fifo_path}"

    @classmethod
    def from_spec(cls, spec: str) -> "Wakeup":
        kind, _, rest = spec.partition(":")
        if kind == "fd":
            return cls(fd=int(rest))
        if kind == "fifo":
            return cls(fifo_path=rest)
        raise ValueError(f"bad wakeup spec {spec!r}")

    @property
    def pass_fd(self) -> int | None:
        """The fd a spawner must include in ``pass_fds`` (eventfd only)."""
        return self._fd

    def _read_fd(self) -> int:
        if self._fd is not None:
            return self._fd
        if self._fifo_rfd is None:
            self._fifo_rfd = os.open(
                self._fifo_path, os.O_RDONLY | os.O_NONBLOCK
            )
        return self._fifo_rfd

    def signal(self) -> None:
        self.signals += 1
        try:
            if self._fd is not None:
                os.write(self._fd, struct.pack("<Q", 1))
                return
            if self._fifo_wfd is None:
                # O_NONBLOCK open fails with ENXIO until a reader exists;
                # the reader's timeout covers the pre-open window
                self._fifo_wfd = os.open(
                    self._fifo_path, os.O_WRONLY | os.O_NONBLOCK
                )
            os.write(self._fifo_wfd, b"\x01")
        except (BlockingIOError, FileNotFoundError, OSError):
            # a saturated counter/pipe still wakes the reader; a missing
            # reader will poll on its own timeout
            pass

    def wait(self, timeout: float) -> bool:
        """Block up to ``timeout`` for a signal; drains the counter."""
        try:
            fd = self._read_fd()
            ready, _, _ = select.select([fd], [], [], timeout)
            if not ready:
                return False
            self.drain()
            return True
        except OSError:
            return False

    def drain(self) -> None:
        self.wakes += 1
        try:
            fd = self._read_fd()
            while True:
                if not os.read(fd, 4096):
                    return
        except (BlockingIOError, OSError):
            return

    def fileno(self) -> int:
        return self._read_fd()

    def close(self) -> None:
        for fd in (self._fd, self._fifo_rfd, self._fifo_wfd):
            if fd is not None:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._fd = self._fifo_rfd = self._fifo_wfd = None


class MessageRing:
    """One direction of the ring: SPSC, fixed slots, JSON meta + raw body."""

    def __init__(
        self,
        mm: mmap.mmap,
        head_off: int,
        tail_off: int,
        data_off: int,
        slots: int,
        slot_bytes: int,
        spill_dir: str,
        name: str,
    ):
        self._mm = mm
        self._head_off = head_off
        self._tail_off = tail_off
        self._data_off = data_off
        self._slots = slots
        self._slot_bytes = slot_bytes
        self._spill_dir = spill_dir
        self._name = name

    def _get(self, off: int) -> int:
        return struct.unpack_from("<Q", self._mm, off)[0]

    def _set(self, off: int, value: int) -> None:
        memoryview(self._mm)[off:off + 8].cast("Q")[0] = value

    def pending(self) -> int:
        return self._get(self._head_off) - self._get(self._tail_off)

    def push(self, meta: dict, body: bytes = b"") -> None:
        """Publish one message; raises :class:`RingFull` when the consumer
        is a full ring behind (the backpressure signal)."""
        head = self._get(self._head_off)
        if head - self._get(self._tail_off) >= self._slots:
            raise RingFull(self._name)
        data = json.dumps(meta, separators=(",", ":")).encode("utf-8")
        flags = 0
        if _SLOT_HEADER.size + len(data) + len(body) > self._slot_bytes:
            # oversize: the whole message moves to a one-off spill file,
            # the slot carries only its name (unique per sequence number)
            fname = f"{self._name}-{head}.spill"
            with open(os.path.join(self._spill_dir, fname), "wb") as f:
                f.write(struct.pack("<I", len(data)))
                f.write(data)
                f.write(body)
            data = json.dumps({"_spill": fname}).encode("utf-8")
            body = b""
            flags = _FLAG_SPILLED
        off = self._data_off + (head % self._slots) * self._slot_bytes
        _SLOT_HEADER.pack_into(self._mm, off, len(data), len(body), flags)
        off += _SLOT_HEADER.size
        self._mm[off:off + len(data)] = data
        off += len(data)
        self._mm[off:off + len(body)] = body
        # publish AFTER the payload: the store ordering is the fence
        self._set(self._head_off, head + 1)

    def pop(self) -> tuple[dict, bytes] | None:
        tail = self._get(self._tail_off)
        if tail >= self._get(self._head_off):
            return None
        off = self._data_off + (tail % self._slots) * self._slot_bytes
        meta_len, body_len, flags = _SLOT_HEADER.unpack_from(self._mm, off)
        off += _SLOT_HEADER.size
        meta = json.loads(bytes(self._mm[off:off + meta_len]))
        body = bytes(self._mm[off + meta_len:off + meta_len + body_len])
        self._set(self._tail_off, tail + 1)
        if flags & _FLAG_SPILLED:
            path = os.path.join(self._spill_dir, meta["_spill"])
            with open(path, "rb") as f:
                blob = f.read()
            os.unlink(path)
            (meta_len,) = struct.unpack_from("<I", blob, 0)
            meta = json.loads(blob[4:4 + meta_len])
            body = blob[4 + meta_len:]
        return meta, body


class RingFile:
    """The per-worker shared file: header + stats + request/completion
    rings. ``create`` (re)initializes -- truncating any carcass from a
    killed worker -- and ``attach`` maps an existing file read-write."""

    def __init__(self, path: str, mm: mmap.mmap, fileobj):
        self.path = path
        self._mm = mm
        self._file = fileobj
        slots = struct.unpack_from("<I", mm, HEADER_BYTES - 8)[0]
        slot_bytes = struct.unpack_from("<I", mm, HEADER_BYTES - 4)[0]
        spill_dir = os.path.dirname(os.path.abspath(path))
        name = os.path.splitext(os.path.basename(path))[0]
        req_off = HEADER_BYTES + STATS_BYTES
        cmp_off = req_off + slots * slot_bytes
        self.requests = MessageRing(
            mm, _OFF_REQ_HEAD, _OFF_REQ_TAIL, req_off,
            slots, slot_bytes, spill_dir, f"{name}-req",
        )
        self.completions = MessageRing(
            mm, _OFF_CMP_HEAD, _OFF_CMP_TAIL, cmp_off,
            slots, slot_bytes, spill_dir, f"{name}-cmp",
        )
        self.slots = slots
        self.slot_bytes = slot_bytes

    @classmethod
    def create(
        cls, path: str, slots: int, slot_bytes: int, generation: int
    ) -> "RingFile":
        size = HEADER_BYTES + STATS_BYTES + 2 * slots * slot_bytes
        # O_TRUNC via "wb": a respawn over a dead worker's file starts
        # from zeroed counters; the old process's mapping (if any) now
        # points at the orphaned inode and cannot corrupt this one
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.truncate(size)
        os.replace(tmp, path)
        f = open(path, "r+b")
        try:
            mm = mmap.mmap(f.fileno(), size)
            struct.pack_into("<I", mm, _OFF_MAGIC, MAGIC)
            struct.pack_into("<I", mm, _OFF_VERSION, VERSION)
            struct.pack_into("<Q", mm, _OFF_GENERATION, generation)
            struct.pack_into("<I", mm, _OFF_STATE, STATE_INIT)
            struct.pack_into("<I", mm, HEADER_BYTES - 8, slots)
            struct.pack_into("<I", mm, HEADER_BYTES - 4, slot_bytes)
            return cls(path, mm, f)
        except BaseException:
            # a failed map/header init must not strand the descriptor on
            # the supervisor's respawn loop (pio check R001)
            f.close()
            raise

    @classmethod
    def attach(cls, path: str) -> "RingFile":
        f = open(path, "r+b")
        size = os.fstat(f.fileno()).st_size
        mm = mmap.mmap(f.fileno(), size)
        if struct.unpack_from("<I", mm, _OFF_MAGIC)[0] != MAGIC:
            mm.close()
            f.close()
            raise ValueError(f"{path}: not a pio ring file")
        return cls(path, mm, f)

    # -- header fields ------------------------------------------------------
    @property
    def generation(self) -> int:
        return struct.unpack_from("<Q", self._mm, _OFF_GENERATION)[0]

    @property
    def state(self) -> int:
        return struct.unpack_from("<I", self._mm, _OFF_STATE)[0]

    def set_state(self, state: int) -> None:
        struct.pack_into("<I", self._mm, _OFF_STATE, state)

    # -- stats region (worker-published metrics snapshot) -------------------
    def write_stats(self, obj: dict) -> None:
        """Seqlock write: readers retry while ``seq`` is odd or changed
        under them; a SIGKILL mid-write leaves an odd seq that readers
        permanently skip (they fall back to 'no stats')."""
        data = json.dumps(obj, separators=(",", ":")).encode("utf-8")
        if len(data) > STATS_BYTES:
            return  # a pathological label explosion must not crash serving
        seq = struct.unpack_from("<Q", self._mm, _OFF_STATS_SEQ)[0]
        struct.pack_into("<Q", self._mm, _OFF_STATS_SEQ, seq + 1)  # odd
        self._mm[HEADER_BYTES:HEADER_BYTES + len(data)] = data
        struct.pack_into("<I", self._mm, _OFF_STATS_LEN, len(data))
        struct.pack_into("<Q", self._mm, _OFF_STATS_SEQ, seq + 2)  # even

    def read_stats(self) -> dict | None:
        for _ in range(8):
            seq0 = struct.unpack_from("<Q", self._mm, _OFF_STATS_SEQ)[0]
            if seq0 == 0 or seq0 % 2:
                return None
            length = struct.unpack_from("<I", self._mm, _OFF_STATS_LEN)[0]
            data = bytes(self._mm[HEADER_BYTES:HEADER_BYTES + length])
            if struct.unpack_from("<Q", self._mm, _OFF_STATS_SEQ)[0] == seq0:
                try:
                    return json.loads(data)
                except ValueError:
                    return None
        return None

    def close(self) -> None:
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass
        self._file.close()
