"""Runtime resource-lifecycle watcher: the R-series' reality check.

Port of ``predictionio_tpu/analysis/leakwatch.py``: it hooks the port's
``predictionio_tpu_torch.obs.trace.Span`` and the semaphores that
``predictionio_tpu_torch`` modules build, never the JAX package's.

The static R001/R002 rules reason about exception edges and call-graph
credit; this module records what tests ACTUALLY leak. ``install()``
wraps two protocols:

- **spans** (R002's runtime half): ``obs.trace.Span`` construction and
  ``finish`` are wrapped so every live-but-unfinished span is known.
  The shared sentinels (``NULL_SPAN``, ``SAMPLED_OUT_ROOT``) are
  separate classes and never tracked; ``finish`` is idempotent, so a
  double finish unregisters once.
- **permits** (R001/R004's runtime half): ``threading.Semaphore`` /
  ``BoundedSemaphore`` constructed from predictionio_tpu_torch modules
  (decided by one caller-frame peek at construction, exactly
  lockwatch's policy -- stdlib-internal semaphores stay untouched)
  return a thin wrapper counting successful acquires vs releases per
  instance, keyed by construction site.

A test hook snapshots both ledgers around every test and fails the test
that ended with a NEW unfinished span or a net permit debt -- after a
short settle loop, because service teardown legitimately finishes a
straggler span a few milliseconds after the test body returns. Leaks
of this kind are recorded, never raised mid-flight (failing inside
arbitrary span/semaphore paths would turn a diagnosis into a
heisenbug).

Under this repo's pytest the reference's leakwatch already wraps the
port's semaphores for the whole session (``tests/conftest.py``; its
prefix covers this package), but not the port's spans, which are
another class. So the port's test files that start spans install this
watch with ``install(semaphores=False)`` from autouse fixtures of their
own: wrapping ``threading.Semaphore`` a second time in one process
would file every port semaphore under this module's site.
``PIO_LEAKWATCH=0`` opts out; never enabled in production servers --
the wrappers cost a dict hit per span/permit operation.
"""

from __future__ import annotations

import sys
import threading
import time
import weakref


class LeakWatch:
    """Live-obligation ledgers. One global instance backs ``install()``;
    tests can build private instances and wrap objects explicitly."""

    def __init__(self):
        self._mutex = threading.Lock()
        #: id(span) -> span (strong ref: a leaked span must not be
        #: garbage-collected out of the evidence)
        self._live_spans: dict = {}
        #: ledger key -> [weakref(sem), site, acquired, released]; keys
        #: are a monotonic serial, never id() -- CPython reuses ids
        #: after GC, and a reused key would let a new semaphore's debt
        #: net against a dead one's snapshot
        self._sems: dict = {}
        self._next_serial = 0

    # -- spans --------------------------------------------------------------
    def note_span_started(self, span) -> None:
        with self._mutex:
            self._live_spans[id(span)] = span

    def note_span_finished(self, span) -> None:
        with self._mutex:
            self._live_spans.pop(id(span), None)

    def pending_spans(self) -> list:
        """Live unfinished spans, oldest first."""
        with self._mutex:
            return list(self._live_spans.values())

    def span_snapshot(self) -> set:
        with self._mutex:
            return set(self._live_spans)

    def new_pending_spans(self, before: set) -> list:
        with self._mutex:
            return [
                s for k, s in self._live_spans.items() if k not in before
            ]

    # -- permits ------------------------------------------------------------
    def wrap_semaphore(self, sem, site: str) -> "_WatchedSemaphore":
        wrapped = _WatchedSemaphore(sem, site, self)
        with self._mutex:
            self._next_serial += 1
            wrapped._serial = self._next_serial
            self._sems[wrapped._serial] = [weakref.ref(wrapped), site, 0, 0]
        return wrapped

    def _note_acquired(self, wrapped, n: int = 1) -> None:
        with self._mutex:
            rec = self._sems.get(wrapped._serial)
            if rec is not None:
                rec[2] += n

    def _note_released(self, wrapped, n: int = 1) -> None:
        with self._mutex:
            rec = self._sems.get(wrapped._serial)
            if rec is not None:
                rec[3] += n

    def permit_debts(self) -> dict:
        """site -> net held permits (acquired - released) per LIVE
        watched semaphore; dead instances fall out of the ledger."""
        out: dict = {}
        with self._mutex:
            dead = []
            for key, (ref, site, acq, rel) in self._sems.items():
                if ref() is None:
                    dead.append(key)
                    continue
                out[f"{site}#{key}"] = acq - rel
            for key in dead:
                self._sems.pop(key, None)
        return out

    @staticmethod
    def new_debts(before: dict, after: dict) -> dict:
        """Semaphores whose net held count GREW over a test (new
        instances count from zero)."""
        return {
            key: held - before.get(key, 0)
            for key, held in after.items()
            if held - before.get(key, 0) > 0
        }


class _WatchedSemaphore:
    """Duck-types a semaphore; successful acquires and every release
    are charged to the ledger."""

    def __init__(self, real, site: str, watch: LeakWatch):
        self._real = real
        self.site = site
        self._watch = watch
        self._serial = 0  # assigned by wrap_semaphore

    def acquire(self, *args, **kwargs):
        got = self._real.acquire(*args, **kwargs)
        if got:
            self._watch._note_acquired(self)
        return got

    def release(self, n: int = 1):
        self._real.release(n)
        self._watch._note_released(self, n)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        return getattr(self._real, name)


_GLOBAL = LeakWatch()
_REAL_SEMAPHORE = None
_REAL_BOUNDED = None
_REAL_SPAN_INIT = None
_REAL_SPAN_FINISH = None


def global_watch() -> LeakWatch:
    return _GLOBAL


def enabled_default() -> bool:
    """The conftest gate: on unless ``PIO_LEAKWATCH=0`` opts out."""
    import os

    return os.environ.get("PIO_LEAKWATCH", "1") != "0"


def _watched_site() -> str | None:
    """Construction site of the semaphore two frames up; only
    predictionio_tpu_torch's own semaphores are wrapped (the JAX
    package's stay untouched)."""
    try:
        frame = sys._getframe(2)
    except ValueError:
        return None
    mod = frame.f_globals.get("__name__", "")
    if (mod == "predictionio_tpu_torch"
            or mod.startswith("predictionio_tpu_torch.")) and (
            mod != __name__):
        return f"{mod}:{frame.f_lineno}"
    return None


def install(semaphores: bool = True) -> None:
    """Wrap ``Span`` lifecycle and, unless ``semaphores`` is false,
    package-constructed semaphores. Idempotent; ``uninstall()``
    restores."""
    global _REAL_SEMAPHORE, _REAL_BOUNDED, _REAL_SPAN_INIT, _REAL_SPAN_FINISH
    if _REAL_SPAN_INIT is not None:
        return
    from predictionio_tpu_torch.obs import trace

    _REAL_SPAN_INIT = trace.Span.__init__
    _REAL_SPAN_FINISH = trace.Span.finish

    real_init = _REAL_SPAN_INIT
    real_finish = _REAL_SPAN_FINISH

    def span_init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        _GLOBAL.note_span_started(self)

    def span_finish(self):
        real_finish(self)
        _GLOBAL.note_span_finished(self)

    trace.Span.__init__ = span_init
    trace.Span.finish = span_finish
    if not semaphores:
        return

    _REAL_SEMAPHORE = threading.Semaphore
    _REAL_BOUNDED = threading.BoundedSemaphore
    real_sem, real_bounded = _REAL_SEMAPHORE, _REAL_BOUNDED

    def make_semaphore(value: int = 1):
        site = _watched_site()
        real = real_sem(value)
        return _GLOBAL.wrap_semaphore(real, site) if site else real

    def make_bounded(value: int = 1):
        site = _watched_site()
        real = real_bounded(value)
        return _GLOBAL.wrap_semaphore(real, site) if site else real

    threading.Semaphore = make_semaphore
    threading.BoundedSemaphore = make_bounded


def uninstall() -> None:
    global _REAL_SEMAPHORE, _REAL_BOUNDED, _REAL_SPAN_INIT, _REAL_SPAN_FINISH
    if _REAL_SPAN_INIT is None:
        return
    from predictionio_tpu_torch.obs import trace

    trace.Span.__init__ = _REAL_SPAN_INIT
    trace.Span.finish = _REAL_SPAN_FINISH
    if _REAL_SEMAPHORE is not None:
        threading.Semaphore = _REAL_SEMAPHORE
        threading.BoundedSemaphore = _REAL_BOUNDED
    _REAL_SEMAPHORE = _REAL_BOUNDED = None
    _REAL_SPAN_INIT = _REAL_SPAN_FINISH = None


def installed() -> bool:
    return _REAL_SPAN_INIT is not None


def settle(check, timeout_s: float = 1.0, interval_s: float = 0.02):
    """Re-evaluate ``check()`` (a callable returning the offending
    leaks) until it comes back empty or the timeout expires: service
    teardown may finish a straggler span / return a parked permit a few
    milliseconds after the test body ends. Returns the last result."""
    deadline = time.monotonic() + timeout_s
    result = check()
    while result and time.monotonic() < deadline:
        time.sleep(interval_s)
        result = check()
    return result
