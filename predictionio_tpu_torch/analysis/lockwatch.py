"""Runtime lock-order watcher: C001's reality check, C006's witness.

Port of ``predictionio_tpu/analysis/lockwatch.py``: it watches the locks
that ``predictionio_tpu_torch`` modules build, never the JAX package's.

The static C001/C006 rules reason about lexical nesting and call-graph
paths; this module records what threads ACTUALLY do. Beyond order edges,
every acquisition records the lockset HELD at that moment (``held_at``),
and ``runtime_witness()`` renders what tier-1 observed at the lock sites
a static C006 race finding names -- or their absence -- so the repo-wide
gate can attach runtime evidence to a static report. ``install()`` replaces
``threading.Lock``/``threading.RLock`` with factories that hand
predictionio_tpu_torch code (decided by the caller's module at construction
time -- one frame peek per ``Lock()``, no ``sys.settrace``) a thin wrapper.
Every acquisition while other watched locks are held records an order edge
``(held_site -> acquired_site)``; observing both ``A -> B`` and ``B -> A``
-- from any pair of threads, without needing the timing to actually
deadlock -- is an inversion.

Lock identity is the CONSTRUCTION SITE (``module:lineno``), not the
instance: two instances of the same class's ``self._lock`` share a site,
so per-instance locks validate the class-level ordering policy the static
rule checks. Inversions are recorded, never raised mid-acquire (failing
inside arbitrary lock paths would turn a diagnosis into a heisenbug);
whoever installs the watch fails the run that produced one.

Never enabled in production servers -- the wrapper costs a dict hit per
acquire. Under this repo's pytest the reference's lockwatch is already
installed for the whole session (``tests/conftest.py``) and its prefix
covers this package's locks too; installing this one in the same
process would wrap every lock twice, so the port's tests install it in
a subprocess or use private ``LockWatch()`` instances.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field


@dataclass
class Inversion:
    first: tuple[str, str]   # the edge seen earlier (site_a -> site_b)
    second: tuple[str, str]  # the contradicting edge
    thread: str
    detail: str = ""


@dataclass
class LockWatch:
    """Edge registry. One global instance backs ``install()``; tests can
    build private instances and wrap locks explicitly via ``wrap()``."""

    #: (site_a, site_b) -> thread name that first recorded the edge
    edges: dict = field(default_factory=dict)
    inversions: list = field(default_factory=list)
    #: site -> set of frozensets: every distinct lockset observed HELD at
    #: an acquisition of that site (the empty frozenset = acquired bare).
    #: This is the runtime half of C006: a static disjoint-lockset race
    #: finding can cite what locks tier-1 actually held at the sites in
    #: question -- or their absence.
    held_at: dict = field(default_factory=dict)
    _state: threading.local = field(default_factory=threading.local)
    _mutex: threading.Lock = field(default_factory=threading.Lock)

    def _held(self) -> list:
        held = getattr(self._state, "held", None)
        if held is None:
            held = self._state.held = []
        return held

    def note_acquired(self, lock: "_WatchedLock") -> None:
        held = self._held()
        for entry in held:
            if entry[0] is lock:
                entry[1] += 1  # reentrant re-acquire: no new edges
                return
        new_edges = []
        for entry in held:
            a, b = entry[0].site, lock.site
            if a != b:
                new_edges.append((a, b))
        held_sites = frozenset(e[0].site for e in held)
        held.append([lock, 1])
        # racy membership pre-check (GIL-safe): the steady state -- this
        # site already observed with this held-set, no new edges -- pays
        # no mutex at all, so watched locks stay near-transparent
        known = self.held_at.get(lock.site)
        need_record = known is None or held_sites not in known
        if not new_edges and not need_record:
            return
        with self._mutex:
            if need_record:
                self.held_at.setdefault(lock.site, set()).add(held_sites)
            if not new_edges:
                return
            for a, b in new_edges:
                self.edges.setdefault((a, b), threading.current_thread().name)
                if (b, a) in self.edges:
                    self.inversions.append(Inversion(
                        first=(b, a), second=(a, b),
                        thread=threading.current_thread().name,
                        detail=(
                            f"{a} -> {b} (thread "
                            f"{threading.current_thread().name}) contradicts "
                            f"{b} -> {a} (thread {self.edges[(b, a)]})"
                        ),
                    ))

    def note_released(self, lock: "_WatchedLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                held[i][1] -= 1
                if held[i][1] <= 0:
                    del held[i]
                return

    def wrap(self, real_lock, site: str) -> "_WatchedLock":
        return _WatchedLock(real_lock, site, self)

    def runtime_witness(self, sites: "list[str]") -> str:
        """What the run actually observed at the given lock construction
        sites (``module:lineno``): exact site first, tolerating a +/-2
        line drift between the static declaration line and the runtime
        construction frame (multi-line assignments) -- never the whole
        module, which would present other locks' acquisitions as
        evidence for this one. Used by the tier-1 gate to annotate C006
        findings with runtime evidence -- or its absence."""
        if not sites:
            return "no lock sites to witness"
        with self._mutex:
            snapshot = {k: set(v) for k, v in self.held_at.items()}
        parts = []
        for site in sites:
            module, _, line_s = site.rpartition(":")
            hits = {k: v for k, v in snapshot.items() if k == site}
            if not hits and line_s.isdigit():
                line = int(line_s)
                hits = {
                    k: v for k, v in snapshot.items()
                    if k.rsplit(":", 1)[0] == module
                    and k.rsplit(":", 1)[1].isdigit()
                    and abs(int(k.rsplit(":", 1)[1]) - line) <= 2
                }
            if not hits:
                parts.append(f"{site}: never acquired under lockwatch")
                continue
            for k, locksets in sorted(hits.items()):
                rendered = sorted(
                    "{" + ", ".join(sorted(ls)) + "}" if ls else "{}"
                    for ls in locksets
                )
                parts.append(f"{k}: acquired holding {', '.join(rendered)}")
        return "; ".join(parts)


class _WatchedLock:
    """Duck-types a lock: acquire/release/locked/context manager; anything
    else (Condition's ``_is_owned`` etc.) delegates to the real lock."""

    def __init__(self, real, site: str, watch: LockWatch):
        self._real = real
        self.site = site
        self._watch = watch

    def acquire(self, *args, **kwargs):
        got = self._real.acquire(*args, **kwargs)
        if got:
            self._watch.note_acquired(self)
        return got

    def release(self):
        self._real.release()
        self._watch.note_released(self)

    def locked(self):
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        return getattr(self._real, name)


_GLOBAL = LockWatch()
_REAL_LOCK = None
_REAL_RLOCK = None


def global_watch() -> LockWatch:
    return _GLOBAL


def _watched_module() -> str | None:
    """The module of the frame constructing the lock; only
    predictionio_tpu_torch's own locks are wrapped (stdlib
    queue/logging/etc. and the JAX package keep real locks untouched)."""
    try:
        mod = sys._getframe(2).f_globals.get("__name__", "")
    except ValueError:
        return None
    if (mod == "predictionio_tpu_torch"
            or mod.startswith("predictionio_tpu_torch.")) and (
            mod != __name__):
        frame = sys._getframe(2)
        return f"{mod}:{frame.f_lineno}"
    return None


def install() -> None:
    """Patch ``threading.Lock``/``RLock`` so locks constructed by
    predictionio_tpu_torch are watched. Idempotent; ``uninstall()``
    restores."""
    global _REAL_LOCK, _REAL_RLOCK
    if _REAL_LOCK is not None:
        return
    _REAL_LOCK = threading.Lock
    _REAL_RLOCK = threading.RLock

    def make_lock():
        site = _watched_module()
        real = _REAL_LOCK()
        return _GLOBAL.wrap(real, site) if site else real

    def make_rlock():
        site = _watched_module()
        real = _REAL_RLOCK()
        return _GLOBAL.wrap(real, site) if site else real

    threading.Lock = make_lock
    threading.RLock = make_rlock


def uninstall() -> None:
    global _REAL_LOCK, _REAL_RLOCK
    if _REAL_LOCK is None:
        return
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    _REAL_LOCK = _REAL_RLOCK = None


def installed() -> bool:
    return _REAL_LOCK is not None
