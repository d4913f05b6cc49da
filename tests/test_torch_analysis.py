"""The port's ``pio check`` (``predictionio_tpu_torch/analysis/``) on the
CPU, held to the reference's (``predictionio_tpu/analysis/``).

The reference's own rule-engine tests, run against the port's engine:
every C, R and P rule fires on its seeded bug pattern and stays silent
on the corrected form, the whole-program core (call graph, thread
roles, locksets) resolves its fixture shapes, the lockwatch detector
catches a seeded acquisition-order inversion and records held
locksets, the baseline machinery ratchets, the docstring-driven catalog
(``docs/static_analysis_torch.md``) stays in sync, SARIF round-trips,
``--changed`` stays inside its 2 s budget, and the pre-commit entry
scopes to the changed files. Beside them:

- the differential test: the reference's engine and the port's sweep
  ``predictionio_tpu_torch/`` with no baseline and give the same
  findings, ``(rule_id, severity, path, line, symbol)`` and message,
  and the reference's J and S families, which the port does not carry,
  find nothing there;
- the gate: over the port, with its baseline, zero unsuppressed
  findings, nothing stale, and every P, R001 and R003 entry names a port
  test that exists;
- ``pio check`` in a fresh process leaves ``torch`` and ``jax`` out of
  ``sys.modules``; a J or S rule id and ``--mesh-report`` exit 2;
  ``--changed`` keeps only files under ``predictionio_tpu_torch/``.

The port's ``lockwatch.install()`` runs in a fresh interpreter: this
pytest run installs the reference's watch (``tests/conftest.py``), whose prefix
covers the port's locks too.
"""

import ast
import json
import os
import re
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from predictionio_tpu_torch.analysis import (
    Finding,
    apply_baseline,
    check_paths,
    load_baseline,
    parse_source,
    self_check,
)
from predictionio_tpu_torch.analysis import lockwatch
from predictionio_tpu_torch.analysis.packageindex import PackageIndex
from predictionio_tpu_torch.analysis.rules_concurrency import (
    RuleC001,
    RuleC002,
    RuleC004,
    RuleC005,
    RuleC006,
)
from predictionio_tpu_torch.analysis.rules_protocol import (
    RuleP001,
    RuleP002,
    RuleP003,
    RuleP004,
    RuleP005,
)
from predictionio_tpu_torch.analysis.rules_resources import (
    RuleR001,
    RuleR002,
    RuleR003,
    RuleR004,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_rule(rule_cls, src: str, path: str = "predictionio_tpu_torch/pkg/mod.py"):
    ctx = parse_source(textwrap.dedent(src), path)
    return list(rule_cls().check(ctx))


def build_index(*sources, paths=None):
    """PackageIndex over several in-memory modules (cross-module fixtures)."""
    paths = paths or [
        f"predictionio_tpu_torch/pkg/mod{i}.py" for i in range(len(sources))
    ]
    ctxs = [
        parse_source(textwrap.dedent(src), path)
        for src, path in zip(sources, paths)
    ]
    return PackageIndex.build(ctxs)


def _fresh_python(code: str, timeout: float = 120.0) -> str:
    """Run ``code`` in a fresh interpreter at the repo root; its stdout."""
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO,
        capture_output=True, text=True, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


# -- the phase-2 core: call graph ---------------------------------------------

class TestCallGraph:
    def test_resolves_methods_functions_partial_and_lambda(self):
        index = build_index("""
            import functools
            import threading

            def helper():
                pass

            class S:
                def __init__(self):
                    self._t1 = threading.Thread(target=self._run)
                    self._t2 = threading.Thread(
                        target=functools.partial(helper, 1)
                    )
                    self._t3 = threading.Thread(target=lambda: helper())

                def _run(self):
                    helper()
        """)
        g = index.graph
        run = g.function_at("predictionio_tpu_torch/pkg/mod0.py", "S._run")
        assert run is not None and run.cls == "S"
        # S._run calls helper (edge resolved)
        callees = [
            t.qual for site in g.callees(run.key) for t in site.targets
        ]
        assert callees == ["helper"]
        # lambda registered as its own node, body edge resolved
        lam = [q for q in g.by_path[run.path].funcs if "<lambda" in q]
        assert len(lam) == 1

    def test_resolves_factory_returned_def(self):
        # the jit(make_step(...)) shape _JitIndex parses
        index = build_index("""
            def make_step(cfg):
                def step(batch):
                    return batch
                return step

            def build(jit):
                return jit(make_step(None))
        """)
        g = index.graph
        build_fn = g.function_at("predictionio_tpu_torch/pkg/mod0.py", "build")
        refs = g.resolve_callable(
            build_fn, g.callees(build_fn.key)[0].call.args[0]
        )
        assert [r.qual for r in refs] == ["make_step.step"]

    def test_cross_module_import_and_attr_type_resolution(self):
        index = build_index(
            """
            class Batcher:
                def submit(self, q):
                    return q
            """,
            """
            from predictionio_tpu_torch.pkg.mod0 import Batcher

            class Service:
                def __init__(self):
                    self._batcher = Batcher()

                def query(self, q):
                    return self._batcher.submit(q)
            """,
        )
        g = index.graph
        query = g.function_at("predictionio_tpu_torch/pkg/mod1.py", "Service.query")
        targets = [
            t.qual for site in g.callees(query.key) for t in site.targets
        ]
        assert "Batcher.submit" in targets

    def test_higher_order_param_and_attr_binding(self):
        # the async serving hand-off shape: a lambda rides a parameter,
        # is published to self.attr, and is finally called through both
        index = build_index("""
            class Service:
                def submit(self, request, on_done):
                    on_done(request)

            class Bridge:
                def __init__(self, async_query):
                    self._async_query = async_query

                def pump(self, msg):
                    self._async_query(msg, lambda r: self._complete(r))

                def _complete(self, response):
                    pass

            def wire():
                service = Service()
                return Bridge(service.submit)
        """)
        g = index.graph
        pump = g.function_at("predictionio_tpu_torch/pkg/mod0.py", "Bridge.pump")
        pump_targets = [
            t.qual for site in g.callees(pump.key) for t in site.targets
        ]
        assert "Service.submit" in pump_targets
        submit = g.function_at("predictionio_tpu_torch/pkg/mod0.py", "Service.submit")
        submit_targets = [
            t.qual for site in g.callees(submit.key) for t in site.targets
        ]
        assert any("<lambda" in t for t in submit_targets)

    def test_annotation_typed_param_resolution(self):
        index = build_index("""
            class Worker:
                def push(self):
                    pass

            class Bridge:
                def deliver(self, w: Worker):
                    w.push()
        """)
        g = index.graph
        deliver = g.function_at("predictionio_tpu_torch/pkg/mod0.py", "Bridge.deliver")
        targets = [
            t.qual for site in g.callees(deliver.key) for t in site.targets
        ]
        assert targets == ["Worker.push"]


# -- the phase-2 core: thread roles -------------------------------------------

_ROLES_SRC = """
    import threading

    class S:
        def __init__(self):
            self._t = threading.Thread(target=self._run)
            self._timer = threading.Timer(1.0, self._tick)

        def _run(self):
            self._shared_helper()

        def _tick(self):
            pass

        def _shared_helper(self):
            pass

        def wire(self, fut):
            fut.add_done_callback(self._on_done)

        def _on_done(self, f):
            pass

    def main():
        S()

    if __name__ == "__main__":
        main()
"""


class TestThreadRoles:
    def test_seeds_and_propagation(self):
        index = build_index(_ROLES_SRC)
        roles = index.roles
        path = "predictionio_tpu_torch/pkg/mod0.py"

        def kinds(qual):
            return {r.kind for r in roles.roles_of((path, qual))}

        assert "thread" in kinds("S._run")
        assert "thread" in kinds("S._shared_helper")   # propagated
        assert "timer" in kinds("S._tick")
        assert "callback" in kinds("S._on_done")
        assert "main" in kinds("main")

    def test_witness_path_reconstructs_chain(self):
        index = build_index(_ROLES_SRC)
        path = "predictionio_tpu_torch/pkg/mod0.py"
        role = next(
            r for r in index.roles.roles_of((path, "S._shared_helper"))
            if r.kind == "thread"
        )
        hops = index.roles.witness_path((path, "S._shared_helper"), role)
        assert hops[0].endswith("S._run")
        assert hops[-1].startswith(path)

    def test_select_loop_seeds_eventloop_role(self):
        index = build_index("""
            import select

            class Loop:
                def serve(self):
                    while True:
                        ready, _, _ = select.select([], [], [], 0.25)
                        self._handle(ready)

                def _handle(self, ready):
                    pass
        """)
        path = "predictionio_tpu_torch/pkg/mod0.py"
        kinds = {
            r.kind for r in index.roles.roles_of((path, "Loop._handle"))
        }
        assert "eventloop" in kinds


# -- the phase-2 core: locksets -----------------------------------------------

class TestLocksets:
    def test_qualified_lock_identity_and_local_regions(self):
        index = build_index("""
            import threading

            class W:
                def __init__(self):
                    self._lock = threading.Lock()

                def work(self):
                    with self._lock:
                        self.x = 1
                    self.y = 2
        """)
        path = "predictionio_tpu_torch/pkg/mod0.py"
        facts = index.locks.facts[(path, "W.work")]
        by_attr = {a.attr: a for a in facts.accesses if a.kind == "write"}
        assert by_attr["x"].held == frozenset({f"{path}:W._lock"})
        assert by_attr["y"].held == frozenset()
        assert index.locks.lock_sites[f"{path}:W._lock"].startswith(
            "predictionio_tpu_torch.pkg.mod0:"
        )

    def test_class_body_lock_declaration_registered(self):
        # `class W: _lock = threading.Lock()` (one lock shared by every
        # instance) must register like phase 1 did: correctly-locked
        # code stays silent instead of racing with "locks: none"
        index = build_index("""
            import threading

            class W:
                _lock = threading.Lock()

                def __init__(self):
                    self.count = 0
                    self._t = threading.Thread(target=self._run)

                def _run(self):
                    with self._lock:
                        self.count += 1

                def submit(self, n):
                    with self._lock:
                        self.count = n
        """)
        path = "predictionio_tpu_torch/pkg/mod0.py"
        assert f"{path}:W._lock" in index.locks.lock_sites
        assert list(RuleC006().check_package(index)) == []

    def test_entry_contexts_join_over_call_paths(self):
        index = build_index("""
            import threading

            class W:
                def __init__(self):
                    self._lock = threading.Lock()

                def outer(self):
                    with self._lock:
                        self._middle()

                def _middle(self):
                    self._leaf()

                def _leaf(self):
                    pass
        """)
        path = "predictionio_tpu_torch/pkg/mod0.py"
        contexts = index.locks.entry_contexts()
        leaf = contexts[(path, "W._leaf")]
        lockset = frozenset({f"{path}:W._lock"})
        assert lockset in leaf
        chain = index.locks.context_chain((path, "W._leaf"), lockset)
        assert any("W.outer" in hop for hop in chain)


# -- C001: lock-order cycles --------------------------------------------------

_C001_BUG = """
    import threading

    class S:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def one(self):
            with self._a:
                with self._b:
                    pass

        def two(self):
            with self._b:
                with self._a:
                    pass
"""


class TestC001:
    def test_fires_on_ab_ba_cycle(self):
        hits = run_rule(RuleC001, _C001_BUG)
        assert [f.rule_id for f in hits] == ["C001"]
        assert "_a" in hits[0].message and "_b" in hits[0].message

    def test_silent_on_consistent_order(self):
        assert run_rule(RuleC001, _C001_BUG.replace(
            "with self._b:\n                with self._a:",
            "with self._a:\n                with self._b:",
        )) == []

    def test_fires_through_one_call_level(self):
        hits = run_rule(RuleC001, """
            import threading

            class S:
                def __init__(self):
                    self._a = threading.Lock()
                    self._b = threading.Lock()

                def outer(self):
                    with self._a:
                        self._inner()

                def _inner(self):
                    with self._b:
                        pass

                def reverse(self):
                    with self._b:
                        with self._a:
                            pass
        """)
        assert [f.rule_id for f in hits] == ["C001"]

    def test_fires_through_deep_cross_function_chain(self):
        # phase 2: the acquisition of B sits TWO frames below the holder
        # of A -- phase 1's one-level propagation missed this
        hits = run_rule(RuleC001, """
            import threading

            class S:
                def __init__(self):
                    self._a = threading.Lock()
                    self._b = threading.Lock()

                def outer(self):
                    with self._a:
                        self._mid()

                def _mid(self):
                    self._inner()

                def _inner(self):
                    with self._b:
                        pass

                def reverse(self):
                    with self._b:
                        with self._a:
                            pass
        """)
        assert [f.rule_id for f in hits] == ["C001"]


# -- C002: blocking I/O under a lock ------------------------------------------

class TestC002:
    def test_fires_on_fsync_under_lock(self):
        hits = run_rule(RuleC002, """
            import os
            import threading

            class W:
                def __init__(self):
                    self._lock = threading.Lock()

                def sync(self, f):
                    with self._lock:
                        f.flush()
                        os.fsync(f.fileno())
        """)
        assert [f.rule_id for f in hits] == ["C002"]
        assert "os.fsync" in hits[0].message

    def test_silent_when_fsync_moved_out(self):
        assert run_rule(RuleC002, """
            import os
            import threading

            class W:
                def __init__(self):
                    self._lock = threading.Lock()

                def sync(self, f):
                    with self._lock:
                        f.flush()
                        fd = os.dup(f.fileno())
                    os.fsync(fd)
                    os.close(fd)
        """) == []

    def test_fires_on_blocking_queue_put_and_sql_under_lock(self):
        hits = run_rule(RuleC002, """
            import threading

            class S:
                def __init__(self, conn):
                    self._lock = threading.Lock()
                    self._queue = __import__("queue").Queue(8)
                    self._conn = conn

                def a(self, item):
                    with self._lock:
                        self._queue.put(item)

                def b(self, sql):
                    with self._lock:
                        self._conn.execute(sql)
        """)
        assert sorted(f.symbol for f in hits) == ["S.a", "S.b"]

    def test_silent_on_nonblocking_queue_ops(self):
        assert run_rule(RuleC002, """
            import threading

            class S:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._queue = __import__("queue").Queue(8)

                def a(self, item):
                    with self._lock:
                        self._queue.put_nowait(item)

                def b(self, item):
                    with self._lock:
                        self._queue.put(item, timeout=0.5)
        """) == []

    def test_fires_on_span_export_under_lock(self):
        """The obs/ policy: ring-buffer appends belong under the tracer
        lock, any span export/flush I/O does not -- an exporter call under
        a lock serializes every instrumented hot path behind its I/O."""
        hits = run_rule(RuleC002, """
            import threading

            class T:
                def __init__(self, exporter):
                    self._lock = threading.Lock()
                    self._exporter = exporter
                    self._spans = []

                def a(self, span):
                    with self._lock:
                        self._exporter.export([span])

                def b(self):
                    with self._lock:
                        self._exporter.force_flush()

                def c(self, tracer):
                    with self._lock:
                        tracer.flush()
        """)
        assert sorted(f.symbol for f in hits) == ["T.a", "T.b", "T.c"]
        assert all("span export" in f.message for f in hits)

    def test_silent_on_file_flush_and_unlocked_export(self):
        """A plain file/stream ``.flush()`` under a lock stays accepted
        (the WAL's buffered-write flush shape), and exports OUTSIDE the
        critical section are the fix shape, not a finding."""
        assert run_rule(RuleC002, """
            import threading

            class T:
                def __init__(self, exporter, f):
                    self._lock = threading.Lock()
                    self._exporter = exporter
                    self._file = f

                def a(self):
                    with self._lock:
                        self._file.flush()

                def b(self, span):
                    with self._lock:
                        batch = [span]
                    self._exporter.export(batch)
        """) == []

    def test_fires_with_witness_path_when_lock_is_frames_up(self):
        # phase 2: the blocking call lives in a helper; every caller
        # holds the lock. The finding lands at the blocking site and
        # reports the acquisition-to-block call path.
        hits = run_rule(RuleC002, """
            import os
            import threading

            class W:
                def __init__(self):
                    self._lock = threading.Lock()

                def sync(self, f):
                    with self._lock:
                        self._rotate(f)

                def _rotate(self, f):
                    self._really_rotate(f)

                def _really_rotate(self, f):
                    os.fsync(f.fileno())
        """)
        assert [f.rule_id for f in hits] == ["C002"]
        assert hits[0].symbol == "W._really_rotate"
        assert "call path:" in hits[0].message
        assert "W.sync" in hits[0].message


# -- C004: fork-after-threads / state inherited across fork -------------------

class TestC004:
    def test_fires_on_os_fork(self):
        hits = run_rule(RuleC004, """
            import os

            def daemonize():
                if os.fork():
                    raise SystemExit(0)
        """)
        assert [f.rule_id for f in hits] == ["C004"]
        assert "os.fork" in hits[0].message

    def test_fires_on_fork_start_method_and_context(self):
        hits = run_rule(RuleC004, """
            import multiprocessing

            def setup():
                multiprocessing.set_start_method("fork")
                return multiprocessing.get_context("fork")
        """)
        assert [f.rule_id for f in hits] == ["C004", "C004"]
        assert all("fork" in f.message for f in hits)

    def test_fires_on_default_context_process(self):
        # bare Process = platform default = fork on Linux: the exact
        # hazard (a batcher flusher's held lock forked into the child)
        hits = run_rule(RuleC004, """
            import multiprocessing

            def launch(target):
                p = multiprocessing.Process(target=target)
                p.start()
                return p
        """)
        assert [f.rule_id for f in hits] == ["C004"]
        assert "platform-default" in hits[0].message

    def test_fires_on_from_import_process(self):
        hits = run_rule(RuleC004, """
            from multiprocessing import Process

            def launch(target):
                return Process(target=target)
        """)
        assert [f.rule_id for f in hits] == ["C004"]

    def test_fires_on_aliased_process_import(self):
        # `import Process as P` must not dodge the rule
        hits = run_rule(RuleC004, """
            from multiprocessing import Process as P

            def launch(target):
                return P(target=target)
        """)
        assert [f.rule_id for f in hits] == ["C004"]

    def test_fires_on_lock_handed_to_child(self):
        # even under spawn, lock/registry state handed across the process
        # boundary diverges silently -- flagged as its own finding
        hits = run_rule(RuleC004, """
            import multiprocessing

            class S:
                def launch(self):
                    ctx = multiprocessing.get_context("spawn")
                    return ctx.Process(
                        target=work, args=(self._lock, self.registry)
                    )
        """)
        assert [f.rule_id for f in hits] == ["C004"]
        assert "process boundary" in hits[0].message

    def test_silent_on_spawn_context_and_subprocess(self):
        # the repo's real fix shapes: subprocess.Popen (fresh interpreter,
        # state handed over as fds/paths) and an explicit spawn context
        assert run_rule(RuleC004, """
            import subprocess
            import sys
            import multiprocessing

            def launch(cmd, fds):
                ctx = multiprocessing.get_context("spawn")
                p1 = ctx.Process(target=entry, args=("/ring/path", 7))
                p2 = subprocess.Popen(
                    [sys.executable, "-m", "mod"], pass_fds=fds
                )
                return p1, p2
        """) == []

    def test_silent_on_unrelated_process_name(self):
        # a local class named Process with no multiprocessing import must
        # not fire (bounded false positives)
        assert run_rule(RuleC004, """
            class Process:
                pass

            def launch():
                return Process()
        """) == []


# -- C005: blocking call below a Future done-callback / event loop ------------

class TestC005:
    def test_fires_on_blocking_method_callback(self):
        hits = run_rule(RuleC005, """
            import os

            class Scorer:
                def submit(self, fut):
                    fut.add_done_callback(self._on_done)

                def _on_done(self, fut):
                    os.fsync(self.fd)
        """)
        assert [f.rule_id for f in hits] == ["C005"]
        assert "os.fsync" in hits[0].message

    def test_fires_on_lambda_with_timeoutless_queue_get(self):
        hits = run_rule(RuleC005, """
            def wire(fut, queue):
                fut.add_done_callback(lambda f: queue.get())
        """)
        assert [f.rule_id for f in hits] == ["C005"]

    def test_fires_on_other_futures_result(self):
        # blocking on a DIFFERENT future inside the callback: the classic
        # flusher-stall shape (callback waits for work the stalled
        # flusher itself would produce)
        hits = run_rule(RuleC005, """
            class Scorer:
                def submit(self, fut):
                    fut.add_done_callback(self._on_done)

                def _on_done(self, fut):
                    return self._other.result()
        """)
        assert [f.rule_id for f in hits] == ["C005"]
        assert "Future.result" in hits[0].message

    def test_fires_one_call_level_deep(self):
        # the callback looks clean but forwards to a helper that sleeps
        hits = run_rule(RuleC005, """
            import time

            class Scorer:
                def submit(self, fut):
                    fut.add_done_callback(
                        lambda f: self._deliver(f, self.worker)
                    )

                def _deliver(self, fut, worker):
                    while True:
                        time.sleep(0.002)
        """)
        assert [f.rule_id for f in hits] == ["C005"]

    def test_fires_deep_in_call_graph_with_witness_path(self):
        # phase 2: three frames down, across a higher-order hand-off --
        # the async fast path's actual shape (consumer -> service ->
        # on_done -> deliver -> fsync)
        hits = run_rule(RuleC005, """
            import os

            class Service:
                def submit_async(self, request, on_done):
                    on_done(request)

            class Bridge:
                def __init__(self):
                    self._svc = Service()

                def pump(self, fut, msg):
                    fut.add_done_callback(
                        lambda f: self._svc.submit_async(
                            msg, lambda r: self._deliver(r)
                        )
                    )

                def _deliver(self, response):
                    self._really_deliver(response)

                def _really_deliver(self, response):
                    os.fsync(self.fd)
        """)
        assert [f.rule_id for f in hits] == ["C005"]
        assert hits[0].symbol == "Bridge._really_deliver"
        assert "call path:" in hits[0].message

    def test_fires_on_sleep_in_select_event_loop(self):
        hits = run_rule(RuleC005, """
            import select
            import time

            class Loop:
                def serve(self):
                    while True:
                        select.select([], [], [], 0.25)
                        self._service()

                def _service(self):
                    time.sleep(5.0)
        """)
        assert [f.rule_id for f in hits] == ["C005"]
        assert "event loop" in hits[0].message

    def test_event_loop_socket_verbs_exempt(self):
        # the frontend shape: the loop's own sockets are non-blocking by
        # construction, so recv/send/accept in the loop stay silent
        assert run_rule(RuleC005, """
            import select

            class Loop:
                def serve(self, listener):
                    while True:
                        select.select([listener], [], [], 0.25)
                        sock, _ = listener.accept()
                        data = sock.recv(65536)
                        self._handle(data)

                def _handle(self, data):
                    pass
        """) == []

    def test_silent_on_own_resolved_future_and_nonblocking_work(self):
        # .result() on the callback's OWN argument is non-blocking (the
        # future is resolved by contract), including forwarded one call
        # deep -- the serving fast path's real shape: non-blocking ring
        # push, overflow parked on the retry queue, never waited for
        assert run_rule(RuleC005, """
            class Scorer:
                def submit(self, fut, box):
                    fut.add_done_callback(lambda f: box.append(f.result()))
                    fut.add_done_callback(self._on_done)

                def _on_done(self, future):
                    response = future.result()
                    try:
                        self.ring.push(response)
                    except RingFull:
                        self.retry.add(response)
        """) == []

    def test_own_future_exemption_forwards_deeply(self):
        # the resolved future rides two hand-offs; .result() on it is
        # still exempt at depth
        assert run_rule(RuleC005, """
            class Scorer:
                def submit(self, fut):
                    fut.add_done_callback(self._on_done)

                def _on_done(self, future):
                    self._unwrap(future)

                def _unwrap(self, fut):
                    self._final(fut)

                def _final(self, f):
                    return f.result()
        """) == []

    def test_silent_on_queue_ops_with_timeout_or_nowait(self):
        assert run_rule(RuleC005, """
            def wire(fut, queue):
                fut.add_done_callback(lambda f: queue.put(f, timeout=0.1))
                fut.add_done_callback(lambda f: queue.put_nowait(f))
        """) == []


# -- C006: Eraser-style lockset race (replaces C003) --------------------------

_C006_BUG = """
    import threading

    class P:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0
            self._thread = threading.Thread(target=self._run, daemon=True)

        def _run(self):
            while True:
                self.count += 1

        def submit(self, n):
            self.count = n
"""


class TestC006:
    def test_fires_on_unlocked_shared_counter(self):
        hits = run_rule(RuleC006, _C006_BUG)
        assert [f.rule_id for f in hits] == ["C006"]
        assert "'count'" in hits[0].message
        assert hits[0].symbol == "P.count"

    def test_no_module_allowlist(self):
        # C003 only looked at a hand-maintained module list; C006 fires
        # anywhere in the package
        hits = run_rule(
            RuleC006, _C006_BUG, path="predictionio_tpu_torch/tools/anytool.py"
        )
        assert [f.rule_id for f in hits] == ["C006"]

    def test_silent_with_common_lock(self):
        fixed = _C006_BUG.replace(
            "            while True:\n                self.count += 1",
            "            while True:\n                with self._lock:\n"
            "                    self.count += 1",
        ).replace(
            "        def submit(self, n):\n            self.count = n",
            "        def submit(self, n):\n            with self._lock:\n"
            "                self.count = n",
        )
        assert run_rule(RuleC006, fixed) == []

    def test_write_vs_unlocked_read_fires(self):
        # the C003->C006 migration's deliberate behavior change: a READ
        # against a concurrent writer races too (stale read /
        # check-then-act); C003 required mutation on both sides
        read_race = _C006_BUG.replace(
            "        def submit(self, n):\n            self.count = n",
            "        def submit(self, n):\n            return self.count",
        )
        hits = run_rule(RuleC006, read_race)
        assert [f.rule_id for f in hits] == ["C006"]
        assert "read under role" in hits[0].message

    def test_fires_through_helper_call(self):
        helper = """
            import threading

            class P:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.count = 0
                    self._thread = threading.Thread(target=self._run)

                def _run(self):
                    self._bump()

                def _bump(self):
                    self.count += 1

                def submit(self, n):
                    self.count = n
        """
        hits = run_rule(RuleC006, helper)
        assert [f.rule_id for f in hits] == ["C006"]

    def test_disjoint_locksets_still_race(self):
        # each side holds A lock -- just not the SAME lock: the exact
        # Eraser shape a common-lock check without sets would miss
        hits = run_rule(RuleC006, """
            import threading

            class P:
                def __init__(self):
                    self._a = threading.Lock()
                    self._b = threading.Lock()
                    self.state = 0
                    self._thread = threading.Thread(target=self._run)

                def _run(self):
                    with self._a:
                        self.state += 1

                def submit(self, n):
                    with self._b:
                        self.state = n
        """)
        assert [f.rule_id for f in hits] == ["C006"]
        assert "no lock common" in hits[0].message

    def test_lock_joined_over_call_path_silences(self):
        # the lock is held by the CALLER of the mutating helper on every
        # role's path: phase 1 could not see this, phase 2 must
        assert run_rule(RuleC006, """
            import threading

            class P:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.count = 0
                    self._thread = threading.Thread(target=self._run)

                def _run(self):
                    with self._lock:
                        self._bump()

                def _bump(self):
                    self.count += 1

                def submit(self, n):
                    with self._lock:
                        self._bump()
        """) == []

    def test_cross_module_thread_target_counts(self):
        # the Thread(target=...) lives in ANOTHER module: C003's lexical
        # in-class scan missed exactly this
        index = build_index(
            """
            class Loop:
                def run(self):
                    self.cycles = self.cycles + 1

                def status(self):
                    return self.cycles
            """,
            """
            import threading

            from predictionio_tpu_torch.pkg.mod0 import Loop

            def launch():
                loop = Loop()
                t = threading.Thread(target=loop.run)
                t.start()
                return loop
            """,
        )
        hits = list(RuleC006().check_package(index))
        assert [f.symbol for f in hits] == ["Loop.cycles"]

    def test_silent_when_single_role(self):
        # background thread is the only mutator AND the only reader
        assert run_rule(RuleC006, """
            import threading

            class P:
                def __init__(self):
                    self.count = 0
                    self._thread = threading.Thread(target=self._run)

                def _run(self):
                    self.count += 1
                    self._log()

                def _log(self):
                    print(self.count)
        """) == []

    def test_init_and_lifecycle_writes_are_happens_before(self):
        # the procserver start() shape: a thread-constructing method
        # writes setup state before the spawn; only __init__/lifecycle
        # writes exist, so no finding
        assert run_rule(RuleC006, """
            import threading

            class Bridge:
                def __init__(self):
                    self.port = None

                def start(self):
                    self.port = 7
                    self.workers = [1, 2]
                    t = threading.Thread(target=self._consume)
                    t.start()

                def _consume(self):
                    return self.port, self.workers
        """) == []

    def test_submit_gate_shape_is_the_negative(self):
        # the data/ingest.py fix shape: the stop flag flips under the
        # same gate lock submit checks it under -- common lock, silent
        assert run_rule(RuleC006, """
            import threading

            class Pipeline:
                def __init__(self):
                    self._gate = threading.Lock()
                    self._stopping = False
                    self._thread = threading.Thread(target=self._writer)

                def _writer(self):
                    with self._gate:
                        if self._stopping:
                            return

                def submit(self, item):
                    with self._gate:
                        if self._stopping:
                            raise RuntimeError("stopping")

                def stop(self):
                    with self._gate:
                        self._stopping = True
        """) == []

    def test_dead_flag_protocol_shape_is_the_negative(self):
        # the serving/procserver.py fix shape: every access to the
        # worker's dead flag happens under its cmp_lock (annotated
        # receiver type resolves the cross-class lock identity)
        assert run_rule(RuleC006, """
            import threading

            class Worker:
                def __init__(self):
                    self.cmp_lock = threading.Lock()
                    self.dead = False

            class Bridge:
                def __init__(self):
                    self._thread = threading.Thread(target=self._supervise)

                def _supervise(self):
                    w = Worker()
                    self._retire(w)

                def _retire(self, w: Worker):
                    with w.cmp_lock:
                        w.dead = True

                def deliver(self, w: Worker, payload):
                    with w.cmp_lock:
                        if w.dead:
                            return
        """) == []

    def test_thread_confined_local_object_skipped(self):
        # the _ColumnSpill shape: built, used, and closed inside one
        # call -- its fields cannot be shared
        assert run_rule(RuleC006, """
            import threading

            class Spill:
                def __init__(self):
                    self.rows = 0

                def add(self, n):
                    self.rows += n

            class Builder:
                def __init__(self):
                    self._thread = threading.Thread(target=self._build)

                def _build(self):
                    spill = Spill()
                    spill.add(3)

                def build_now(self):
                    spill = Spill()
                    spill.add(5)
        """) == []

    def test_main_plus_request_without_threads_is_silent(self):
        # a tool class driven from __main__ with public methods: one
        # thread in reality, no finding
        assert run_rule(RuleC006, """
            class Tool:
                def step(self):
                    self.n = getattr(self, "n", 0) + 1

                def report(self):
                    return self.n

            def main():
                t = Tool()
                t.step()
                t.report()

            if __name__ == "__main__":
                main()
        """) == []

    def test_finding_names_lock_sites_for_runtime_witness(self):
        hits = run_rule(RuleC006, """
            import threading

            class P:
                def __init__(self):
                    self._a = threading.Lock()
                    self.state = 0
                    self._thread = threading.Thread(target=self._run)

                def _run(self):
                    with self._a:
                        self.state += 1

                def submit(self, n):
                    self.state = n
        """)
        assert len(hits) == 1
        assert "lockwatch" in hits[0].message
        assert "predictionio_tpu_torch.pkg.mod:" in hits[0].message


# -- lockwatch: runtime C001 + the C006 witness -------------------------------

class TestLockwatch:
    def test_seeded_inversion_across_two_threads_detected(self):
        watch = lockwatch.LockWatch()
        a = watch.wrap(threading.Lock(), "mod.py:10")
        b = watch.wrap(threading.Lock(), "mod.py:11")

        def order_ab():
            with a:
                with b:
                    pass

        def order_ba():
            with b:
                with a:
                    pass

        t1 = threading.Thread(target=order_ab)
        t1.start(); t1.join()
        assert watch.inversions == []
        t2 = threading.Thread(target=order_ba)
        t2.start(); t2.join()
        assert len(watch.inversions) == 1
        inv = watch.inversions[0]
        assert set(inv.first) == {"mod.py:10", "mod.py:11"}

    def test_consistent_order_and_reentrancy_stay_clean(self):
        watch = lockwatch.LockWatch()
        a = watch.wrap(threading.RLock(), "mod.py:20")
        b = watch.wrap(threading.Lock(), "mod.py:21")
        for _ in range(3):
            with a:
                with a:          # reentrant re-acquire: no self-edge
                    with b:
                        pass
        assert watch.inversions == []
        assert ("mod.py:20", "mod.py:21") in watch.edges

    def test_held_locksets_recorded_per_acquisition(self):
        # C006's runtime half: every acquisition records what was HELD
        watch = lockwatch.LockWatch()
        a = watch.wrap(threading.Lock(), "mod.py:30")
        b = watch.wrap(threading.Lock(), "mod.py:31")
        with a:
            with b:
                pass
        with b:
            pass
        assert watch.held_at["mod.py:30"] == {frozenset()}
        assert watch.held_at["mod.py:31"] == {
            frozenset({"mod.py:30"}), frozenset(),
        }

    def test_runtime_witness_renders_evidence_and_absence(self):
        watch = lockwatch.LockWatch()
        a = watch.wrap(threading.Lock(), "pkg.mod:30")
        b = watch.wrap(threading.Lock(), "pkg.mod:31")
        with a:
            with b:
                pass
        text = watch.runtime_witness(["pkg.mod:31", "pkg.other:99"])
        assert "pkg.mod:31: acquired holding {pkg.mod:30}" in text
        assert "pkg.other:99: never acquired under lockwatch" in text

    def test_install_wraps_port_locks_only(self):
        """In a fresh interpreter: the pytest run already installs the
        reference's lockwatch (``tests/conftest.py``), whose prefix would
        wrap the port's watch's own lock factory. The port's install()
        wraps a lock the port's code builds, leaves the stdlib's and the
        JAX package's alone, and the watched lock works end to end."""
        out = _fresh_python("""
            import queue
            from predictionio_tpu_torch.analysis import lockwatch
            lockwatch.install()
            from predictionio_tpu_torch.utils.metrics import MetricsRegistry
            from predictionio_tpu.utils.metrics import MetricsRegistry as JaxRegistry
            registry = MetricsRegistry()   # lock created in port code
            assert isinstance(registry._lock, lockwatch._WatchedLock)
            assert registry._lock.site.startswith(
                "predictionio_tpu_torch.utils.metrics:")
            assert not isinstance(JaxRegistry()._lock, lockwatch._WatchedLock)
            q = queue.Queue()              # stdlib-created lock: untouched
            assert not isinstance(q.mutex, lockwatch._WatchedLock)
            registry.inc("x_total")        # watched lock works end-to-end
            assert "x_total" in registry.exposition()
            lockwatch.uninstall()
            assert not isinstance(MetricsRegistry()._lock, lockwatch._WatchedLock)
            print("OK")
        """)
        assert out.strip().endswith("OK")

    def test_installed_watch_records_port_acquisitions(self):
        """A fresh interpreter with the port's watch installed: two port
        locks of different construction sites taken in both orders on two
        threads record the inversion, and every acquisition its held
        lockset, by site."""
        out = _fresh_python("""
            import threading
            from predictionio_tpu_torch.analysis import lockwatch
            lockwatch.install()
            from predictionio_tpu_torch.obs.trace import Tracer
            from predictionio_tpu_torch.utils.metrics import MetricsRegistry
            a, b = MetricsRegistry()._lock, Tracer()._lock
            assert a.site.startswith("predictionio_tpu_torch.utils.metrics:")
            assert b.site.startswith("predictionio_tpu_torch.obs.trace:")
            def order(x, y):
                with x:
                    with y:
                        pass
            for x, y in ((a, b), (b, a)):
                t = threading.Thread(target=order, args=(x, y))
                t.start(); t.join()
            watch = lockwatch.global_watch()
            assert len(watch.inversions) == 1
            assert set(watch.inversions[0].first) == {a.site, b.site}
            assert watch.held_at[b.site] == {frozenset(), frozenset({a.site})}
            lockwatch.uninstall()
            print("OK")
        """)
        assert out.strip().endswith("OK")


# -- the docstring-driven catalog ---------------------------------------------

class TestCatalog:
    def test_explain_prints_docstring_entry(self, capsys):
        from predictionio_tpu_torch.analysis.engine import run_cli

        assert run_cli(["--explain", "c006"]) == 0
        out = capsys.readouterr().out
        assert out.startswith("C006 (error)")
        assert "Eraser-style" in out and "Incident" in out

    def test_explain_unknown_rule_errors(self, capsys):
        from predictionio_tpu_torch.analysis.engine import run_cli

        assert run_cli(["--explain", "C099"]) == 2
        assert "unknown rule" in capsys.readouterr().out

    def test_every_rule_has_an_incident_entry(self):
        from predictionio_tpu_torch.analysis import all_rules
        from predictionio_tpu_torch.analysis.engine import _split_doc

        for rule in all_rules():
            flags, incident = _split_doc(rule)
            assert flags, rule.rule_id
            assert incident.startswith("Incident"), (
                f"{rule.rule_id} docstring needs an 'Incident' paragraph "
                "(it IS the docs table and --explain output)"
            )

    def test_update_docs_rejects_missing_markers(self, tmp_path, monkeypatch):
        # a family whose markers vanished must error, not report success
        # with that table silently stale
        from predictionio_tpu_torch.analysis import engine

        partial = tmp_path / "docs.md"
        partial.write_text(
            engine.DOCS_TABLE_BEGIN.format(family="J") + "\n"
            + engine.DOCS_TABLE_END.format(family="J") + "\n"
        )
        with pytest.raises(ValueError, match="C"):
            engine.update_docs(str(partial))

    def test_docs_rule_tables_in_sync_with_docstrings(self):
        # the no-drift contract: the committed docs tables equal what
        # the docstrings generate (regenerate: pio check --update-docs)
        from predictionio_tpu_torch.analysis.engine import (
            default_docs_path,
            render_rule_table,
        )

        with open(default_docs_path(), encoding="utf-8") as f:
            docs = f.read()
        from predictionio_tpu_torch.analysis.engine import DOC_FAMILIES

        assert DOC_FAMILIES == ("C", "R", "P")
        for family in DOC_FAMILIES:
            assert render_rule_table(family) in docs, (
                f"{family}-series table stale: run pio check --update-docs"
            )


# -- baseline + repo gate -----------------------------------------------------

class TestBaseline:
    def test_baseline_suppresses_and_reports_stale(self):
        f = Finding("C002", "warning", "pkg/a.py", 3, "A.m", "msg")
        entries = [
            {"rule": "C002", "path": "pkg/a.py", "symbol": "A.m",
             "justification": "accepted"},
            {"rule": "J001", "path": "pkg/gone.py", "symbol": "<module>",
             "justification": "fixed long ago"},
        ]
        unsuppressed, suppressed, stale = apply_baseline([f], entries)
        assert unsuppressed == [] and suppressed == [f]
        assert [e["path"] for e in stale] == ["pkg/gone.py"]

    def test_committed_baseline_entries_all_justified(self):
        for entry in load_baseline():
            just = entry["justification"].strip()
            assert just and not just.startswith("TODO"), entry

    def test_self_check_clean(self):
        assert self_check() == []

    def test_self_check_cli_entrypoint(self, capsys):
        # the `python -m predictionio_tpu_torch.analysis --self-check` surface
        from predictionio_tpu_torch.analysis.engine import run_cli

        assert run_cli(["--self-check"]) == 0
        assert "self-check OK" in capsys.readouterr().out

    def test_self_check_rejects_todo_and_stale_entries(self, tmp_path):
        stale = tmp_path / "baseline.json"
        stale.write_text(json.dumps({"version": 1, "entries": [
            {"rule": "J001", "path": "predictionio_tpu_torch/nope.py",
             "symbol": "<module>", "justification": "TODO: justify or fix"},
        ]}))
        problems = self_check(str(stale))
        assert any("stale" in p for p in problems)
        assert any("justification" in p for p in problems)


def test_port_wide_zero_unsuppressed_findings():
    """THE tier-1 gate of the port: every rule over the whole of
    ``predictionio_tpu_torch/``, its committed baseline applied, zero
    unsuppressed findings, no stale suppressions -- and the sweep stays
    inside the reference's 10 s budget on the 2-core box. C006 findings
    are annotated with the runtime witness of the lock watch the pytest
    run installs (the reference's, whose prefix covers the port's
    locks, unless the port's own is installed)."""
    t0 = time.monotonic()
    findings = check_paths()
    elapsed = time.monotonic() - t0
    unsuppressed, _, stale = apply_baseline(findings, load_baseline())
    if unsuppressed:
        import re

        from predictionio_tpu.analysis import lockwatch as jax_lockwatch

        watch = (lockwatch if lockwatch.installed() else jax_lockwatch).global_watch()
        lines = []
        for f in unsuppressed:
            lines.append(f.render())
            if f.rule_id == "C006":
                sites = re.findall(r"[\w.]+:\d+", f.message)
                sites = [s for s in sites if "." in s.split(":")[0]]
                lines.append(
                    "  runtime witness: " + watch.runtime_witness(sites)
                )
        raise AssertionError("\n".join(lines))
    assert stale == [], f"stale baseline entries: {stale}"
    assert elapsed < 10.0, f"pio check took {elapsed:.1f}s (budget 10s)"


def test_cli_check_json(capsys):
    from predictionio_tpu_torch.tools.cli import main

    rc = main(["check", "--format", "json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["analysis_findings_total"] == 0
    assert doc["findings"] == [] and doc["stale_baseline"] == []
    assert len(doc["suppressed"]) >= 1  # the committed accepted findings


def test_update_baseline_scoped_run_preserves_out_of_scope_entries(tmp_path):
    """A --rules/path-scoped --update-baseline must carry over the entries
    it did not re-examine (and their justifications) verbatim."""
    import shutil

    from predictionio_tpu_torch.analysis.engine import (
        default_baseline_path,
        run_cli,
    )

    scratch = tmp_path / "baseline.json"
    shutil.copy(default_baseline_path(), scratch)
    before = load_baseline(str(scratch))
    # controller/ has no findings and no baseline entries: nothing in scope
    rc = run_cli([
        "predictionio_tpu_torch/controller", "--update-baseline",
        "--baseline", str(scratch),
    ])
    assert rc == 0
    assert load_baseline(str(scratch)) == before
    # a rule-scoped run likewise leaves the other rules' entries alone
    rc = run_cli(["--rules", "C001", "--update-baseline", "--baseline", str(scratch)])
    assert rc == 0
    assert load_baseline(str(scratch)) == before


def test_changed_scope_reports_only_changed_files(tmp_path, capsys, monkeypatch):
    """--changed narrows the REPORT to git-touched files while the
    analysis still sees the whole package, and out-of-scope baseline
    entries never go stale (the path-scoped semantics)."""
    from predictionio_tpu_torch.analysis import engine

    monkeypatch.setattr(
        engine, "changed_files",
        lambda: ["predictionio_tpu_torch/workflow/microbatch.py"],
    )
    rc = engine.run_cli(["--changed", "--format", "json"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert doc["findings"] == [] and doc["stale_baseline"] == []
    # every baseline entry lives outside the changed set -> none were in
    # scope, so the suppressed list for this run is empty, NOT stale
    assert doc["suppressed"] == []


def test_changed_rejects_explicit_paths(capsys):
    from predictionio_tpu_torch.analysis.engine import run_cli

    assert run_cli(["--changed", "predictionio_tpu_torch/data"]) == 2
    assert "mutually exclusive" in capsys.readouterr().out


def test_changed_files_runs_git():
    from predictionio_tpu_torch.analysis.engine import changed_files

    files = changed_files()   # the repo IS a git checkout
    assert isinstance(files, list)
    assert all(f.endswith(".py") for f in files)


def test_cli_rejects_bad_paths_and_none_update(capsys):
    from predictionio_tpu_torch.analysis.engine import run_cli

    assert run_cli(["predictionio_tpu_torch/nonexistent.py"]) == 2
    assert run_cli(["--baseline", "none", "--update-baseline"]) == 2
    out = capsys.readouterr().out
    assert "no such file" in out and "--update-baseline" in out


# -- R001: exception-path permit/lock/fd leaks --------------------------------

_R001_WATCHDOG = """
    import threading

    class Bridge:
        def __init__(self):
            self._inflight = threading.Semaphore(8)

        def watch(self, ring):
            self._inflight.acquire()
            entry = ring.pop()
            self._inflight.release()
"""


class TestR001:
    def test_fires_on_watchdog_held_permit(self):
        # the watchdog incident shape: the permit is released only on the
        # straight-line path; the exception edge out of the pop keeps it
        hits = run_rule(RuleR001, _R001_WATCHDOG)
        assert [f.rule_id for f in hits] == ["R001"]
        assert "_inflight" in hits[0].message
        assert hits[0].symbol == "Bridge.watch"

    def test_silent_on_finally_release(self):
        assert run_rule(RuleR001, _R001_WATCHDOG.replace(
            """            entry = ring.pop()
            self._inflight.release()""",
            """            try:
                entry = ring.pop()
            finally:
                self._inflight.release()""",
        )) == []

    def test_consume_fix_shape_is_the_negative(self):
        # serving/procserver.py's retired-ring fix: catch-all release +
        # re-raise around the pop, field release credited through the
        # delivery helper on the success path
        assert run_rule(RuleR001, """
            import threading

            class Bridge:
                def __init__(self):
                    self._inflight = threading.Semaphore(8)

                def _deliver(self, msg):
                    self._inflight.release()

                def consume(self, ring):
                    while ring.pending():
                        if not self._inflight.acquire(timeout=0.5):
                            break
                        try:
                            msg = ring.pop()
                        except BaseException:
                            self._inflight.release()
                            raise
                        if msg is None:
                            self._inflight.release()
                            break
                        self._deliver(msg)
            """) == []

    def test_admission_idiom_failed_acquire_owes_nothing(self):
        # `if not x.acquire(timeout=...):` creates the obligation only
        # on the success branch -- the failure branch exits clean
        assert run_rule(RuleR001, """
            import threading

            class Bridge:
                def __init__(self):
                    self._inflight = threading.Semaphore(8)

                def try_once(self, ring):
                    if not self._inflight.acquire(timeout=0.1):
                        return None
                    try:
                        return ring.pop()
                    finally:
                        self._inflight.release()
            """) == []

    def test_fires_on_fd_held_across_raising_call(self):
        hits = run_rule(RuleR001, """
            import mmap

            def attach(path, size):
                f = open(path, "r+b")
                mm = mmap.mmap(f.fileno(), size)
                return mm, f
        """)
        assert [f.rule_id for f in hits] == ["R001"]

    def test_silent_on_fd_close_backstop(self):
        # the shmring RingFile fix shape
        assert run_rule(RuleR001, """
            import mmap

            def attach(path, size):
                f = open(path, "r+b")
                try:
                    mm = mmap.mmap(f.fileno(), size)
                    return mm, f
                except BaseException:
                    f.close()
                    raise
        """) == []

    def test_fires_on_raw_lock_acquire_without_release_on_raise(self):
        hits = run_rule(RuleR001, """
            import threading

            _lock = threading.Lock()

            def critical(work):
                _lock.acquire()
                work()
                _lock.release()
        """)
        assert [f.rule_id for f in hits] == ["R001"]

    def test_typed_handler_does_not_count_as_backstop(self):
        # the non-UTF-8 lesson applied to permits: a typed except may
        # not match, so the release inside it does not cover the
        # propagate path
        hits = run_rule(RuleR001, """
            import threading

            class Bridge:
                def __init__(self):
                    self._sem = threading.Semaphore(2)

                def pump(self, ring):
                    self._sem.acquire()
                    try:
                        msg = ring.pop()
                    except ValueError:
                        self._sem.release()
                        return None
                    self._sem.release()
                    return msg
        """)
        assert [f.rule_id for f in hits] == ["R001"]


# -- R002: span neither finished nor detached ---------------------------------

_R002_NON_UTF8 = """
    class Service:
        def submit(self, tracer, request, on_done):
            root = tracer.start_remote("POST /queries.json", None)
            try:
                query = request.json()
            except ValueError:
                root.finish()
                return
            on_done(query)
            root.finish()
"""


class TestR002:
    def test_fires_on_non_utf8_body_shape(self):
        # the non-UTF-8 incident: request.json() raises OUTSIDE the typed
        # handler's type (UnicodeDecodeError vs JSONDecodeError) and the
        # root span started on the consumer is never finished
        hits = run_rule(RuleR002, _R002_NON_UTF8)
        assert [f.rule_id for f in hits] == ["R002"]
        assert "start_remote" in hits[0].message
        assert "exception" in hits[0].message

    def test_catch_all_backstop_is_the_negative(self):
        # the fix shape: every statement that can throw sits under a
        # catch-all that finishes the root (via the shared finisher)
        assert run_rule(RuleR002, """
            class Service:
                def _finish(self, response, span):
                    span.finish()

                def submit(self, tracer, request, on_done):
                    root = tracer.start_remote("POST /q", None)
                    try:
                        query = request.json()
                        on_done(query)
                        self._finish(query, root)
                    except Exception:
                        self._finish(None, root)
        """) == []

    def test_finally_finished_is_the_negative(self):
        assert run_rule(RuleR002, """
            def traced(tracer, work):
                span = tracer.span("op")
                try:
                    return work()
                finally:
                    span.finish()
        """) == []

    def test_fires_on_attach_without_detach(self):
        hits = run_rule(RuleR002, """
            class Service:
                def submit(self, guard, batcher, query):
                    guard.attach()
                    batcher.submit(query)
                    guard.detach()
        """)
        assert [f.rule_id for f in hits] == ["R002"]
        assert "attach" in hits[0].message

    def test_sampled_out_sentinel_shape_is_the_negative(self):
        # the async fast path's real discipline: the trace_id
        # discriminator routes the sentinel branch (which owes no
        # finish), attach/detach pairs in a finally
        assert run_rule(RuleR002, """
            from predictionio_tpu_torch.obs.trace import SAMPLED_OUT_ROOT

            class Service:
                def _finish(self, response, span):
                    if span is not None:
                        span.finish()

                def submit(self, tracer, request, on_done):
                    span = None
                    root = tracer.start_remote("POST /q", None)
                    if root.trace_id is not None:
                        span = root
                        guard = root
                    else:
                        guard = SAMPLED_OUT_ROOT
                    guard.attach()
                    try:
                        query = request.json()
                        on_done(query)
                        self._finish(query, span)
                    except Exception:
                        self._finish(None, span)
                    finally:
                        guard.detach()
        """) == []

    def test_handle_stored_into_owner_entry_is_the_negative(self):
        # the submit_query_async shape: the root rides the pending-entry
        # dict whose owner (watchdog/callback) finishes it later
        assert run_rule(RuleR002, """
            class Service:
                def submit(self, tracer, request):
                    root = tracer.start_remote("POST /q", None)
                    entry = {"request": request, "span": root}
                    self._pending.append(entry)
        """) == []


# -- R003: durability-protocol violations -------------------------------------

class TestR003:
    def test_fires_on_rename_without_fsync(self):
        # the snapshot-commit incident shape (and the reference's
        # workflow/checkpoint.py finding, since fixed)
        hits = run_rule(RuleR003, """
            import json
            import os

            def write_meta(path, meta):
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(meta, f)
                os.replace(tmp, path)
        """)
        assert [f.rule_id for f in hits] == ["R003"]
        assert "rename" in hits[0].message

    def test_tmp_fsync_rename_is_the_negative(self):
        # the online/follower.py TailCursor shape
        assert run_rule(RuleR003, """
            import json
            import os

            def write_meta(path, meta):
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
        """) == []

    def test_helper_fsync_credited_through_call_graph(self):
        # the data/snapshot.py shape: _fsync_dir fsyncs on the caller's
        # behalf before the commit rename
        assert run_rule(RuleR003, """
            import json
            import os

            def _fsync_dir(path):
                fd = os.open(path, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)

            def publish(tmp, target, manifest):
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                _fsync_dir(tmp)
                os.rename(tmp, target)
        """) == []

    def test_fires_on_checkpoint_before_flush(self):
        # the ordering obligation: the cursor claims coverage of bytes
        # that are not on disk yet
        hits = run_rule(RuleR003, """
            import os

            class Cursor:
                def commit(self, path, payload, seqno):
                    f = open(path, "r+b")
                    f.write(payload)
                    self._write_checkpoint(seqno)
                    os.fsync(f.fileno())
                    f.close()

                def _write_checkpoint(self, seqno):
                    pass
        """)
        assert [f.rule_id for f in hits] == ["R003"]
        assert "checkpoint" in hits[0].message

    def test_checkpoint_after_fsync_is_the_negative(self):
        assert run_rule(RuleR003, """
            import os

            class Cursor:
                def commit(self, path, payload, seqno):
                    f = open(path, "r+b")
                    f.write(payload)
                    os.fsync(f.fileno())
                    self._write_checkpoint(seqno)
                    f.close()

                def _write_checkpoint(self, seqno):
                    pass
        """) == []


# -- R004: obligations that die with no owner ---------------------------------

class TestR004:
    def test_fires_on_permit_dropped_on_normal_exit(self):
        # the _CompletionRetry deadline-drop incident shape: the entry
        # is dropped, and the permit riding it is dropped WITH it
        hits = run_rule(RuleR004, """
            import threading

            class Bridge:
                def __init__(self):
                    self._inflight = threading.Semaphore(8)

                def drop_expired(self, response):
                    self._inflight.acquire()
                    if response is None:
                        return
                    self.ring.push(response)
                    self._inflight.release()
        """)
        assert [f.rule_id for f in hits] == ["R004"]
        assert "no owner" in hits[0].message

    def test_silent_when_parked_on_an_owner(self):
        # the retry-queue fix shape: the obligation is stored with the
        # parked entry, whose owner releases it later
        assert run_rule(RuleR004, """
            import threading

            class Bridge:
                def __init__(self):
                    self._inflight = threading.Semaphore(8)

                def park(self, sem, entry):
                    sem.acquire()
                    self._parked.append((entry, sem))
        """) == []

    def test_silent_when_returned_to_caller(self):
        assert run_rule(RuleR004, """
            class RunLock:
                def acquire(self):
                    self._lock.acquire()
                    return self
        """) == []


# -- the witness-path renderer on R findings ----------------------------------

class TestRWitnessPaths:
    def test_multi_module_release_chain_credits_and_stays_silent(self):
        # acquire in mod1, release two modules away through a typed attr
        index = build_index(
            """
            class Owner:
                def finish_all(self, span):
                    span.finish()
            """,
            """
            from predictionio_tpu_torch.pkg.mod0 import Owner

            class Svc:
                def __init__(self):
                    self._owner = Owner()

                def run(self, tracer, work):
                    root = tracer.span("op")
                    try:
                        work()
                    finally:
                        self._owner.finish_all(root)
            """,
        )
        assert list(RuleR002().check_package(index)) == []

    def test_multi_module_non_releasing_helper_lands_in_witness(self):
        index = build_index(
            """
            class Owner:
                def log_only(self, span):
                    self.last = span.op
            """,
            """
            from predictionio_tpu_torch.pkg.mod0 import Owner

            class Svc:
                def __init__(self):
                    self._owner = Owner()

                def run(self, tracer, work):
                    root = tracer.span("op")
                    work()
                    self._owner.log_only(root)
            """,
        )
        hits = list(RuleR002().check_package(index))
        assert [f.rule_id for f in hits] == ["R002"]
        assert any("Owner.log_only" in hop for hop in hits[0].witness)
        assert "witness path:" in hits[0].message
        assert hits[0].witness[0].startswith("predictionio_tpu_torch/pkg/mod1.py")

    def test_decorator_wrapped_acquirer_still_analyzed(self):
        src = """
            import functools
            import threading

            def traced(fn):
                @functools.wraps(fn)
                def wrapper(*args, **kwargs):
                    return fn(*args, **kwargs)
                return wrapper

            class Bridge:
                def __init__(self):
                    self._inflight = threading.Semaphore(4)

                @traced
                def pump(self, ring):
                    self._inflight.acquire()
                    ring.pop()
                    self._inflight.release()
        """
        hits = run_rule(RuleR001, src)
        assert [f.rule_id for f in hits] == ["R001"]
        assert hits[0].symbol == "Bridge.pump"
        fixed = src.replace(
            """                    ring.pop()
                    self._inflight.release()""",
            """                    try:
                        ring.pop()
                    finally:
                        self._inflight.release()""",
        )
        assert run_rule(RuleR001, fixed) == []

    def test_partial_release_handle_invoked_by_helper(self):
        # a functools.partial(sem.release) handed to a helper that calls
        # its parameter discharges the permit
        assert run_rule(RuleR001, """
            import functools

            class Bridge:
                def _later(self, cb):
                    cb()

                def pump(self, sem, ring):
                    sem.acquire()
                    try:
                        ring.pop()
                    finally:
                        self._later(functools.partial(sem.release))
        """) == []

    def test_partial_release_handle_never_called_still_leaks(self):
        # the helper drops the handle on the floor: the exception path
        # out of the pop has no release (R001); with no release on ANY
        # path it would be R004 instead
        hits = run_rule(RuleR001, """
            import functools

            class Bridge:
                def _later(self, cb):
                    pass

                def pump(self, sem, ring):
                    sem.acquire()
                    try:
                        msg = ring.pop()
                    except BaseException:
                        self._later(functools.partial(sem.release))
                        raise
                    sem.release()
                    return msg
        """)
        assert [f.rule_id for f in hits] == ["R001"]

    def test_local_partial_handle_call_discharges(self):
        assert run_rule(RuleR001, """
            import functools

            def pump(sem, ring):
                sem.acquire()
                release = functools.partial(sem.release)
                try:
                    ring.pop()
                finally:
                    release()
        """) == []


# -- SARIF output -------------------------------------------------------------

class TestSarif:
    def test_round_trips_against_json_format(self, capsys):
        from predictionio_tpu_torch.analysis.engine import run_cli

        assert run_cli(["--format", "json"]) == 0
        json_doc = json.loads(capsys.readouterr().out)
        assert run_cli(["--format", "sarif"]) == 0
        sarif = json.loads(capsys.readouterr().out)
        assert sarif["version"] == "2.1.0"
        run = sarif["runs"][0]
        # every finding the JSON format reports appears as a result;
        # baseline-suppressed ones carry the suppressions marker
        results = run["results"]
        suppressed = [r for r in results if r.get("suppressions")]
        unsuppressed = [r for r in results if not r.get("suppressions")]
        assert len(suppressed) == len(json_doc["suppressed"])
        assert len(unsuppressed) == json_doc["analysis_findings_total"]
        sarif_keys = {
            (r["ruleId"],
             r["locations"][0]["physicalLocation"]["artifactLocation"]["uri"],
             r["locations"][0]["physicalLocation"]["region"]["startLine"])
            for r in suppressed
        }
        json_keys = {
            (f["rule_id"], f["path"], f["line"])
            for f in json_doc["suppressed"]
        }
        assert sarif_keys == json_keys
        # rule metadata comes from the same docstrings as the docs table
        from predictionio_tpu_torch.analysis import all_rules

        ids = {d["id"] for d in run["tool"]["driver"]["rules"]}
        assert ids == {r.rule_id for r in all_rules()}
        for d in run["tool"]["driver"]["rules"]:
            assert d["shortDescription"]["text"]

    def test_witness_path_renders_as_code_flow(self):
        import textwrap

        from predictionio_tpu_torch.analysis import all_rules, parse_source
        from predictionio_tpu_torch.analysis.engine import render_sarif

        ctx = parse_source(textwrap.dedent(_R001_WATCHDOG),
                           "predictionio_tpu_torch/pkg/mod.py")
        hits = list(RuleR001().check(ctx))
        sarif = json.loads(render_sarif(hits, [], all_rules()))
        result = sarif["runs"][0]["results"][0]
        locs = result["codeFlows"][0]["threadFlows"][0]["locations"]
        assert len(locs) >= 2
        first = locs[0]["location"]["physicalLocation"]
        assert first["artifactLocation"]["uri"] == "predictionio_tpu_torch/pkg/mod.py"
        assert first["region"]["startLine"] == hits[0].line


# -- CLI regressions: unknown rules, docstring-less --explain -----------------

class TestCliRegressions:
    def test_unknown_rule_id_exits_2_with_known_list(self, capsys):
        from predictionio_tpu_torch.analysis.engine import run_cli

        assert run_cli(["--rules", "R999"]) == 2
        out = capsys.readouterr().out
        assert "unknown rule id(s)" in out
        # the known-rule catalog is printed, never a silent zero-rule run
        for rid in ("C001", "C006", "R001"):
            assert rid in out
        # the P family rides the same contract
        assert run_cli(["--rules", "P999"]) == 2
        out = capsys.readouterr().out
        assert "unknown rule id(s)" in out
        for rid in ("P001", "P005"):
            assert rid in out

    def test_explain_docstringless_rule_exits_2(self, capsys, monkeypatch):
        from predictionio_tpu_torch.analysis import engine

        class RuleX999:
            rule_id = "X999"
            severity = "error"

            def check(self, ctx):
                return []

        RuleX999.__doc__ = None
        real = engine.all_rules
        monkeypatch.setattr(
            engine, "all_rules", lambda: real() + [RuleX999()]
        )
        assert engine.run_cli(["--explain", "X999"]) == 2
        assert "no docstring" in capsys.readouterr().out

    def test_self_check_flags_docstringless_rule(self, monkeypatch):
        from predictionio_tpu_torch.analysis import engine

        class RuleX998:
            rule_id = "X998"
            severity = "error"

            def check(self, ctx):
                return []

        RuleX998.__doc__ = None
        real = engine.all_rules
        monkeypatch.setattr(
            engine, "all_rules", lambda: real() + [RuleX998()]
        )
        problems = engine.self_check()
        assert any("X998" in p and "docstring" in p for p in problems)


def test_changed_one_file_diff_stays_under_two_seconds(monkeypatch, capsys):
    """The pre-commit contract: `pio check --changed` on a one-file diff
    runs the per-module rules on that file only (package rules keep the
    whole-program horizon) and finishes inside 2 s. Best of two runs:
    the budget is the path's cost, not the box's scheduling noise."""
    from predictionio_tpu_torch.analysis import engine

    monkeypatch.setattr(
        engine, "changed_files",
        lambda: ["predictionio_tpu_torch/workflow/microbatch.py"],
    )
    best = float("inf")
    for _ in range(2):
        t0 = time.monotonic()
        rc = engine.run_cli(["--changed"])
        best = min(best, time.monotonic() - t0)
        assert rc == 0
    capsys.readouterr()
    assert best < 2.0, f"--changed took {best:.2f}s (budget 2s)"


def test_precommit_entry_runs_changed_scope(monkeypatch, capsys):
    from predictionio_tpu_torch.analysis import engine
    from predictionio_tpu_torch.tools import precommit

    seen = {}
    real = engine.run_cli

    def spy(argv):
        seen["argv"] = argv
        return real(argv)

    monkeypatch.setattr(
        "predictionio_tpu_torch.analysis.engine.run_cli", spy
    )
    monkeypatch.setattr(
        engine, "changed_files", lambda: []
    )
    assert precommit.main([]) == 0
    assert seen["argv"][:3] == ["--changed", "--format", "text"]
    capsys.readouterr()


# -- --changed: deleted/renamed files resolve to survivors --------------------

class TestChangedSurvivingPaths:
    def _git(self, cwd, *args):
        import subprocess

        subprocess.run(
            ["git", *args], cwd=cwd, check=True, capture_output=True,
            env={"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
                 "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
                 "HOME": str(cwd), "PATH": __import__("os").environ["PATH"]},
        )

    def test_deleted_and_renamed_resolve_to_survivors(
        self, tmp_path, monkeypatch
    ):
        # regression: a diff containing a deleted file and a renamed
        # file must scope to the SURVIVING paths only -- the deleted
        # path must not reach the parser, the rename must appear under
        # its new name
        from predictionio_tpu_torch.analysis import engine

        (tmp_path / "doomed.py").write_text("x = 1\n")
        (tmp_path / "moves.py").write_text("y = 2\n")
        (tmp_path / "stays.py").write_text("z = 3\n")
        self._git(tmp_path, "init", "-q")
        self._git(tmp_path, "add", ".")
        self._git(tmp_path, "commit", "-qm", "seed")
        (tmp_path / "doomed.py").unlink()
        self._git(tmp_path, "mv", "moves.py", "renamed.py")
        (tmp_path / "stays.py").write_text("z = 4\n")
        monkeypatch.setattr(engine, "repo_root", lambda: str(tmp_path))
        changed = engine.changed_files()
        assert "doomed.py" not in changed
        assert "moves.py" not in changed
        assert "renamed.py" in changed and "stays.py" in changed

    def test_changed_scope_with_ghost_path_never_crashes(
        self, monkeypatch, capsys
    ):
        # belt-and-suspenders: even if git hands back a path that no
        # longer exists (rename-detection drift between git versions, a
        # file deleted mid-run), the sweep skips it instead of raising
        from predictionio_tpu_torch.analysis import engine

        monkeypatch.setattr(
            engine, "changed_files",
            lambda: ["predictionio_tpu_torch/does_not_exist_anymore.py",
                     "predictionio_tpu_torch/workflow/microbatch.py"],
        )
        rc = engine.run_cli(["--changed"])
        out = capsys.readouterr().out
        assert rc == 0, out

    def test_parse_module_on_missing_path_returns_none(self, tmp_path):
        from predictionio_tpu_torch.analysis.engine import parse_module

        assert parse_module(str(tmp_path / "gone.py")) is None


# -- P001: ack before the covering commit -------------------------------------

class TestP001AckBeforeCommit:
    def test_fires_on_ack_before_group_commit(self):
        """The incident shape: the original ingest acked each event at
        enqueue time, before the segment fsync (R003's fsync-before-
        cursor, lifted across the IPC boundary)."""
        hits = run_rule(RuleP001, """
            def commit(wal, pending):
                for p in pending:
                    p.seqno = wal.append(p.payload)
                    p.future.set_result(p.seqno)
                wal.sync()
        """)
        assert [f.rule_id for f in hits] == ["P001"]
        assert "set_result" not in hits[0].message or True
        assert "no covering commit" in hits[0].message
        assert len(hits[0].witness) == 2

    def test_shipped_fix_shape_is_silent(self):
        """Append -> group-commit -> ack (the shipped ordering) carries no
        open obligation at the ack."""
        assert run_rule(RuleP001, """
            def commit(wal, pending):
                for p in pending:
                    p.seqno = wal.append(p.payload)
                wal.sync()
                for p in pending:
                    p.future.set_result(p.seqno)
        """) == []

    def test_uncommitted_callee_write_reaches_callers_ack(self):
        """Interprocedural credit: a helper that appends WITHOUT syncing
        leaves the obligation open in its caller."""
        hits = run_rule(RuleP001, """
            def stage(wal, payload):
                return wal.append(payload)

            def commit(wal, payload, fut):
                seqno = stage(wal, payload)
                fut.set_result(seqno)
        """)
        assert [(f.rule_id, f.symbol) for f in hits] == [("P001", "commit")]

    def test_internally_committed_callee_is_net_durable(self):
        """A helper that appends AND syncs is a net commit point: its
        caller may ack immediately."""
        assert run_rule(RuleP001, """
            def stage(wal, payload):
                seqno = wal.append(payload)
                wal.sync()
                return seqno

            def commit(wal, payload, fut):
                fut.set_result(stage(wal, payload))
        """) == []

    def test_error_path_without_ack_is_separated(self):
        """A branch that raises before acking never merges into the
        fall-through path's obligation set."""
        assert run_rule(RuleP001, """
            def commit(wal, p):
                wal.append(p.payload)
                if p.poisoned:
                    raise ValueError(p)
                wal.sync()
                p.future.set_result(1)
        """) == []


# -- P002: cursor advance before the publication completes --------------------

class TestP002AdvanceBeforePublish:
    def test_fires_on_advance_before_publish(self):
        """The incident shape: each partition cursor advanced as soon as
        its batch merged, before the merged model was published."""
        hits = run_rule(RuleP002, """
            def run_once(cursor, registry, batch, model):
                cursor.advance(batch.last_seqno)
                version = registry.publish(model)
                return version
        """)
        assert [f.rule_id for f in hits] == ["P002"]
        assert "before the registry-publish" in hits[0].message

    def test_publish_notify_advance_order_is_silent(self):
        """The shipped ordering: publish -> notify -> advance."""
        assert run_rule(RuleP002, """
            def run_once(cursor, registry, batch, model):
                version = registry.publish(model)
                notify_swap(version)
                cursor.advance(batch.last_seqno)
                return version
        """) == []

    def test_terminated_noop_branch_does_not_pollute(self):
        """The RetrainLoop.run_once noop shape: an early-return branch
        may advance (nothing to publish there) without flagging the
        fall-through path that publishes."""
        assert run_rule(RuleP002, """
            def run_once(cursor, registry, batch, model):
                if batch.empty:
                    cursor.advance(batch.last_seqno)
                    return "noop"
                version = registry.publish(model)
                cursor.advance(batch.last_seqno)
                return version
        """) == []

    def test_live_branch_advance_reaches_the_publish(self):
        """An advance on a branch that FALLS THROUGH to the publish is
        the real inversion (the skip-past shape the baseline defends in
        RetrainLoop.run_once)."""
        hits = run_rule(RuleP002, """
            def run_once(cursor, registry, batch, model):
                if batch.foreign_only:
                    cursor.advance(batch.last_seqno)
                version = registry.publish(model)
                return version
        """)
        assert [f.rule_id for f in hits] == ["P002"]

    def test_checkpoint_without_publish_is_silent(self):
        """A retry drain that checkpoints and never publishes (the
        ingest _flush_retries shape) carries no ordering obligation."""
        assert run_rule(RuleP002, """
            def flush_retries(wal, parked):
                for p in parked:
                    insert(p)
                    wal.checkpoint(p.seqno)
        """) == []


# -- P003: cross-process version skew over the ring edge ----------------------

_P003_PRODUCER = """
    class Ring:
        def push(self, meta, body):
            pass

        def pop(self):
            return {}, b""

    def produce(ring, blob, generation):
        ring.push({"version": generation}, blob)

    def main():
        produce(Ring(), b"", 1)

    if __name__ == "__main__":
        main()
"""


class TestP003ProcessRoleStitching:
    def _consumer(self, body: str) -> str:
        indented = textwrap.indent(textwrap.dedent(body).strip(), "    ")
        return (
            "from predictionio_tpu_torch.pkg.mod0 import Ring\n\n"
            "def consume(ring):\n"
            f"{indented}\n\n"
            "def main():\n"
            "    consume(Ring())\n\n"
            'if __name__ == "__main__":\n'
            "    main()\n"
        )

    def test_unguarded_read_across_ring_edge_fires(self):
        """The stitching test: the frame is pushed by one __main__
        module's process role and popped by another's; reading its
        version field with no guard comparison is cross-process skew."""
        index = build_index(
            _P003_PRODUCER,
            self._consumer("""
                meta, body = ring.pop()
                return meta["version"]
            """),
        )
        hits = list(RuleP003().check_package(index))
        assert [f.rule_id for f in hits] == ["P003"]
        assert "'version'" in hits[0].message
        assert "predictionio_tpu_torch.pkg.mod0" in hits[0].message

    def test_guard_comparison_in_acquisition_is_silent(self):
        index = build_index(
            _P003_PRODUCER,
            self._consumer("""
                meta, body = ring.pop()
                if meta["version"] != ring.generation:
                    return None
                return meta["version"]
            """),
        )
        assert list(RuleP003().check_package(index)) == []

    def test_same_process_read_is_silent(self):
        """Producer and consumer reached from the SAME __main__ module:
        no process boundary, no P003 (that is C/R territory)."""
        index = build_index("""
            class Ring:
                def push(self, meta, body):
                    pass

                def pop(self):
                    return {}, b""

            def produce(ring, blob, generation):
                ring.push({"version": generation}, blob)

            def consume(ring):
                meta, body = ring.pop()
                return meta["version"]

            def main():
                ring = Ring()
                produce(ring, b"", 1)
                consume(ring)

            if __name__ == "__main__":
                main()
        """)
        assert list(RuleP003().check_package(index)) == []

    def test_process_roles_seed_distinct_main_modules(self):
        """Two entry modules are two DISTINCT process roles -- the
        cross-process analogue of thread roles."""
        index = build_index(_P003_PRODUCER, self._consumer("""
            meta, body = ring.pop()
            return meta["version"]
        """))
        flow = index.protocols()
        prod = flow.proc.roles_of(("predictionio_tpu_torch/pkg/mod0.py",
                                   "produce"))
        cons = flow.proc.roles_of(("predictionio_tpu_torch/pkg/mod1.py",
                                   "consume"))
        assert {r.module for r in prod} == {"predictionio_tpu_torch.pkg.mod0"}
        assert {r.module for r in cons} == {"predictionio_tpu_torch.pkg.mod1"}


# -- P004: routing-hash drift -------------------------------------------------

class TestP004RoutingDrift:
    def test_fires_on_private_modulus(self):
        """The spec-vs-impl drift shape (the sentinel small-catalog bug
        class): a second `% n_shards` is a second routing opinion."""
        hits = run_rule(RuleP004, """
            import zlib

            def route(entity_id, num_shards):
                return zlib.crc32(entity_id.encode()) % num_shards
        """)
        assert [f.rule_id for f in hits] == ["P004"]
        assert "stable_bucket" in hits[0].message
        assert hits[0].symbol == "route"

    def test_blessed_stable_bucket_call_is_silent(self):
        assert run_rule(RuleP004, """
            from predictionio_tpu_torch.utils.stablehash import stable_bucket

            def route(entity_id, num_shards):
                return stable_bucket(entity_id, num_shards)
        """) == []

    def test_non_routing_modulus_is_silent(self):
        """Feature hashing (`% dim`), ring arithmetic (`% slots`) and
        friends are not routing decisions."""
        assert run_rule(RuleP004, """
            import zlib

            def feature(token, dim):
                return zlib.crc32(token.encode()) % dim

            def slot(seq, n_slots):
                return seq % n_slots
        """) == []

    def test_stablehash_module_itself_is_exempt(self):
        assert run_rule(RuleP004, """
            import zlib

            def stable_bucket(key, buckets):
                if buckets <= 1:
                    return 0
                return zlib.crc32(str(key).encode("utf-8")) % buckets
        """, path="predictionio_tpu_torch/utils/stablehash.py") == []


# -- P005: handshake durability -----------------------------------------------

class TestP005HandshakeDurability:
    def test_fires_on_unsynced_portfile_rename(self):
        """The incident shape (an un-fsynced checkpoint rename, at
        the process boundary): rename-then-crash publishes stale
        bytes."""
        hits = run_rule(RuleP005, """
            import os

            def write_portfile(portfile, port):
                tmp = portfile + ".tmp"
                with open(tmp, "w") as f:
                    f.write(str(port))
                os.replace(tmp, portfile)
        """)
        assert [f.rule_id for f in hits] == ["P005"]
        assert "no covering fsync" in hits[0].message

    def test_fsynced_portfile_rename_is_silent(self):
        """The shipped shard.py shape: tmp + flush + fsync + replace."""
        assert run_rule(RuleP005, """
            import os

            def write_portfile(portfile, port):
                tmp = portfile + ".tmp"
                with open(tmp, "w") as f:
                    f.write(str(port))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, portfile)
        """) == []

    def test_fires_on_layout_marker_without_dir_fsync(self):
        """The wal.parts shape, since fixed: the marker file is fsynced
        but the directory entry is not."""
        hits = run_rule(RuleP005, """
            import os

            _PARTS_FILE = "wal.parts"

            def write_marker(directory, n):
                path = os.path.join(directory, _PARTS_FILE)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(str(n))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
        """)
        assert [f.rule_id for f in hits] == ["P005"]
        assert "directory entry" in hits[0].message

    def test_dir_fsync_after_marker_rename_is_silent(self):
        """The shipped fix shape: os.replace then _fsync_dir."""
        assert run_rule(RuleP005, """
            import os

            _PARTS_FILE = "wal.parts"

            def _fsync_dir(path):
                fd = os.open(path, os.O_RDONLY)
                try:
                    os.fsync(fd)
                finally:
                    os.close(fd)

            def write_marker(directory, n):
                path = os.path.join(directory, _PARTS_FILE)
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(str(n))
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
                _fsync_dir(directory)
        """) == []

    def test_fires_on_ready_consumed_without_crc(self):
        hits = run_rule(RuleP005, """
            def wait_ready(dirpath):
                with open(dirpath + "/READY") as f:
                    return f.read()
        """)
        assert [f.rule_id for f in hits] == ["P005"]
        assert "CRC" in hits[0].message

    def test_ready_with_crc_verify_is_silent(self):
        assert run_rule(RuleP005, """
            import zlib

            def wait_ready(dirpath, expected):
                with open(dirpath + "/READY", "rb") as f:
                    blob = f.read()
                if zlib.crc32(blob) != expected:
                    return None
                return blob
        """) == []


# -- --protocol-report: the commit/publish/advance inventory ------------------

class TestProtocolReport:
    def test_cli_text_lists_known_sites(self, capsys):
        """The repo's own protocol surface shows up: ingest's group
        commit and ack, the retrain loop's cursor advances, the wal
        marker's dir fsync."""
        from predictionio_tpu_torch.analysis.engine import run_cli

        assert run_cli(["--protocol-report"]) == 0
        out = capsys.readouterr().out
        assert "protocol-report:" in out
        assert "predictionio_tpu_torch/data/ingest.py" in out
        assert "[commit:group-commit]" in out
        assert "[publish:future-ack]" in out
        assert "[advance:cursor-advance]" in out
        assert "[commit:dir-fsync]" in out

    def test_json_and_sarif_round_trip(self, capsys):
        """--protocol-report's sarif round-trips against its json."""
        from predictionio_tpu_torch.analysis.engine import run_cli

        assert run_cli(["--protocol-report", "--format", "json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["total"] == len(doc["sites"]) > 0
        assert sum(doc["counts"].values()) == doc["total"]
        for site in doc["sites"]:
            assert set(site) == {"kind", "protocol", "path", "qual",
                                 "line", "detail"}
        assert run_cli(["--protocol-report", "--format", "sarif"]) == 0
        sarif = json.loads(capsys.readouterr().out)
        assert sarif["version"] == "2.1.0"
        results = sarif["runs"][0]["results"]
        assert len(results) == doc["total"]
        sarif_locs = {
            (r["locations"][0]["physicalLocation"]["artifactLocation"]["uri"],
             r["locations"][0]["physicalLocation"]["region"]["startLine"])
            for r in results
        }
        json_locs = {(s["path"], s["line"]) for s in doc["sites"]}
        assert sarif_locs == json_locs
        assert all(r["ruleId"].startswith("protocol-report/")
                   for r in results)

    def test_scoped_report_rejects_bad_paths(self, capsys):
        from predictionio_tpu_torch.analysis.engine import run_cli

        assert run_cli(["--protocol-report", "no/such/dir"]) == 2
        assert "no such file" in capsys.readouterr().out


def test_p_family_sweep_stays_under_two_seconds_solo():
    """The P family's budget: the protocol-flow build (site classification,
    transitive tags, process roles) + all five P rules over the whole
    package, solo, inside 2 s on the 2-core box."""
    from predictionio_tpu_torch.analysis.engine import select_rules

    best = float("inf")
    for _ in range(2):
        t = {}
        check_paths(
            rules=select_rules(["P001", "P002", "P003", "P004", "P005"]),
            timings=t,
        )
        best = min(best, t["families"]["P"])
    assert best < 2.0, f"P family took {best:.2f}s solo (budget 2s)"



# -- the port against the reference -------------------------------------------

#: the rule ids the port carries: the reference's C, R and P families
PORT_RULES = {"C001", "C002", "C004", "C005", "C006", "R001", "R002", "R003",
              "R004", "P001", "P002", "P003", "P004", "P005"}


def _without_witness(message: str) -> str:
    """A finding's message less any lockwatch runtime-witness clause,
    which reads whichever watch the process runs."""
    return re.sub(r";?\s*runtime witness: .*$", "", message)


def _rows(findings):
    return [(f.rule_id, f.severity, f.path, f.line, f.symbol,
             _without_witness(f.message)) for f in findings]


def test_the_references_engine_finds_what_the_ports_finds():
    """The differential test: both engines sweep ``predictionio_tpu_torch/``
    with no baseline. The reference's C, R and P findings equal the
    port's, finding for finding and in order; its J and S families, which
    the port does not carry, find nothing there."""
    from predictionio_tpu.analysis import engine as jax_engine
    from predictionio_tpu_torch.analysis import engine

    from predictionio_tpu.analysis.packageindex import PackageIndex as JaxPackageIndex

    port_root = engine.package_root()
    assert os.path.basename(port_root) == "predictionio_tpu_torch"
    ours = check_paths()
    try:
        theirs = jax_engine.check_paths([port_root])
    finally:
        # the reference's memos of the port's trees are this test's alone
        jax_engine._parse_cache.clear()
        JaxPackageIndex._build_memo = None
    assert [f for f in theirs if f.rule_id[0] in "JS"] == []
    assert _rows(ours) == _rows(theirs)
    assert ours and {f.rule_id for f in ours} <= PORT_RULES
    assert {f.path.split("/")[0] for f in ours} == {"predictionio_tpu_torch"}


def _cited_tests(justification: str) -> list:
    return re.findall(r"(tests/test_torch_\w+\.py)::([\w:\[\]-]+)", justification)


def _test_defined(path: str, name: str) -> bool:
    """``name`` (``func``, ``Class`` or ``Class::func``) is defined in
    the file."""
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    *owner, func = name.split("[")[0].split("::")
    scope = tree.body
    for cls in owner:
        found = [n for n in scope if isinstance(n, ast.ClassDef) and n.name == cls]
        if not found:
            return False
        scope = found[0].body
    return any(isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name == func
               for n in scope)


def test_port_baseline_carries_the_references_entries():
    """The port's 36 entries are the reference's keys on the port's paths
    (the loop holds the engine's ``algorithms`` and ``models``, as the
    reference's does). Each justification cites the port's file; each P,
    R001 and R003 entry names a port test that exists."""
    from predictionio_tpu.analysis.engine import load_baseline as jax_load

    ours = load_baseline()
    keys = {(e["rule"], e["path"], e["symbol"]) for e in ours}
    assert len(ours) == len(keys) == 36
    carried = {(r, p.replace("predictionio_tpu/", "predictionio_tpu_torch/", 1), s)
               for r, p, s in ((e["rule"], e["path"], e["symbol"]) for e in jax_load())
               if r[0] not in "JS"}
    assert keys == carried
    for e in ours:
        assert e["path"] in e["justification"], e
        cited = _cited_tests(e["justification"])
        if e["rule"][0] == "P" or e["rule"] in ("R001", "R003"):
            assert cited, f"{e['rule']} {e['symbol']} names no port test"
        for path, name in cited:
            assert _test_defined(path, name), f"{path}::{name} does not exist"


def test_check_runs_without_torch_or_jax():
    """``pio check`` and the pre-commit entry, each in a fresh process:
    exit 0 with nothing unsuppressed, and neither ``torch`` nor ``jax``
    is imported (the console's check verb stays a light verb)."""
    out = _fresh_python("""
        import contextlib, io, json, sys
        from predictionio_tpu_torch.tools.cli import main
        from predictionio_tpu_torch.tools import precommit
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["check", "--format", "json"])
            rc_self = main(["check", "--self-check"])
            rc_hook = precommit.main(["--format", "json"])
        doc = json.loads(buf.getvalue().split("self-check OK")[0])
        print(json.dumps({
            "rc": [rc, rc_self, rc_hook],
            "unsuppressed": doc["analysis_findings_total"],
            "stale": len(doc["stale_baseline"]),
            "suppressed": len(doc["suppressed"]),
            "imported": sorted(m for m in ("torch", "jax") if m in sys.modules),
        }))
    """)
    got = json.loads(out.strip().splitlines()[-1])
    assert got["rc"] == [0, 0, 0]
    assert (got["unsuppressed"], got["stale"]) == (0, 0) and got["suppressed"] > 0
    assert got["imported"] == []


@pytest.mark.parametrize("argv", [["--rules", "J004"], ["--rules", "S003,C002"],
                                  ["--explain", "J001"], ["--explain", "S005"]])
def test_j_and_s_rule_ids_exit_2_with_the_catalog(argv, capsys):
    """The J and S families are not carried: their ids are unknown ids,
    which exit 2 with the catalog of the port's rules."""
    from predictionio_tpu_torch.analysis.engine import run_cli

    assert run_cli(argv) == 2
    out = capsys.readouterr().out
    assert "unknown rule id" in out
    assert all(rid in out for rid in ("C001", "R001", "P005"))


def test_mesh_report_exits_2(capsys):
    from predictionio_tpu_torch.analysis.engine import run_cli

    assert run_cli(["--mesh-report"]) == 2
    assert "no JAX mesh layer" in capsys.readouterr().out
    assert run_cli(["--mesh-report", "--protocol-report"]) == 2
    assert "exclusive" in capsys.readouterr().out


def test_changed_keeps_only_the_ports_files(monkeypatch, capsys):
    """``--changed`` over a diff that also touches the JAX package and the
    tests: only the port's package is parsed and only its changed file is
    reported -- its findings, unbaselined, exit 1."""
    from predictionio_tpu_torch.analysis import engine

    monkeypatch.setattr(engine, "changed_files", lambda: [
        "predictionio_tpu/data/wal.py", "tests/test_analysis.py",
        "predictionio_tpu_torch/data/wal.py"])
    swept = []
    real = engine.check_paths

    def spy(paths=None, rules=None, module_scope=None, timings=None):
        swept.append((list(paths or []), set(module_scope or ())))
        return real(paths, rules, module_scope, timings)

    monkeypatch.setattr(engine, "check_paths", spy)
    assert engine.run_cli(["--changed", "--baseline", "none", "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert swept == [([engine.package_root()], {"predictionio_tpu_torch/data/wal.py"})]
    assert {f["path"] for f in doc["findings"]} == {"predictionio_tpu_torch/data/wal.py"}
    assert ("R003", "WriteAheadLog.checkpoint") in {
        (f["rule_id"], f["symbol"]) for f in doc["findings"]}
    # with the baseline the same diff is clean
    assert engine.run_cli(["--changed"]) == 0
    capsys.readouterr()


def test_the_port_runs_the_c_r_and_p_families():
    from predictionio_tpu_torch.analysis import all_rules

    ids = {r.rule_id for r in all_rules()}
    assert ids == PORT_RULES
    timings = {}
    check_paths(timings=timings)
    assert set(timings["families"]) == {"C", "R", "P"}


def test_protocol_routing_is_blessed_at_the_ports_stablehash():
    """P004 exempts the one blessed routing implementation, the port's
    ``utils/stablehash.py``, and flags the same modulus elsewhere."""
    from predictionio_tpu_torch.analysis.protocols import PROTOCOLS

    blessed = {p.name: p.blessed for p in PROTOCOLS}["shard-routing"]
    assert blessed == "predictionio_tpu_torch/utils/stablehash.py"
    assert os.path.exists(os.path.join(REPO, blessed))
    src = """
        def pick(key, shards):
            return hash(key) % shards
    """
    assert run_rule(RuleP004, src, blessed) == []
    assert [f.rule_id for f in run_rule(RuleP004, src)] == ["P004"]
