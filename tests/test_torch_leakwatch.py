"""The port's leakwatch (``predictionio_tpu_torch/analysis/leakwatch.py``):
the R-series runtime companion, held to the reference's own tests
(``tests/test_leakwatch.py``).

A deliberately-leaked span of the port's tracer and a
deliberately-unbalanced permit must be detected, the settle loop must
absorb legitimately-late teardown, ``install()`` must wrap only the
semaphores the port's modules build -- never the JAX package's or a
test's -- and ``PIO_LEAKWATCH=0`` must opt out cleanly.

The pytest run already installs the reference's leakwatch (``tests/conftest.py``),
whose prefix covers the port's semaphores but not the port's spans, which
are another class. So the port's span watch is installed here with
``install(semaphores=False)`` by the autouse fixtures below, which fail a
test that leaves a port span unfinished; the port's test files that start
spans import them. The semaphore hook runs in a fresh interpreter.
"""

import os
import subprocess
import sys
import textwrap
import threading

import pytest

from predictionio_tpu_torch.analysis import leakwatch
from predictionio_tpu_torch.obs.trace import Tracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the install()-dependent tests are meaningless when the operator
#: opted the whole run out
needs_install = pytest.mark.skipif(
    not leakwatch.enabled_default(),
    reason="PIO_LEAKWATCH=0 opts the run out of leakwatch",
)


@pytest.fixture(scope="session")
def port_span_watch_session():
    """The port's span watch, installed once for the session (spans only:
    the reference's watch already wraps the port's semaphores)."""
    if not leakwatch.enabled_default():
        yield
        return
    leakwatch.install(semaphores=False)
    yield
    leakwatch.uninstall()


@pytest.fixture(autouse=True)
def port_span_watch(port_span_watch_session):
    """Fail the test that ended with a NEW unfinished port span (after a
    short settle window: teardown may finish a straggler span a few
    milliseconds after the test body returns)."""
    if not leakwatch.enabled_default():
        yield
        return
    leakwatch.install(semaphores=False)  # idempotent; a test may uninstall
    watch = leakwatch.global_watch()
    before = watch.span_snapshot()
    yield
    leaked = leakwatch.settle(lambda: watch.new_pending_spans(before))
    assert not leaked, "unfinished port span(s) leaked by this test: " + ", ".join(
        f"{s.op} (trace {s.trace_id})" for s in leaked
    )


def _handed_span(tracer, op):
    """Start a span and hand it to the caller. Returning the handle
    transfers the static obligation to the caller (pio check R002's
    escape semantics), so a test that then deliberately never finishes
    it exercises the RUNTIME detector without tripping the static one."""
    span = tracer.span(op)
    return span


@needs_install
def test_deliberately_leaked_span_is_detected():
    """The acceptance shape: a port span started and never finished fails
    the test-end check. The leak is detected, then finished here so THIS
    test's own autouse fixture stays green."""
    assert leakwatch.installed()
    watch = leakwatch.global_watch()
    before = watch.span_snapshot()
    tracer = Tracer(enabled=True)
    span = _handed_span(tracer, "deliberate.leak")
    leaked = watch.new_pending_spans(before)
    assert [s.op for s in leaked] == ["deliberate.leak"]
    # the fixture would now fail the test with the op named; prove the
    # settle loop does NOT absolve a genuine leak
    still = leakwatch.settle(
        lambda: watch.new_pending_spans(before), timeout_s=0.1
    )
    assert [s.op for s in still] == ["deliberate.leak"]
    span.finish()
    assert watch.new_pending_spans(before) == []


@needs_install
def test_the_references_watch_does_not_see_port_spans():
    """Why the port's span watch exists: the reference's leakwatch hooks
    its own ``Span`` class, so a port span is invisible to it."""
    from predictionio_tpu.analysis import leakwatch as jax_leakwatch

    jax_watch = jax_leakwatch.global_watch()
    ours = leakwatch.global_watch()
    jax_before, before = jax_watch.span_snapshot(), ours.span_snapshot()
    span = _handed_span(Tracer(enabled=True), "port.only")
    try:
        assert [s.op for s in ours.new_pending_spans(before)] == ["port.only"]
        assert jax_watch.new_pending_spans(jax_before) == []
    finally:
        span.finish()


def test_finished_and_with_spans_do_not_linger():
    watch = leakwatch.global_watch()
    before = watch.span_snapshot()
    tracer = Tracer(enabled=True)
    with tracer.span("ok.op"):
        with tracer.span("ok.child"):
            pass
    handle = _handed_span(tracer, "ok.handle")
    handle.attach()
    handle.detach()
    handle.finish()
    handle.finish()  # idempotent double finish unregisters once, cleanly
    assert watch.new_pending_spans(before) == []


def test_settle_absorbs_late_teardown():
    """A straggler span finished by a background thread shortly after
    the test body ends must not fail the test."""
    watch = leakwatch.global_watch()
    before = watch.span_snapshot()
    tracer = Tracer(enabled=True)
    span = _handed_span(tracer, "late.finish")
    t = threading.Timer(0.05, span.finish)
    t.start()
    try:
        assert leakwatch.settle(
            lambda: watch.new_pending_spans(before), timeout_s=1.0
        ) == []
    finally:
        t.join()


def test_deliberately_unbalanced_permit_is_detected():
    """The acceptance shape: a permit acquired and never released shows
    up as a net debt at its construction site."""
    watch = leakwatch.LeakWatch()
    watched = watch.wrap_semaphore(threading.Semaphore(2), "pkg.mod:10")
    before = watch.permit_debts()
    watched.acquire()
    debts = leakwatch.LeakWatch.new_debts(before, watch.permit_debts())
    assert list(debts.values()) == [1]
    (key,) = debts
    assert key.startswith("pkg.mod:10")
    watched.release()
    assert leakwatch.LeakWatch.new_debts(before, watch.permit_debts()) == {}


def test_balanced_and_failed_acquires_stay_clean():
    watch = leakwatch.LeakWatch()
    watched = watch.wrap_semaphore(threading.Semaphore(1), "pkg.mod:11")
    before = watch.permit_debts()
    with watched:
        # a failed timed acquire must not charge a phantom permit
        assert watched.acquire(timeout=0.01) is False
    assert leakwatch.LeakWatch.new_debts(before, watch.permit_debts()) == {}


def test_dead_semaphores_fall_out_of_the_ledger():
    watch = leakwatch.LeakWatch()
    watched = watch.wrap_semaphore(threading.Semaphore(1), "pkg.mod:12")
    watched.acquire()
    assert any(k.startswith("pkg.mod:12") for k in watch.permit_debts())
    del watched
    assert not any(k.startswith("pkg.mod:12") for k in watch.permit_debts())


def test_install_wraps_port_semaphores_only():
    """The frame-peek policy, in a fresh interpreter (the pytest run's
    reference watch would wrap the port's factory a second time): the
    port ScorerBridge's admission semaphore is watched at its site, the
    JAX package's and a test's are not, and a balanced acquire/release
    through the wrapper leaves no debt."""
    code = textwrap.dedent("""
        import threading
        from predictionio_tpu_torch.analysis import leakwatch
        leakwatch.install()
        from predictionio_tpu_torch.serving.procserver import ScorerBridge
        from predictionio_tpu.serving.procserver import ScorerBridge as JaxBridge
        bridge = ScorerBridge(None, "127.0.0.1", 0)
        assert isinstance(bridge._inflight, leakwatch._WatchedSemaphore)
        assert bridge._inflight.site.startswith(
            "predictionio_tpu_torch.serving.procserver:")
        assert not isinstance(JaxBridge(None, "127.0.0.1", 0)._inflight,
                              leakwatch._WatchedSemaphore)
        before = leakwatch.global_watch().permit_debts()
        assert bridge._inflight.acquire(timeout=0.1) is True
        bridge._inflight.release()
        assert leakwatch.LeakWatch.new_debts(
            before, leakwatch.global_watch().permit_debts()) == {}
        local = threading.Semaphore(1)  # constructed from test code: real
        assert not isinstance(local, leakwatch._WatchedSemaphore)
        leakwatch.uninstall()
        assert not leakwatch.installed()
        assert not isinstance(ScorerBridge(None, "127.0.0.1", 0)._inflight,
                              leakwatch._WatchedSemaphore)
        print("OK")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_span_only_install_leaves_semaphores_alone():
    """``install(semaphores=False)``, the pytest run's mode: spans are
    watched, ``threading.Semaphore`` is whatever it was before."""
    if not leakwatch.enabled_default():
        pytest.skip("leakwatch disabled for this run")
    assert leakwatch.installed()
    assert leakwatch._REAL_SEMAPHORE is None
    from predictionio_tpu_torch.serving.procserver import ScorerBridge

    bridge = ScorerBridge(None, "127.0.0.1", 0)
    assert not isinstance(bridge._inflight, leakwatch._WatchedSemaphore)


def test_env_opt_out_and_uninstall_restore(monkeypatch):
    monkeypatch.setenv("PIO_LEAKWATCH", "0")
    assert leakwatch.enabled_default() is False
    monkeypatch.delenv("PIO_LEAKWATCH")
    assert leakwatch.enabled_default() is True
    # uninstall restores the real methods; reinstall for the rest of the
    # session (the fixtures above own the lifecycle)
    was = leakwatch.installed()
    if not was:
        pytest.skip("leakwatch disabled for this run")
    from predictionio_tpu_torch.obs import trace

    watch = leakwatch.global_watch()
    leakwatch.uninstall()
    try:
        assert not leakwatch.installed()
        before = watch.span_snapshot()
        span = Tracer(enabled=True).span("untracked")
        assert watch.new_pending_spans(before) == []
        span.finish()
    finally:
        leakwatch.install(semaphores=False)
    assert leakwatch.installed()
    assert isinstance(
        trace.Span, type
    )  # class methods swapped back in, not replaced wholesale
