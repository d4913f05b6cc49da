"""R-series rules: exception-path resource-lifecycle invariants.

Port of ``predictionio_tpu/analysis/rules_resources.py``.

Built on ``analysis/flowgraph.py``: per-function flowgraphs with
explicit exception edges and a must-release obligation domain,
propagated interprocedurally through the package call graph so a
helper that releases on behalf of its caller (the ``_respond`` /
``_deliver`` shapes) is credited along the witness path. Each finding
reports the acquiring line and the witness hand-off path.

Every rule class docstring IS its incident-catalog entry: ``pio check
--explain RULE`` prints it, and the R table in
``docs/static_analysis.md`` is generated from it.
"""

from __future__ import annotations

from typing import Iterator

from predictionio_tpu_torch.analysis.engine import Finding
from predictionio_tpu_torch.analysis.flowgraph import ATTACH, FD, LOCK, PERMIT, SPAN
from predictionio_tpu_torch.analysis.packageindex import PackageIndex, PackageRule


def _witness(fi, ob, leak) -> tuple:
    hops = [f"{fi.path}:{fi.qual}:{ob.line}"]
    hops.extend(leak.trail)
    hops.append(f"{fi.path}:{fi.qual}:{leak.line}")
    return tuple(hops)


def _witness_text(hops: tuple) -> str:
    return " -> ".join(hops)


def _grouped(index: PackageIndex) -> dict:
    """(function, obligation) -> {exit kind: Leak}; one finding per
    obligation, classified by the worst exit it survives to."""
    out: dict = {}
    for leak in index.resources().leaks:
        rec = out.setdefault((leak.fi.key, id(leak.ob)), {
            "fi": leak.fi, "ob": leak.ob, "exits": {},
        })
        rec["exits"].setdefault(leak.exit, leak)
    return out


class RuleR001(PackageRule):
    """A resource acquired but not released on some exception path out
    of the acquiring function: an admission permit
    (``Semaphore``/tracker ``.acquire()`` idioms), a raw
    ``Lock.acquire`` outside ``with``, or an
    ``open``/``mmap``/``socket`` descriptor that an exception edge
    carries past its ``close``. Releases by a helper the value (or the
    owning field) is handed to are credited through the package call
    graph -- the finding means NO path out of the function, direct or
    delegated, discharges the obligation on that exception edge.

    Incident: a review caught the async watchdog holding
    admission permits for requests whose batch had wedged (a 503 path
    that never released), and the rule's first sweep convicted the ring
    consumer's retired-worker race -- a permit acquired, then
    ``ring.requests.pop()`` raising on a ring the supervisor had just
    closed, leaked the permit through the recovery ``continue`` and
    permanently shrank ``max_inflight``."""

    rule_id = "R001"
    severity = "error"

    def check_package(self, index: PackageIndex) -> Iterator[Finding]:
        for rec in sorted(
            _grouped(index).values(),
            key=lambda r: (r["fi"].key, r["ob"].line),
        ):
            ob, fi = rec["ob"], rec["fi"]
            if ob.kind not in (PERMIT, LOCK, FD):
                continue
            if "normal" in rec["exits"]:
                continue  # R004 owns the stronger never-released shape
            leak = rec["exits"]["exception"]
            hops = _witness(fi, ob, leak)
            yield Finding(
                self.rule_id, self.severity, fi.path, ob.line, fi.qual,
                f"{ob.kind} {ob.label!r} acquired at line {ob.line} is not "
                f"released on an exception path out of {fi.qual} "
                f"(leak edge at line {leak.line}; witness path: "
                f"{_witness_text(hops)})",
                "release in a finally/backstop handler, or hand the "
                "obligation to a helper that owns it on every path "
                "(the _deliver/_CompletionRetry shape)",
                witness=hops,
            )


class RuleR002(PackageRule):
    """A trace span started (``tracer.span``/``start_remote`` used as an
    explicit handle, not a ``with``) or attached
    (``Span.attach()``) with some path out of the function that
    neither finishes nor detaches it and never hands it to an owner.
    ``finally``-finished spans, handles forwarded to a finishing helper
    (``_finish_async_response``), handles stored into an owning
    entry/container, and the sampled-out-sentinel
    ``SAMPLED_OUT_ROOT.attach()/detach()`` discipline are all credited
    and stay silent.

    Incident: the non-UTF-8-body live-trace leak (a review finding): a
    request body that raised ``UnicodeDecodeError`` slipped past the
    ``json.JSONDecodeError`` handler, so the root span started on the
    ring consumer was never finished -- the trace stayed live forever
    and the request escaped its 500-envelope contract. The fix shape is
    the whole-submit-path catch-all backstop plus ``finally:
    guard.detach()``."""

    rule_id = "R002"
    severity = "error"

    def check_package(self, index: PackageIndex) -> Iterator[Finding]:
        for rec in sorted(
            _grouped(index).values(),
            key=lambda r: (r["fi"].key, r["ob"].line),
        ):
            ob, fi = rec["ob"], rec["fi"]
            if ob.kind not in (SPAN, ATTACH):
                continue
            leak = rec["exits"].get("exception") or rec["exits"]["normal"]
            hops = _witness(fi, ob, leak)
            what = (
                "attached to the thread context stack and never detached"
                if ob.kind == ATTACH else "started and neither finished nor "
                "handed to an owner"
            )
            yield Finding(
                self.rule_id, self.severity, fi.path, ob.line, fi.qual,
                f"span handle {ob.label!r} ({ob.kind}) is {what} on a "
                f"{leak.exit} path out of {fi.qual} (leak edge at line "
                f"{leak.line}; witness path: {_witness_text(hops)})",
                "finish/detach in a finally, add a catch-all backstop "
                "that finishes the root, or forward the handle to the "
                "shared _respond tail",
                witness=hops,
            )


class RuleR003(PackageRule):
    """A durability-protocol violation, checked as an ordering
    obligation at the commit site: a tmp file renamed into its commit
    location (``os.replace``/``os.rename``) on a path where the bytes
    written were never fsynced (file or directory), or a
    checkpoint/cursor write ordered BEFORE the fsync of the data it
    claims to cover. Helpers that fsync on the caller's behalf
    (``_fsync_dir``, a parameter the callee fsyncs) are credited
    through the call-graph summaries.

    Incident: the WAL/registry/snapshot tmp+fsync+rename contract --
    a rename WITHOUT the fsync publishes a name whose bytes can vanish
    in a crash, exactly the torn-manifest class the snapshot store's
    CRC checks exist to catch after the fact. The rule's first sweep
    convicted the training-checkpoint meta sidecar
    (``workflow/checkpoint.py``), which renamed un-fsynced resume
    metadata into place."""

    rule_id = "R003"
    severity = "error"

    def check_package(self, index: PackageIndex) -> Iterator[Finding]:
        for rec in sorted(
            index.resources().durability,
            key=lambda r: (r.fi.key, r.line),
        ):
            yield Finding(
                self.rule_id, self.severity, rec.fi.path, rec.line,
                rec.fi.qual,
                f"durability-protocol violation ({rec.kind}): {rec.detail}",
                "fsync the written file (and the directory for new names) "
                "before the rename/checkpoint that commits it -- the "
                "data/snapshot discipline",
            )


class RuleR004(PackageRule):
    """An obligation that dies with no owner: a permit, raw lock, or
    descriptor acquired into a local (or bare ``acquire()`` on a
    field) that reaches the NORMAL exit of the function still open --
    never released, never returned, never stored, never handed to a
    releasing helper. Where R001 flags the exception edge that skips an
    existing release, R004 flags the shape where no release exists at
    all.

    Incident: the ``_CompletionRetry`` deadline-drop review finding:
    a parked completion whose deadline expired was dropped --
    response gone, fine -- but the admission permit riding the entry
    was dropped WITH it, so every expired retry permanently shrank the
    scorer's admission window until the tier wedged closed."""

    rule_id = "R004"
    severity = "error"

    def check_package(self, index: PackageIndex) -> Iterator[Finding]:
        for rec in sorted(
            _grouped(index).values(),
            key=lambda r: (r["fi"].key, r["ob"].line),
        ):
            ob, fi = rec["ob"], rec["fi"]
            if ob.kind not in (PERMIT, LOCK, FD):
                continue
            if "normal" not in rec["exits"]:
                continue
            leak = rec["exits"]["normal"]
            hops = _witness(fi, ob, leak)
            yield Finding(
                self.rule_id, self.severity, fi.path, ob.line, fi.qual,
                f"{ob.kind} {ob.label!r} acquired at line {ob.line} "
                f"escapes {fi.qual} with no owner: the normal exit at "
                f"line {leak.line} drops it unreleased (witness path: "
                f"{_witness_text(hops)})",
                "release before every exit, store the obligation on an "
                "owner that releases it, or return it to the caller",
                witness=hops,
            )


RULES = (RuleR001, RuleR002, RuleR003, RuleR004)
