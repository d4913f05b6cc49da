"""P-series rules: cross-process protocol ordering over the fabric.

Port of ``predictionio_tpu/analysis/rules_protocol.py``.

Built on ``analysis/protocols.py``: the declared commit/publish/advance
point model classified over the package call graph, with process
roles seeded at ``__main__`` guards and stitched through ring, portfile,
and ``--notify`` edges.  Where the R series proves ordering inside one
process (fsync-before-cursor on one flowgraph), the P series proves it
across the IPC boundary: the ack a peer observes, the cursor another
process replays from, the generation guard a frame must bind.

P004 is deliberately a *module* rule (a routing ``%`` is file-local
evidence), so ``pio check --changed`` runs it per file inside the
pre-commit budget; the ordering rules (P001/P002/P003/P005) are
package-horizon like the rest of phase 2.

Every rule class docstring IS its incident-catalog entry: ``pio check
--explain RULE`` prints it, and the P table in
``docs/static_analysis.md`` is generated from it.
"""

from __future__ import annotations

import ast
from typing import Iterator

from predictionio_tpu_torch.analysis.engine import Finding
from predictionio_tpu_torch.analysis.packageindex import PackageRule
from predictionio_tpu_torch.analysis.protocols import routing_mod_sites


def _hops(fi, *lines) -> tuple:
    return tuple(f"{fi.path}:{fi.qual}:{line}" for line in lines)


class RuleP001(PackageRule):
    """An acknowledgement -- a future ``set_result``, an HTTP 2xx, or a
    ring completion push -- reachable on some path while a WAL/journal
    append on that path is not yet covered by a commit point (an
    ``os.fsync``, an ``.fsync``, or the WAL's group-commit ``sync``).
    This is R003 generalized across the IPC boundary: the peer that
    observes the ack is in another process, so no amount of in-process
    ordering after the fact can retract it. Callees are credited
    transitively: a helper that appends AND syncs internally is a net
    commit; a helper that appends without syncing leaves the obligation
    open in its caller.

    Incident: the ingest pipeline's original shape acked an event at
    enqueue time, before the segment fsync -- a SIGKILL between the 201
    and the group commit silently dropped acked events, which the
    at-least-once replay contract (PAPER.md section 4) forbids; the fix
    moved ``future.set_result`` after ``wal.sync()`` and the partitioned
    WAL kept that ordering per shard. This rule pins both.
    """

    rule_id = "P001"
    severity = "error"

    def check_package(self, index) -> Iterator[Finding]:
        flow = index.protocols()
        from predictionio_tpu_torch.analysis.protocols import ack_before_commit

        for fi in index.graph.functions.values():
            for wline, wdetail, aline, akind in ack_before_commit(
                flow, fi
            ):
                yield Finding(
                    rule_id=self.rule_id, severity=self.severity,
                    path=fi.path, line=aline, symbol=fi.qual,
                    message=(
                        f"{akind} ack at line {aline} is reachable while "
                        f"the WAL write {wdetail} at line {wline} has no "
                        f"covering commit (fsync/sync) on the path"
                    ),
                    hint=(
                        "move the ack after the covering wal.sync()/"
                        "os.fsync(), or route it through the durability "
                        "point that already exists"
                    ),
                    witness=_hops(fi, wline, aline),
                    related=((fi.path, wline,
                              f"uncommitted write: {wdetail}"),),
                )


class RuleP002(PackageRule):
    """A replay cursor or checkpoint advance reachable on a path BEFORE
    a publication point (registry publish, ``/models/swap`` notify) that
    the same path still performs: the publish->notify->advance order is
    inverted, so a crash between the advance and the publish loses the
    events the cursor already passed. Branches that terminate before
    publishing (early returns, error paths) are path-separated and never
    flag; callees that publish and advance internally in the correct
    order contribute nothing to their callers.

    Incident: exactly-once fold-in replay depends on the cursor being
    the LAST thing that moves -- publish the model, notify the serving
    fabric, then advance. The retrain loop's first draft advanced each
    partition cursor as soon as its batch merged, before the merged
    model was published; a crash after the advance and before the
    publish dropped the window from every follower. The fix ordered
    ``registry.publish`` -> ``_notify_swap`` -> ``cursor.advance``, and
    the partitioned follower kept the order per partition cursor.
    """

    rule_id = "P002"
    severity = "error"

    def check_package(self, index) -> Iterator[Finding]:
        flow = index.protocols()
        from predictionio_tpu_torch.analysis.protocols import (
            advance_before_publish,
        )

        for fi in index.graph.functions.values():
            for aline, adetail, pline, pkind in advance_before_publish(
                flow, fi
            ):
                yield Finding(
                    rule_id=self.rule_id, severity=self.severity,
                    path=fi.path, line=aline, symbol=fi.qual,
                    message=(
                        f"cursor advance {adetail} at line {aline} is "
                        f"reachable before the {pkind} at line {pline} "
                        f"completes: a crash in between loses the "
                        f"consumed window"
                    ),
                    hint=(
                        "advance the cursor only after every publication "
                        "obligation on the path has completed "
                        "(publish -> notify -> advance)"
                    ),
                    witness=_hops(fi, aline, pline),
                    related=((fi.path, pline,
                              f"later publication point ({pkind})"),),
                )


class RuleP003(PackageRule):
    """A guard field (``generation``/``epoch``/``version``) read off a
    ring-popped frame in a function that never compares any guard value,
    running in a process role distinct from every frame producer's role:
    the consumer trusts a cross-process version without binding the
    swap-epoch guard in the acquisition that read it. Process roles are
    seeded at each module's ``__main__`` guard (each entry module is its
    own process) and propagated over call edges -- the cross-process
    extension of the C-series thread roles, stitched through the ring
    edge.

    Incident: the swap-epoch protocol exists because a scorer shard and
    its frontend restart independently -- a completion frame addressed
    to ring generation G must be dropped by a generation-G+1 consumer,
    not served. Reading ``frame["version"]`` without comparing it to the
    bound generation reintroduces the stale-read the per-shard hot swap
    was built to exclude: a respawned shard would serve scores from the
    dead epoch's factors.
    """

    rule_id = "P003"
    severity = "error"

    def check_package(self, index) -> Iterator[Finding]:
        flow = index.protocols()
        from predictionio_tpu_torch.analysis.protocols import (
            unguarded_peer_reads,
        )

        for fi in index.graph.functions.values():
            for line, field, labels, pushers in unguarded_peer_reads(
                flow, fi
            ):
                role = labels[0] if labels else "proc:?"
                witness = ()
                roles = flow.proc.roles_of(fi.key)
                if roles:
                    witness = tuple(
                        flow.proc.witness_path(fi.key, sorted(
                            roles, key=lambda r: r.module
                        )[0])
                    )
                yield Finding(
                    rule_id=self.rule_id, severity=self.severity,
                    path=fi.path, line=line, symbol=fi.qual,
                    message=(
                        f"guard field {field!r} read from a ring-popped "
                        f"frame in {role} with no guard comparison in "
                        f"the function; frames are produced by "
                        f"{', '.join(pushers)} in another process"
                    ),
                    hint=(
                        "compare the frame's generation/epoch against "
                        "the guard bound in the same acquisition before "
                        "trusting any versioned field"
                    ),
                    witness=witness,
                )


class RuleP004:
    """A ``%`` partition/shard selection whose right operand names a
    shard, partition, or bucket count, outside the one blessed
    implementation in ``utils/stablehash.py``: routing-hash drift.
    Ingest placed every row with ``stable_bucket``; any second modulus
    is a second opinion about where data lives, and the two WILL
    disagree the day one of them changes. File-local by design so
    ``pio check --changed`` pays one file, not the package horizon.

    Incident: the small-catalog retrieval bug shipped because a spec
    ("pad to the tile boundary") and an implementation (a sentinel that
    aliased a real item id at exactly ``% tile`` boundaries) drifted
    apart with no single source of truth. Routing has the same shape
    with higher stakes: the serving shard map and the ingest partitioner
    each held a private ``crc32(...) % n`` until the package blessed
    ``stable_bucket`` -- a re-derived modulus routes a user's events to
    one shard and their queries to another, which reads as silent empty
    recommendations, not a crash.
    """

    rule_id = "P004"
    severity = "warning"

    def check(self, ctx) -> Iterator[Finding]:
        for line, text in routing_mod_sites(ctx.tree, ctx.path):
            symbol = _enclosing_symbol(ctx.tree, line)
            yield Finding(
                rule_id=self.rule_id, severity=self.severity,
                path=ctx.path, line=line, symbol=symbol,
                message=(
                    f"partition/shard selection `{text}` bypasses "
                    f"utils/stablehash.stable_bucket: a second modulus "
                    f"is a second routing opinion"
                ),
                hint=(
                    "route the selection through stable_bucket(key, n) "
                    "so ingest and serving keep one hash forever"
                ),
            )


class RuleP005(PackageRule):
    """A handshake artifact (portfile, ``wal.parts`` layout marker,
    manifest, READY file) published by ``os.replace``/``os.rename``
    without a preceding fsync on the path, a layout-marker rename whose
    directory entry is never fsynced before the function exits, or a
    READY-style handshake file consumed without any CRC/checksum verify
    in the reader. A handshake file IS a cross-process message: the peer
    that reads it cannot tell a durable publication from one the page
    cache will forget at the next power cut.

    Incident: the checkpoint-cursor rename originally shipped without
    the fsync-before-rename, and recovery after SIGKILL replayed from a
    cursor the filesystem had silently rolled back -- the same shape
    recurs at every process boundary artifact: the scorer portfile the
    supervisor polls, the ``wal.parts`` marker that is the partition
    layout's single source of truth, the registry manifest the fabric
    swaps to. Rename-then-crash without the covering fsyncs leaves the
    OLD bytes (file fsync missed) or NO directory entry (dir fsync
    missed), and the peer process handshakes against a ghost.
    """

    rule_id = "P005"
    severity = "error"

    _MESSAGES = {
        "unsynced-rename": (
            "handshake rename {detail} at line {line} has no covering "
            "fsync on the path: the peer can read pre-rename bytes "
            "after a crash"
        ),
        "layout-no-dirfsync": (
            "layout-marker rename {detail} at line {line} never fsyncs "
            "the directory entry: the marker can vanish at a power cut "
            "and the peer resolves the wrong layout"
        ),
    }
    _HINTS = {
        "unsynced-rename": (
            "write to a tmp path, flush+os.fsync the fd, then "
            "os.replace onto the handshake name"
        ),
        "layout-no-dirfsync": (
            "after os.replace, fsync the containing directory so the "
            "new entry itself is durable"
        ),
    }

    def check_package(self, index) -> Iterator[Finding]:
        flow = index.protocols()
        from predictionio_tpu_torch.analysis.protocols import (
            handshake_findings,
            unverified_ready_reads,
        )

        for fi in index.graph.functions.values():
            for kind, line, detail in handshake_findings(flow, fi):
                yield Finding(
                    rule_id=self.rule_id, severity=self.severity,
                    path=fi.path, line=line, symbol=fi.qual,
                    message=self._MESSAGES[kind].format(
                        detail=detail, line=line
                    ),
                    hint=self._HINTS[kind],
                    witness=_hops(fi, line),
                )
            for line, detail in unverified_ready_reads(flow, fi):
                yield Finding(
                    rule_id=self.rule_id, severity=self.severity,
                    path=fi.path, line=line, symbol=fi.qual,
                    message=(
                        f"READY handshake file consumed at line {line} "
                        f"({detail}) with no CRC/checksum verify in the "
                        f"reader"
                    ),
                    hint=(
                        "verify the artifact's CRC before acting on the "
                        "READY signal; a torn write must read as absent, "
                        "not as ready"
                    ),
                    witness=_hops(fi, line),
                )


def _enclosing_symbol(tree: ast.AST, line: int) -> str:
    """Innermost def/class qualname containing ``line`` (module rules
    have no call-graph FunctionInfo to ask)."""
    best = "<module>"
    best_span = None

    def walk(node, prefix):
        nonlocal best, best_span
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                end = getattr(child, "end_lineno", child.lineno)
                if child.lineno <= line <= end:
                    span = end - child.lineno
                    if best_span is None or span <= best_span:
                        best, best_span = qual, span
                    walk(child, qual)
            else:
                walk(child, prefix)

    walk(tree, "")
    return best


RULES = (RuleP001, RuleP002, RuleP003, RuleP004, RuleP005)
