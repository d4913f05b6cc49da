"""C-series rules: the concurrency invariants, phase 2.

Port of ``predictionio_tpu/analysis/rules_concurrency.py``. Each rule's
docstring is the reference's, its incident one of the reference
package's.

Phase 1 walked one module at a time -- lexical ``with``
nesting plus one level of ``self.`` call propagation -- which matched the
WAL/snapshot incidents but not the shapes the serving/online tiers took,
where the hazard spans files and threads. Phase 2 rebuilds the family on
the whole-package core (``callgraph`` / ``threadroles`` / ``locksets``):

- C001/C002 join locksets over call paths (a blocking call N frames
  below the lock acquisition is the same stall as one frame below);
- C005 follows done-callback and event-loop roles through the call
  graph, including the higher-order hand-offs of the async serving path;
- C006 is the Eraser-style static lockset race detector that replaces
  C003: a field written under one thread role and read/written under
  another with disjoint locksets, package-wide, no module allowlist.

Every rule class docstring IS its incident-catalog entry: ``pio check
--explain RULE`` prints it, and the rule table in
``docs/static_analysis.md`` is generated from it (the paragraph starting
``Incident`` becomes the incident column).
"""

from __future__ import annotations

import ast
from typing import Iterator

from predictionio_tpu_torch.analysis.astutil import call_name, dotted
from predictionio_tpu_torch.analysis.engine import Finding, ModuleContext
from predictionio_tpu_torch.analysis.locksets import blocking_reason
from predictionio_tpu_torch.analysis.packageindex import PackageIndex, PackageRule
from predictionio_tpu_torch.analysis.threadroles import CONCURRENT_KINDS

#: cap on the depth of role-carrying DFS walks (C005/C006); real chains
#: in this repo are <= 6 hops (ring consumer -> ... -> retry queue)
_MAX_DEPTH = 12


def _chain_text(hops: list[str]) -> str:
    return " -> ".join(hops)


class RuleC001(PackageRule):
    """Inconsistent lock-acquisition order: lock A held while acquiring
    B on one path, B held while acquiring A on another -- a cycle in the
    package lock graph, now joined over full call-graph reachability
    (the acquisition of B may sit any number of frames below the holder
    of A). A cycle is a deadlock waiting for the right interleaving.
    Validated at runtime by ``analysis/lockwatch.py``, which records
    actual acquisition-order edges (and the held lockset at every
    acquisition) under tier-1.

    Incident: the snapshot-GC and checkpoint-ordering races
    (snapshot GC vs builder, checkpoint vs flush)."""

    rule_id = "C001"
    severity = "error"

    def check_package(self, index: PackageIndex) -> Iterator[Finding]:
        locks = index.locks
        contexts = locks.entry_contexts()
        #: (held lock, acquired lock) -> (path, line) of first sighting
        edges: dict[tuple, tuple] = {}
        for fkey, facts in sorted(locks.facts.items()):
            inherited = [frozenset()] + sorted(
                contexts.get(fkey, ()), key=sorted
            )
            for lock, held, line in facts.acquisitions:
                for base in inherited:
                    for h in base | held:
                        if h != lock:
                            edges.setdefault(
                                (h, lock), (facts.info.path, line)
                            )
        reported: set[frozenset] = set()
        for (a, b), (path, line) in sorted(
            edges.items(), key=lambda kv: (kv[1], kv[0])
        ):
            if (b, a) not in edges or frozenset((a, b)) in reported:
                continue
            reported.add(frozenset((a, b)))
            rpath, rline = edges[(b, a)]
            sa, sb = index.locks.short_lock(a), index.locks.short_lock(b)
            yield Finding(
                self.rule_id, self.severity, path, line,
                "<module>",
                f"inconsistent lock order: {sa!r} -> {sb!r} "
                f"({path}:{line}) but also {sb!r} -> {sa!r} "
                f"({rpath}:{rline})",
                "pick one global acquisition order and restructure the "
                "second site to follow it",
            )


class RuleC002(PackageRule):
    """Blocking I/O (fsync, SQL execute/commit, socket calls, span
    export, ``queue.put/get`` without timeout, ``urlopen``,
    ``time.sleep``) while holding a lock -- including locks held by a
    CALLER any number of frames up the call graph; such findings report
    the witness call path from the acquisition to the blocking call.

    Incident: the WAL held its writer lock across the group-commit
    fsync, parking every concurrent ``append()`` behind disk latency
    (fixed by dup-ing the fd under the lock, fsync outside); the same
    shape recurred in the snapshot store and the span exporter."""

    rule_id = "C002"
    severity = "warning"

    def check_package(self, index: PackageIndex) -> Iterator[Finding]:
        locks = index.locks
        contexts = locks.entry_contexts()
        for fkey, facts in sorted(locks.facts.items()):
            inherited = sorted(contexts.get(fkey, ()), key=sorted)
            for reason, held, line, _call in facts.blocking:
                if held:
                    yield Finding(
                        self.rule_id, self.severity, facts.info.path, line,
                        facts.info.qual,
                        f"blocking call ({reason}) while holding "
                        f"{', '.join(sorted(locks.short_lock(h) for h in held))}",
                        "move the blocking call outside the critical "
                        "section (capture state under the lock, do I/O "
                        "after release)",
                    )
                elif inherited:
                    ls = inherited[0]
                    chain = locks.context_chain(fkey, ls) + [
                        f"{facts.info.path}:{facts.info.qual}:{line}"
                    ]
                    yield Finding(
                        self.rule_id, self.severity, facts.info.path, line,
                        facts.info.qual,
                        f"blocking call ({reason}) reached with "
                        f"{', '.join(sorted(locks.short_lock(h) for h in ls))} "
                        f"held by a caller (call path: {_chain_text(chain)})",
                        "move the blocking call outside the critical "
                        "section, or stop calling this helper under the "
                        "lock",
                    )


class RuleC004:
    """``fork()``-flavored child creation in a threads-and-locks
    package: ``os.fork()`` / ``os.forkpty()``; ``multiprocessing`` with
    the ``fork`` start method (explicit, or implied by a default-context
    ``Process(...)`` -- on Linux the default IS fork); and lock/registry/
    tracer/batcher-shaped state passed as ``Process`` args (inherited or
    duplicated across the process boundary, it silently diverges).

    Incident: the multi-process serving tier. Every service
    module here starts threads and holds locks (batcher flusher, ingest
    writer, metrics registry, tracer), so a forked child inherits
    possibly-HELD locks with no owner thread -- the next acquire
    deadlocks forever -- and silently-duplicated registries/rings. The
    fix shape is ``serving/procserver.py``'s: ``subprocess.Popen`` of a
    fresh interpreter (or ``get_context("spawn")``), state handed across
    explicitly -- ring files by path, eventfds via ``pass_fds``."""

    rule_id = "C004"
    severity = "error"

    #: dotted-arg name TOKENS (split on "."/"_") that look like
    #: cross-fork-hazardous state; token equality, not substring -- a
    #: substring match flagged 'wall_clock' (lock) and 'timeout_seconds'
    #: (cond), and C004 is error-severity
    _STATE_HINTS = frozenset((
        "lock", "locks", "rlock", "mutex", "registry", "tracer",
        "batcher", "sem", "semaphore", "cond", "condition",
    ))
    _SAFE_CONTEXTS = ("spawn", "forkserver")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        # one walk collects everything; modules that never touch fork/
        # multiprocessing (almost all of them) exit before any per-call
        # analysis, keeping the full-package sweep inside its budget
        mp_aliases, process_names, calls, assigns = self._collect(ctx)
        if not (mp_aliases or process_names) and not any(
            call_name(c) in ("os.fork", "os.forkpty") for c in calls
        ):
            return
        spawn_ctx, fork_ctx = self._context_names(assigns)
        for call in calls:
            name = call_name(call)
            if name in ("os.fork", "os.forkpty"):
                yield Finding(
                    self.rule_id, self.severity, ctx.path, call.lineno,
                    ctx.symbol_for(call),
                    "os.fork() in a package whose modules start threads "
                    "and hold locks: the child inherits possibly-held "
                    "locks with no owner thread",
                    "exec a fresh interpreter (subprocess.Popen) or use a "
                    "multiprocessing spawn context",
                )
                continue
            if name.endswith((".set_start_method", ".get_context")) or name in (
                "set_start_method", "get_context"
            ):
                root = name.split(".")[0]
                if "." in name and root not in mp_aliases and not (
                    root in fork_ctx or root in spawn_ctx
                ):
                    continue
                if call.args and isinstance(call.args[0], ast.Constant) and (
                    call.args[0].value == "fork"
                ):
                    yield Finding(
                        self.rule_id, self.severity, ctx.path, call.lineno,
                        ctx.symbol_for(call),
                        "explicit multiprocessing 'fork' start method: "
                        "forked children inherit this package's locks and "
                        "registries mid-state",
                        'use get_context("spawn") (fresh interpreter) and '
                        "pass state explicitly",
                    )
                continue
            is_process = False
            if name.endswith(".Process"):
                root = name.rsplit(".", 1)[0]
                if root in spawn_ctx:
                    # the documented fix shape -- still check the args
                    yield from self._check_args(ctx, call)
                    continue
                is_process = root in mp_aliases or root in fork_ctx
            elif name in process_names:
                # covers `from multiprocessing import Process` AND its
                # aliased form (`... import Process as P; P(...)`)
                is_process = True
            if is_process:
                yield Finding(
                    self.rule_id, self.severity, ctx.path, call.lineno,
                    ctx.symbol_for(call),
                    "multiprocessing.Process under the platform-default "
                    "start method (fork on Linux): the child inherits "
                    "this package's locks and registries mid-state",
                    'use get_context("spawn").Process or subprocess.Popen',
                )
                yield from self._check_args(ctx, call)

    def _check_args(self, ctx: ModuleContext, call: ast.Call) -> Iterator[Finding]:
        """Lock/registry-shaped state handed to a child process: even a
        spawn context duplicates it (or fails to pickle it at runtime);
        either way the two copies silently diverge."""
        arg_nodes: list[ast.AST] = list(call.args)
        for kw in call.keywords:
            arg_nodes.append(kw.value)
        for node in arg_nodes:
            for sub in ast.walk(node):
                d = dotted(sub)
                if d is None:
                    continue
                tokens = d.lower().replace(".", "_").split("_")
                if any(t in self._STATE_HINTS for t in tokens):
                    yield Finding(
                        self.rule_id, self.severity, ctx.path, call.lineno,
                        ctx.symbol_for(call),
                        f"{d!r} handed to a child process: lock/registry "
                        "state inherited across the process boundary "
                        "diverges silently (or deadlocks if fork-inherited "
                        "while held)",
                        "share by path/fd (ring file, pass_fds) and rebuild "
                        "the object in the child",
                    )
                    break

    @staticmethod
    def _collect(ctx: ModuleContext) -> tuple:
        """One pass over the module: multiprocessing import aliases,
        names bound to its Process class, every Call node, and every
        Assign-from-Call (context-variable candidates)."""
        mp_aliases: set[str] = set()
        process_names: set[str] = set()
        calls: list[ast.Call] = []
        assigns: list[ast.Assign] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                calls.append(node)
            elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                assigns.append(node)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "multiprocessing":
                        mp_aliases.add(alias.asname or "multiprocessing")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "multiprocessing":
                    for alias in node.names:
                        if alias.name == "Process":
                            process_names.add(alias.asname or "Process")
                        if alias.name in ("get_context", "set_start_method"):
                            mp_aliases.add("")  # bare calls resolve to mp
        return mp_aliases, process_names, calls, assigns

    def _context_names(
        self, assigns: "list[ast.Assign]"
    ) -> tuple[set[str], set[str]]:
        """Names assigned from ``get_context("spawn"|"forkserver")`` vs
        ``get_context("fork")`` / bare ``get_context()``."""
        spawn_ctx: set[str] = set()
        fork_ctx: set[str] = set()
        for node in assigns:
            name = call_name(node.value)
            if not (name == "get_context" or name.endswith(".get_context")):
                continue
            method = None
            if node.value.args and isinstance(node.value.args[0], ast.Constant):
                method = node.value.args[0].value
            target_names = {
                t.id for t in node.targets if isinstance(t, ast.Name)
            }
            if method in self._SAFE_CONTEXTS:
                spawn_ctx |= target_names
            else:
                fork_ctx |= target_names
        return spawn_ctx, fork_ctx


class RuleC005(PackageRule):
    """A blocking call (the C002 catalog, plus another future's
    ``.result()``) anywhere in the call graph below a function passed to
    ``Future.add_done_callback`` -- the flusher role -- or below a
    single-threaded ``select`` event loop (the frontend worker's serve
    loop, the ring consumer). Findings report the witness call path from
    the registration/loop down to the blocking call. ``.result()`` on
    the callback's OWN (already-resolved) future argument is exempt,
    tracked through argument forwarding at any depth; event-loop scans
    skip socket verbs (the loops' own sockets are non-blocking by
    construction).

    Incident: the async scorer fast path: every
    ``/queries.json`` response is serialized and pushed to the
    completion ring from a done-callback running ON THE MICRO-BATCHER'S
    FLUSHER THREAD -- one blocking call there stalls every in-flight
    batch, not one request, and the call can hide several frames down
    (`consumer -> submit_query_async -> finish -> on_done -> deliver`).
    The fix shape is ``serving/procserver.py``'s ``_CompletionRetry``:
    one non-blocking push, overflow parked for a timer thread."""

    rule_id = "C005"
    severity = "error"

    def check_package(self, index: PackageIndex) -> Iterator[Finding]:
        reported: set[tuple] = set()
        for role, entry in index.roles.entries(("callback", "eventloop")):
            fi = index.graph.functions.get(entry)
            if fi is None:
                continue
            exempt = (
                frozenset(p for p in fi.params() if p != "self")
                if role.kind == "callback" else frozenset()
            )
            yield from self._scan(
                index, role, fi, exempt,
                [f"{fi.path}:{fi.qual}"], set(), reported,
            )

    def _scan(
        self, index, role, fi, exempt, chain, seen, reported, depth=0
    ) -> Iterator[Finding]:
        state = (fi.key, exempt, role)
        if state in seen or depth > _MAX_DEPTH:
            return
        seen.add(state)
        facts = index.locks.facts.get(fi.key)
        if facts is None:
            return
        for call, _held, line in facts.calls:
            reason = blocking_reason(call)
            if reason is None and isinstance(call.func, ast.Attribute):
                if call.func.attr == "result":
                    recv = dotted(call.func.value) or ""
                    if recv not in exempt:
                        reason = "Future.result()"
            if reason is not None and role.kind == "eventloop" and (
                reason.startswith("socket .")
            ):
                # the loop's own sockets are non-blocking by construction
                reason = None
            if reason is not None:
                key = (fi.path, line, reason)
                if key in reported:
                    continue
                reported.add(key)
                where = (
                    "a Future.add_done_callback callback: it runs on the "
                    "resolving thread (the micro-batcher's flusher on the "
                    "serving path) and stalls every batch behind it"
                    if role.kind == "callback" else
                    "a single-threaded event loop: it stalls every "
                    "connection and ring the loop services"
                )
                yield Finding(
                    self.rule_id, self.severity, fi.path, line,
                    fi.qual,
                    f"blocking call ({reason}) inside {where} "
                    f"[registered at {role.seed}; call path: "
                    f"{_chain_text(chain)}]",
                    "do the work non-blocking and park overflow on "
                    "another thread (the completion-retry-queue shape "
                    "in serving/procserver.py)",
                )
                continue
            for target in index.graph.call_targets.get(
                (fi.path, id(call)), ()
            ):
                fwd = self._forwarded(index, fi, call, target, exempt)
                yield from self._scan(
                    index, role, target, fwd,
                    chain + [f"{target.path}:{target.qual}:{line}"],
                    seen, reported, depth + 1,
                )

    @staticmethod
    def _forwarded(index, caller, call, target, exempt) -> frozenset:
        """Map the caller's exempt (resolved-future) names onto the
        callee's parameters through this call's arguments."""
        if not exempt:
            return frozenset()
        params = target.params()
        offset = 1 if params[:1] == ["self"] else 0
        out = set()
        for i, arg in enumerate(call.args):
            d = dotted(arg)
            if d in exempt and i + offset < len(params):
                out.add(params[i + offset])
        for kw in call.keywords:
            d = dotted(kw.value)
            if d in exempt and kw.arg in params:
                out.add(kw.arg)
        return frozenset(out)


class RuleC006(PackageRule):
    """Eraser-style static lockset race: a field written under one
    thread role and read/written under a different role with DISJOINT
    locksets, anywhere in the package. Roles are inferred
    interprocedurally (``threadroles``): ``Thread(target=...)`` entry
    points, ``threading.Timer`` bodies, done-callback (flusher)
    functions, subprocess ``__main__`` entries -- each a distinct
    concurrent context -- plus the merged "request" role of a class's
    public methods (counted only when some genuinely concurrent role
    also touches the class, so single-threaded tool classes stay
    silent). Locksets join over the witness call path; ``__init__`` and
    thread-constructing lifecycle methods are happens-before the spawn
    and excluded. Findings name both roles, their locksets, the witness
    path, and the lock construction sites so the tier-1 gate can cite
    lockwatch's runtime evidence.

    Incident: generalizes C003 (which guarded a hand-maintained module
    allowlist: ingest/WAL/snapshot/microbatch/metrics/serving/online)
    package-wide after the serving tiers spread cross-thread state over
    modules the allowlist never named -- the ring consumer, the flusher
    callbacks, the retry timer, and the supervisor all mutate scorer
    state the request path reads."""

    rule_id = "C006"
    severity = "error"

    def check_package(self, index: PackageIndex) -> Iterator[Finding]:
        records = self._collect_accesses(index)
        confined = self._confined_classes(index)
        for (ckey, attr), recs in sorted(records.items()):
            if ckey in confined:
                continue
            yield from self._judge(index, ckey, attr, recs)

    # -- access collection --------------------------------------------------
    def _collect_accesses(self, index: PackageIndex) -> dict:
        """(class key, attr) -> list of (group, kind, lockset, line,
        path, func qual, role|None) access records, gathered by walking
        the call graph from every concurrent role entry and every public
        request method. Every ``main`` seed folds into ONE group: two
        ``__main__`` guards are two processes, never two threads of one
        process."""
        records: dict = {}
        lifecycle = self._lifecycle_methods(index)
        for role, entry in index.roles.entries(CONCURRENT_KINDS):
            group = "main" if role.kind == "main" else role.label
            self._dfs(
                index, entry, frozenset(), group, role,
                records, {}, lifecycle,
            )
        for cinfo in index.graph.classes.values():
            for name, meth in sorted(cinfo.methods.items()):
                if name.startswith("_") or meth.key in lifecycle:
                    continue
                self._dfs(
                    index, meth.key, frozenset(), "request", None,
                    records, {}, lifecycle,
                )
        return records

    def _dfs(
        self, index, fkey, pathheld, group, role, records, visited,
        lifecycle, depth=0, setup=False,
    ) -> None:
        seen = visited.setdefault(group, set())
        state = (fkey, pathheld, setup)
        if state in seen or depth > _MAX_DEPTH:
            return
        seen.add(state)
        facts = index.locks.facts.get(fkey)
        if facts is None:
            return
        fi = facts.info
        if fi.cls is not None and not setup and fi.name != "__init__" and (
            fkey not in lifecycle
        ):
            ckey = (fi.path, fi.cls)
            for acc in facts.accesses:
                records.setdefault((ckey, acc.attr), []).append((
                    group, acc.kind, frozenset(pathheld | acc.held),
                    acc.line, fi.path, fi.qual, role,
                ))
        for call, held, line in facts.calls:
            for target in index.graph.call_targets.get(
                (fi.path, id(call)), ()
            ):
                # everything reached THROUGH an __init__ (a constructor
                # called mid-traversal builds a fresh object) is
                # initialization, happens-before any sharing -- the
                # Eraser first-thread discount, one level deeper
                self._dfs(
                    index, target.key, frozenset(pathheld | held),
                    group, role, records, visited, lifecycle, depth + 1,
                    setup or target.name in ("__init__", "__enter__")
                    or target.key in lifecycle,
                )

    @staticmethod
    def _lifecycle_methods(index: PackageIndex) -> set:
        """Methods whose execution happens-before the threads they
        spawn: ``__init__``/``__enter__`` plus any method constructing a
        Thread/Timer. Their field writes are setup, not races (the
        Eraser initialization discount, statically)."""
        out: set = set()
        for cinfo in index.graph.classes.values():
            for name, meth in cinfo.methods.items():
                if name in ("__init__", "__enter__"):
                    out.add(meth.key)
                    continue
                for node in index.graph.body_nodes(meth.node):
                    if isinstance(node, ast.Call):
                        cn = call_name(node)
                        if cn.endswith(("Thread", "Timer")) and cn not in (
                            "", "current_thread",
                        ):
                            out.add(meth.key)
                            break
        return out

    # -- the race predicate -------------------------------------------------
    def _judge(self, index, ckey, attr, recs) -> Iterator[Finding]:
        path, cls = ckey
        if self._key_of(index, path, cls, attr) is not None:
            return  # the field IS a lock; guarding it with itself is fine
        strong = {
            r[0] for r in recs
            if r[6] is not None and r[6].kind in ("thread", "timer", "callback")
        }
        if not strong:
            # no genuinely concurrent role ever touches this class:
            # "main" and "request" alone are one thread in practice
            # (tool classes, module mains) -- the C003 precedent kept
            return
        groups: dict[str, list] = {}
        for rec in recs:
            groups.setdefault(rec[0], []).append(rec)
        if len(groups) < 2:
            return
        # the Eraser predicate: >= 2 roles touch the field, at least one
        # writes, and no lock is common to every access
        write_groups = {
            g for g, rs in groups.items() if any(r[1] == "write" for r in rs)
        }
        if not write_groups:
            return
        common = None
        for rs in groups.values():
            for r in rs:
                common = set(r[2]) if common is None else (common & r[2])
        if common:
            return
        # report the most race-shaped pair: a write and an access from a
        # DIFFERENT group with the smallest lockset overlap
        wrec, orec = None, None
        best = None
        for wg in sorted(write_groups):
            for w in groups[wg]:
                if w[1] != "write":
                    continue
                for og in sorted(groups):
                    if og == wg:
                        continue
                    for o in groups[og]:
                        overlap = len(w[2] & o[2])
                        if best is None or overlap < best:
                            best, wrec, orec = overlap, w, o
        if wrec is None:
            return
        locks_seen = sorted({lk for r in recs for lk in r[2]})
        sites = [
            index.locks.lock_sites.get(lk) for lk in locks_seen
        ]
        sites = [s for s in sites if s]
        witness = ""
        if wrec[6] is not None:
            hops = index.roles.witness_path((wrec[4], wrec[5]), wrec[6])
            if hops:
                witness = f"; role path: {_chain_text(hops)}"
        lock_note = (
            "lock sites for runtime witness (lockwatch): "
            + ", ".join(sites)
            if sites else "no lock is held at any access site "
            "(lockwatch has no runtime witness to offer)"
        )
        yield Finding(
            self.rule_id, self.severity, path, wrec[3],
            f"{cls}.{attr}",
            f"field {attr!r} of {cls} is written under role {wrec[0]} "
            f"(locks: {self._lockset_text(index, wrec[2])}) and "
            f"{orec[1]} under role {orec[0]} at {orec[4]}:{orec[3]} "
            f"(locks: {self._lockset_text(index, orec[2])}) with no "
            f"lock common to every access{witness}; {lock_note}",
            "guard every access with one shared lock, confine the field "
            "to a single thread, or publish it immutably before the "
            "thread starts",
        )

    @staticmethod
    def _confined_classes(index: PackageIndex) -> set:
        """Classes whose instances provably never escape one function:
        constructed only as locals, never published to ``self.attr`` /
        returned / passed on, and spawning no threads of their own --
        their fields are thread-confined by construction (the
        ``_ColumnSpill`` shape: a scratch object built, used, and closed
        inside one build call)."""
        published: set = set()
        constructed: set = set()
        graph = index.graph
        for cinfo in graph.classes.values():
            for types in cinfo.attr_types.values():
                published.update(t.key for t in types)
        for fi in graph.functions.values():
            env = graph._local_env(fi)
            local_types = {
                v[1].key: k for k, v in env.items() if v[0] == "type"
            }
            constructed.update(local_types)
            if not local_types:
                continue
            for node in index.graph.body_nodes(fi.node):
                # returning or passing the instance publishes it
                if isinstance(node, ast.Return) and node.value is not None:
                    t = graph.instance_type(fi, node.value)
                    if t is not None:
                        published.add(t.key)
                    elif isinstance(node.value, ast.Call):
                        c = graph._resolve_class_expr(fi, node.value.func)
                        if c is not None:
                            published.add(c.key)
                elif isinstance(node, ast.Call):
                    for arg in list(node.args) + [
                        kw.value for kw in node.keywords
                    ]:
                        t = graph.instance_type(fi, arg)
                        if t is not None and isinstance(arg, ast.Name):
                            published.add(t.key)
        for role, entry in index.roles.entries(("thread", "timer", "callback")):
            fi = graph.functions.get(entry)
            if fi is not None and fi.cls is not None:
                published.add((fi.path, fi.cls))
        return constructed - published

    @staticmethod
    def _key_of(index, path, cls, attr):
        key = f"{path}:{cls}.{attr}"
        return key if key in index.locks.lock_sites else None

    @staticmethod
    def _lockset_text(index, lockset) -> str:
        if not lockset:
            return "none"
        return ", ".join(
            sorted(index.locks.short_lock(lk) for lk in lockset)
        )


RULES = (RuleC001, RuleC002, RuleC004, RuleC005, RuleC006)
