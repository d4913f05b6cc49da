"""Exception-edge resource-lifecycle dataflow: the R-series substrate.

Port of ``predictionio_tpu/analysis/flowgraph.py``.

The serving and ingest tiers are held together by paired-protocol
invariants -- an admission permit released exactly once, a trace span
finished on every path, a tmp file fsynced before the rename that
commits it -- and four reviews in a row each caught an
exception-edge leak of one of them by hand (the non-UTF-8-body
live-trace leak, the watchdog permit hold, the ``_CompletionRetry``
deadline-drop permit, the retired-ring read race). This module makes
those protocols checkable mechanically:

- **Flowgraph**: each function is interpreted over a per-statement
  control-flow walk with EXPLICIT exception edges -- any call or
  ``raise`` may throw, ``try``/``except``/``finally``/``with`` are
  modeled structurally (``finally`` runs on return/break/continue/raise
  flows too), and loop bodies iterate to a fixpoint. Typed ``except``
  clauses both catch AND propagate (the non-UTF-8 incident was exactly
  a typed handler whose type did not match); only a bare /
  ``Exception`` / ``BaseException`` handler is a true backstop.
- **Obligations** (the must-release abstract domain): facts created by
  acquire-shaped calls -- semaphore/tracker ``.acquire()`` permit
  idioms, ``tracer.span``/``start_remote`` handles and
  ``Span.attach()``, raw ``Lock.acquire`` outside ``with``,
  ``open``/``mmap``/``socket`` file descriptors, and the
  tmp-write-pending-fsync facts of the durability protocol -- and
  discharged by their matching release (``release``/``finish``/
  ``detach``/``close``/``os.fsync``), by escaping to an owner (returned,
  stored on ``self``, packed into a container), or by being handed to a
  callee that releases on the caller's behalf.
- **Interprocedural credit**: per-function summaries (which parameters
  a function releases/fsyncs/invokes, which class-level permit/lock
  fields it may release, transitively) are computed to a fixpoint over
  the package call graph, so the async serving chain -- ring
  consumer -> ``submit_query_async`` -> flusher callback ->
  ``_complete_query`` -> ``_inflight.release()`` -- credits the
  acquiring function along the witness path instead of flagging it.

The join is may-analysis union: an obligation open on SOME path to an
exit is a leak on that exit. ``rules_resources`` turns the per-exit
leak records into R001 (exception-path permit/lock/fd leak), R002
(span neither finished nor detached), R003 (durability-protocol
violation, site-triggered at the commit rename / checkpoint write) and
R004 (obligation dies in a local with no owner).

Flowgraph state is cached per function alongside the
:class:`~predictionio_tpu_torch.analysis.packageindex.PackageIndex` (one
``ResourceFlow`` per ``pio check`` run, built lazily so J/C-only runs
pay nothing).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field as dfield

from predictionio_tpu_torch.analysis.astutil import call_name, dotted

# -- obligation kinds ---------------------------------------------------------
PERMIT = "permit"
LOCK = "lock"
SPAN = "span"
ATTACH = "attach"
FD = "fd"
DIRTY = "dirty"          # bytes written to a commit-protocol file, not yet fsynced

#: receiver-name tokens that mark a ``.acquire()`` as a permit idiom
_PERMIT_TOKENS = frozenset((
    "sem", "semaphore", "inflight", "permit", "permits", "tracker",
))
_LOCK_TOKENS = frozenset(("lock", "rlock", "mutex"))
#: method names that start a span handle (explicit-lifetime tracing)
_SPAN_STARTS = frozenset(("span", "start_remote", "start_span"))
#: receiver tokens for which a bare ``.attach()`` is a context-stack push
_ATTACH_TOKENS = frozenset(("span", "root", "guard", "handle"))
_FD_FUNCS = frozenset((
    "open", "os.open", "os.fdopen", "mmap.mmap", "socket.socket",
    "os.eventfd",
))
_WRITE_VERBS = frozenset(("write", "writelines", "truncate"))
#: checkpoint/cursor-write shapes for the R003 ordering obligation
_CKPT_TOKENS = frozenset(("checkpoint", "cursor"))
_SEM_CTORS = frozenset((
    "threading.Semaphore", "threading.BoundedSemaphore", "Semaphore",
    "BoundedSemaphore",
))
_CATCH_ALL_TYPES = frozenset(("Exception", "BaseException"))

#: release verb -> obligation kinds it discharges. ``detach`` does NOT
#: discharge a started span (a detached-but-unfinished span IS the
#: live-trace leak class R002 exists for), and ``finish`` does not pop
#: the context stack -- the pairing is exact by design.
_RELEASE_KINDS = {
    "release": (PERMIT, LOCK),
    "finish": (SPAN,),
    "detach": (ATTACH,),
    "close": (FD,),
}

_MAX_LOOP_ITERS = 4
_MAX_SUMMARY_ROUNDS = 8


def _tokens(d: str) -> set:
    return set(d.lower().replace(".", "_").split("_")) - {""}


def _is_tmpish(text: str) -> bool:
    return "tmp" in text.lower()


@dataclass(eq=False)
class Obligation:
    """One acquire fact. Interned per call site so loop fixpoints
    converge (re-executing the acquire is the same obligation)."""

    kind: str
    label: str               # human key: "self._inflight", "root", "f"
    line: int
    field: tuple | None = None     # (path, cls, attr) for class-field permits
    pathname: str | None = None    # DIRTY: name the written path was opened under


@dataclass
class Leak:
    fi: object               # FunctionInfo
    ob: Obligation
    exit: str                # "exception" | "normal"
    line: int                # line of the leaking exit edge
    trail: tuple             # non-discharging hand-off hops, for the witness


@dataclass
class Durability:
    fi: object
    line: int
    kind: str                # "rename" | "checkpoint"
    detail: str


@dataclass
class Summary:
    """What a function does to values handed to it (the release-on-
    behalf-of-caller credit) and to shared permit/lock fields."""

    releases: set = dfield(default_factory=set)   # param names discharged/owned
    fsyncs: set = dfield(default_factory=set)     # param names fsynced
    calls: set = dfield(default_factory=set)      # param names invoked as callables
    fields: set = dfield(default_factory=set)     # (path, cls, attr) may-released
    fsyncs_any: bool = False


# -- the whole-package layer --------------------------------------------------

class ResourceFlow:
    """Obligation analysis over every function of a
    :class:`PackageIndex`; built once per run, read by the R rules."""

    def __init__(self, index):
        self.index = index
        self.graph = index.graph
        self.locks = index.locks
        #: (path, clsqual) -> {attr}: semaphore-valued fields
        self._sem_fields: dict[tuple, set] = {}
        #: (path, clsqual, attr) -> ClassInfo: `self.attr = param` where the
        #: param carries a class annotation (extends callgraph.attr_types)
        self._attr_ext: dict[tuple, object] = {}
        self._collect_fields()
        self.summaries: dict[tuple, Summary] = {}
        self._build_summaries()
        self.leaks: list[Leak] = []
        self.durability: list[Durability] = []
        for fi in sorted(self.graph.functions.values(), key=lambda f: f.key):
            if self._relevant(fi):
                _Analysis(self, fi).run()

    # -- field inventory ----------------------------------------------------
    def _collect_fields(self) -> None:
        for cinfo in self.graph.classes.values():
            ann_types = {}
            for meth in cinfo.methods.values():
                args = getattr(meth.node, "args", None)
                if args is not None:
                    for p in args.posonlyargs + args.args + args.kwonlyargs:
                        hit = None
                        if p.annotation is not None:
                            ann = p.annotation
                            if isinstance(ann, ast.Constant) and isinstance(
                                ann.value, str
                            ):
                                try:
                                    ann = ast.parse(ann.value, mode="eval").body
                                except SyntaxError:
                                    ann = None
                            if ann is not None:
                                hit = self.graph._resolve_class_expr(meth, ann)
                        if hit is not None:
                            ann_types[p.arg] = hit
                for node in self.graph.body_nodes(meth.node):
                    if not isinstance(node, ast.Assign):
                        continue
                    for t in node.targets:
                        d = dotted(t)
                        if not (d and d.startswith("self.") and d.count(".") == 1):
                            continue
                        attr = d[len("self."):]
                        v = node.value
                        if isinstance(v, ast.Call) and call_name(v) in _SEM_CTORS:
                            self._sem_fields.setdefault(
                                cinfo.key, set()
                            ).add(attr)
                        elif isinstance(v, ast.Name) and v.id in ann_types:
                            self._attr_ext[(*cinfo.key, attr)] = ann_types[v.id]

    def _class_of_expr(self, fi, obj: str):
        """ClassInfo for a dotted receiver prefix (``self``, a typed
        local, ``self._bridge`` through the annotated-param extension)."""
        parts = obj.split(".")
        if parts[0] == "self":
            cinfo = (
                self.graph.classes.get((fi.path, fi.cls)) if fi.cls else None
            )
            parts = parts[1:]
        else:
            env = self.graph._local_env(fi).get(parts[0])
            cinfo = env[1] if env and env[0] == "type" else None
            parts = parts[1:]
        for attr in parts:
            if cinfo is None:
                return None
            types = cinfo.attr_types.get(attr)
            if types and len(types) == 1:
                cinfo = next(iter(types))
            else:
                cinfo = self._attr_ext.get((*cinfo.key, attr))
        return cinfo

    def field_of(self, fi, recv: str) -> tuple | None:
        """``self._inflight`` / ``self._bridge._inflight`` / ``w.cmp_lock``
        -> the class-qualified permit/lock field key, or None."""
        if "." not in recv:
            return None
        obj, attr = recv.rsplit(".", 1)
        cinfo = self._class_of_expr(fi, obj)
        if cinfo is None:
            return None
        if attr in self._sem_fields.get(cinfo.key, ()) or attr in (
            self.locks._declared.get(cinfo.key, ())
        ):
            return (*cinfo.key, attr)
        return None

    # -- summaries ----------------------------------------------------------
    def _build_summaries(self) -> None:
        for fi in self.graph.functions.values():
            self.summaries[fi.key] = self._local_summary(fi)
        for _ in range(_MAX_SUMMARY_ROUNDS):
            changed = False
            for fi in self.graph.functions.values():
                changed |= self._propagate_summary(fi)
            if not changed:
                break

    def _local_summary(self, fi) -> Summary:
        s = Summary()
        params = set(fi.params()) - {"self"}
        for node in self.graph.body_nodes(fi.node):
            if isinstance(node, ast.Call):
                fn = node.func
                name = call_name(node)
                if isinstance(fn, ast.Attribute):
                    recv = dotted(fn.value)
                    if fn.attr in _RELEASE_KINDS and recv:
                        if recv in params:
                            s.releases.add(recv)
                        if fn.attr == "release":
                            fld = self.field_of(fi, recv)
                            if fld is not None:
                                s.fields.add(fld)
                    if fn.attr == "fsync":
                        s.fsyncs_any = True
                if name == "os.close" and node.args:
                    d = dotted(node.args[0])
                    if d in params:
                        s.releases.add(d)
                if name == "os.fsync":
                    s.fsyncs_any = True
                    root = _fsync_target(node)
                    if root in params:
                        s.fsyncs.add(root)
                if isinstance(fn, ast.Name) and fn.id in params:
                    s.calls.add(fn.id)
                # params stored into a self-rooted container own the value
                if isinstance(fn, ast.Attribute) and fn.attr in (
                    "append", "add", "put", "put_nowait", "appendleft",
                ):
                    recv = dotted(fn.value) or ""
                    if recv.startswith("self."):
                        for p in _names_shallow(node.args):
                            if p in params:
                                s.releases.add(p)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    d = dotted(t)
                    base = t
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    db = dotted(base)
                    if (d and d.startswith("self.")) or (
                        db and db.startswith("self.")
                    ):
                        for p in _names_shallow([node.value]):
                            if p in params:
                                s.releases.add(p)
        return s

    def _propagate_summary(self, fi) -> bool:
        s = self.summaries[fi.key]
        params = set(fi.params()) - {"self"}
        changed = False
        for site in self.graph.callees(fi.key):
            for target in site.targets:
                ts = self.summaries.get(target.key)
                if ts is None:
                    continue
                if ts.fields - s.fields:
                    s.fields |= ts.fields
                    changed = True
                if ts.fsyncs_any and not s.fsyncs_any:
                    s.fsyncs_any = True
                    changed = True
                if not params:
                    continue
                tparams = target.params()
                offset = 1 if tparams[:1] == ["self"] else 0
                pairs = []
                for i, arg in enumerate(site.call.args):
                    d = dotted(arg)
                    if d in params and i + offset < len(tparams):
                        pairs.append((d, tparams[i + offset]))
                for kw in site.call.keywords:
                    d = dotted(kw.value)
                    if d in params and kw.arg in tparams:
                        pairs.append((d, kw.arg))
                for mine, theirs in pairs:
                    if theirs in ts.releases and mine not in s.releases:
                        s.releases.add(mine)
                        changed = True
                    if theirs in ts.fsyncs and mine not in s.fsyncs:
                        s.fsyncs.add(mine)
                        changed = True
                    if theirs in ts.calls and mine not in s.calls:
                        s.calls.add(mine)
                        changed = True
        return changed

    # -- relevance prescan --------------------------------------------------
    def _relevant(self, fi) -> bool:
        """Does this function create any obligation or commit site? The
        sweep budget is paid here: most functions exit in one cheap
        pass and never run the dataflow."""
        for node in self.graph.body_nodes(fi.node):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in ("os.replace", "os.rename"):
                return True
            if name in _FD_FUNCS:
                return True
            fn = node.func
            if isinstance(fn, ast.Attribute):
                if fn.attr == "acquire" and self._acquire_kind(fi, fn) is not None:
                    return True
                if fn.attr in _SPAN_STARTS:
                    return True
                if fn.attr == "attach" and not node.args:
                    recv = dotted(fn.value) or ""
                    if _tokens(recv) & _ATTACH_TOKENS:
                        return True
        return False

    def _acquire_kind(self, fi, fn: ast.Attribute) -> str | None:
        recv = dotted(fn.value)
        if not recv:
            return None
        fld = self.field_of(fi, recv)
        if fld is not None:
            cls_key = (fld[0], fld[1])
            if fld[2] in self._sem_fields.get(cls_key, ()):
                return PERMIT
            return LOCK
        toks = _tokens(recv)
        if toks & _PERMIT_TOKENS:
            return PERMIT
        if toks & _LOCK_TOKENS:
            return LOCK
        return None


def _fsync_target(call: ast.Call) -> str | None:
    """``os.fsync(fd)`` / ``os.fsync(f.fileno())`` -> the root name."""
    if not call.args:
        return None
    arg = call.args[0]
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute):
        if arg.func.attr == "fileno":
            return dotted(arg.func.value)
    return dotted(arg)


def _names_shallow(nodes) -> set:
    """Dotted references in expressions, including inside container
    displays and calls -- the escape check's reach. A chain contributes
    only its FULL dotted form: ``span.op`` escapes an attribute value,
    not the span handle itself."""
    out = set()

    def rec(n):
        d = dotted(n)
        if d is not None:
            out.add(d)
            return
        for c in ast.iter_child_nodes(n):
            rec(c)

    for node in nodes:
        rec(node)
    return out


# -- the per-function interpreter ---------------------------------------------

class _Ctx:
    """Where non-local control flow delivers its state: the innermost
    handler (``raise_to``) and the collectors ``finally`` interposes on."""

    __slots__ = ("raise_to", "return_to", "break_to", "continue_to")

    def __init__(self, raise_to, return_to, break_to=None, continue_to=None):
        self.raise_to = raise_to
        self.return_to = return_to
        self.break_to = break_to
        self.continue_to = continue_to

    def replaced(self, **kw) -> "_Ctx":
        out = _Ctx(self.raise_to, self.return_to, self.break_to, self.continue_to)
        for k, v in kw.items():
            setattr(out, k, v)
        return out


class _Analysis:
    """May-open obligation dataflow for ONE function. State = frozenset
    of ``(Obligation, alias names, hand-off trail)`` entries; join is
    union (an obligation open on some path stays open); ``None`` marks
    unreachable code. Which EXIT collector a state reaches (the
    function-level raise vs return sink) is what classifies a leak as
    exception-path vs normal -- no per-entry flag needed."""

    def __init__(self, flow: ResourceFlow, fi):
        self.flow = flow
        self.fi = fi
        self._obs: dict[int, Obligation] = {}      # id(call) -> interned
        self._handles: dict[str, tuple] = {}       # partial-release handles
        self._exc_exit: list = []                  # (state, line)
        self._ret_exit: list = []

    # -- driver -------------------------------------------------------------
    def run(self) -> None:
        body = self.fi.node.body
        if not isinstance(body, list):
            return  # lambda bodies hold no statements to leak across
        ctx = _Ctx(
            raise_to=lambda s, l: self._exc_exit.append((s, l)),
            return_to=lambda s, l: self._ret_exit.append((s, l)),
        )
        out = self._block(body, frozenset(), ctx)
        end = getattr(self.fi.node, "end_lineno", self.fi.node.lineno)
        flow = self.flow
        leaked: dict[int, dict] = {}

        def note(state, exit_kind, line):
            if state is None:
                return
            for ob, names, trail in state:
                if ob.kind == DIRTY:
                    continue
                rec = leaked.setdefault(id(ob), {"ob": ob, "exits": {}})
                prior = rec["exits"].get(exit_kind)
                # keep the exit whose hand-off trail says the most: the
                # witness should name the helper that failed to release
                if prior is None or len(trail) > len(prior[1]):
                    rec["exits"][exit_kind] = (line, trail)

        note(out, "normal", end)
        for state, line in self._ret_exit:
            note(state, "normal", line)
        for state, line in self._exc_exit:
            note(state, "exception", line)
        for rec in leaked.values():
            for exit_kind, (line, trail) in rec["exits"].items():
                flow.leaks.append(Leak(
                    fi=self.fi, ob=rec["ob"], exit=exit_kind,
                    line=line, trail=trail,
                ))

    # -- state helpers ------------------------------------------------------
    @staticmethod
    def _join(*states):
        live = [s for s in states if s is not None]
        if not live:
            return None
        out = live[0]
        for s in live[1:]:
            out = out | s
        return out

    def _gen(self, state, ob: Obligation, names) -> frozenset:
        return state | {(ob, frozenset(names), ())}

    @staticmethod
    def _discharge(state, pred) -> frozenset:
        return frozenset(e for e in state if not pred(e))

    # -- blocks and statements ----------------------------------------------
    def _block(self, stmts, state, ctx):
        for stmt in stmts:
            if state is None:
                break
            state = self._stmt(stmt, state, ctx)
        return state

    def _stmt(self, stmt, state, ctx):
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                state = self._eval(stmt.value, state, ctx)
                state = self._escape_via_return(stmt.value, state)
            ctx.return_to(state, stmt.lineno)
            return None
        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                state = self._eval(stmt.exc, state, ctx)
            ctx.raise_to(state, stmt.lineno)
            return None
        if isinstance(stmt, ast.Break):
            if ctx.break_to is not None:
                ctx.break_to.append(state)
            return None
        if isinstance(stmt, ast.Continue):
            if ctx.continue_to is not None:
                ctx.continue_to.append(state)
            return None
        if isinstance(stmt, ast.If):
            return self._if(stmt, state, ctx)
        if isinstance(stmt, (ast.While,)):
            return self._loop(stmt, state, ctx, test=stmt.test)
        if isinstance(stmt, ast.For):
            state = self._eval(stmt.iter, state, ctx)
            return self._loop(stmt, state, ctx, test=None)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, state, ctx)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            return self._with(stmt, state, ctx)
        if isinstance(stmt, ast.Assign):
            return self._assign(stmt, state, ctx)
        if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if stmt.value is not None:
                state = self._eval(stmt.value, state, ctx)
            return state
        if isinstance(stmt, ast.Expr):
            return self._expr(stmt, state, ctx)
        if isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            return state  # nested defs are their own flowgraphs
        if isinstance(stmt, ast.Delete):
            return state
        # generic statement: evaluate any embedded calls
        return self._eval(stmt, state, ctx)

    # -- control flow -------------------------------------------------------
    def _if(self, stmt, state, ctx):
        then_in = else_in = None
        test = stmt.test
        acq = self._classify_call(test) if isinstance(test, ast.Call) else None
        neg = (
            isinstance(test, ast.UnaryOp)
            and isinstance(test.op, ast.Not)
            and isinstance(test.operand, ast.Call)
        )
        neg_acq = self._classify_call(test.operand) if neg else None
        if acq is not None:
            # `if x.acquire(timeout=...):` -- held only in the then branch
            state = self._eval(test, state, ctx, skip=test)
            then_in = self._gen(state, acq[0], acq[1])
            else_in = state
        elif neg_acq is not None:
            # `if not x.acquire(timeout=...):` -- held only PAST the if
            state = self._eval(test, state, ctx, skip=test.operand)
            then_in = state
            else_in = self._gen(state, neg_acq[0], neg_acq[1])
        else:
            state = self._eval(test, state, ctx)
            then_in = else_in = state
            sentinel = _sentinel_test(test)
            if sentinel is not None:
                # `X.trace_id is None`: in that branch X is the shared
                # sampled-out sentinel (SAMPLED_OUT_ROOT / NULL_SPAN),
                # which owes no finish -- the tracer's documented
                # suppression contract
                name, none_branch = sentinel
                cleared = self._discharge(
                    state,
                    lambda e: e[0].kind in (SPAN, ATTACH) and name in e[1],
                )
                if none_branch == "then":
                    then_in = cleared
                else:
                    else_in = cleared
        t_out = self._block(stmt.body, then_in, ctx)
        e_out = self._block(stmt.orelse, else_in, ctx)
        return self._join(t_out, e_out)

    def _loop(self, stmt, state, ctx, test):
        infinite = (
            test is not None
            and isinstance(test, ast.Constant)
            and test.value is True
        )
        breaks: list = []
        conts: list = []
        loop_ctx = ctx.replaced(break_to=breaks, continue_to=conts)
        head = state
        for _ in range(_MAX_LOOP_ITERS):
            cur = head
            if test is not None:
                cur = self._eval(test, cur, ctx)
            body_out = self._block(stmt.body, cur, loop_ctx)
            nxt = self._join(head, body_out, *conts)
            conts.clear()
            if nxt == head:
                break
            head = nxt
        out = self._join(*breaks, None if infinite else head)
        if stmt.orelse and out is not None:
            out = self._block(stmt.orelse, out, ctx)
        return out

    def _try(self, stmt, state, ctx):
        pending_exc: list = []      # exceptional flows owed to the OUTER ctx
        pending_ret: list = []
        pending_brk: list = []
        pending_cont: list = []
        has_final = bool(stmt.finalbody)
        body_exc: list = []

        inner_ctx = _Ctx(
            raise_to=lambda s, l: body_exc.append((s, l)),
            return_to=(
                (lambda s, l: pending_ret.append((s, l)))
                if has_final else ctx.return_to
            ),
            break_to=(pending_brk if has_final else ctx.break_to),
            continue_to=(pending_cont if has_final else ctx.continue_to),
        )
        body_out = self._block(stmt.body, state, inner_ctx)
        exc_state = self._join(*(s for s, _ in body_exc))
        exc_line = body_exc[0][1] if body_exc else stmt.lineno

        # raises from HANDLER bodies (incl. bare re-raise) go outward
        handler_ctx = inner_ctx.replaced(
            raise_to=(
                (lambda s, l: pending_exc.append((s, l)))
                if has_final else ctx.raise_to
            ),
        )
        handler_outs = []
        if stmt.handlers and exc_state is not None:
            for h in stmt.handlers:
                handler_outs.append(
                    self._block(h.body, exc_state, handler_ctx)
                )
            if not any(_catches_all(h) for h in stmt.handlers):
                # a typed handler may NOT match (the non-UTF-8-body
                # incident): the raw exception also propagates
                pending_exc.append((exc_state, exc_line))
        elif exc_state is not None:
            pending_exc.append((exc_state, exc_line))

        if stmt.orelse and body_out is not None:
            body_out = self._block(stmt.orelse, body_out, inner_ctx)
        normal = self._join(body_out, *handler_outs)

        if has_final:
            if normal is not None:
                normal = self._block(stmt.finalbody, normal, ctx)
            for s, l in pending_exc:
                after = self._block(stmt.finalbody, s, ctx)
                if after is not None:
                    ctx.raise_to(after, l)
            for s, l in pending_ret:
                after = self._block(stmt.finalbody, s, ctx)
                if after is not None:
                    ctx.return_to(after, l)
            for collector, sink in (
                (pending_brk, ctx.break_to), (pending_cont, ctx.continue_to)
            ):
                for s in collector:
                    after = self._block(stmt.finalbody, s, ctx)
                    if after is not None and sink is not None:
                        sink.append(after)
        else:
            for s, l in pending_exc:
                ctx.raise_to(s, l)
        return normal

    def _with(self, stmt, state, ctx):
        for item in stmt.items:
            ce = item.context_expr
            as_name = (
                item.optional_vars.id
                if isinstance(item.optional_vars, ast.Name) else None
            )
            if isinstance(ce, ast.Call):
                spec = self._classify_call(ce)
                if spec is not None:
                    # managed acquire: the context-manager protocol
                    # guarantees the release -- no lifecycle obligation.
                    # An open of a commit-protocol tmp file still starts
                    # the DIRTY fact (closing is not fsyncing).
                    state = self._eval(ce, state, ctx, skip=ce)
                    ob, _names = spec
                    if ob.kind == FD and ob.pathname is not None and (
                        _is_tmpish(ob.pathname)
                    ):
                        dirty = self._intern(
                            ce, DIRTY, as_name or ob.label, ob.pathname
                        )
                        state = self._gen(state, dirty, {as_name or ob.label})
                    continue
            state = self._eval(ce, state, ctx)
        return self._block(stmt.body, state, ctx)

    # -- assignment and expression statements --------------------------------
    def _assign(self, stmt, state, ctx):
        value = stmt.value
        spec = self._classify_call(value) if isinstance(value, ast.Call) else None
        state = self._eval(value, state, ctx, skip=value if spec else None)
        target_names = {
            t.id for t in stmt.targets if isinstance(t, ast.Name)
        }
        attr_target = any(
            isinstance(_sub_base(t), ast.Attribute) for t in stmt.targets
        )
        # rebinding a name drops that alias from existing obligations
        if target_names:
            state = frozenset(
                (ob, names - target_names, trail)
                for ob, names, trail in state
            )
        if spec is not None:
            ob, default_names = spec
            names = target_names or default_names
            if ob.kind == FD and ob.pathname is not None and _is_tmpish(ob.pathname):
                dirty = self._intern(value, DIRTY, ob.label, ob.pathname)
                state = self._gen(state, dirty, set(names))
            if attr_target and not target_names:
                # `self._file = open(...)`: owned at birth -- the object
                # the attribute lives on carries the release obligation
                return state
            return self._gen(state, ob, names)
        # partial-release handle: cb = functools.partial(x.release)
        handle = self._partial_handle(value)
        if handle is not None and target_names:
            for n in target_names:
                self._handles[n] = handle
            return state
        value_names = _names_shallow([value])
        # alias copy: a = b
        if isinstance(value, ast.Name) and target_names:
            out = set()
            for ob, names, trail in state:
                if value.id in names:
                    out.add((ob, names | target_names, trail))
                else:
                    out.add((ob, names, trail))
            state = frozenset(out)
            return state
        # escape: obligation stored on self / packed into a container
        self_target = any(
            (dotted(t) or "").startswith("self.")
            or (dotted(_sub_base(t)) or "").startswith("self.")
            for t in stmt.targets
        )
        container = isinstance(value, (ast.Dict, ast.List, ast.Tuple, ast.Set))
        if (self_target or container) and value_names:
            state = self._discharge(
                state,
                lambda e: e[0].kind != DIRTY and (e[1] & value_names),
            )
        return state

    def _expr(self, stmt, state, ctx):
        value = stmt.value
        spec = self._classify_call(value) if isinstance(value, ast.Call) else None
        state = self._eval(value, state, ctx, skip=value if spec else None)
        if spec is not None:
            ob, names = spec
            if ob.kind == FD and ob.pathname is not None and _is_tmpish(ob.pathname):
                dirty = self._intern(value, DIRTY, ob.label, ob.pathname)
                state = self._gen(state, dirty, set(names))
            state = self._gen(state, ob, names)
        return state

    def _escape_via_return(self, value, state):
        names = _names_shallow([value])
        if isinstance(value, ast.Name) and value.id == "self":
            # returning self hands every self-rooted obligation to the
            # caller (the `return self.acquire()` / __enter__ shape)
            return self._discharge(
                state,
                lambda e: e[0].kind != DIRTY
                and any(n.startswith("self.") for n in e[1]),
            )
        if not names:
            return state
        return self._discharge(
            state, lambda e: e[0].kind != DIRTY and (e[1] & names)
        )

    # -- calls ---------------------------------------------------------------
    def _eval(self, node, state, ctx, skip=None):
        """Evaluate every call embedded in ``node``: apply discharge /
        acquire-independent effects and raise the exception edge."""
        for call in _calls_in(node):
            if call is skip:
                continue
            state = self._apply_call(call, state, ctx)
        return state

    def _apply_call(self, call, state, ctx):
        fn = call.func
        name = call_name(call)
        arg_names = set()
        for a in list(call.args) + [kw.value for kw in call.keywords]:
            d = dotted(a)
            if d is not None:
                arg_names.add(d)
            elif isinstance(a, (ast.Dict, ast.List, ast.Tuple, ast.Set)):
                arg_names |= _names_shallow([a])
            elif isinstance(a, ast.Call) and isinstance(a.func, ast.Attribute):
                if a.func.attr == "fileno":
                    d = dotted(a.func.value)
                    if d is not None:
                        arg_names.add(d)

        # 1. direct release verbs
        if isinstance(fn, ast.Attribute) and fn.attr in _RELEASE_KINDS:
            recv = dotted(fn.value)
            if recv:
                kinds = _RELEASE_KINDS[fn.attr]
                fld = self.flow.field_of(self.fi, recv)
                state = self._discharge(
                    state,
                    lambda e: e[0].kind in kinds and (
                        recv in e[1]
                        or (fld is not None and e[0].field == fld)
                    ),
                )
        if name == "os.close" and call.args:
            d = dotted(call.args[0])
            if d:
                state = self._discharge(
                    state, lambda e: e[0].kind == FD and d in e[1]
                )

        # 2. fsync discharges the durability obligations
        if name == "os.fsync" or (
            isinstance(fn, ast.Attribute) and fn.attr == "fsync"
        ):
            target = _fsync_target(call) if name == "os.fsync" else None
            state = self._discharge(
                state,
                lambda e: e[0].kind == DIRTY
                and (target is None or target in e[1]),
            )

        # 3. partial-release handle invocation
        if isinstance(fn, ast.Name) and fn.id in self._handles:
            verb, target_name = self._handles[fn.id]
            kinds = _RELEASE_KINDS.get(verb, ())
            state = self._discharge(
                state, lambda e: e[0].kind in kinds and target_name in e[1]
            )

        # 4. commit sites (R003)
        if name in ("os.replace", "os.rename"):
            state = self._commit_site(call, state)
        if isinstance(fn, ast.Attribute) and (
            _tokens(fn.attr) & _CKPT_TOKENS
        ):
            dirty = [e for e in state if e[0].kind == DIRTY]
            if dirty:
                ob = dirty[0][0]
                self.flow.durability.append(Durability(
                    fi=self.fi, line=call.lineno, kind="checkpoint",
                    detail=(
                        f"checkpoint/cursor write `{call_name(call)}` is "
                        f"ordered BEFORE the fsync covering the bytes "
                        f"written at line {ob.line}"
                    ),
                ))
                # report once per site, then consider it covered
                state = self._discharge(state, lambda e: e[0].kind == DIRTY)

        # 5. writes through a tracked fd dirty the commit protocol
        if isinstance(fn, ast.Attribute) and fn.attr in _WRITE_VERBS:
            recv = dotted(fn.value)
            if recv:
                for ob, names, _trail in state:
                    if ob.kind == FD and recv in names and ob.pathname:
                        dirty = self._intern(call, DIRTY, recv, ob.pathname)
                        state = self._gen(state, dirty, {recv})
                        break

        # 6. hand-offs: obligations passed as arguments
        targets = self.graph_targets(call)
        if arg_names:
            if targets:
                state = self._handoff(call, targets, arg_names, state)
            else:
                # unresolved callee: ownership is unknowable; err on the
                # quiet side (the value may be stashed or released)
                state = self._discharge(
                    state,
                    lambda e: e[0].kind not in (DIRTY,) and (e[1] & arg_names),
                )
        # 7. field-keyed permits released anywhere below the callee
        if targets:
            fields = set()
            for t in targets:
                ts = self.flow.summaries.get(t.key)
                if ts is not None:
                    fields |= ts.fields
            if fields:
                state = self._discharge(
                    state,
                    lambda e: e[0].field is not None and e[0].field in fields,
                )
            if any(
                self.flow.summaries.get(t.key, Summary()).fsyncs_any
                for t in targets
            ):
                state = self._discharge(state, lambda e: e[0].kind == DIRTY)

        # 8. the exception edge: any call may throw; hand-offs above are
        # assumed to stick (may-analysis errs quiet on discharging calls).
        # Logging is contractually non-raising (the logging module
        # swallows handler errors), so backstop handlers that log before
        # releasing stay clean.
        if not _is_nothrow(name):
            ctx.raise_to(state, call.lineno)
        return state

    def graph_targets(self, call) -> list:
        return self.flow.graph.call_targets.get(
            (self.fi.path, id(call)), []
        )

    def _handoff(self, call, targets, arg_names, state):
        """Credit a resolved callee that releases/owns the obligation on
        the caller's behalf; otherwise record the hop in the trail."""
        out = set()
        for entry in state:
            ob, names, trail = entry
            hit = names & arg_names
            if not hit or ob.kind == DIRTY:
                out.add(entry)
                continue
            discharged = False
            hop = None
            for t in targets:
                ts = self.flow.summaries.get(t.key)
                if ts is None:
                    continue
                tparams = t.params()
                offset = 1 if tparams[:1] == ["self"] else 0
                for i, a in enumerate(call.args):
                    d = dotted(a)
                    if d in hit and i + offset < len(tparams):
                        p = tparams[i + offset]
                        if p in ts.releases:
                            discharged = True
                        elif p in ts.calls and self._is_release_handle(a):
                            discharged = True
                for kw in call.keywords:
                    d = dotted(kw.value)
                    if d in hit and kw.arg in tparams:
                        if kw.arg in ts.releases:
                            discharged = True
                        elif kw.arg in ts.calls and self._is_release_handle(
                            kw.value
                        ):
                            discharged = True
                hop = f"{t.path}:{t.qual}:{call.lineno}"
            if discharged:
                continue
            if hop is not None and hop not in trail:
                trail = trail + (hop,)
            out.add((ob, names, trail))
        return frozenset(out)

    def _is_release_handle(self, expr) -> bool:
        """Is this argument itself a bound release (``x.release`` /
        ``functools.partial(x.release)``)? Then a callee that CALLS its
        parameter discharges the obligation."""
        if isinstance(expr, ast.Call):
            return self._partial_handle(expr) is not None
        d = dotted(expr)
        if d is None or "." not in d:
            return d in self._handles if d else False
        return d.rsplit(".", 1)[1] in _RELEASE_KINDS

    def _partial_handle(self, value) -> tuple | None:
        """``functools.partial(x.release)`` -> ("release", "x")."""
        if not isinstance(value, ast.Call):
            return None
        if call_name(value) not in ("partial", "functools.partial"):
            return None
        if not value.args:
            return None
        d = dotted(value.args[0])
        if d is None or "." not in d:
            return None
        obj, verb = d.rsplit(".", 1)
        if verb in _RELEASE_KINDS:
            return (verb, obj)
        return None

    def _commit_site(self, call, state):
        """``os.replace(src, dst)`` / ``os.rename``: the commit point of
        the tmp+fsync+rename protocol. Violated when the bytes renamed
        into place were written on this path with no fsync."""
        src = call.args[0] if call.args else None
        src_d = dotted(src) if src is not None else None
        src_text = src_d or ""
        if src is not None and src_d is None:
            src_text = " ".join(sorted(_names_shallow([src]))) or (
                src.value if isinstance(src, ast.Constant) and isinstance(
                    src.value, str
                ) else ""
            )
        dirty = [e for e in state if e[0].kind == DIRTY]
        matched = [
            e for e in dirty
            if src_d is not None and (
                src_d in e[1] or e[0].pathname == src_d
            )
        ]
        hits = matched or (dirty if _is_tmpish(src_text) else [])
        if hits:
            ob = hits[0][0]
            self.flow.durability.append(Durability(
                fi=self.fi, line=call.lineno, kind="rename",
                detail=(
                    f"tmp file written at line {ob.line} is renamed into "
                    f"its commit location with no fsync of the file on "
                    f"this path"
                ),
            ))
            return self._discharge(state, lambda e: e[0].kind == DIRTY)
        return state

    # -- acquire classification ----------------------------------------------
    def _intern(self, node, kind, label, pathname=None, field=None) -> Obligation:
        key = id(node) if kind != DIRTY else -id(node)
        ob = self._obs.get(key)
        if ob is None:
            ob = Obligation(
                kind=kind, label=label, line=node.lineno, field=field,
                pathname=pathname,
            )
            self._obs[key] = ob
        return ob

    def _classify_call(self, call) -> tuple | None:
        """An acquire-shaped call -> (Obligation, default alias names),
        or None."""
        if not isinstance(call, ast.Call):
            return None
        fn = call.func
        name = call_name(call)
        if isinstance(fn, ast.Attribute):
            recv = dotted(fn.value)
            if fn.attr == "acquire" and recv:
                kind = self.flow._acquire_kind(self.fi, fn)
                if kind is None:
                    return None
                ob = self._intern(
                    call, kind, recv,
                    field=self.flow.field_of(self.fi, recv),
                )
                return ob, {recv}
            if fn.attr in _SPAN_STARTS and recv:
                ob = self._intern(call, SPAN, f"{recv}.{fn.attr}")
                return ob, {f"<span:{call.lineno}>"}
            if fn.attr == "attach" and not call.args and recv:
                if _tokens(recv) & _ATTACH_TOKENS:
                    ob = self._intern(call, ATTACH, recv)
                    return ob, {recv}
        if name in _FD_FUNCS:
            pathname = None
            mode = None
            if call.args:
                a0 = call.args[0]
                pathname = dotted(a0)
                if pathname is None:
                    subnames = sorted(_names_shallow([a0]))
                    tmpish = [n for n in subnames if _is_tmpish(n)]
                    if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                        pathname = a0.value
                    elif tmpish:
                        pathname = tmpish[0]
                if len(call.args) > 1 and isinstance(
                    call.args[1], ast.Constant
                ) and isinstance(call.args[1].value, str):
                    mode = call.args[1].value
            if name == "open" and mode is not None and (
                "r" in mode and "+" not in mode and "w" not in mode
                and "a" not in mode
            ):
                # read-only opens never owe the durability protocol; the
                # fd lifecycle obligation still applies
                pathname = None
            ob = self._intern(call, FD, name, pathname=pathname)
            return ob, {f"<fd:{call.lineno}>"}
        return None


def _sentinel_test(test) -> tuple | None:
    """``X.trace_id is None`` / ``is not None`` -> (X, branch in which X
    is the sampled-out sentinel): the explicit-handle tracing API's
    discriminator (a sentinel root records nothing and owes nothing)."""
    if not (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], (ast.Is, ast.IsNot))
        and isinstance(test.comparators[0], ast.Constant)
        and test.comparators[0].value is None
        and isinstance(test.left, ast.Attribute)
        and test.left.attr == "trace_id"
    ):
        return None
    name = dotted(test.left.value)
    if name is None:
        return None
    return name, ("then" if isinstance(test.ops[0], ast.Is) else "else")


#: call-name prefixes/names that never raise into caller control flow
_NOTHROW_PREFIXES = ("logger.", "logging.", "log.", "self.logger.", "self.log.")
_NOTHROW_NAMES = frozenset((
    "print", "warnings.warn", "traceback.print_exc",
    # constructing a release handle is not a throwing operation
    "partial", "functools.partial",
))


def _is_nothrow(name: str) -> bool:
    return name in _NOTHROW_NAMES or name.startswith(_NOTHROW_PREFIXES)


def _sub_base(node):
    while isinstance(node, ast.Subscript):
        node = node.value
    return node


def _catches_all(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    types = (
        handler.type.elts if isinstance(handler.type, ast.Tuple)
        else [handler.type]
    )
    for t in types:
        d = dotted(t)
        if d is not None and d.rsplit(".", 1)[-1] in _CATCH_ALL_TYPES:
            return True
    return False


def _calls_in(node):
    """Calls embedded in an expression/statement, in source order,
    without descending into nested function/lambda bodies (those are
    their own flowgraphs)."""
    out = []
    stack = [node]
    while stack:
        cur = stack.pop()
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(cur, ast.Call):
            out.append(cur)
        stack.extend(ast.iter_child_nodes(cur))
    out.sort(key=lambda c: (c.lineno, c.col_offset))
    return out
