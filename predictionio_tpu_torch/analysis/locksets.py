"""Per-function lockset dataflow, joined over call paths.

Port of ``predictionio_tpu/analysis/locksets.py``.

Phase 1 tracked "which locks does THIS function lexically hold" -- enough
for fsync-under-the-same-``with`` but blind to the two shapes that
actually bit the serving tiers: a helper that blocks while EVERY caller holds a
lock (the lock lives N frames up), and two threads touching a field
where each side's lock set is non-empty but DISJOINT.

Three layers:

- **Lock identity** is package-qualified by *declaration site class*:
  ``self._lock`` in ``MicroBatcher`` is ``workflow/microbatch.py:
  MicroBatcher._lock`` -- all instances of one class share an identity,
  matching lockwatch's construction-site keying, so the static and
  runtime views can be cross-referenced. Receiver types are resolved
  through the call graph's inference (``w.cmp_lock`` with ``w: _Worker``
  annotates to ``_Worker.cmp_lock``).
- **Local facts** per function: lock acquisitions, blocking calls, calls
  made, and ``self.*`` field reads/writes -- each annotated with the
  lockset *lexically held* at that statement (``with`` nesting, the
  phase-1 region walk generalized).
- **Entry contexts**: a fixpoint over the call graph computing, for each
  function, the distinct non-empty locksets callers can hold around a
  call to it, with one witness call chain per lockset. ``join`` is
  set-union along a path (locks accumulate) and set-of-locksets across
  paths (alternatives stay distinct -- intersecting them would erase the
  exact disjointness C006 needs to see).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from predictionio_tpu_torch.analysis.astutil import call_name, dotted, keyword
from predictionio_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo

_LOCK_CTORS = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
}

#: attribute calls that mutate a container in place (writes to the field)
_MUTATORS = {
    "append", "extend", "insert", "pop", "remove", "clear", "add",
    "discard", "update", "setdefault", "popitem",
}

#: per-function cap on tracked caller locksets (fixpoint bound; real code
#: has 1-3)
_MAX_CONTEXTS = 6


def blocking_reason(call: ast.Call) -> str | None:
    """The C002 catalog: calls that can park the calling thread. Returns
    a short human reason, or None."""
    name = call_name(call)
    if name == "os.fsync":
        return "os.fsync"
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr == "fsync":
            return "fsync"
        # span/trace export under a lock serializes every instrumented hot
        # path behind the exporter's I/O (obs/ policy: ring-buffer under
        # the lock, export outside). Bare .flush() only counts on
        # tracing-shaped receivers so file/stream flushes stay unflagged.
        if attr in ("export", "export_spans", "force_flush"):
            return f"span export .{attr}()"
        if attr == "flush":
            recv = (dotted(call.func.value) or "").lower()
            if any(
                s in recv for s in ("trace", "span", "exporter", "telemetry")
            ):
                return f"span export .{attr}()"
        if attr in ("execute", "executemany", "commit", "rollback"):
            return f"SQL .{attr}()"
        if attr in ("connect", "sendall", "recv", "accept", "makefile"):
            return f"socket .{attr}()"
        if attr in ("put", "get"):
            recv = (dotted(call.func.value) or "").lower()
            if "queue" in recv or recv in ("q", "self.q"):
                if keyword(call, "timeout") is not None:
                    return None
                block_kw = keyword(call, "block")
                if block_kw is not None and isinstance(
                    block_kw.value, ast.Constant
                ) and block_kw.value.value is False:
                    return None
                return f"blocking queue .{attr}() without timeout"
    if name == "time.sleep":
        return "time.sleep"
    if name in ("urllib.request.urlopen", "urlopen"):
        return "urlopen"
    return None


@dataclass
class Access:
    attr: str
    kind: str         # "read" | "write"
    line: int
    held: frozenset   # qualified lock keys lexically held


@dataclass
class FuncFacts:
    info: FunctionInfo
    #: (lock key, held-before frozenset, line)
    acquisitions: list = field(default_factory=list)
    #: (reason, held frozenset, line, call node)
    blocking: list = field(default_factory=list)
    #: (call node, held frozenset, line)
    calls: list = field(default_factory=list)
    accesses: list = field(default_factory=list)   # list[Access]


class LockModel:
    """Package lock inventory + per-function facts + caller contexts."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        #: qualified lock key -> "module.dotted:line" construction site
        #: (the lockwatch runtime crosswalk)
        self.lock_sites: dict[str, str] = {}
        #: (path, cls|None) -> {attr/name, ...} locks declared there
        self._declared: dict[tuple, set] = {}
        self.facts: dict[tuple, FuncFacts] = {}
        self._collect_locks()
        for fi in graph.functions.values():
            self.facts[fi.key] = self._walk(fi)
        self._contexts: dict[tuple, dict] | None = None

    # -- lock inventory -----------------------------------------------------
    def _collect_locks(self) -> None:
        for mod in self.graph.modules.values():
            for node in mod.call_assigns:
                if call_name(node.value) not in _LOCK_CTORS:
                    continue
                cls = mod.ctx.symbol_for(node)
                for t in node.targets:
                    d = dotted(t)
                    if d is None:
                        continue
                    if d.startswith("self.") and d.count(".") == 1:
                        # enclosing qual is "Class.method"; the class owns
                        # the lock
                        owner = cls.rsplit(".", 1)[0] if "." in cls else None
                        if owner is None:
                            continue
                        attr = d[len("self."):]
                        key = self._key(mod.path, owner, attr)
                        self._declared.setdefault(
                            (mod.path, owner), set()
                        ).add(attr)
                    elif "." not in d and cls == "<module>":
                        key = self._key(mod.path, None, d)
                        self._declared.setdefault((mod.path, None), set()).add(d)
                    elif "." not in d and (mod.path, cls) in self.graph.classes:
                        # class-BODY declaration (class Foo: _lock =
                        # Lock()): one lock shared by every instance --
                        # phase 1 registered these and so must we
                        key = self._key(mod.path, cls, d)
                        self._declared.setdefault(
                            (mod.path, cls), set()
                        ).add(d)
                    else:
                        continue
                    self.lock_sites.setdefault(
                        key, f"{mod.dotted}:{node.lineno}"
                    )

    @staticmethod
    def _key(path: str, cls: str | None, name: str) -> str:
        return f"{path}:{cls}.{name}" if cls else f"{path}:{name}"

    def lock_key(self, fi: FunctionInfo, expr: ast.AST) -> str | None:
        """Qualified identity of a lock-valued expression, or None when
        the expression is not a known lock."""
        d = dotted(expr)
        if d is None:
            return None
        if d.startswith("self.") and d.count(".") == 1 and fi.cls is not None:
            attr = d[len("self."):]
            if attr in self._declared.get((fi.path, fi.cls), ()):
                return self._key(fi.path, fi.cls, attr)
            return None
        if "." not in d:
            if d in self._declared.get((fi.path, None), ()):
                return self._key(fi.path, None, d)
            return None
        # typed receiver: w.cmp_lock / self._retry._cv
        root, rest = d.rsplit(".", 1)
        recv = self.graph.instance_type(fi, _parse_dotted(root))
        if recv is not None and rest in self._declared.get(
            (recv.path, recv.qual), ()
        ):
            return self._key(recv.path, recv.qual, rest)
        return None

    def class_locks(self, path: str, cls: str) -> set:
        return {
            self._key(path, cls, a)
            for a in self._declared.get((path, cls), ())
        }

    # -- local facts --------------------------------------------------------
    def _walk(self, fi: FunctionInfo) -> FuncFacts:
        facts = FuncFacts(fi)
        method_names = set()
        if fi.cls is not None:
            cinfo = self.graph.classes.get((fi.path, fi.cls))
            if cinfo is not None:
                method_names = set(cinfo.methods)
        nodes = self.graph.body_nodes(fi.node)
        # lock-free function (the overwhelming majority): every held set
        # is empty, so the facts fall straight out of the cached flat
        # body list -- no region recursion. The flat walk itself detects
        # With/acquire nodes and bails (returns None) so the common case
        # pays a single pass instead of prescan + walk.
        flat = self._walk_flat(fi, facts, method_names, nodes)
        if flat is not None:
            return flat
        facts = FuncFacts(fi)

        def visit(node: ast.AST, held: tuple) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                acquired = []
                for item in node.items:
                    lid = self.lock_key(fi, item.context_expr)
                    if lid is not None:
                        facts.acquisitions.append(
                            (lid, frozenset(held), node.lineno)
                        )
                        acquired.append(lid)
                    else:
                        # non-lock context managers still make calls
                        # (tracer.span(...)) the graph needs to see
                        visit(item.context_expr, held)
                inner = held + tuple(a for a in acquired if a not in held)
                for child in node.body:
                    visit(child, inner)
                return
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                return  # nested defs are their own call-graph nodes
            if isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"
                ):
                    lid = self.lock_key(fi, node.func.value)
                    if lid is not None:
                        facts.acquisitions.append(
                            (lid, frozenset(held), node.lineno)
                        )
                reason = blocking_reason(node)
                if reason is not None:
                    facts.blocking.append(
                        (reason, frozenset(held), node.lineno, node)
                    )
                facts.calls.append((node, frozenset(held), node.lineno))
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATORS
                ):
                    recv = dotted(node.func.value) or ""
                    if recv.startswith("self.") and recv.count(".") == 1:
                        # `.add()`/`.update()` on an attr whose inferred
                        # type DEFINES that method is a method call, not
                        # a container mutation (self._retry.add(...))
                        rtype = self.graph.instance_type(fi, node.func.value)
                        if rtype is None or node.func.attr not in rtype.methods:
                            facts.accesses.append(Access(
                                recv[len("self."):], "write",
                                node.lineno, frozenset(held),
                            ))
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    base = t
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    d = dotted(base)
                    if d and d.startswith("self.") and d.count(".") == 1:
                        facts.accesses.append(Access(
                            d[len("self."):], "write",
                            node.lineno, frozenset(held),
                        ))
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    d = dotted(t)
                    if d and d.startswith("self.") and d.count(".") == 1:
                        facts.accesses.append(Access(
                            d[len("self."):], "write",
                            node.lineno, frozenset(held),
                        ))
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr not in method_names
            ):
                facts.accesses.append(Access(
                    node.attr, "read", node.lineno, frozenset(held)
                ))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        body = fi.node.body if isinstance(fi.node.body, list) else [fi.node.body]
        for stmt in body:
            visit(stmt, ())
        return facts

    _EMPTY = frozenset()

    def _walk_flat(
        self, fi: FunctionInfo, facts: FuncFacts, method_names: set, nodes
    ) -> "FuncFacts | None":
        """The no-locks fast path: identical facts to the region walk,
        with every held set the empty frozenset. Returns None on the
        first With/acquire node -- the caller restarts with the region
        walk (partial facts are discarded with the FuncFacts)."""
        held = self._EMPTY
        for node in nodes:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                return None
            if isinstance(node, ast.Call):
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "acquire"):
                    return None
                reason = blocking_reason(node)
                if reason is not None:
                    facts.blocking.append((reason, held, node.lineno, node))
                facts.calls.append((node, held, node.lineno))
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATORS
                ):
                    recv = dotted(node.func.value) or ""
                    if recv.startswith("self.") and recv.count(".") == 1:
                        rtype = self.graph.instance_type(fi, node.func.value)
                        if rtype is None or node.func.attr not in rtype.methods:
                            facts.accesses.append(Access(
                                recv[len("self."):], "write",
                                node.lineno, held,
                            ))
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    base = t
                    while isinstance(base, ast.Subscript):
                        base = base.value
                    d = dotted(base)
                    if d and d.startswith("self.") and d.count(".") == 1:
                        facts.accesses.append(Access(
                            d[len("self."):], "write", node.lineno, held,
                        ))
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    d = dotted(t)
                    if d and d.startswith("self.") and d.count(".") == 1:
                        facts.accesses.append(Access(
                            d[len("self."):], "write", node.lineno, held,
                        ))
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr not in method_names
            ):
                facts.accesses.append(Access(
                    node.attr, "read", node.lineno, held
                ))
        return facts

    # -- interprocedural contexts -------------------------------------------
    def entry_contexts(self) -> dict:
        """fkey -> {frozenset(lockset): witness}, where witness is
        ``(caller fkey, call line, caller's own context lockset)`` --
        enough to rebuild the acquisition-to-blocking chain."""
        if self._contexts is not None:
            return self._contexts
        contexts: dict[tuple, dict] = {}
        work: list[tuple] = []

        def push(fkey, lockset, witness):
            if not lockset:
                return
            ctxs = contexts.setdefault(fkey, {})
            if lockset in ctxs or len(ctxs) >= _MAX_CONTEXTS:
                return
            ctxs[lockset] = witness
            work.append((fkey, lockset))

        for fkey, facts in self.facts.items():
            for call, held, line in facts.calls:
                if not held:
                    continue
                for target in self.graph.call_targets.get(
                    (facts.info.path, id(call)), ()
                ):
                    push(
                        target.key, frozenset(held),
                        (fkey, line, frozenset()),
                    )
        while work:
            fkey, lockset = work.pop()
            facts = self.facts.get(fkey)
            if facts is None:
                continue
            for call, held, line in facts.calls:
                for target in self.graph.call_targets.get(
                    (facts.info.path, id(call)), ()
                ):
                    push(
                        target.key, frozenset(lockset | held),
                        (fkey, line, lockset),
                    )
        self._contexts = contexts
        return contexts

    def context_chain(self, fkey: tuple, lockset: frozenset) -> list[str]:
        """Witness call chain (outermost caller first) for one inherited
        lockset, as ``path:qual:line`` hops."""
        chain = []
        contexts = self.entry_contexts()
        cur_key, cur_set = fkey, lockset
        seen = set()
        while (cur_key, cur_set) not in seen:
            seen.add((cur_key, cur_set))
            witness = contexts.get(cur_key, {}).get(cur_set)
            if witness is None:
                break
            caller, line, caller_set = witness
            path, qual = caller
            chain.append(f"{path}:{qual}:{line}")
            cur_key, cur_set = caller, frozenset(caller_set)
            if not cur_set:
                break
        chain.reverse()
        return chain

    @staticmethod
    def short_lock(key: str) -> str:
        """``pkg/mod.py:Cls._lock`` -> ``Cls._lock`` (for messages)."""
        return key.rsplit(":", 1)[-1]


def _parse_dotted(text: str) -> ast.AST:
    return ast.parse(text, mode="eval").body
