"""Thread-role inference: WHICH threads can execute each function.

Port of ``predictionio_tpu/analysis/threadroles.py``.

The phase-1 concurrency rules modeled two roles per class (the lexical
``Thread(target=self.X)`` entry vs public methods) and could not see a
role cross a module boundary. The serving/online tiers broke that model:
the micro-batcher's flusher resolves futures whose done-callbacks live
two modules away, the scorer bridge's ring consumer is an event loop on
its own thread, frontend workers are whole subprocesses entered through
``__main__``, and the retrain loop's follower thread calls into the
registry that request threads also touch.

This module seeds roles at every construction the package uses:

- ``thread``: ``threading.Thread(target=f)`` targets, plus
  ``ServiceThread`` HOOKS (its ``on_stop`` teardown callable -- the
  serve loop itself dispatches stdlib handlers no static resolver can
  see) -- each construction site is a DISTINCT role (two different
  threads are two different execution contexts);
- ``timer``: ``threading.Timer(interval, f)`` bodies;
- ``callback``: functions registered via ``Future.add_done_callback`` --
  the flusher role: they run on whatever thread RESOLVES the future
  (the micro-batcher's flusher on the serving path);
- ``eventloop``: bodies of ``select``/``selectors`` polling loops (the
  frontend worker's single-threaded serve loop, the bridge's ring
  consumer). NOTE: an event loop is a *scheduling* discipline, not a
  thread identity -- C005-style stall rules treat it as a role, while
  C006's race detection folds it into whichever thread runs it;
- ``main``: calls made under a module's ``if __name__ == "__main__":``
  guard -- the subprocess entry points (``python -m ...`` workers).

Roles then propagate over the whole-package call graph: every function
reachable from a role's entry point carries that role, with a witness
path (the call chain from the entry) kept for reporting.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from predictionio_tpu_torch.analysis.astutil import call_name, keyword
from predictionio_tpu_torch.analysis.callgraph import CallGraph

#: role kinds that denote a distinct concurrent execution context (used
#: by C006; ``eventloop`` is excluded -- see module docstring)
CONCURRENT_KINDS = ("thread", "timer", "callback", "main")


@dataclass(frozen=True)
class Role:
    kind: str     # thread | timer | callback | eventloop | main
    seed: str     # "path:line" of the construction / guard site

    @property
    def label(self) -> str:
        return f"{self.kind}@{self.seed}"


class RoleInference:
    """Seed + propagate roles; query per-function role sets and witness
    call paths."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        #: fkey -> set[Role]
        self.roles: dict[tuple, set] = {}
        #: (fkey, role) -> (parent fkey | None, call line | None)
        self._parent: dict[tuple, tuple] = {}
        self._seed_entries: list[tuple] = []  # (Role, fkey)
        self._seed()
        self._propagate()

    # -- seeds --------------------------------------------------------------
    def _seed(self) -> None:
        for fi in self.graph.functions.values():
            for node in self.graph.body_nodes(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                name = call_name(node)
                site = f"{fi.path}:{node.lineno}"
                if name == "ServiceThread" or name.endswith(".ServiceThread"):
                    # ServiceThread(server, on_stop=...): serve_forever
                    # dispatches stdlib handlers we cannot resolve, but
                    # its HOOKS (the on_stop teardown callable) run on
                    # whatever thread stops the service, concurrent with
                    # request handlers -- seed those
                    for kw in node.keywords:
                        self._add_seed(fi, "thread", site, kw.value)
                    for arg in node.args[1:]:
                        self._add_seed(fi, "thread", site, arg)
                elif name == "threading.Thread" or name.endswith(".Thread") or (
                    name == "Thread"
                ):
                    kw = keyword(node, "target")
                    if kw is not None:
                        self._add_seed(fi, "thread", site, kw.value)
                elif name == "threading.Timer" or name.endswith(".Timer") or (
                    name == "Timer"
                ):
                    target = None
                    kw = keyword(node, "function")
                    if kw is not None:
                        target = kw.value
                    elif len(node.args) >= 2:
                        target = node.args[1]
                    if target is not None:
                        self._add_seed(fi, "timer", site, target)
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_done_callback"
                    and node.args
                ):
                    self._add_seed(fi, "callback", site, node.args[0])
            if self._is_select_loop(fi):
                role = Role("eventloop", f"{fi.path}:{fi.node.lineno}")
                self._seed_entries.append((role, fi.key))
        for mod in self.graph.modules.values():
            if not mod.main_body:
                continue
            entry = _MainEntry(mod)
            for stmt in mod.main_body:
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call):
                        for target in self.graph.resolve_call(entry, node):
                            role = Role("main", f"{mod.path}:{node.lineno}")
                            self._seed_entries.append((role, target.key))

    def _add_seed(self, fi, kind: str, site: str, expr: ast.AST) -> None:
        for target in self.graph.resolve_callable(fi, expr):
            self._seed_entries.append((Role(kind, site), target.key))

    def _is_select_loop(self, fi) -> bool:
        """A while-loop body that polls ``*.select(...)``: the
        single-thread event-loop shape (frontend serve, ring consumer)."""
        for node in self.graph.body_nodes(fi.node):
            if not isinstance(node, ast.While):
                continue
            for inner in ast.walk(node):
                if (
                    isinstance(inner, ast.Call)
                    and isinstance(inner.func, ast.Attribute)
                    and inner.func.attr == "select"
                ):
                    return True
        return False

    # -- propagation --------------------------------------------------------
    def _propagate(self) -> None:
        work: list[tuple] = []
        for role, fkey in self._seed_entries:
            if fkey not in self.graph.functions:
                continue
            if role not in self.roles.setdefault(fkey, set()):
                self.roles[fkey].add(role)
                self._parent[(fkey, role)] = (None, None)
                work.append((fkey, role))
        while work:
            fkey, role = work.pop()
            for site in self.graph.callees(fkey):
                for target in site.targets:
                    tset = self.roles.setdefault(target.key, set())
                    if role in tset:
                        continue
                    tset.add(role)
                    self._parent[(target.key, role)] = (fkey, site.line)
                    work.append((target.key, role))

    # -- queries ------------------------------------------------------------
    def roles_of(self, fkey: tuple) -> set:
        return self.roles.get(fkey, set())

    def entries(self, kinds: tuple) -> list:
        """(Role, entry fkey) seeds whose kind is in ``kinds``."""
        return [
            (role, fkey) for role, fkey in self._seed_entries
            if role.kind in kinds and fkey in self.graph.functions
        ]

    def witness_path(self, fkey: tuple, role: Role) -> list[str]:
        """Call chain from the role's entry point to ``fkey``:
        ``["path:qual", "path:qual:line", ...]`` (entry first)."""
        chain: list[tuple] = []
        cur = fkey
        seen = set()
        while cur is not None and cur not in seen:
            seen.add(cur)
            parent = self._parent.get((cur, role))
            if parent is None:
                break
            chain.append((cur, parent[1]))
            cur = parent[0]
        chain.reverse()
        out = []
        for (path, qual), line in chain:
            out.append(f"{path}:{qual}" + (f":{line}" if line else ""))
        return out


class _MainEntry:
    """A pseudo-FunctionInfo for resolving calls made at a module's
    ``__main__`` guard (module scope: no self, no params)."""

    def __init__(self, mod):
        self.path = mod.path
        self.qual = "<module>"
        self.cls = None
        self.module = mod
        self.node = mod.ctx.tree
        self.key = (mod.path, "<module>")

    def params(self) -> list:
        return []
