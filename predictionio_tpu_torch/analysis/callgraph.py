"""Whole-package call graph: the phase-2 analysis substrate.

Port of ``predictionio_tpu/analysis/callgraph.py``; ``PACKAGE`` is the
port's, so imports resolve under ``predictionio_tpu_torch`` only.

Phase 1's concurrency rules saw one module at a time with one level of
``self.`` call propagation -- enough for the WAL/snapshot incidents, blind
to the shapes the serving tiers introduced, where the hazard spans files: the ring
consumer (``serving/procserver.py``) hands a lambda into
``QueryService.submit_query_async`` (``workflow/create_server.py``), which
registers a callback on a ``MicroBatcher`` future
(``workflow/microbatch.py``) that eventually calls the lambda back on the
flusher thread. A blocking call anywhere down that chain stalls every
batch, and no per-module walk can see it.

This module builds a module-qualified call graph over every parsed file:

- **functions**: every ``def``/``async def``/``lambda``, keyed by
  ``(path, qualname)`` (lambdas as ``<enclosing>.<lambda:LINE>``);
- **imports**: absolute and relative package imports, chased through one
  level of ``__init__`` re-exports;
- **types**: light flow-insensitive inference -- ``x = ClassName(...)``
  locals, ``self.attr = ClassName(...)`` instance attributes, and
  parameter annotations naming package classes -- so ``self._batcher
  .submit(...)`` resolves to ``MicroBatcher.submit``;
- **callable references**: ``self._run`` / ``module.func`` / bare names /
  ``functools.partial(fn, ...)`` wrappers / the ``jit(make_step(...))``
  factory form (a call whose callee ``return``s a nested def -- the shape
  the reference's ``rules_jax._JitIndex`` parses);
- **higher-order bindings**: when a resolved call passes a callable
  reference as an argument, the callee's parameter (and any ``self.attr =
  param`` publication of it) resolves future ``param(...)`` calls to that
  reference.  Bindings are unioned globally (context-insensitive) and the
  edge build iterates to a fixpoint, which is exactly what stitches the
  async serving chain above into one path.

The graph is deliberately an over-approximation in places (a name that
several classes define methods for resolves to all of them) and an
under-approximation in others (dynamic dispatch through untyped values
drops the edge); each rule built on top chooses which side to err on.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from predictionio_tpu_torch.analysis.astutil import call_name, dotted

#: the package every analyzed path is resolved under
PACKAGE = "predictionio_tpu_torch"

#: wrappers seen through when resolving a callable reference
_PARTIAL_NAMES = {"partial", "functools.partial"}

#: max re-export / binding fixpoint iterations (chains are short in
#: practice; the cap guards cyclic imports)
_MAX_CHASE = 4
_MAX_FIXPOINT = 5


@dataclass(eq=False)
class FunctionInfo:
    """One def/lambda: the call-graph node."""

    path: str
    qual: str
    node: ast.AST
    cls: str | None          # enclosing class qualname iff a direct method
    module: "ModuleInfo" = None

    @property
    def key(self) -> tuple[str, str]:
        return (self.path, self.qual)

    @property
    def name(self) -> str:
        return self.qual.rsplit(".", 1)[-1]

    def params(self) -> list[str]:
        cached = self.__dict__.get("_params")
        if cached is None:
            a = getattr(self.node, "args", None)
            cached = [] if a is None else [
                p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            ]
            self.__dict__["_params"] = cached
        return cached


@dataclass(eq=False)
class ClassInfo:
    path: str
    qual: str
    node: ast.ClassDef
    module: "ModuleInfo" = None
    methods: dict = field(default_factory=dict)   # name -> FunctionInfo
    #: attr -> set[ClassInfo]: ``self.attr = ClassName(...)``
    attr_types: dict = field(default_factory=dict)
    #: attr -> set[FunctionInfo]: ``self.attr = <callable ref>``
    attr_callables: dict = field(default_factory=dict)
    #: (method FunctionInfo, param name, attr): ``self.attr = param`` --
    #: resolved against param bindings during the fixpoint
    attr_from_param: list = field(default_factory=list)

    @property
    def key(self) -> tuple[str, str]:
        return (self.path, self.qual)


@dataclass(eq=False)
class ModuleInfo:
    ctx: object                  # engine.ModuleContext
    dotted: str                  # "predictionio_tpu_torch.serving.frontend"
    funcs: dict = field(default_factory=dict)     # qual -> FunctionInfo
    top: dict = field(default_factory=dict)       # module-level name -> FunctionInfo
    classes: dict = field(default_factory=dict)   # clsqual -> ClassInfo
    #: local name -> ("module", dotted) | ("symbol", dotted, name)
    imports: dict = field(default_factory=dict)
    #: statements under ``if __name__ == "__main__":`` (subprocess entry)
    main_body: list = field(default_factory=list)
    #: Import/ImportFrom nodes, collected during the ONE indexing visit
    #: (function-level lazy imports included) so no later pass re-walks
    #: the module tree
    import_nodes: list = field(default_factory=list)
    #: Assign-from-Call nodes (the lock/semaphore-constructor candidates)
    call_assigns: list = field(default_factory=list)

    @property
    def path(self) -> str:
        return self.ctx.path


def module_dotted(path: str) -> str:
    """``predictionio_tpu_torch/serving/frontend.py`` -> its import name."""
    p = path[:-3] if path.endswith(".py") else path
    parts = p.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


class CallSite:
    """One resolved call expression inside a function body."""

    __slots__ = ("line", "call", "targets")

    def __init__(self, line: int, call: ast.Call, targets: list):
        self.line = line
        self.call = call
        self.targets = targets   # list[FunctionInfo]


class CallGraph:
    """Package-wide function index + resolved call edges."""

    def __init__(self, contexts: list):
        self.modules: dict[str, ModuleInfo] = {}       # dotted -> ModuleInfo
        self.by_path: dict[str, ModuleInfo] = {}       # path -> ModuleInfo
        self.functions: dict[tuple, FunctionInfo] = {}  # key -> info
        self.classes: dict[tuple, ClassInfo] = {}
        #: fkey -> list[CallSite]
        self.callsites: dict[tuple, list] = {}
        #: (path, id(call ast node)) -> list[FunctionInfo] (locksets uses
        #: this to resolve calls during its own region walk)
        self.call_targets: dict[tuple, list] = {}
        #: (fkey, param) -> set[FunctionInfo]: higher-order bindings
        self.param_bindings: dict[tuple, set] = {}
        self._local_env_cache: dict[tuple, dict] = {}
        self._returned_defs_cache: dict[tuple, list] = {}
        self._params_cache: dict[tuple, frozenset] = {}
        #: id(fn node) -> flattened body-node list; every layer built on
        #: the graph (edges, roles, locksets fast path, the R-series
        #: flowgraphs) re-reads this instead of re-walking the AST --
        #: the body walk was the single hottest loop in the sweep
        self._body_cache: dict[int, list] = {}
        for ctx in contexts:
            self._index_module(ctx)
        self._index_imports()
        self._index_class_attrs()
        self._build_edges()

    # -- indexing -----------------------------------------------------------
    def _index_module(self, ctx) -> None:
        mod = ModuleInfo(ctx=ctx, dotted=module_dotted(ctx.path))
        self.modules[mod.dotted] = mod
        self.by_path[mod.path] = mod
        # nodes outside any function body (module level, decorators,
        # argument defaults) land here: traversed for indexing, read by
        # nobody -- the fill below is what makes body_nodes() free
        dead: list = []

        # iterative pre-order walk with an explicit stack; this touches
        # every node of every module, so generator machinery per node
        # (ast.iter_child_nodes) is what the inlined child iteration
        # below buys back. Stack entries carry the walk context:
        # (node, qual, parent_cls -- class the node is a DIRECT child
        # of, encl_cls -- innermost lexically-enclosing class, body --
        # innermost function's flattened node list)
        AST = ast.AST
        ATOM = _ATOM

        def push_children(stack, node, qual, parent_cls, encl_cls, body):
            sub = []
            append = sub.append
            for name in node._fields:
                f = getattr(node, name, None)
                if isinstance(f, AST):
                    if not isinstance(f, ATOM):
                        append((f, qual, parent_cls, encl_cls, body))
                elif type(f) is list:
                    for item in f:
                        if isinstance(item, AST) and not isinstance(item, ATOM):
                            append((item, qual, parent_cls, encl_cls, body))
            sub.reverse()
            stack.extend(sub)

        def enter_function(stack, child, fq, owner, stmts):
            """Descend into a def/lambda, filling its body-node cache:
            body statements (and their subtrees) go to the function's
            list, decorators/args are indexed but -- like ``_body_walk``
            -- belong to no body. Nested defs and lambdas inside a
            method close over its self, so they resolve self.* against
            the class (owner as encl_cls) even though only direct
            children are METHODS (parent_cls=None below)."""
            fbody: list = []
            self._body_cache[id(child)] = fbody
            body_ids = {id(s) for s in stmts}
            sub = []
            for name in child._fields:
                f = getattr(child, name, None)
                if isinstance(f, AST):
                    if not isinstance(f, ATOM):
                        sub.append((f, fq, None, owner,
                                    fbody if id(f) in body_ids else dead))
                elif type(f) is list:
                    for item in f:
                        if isinstance(item, AST) and not isinstance(item, ATOM):
                            sub.append((item, fq, None, owner,
                                        fbody if id(item) in body_ids
                                        else dead))
            sub.reverse()
            stack.extend(sub)

        stack: list = []
        push_children(stack, ctx.tree, "", None, None, dead)
        while stack:
            child, qual, parent_cls, encl_cls, body = stack.pop()
            t = child.__class__
            if t is ast.ClassDef:
                cq = f"{qual}.{child.name}" if qual else child.name
                cinfo = ClassInfo(mod.path, cq, child, module=mod)
                mod.classes[cq] = cinfo
                self.classes[cinfo.key] = cinfo
                body.append(child)
                push_children(stack, child, cq, cinfo, cinfo, body)
            elif t is ast.FunctionDef or t is ast.AsyncFunctionDef:
                fq = f"{qual}.{child.name}" if qual else child.name
                owner = parent_cls or encl_cls
                info = FunctionInfo(
                    mod.path, fq, child,
                    cls=owner.qual if owner else None,
                    module=mod,
                )
                mod.funcs[fq] = info
                self.functions[info.key] = info
                if parent_cls is not None:
                    parent_cls.methods[child.name] = info
                elif not qual:
                    mod.top[child.name] = info
                enter_function(stack, child, fq, owner, child.body)
            elif t is ast.Lambda:
                fq = f"{qual}.<lambda:{child.lineno}>" if qual else (
                    f"<lambda:{child.lineno}>"
                )
                owner = parent_cls or encl_cls
                info = FunctionInfo(
                    mod.path, fq, child,
                    cls=owner.qual if owner else None,
                    module=mod,
                )
                mod.funcs[fq] = info
                self.functions[info.key] = info
                enter_function(stack, child, fq, owner, [child.body])
            else:
                if t is ast.Import or t is ast.ImportFrom:
                    mod.import_nodes.append(child)
                elif t is ast.Assign:
                    if isinstance(child.value, ast.Call):
                        mod.call_assigns.append(child)
                elif (t is ast.If and qual == ""
                        and _is_main_guard(child.test)):
                    mod.main_body.extend(child.body)
                body.append(child)
                if t is ast.Name or t is ast.Constant:
                    continue  # leaves: nothing left to push
                push_children(
                    stack, child, qual, parent_cls, encl_cls, body
                )

    def _index_imports(self) -> None:
        for mod in self.modules.values():
            for node in mod.import_nodes:
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        if alias.name.startswith(PACKAGE):
                            local = alias.asname or alias.name.split(".")[0]
                            target = (
                                alias.name if alias.asname else
                                alias.name.split(".")[0]
                            )
                            mod.imports[local] = ("module", target)
                elif isinstance(node, ast.ImportFrom):
                    base = self._from_base(mod, node)
                    if base is None:
                        continue
                    for alias in node.names:
                        local = alias.asname or alias.name
                        sub = f"{base}.{alias.name}"
                        if sub in self.modules or not self._has_module(base):
                            mod.imports[local] = ("module", sub)
                        else:
                            mod.imports[local] = ("symbol", base, alias.name)

    def _has_module(self, dotted_name: str) -> bool:
        return dotted_name in self.modules

    def _from_base(self, mod: ModuleInfo, node: ast.ImportFrom) -> str | None:
        if node.level == 0:
            m = node.module or ""
            return m if m.startswith(PACKAGE) else None
        # relative: our dotted name minus (level) trailing components
        # (package __init__ modules count as the package itself)
        parts = mod.dotted.split(".")
        if not mod.path.endswith("__init__.py"):
            parts = parts[:-1]
        parts = parts[: len(parts) - (node.level - 1)] if node.level > 1 else parts
        base = ".".join(parts)
        if node.module:
            base = f"{base}.{node.module}"
        return base if base.startswith(PACKAGE) else None

    def _index_class_attrs(self) -> None:
        for cinfo in self.classes.values():
            for meth in cinfo.methods.values():
                params = set(meth.params())
                for node in self.body_nodes(meth.node):
                    if not isinstance(node, ast.Assign):
                        continue
                    for t in node.targets:
                        d = dotted(t)
                        if not (d and d.startswith("self.") and d.count(".") == 1):
                            continue
                        attr = d[len("self."):]
                        value = node.value
                        if isinstance(value, ast.Call):
                            hit = self._resolve_class_expr(meth, value.func)
                            if hit is not None:
                                cinfo.attr_types.setdefault(attr, set()).add(hit)
                                continue
                        refs = self.resolve_callable(meth, value, _env={})
                        if refs:
                            cinfo.attr_callables.setdefault(
                                attr, set()
                            ).update(refs)
                        elif isinstance(value, ast.Name) and value.id in params:
                            cinfo.attr_from_param.append(
                                (meth, value.id, attr)
                            )

    # -- symbol resolution --------------------------------------------------
    def resolve_symbol(self, dotted_mod: str, name: str, _depth: int = 0):
        """A name exported by a module: ('func', info) | ('class', cinfo)
        | None. Chases one-level ``__init__`` re-exports."""
        mod = self.modules.get(dotted_mod)
        if mod is None or _depth > _MAX_CHASE:
            return None
        if name in mod.top:
            return ("func", mod.top[name])
        if name in mod.classes:
            return ("class", mod.classes[name])
        imp = mod.imports.get(name)
        if imp is not None:
            if imp[0] == "module":
                return ("module", imp[1])
            return self.resolve_symbol(imp[1], imp[2], _depth + 1)
        return None

    def _resolve_class_expr(self, fi: FunctionInfo, expr: ast.AST) -> ClassInfo | None:
        """``ClassName`` / ``mod.ClassName`` / imported name -> ClassInfo."""
        d = dotted(expr)
        if d is None:
            return None
        mod = fi.module
        if "." not in d:
            if d in mod.classes:
                return mod.classes[d]
            hit = self.resolve_symbol(mod.dotted, d)
            if hit and hit[0] == "class":
                return hit[1]
            return None
        root, rest = d.split(".", 1)
        imp = mod.imports.get(root)
        if imp and imp[0] == "module":
            hit = self.resolve_symbol(imp[1], rest)
            if hit and hit[0] == "class":
                return hit[1]
        return None

    def _local_env(self, fi: FunctionInfo) -> dict:
        """name -> ('type', ClassInfo) | ('callables', set[FunctionInfo]);
        from ``x = ClassName(...)`` / ``x = <callable ref>`` assignments
        and class-annotated parameters."""
        cached = self._local_env_cache.get(fi.key)
        if cached is not None:
            return cached
        env: dict = {}
        args = getattr(fi.node, "args", None)
        if args is not None:
            for p in args.posonlyargs + args.args + args.kwonlyargs:
                if p.annotation is not None:
                    ann = p.annotation
                    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                        # "ScorerBridge" string annotations
                        ann = _parse_annotation(ann.value)
                    if ann is not None:
                        hit = self._resolve_class_expr(fi, ann)
                        if hit is not None:
                            env[p.arg] = ("type", hit)
        for node in self.body_nodes(fi.node):
            if not isinstance(node, ast.Assign):
                continue
            names = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            if not names:
                continue
            value = node.value
            if isinstance(value, ast.Call):
                hit = self._resolve_class_expr(fi, value.func)
                if hit is not None:
                    for n in names:
                        env[n] = ("type", hit)
                    continue
            refs = self.resolve_callable(fi, value, _env={})
            if refs:
                for n in names:
                    env[n] = ("callables", set(refs))
        self._local_env_cache[fi.key] = env
        return env

    def instance_type(self, fi: FunctionInfo, expr: ast.AST) -> ClassInfo | None:
        """Static type of a receiver expression, where inferable:
        ``self`` -> own class; typed local/param; ``self.attr`` with a
        recorded attr type."""
        if isinstance(expr, ast.Name):
            if expr.id == "self" and fi.cls is not None:
                return self.classes.get((fi.path, fi.cls))
            hit = self._local_env(fi).get(expr.id)
            if hit and hit[0] == "type":
                return hit[1]
            return None
        if isinstance(expr, ast.Attribute):
            base = self.instance_type(fi, expr.value)
            if base is not None:
                types = base.attr_types.get(expr.attr)
                if types and len(types) == 1:
                    return next(iter(types))
            return None
        return None

    # -- callable references ------------------------------------------------
    def resolve_callable(
        self, fi: FunctionInfo, expr: ast.AST, _env: dict | None = None
    ) -> list:
        """The function(s) a callable-valued expression denotes: the
        ``Thread(target=...)`` / ``add_done_callback(...)`` argument
        resolver. Returns [] when unresolvable."""
        if isinstance(expr, ast.Lambda):
            for info in fi.module.funcs.values():
                if info.node is expr:
                    return [info]
            return []
        if isinstance(expr, ast.Call):
            name = call_name(expr)
            if name in _PARTIAL_NAMES and expr.args:
                return self.resolve_callable(fi, expr.args[0], _env)
            # factory form: a call whose callee returns a nested def
            # (the jit(make_step(...)) shape)
            out = []
            for factory in self.resolve_callable(fi, expr.func, _env):
                out.extend(self._returned_defs(factory))
            return out
        d = dotted(expr)
        if d is None:
            return []
        env = self._local_env(fi) if _env is None else _env
        if "." not in d:
            hit = env.get(d)
            if hit:
                return list(hit[1]) if hit[0] == "callables" else []
            nested = fi.module.funcs.get(f"{fi.qual}.{d}")
            if nested is not None:
                return [nested]
            if d in fi.module.top:
                return [fi.module.top[d]]
            sym = self.resolve_symbol(fi.module.dotted, d)
            if sym and sym[0] == "func":
                return [sym[1]]
            return []
        root, rest = d.split(".", 1)
        if root == "self" and fi.cls is not None:
            cinfo = self.classes.get((fi.path, fi.cls))
            if cinfo is not None:
                if "." not in rest:
                    if rest in cinfo.methods:
                        return [cinfo.methods[rest]]
                    cands = cinfo.attr_callables.get(rest)
                    if cands:
                        return sorted(cands, key=lambda f: f.key)
                    return self._method_anywhere(fi.module, rest)
                attr, meth = rest.split(".", 1)
                if "." not in meth:
                    for t in cinfo.attr_types.get(attr, ()):  # typed attr
                        if meth in t.methods:
                            return [t.methods[meth]]
            return []
        hit = env.get(root)
        if hit and hit[0] == "type" and "." not in rest:
            m = hit[1].methods.get(rest)
            return [m] if m else []
        imp = fi.module.imports.get(root)
        if imp and imp[0] == "module":
            if "." not in rest:
                sym = self.resolve_symbol(imp[1], rest)
                if sym and sym[0] == "func":
                    return [sym[1]]
            else:
                first, meth = rest.split(".", 1)
                sym = self.resolve_symbol(imp[1], first)
                if sym and sym[0] == "class" and "." not in meth:
                    m = sym[1].methods.get(meth)
                    return [m] if m else []
        # imported class attribute: ClassName.method
        cinfo = None
        if root in fi.module.classes:
            cinfo = fi.module.classes[root]
        else:
            sym = self.resolve_symbol(fi.module.dotted, root)
            if sym and sym[0] == "class":
                cinfo = sym[1]
        if cinfo is not None and "." not in rest:
            m = cinfo.methods.get(rest)
            return [m] if m else []
        return []

    def _params_set(self, fi: FunctionInfo) -> frozenset:
        cached = self._params_cache.get(fi.key)
        if cached is None:
            cached = frozenset(fi.params())
            self._params_cache[fi.key] = cached
        return cached

    def _method_anywhere(self, mod: ModuleInfo, name: str) -> list:
        """``self.X`` with no same-class hit: any unique method named X in
        the module (the phase-1 _LockIndex heuristic, kept for fixtures
        written against it)."""
        hits = [
            c.methods[name] for c in mod.classes.values() if name in c.methods
        ]
        return hits if len(hits) == 1 else []

    def _returned_defs(self, factory: FunctionInfo) -> list:
        cached = self._returned_defs_cache.get(factory.key)
        if cached is not None:
            return cached
        out = []
        for ret in ast.walk(factory.node):
            if isinstance(ret, ast.Return) and isinstance(ret.value, ast.Name):
                nested = factory.module.funcs.get(
                    f"{factory.qual}.{ret.value.id}"
                )
                if nested is not None:
                    out.append(nested)
        self._returned_defs_cache[factory.key] = out
        return out

    # -- call resolution ----------------------------------------------------
    def resolve_call(self, fi: FunctionInfo, call: ast.Call) -> list:
        """The function(s) a call expression may enter."""
        func = call.func
        d = dotted(func)
        if d is None:
            # (lambda ...)(...) and subscripted callees: skip
            return []
        # param(...) through higher-order bindings
        if "." not in d and d in self._params_set(fi):
            return sorted(
                self.param_bindings.get((fi.key, d), ()),
                key=lambda f: f.key,
            )
        if d.startswith("self.") and d.count(".") == 1 and fi.cls is not None:
            cinfo = self.classes.get((fi.path, fi.cls))
            attr = d[len("self."):]
            if cinfo is not None and attr not in cinfo.methods:
                cands = cinfo.attr_callables.get(attr)
                if cands:
                    return sorted(cands, key=lambda f: f.key)
        targets = self.resolve_callable(fi, func)
        if targets:
            return targets
        # ClassName(...): the constructor is the callee
        cls = self._resolve_class_expr(fi, func)
        if cls is not None:
            init = cls.methods.get("__init__")
            return [init] if init is not None else []
        return []

    def _build_edges(self) -> None:
        # first pass: resolve every call once; the fixpoint then only
        # revisits DYNAMIC sites (param calls, attr-callable calls) whose
        # resolution can grow as higher-order bindings land -- the static
        # majority of sites never needs a second look
        dynamic: list[tuple] = []   # (fi, CallSite)
        for fi in list(self.functions.values()):
            params = self._params_set(fi)
            sites: list[CallSite] = []
            for node in self.body_nodes(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                targets = self.resolve_call(fi, node)
                site = CallSite(node.lineno, node, targets)
                sites.append(site)
                self.call_targets[(fi.path, id(node))] = targets
                self._bind_callable_args(fi, node, targets)
                d = dotted(node.func)
                if d is not None:
                    if "." not in d and d in params:
                        dynamic.append((fi, site))
                    elif d.startswith("self.") and d.count(".") == 1:
                        cinfo = (
                            self.classes.get((fi.path, fi.cls))
                            if fi.cls else None
                        )
                        # plain method calls resolve statically; only
                        # attr-callable slots can gain targets later
                        if cinfo is None or d[5:] not in cinfo.methods:
                            dynamic.append((fi, site))
            self.callsites[fi.key] = sites
        for _ in range(_MAX_FIXPOINT):
            changed = self._publish_param_attrs()
            for fi, site in dynamic:
                targets = self.resolve_call(fi, site.call)
                if [t.key for t in targets] != [
                    t.key for t in site.targets
                ]:
                    changed = True
                    site.targets = targets
                    self.call_targets[(fi.path, id(site.call))] = targets
                changed |= self._bind_callable_args(fi, site.call, targets)
            if not changed:
                break

    def _publish_param_attrs(self) -> bool:
        """Fold param bindings into ``self.attr = param`` publications."""
        changed = False
        for cinfo in self.classes.values():
            for meth, param, attr in cinfo.attr_from_param:
                bound = self.param_bindings.get((meth.key, param))
                if bound:
                    cur = cinfo.attr_callables.setdefault(attr, set())
                    if not bound <= cur:
                        cur.update(bound)
                        changed = True
        return changed

    def _bind_callable_args(
        self, fi: FunctionInfo, call: ast.Call, targets: list
    ) -> bool:
        """Record callable-reference arguments against the callee's
        parameters (the higher-order hand-off: ``submit_query_async(req,
        lambda r: ...)`` binds ``on_done`` to the lambda)."""
        changed = False
        for target in targets:
            params = target.params()
            offset = 1 if params[:1] == ["self"] else 0
            for i, arg in enumerate(call.args):
                refs = self._callable_arg(fi, arg)
                if refs and i + offset < len(params):
                    changed |= self._bind(
                        target, params[i + offset], refs
                    )
            for kw in call.keywords:
                if kw.arg is None:
                    continue
                refs = self._callable_arg(fi, kw.value)
                if refs and kw.arg in params:
                    changed |= self._bind(target, kw.arg, refs)
        return changed

    def _callable_arg(self, fi: FunctionInfo, expr: ast.AST) -> list:
        if isinstance(expr, (ast.Lambda, ast.Call)) or dotted(expr) is not None:
            refs = self.resolve_callable(fi, expr)
            # a Call argument that resolves as a *factory* form would be
            # a value, not a callable; only keep explicit partial()s
            if isinstance(expr, ast.Call) and call_name(expr) not in _PARTIAL_NAMES:
                return []
            return refs
        return []

    def _bind(self, target: FunctionInfo, param: str, refs: list) -> bool:
        cur = self.param_bindings.setdefault((target.key, param), set())
        fresh = set(refs) - cur
        if fresh:
            cur.update(fresh)
            return True
        return False

    # -- convenience --------------------------------------------------------
    def body_nodes(self, fn: ast.AST) -> list:
        """The function's body nodes, excluding nested defs/lambdas and
        their subtrees (those are their own call-graph nodes). Filled
        inline during indexing; the fallback (un-indexed nodes, e.g. a
        module tree) filters ``_body_walk`` to the same contract -- the
        raw walk also yields direct-child def statements themselves."""
        cached = self._body_cache.get(id(fn))
        if cached is None:
            cached = self._body_cache[id(fn)] = [
                n for n in _body_walk(fn)
                if not isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                )
            ]
        return cached

    def callees(self, fkey: tuple) -> list:
        return self.callsites.get(fkey, [])

    def function_at(self, path: str, qual: str) -> FunctionInfo | None:
        return self.functions.get((path, qual))


def _is_main_guard(test: ast.AST) -> bool:
    return (
        isinstance(test, ast.Compare)
        and isinstance(test.left, ast.Name)
        and test.left.id == "__name__"
        and any(
            isinstance(c, ast.Constant) and c.value == "__main__"
            for c in test.comparators
        )
    )


def _parse_annotation(text: str) -> ast.AST | None:
    try:
        return ast.parse(text, mode="eval").body
    except SyntaxError:
        return None


#: context/operator singletons (Load, Store, Add, Eq, ...): no children,
#: never inspected as standalone nodes (rules read them as ``node.ctx`` /
#: ``node.op`` attributes) -- ~a third of all AST nodes, so both the index
#: walk and every body_nodes() consumer skip them
_ATOM = (ast.expr_context, ast.boolop, ast.operator, ast.unaryop, ast.cmpop)


def _body_walk(fn: ast.AST):
    """Walk a function body without descending into nested defs/lambdas
    (those are their own call-graph nodes)."""
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda) + _ATOM,
            ):
                continue
            stack.append(child)
