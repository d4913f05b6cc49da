"""Cross-process protocol facts: declared commit/publish/advance points.

Port of ``predictionio_tpu/analysis/protocols.py``; the blessed routing
implementation is the port's ``predictionio_tpu_torch/utils/stablehash.py``.

The serving fabric and the partitioned WAL made the system a
multi-process fabric -- N scorer
shards behind a swap-epoch protocol, P WAL partitions each with its own
fsync stream and follower cursor, portfile handshakes, and one shared
``stablehash`` bucket function that ingest and serving must agree on
forever.  Every per-process family (C/R) stops at the process
boundary; the P series lifts the discipline to cross-process
happens-before.

The model is *declared*, not inferred: ``PROTOCOLS`` is a small table
naming, per protocol, its

- **commit points** -- the calls that make state durable (``os.fsync``,
  the WAL's group-commit ``sync``, a directory-entry fsync);
- **publication points** -- the calls that make state visible to a peer
  process (ring push, registry publish, the ``/models/swap`` notify, a
  handshake ``os.replace``, a future/HTTP 2xx ack);
- **advance points** -- the calls that move a replay cursor or
  checkpoint past consumed input.

``ProtocolFlow`` classifies every call site in the package against this
table (one pass over the shared call graph, cached on the
``PackageIndex`` like ``ResourceFlow``), folds the tags
transitively over call edges, seeds *process roles* from each module's
``__main__`` guard (each entry module is a DISTINCT role -- the
cross-process analogue of the thread roles), and exposes the
path-sensitive ordering scans the P rules are built on.  The same site
inventory backs ``pio check --protocol-report``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass


# -- the declared-protocol table ----------------------------------------------

@dataclass(frozen=True)
class Point:
    """One declared protocol point: a syntactic recognizer for the calls
    that commit, publish, advance, or consume protocol state."""

    role: str                 # "commit" | "publish" | "advance" | "consume"
    kind: str                 # stable site label ("fsync", "ring-push", ...)
    names: tuple = ()         # exact dotted call names ("os.fsync",)
    suffixes: tuple = ()      # dotted-name suffixes (".append",)
    name_all: tuple = ()      # every token must appear in the call name
    recv_any: tuple = ()      # receiver (dotted prefix) token allow-list
    target_any: tuple = ()    # substring match against resolved arg text
    arg_2xx: bool = False     # first positional arg must be a 2xx constant


@dataclass(frozen=True)
class Protocol:
    """One cross-process protocol: its ordering contract plus the table
    of declared points the analysis recognizes."""

    name: str
    contract: str
    points: tuple
    guard_tokens: tuple = ()   # swap-epoch: version-guard field tokens
    layout_tokens: tuple = ()  # handshake: targets needing a dir fsync
    verify_tokens: tuple = ()  # handshake: targets needing a CRC verify
    blessed: str = ""          # routing: the one blessed implementation


PROTOCOLS = (
    Protocol(
        name="wal-ack",
        contract=(
            "every ack (future result, HTTP 2xx, ring completion) is "
            "preceded by the fsync covering the writes it acknowledges"
        ),
        points=(
            Point("write", "wal-append", suffixes=(".append",),
                  recv_any=("wal", "journal")),
            Point("commit", "fsync", names=("os.fsync",),
                  suffixes=(".fsync",)),
            Point("commit", "group-commit", suffixes=(".sync",),
                  recv_any=("wal", "journal")),
            Point("publish", "future-ack", suffixes=(".set_result",)),
            Point("publish", "http-2xx", suffixes=(".send_response",),
                  arg_2xx=True),
            Point("publish", "ring-completion", suffixes=(".push",),
                  recv_any=("ring", "rings", "ctl", "requests",
                            "completions")),
        ),
    ),
    Protocol(
        name="replay-cursor",
        contract=(
            "publish -> notify -> cursor advance; a cursor or checkpoint "
            "never passes input whose consumer obligation is still open"
        ),
        points=(
            Point("publish", "registry-publish", suffixes=(".publish",)),
            Point("publish", "swap-notify", name_all=("notify", "swap")),
            Point("advance", "cursor-advance", suffixes=(".advance",)),
            Point("advance", "checkpoint", suffixes=(".checkpoint",)),
        ),
    ),
    Protocol(
        name="swap-epoch",
        contract=(
            "a frame or response field read from a peer process binds the "
            "generation/epoch guard in the same acquisition that read it"
        ),
        guard_tokens=("generation", "epoch", "version"),
        points=(
            Point("publish", "ring-push", suffixes=(".push",),
                  recv_any=("ring", "rings", "ctl", "requests",
                            "completions")),
            Point("consume", "ring-pop", suffixes=(".pop",),
                  recv_any=("ring", "rings", "ctl", "requests",
                            "completions")),
        ),
    ),
    Protocol(
        name="handshake",
        contract=(
            "handshake artifacts (portfile/marker/manifest) are fsynced "
            "before the rename that publishes them; layout markers also "
            "fsync the directory entry; READY files are CRC-verified "
            "before they are trusted"
        ),
        layout_tokens=("parts",),
        verify_tokens=("ready",),
        points=(
            Point("commit", "fsync", names=("os.fsync",),
                  suffixes=(".fsync",)),
            Point("commit", "dir-fsync", name_all=("fsync", "dir")),
            Point("publish", "handshake-rename",
                  names=("os.replace", "os.rename"),
                  target_any=("port", "parts", "marker", "manifest",
                              "ready")),
        ),
    ),
    Protocol(
        name="shard-routing",
        contract=(
            "every partition/shard selection routes through "
            "utils/stablehash.stable_bucket: ingest and serving must "
            "agree on the bucket function forever"
        ),
        blessed="predictionio_tpu_torch/utils/stablehash.py",
        points=(),
    ),
)

def _build_trigger_tokens() -> frozenset:
    """One witness token per declared point: a call whose name tokens
    miss ALL of them cannot match any point, so ``_classify`` skips the
    protocol loop for the ~95% of calls that are not protocol points.
    The longest token of each recognizer is the rarest in practice."""
    trig = set()
    for proto in PROTOCOLS:
        for pt in proto.points:
            for n in pt.names:
                toks = _TOKEN_RE.findall(n.split(".")[-1].lower())
                if toks:
                    trig.add(max(toks, key=len))
            for s in pt.suffixes:
                toks = _TOKEN_RE.findall(s.split(".")[-1].lower())
                if toks:
                    trig.add(max(toks, key=len))
            if pt.name_all:
                trig.add(max((t.lower() for t in pt.name_all), key=len))
    return frozenset(trig)


#: the one blessed routing implementation (exempt from P004)
ROUTING_BLESSED_PATH = "utils/stablehash.py"
#: right-operand tokens that mark a ``%`` as a routing decision
ROUTING_TOKENS = frozenset(
    ("shard", "shards", "partition", "partitions", "bucket", "buckets")
)


@dataclass(frozen=True)
class Site:
    """One classified protocol point occurrence in the package."""

    protocol: str
    role: str
    kind: str
    path: str
    qual: str
    line: int
    detail: str
    target: str = ""   # resolved rename-target text (handshake sites)


_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _tokens(text: str) -> frozenset:
    return frozenset(_TOKEN_RE.findall(text.lower()))


_TRIGGER_TOKENS = _build_trigger_tokens()


def _dotted(node: ast.AST) -> str:
    """``self.rings[i].requests.push`` -> ``self.rings.requests.push``
    (subscripts are transparent; unresolvable bases become ``?``)."""
    parts = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        else:
            break
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        parts.append("?")
    else:
        return ""
    return ".".join(reversed(parts))


def _expr_text(expr: ast.AST, env: dict, consts: dict, depth: int = 0) -> str:
    """Best-effort text of an argument expression, following same-
    function Name assignments and module-level string constants -- the
    resolution that lets ``os.replace(tmp, path)`` see through
    ``path = os.path.join(self.directory, _PARTS_FILE)``."""
    if depth > 4:
        return ""
    if isinstance(expr, ast.Constant):
        return str(expr.value) if isinstance(expr.value, str) else ""
    if isinstance(expr, ast.Name):
        if expr.id in env:
            return env[expr.id]
        if expr.id in consts:
            return consts[expr.id]
        return expr.id
    if isinstance(expr, ast.Attribute):
        return _dotted(expr)
    if isinstance(expr, ast.JoinedStr):
        return "".join(
            _expr_text(v.value if isinstance(v, ast.FormattedValue) else v,
                       env, consts, depth + 1)
            for v in expr.values
        )
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        return (_expr_text(expr.left, env, consts, depth + 1)
                + _expr_text(expr.right, env, consts, depth + 1))
    if isinstance(expr, ast.Call):
        # os.path.join(a, b, ...) and str.format-ish calls: join the args
        return " ".join(
            _expr_text(a, env, consts, depth + 1) for a in expr.args
        )
    return ""


# -- process roles ------------------------------------------------------------

@dataclass(frozen=True)
class ProcRole:
    """One OS-process identity, seeded at a module's ``__main__`` guard.
    Distinct entry modules are distinct roles: the shard executable and
    the frontend executable never share an address space, so a value
    crossing between their call trees crossed a process boundary."""

    module: str   # dotted module of the entry point
    seed: str     # "path:line" of the guard

    @property
    def label(self) -> str:
        return f"proc:{self.module}"


class _ProcEntry:
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


class ProcessRoles:
    """Which OS processes can execute each function: ``__main__``-guard
    seeds propagated over call edges (the cross-process analogue of
    ``RoleInference``).  Functions reachable from two different entry
    modules run in two different processes -- that is the stitching
    P003 needs to call a ring/portfile/notify edge *cross*-process."""

    def __init__(self, graph):
        self.graph = graph
        self.role_map: dict[tuple, set] = {}
        self._parent: dict[tuple, tuple] = {}
        work = []
        for mod in graph.modules.values():
            if not mod.main_body:
                continue
            role = ProcRole(
                mod.dotted, f"{mod.path}:{mod.main_body[0].lineno}"
            )
            entry = _ProcEntry(mod)
            for stmt in mod.main_body:
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    for target in graph.resolve_call(entry, node):
                        bucket = self.role_map.setdefault(target.key, set())
                        if role not in bucket:
                            bucket.add(role)
                            self._parent[(target.key, role)] = (
                                None, node.lineno
                            )
                            work.append((target.key, role))
        while work:
            fkey, role = work.pop()
            for cs in graph.callees(fkey):
                for target in cs.targets:
                    bucket = self.role_map.setdefault(target.key, set())
                    if role not in bucket:
                        bucket.add(role)
                        self._parent[(target.key, role)] = (fkey, cs.line)
                        work.append((target.key, role))

    def roles_of(self, fkey: tuple) -> set:
        return self.role_map.get(fkey, set())

    def witness_path(self, fkey: tuple, role: ProcRole) -> list[str]:
        """Seed-to-function hop list ("path:qual:line") for SARIF
        codeFlows, mirroring ``RoleInference.witness_path``."""
        hops = []
        cur = fkey
        while cur is not None:
            parent, line = self._parent.get((cur, role), (None, 0))
            hops.append(f"{cur[0]}:{cur[1]}:{line}")
            cur = parent
        return list(reversed(hops))


# -- the facts layer ----------------------------------------------------------

_ROLE_ORDER = {"commit": 0, "write": 1, "consume": 2, "advance": 3,
               "publish": 4}


class ProtocolFlow:
    """Protocol point classification + transitive tags + process roles,
    built ONCE per ``PackageIndex`` (every P rule and
    ``--protocol-report`` read the same build)."""

    def __init__(self, index):
        self.index = index
        self.graph = index.graph
        self._consts: dict[str, dict] = {}
        for ctx in index.contexts:
            self._consts[ctx.path] = {
                t.id: s.value.value
                for s in ctx.tree.body if isinstance(s, ast.Assign)
                for t in s.targets
                if isinstance(t, ast.Name)
                and isinstance(s.value, ast.Constant)
                and isinstance(s.value.value, str)
            }
        #: (path, id(call node)) -> tuple[Site, ...]
        self.call_sites: dict[tuple, tuple] = {}
        #: fkey -> list[Site]
        self.fn_sites: dict[tuple, list] = {}
        self.sites: list[Site] = []
        #: fkey -> frozenset[(protocol, role)] -- transitive over callees
        self.trans: dict[tuple, set] = {}
        #: (fkey, (protocol, role)) -> representative Site for witnesses
        self.trans_repr: dict[tuple, Site] = {}
        #: fkeys containing a bare ``open(...)`` call -- the only
        #: candidates for the READY-read scan
        self.open_fns: set[tuple] = set()
        self._scan_sites()
        self._build_trans()
        self.proc = ProcessRoles(self.graph)
        #: modules whose process role pushes swap-epoch frames (the
        #: producer side of every ring edge)
        self.pusher_modules: set[str] = set()
        for fkey, sites in self.fn_sites.items():
            if not any(s.protocol == "swap-epoch" and s.role == "publish"
                       for s in sites):
                continue
            for role in self.proc.roles_of(fkey):
                self.pusher_modules.add(role.module)
            if fkey[1] == "<module>":
                mod = self.graph.by_path.get(fkey[0])
                if mod is not None:
                    self.pusher_modules.add(mod.dotted)

    # -- classification -----------------------------------------------------
    def _env(self, fi) -> dict:
        """Same-function Name -> resolved text (single pass; assignments
        normally precede the uses the rename matcher cares about)."""
        env: dict[str, str] = {}
        consts = self._consts.get(fi.path, {})
        for node in self.graph.body_nodes(fi.node):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                text = _expr_text(node.value, env, consts)
                if text:
                    env[tgt.id] = text
        return env

    def _scan_sites(self) -> None:
        for fi in self.graph.functions.values():
            env = None
            for node in self.graph.body_nodes(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                if (isinstance(node.func, ast.Name)
                        and node.func.id == "open" and node.args):
                    self.open_fns.add(fi.key)
                if env is None:
                    env = self._env(fi)
                sites = self._classify(fi.path, fi.qual, node, env)
                if sites:
                    self.call_sites[(fi.path, id(node))] = sites
                    self.fn_sites.setdefault(fi.key, []).extend(sites)
                    self.sites.extend(sites)
        for mod in self.graph.modules.values():
            for stmt in mod.main_body:
                for node in ast.walk(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    sites = self._classify(
                        mod.path, "<module>", node, {}
                    )
                    if sites:
                        self.call_sites[(mod.path, id(node))] = sites
                        self.fn_sites.setdefault(
                            (mod.path, "<module>"), []
                        ).extend(sites)
                        self.sites.extend(sites)
        self.sites.sort(key=lambda s: (s.path, s.line, s.protocol, s.role))

    def _classify(self, path, qual, call, env) -> tuple:
        name = _dotted(call.func)
        if not name:
            return ()
        toks = _tokens(name)
        if not (toks & _TRIGGER_TOKENS):
            return ()
        consts = self._consts.get(path, {})
        out = []
        seen = set()
        for proto in PROTOCOLS:
            for pt in proto.points:
                if (proto.name, pt.role) in seen:
                    continue
                target = self._match(pt, name, toks, call, env, consts)
                if target is None:
                    continue
                seen.add((proto.name, pt.role))
                out.append(Site(
                    protocol=proto.name, role=pt.role, kind=pt.kind,
                    path=path, qual=qual, line=call.lineno,
                    detail=f"{name}(...)", target=target,
                ))
        return tuple(out)

    def _match(self, pt, name, toks, call, env, consts):
        """None = no match; otherwise the resolved target text ("" when
        the point carries no target filter)."""
        hit = False
        if pt.names and name in pt.names:
            hit = True
        if not hit and pt.suffixes:
            for suf in pt.suffixes:
                if name.endswith(suf) and len(name) > len(suf):
                    recv = name[: -len(suf)]
                    if not pt.recv_any or (_tokens(recv)
                                           & set(pt.recv_any)):
                        hit = True
                        break
        if not hit and pt.name_all and set(pt.name_all) <= toks:
            hit = True
        if not hit:
            return None
        if pt.arg_2xx:
            if not call.args:
                return None
            arg = call.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, int)
                    and 200 <= arg.value < 300):
                return None
        if pt.target_any:
            text = " ".join(
                _expr_text(a, env, consts) for a in call.args
            ).lower()
            if not any(t in text for t in pt.target_any):
                return None
            return text
        return ""

    # -- transitive tags ----------------------------------------------------
    def _build_trans(self) -> None:
        tags: dict[tuple, set] = {}
        for fkey, sites in self.fn_sites.items():
            bucket = tags.setdefault(fkey, set())
            for s in sites:
                tag = (s.protocol, s.role)
                bucket.add(tag)
                self.trans_repr.setdefault((fkey, tag), s)
        changed = True
        while changed:
            changed = False
            for fkey in self.graph.callsites:
                bucket = tags.setdefault(fkey, set())
                for cs in self.graph.callsites[fkey]:
                    for target in cs.targets:
                        for tag in tags.get(target.key, ()):
                            if tag not in bucket:
                                bucket.add(tag)
                                rep = self.trans_repr.get(
                                    (target.key, tag)
                                )
                                if rep is not None:
                                    self.trans_repr.setdefault(
                                        (fkey, tag), rep
                                    )
                                changed = True
        self.trans = tags

    # -- the report ---------------------------------------------------------
    def report_sites(self) -> list[dict]:
        """Uniform site dicts for the shared inventory-report writer
        (``--protocol-report``): one row per classified point."""
        return [
            {
                "kind": f"{s.role}:{s.kind}",
                "protocol": s.protocol,
                "path": s.path,
                "qual": s.qual,
                "line": s.line,
                "detail": s.detail,
            }
            for s in self.sites
        ]


# -- the path-sensitive ordering scan -----------------------------------------

def _copy_state(state: dict) -> dict:
    return {k: set(v) for k, v in state.items()}


def _merge_state(dst: dict, src: dict) -> None:
    """May-union, except ``must*`` keys which intersect: a fact under a
    ``must`` key holds only if it holds on EVERY path reaching the
    join."""
    for k in set(dst) | set(src):
        a, b = dst.get(k, set()), src.get(k, set())
        dst[k] = (a & b) if k.startswith("must") else (a | b)


def scan_ordering(graph, fi, state: dict, visit, finish=None) -> None:
    """Walk ``fi``'s body path-sensitively in statement order.

    ``visit(state, call)`` fires for every call in execution order and
    mutates ``state`` (a dict of sets; ``must*`` keys intersect at
    joins, everything else unions).  If-branches fork copies; a branch
    that terminates (return/raise/break/continue) never merges back --
    that is what keeps the noop early-return in ``RetrainLoop.run_once``
    from polluting the fall-through path.  ``finish(state)`` fires once
    per function exit (every return/raise and the natural fall-off)."""

    def visit_calls(node, st):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                visit(st, sub)

    def walk(stmts, st) -> bool:
        for s in stmts:
            t = type(s)
            if t in (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef):
                continue
            if t in (ast.Return, ast.Raise):
                visit_calls(s, st)
                if finish is not None:
                    finish(st)
                return False
            if t in (ast.Break, ast.Continue):
                return False
            if t is ast.If:
                visit_calls(s.test, st)
                then_st, else_st = _copy_state(st), _copy_state(st)
                then_live = walk(s.body, then_st)
                else_live = walk(s.orelse, else_st)
                if then_live and else_live:
                    st.clear()
                    st.update(then_st)
                    _merge_state(st, else_st)
                elif then_live:
                    st.clear()
                    st.update(then_st)
                elif else_live:
                    st.clear()
                    st.update(else_st)
                else:
                    return False
                continue
            if t in (ast.For, ast.AsyncFor):
                visit_calls(s.iter, st)
                body_st = _copy_state(st)
                if walk(s.body, body_st):
                    _merge_state(st, body_st)
                if s.orelse and not walk(s.orelse, st):
                    return False
                continue
            if t is ast.While:
                visit_calls(s.test, st)
                body_st = _copy_state(st)
                if walk(s.body, body_st):
                    _merge_state(st, body_st)
                if s.orelse and not walk(s.orelse, st):
                    return False
                continue
            if t in (ast.With, ast.AsyncWith):
                for item in s.items:
                    visit_calls(item.context_expr, st)
                if not walk(s.body, st):
                    return False
                continue
            if t is ast.Try:
                entry = _copy_state(st)
                live = walk(s.body, st)
                if live and s.orelse:
                    live = walk(s.orelse, st)
                branches = [st] if live else []
                for h in s.handlers:
                    # the handler can enter from anywhere between the
                    # try entry and the body end: union both
                    h_st = _copy_state(st)
                    _merge_state(h_st, entry)
                    if walk(h.body, h_st):
                        branches.append(h_st)
                if not branches:
                    if s.finalbody:
                        walk(s.finalbody, _copy_state(entry))
                    return False
                merged = branches[0]
                for b in branches[1:]:
                    _merge_state(merged, b)
                if merged is not st:
                    st.clear()
                    st.update(merged)
                if s.finalbody and not walk(s.finalbody, st):
                    return False
                continue
            visit_calls(s, st)
        return True

    body = fi.node.body
    if not isinstance(body, list):
        # a Lambda: single expression, single path
        visit_calls(body, state)
        if finish is not None:
            finish(state)
        return
    if walk(body, state) and finish is not None:
        finish(state)


# -- the rule-facing checks ---------------------------------------------------

def _call_events(flow, fi, call, protocol, paired: tuple) -> list:
    """Events a call contributes for one protocol: its direct sites plus
    derived tags from resolved callees.  A callee carrying BOTH roles of
    a ``paired`` contract (e.g. write+commit, or advance+publish) is
    internally ordered -- it is checked in its own scan and contributes
    only the net effect (the first role of the pair for commit-like
    pairs, nothing for advance/publish pairs)."""
    events = []
    for s in flow.call_sites.get((fi.path, id(call)), ()):
        if s.protocol == protocol:
            events.append((s.role, s))
    for target in flow.graph.call_targets.get((fi.path, id(call)), ()):
        if target.key == fi.key:
            continue
        tags = flow.trans.get(target.key) or ()
        roles = {r for (p, r) in tags if p == protocol}
        if not roles:
            continue
        net = _net_roles(roles, paired)
        for role in net:
            rep = flow.trans_repr.get((target.key, (protocol, role)))
            if rep is not None:
                events.append((role, rep))
    events.sort(key=lambda e: _ROLE_ORDER.get(e[0], 9))
    return events


def _net_roles(roles: set, paired: tuple) -> set:
    lo, hi = paired
    if lo in roles and hi in roles:
        # internally ordered: a commit-pair nets to the commit; an
        # ordering pair (advance/publish) nets to nothing
        return {lo} if lo == "commit" else set()
    return set(roles)


def ack_before_commit(flow, fi) -> list[tuple]:
    """P001 scan: (write line, write detail, ack line, ack kind) per
    path where an ack is reachable with an uncommitted WAL write."""
    # every write/ack visible to the scan (direct sites and callee nets
    # alike) is in the transitive tag set, so a function missing either
    # role cannot fire and skips the path-sensitive walk entirely
    tags = flow.trans.get(fi.key) or ()
    if ("wal-ack", "write") not in tags or ("wal-ack", "publish") not in tags:
        return []
    findings: list[tuple] = []
    seen: set[tuple] = set()

    def visit(state, call):
        for role, site in _call_events(
            flow, fi, call, "wal-ack", ("commit", "write")
        ):
            if role == "commit":
                state["pending"].clear()
            elif role == "write":
                state["pending"].add((site.line, site.detail))
            elif role == "publish":
                for wline, wdetail in sorted(state["pending"]):
                    key = (wline, call.lineno)
                    if key not in seen:
                        seen.add(key)
                        findings.append(
                            (wline, wdetail, call.lineno, site.kind)
                        )

    scan_ordering(flow.graph, fi, {"pending": set()}, visit)
    return findings


def advance_before_publish(flow, fi) -> list[tuple]:
    """P002 scan: (advance line, advance detail, publish line, publish
    kind) per path where a cursor advance precedes a publication."""
    tags = flow.trans.get(fi.key) or ()
    if (("replay-cursor", "advance") not in tags
            or ("replay-cursor", "publish") not in tags):
        return []
    findings: list[tuple] = []
    seen: set[tuple] = set()

    def visit(state, call):
        for role, site in _call_events(
            flow, fi, call, "replay-cursor", ("advance", "publish")
        ):
            if role == "advance":
                state["advanced"].add((site.line, site.detail))
            elif role == "publish":
                for aline, adetail in sorted(state["advanced"]):
                    key = (aline, call.lineno)
                    if key not in seen:
                        seen.add(key)
                        findings.append(
                            (aline, adetail, call.lineno, site.kind)
                        )

    scan_ordering(flow.graph, fi, {"advanced": set()}, visit)
    return findings


def handshake_findings(flow, fi) -> list[tuple]:
    """P005 scan: ("unsynced-rename" | "layout-no-dirfsync", line,
    detail) -- renames of handshake artifacts without a preceding fsync
    on the path, and layout-marker renames whose directory entry is
    never fsynced before the function exits."""
    # both finding shapes anchor on a rename performed HERE: a function
    # with no direct handshake publish site cannot fire
    if not any(s.protocol == "handshake" and s.role == "publish"
               for s in flow.fn_sites.get(fi.key, ())):
        return []
    findings: list[tuple] = []
    seen: set[tuple] = set()

    def emit(kind, line, detail):
        if (kind, line) not in seen:
            seen.add((kind, line))
            findings.append((kind, line, detail))

    def visit(state, call):
        for role, site in _call_events(
            flow, fi, call, "handshake", ("commit", "publish")
        ):
            if role != "commit":
                continue
            state["must_sync"].add("synced")
            if site.kind == "dir-fsync":
                state["pending_dir"].clear()
        for s in flow.call_sites.get((fi.path, id(call)), ()):
            if s.protocol != "handshake" or s.role != "publish":
                continue
            if "synced" not in state["must_sync"]:
                emit("unsynced-rename", s.line, s.detail)
            if any(t in s.target for t in ("parts",)):
                state["pending_dir"].add((s.line, s.detail))
            # the fsync is consumed: a second rename needs its own
            state["must_sync"].clear()

    def finish(state):
        for line, detail in sorted(state["pending_dir"]):
            emit("layout-no-dirfsync", line, detail)

    scan_ordering(
        flow.graph, fi,
        {"must_sync": set(), "pending_dir": set()},
        visit, finish,
    )
    return findings


_VERIFY_OK_TOKENS = frozenset(("crc", "crc32", "checksum", "digest", "sha",
                               "sha256", "md5", "verify"))


def unverified_ready_reads(flow, fi) -> list[tuple]:
    """P005 companion: (line, detail) for ``open()`` of a READY-style
    handshake file in a function that never mentions a CRC/checksum."""
    if fi.key not in flow.open_fns:
        return []
    graph = flow.graph
    consts = flow._consts.get(fi.path, {})
    env = flow._env(fi)
    reads = []
    fn_tokens: set = set()
    for node in graph.body_nodes(fi.node):
        if isinstance(node, (ast.Name, ast.Attribute)):
            fn_tokens |= _tokens(_dotted(node))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            fn_tokens |= _tokens(node.value)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "open" and node.args):
            text = _expr_text(node.args[0], env, consts).lower()
            if "ready" in text:
                reads.append((node.lineno, f"open({text[:40]!r})"))
    if not reads or (fn_tokens & _VERIFY_OK_TOKENS):
        return []
    return reads


def unguarded_peer_reads(flow, fi) -> list[tuple]:
    """P003 scan: (line, field, role labels, pusher modules) for guard-
    field reads off a ring-popped frame with no guard comparison in the
    function, in a process role distinct from every pusher's."""
    graph = flow.graph
    guard = set()
    for proto in PROTOCOLS:
        guard |= set(proto.guard_tokens)
    tainted: dict[str, int] = {}
    for node in graph.body_nodes(fi.node):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        sites = flow.call_sites.get((fi.path, id(node.value)), ())
        if not any(s.protocol == "swap-epoch" and s.role == "consume"
                   for s in sites):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                tainted[tgt.id] = node.lineno
            elif isinstance(tgt, ast.Tuple):
                for elt in tgt.elts:
                    if isinstance(elt, ast.Name):
                        tainted[elt.id] = node.lineno
    if not tainted:
        return []
    reads: list[tuple] = []       # (line, field, bound-name-or-None)
    compare_tokens: set = set()
    compare_names: set = set()
    assigns: dict[int, str] = {}  # id(value node) -> bound local name
    for node in graph.body_nodes(fi.node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            assigns[id(node.value)] = node.targets[0].id
        if isinstance(node, ast.Compare):
            for side in [node.left, *node.comparators]:
                compare_tokens |= _tokens(_dotted(side))
                if isinstance(side, ast.Constant):
                    compare_tokens |= _tokens(str(side.value))
                if isinstance(side, ast.Name):
                    compare_names.add(side.id)
    for node in graph.body_nodes(fi.node):
        field = None
        if (isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id in tainted
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            if _tokens(node.slice.value) & guard:
                field = node.slice.value
        elif (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in tainted):
            if _tokens(node.attr) & guard:
                field = node.attr
        if field is not None:
            reads.append((node.lineno, field, assigns.get(id(node))))
    if not reads:
        return []
    if compare_tokens & guard:
        return []
    unbound = [r for r in reads if r[2] is None
               or r[2] not in compare_names]
    if not unbound:
        return []
    roles = flow.proc.roles_of(fi.key)
    if not roles:
        return []
    my_modules = {r.module for r in roles}
    foreign = flow.pusher_modules - my_modules
    if not foreign:
        return []
    labels = sorted(r.label for r in roles)
    return [(line, field, labels, sorted(foreign))
            for line, field, _ in unbound]


def routing_mod_sites(tree: ast.AST, path: str) -> list[tuple]:
    """P004 scan (file-local): (line, text) for every ``%`` whose right
    operand names a shard/partition/bucket count, outside the blessed
    ``utils/stablehash.py``."""
    if path.replace("\\", "/").endswith(ROUTING_BLESSED_PATH):
        return []
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.BinOp)
                and isinstance(node.op, ast.Mod)):
            continue
        right = _dotted(node.right)
        if not right:
            continue
        last = right.rsplit(".", 1)[-1]
        if _tokens(last) & ROUTING_TOKENS:
            left = _dotted(node.left) or "<expr>"
            out.append((node.lineno, f"{left} % {right}"))
    return out
