"""Rule engine: parse the port's package, run the C/R/P rule families,
report.

Port of ``predictionio_tpu/analysis/engine.py``. Its departures: the
package it sweeps by default is ``predictionio_tpu_torch/`` (the
directory above this file); ``all_rules`` lists the C, R and P families
only, so a J or S id given to ``--rules`` or ``--explain`` exits 2 with
the catalog of known rules, as any unknown id does; ``--update-docs``
writes the port's own catalog, ``docs/static_analysis_torch.md``;
``--mesh-report`` exits 2 (the port has no JAX mesh layer), and
``--changed`` keeps only changed files under the port's package.

The analyzer is deliberately dependency-free (``ast`` + the phase-2
whole-package core -- call graph, thread roles, lockset dataflow -- no
typeshed, no import-time execution of the analyzed code): it has to run
inside tier-1 on a 2-core box in single-digit seconds (files parse in
parallel, the package index builds once), and it encodes THIS repo's
invariants -- the no-blocking-I/O-under-a-lock rule, the Eraser-style
lockset race predicate, the exception-edge release and durability
orderings, the cross-process commit/publish/advance protocols -- not a
general Python lint. See ``docs/static_analysis_torch.md`` for the rule
catalog and the incident each rule encodes (``--explain RULE`` prints
any entry).

Baseline contract (``analysis/baseline.json``): accepted findings are keyed
by ``(rule, path, symbol)`` -- line-independent, so unrelated edits don't
churn the file -- and every entry carries a human justification. The
tier-1 gate asserts zero UNSUPPRESSED findings; entries that no longer
match any finding are "stale" and fail ``--self-check``, which is what
makes the baseline a ratchet instead of a dumping ground.
"""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import textwrap
import time
from dataclasses import dataclass, field, asdict
from typing import Iterable, Iterator

#: severity ladder (sort order for reports)
SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    rule_id: str
    severity: str
    path: str          # repo-relative, posix separators
    line: int
    symbol: str        # enclosing "Class.method" / "func" / "<module>"
    message: str
    hint: str = ""
    #: structured witness call path ("path:qual:line" hops) -- rendered
    #: as SARIF codeFlows; interprocedural rules populate it
    witness: tuple = ()
    #: (path, line, label) construction sites backing the finding (the
    #: reference's S rules fill it; no C, R or P rule does) -- rendered
    #: as SARIF relatedLocations
    related: tuple = ()

    def key(self) -> tuple:
        return (self.rule_id, self.path, self.symbol)

    def render(self) -> str:
        loc = f"{self.path}:{self.line}"
        hint = f" [fix: {self.hint}]" if self.hint else ""
        return f"{loc}: {self.rule_id} {self.severity}: {self.message}{hint}"


@dataclass
class ModuleContext:
    """One parsed file, shared by every rule."""

    path: str                       # repo-relative
    tree: ast.AST
    source: str
    #: id(node) -> qualname; built LAZILY on first symbol_for() -- the
    #: package rules never ask, so a --changed run only pays the symbol
    #: walk for the files whose module rules actually run
    symbols: dict | None = None

    def symbol_for(self, node: ast.AST) -> str:
        """Qualname of the innermost enclosing def/class, '<module>' else."""
        if self.symbols is None:
            self.symbols = _index_symbols(self.tree)
        return self.symbols.get(id(node), "<module>")


def _index_symbols(tree: ast.AST) -> dict:
    """Map every AST node to its enclosing Class.func qualname."""
    out: dict = {}

    def visit(node: ast.AST, qual: str) -> None:
        for child in ast.iter_child_nodes(node):
            q = qual
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                q = f"{qual}.{child.name}" if qual else child.name
            out[id(child)] = q or "<module>"
            visit(child, q)

    visit(tree, "")
    return out


def package_root() -> str:
    """The ``predictionio_tpu_torch`` package directory (computed from
    this file: the analyzer must not import the analyzed package)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_root() -> str:
    """Directory holding the ``predictionio_tpu_torch`` package."""
    return os.path.dirname(package_root())


def iter_py_files(root: str) -> Iterator[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        # the analyzer sweep must never descend into bytecode caches or
        # build output (repo-hygiene invariant, also enforced by .gitignore)
        dirnames[:] = [
            d for d in sorted(dirnames)
            if d not in ("__pycache__", "_build", ".git")
        ]
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


#: (abspath, root) -> (mtime_ns, size, ModuleContext). Repeated
#: in-process checks (check + report in one invocation, self_check, the
#: fixture suite) re-parse an unchanged file for free; any on-disk edit
#: changes the stat signature and invalidates the entry.
_parse_cache: dict = {}


def parse_module(path: str, root: str | None = None) -> ModuleContext | None:
    root = root or repo_root()
    apath = os.path.abspath(path)
    try:
        st = os.stat(apath)
    except OSError:
        # a path that vanished between scoping and parsing (a deleted
        # file in the --changed diff, a mid-run unlink) is skipped like
        # a syntax error, never a crash
        return None
    key = (apath, root)
    hit = _parse_cache.get(key)
    if (hit is not None and hit[0] == st.st_mtime_ns
            and hit[1] == st.st_size):
        return hit[2]
    try:
        with open(apath, "r", encoding="utf-8") as f:
            source = f.read()
    except OSError:
        return None
    rel = os.path.relpath(apath, root).replace(os.sep, "/")
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError:
        return None
    ctx = ModuleContext(path=rel, tree=tree, source=source)
    # the signature was taken before the read: if the file changed in
    # between, the stale entry misses on the next stat and re-parses
    _parse_cache[key] = (st.st_mtime_ns, st.st_size, ctx)
    return ctx


def parse_source(source: str, path: str = "fixture.py") -> ModuleContext:
    """Analyze an in-memory snippet (the rule-fixture test entry point)."""
    tree = ast.parse(source, filename=path)
    return ModuleContext(path=path, tree=tree, source=source)


def all_rules() -> list:
    from predictionio_tpu_torch.analysis import (
        rules_concurrency,
        rules_protocol,
        rules_resources,
    )

    return [
        cls() for cls in (
            rules_concurrency.RULES + rules_resources.RULES
            + rules_protocol.RULES
        )
    ]


def select_rules(rule_ids: Iterable[str] | None = None) -> list:
    rules = all_rules()
    if not rule_ids:
        return rules
    wanted = {r.upper() for r in rule_ids}
    known = sorted(r.rule_id for r in rules)
    unknown = wanted - set(known)
    if unknown:
        # exit-2 with the catalog, never a silent zero-rule run
        raise ValueError(
            f"unknown rule id(s): {sorted(unknown)} (known: {known})"
        )
    return [r for r in rules if r.rule_id in wanted]


def parse_files(files: list[str], root: str | None = None) -> list[ModuleContext]:
    """Parse many files concurrently (reads overlap; the 2-core sweep
    budget is paid here). Unparseable files are skipped,
    matching ``parse_module``."""
    root = root or repo_root()
    # ast.parse is GIL-bound: on a single-core box the thread pool only
    # adds scheduling overhead, so parse serially there
    if len(files) < 8 or (os.cpu_count() or 2) < 2:
        ctxs = [parse_module(p, root) for p in files]
    else:
        from concurrent.futures import ThreadPoolExecutor

        workers = min(8, max(2, os.cpu_count() or 2))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            ctxs = list(ex.map(lambda p: parse_module(p, root), files))
    return [c for c in ctxs if c is not None]


def check_paths(
    paths: Iterable[str] | None = None,
    rules: list | None = None,
    module_scope: "set[str] | None" = None,
    timings: "dict | None" = None,
) -> list[Finding]:
    """Run the rule set over files/directories; defaults to the package.

    Per-module rules run on each file independently; package rules
    (``check_package``) run ONCE over a shared :class:`PackageIndex`
    built from every parsed file -- scoping the paths scopes the
    interprocedural horizon with them.

    ``module_scope`` (repo-relative paths) restricts the PER-MODULE
    rules to those files while the package rules still see everything
    parsed: a module-rule finding depends only on its own file, so
    ``--changed`` skips the other ~99% of per-module work and stays
    inside the pre-commit latency budget. ``timings`` (optional dict) is
    filled with per-rule-family runtimes in seconds.

    The whole run executes with the cyclic garbage collector paused
    (restored on exit): the analysis allocates millions of AST/state
    objects that stay reachable for the run's whole lifetime, and the
    generational collector re-scanning them was measured at ~20% of the
    sweep on the pre-commit path. One run's allocations are bounded by
    the package size, so pausing is safe."""
    import gc

    gc_was_enabled = gc.isenabled()
    if gc_was_enabled:
        gc.disable()
    try:
        return _check_paths(paths, rules, module_scope, timings)
    finally:
        if gc_was_enabled:
            gc.enable()


def _check_paths(paths, rules, module_scope, timings) -> list[Finding]:
    rules = rules if rules is not None else all_rules()
    root = repo_root()
    files: list[str] = []
    for p in paths or [package_root()]:
        if os.path.isdir(p):
            files.extend(iter_py_files(p))
        else:
            files.append(p)
    t0 = time.perf_counter()
    contexts = parse_files(files, root)
    if timings is not None:
        timings["parse"] = time.perf_counter() - t0
    module_rules = [r for r in rules if not hasattr(r, "check_package")]
    package_rules = [r for r in rules if hasattr(r, "check_package")]
    findings: list[Finding] = []

    def charge(rule_id: str, spent: float) -> None:
        if timings is not None:
            fam = rule_id[:1]
            timings.setdefault("families", {})
            timings["families"][fam] = (
                timings["families"].get(fam, 0.0) + spent
            )

    module_contexts = contexts if module_scope is None else [
        c for c in contexts if c.path in module_scope
    ]
    for rule in module_rules:
        t0 = time.perf_counter()
        for ctx in module_contexts:
            findings.extend(rule.check(ctx))
        charge(rule.rule_id, time.perf_counter() - t0)
    if package_rules:
        from predictionio_tpu_torch.analysis.packageindex import PackageIndex

        t0 = time.perf_counter()
        index = PackageIndex.build(contexts)
        if timings is not None:
            timings["index"] = time.perf_counter() - t0
        for rule in package_rules:
            t0 = time.perf_counter()
            findings.extend(rule.check_package(index))
            charge(rule.rule_id, time.perf_counter() - t0)
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return findings


def changed_files() -> list[str]:
    """Repo-relative ``.py`` files the working tree has touched vs HEAD
    (staged, unstaged, and untracked) -- the ``pio check --changed``
    pre-commit scope.

    Deletions and renames resolve to SURVIVING paths only:
    ``--diff-filter=d`` drops deleted entries at the git level (rename
    sources included -- with rename detection off a rename is a
    delete+add pair), and the existence filter below backstops any git
    that still lists a path with no file behind it. Scoping a vanished
    path would either crash the parse or silently report on nothing."""
    root = repo_root()
    out: set[str] = set()
    for cmd in (
        ["git", "diff", "--name-only", "--diff-filter=d", "HEAD", "--"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        proc = subprocess.run(
            cmd, cwd=root, capture_output=True, text=True, timeout=30
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed: {proc.stderr.strip() or 'not a git repo?'}"
            )
        out.update(line.strip() for line in proc.stdout.splitlines())
    return sorted(
        f for f in out
        if f.endswith(".py") and os.path.exists(os.path.join(root, f))
    )


# -- baseline -----------------------------------------------------------------

def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def load_baseline(path: str | None = None) -> list[dict]:
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    entries = doc.get("entries", [])
    for e in entries:
        for key in ("rule", "path", "symbol", "justification"):
            if key not in e:
                raise ValueError(f"baseline entry missing {key!r}: {e}")
    return entries


def apply_baseline(
    findings: list[Finding], entries: list[dict]
) -> tuple[list[Finding], list[Finding], list[dict]]:
    """Split findings into (unsuppressed, suppressed); also return entries
    that matched nothing (stale -- the ratchet says delete them)."""
    keys = {(e["rule"], e["path"], e["symbol"]): e for e in entries}
    matched: set[tuple] = set()
    unsuppressed, suppressed = [], []
    for f in findings:
        if f.key() in keys:
            matched.add(f.key())
            suppressed.append(f)
        else:
            unsuppressed.append(f)
    stale = [e for k, e in keys.items() if k not in matched]
    return unsuppressed, suppressed, stale


def write_baseline(
    findings: list[Finding],
    path: str | None = None,
    preserved: list[dict] | None = None,
) -> int:
    """Write a baseline covering every current finding, preserving existing
    justifications; new entries get a TODO that ``--self-check`` rejects
    until a human writes the real reason. ``preserved`` entries (the parts
    of the old baseline a ``--rules``/path-scoped run did NOT re-examine)
    are carried over verbatim instead of silently dropped."""
    path = path or default_baseline_path()
    old = {}
    if os.path.exists(path):
        old = {(e["rule"], e["path"], e["symbol"]): e for e in load_baseline(path)}
    keys = {f.key() for f in findings}
    keys |= {(e["rule"], e["path"], e["symbol"]) for e in (preserved or [])}
    entries = []
    for key in sorted(keys):
        rule, fpath, symbol = key
        prior = old.get(key)
        entries.append({
            "rule": rule,
            "path": fpath,
            "symbol": symbol,
            "justification": prior["justification"] if prior else
            "TODO: justify or fix",
        })
    doc = {"version": 1, "entries": entries}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=False)
        f.write("\n")
    return len(entries)


# -- reports ------------------------------------------------------------------

def render_text(
    unsuppressed: list[Finding], suppressed: list[Finding], stale: list[dict]
) -> str:
    lines = [f.render() for f in unsuppressed]
    if stale:
        lines.append("")
        lines.append("stale baseline entries (fixed findings -- delete them):")
        lines.extend(
            f"  {e['rule']} {e['path']} {e['symbol']}" for e in stale
        )
    lines.append("")
    lines.append(
        f"pio check: {len(unsuppressed)} finding(s), "
        f"{len(suppressed)} baseline-suppressed, {len(stale)} stale entr"
        f"{'y' if len(stale) == 1 else 'ies'}"
    )
    return "\n".join(lines).lstrip("\n")


def render_json(
    unsuppressed: list[Finding], suppressed: list[Finding], stale: list[dict]
) -> str:
    return json.dumps(
        {
            "findings": [asdict(f) for f in unsuppressed],
            "suppressed": [asdict(f) for f in suppressed],
            "stale_baseline": stale,
            "analysis_findings_total": len(unsuppressed),
        },
        indent=2,
    )


#: the schema SARIF output declares (CI annotators key off this)
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def _sarif_location(path: str, line: int, message: str | None = None) -> dict:
    loc = {
        "physicalLocation": {
            "artifactLocation": {"uri": path},
            "region": {"startLine": max(int(line), 1)},
        },
    }
    if message:
        loc["message"] = {"text": message}
    return loc


def _sarif_result(f: Finding, suppressed: bool) -> dict:
    result = {
        "ruleId": f.rule_id,
        "level": "error" if f.severity == "error" else "warning",
        "message": {"text": f.message + (f" [fix: {f.hint}]" if f.hint else "")},
        "locations": [_sarif_location(f.path, f.line)],
    }
    if f.witness:
        # the witness call path ("path:qual:line" hops) becomes a SARIF
        # codeFlow so diff annotators can render the hand-off chain
        flow_locs = []
        for hop in f.witness:
            parts = hop.split(":")
            hop_path, hop_line, label = f.path, f.line, hop
            if parts and parts[0].endswith(".py"):
                hop_path = parts[0]
            if parts and parts[-1].isdigit():
                hop_line = int(parts[-1])
            flow_locs.append({
                "location": _sarif_location(hop_path, hop_line, label),
            })
        result["codeFlows"] = [{"threadFlows": [{"locations": flow_locs}]}]
    if f.related:
        # construction sites backing the finding ride as
        # relatedLocations so a CI annotator can link them next to the
        # violation
        result["relatedLocations"] = [
            _sarif_location(rpath, rline, label)
            for rpath, rline, label in f.related
        ]
    if suppressed:
        result["suppressions"] = [{"kind": "external"}]
    return result


def render_sarif(
    unsuppressed: list[Finding], suppressed: list[Finding], rules: list,
    stale: "list[dict] | None" = None,
) -> str:
    """SARIF 2.1.0 (``--format sarif``): rule metadata comes from the
    same docstrings that generate the docs tables and ``--explain``
    output, witness paths ride as codeFlows, and baseline-suppressed
    findings are emitted with a ``suppressions`` marker so CI can
    annotate diffs without re-reporting accepted risks. Stale baseline
    entries fail the run (exit 1), so they MUST appear as results too --
    a CI annotator must never render a clean report for a red run."""
    descriptors = []
    for rule in sorted(rules, key=lambda r: r.rule_id):
        flags, incident = _split_doc(rule)
        descriptors.append({
            "id": rule.rule_id,
            "shortDescription": {"text": " ".join(flags.split())[:280] or rule.rule_id},
            "fullDescription": {"text": " ".join(f"{flags} {incident}".split())},
            "defaultConfiguration": {
                "level": "error" if rule.severity == "error" else "warning",
            },
        })
    doc = {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "pio-check",
                    "informationUri": (
                        "https://github.com/apache/predictionio"
                    ),
                    "rules": descriptors,
                },
            },
            "results": [
                *(_sarif_result(f, False) for f in unsuppressed),
                *(_sarif_result(f, True) for f in suppressed),
                *({
                    "ruleId": e["rule"],
                    "level": "error",
                    "message": {"text": (
                        f"stale baseline entry for {e['symbol']}: no "
                        f"finding matches it anymore -- the issue was "
                        f"fixed, delete the suppression (the ratchet)"
                    )},
                    "locations": [_sarif_location(e["path"], 1)],
                } for e in (stale or ())),
            ],
        }],
    }
    return json.dumps(doc, indent=2)


# -- inventory reports (--protocol-report) -----------------------------------

def render_site_report_text(name: str, sites: list[dict]) -> str:
    """The inventory renderer: sites grouped by file plus a one-line
    kind summary (the reference's ``--mesh-report`` shares it)."""
    lines: list = []
    counts: dict = {}
    by_path: dict = {}
    for site in sites:
        counts[site["kind"]] = counts.get(site["kind"], 0) + 1
        by_path.setdefault(site["path"], []).append(site)
    for path in sorted(by_path):
        lines.append(f"{path}:")
        for site in by_path[path]:
            lines.append(
                f"  {site['line']}: [{site['kind']}] {site['qual']}: "
                f"{site['detail']}"
            )
    lines.append("")
    lines.append(
        f"{name}: "
        + ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
        + f" ({len(sites)} sites)"
    )
    return "\n".join(lines)


def render_site_report_json(name: str, sites: list[dict]) -> str:
    counts: dict = {}
    for site in sites:
        counts[site["kind"]] = counts.get(site["kind"], 0) + 1
    return json.dumps({
        "sites": sites,
        "counts": dict(sorted(counts.items())),
        "total": len(sites),
    }, indent=2)


def render_site_report_sarif(name: str, sites: list[dict]) -> str:
    """Inventory sites as note-level SARIF results (one ruleId per site
    kind) so CI annotators ingest the reports through the same pipeline
    as rule findings; round-trips against the json format (same site
    count, same locations)."""
    kinds = sorted({s["kind"] for s in sites})
    doc = {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "pio-check",
                    "informationUri": (
                        "https://github.com/apache/predictionio"
                    ),
                    "rules": [
                        {
                            "id": f"{name}/{kind}",
                            "shortDescription": {
                                "text": f"{name} inventory site: {kind}"
                            },
                            "defaultConfiguration": {"level": "note"},
                        }
                        for kind in kinds
                    ],
                },
            },
            "results": [
                {
                    "ruleId": f"{name}/{s['kind']}",
                    "level": "note",
                    "message": {
                        "text": f"{s['qual']}: {s['detail']}"
                    },
                    "locations": [
                        _sarif_location(s["path"], s["line"])
                    ],
                }
                for s in sites
            ],
        }],
    }
    return json.dumps(doc, indent=2)


def self_check(baseline_path: str | None = None) -> list[str]:
    """Cheap integrity pass: rules compile and are well-formed, every
    baseline entry still matches a real finding and carries a real
    justification. Returns a list of problems (empty = healthy)."""
    problems: list[str] = []
    rules = all_rules()
    seen_ids: set[str] = set()
    for rule in rules:
        if not rule.rule_id or rule.rule_id in seen_ids:
            problems.append(f"bad/duplicate rule id on {type(rule).__name__}")
        seen_ids.add(rule.rule_id)
        if rule.severity not in SEVERITIES:
            problems.append(f"{rule.rule_id}: bad severity {rule.severity!r}")
        if not getattr(rule, "check", None):
            problems.append(f"{rule.rule_id}: no check()")
        if not (type(rule).__doc__ or "").strip():
            problems.append(
                f"{rule.rule_id}: no docstring (it IS the --explain "
                f"entry and the docs table row)"
            )
    try:
        entries = load_baseline(baseline_path)
    except (ValueError, json.JSONDecodeError) as exc:
        return problems + [f"baseline unreadable: {exc}"]
    findings = check_paths(rules=rules)
    _, _, stale = apply_baseline(findings, entries)
    for e in stale:
        problems.append(
            f"stale baseline entry (no matching finding -- delete it): "
            f"{e['rule']} {e['path']} {e['symbol']}"
        )
    for e in entries:
        just = e.get("justification", "").strip()
        if not just or just.startswith("TODO"):
            problems.append(
                f"baseline entry lacks a justification: "
                f"{e['rule']} {e['path']} {e['symbol']}"
            )
    return problems


# -- the incident catalog (docstrings ARE the docs) ---------------------------

_INCIDENT_RE = re.compile(r"\bIncident\b")

#: markers the generated tables live between in docs/static_analysis_torch.md
DOCS_TABLE_BEGIN = "<!-- BEGIN GENERATED RULE TABLE: {family} (pio check --update-docs) -->"
DOCS_TABLE_END = "<!-- END GENERATED RULE TABLE: {family} -->"

#: every docstring-generated rule family, in docs order
DOC_FAMILIES = ("C", "R", "P")


def _split_doc(rule) -> tuple[str, str]:
    """A rule docstring split into (what it flags, the incident it
    encodes) at the first 'Incident' sentence. The docstring is the
    single source: ``--explain`` prints it whole, the docs table renders
    this split -- CLI and docs cannot drift."""
    doc = textwrap.dedent(
        (type(rule).__doc__ or "").strip("\n")
    ).strip()
    # dedent misses the first line (no leading whitespace); normalize all
    doc = "\n".join(line.strip() for line in doc.splitlines())
    m = _INCIDENT_RE.search(doc)
    if m is None:
        return doc, ""
    return doc[: m.start()].rstrip(" .\n"), doc[m.start():]


def _table_cell(text: str) -> str:
    text = " ".join(text.split())
    text = re.sub(r"^Incident[^:]*:\s*", "", text)
    return text.replace("|", "\\|")


def explain(rule_id: str) -> str:
    """The incident-catalog entry for one rule (``--explain RULE``):
    the rule class docstring, verbatim."""
    rules = {r.rule_id: r for r in all_rules()}
    rule = rules.get(rule_id.upper())
    if rule is None:
        raise ValueError(
            f"unknown rule id {rule_id!r} (known: {sorted(rules)})"
        )
    flags, incident = _split_doc(rule)
    if not flags:
        raise ValueError(
            f"rule {rule.rule_id} has no docstring to explain (the "
            f"docstring IS the incident-catalog entry; --self-check "
            f"should have caught this)"
        )
    body = flags + ("\n\n" + incident if incident else "")
    return f"{rule.rule_id} ({rule.severity})\n\n{body}\n"


def render_rule_table(family: str) -> str:
    """The markdown rule table for one family ('C', 'R' or 'P'), generated
    from the rule docstrings. Embedded in docs/static_analysis_torch.md
    between the DOCS_TABLE markers by ``--update-docs``; a tier-1 test
    asserts the committed docs match this output."""
    rows = [
        "| rule | severity | what it flags | the incident it encodes |",
        "|---|---|---|---|",
    ]
    for rule in sorted(all_rules(), key=lambda r: r.rule_id):
        if not rule.rule_id.startswith(family):
            continue
        flags, incident = _split_doc(rule)
        rows.append(
            f"| {rule.rule_id} | {rule.severity} | {_table_cell(flags)} "
            f"| {_table_cell(incident) or '—'} |"
        )
    return "\n".join(rows)


def default_docs_path() -> str:
    return os.path.join(repo_root(), "docs", "static_analysis_torch.md")


def update_docs(path: str | None = None) -> list[str]:
    """Rewrite the generated rule-table blocks in the docs file; returns
    the families replaced. A family whose markers are missing raises --
    silently skipping one would leave its table stale while reporting
    success."""
    path = path or default_docs_path()
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    missing = [
        family for family in DOC_FAMILIES
        if DOCS_TABLE_BEGIN.format(family=family) not in text
        or DOCS_TABLE_END.format(family=family) not in text
    ]
    if missing:
        raise ValueError(
            f"docs rule-table markers missing for famil"
            f"{'y' if len(missing) == 1 else 'ies'} {', '.join(missing)} "
            f"in {path}"
        )
    replaced = []
    for family in DOC_FAMILIES:
        begin = DOCS_TABLE_BEGIN.format(family=family)
        end = DOCS_TABLE_END.format(family=family)
        head, rest = text.split(begin, 1)
        _, tail = rest.split(end, 1)
        text = f"{head}{begin}\n{render_rule_table(family)}\n{end}{tail}"
        replaced.append(family)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return replaced


def add_check_arguments(parser) -> None:
    """The ``pio check`` flag surface, defined ONCE -- shared by the
    standalone CLI (``python -m predictionio_tpu_torch.analysis``) and the
    ``pio check`` subcommand in ``tools/engine_commands.py``."""
    parser.add_argument(
        "paths", nargs="*",
        help="files/dirs to analyze (default: the predictionio_tpu_torch "
        "package)",
    )
    parser.add_argument(
        "--explain", default=None, metavar="RULE",
        help="print RULE's incident-catalog entry (the rule docstring "
        "that also generates the docs table) and exit",
    )
    parser.add_argument(
        "--changed", action="store_true",
        help="scope the report to files git says changed vs HEAD "
        "under the package (pre-commit use; the interprocedural analysis "
        "still sees the whole package, and out-of-scope baseline entries "
        "never go stale)",
    )
    parser.add_argument(
        "--update-docs", action="store_true",
        help="regenerate the rule tables in docs/static_analysis_torch.md "
        "from the rule docstrings",
    )
    parser.add_argument(
        "--mesh-report", action="store_true",
        help="the reference's inventory of mesh/shard_map/PartitionSpec "
        "sites; the port has no JAX mesh layer, so it exits 2",
    )
    parser.add_argument(
        "--protocol-report", action="store_true",
        help="emit the inventory of declared cross-process protocol "
        "points -- every commit (fsync/rename), publication (ring push, "
        "registry publish, notify, ack), and cursor-advance site with "
        "its protocol (text, json, or sarif via --format) instead of "
        "running the rules",
    )
    parser.add_argument(
        "--rules", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
        help="sarif = SARIF 2.1.0 (rule metadata from the docstrings, "
        "witness paths as codeFlows) for CI diff annotation",
    )
    parser.add_argument(
        "--baseline", default=None,
        help="baseline JSON (default: "
        "predictionio_tpu_torch/analysis/baseline.json; 'none' disables "
        "suppression)",
    )
    parser.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to cover every current finding "
        "(existing justifications preserved; new entries get a TODO "
        "that --self-check rejects)",
    )
    parser.add_argument(
        "--self-check", action="store_true",
        help="verify rules compile and baseline entries still correspond "
        "to real findings",
    )


def _scope(paths: list[str]) -> tuple[set[str], list[str]] | None:
    """CLI paths normalized to repo-relative (files, dirs); None = full run."""
    if not paths:
        return None
    root = repo_root()

    def rel(p: str) -> str:
        return os.path.relpath(os.path.abspath(p), root).replace(os.sep, "/")

    files = {rel(p) for p in paths if not os.path.isdir(p)}
    dirs = [rel(p) for p in paths if os.path.isdir(p)]
    return files, dirs


def _entry_in_scope(entry: dict, ran: set[str], scope) -> bool:
    """Did this run re-examine the code a baseline entry points at? Only
    in-scope entries may be reported stale or rewritten; the rest of the
    baseline is carried through untouched."""
    if entry["rule"] not in ran:
        return False
    if scope is None:
        return True
    files, dirs = scope
    return entry["path"] in files or any(
        entry["path"] == d or entry["path"].startswith(d + "/") for d in dirs
    )


def run_with_args(args) -> int:
    """Execute a parsed ``pio check`` invocation."""
    if getattr(args, "explain", None):
        try:
            print(explain(args.explain), end="")
        except ValueError as exc:
            print(f"Error: {exc}")
            return 2
        return 0
    if getattr(args, "update_docs", False):
        try:
            replaced = update_docs()
        except (ValueError, OSError) as exc:
            print(f"Error: {exc}")
            return 2
        print(
            f"docs rule table(s) regenerated: {', '.join(replaced)}-series"
        )
        return 0
    wants_mesh = getattr(args, "mesh_report", False)
    wants_protocol = getattr(args, "protocol_report", False)
    if wants_mesh and wants_protocol:
        print("Error: --mesh-report and --protocol-report are exclusive")
        return 2
    if wants_mesh:
        print(
            "Error: --mesh-report inventories JAX mesh, shard_map and "
            "PartitionSpec sites; the port has no JAX mesh layer (its "
            "meshes are torch.distributed process groups, "
            "parallel/mesh.py)"
        )
        return 2
    if wants_protocol:
        missing = [p for p in args.paths if not os.path.exists(p)]
        if missing:
            print(f"Error: no such file or directory: {', '.join(missing)}")
            return 2
        from predictionio_tpu_torch.analysis.packageindex import PackageIndex

        root = repo_root()
        files: list[str] = []
        for p in args.paths or [package_root()]:
            if os.path.isdir(p):
                files.extend(iter_py_files(p))
            else:
                files.append(p)
        index = PackageIndex.build(parse_files(files, root))
        name, sites = "protocol-report", index.protocols().report_sites()
        if args.format == "json":
            print(render_site_report_json(name, sites))
        elif args.format == "sarif":
            print(render_site_report_sarif(name, sites))
        else:
            print(render_site_report_text(name, sites))
        return 0
    if args.self_check:
        problems = self_check(
            None if args.baseline in (None, "none") else args.baseline
        )
        if problems:
            for p in problems:
                print(f"self-check: {p}")
            return 1
        print("self-check OK: rules compile, baseline entries all live")
        return 0

    try:
        rules = select_rules(
            [r for r in (args.rules or "").split(",") if r.strip()] or None
        )
    except ValueError as exc:
        print(f"Error: {exc}")
        return 2
    missing = [p for p in args.paths if not os.path.exists(p)]
    if missing:
        print(f"Error: no such file or directory: {', '.join(missing)}")
        return 2
    if getattr(args, "changed", False):
        # the full package still parses (package rules need the whole
        # call graph); only the REPORT narrows to the changed files,
        # with the same path-scoped baseline semantics as explicit
        # paths: out-of-scope entries are never reported stale
        if args.paths:
            print("Error: --changed and explicit paths are mutually exclusive")
            return 2
        try:
            changed = changed_files()
        except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
            print(f"Error: --changed needs git: {exc}")
            return 2
        root = repo_root()
        pkg_rel = os.path.relpath(package_root(), root).replace(os.sep, "/")
        # the port gates its own package only: a changed file of the
        # JAX package, the tests or the tools is the reference
        # analyzer's to report, never this one's
        changed_set = {f for f in changed if f.startswith(pkg_rel + "/")}
        # module rules scoped to the changed files (their findings only
        # depend on the file itself); package rules keep the whole-
        # package horizon -- this is what holds the pre-commit run under
        # its 2 s budget
        findings = check_paths(
            [package_root()], rules, module_scope=changed_set
        )
        findings = [f for f in findings if f.path in changed_set]
        ran = {r.rule_id for r in rules}
        scope = (changed_set, [])
    else:
        findings = check_paths(args.paths or None, rules)
        ran = {r.rule_id for r in rules}
        scope = _scope(args.paths)
    if args.update_baseline:
        if args.baseline == "none":
            print("Error: --update-baseline with --baseline none makes no sense")
            return 2
        # a --rules/path-scoped run rewrites only what it re-examined; the
        # rest of the baseline (other rules, other paths -- and their
        # human-written justifications) is preserved verbatim
        preserved = [
            e for e in load_baseline(args.baseline)
            if not _entry_in_scope(e, ran, scope)
        ]
        n = write_baseline(findings, args.baseline, preserved=preserved)
        print(f"baseline rewritten: {n} entr{'y' if n == 1 else 'ies'}")
        return 0
    entries = [] if args.baseline == "none" else load_baseline(args.baseline)
    # out-of-scope entries (unrun rules / unanalyzed paths) must not be
    # reported stale: this run produced no evidence about them
    entries = [e for e in entries if _entry_in_scope(e, ran, scope)]
    unsuppressed, suppressed, stale = apply_baseline(findings, entries)
    if args.format == "json":
        print(render_json(unsuppressed, suppressed, stale))
    elif args.format == "sarif":
        print(render_sarif(unsuppressed, suppressed, rules, stale))
    else:
        print(render_text(unsuppressed, suppressed, stale))
    return 1 if (unsuppressed or stale) else 0


def run_cli(argv: list[str] | None = None) -> int:
    """Shared implementation of ``pio check`` and
    ``python -m predictionio_tpu_torch.analysis``."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="pio check",
        description="concurrency, resource and protocol lint of the "
        "port (rule catalog: docs/static_analysis_torch.md)",
    )
    add_check_arguments(parser)
    return run_with_args(parser.parse_args(argv))
