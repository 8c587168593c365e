"""Framework-aware AST lint engine.

Generic linters cannot see this framework's contracts: that a
``store.builder()`` left unbuilt leaks a writer thread and a tempfile on
a long-lived elastic worker, that wall-clock reads under a coordination
lock skew lease math, or that a CUDA-graph-captured function with a
numpy RNG bakes one draw into every replay.  Each rule here encodes
one such contract as an AST check; the registry keeps rules declarative
(id, severity, rationale, path scope) so the catalog in DESIGN §18 is
generated from the same objects the engine runs.

Suppression is explicit and auditable:

- inline: a ``# lmr: disable=LMR001`` (comma-separated ids) comment on
  the offending line;
- baseline: entries in ``analysis/baseline.json`` — the checked-in
  suppression file the CI gate reads.  The repo ships with an EMPTY
  baseline; anything added must carry a reason.

Copy of the JAX package's ``analysis/lint.py``, anchored on this
package: paths are relative to ``lua_mapreduce_tpu_torch/``, the rules
are this package's ``rules`` and the baseline its own
``analysis/baseline.json``; the CLI is ``python -m
lua_mapreduce_tpu_torch.analysis``.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DISABLE_RE = re.compile(r"#\s*lmr:\s*disable=([A-Z0-9, ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str
    severity: str            # "error" | "warning"
    path: str                # package-relative posix path
    line: int
    col: int
    message: str

    def key(self) -> tuple:
        return (self.path, self.line, self.rule)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Rule:
    """Base class: subclasses set the metadata and implement check().

    ``paths`` scopes the rule to package-relative prefixes (empty =
    every file).  Registration is by subclassing — the registry is the
    set of Rule subclasses, instantiated fresh per run.
    """

    id: str = ""
    severity: str = "error"
    title: str = ""
    rationale: str = ""
    paths: Sequence[str] = ()

    def applies(self, rel: str) -> bool:
        return not self.paths or any(rel.startswith(p) for p in self.paths)

    def check(self, ctx: "FileContext") -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "FileContext", node: ast.AST,
                message: str) -> Finding:
        return Finding(self.id, self.severity, ctx.rel,
                       getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0), message)


class FileContext:
    """One parsed source file handed to every applicable rule."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)

    def line_disables(self, lineno: int) -> set:
        """Rule ids suppressed inline on ``lineno``."""
        return _line_disables_in(self.lines, lineno)


def all_rules() -> List[Rule]:
    """Fresh instances of every registered rule, id order."""
    from lua_mapreduce_tpu_torch.analysis import rules as _rules  # registers

    def leaves(cls):
        subs = cls.__subclasses__()
        if not subs:
            yield cls
        for s in subs:
            yield from leaves(s)

    del _rules
    out = [cls() for cls in set(leaves(Rule)) if cls.id]
    out.sort(key=lambda r: r.id)
    return out


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def _iter_rel_files(paths: Sequence[str]):
    """(abs path, rel) pairs, anchoring each input directory the way
    the call graph does: package files keep the package-relative path,
    files under an explicit directory root are relative to it (so
    fixture trees carry their ``coord/``-style scope prefixes), bare
    files fall back to their basename."""
    for p in paths:
        root = p if os.path.isdir(p) else (os.path.dirname(p) or ".")
        for f in _iter_py_files([p]):
            ap = os.path.abspath(f)
            if ap.startswith(_PKG_ROOT + os.sep):
                rel = os.path.relpath(ap, _PKG_ROOT)
            else:
                rel = os.path.relpath(ap, os.path.abspath(root))
            yield f, rel.replace(os.sep, "/")


def load_baseline(path: Optional[str] = None) -> List[dict]:
    """The checked-in suppression entries: [{rule, path, line?, reason}].
    ``line`` is optional (a file-wide suppression for one rule); every
    entry must carry a non-empty ``reason`` — the audit trail."""
    if path is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "baseline.json")
    try:
        with open(path) as f:
            entries = json.load(f)
    except FileNotFoundError:
        return []
    for e in entries:
        if not e.get("reason"):
            raise ValueError(
                f"baseline entry {e!r} has no reason — suppressions must "
                "be justified")
    return entries


def _baseline_match(entry: dict, f: Finding) -> bool:
    if entry.get("rule") != f.rule or entry.get("path") != f.path:
        return False
    return "line" not in entry or int(entry["line"]) == f.line


def _collect_raw(paths: Sequence[str], rules: Sequence[Rule]):
    """Pre-suppression findings + the pragma inventory + per-file line
    maps: the shared substrate of run_lint and the stale-suppression
    audit."""
    raw: List[Finding] = []
    pragmas: List[dict] = []               # {path, line, rule}
    lines_by_rel: Dict[str, List[str]] = {}
    sources: List[tuple] = []              # (rel, source) — graph input
    for path, rel in _iter_rel_files(paths):
        # a file the gate cannot read or parse cannot be verified — that
        # is itself a finding (LMR000), never a crash of the gate
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except (UnicodeDecodeError, OSError) as e:
            raw.append(Finding("LMR000", "error", rel, 0, 0,
                               f"file is not readable utf-8: {e}"))
            continue
        try:
            ctx = FileContext(path, rel, source)
        except SyntaxError as e:
            raw.append(Finding("LMR000", "error", rel,
                               e.lineno or 0, e.offset or 0,
                               f"file does not parse: {e.msg}"))
            continue
        except ValueError as e:     # ast.parse on NUL bytes
            raw.append(Finding("LMR000", "error", rel, 0, 0,
                               f"file does not parse: {e}"))
            continue
        lines_by_rel[ctx.rel] = ctx.lines
        sources.append((ctx.rel, source, ctx.tree))
        # the pragma INVENTORY comes from real comment tokens only —
        # a ``# lmr: disable=`` mention inside a docstring or a test
        # fixture string is documentation, not a suppression
        pragmas.extend(_comment_pragmas(ctx.rel, source))
        for rule in rules:
            if not rule.applies(ctx.rel):
                continue
            raw.extend(rule.check(ctx))
    return raw, pragmas, lines_by_rel, sources


def _comment_pragmas(rel: str, source: str) -> List[dict]:
    import io
    import tokenize
    out: List[dict] = []
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _DISABLE_RE.search(tok.string)
            if not m:
                continue
            for rid in (s.strip() for s in m.group(1).split(",")):
                if rid:
                    out.append({"path": rel, "line": tok.start[0],
                                "rule": rid})
    except (tokenize.TokenError, IndentationError):
        pass          # unparseable tails already surfaced as LMR000
    return out


def _line_disables_in(lines: Sequence[str], lineno: int) -> set:
    if not (1 <= lineno <= len(lines)):
        return set()
    m = _DISABLE_RE.search(lines[lineno - 1])
    if not m:
        return set()
    return {s.strip() for s in m.group(1).split(",") if s.strip()}


def run_lint(paths: Optional[Sequence[str]] = None,
             baseline: Optional[str] = None,
             rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Lint ``paths`` (default: the whole package) and return the
    findings that survive inline + baseline suppression, sorted by
    (path, line, rule)."""
    if paths is None:
        paths = [_PKG_ROOT]
    if rules is None:
        rules = all_rules()
    base = load_baseline(baseline)
    raw, _pragmas, lines_by_rel, _sources = _collect_raw(paths, rules)
    out: List[Finding] = []
    for finding in raw:
        if finding.rule in _line_disables_in(
                lines_by_rel.get(finding.path, ()), finding.line):
            continue
        if any(_baseline_match(e, finding) for e in base):
            continue
        out.append(finding)
    out.sort(key=Finding.key)
    return out


@dataclasses.dataclass
class AuditReport:
    """run_audit's result: surviving findings from BOTH passes plus the
    suppressions that excused nothing — a pragma or baseline entry that
    no longer fires has outlived the code it excused and must go."""
    findings: List[Finding]
    stale_pragmas: List[dict]       # {path, line, rule}
    stale_baseline: List[dict]      # the unmatched baseline entries

    @property
    def stale(self) -> bool:
        return bool(self.stale_pragmas or self.stale_baseline)


def run_audit(paths: Optional[Sequence[str]] = None,
              baseline: Optional[str] = None,
              deep: bool = True) -> AuditReport:
    """Lint + (optionally) the interprocedural deep pass, with the
    stale-suppression audit: every inline ``# lmr: disable=`` pragma and
    every baseline entry must still suppress at least one raw finding."""
    if paths is None:
        paths = [_PKG_ROOT]
    rules = all_rules()
    base = load_baseline(baseline)
    raw, pragmas, lines_by_rel, sources = _collect_raw(paths, rules)
    if deep:
        # lazy imports: dataflow imports this module. The deep pass
        # reuses the sources just read — one file walk, one parse set
        from lua_mapreduce_tpu_torch.analysis import dataflow, lockset
        from lua_mapreduce_tpu_torch.analysis.callgraph import CallGraph
        graph = CallGraph.from_sources(sources)
        raw = raw + dataflow.analyze(baseline=baseline, graph=graph).raw
        raw = raw + lockset.analyze_conc(baseline=baseline, graph=graph).raw
    used_pragmas = set()
    used_baseline = set()
    out: List[Finding] = []
    for f in raw:
        dis = _line_disables_in(lines_by_rel.get(f.path, ()), f.line)
        if f.rule in dis:
            used_pragmas.add((f.path, f.line, f.rule))
            continue
        matched = [i for i, e in enumerate(base) if _baseline_match(e, f)]
        if matched:
            used_baseline.update(matched)
            continue
        out.append(f)
    out.sort(key=Finding.key)
    stale_pragmas = [p for p in pragmas
                     if (p["path"], p["line"], p["rule"])
                     not in used_pragmas]
    stale_baseline = [e for i, e in enumerate(base)
                      if i not in used_baseline]
    return AuditReport(out, stale_pragmas, stale_baseline)


def format_text(findings: Sequence[Finding]) -> str:
    return "\n".join(f"{f.path}:{f.line}:{f.col}: {f.rule} "
                     f"[{f.severity}] {f.message}" for f in findings)


def report_dict(findings: Sequence[Finding]) -> dict:
    """The one report shape every consumer uses (CLI JSON included)."""
    return {"findings": [f.to_json() for f in findings],
            "count": len(findings)}


def format_json(findings: Sequence[Finding]) -> str:
    return json.dumps(report_dict(findings), indent=2)


def rule_catalog() -> List[Dict[str, str]]:
    """Every rule id the analyzer can emit: the per-function registry,
    the interprocedural (deep) rules, the task-contract rules, and the
    concurrency (conc) band — one catalog, id order (DESIGN §25)."""
    from lua_mapreduce_tpu_torch.analysis import contracts, dataflow, lockset
    out = [{"id": r.id, "severity": r.severity, "title": r.title,
            "rationale": r.rationale,
            "paths": list(r.paths) or ["<all>"]} for r in all_rules()]
    out.extend(dataflow.deep_rule_catalog())
    out.extend(contracts.contract_rule_catalog())
    out.extend(lockset.conc_rule_catalog())
    out.sort(key=lambda r: r["id"])
    return out


def utest() -> None:
    """Self-test: engine plumbing — suppression, baselines, ordering —
    against an in-memory fixture (rule behavior itself is fixture-tested
    per rule in tests/test_analysis.py)."""
    import tempfile

    src = ("import time\n"
           "try:\n"
           "    pass\n"
           "except BaseException:\n"
           "    pass\n"
           "try:\n"
           "    pass\n"
           "except BaseException:  # lmr: disable=LMR005\n"
           "    pass\n")
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "fx.py")
        with open(p, "w") as f:
            f.write(src)
        got = run_lint([p], baseline="/nonexistent")
        assert [f.rule for f in got] == ["LMR005"], got
        assert got[0].line == 4
        # file-wide baseline entry silences it; empty reason is rejected
        bl = os.path.join(d, "b.json")
        with open(bl, "w") as f:
            json.dump([{"rule": "LMR005", "path": "fx.py",
                        "reason": "utest"}], f)
        assert run_lint([p], baseline=bl) == []
        with open(bl, "w") as f:
            json.dump([{"rule": "LMR005", "path": "fx.py"}], f)
        try:
            run_lint([p], baseline=bl)
        except ValueError:
            pass
        else:
            raise AssertionError("reason-less baseline entry must fail")
    ids = [r.id for r in all_rules()]
    assert len(ids) == len(set(ids)) and ids == sorted(ids)
