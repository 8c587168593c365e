"""Interprocedural context propagation + the LMR013+ deep rules.

Copy of the JAX package's ``analysis/dataflow.py``; LMR017 follows
LMR007 to this package's graph captures.

The per-function rules (analysis/rules.py) each guard one region kind —
the index flock, a retry-boundary op body, a captured function — but stop
at the first call: a helper one frame deep evades every one of them.
This pass closes that hole.  It seeds *execution contexts* at the same
syntactic regions the per-function rules recognize, then propagates
them over the whole-program call graph (analysis/callgraph.py):

====================  =====================================================
context               seeded at
====================  =====================================================
holds-flock           call sites inside an ``_open_locked`` index region
                      (coord/ — the flock discipline, LMR002's region)
inside-retry-boundary bodies of retry-boundary ops (store//coord//faults/,
                      LMR008's method set) and functions handed to a
                      ``RetryPolicy.call`` frame
under-graph-capture   functions a CUDA-graph capture or an fx trace runs
                      once, and ``torch.cuda.graph`` blocks, in engine//
                      graphs.py/models//parallel//train/ (LMR007's
                      detection)
replay-deterministic  every function in trace/ (LMR010's scope) and call
                      sites inside coord/ locked regions (LMR004's scope)
====================  =====================================================

The context lattice is flat — a function either runs under a context or
does not; propagation is a BFS per context with the first (shortest)
call chain kept for the diagnostic.  Which edge kinds propagate is per
context: the storage-plane ``interface`` fan-out follows only the
retry-boundary context (a retried op really may dispatch to any
implementation); the deterministic contexts follow static edges only.

Each deep rule then checks the *reached* functions and reports with the
full chain.  Violations a per-function rule already catches at depth 0
are left to that rule (one finding per defect, stable anchors); the
deep ids fire on what the per-function pass provably misses:

- **LMR013** — foreign IO / blocking store ops / user callbacks
  reachable while the index flock is held (interprocedural LMR002; the
  store data-plane call check also fires at depth 0 — LMR002 has no
  net for it).
- **LMR014** — unclassified raisables reachable across the retry
  boundary (interprocedural LMR008, now also covering helpers outside
  store//coord/).
- **LMR015** — wall-clock / RNG reachable inside a replay-deterministic
  region (interprocedural LMR004 + LMR010).
- **LMR016** — non-replayable RPCs (insert_jobs / pt_cas / claim_batch)
  reachable from inside a RetryPolicy-wrapped frame: a retried frame
  that can re-run one of these double-inserts or strands a lease
  (DESIGN §19's excluded-ops table, now enforced).
- **LMR017** — host side effects reachable under a graph capture
  (interprocedural LMR007).

Suppression is the lint engine's: inline ``# lmr: disable=`` on the
offending line, or a justified baseline entry.
"""

from __future__ import annotations

import ast
import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from lua_mapreduce_tpu_torch.analysis import rules as _r
from lua_mapreduce_tpu_torch.analysis.callgraph import (CallGraph, Edge,
                                                  FunctionInfo,
                                                  build_callgraph)
from lua_mapreduce_tpu_torch.analysis.lint import (Finding, _baseline_match,
                                             _line_disables_in,
                                             load_baseline)

# -- contexts ----------------------------------------------------------------

HOLDS_FLOCK = "holds-flock"
RETRY_BOUNDARY = "inside-retry-boundary"
# the retried refinement of the boundary: only frames the retry layer
# actually REPLAYS on a transient fault (the boundary minus the
# deliberately unretried ops) — LMR016's scope. claim/claim_batch ARE
# boundary ops (their raises must classify) but are never replayed, so
# their own claim_batch call is not a replay hazard.
RETRIED_FRAME = "inside-retried-frame"
CAPTURE = "under-graph-capture"
REPLAY_DET = "replay-deterministic"

# which call-edge kinds each context follows (the lattice's propagation
# policy — see module docstring)
_FOLLOW = {
    HOLDS_FLOCK: {"direct", "method", "ctor"},
    RETRY_BOUNDARY: {"direct", "method", "ctor", "interface"},
    RETRIED_FRAME: {"direct", "method", "ctor", "interface"},
    CAPTURE: {"direct", "method", "ctor"},
    REPLAY_DET: {"direct", "method", "ctor"},
}

_MAX_DEPTH = 12           # cycles are cut by the visited set; this only
                          # bounds pathological chains in the report

# store data-plane methods whose *call* under the flock is itself the
# violation (blocking IO through the storage interface — LMR002 has no
# net for these, so LMR013 fires at any depth including 0)
_DATA_PLANE_CALLS = {"lines", "builder", "read_range", "list", "exists",
                     "remove", "size", "write_bytes", "build"}

# the non-replayable RPC set (DESIGN §19): a retried frame reaching one
# of these can double-insert / double-claim on a landed first attempt
_NON_REPLAYABLE = {"insert_jobs", "pt_cas", "claim_batch"}

# retried frames: the boundary set MINUS the deliberately unretried ops
# (faults/wrappers.py: _RETRIED_RPCS = RPC_OPS - {claim_batch,
# claim_spec}, and insert_jobs/pt_cas/claim forward unretried). The
# errors-stream pair (insert_error/drain_errors) IS retried — its
# at-least-once contract makes replay acceptable for telemetry, but a
# helper chain from it into a non-replayable RPC is still LMR016.
_RETRIED_FRAME_METHODS = _r._RETRY_BOUNDARY_METHODS - {
    "claim", "claim_batch", "insert_jobs"}

_CLOCK_CALLS = {"time", "monotonic", "perf_counter", "time_ns",
                "monotonic_ns", "perf_counter_ns"}
_RNG_ROOTS = {("random",), ("np", "random"), ("numpy", "random")}


# -- deep-rule registry (metadata mirrors lint.Rule for the catalog) ---------

@dataclasses.dataclass(frozen=True)
class DeepRule:
    id: str
    severity: str
    title: str
    rationale: str
    paths: Tuple[str, ...]    # where the CONTEXT seeds live (findings
                              # may anchor anywhere a chain reaches)


DEEP_RULES: Tuple[DeepRule, ...] = (
    DeepRule(
        "LMR013", "error",
        "no IO or user callbacks reachable while the flock is held",
        "The index flock serializes every claim/commit in the cluster; "
        "LMR002 polices the locked region itself, but a helper called "
        "from it runs under the same flock one frame deep. Any call "
        "chain from an _open_locked region into foreign IO (open/json/"
        "tempfile/os.*), a blocking store data-plane op (lines/build/"
        "read_range...), time.sleep, or a user callback multiplies the "
        "hottest critical section by an unbounded cost.",
        ("coord/",)),
    DeepRule(
        "LMR014", "error",
        "no unclassified raisables reachable across the retry boundary",
        "Every store op and coord RPC runs under the transient-fault "
        "retry layer; LMR008 checks the op bodies, but a helper they "
        "call — in core/, utils/, anywhere — that raises a generic "
        "RuntimeError/OSError sends an unclassifiable exception across "
        "the same boundary. The retry layer then guesses: wasted "
        "backoff on a deterministic failure, or a spurious job release "
        "on a transient one.",
        ("store/", "coord/", "faults/")),
    DeepRule(
        "LMR015", "error",
        "no wall-clock/RNG reachable inside replay-deterministic regions",
        "Trace timestamps and lease math must be decided by the "
        "injectable clock (LMR010) or hoisted above the lock (LMR004); "
        "a helper called from those regions that reads time.time() or "
        "draws from an unseeded RNG splits the timeline into two time "
        "bases one frame deep, where the per-function rules cannot see "
        "it — and replay/chaos byte-identity quietly stops meaning "
        "anything.",
        ("trace/", "coord/")),
    DeepRule(
        "LMR016", "error",
        "no non-replayable RPCs reachable from a RetryPolicy-wrapped frame",
        "insert_jobs, pt_cas and claim_batch are excluded from the "
        "retried-op set by design (DESIGN §19): a retry whose first "
        "attempt landed double-inserts a namespace, double-applies a "
        "task-doc CAS, or strands a claimed lease nobody executes. A "
        "call chain from inside any retried frame into one of them "
        "re-opens exactly that hole.",
        ("store/", "coord/", "faults/")),
    DeepRule(
        "LMR017", "error",
        "no host side effects reachable under a graph capture",
        "A captured function's Python body runs once, when the graph "
        "is recorded — and so does every helper it calls. LMR007 "
        "checks the captured function itself; a helper one frame deep "
        "with np.random/time.time()/print bakes capture-time values "
        "into every replay just as silently. Draw from an explicit "
        "torch.Generator and pass host values in as arguments.",
        _r.CapturePurityRule.paths),
)


# -- seeding -----------------------------------------------------------------

@dataclasses.dataclass
class _Seed:
    context: str
    fid: str
    # restrict propagation to edges at these lines (region seeds); None
    # seeds the whole function body
    lines: Optional[Set[int]]
    # where the context was established, for the chain diagnostic
    origin: str
    # run the depth-0 checks on the seed function itself: set for seeds
    # NO per-function rule anchors (a function handed to
    # RetryPolicy.call is the retried frame, but it is not a boundary
    # method LMR008 would have checked)
    depth0: bool = False


def _region_call_lines(stmts: Sequence[ast.AST]) -> Set[int]:
    return {c.lineno for c in _r._calls(stmts)}


def _collect_seeds(g: CallGraph) -> List[_Seed]:
    seeds: List[_Seed] = []
    # capture blocks seed last: a def a block calls is a captured def
    # itself, and its whole-function seed must reach it first, at depth
    # 0, where LMR007 anchors
    blocks: List[_Seed] = []
    # LMR007's detection: id()s of the defs a capture runs, per module
    captured = {rel: {id(fn) for fn in _r.captured_defs(m.tree)}
                for rel, m in g.modules.items()
                if rel.startswith(_r.CapturePurityRule.paths)}
    for fid, fi in sorted(g.functions.items()):
        rel = fi.rel
        body = fi.node.body
        if rel.startswith("coord/"):
            for kind, _node, stmts in _r._locked_regions(body):
                lines = _region_call_lines(stmts)
                if not lines:
                    continue
                if kind == "index":
                    seeds.append(_Seed(HOLDS_FLOCK, fid, lines,
                                       f"{rel}:{fi.qual}"))
                # every locked coordination region is replay-
                # deterministic: lease math must not move with the clock
                seeds.append(_Seed(REPLAY_DET, fid, lines,
                                   f"{rel}:{fi.qual}"))
        if rel.startswith("trace/") and rel != "trace/__main__.py" \
                and fi.qual != "<module>" and "utest" not in fi.qual:
            # the trace CLI (__main__) is the offline PRESENTATION
            # layer: it wires real stores (whose retry jitter draws a
            # wall-seeded RNG) to READ spans — it never stamps one.
            # utest() drives the subsystem from OUTSIDE the
            # deterministic region (it builds stores, jobs, policies on
            # the real clock) — not a replay-deterministic frame
            seeds.append(_Seed(REPLAY_DET, fid, None, f"{rel}:{fi.qual}"))
        if rel.startswith(("store/", "coord/", "faults/")) \
                and fi.cls is not None:
            if fi.name in _r._RETRY_BOUNDARY_METHODS:
                seeds.append(_Seed(RETRY_BOUNDARY, fid, None,
                                   f"{rel}:{fi.qual}"))
            if fi.name in _RETRIED_FRAME_METHODS:
                seeds.append(_Seed(RETRIED_FRAME, fid, None,
                                   f"{rel}:{fi.qual}"))
        if rel.startswith(_r.CapturePurityRule.paths):
            if fi.qual != "<module>" and id(fi.node) in captured[rel]:
                seeds.append(_Seed(CAPTURE, fid, None,
                                   f"{rel}:{fi.qual}"))
            for block in _r.capture_blocks(body):
                lines = _region_call_lines(block.body)
                if lines:
                    blocks.append(_Seed(CAPTURE, fid, lines,
                                        f"{rel}:{fi.qual}"))
    seeds.extend(_policy_call_seeds(g))
    return seeds + blocks


def _policy_call_seeds(g: CallGraph) -> Iterable[_Seed]:
    """Functions handed to a RetryPolicy frame: ``<policyish>.call(fn)``
    with fn a local/nested function name, or a lambda (whose calls are
    attributed to the enclosing function — seed those lines)."""
    for fid, fi in sorted(g.functions.items()):
        if fi.qual == "<module>":
            continue          # every def re-walks below; module-level
                              # RetryPolicy frames don't exist
        for n in ast.walk(fi.node):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "call" and n.args):
                continue
            recv = _r._chain(n.func.value)
            if not recv or not any("policy" in part.lower()
                                   for part in recv):
                continue
            arg = n.args[0]
            if isinstance(arg, ast.Lambda):
                lines = {c.lineno for c in ast.walk(arg)
                         if isinstance(c, ast.Call)}
                if lines:
                    for ctx in (RETRY_BOUNDARY, RETRIED_FRAME):
                        yield _Seed(ctx, fid, lines,
                                    f"{fi.rel}:{fi.qual}")
            elif isinstance(arg, ast.Name):
                target = _resolve_local_name(g, fi, arg.id)
                if target is not None:
                    for ctx in (RETRY_BOUNDARY, RETRIED_FRAME):
                        # depth0: the handed function IS the retried
                        # frame, and it is not a boundary method LMR008
                        # would have checked — its own raises count
                        yield _Seed(ctx, target, None,
                                    f"{fi.rel}:{fi.qual}", depth0=True)


def _resolve_local_name(g: CallGraph, fi: FunctionInfo,
                        name: str) -> Optional[str]:
    nested = f"{fi.rel}::{fi.qual}.{name}"
    if nested in g.functions:
        return nested
    mod = g.modules.get(fi.rel)
    if mod and name in mod.functions:
        return mod.functions[name]
    return None


# -- propagation -------------------------------------------------------------

@dataclasses.dataclass
class Reached:
    fid: str
    context: str
    depth: int
    chain: Tuple[Tuple[str, int], ...]   # ((fid, call line), ...) hops
    origin: str
    # region seeds: only these lines of the function run under the
    # context (the locked region / the RetryPolicy.call lambda) — the
    # depth-0 checks scope to them; None = the whole body
    lines: Optional[Set[int]] = None
    # depth-0 checks apply to this function itself (see _Seed.depth0)
    depth0: bool = False


def propagate(g: CallGraph,
              seeds: Optional[List[_Seed]] = None) -> List[Reached]:
    """BFS each context over the graph; first (shortest) chain wins.
    Line-restricted (region) seeds contribute a depth-0 entry scoped to
    the region's own lines plus propagation through its call sites."""
    if seeds is None:
        seeds = _collect_seeds(g)
    reached: Dict[Tuple[str, str], Reached] = {}
    entries: List[Reached] = []          # line-scoped depth-0 regions
    frontier: List[Reached] = []
    for s in seeds:
        key = (s.context, s.fid)
        r = Reached(s.fid, s.context, 0, (), s.origin, s.lines, s.depth0)
        if s.lines is None:
            if key not in reached:
                reached[key] = r
                frontier.append(r)
            elif s.depth0 and not reached[key].depth0 \
                    and reached[key].depth == 0:
                reached[key].depth0 = True
        else:
            entries.append(r)
        follow = _FOLLOW[s.context]
        for e in g.callees(s.fid):
            if s.lines is not None and e.line not in s.lines:
                continue
            if e.kind not in follow:
                continue
            for callee in _expand(g, e):
                ckey = (s.context, callee)
                if ckey in reached:
                    continue
                nr = Reached(callee, s.context, 1,
                             ((s.fid, e.line),), s.origin)
                reached[ckey] = nr
                frontier.append(nr)
    i = 0
    while i < len(frontier):
        cur = frontier[i]
        i += 1
        if cur.depth >= _MAX_DEPTH:
            continue
        follow = _FOLLOW[cur.context]
        for e in g.callees(cur.fid):
            if e.kind not in follow:
                continue
            for callee in _expand(g, e):
                key = (cur.context, callee)
                if key in reached:
                    continue
                nr = Reached(callee, cur.context, cur.depth + 1,
                             cur.chain + ((cur.fid, e.line),), cur.origin)
                reached[key] = nr
                frontier.append(nr)
    return list(reached.values()) + entries


def _expand(g: CallGraph, e: Edge) -> Iterable[str]:
    if e.kind == "interface":
        meth = e.callee[len("<iface:"):-1]
        return g.iface_targets(meth)
    if e.callee.startswith("<"):
        return ()
    return (e.callee,) if e.callee in g.functions else ()


# -- violation checks --------------------------------------------------------

def _fmt_chain(g: CallGraph, r: Reached) -> str:
    hops = []
    for fid, line in r.chain[-4:]:
        fi = g.functions.get(fid)
        hops.append(f"{fi.qual if fi else fid}:{line}")
    via = " -> ".join(hops)
    return f"reached from {r.origin}" + (f" via {via}" if via else "")


def _finding(g: CallGraph, rule: str, fi: FunctionInfo, node: ast.AST,
             r: Reached, what: str) -> Finding:
    return Finding(rule, "error", fi.rel, getattr(node, "lineno", fi.lineno),
                   getattr(node, "col_offset", 0),
                   f"{what} in {fi.qual}() runs under {r.context} — "
                   f"{_fmt_chain(g, r)}")


def _own_call_nodes(fi: FunctionInfo,
                    r: Optional[Reached] = None) -> Iterable[ast.Call]:
    """The function's own calls (lambdas included — the call graph
    attributes them to the enclosing frame — nested defs not), scoped
    to the region lines when ``r`` carries a restriction."""
    stack = list(fi.node.body)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        if isinstance(n, ast.Call) and not (
                r is not None and r.lines is not None
                and n.lineno not in r.lines):
            yield n
        stack.extend(ast.iter_child_nodes(n))


def _check_flock(g: CallGraph, fi: FunctionInfo,
                 r: Reached) -> Iterable[Finding]:
    for call in _own_call_nodes(fi, r):
        c = _r._chain(call.func)
        if not c:
            continue
        if r.depth >= 1:
            if c[0] in ("open", "print", "input") and len(c) == 1:
                yield _finding(g, "LMR013", fi, call, r,
                               f"{c[0]}()")
                continue
            if c[0] in _r._IDX_DENY_ROOTS:
                yield _finding(g, "LMR013", fi, call, r,
                               f"{'.'.join(c)}")
                continue
            if (c[0] == "os" and len(c) > 1
                    and c[1] not in _r._IDX_OS_ALLOWED and c[1] != "path"):
                yield _finding(g, "LMR013", fi, call, r, f"os.{c[1]}")
                continue
            if len(c) == 1 and c[0] in fi.params:
                yield _finding(g, "LMR013", fi, call, r,
                               f"call to parameter {c[0]!r} (user "
                               "callback)")
                continue
        if c == ("time", "sleep") and r.depth >= 1:
            # depth 0 is LMR011's anchor (bare sleep in coord/)
            yield _finding(g, "LMR013", fi, call, r, "time.sleep()")
        elif (len(c) >= 2 and c[-1] in _DATA_PLANE_CALLS
                and c[0] != "os"
                and not (len(c) == 2 and c[0] == "self")):
            # store.lines(...) / self.store.lines(...): blocking
            # data-plane IO through the storage interface. Bare
            # self.lines() is the object's own method — the method
            # edge already propagates the context into it; os.* is
            # the fd-local/metadata surface LMR002 arbitrates.
            yield _finding(g, "LMR013", fi, call, r,
                           f"store data-plane call {'.'.join(c)}()")


def _check_retry_raises(g: CallGraph, fi: FunctionInfo,
                        r: Reached) -> Iterable[Finding]:
    if r.depth < 1 and not r.depth0:
        return        # boundary-method bodies are LMR008's anchor
    for n in _r._own_walk(list(fi.node.body)):
        if not isinstance(n, ast.Raise) or n.exc is None:
            continue
        exc = n.exc
        if isinstance(exc, ast.Call):
            exc = exc.func
        c = _r._chain(exc)
        if c and c[-1] in _r._UNCLASSIFIED_RAISES:
            yield _finding(g, "LMR014", fi, n, r,
                           f"raise {c[-1]}")


def _check_nonreplayable(g: CallGraph, fi: FunctionInfo,
                         r: Reached) -> Iterable[Finding]:
    for call in _own_call_nodes(fi, r):
        name = None
        if isinstance(call.func, ast.Attribute):
            name = call.func.attr
        elif isinstance(call.func, ast.Name):
            name = call.func.id
        if name in _NON_REPLAYABLE:
            yield _finding(g, "LMR016", fi, call, r,
                           f"non-replayable RPC {name}()")


def _check_replay(g: CallGraph, fi: FunctionInfo,
                  r: Reached) -> Iterable[Finding]:
    if r.depth < 1 or fi.rel.startswith("trace/"):
        return        # depth 0 / trace-resident reads are LMR004/LMR010
    for call in _own_call_nodes(fi):
        c = _r._chain(call.func)
        if not c:
            continue
        if len(c) == 2 and c[0] == "time" and c[1] in _CLOCK_CALLS:
            yield _finding(g, "LMR015", fi, call, r,
                           f"time.{c[1]}()")
        elif any(c[:len(root)] == root for root in _RNG_ROOTS) \
                and len(c) > 1:
            yield _finding(g, "LMR015", fi, call, r,
                           f"{'.'.join(c)}")


def _check_capture(g: CallGraph, fi: FunctionInfo,
                   r: Reached) -> Iterable[Finding]:
    if r.depth < 1:
        return                          # depth 0 is LMR007's anchor
    for call in _own_call_nodes(fi):
        c = _r._chain(call.func)
        if not c:
            continue
        if len(c) == 1 and c[0] in ("open", "input", "print"):
            yield _finding(g, "LMR017", fi, call, r, f"{c[0]}()")
        elif any(c[:len(root)] == root for root in _r._IMPURE_ROOTS):
            yield _finding(g, "LMR017", fi, call, r, f"{'.'.join(c)}")


_CHECKS = {
    HOLDS_FLOCK: (_check_flock,),
    RETRY_BOUNDARY: (_check_retry_raises,),
    RETRIED_FRAME: (_check_nonreplayable,),
    REPLAY_DET: (_check_replay,),
    CAPTURE: (_check_capture,),
}


# -- entry points --------------------------------------------------------

@dataclasses.dataclass
class DeepResult:
    findings: List[Finding]          # post-suppression
    raw: List[Finding]               # pre-suppression (audit input)
    graph: CallGraph
    reached: int
    wall_s: float


def analyze(paths: Optional[Sequence[str]] = None,
            baseline: Optional[str] = None,
            graph: Optional[CallGraph] = None) -> DeepResult:
    """The full deep pass: graph, contexts, rules, suppression."""
    t0 = time.perf_counter()
    if graph is None:
        graph = build_callgraph(paths)
    reached = propagate(graph)
    raw: List[Finding] = []
    for r in reached:
        fi = graph.functions.get(r.fid)
        if fi is None or fi.qual == "<module>":
            continue
        for check in _CHECKS[r.context]:
            raw.extend(check(graph, fi, r))
    # one finding per (path, line, rule): overlapping chains into the
    # same defect collapse to the shortest-chain report
    best: Dict[tuple, Finding] = {}
    for f in raw:
        best.setdefault(f.key(), f)
    raw = sorted(best.values(), key=Finding.key)
    base = load_baseline(baseline)
    out = []
    for f in raw:
        if f.rule in _line_disables(graph, f.path, f.line):
            continue
        if any(_baseline_match(e, f) for e in base):
            continue
        out.append(f)
    return DeepResult(out, raw, graph, len(reached),
                      time.perf_counter() - t0)


def _line_disables(g: CallGraph, rel: str, lineno: int) -> Set[str]:
    m = g.modules.get(rel)
    if m is None:
        return set()
    return _line_disables_in(m.lines, lineno)


def run_deep(paths: Optional[Sequence[str]] = None,
             baseline: Optional[str] = None) -> List[Finding]:
    """Deep findings surviving suppression — the CLI/gate entry point."""
    return analyze(paths, baseline).findings


def deep_rule_catalog() -> List[Dict[str, str]]:
    return [{"id": d.id, "severity": d.severity, "title": d.title,
             "rationale": d.rationale, "paths": list(d.paths)}
            for d in DEEP_RULES]


def utest() -> None:
    """Self-test: each deep rule re-finds a seeded helper-indirection
    violation its per-function sibling provably misses, clean twins
    pass, and the real package analyzes clean."""
    from lua_mapreduce_tpu_torch.analysis.lint import run_lint

    flock_fix = ("coord/fx.py", (
        "import json, os, time\n"
        "class Idx:\n"
        "    def claim(self):\n"
        "        fd = self._open_locked()\n"
        "        try:\n"
        "            return self._load_doc(fd)\n"
        "        finally:\n"
        "            os.close(fd)\n"
        "    def _load_doc(self, fd):\n"
        "        doc = json.load(open('sidecar'))\n"
        "        time.sleep(0.1)\n"
        "        return doc\n"
    ))
    g = CallGraph.from_sources([flock_fix])
    res = analyze(graph=g, baseline="/nonexistent")
    rules_hit = sorted({f.rule for f in res.findings})
    assert "LMR013" in rules_hit, res.findings
    assert all(f.line in (10, 11) for f in res.findings
               if f.rule == "LMR013")

    retry_fix = ("store/fx.py", (
        "class MyStore:\n"
        "    def read_range(self, name, offset, length):\n"
        "        return self._fetch(name)\n"
        "    def _fetch(self, name):\n"
        "        raise RuntimeError('backend hiccup')\n"
        "    def build(self, name):\n"
        "        self._publish(name)\n"
        "    def _publish(self, name):\n"
        "        self.js.insert_jobs('ns', [])\n"
    ))
    g = CallGraph.from_sources([retry_fix])
    got = {f.rule for f in analyze(graph=g,
                                   baseline="/nonexistent").findings}
    assert {"LMR014", "LMR016"} <= got, got

    replay_fix = ("coord/cx.py", (
        "import time\n"
        "class S:\n"
        "    def stamp(self):\n"
        "        with self._lock:\n"
        "            self.t = self._now()\n"
        "    def _now(self):\n"
        "        return time.time()\n"
    ))
    g = CallGraph.from_sources([replay_fix])
    got = [f for f in analyze(graph=g, baseline="/nonexistent").findings]
    assert [f.rule for f in got] == ["LMR015"] and got[0].line == 7, got

    capture_fix = ("models/ox.py", (
        "import numpy as np\n"
        "from lua_mapreduce_tpu_torch import graphs\n"
        "def step(state, x):\n"
        "    return state + x * _noise(3), state\n"
        "def run(state, x):\n"
        "    return graphs.scan(step, state, 8, x)\n"
        "def _noise(n):\n"
        "    return np.random.randn(n)\n"
    ))
    g = CallGraph.from_sources([capture_fix])
    got = [f for f in analyze(graph=g, baseline="/nonexistent").findings]
    assert [f.rule for f in got] == ["LMR017"] and got[0].line == 8, got

    # the acceptance pair: the per-function pass misses ALL of these
    for rel, src in (flock_fix, retry_fix, replay_fix, capture_fix):
        import tempfile, os as _os
        with tempfile.TemporaryDirectory() as d:
            sub = _os.path.join(d, _os.path.dirname(rel))
            _os.makedirs(sub, exist_ok=True)
            p = _os.path.join(d, rel)
            with open(p, "w") as fh:
                fh.write(src)
            per_fn = run_lint([d], baseline="/nonexistent")
            assert [f for f in per_fn
                    if f.rule in ("LMR002", "LMR004", "LMR007",
                                  "LMR008")] == [], (rel, per_fn)

    # clean twins: hoisted clock, classified raise, pure helper
    g = CallGraph.from_sources([
        ("coord/clean.py", (
            "import time\n"
            "class S:\n"
            "    def stamp(self):\n"
            "        now = self._now()\n"
            "        with self._lock:\n"
            "            self.t = now\n"
            "    def _now(self):\n"
            "        return time.time()\n"
        )),
        ("store/clean.py", (
            "class S:\n"
            "    def read_range(self, name, offset, length):\n"
            "        return self._fetch(name)\n"
            "    def _fetch(self, name):\n"
            "        raise TransientStoreError('blip')\n"
        )),
    ])
    assert analyze(graph=g, baseline="/nonexistent").findings == []

    # inline suppression holds for deep findings too
    g = CallGraph.from_sources([(
        "coord/sup.py",
        replay_fix[1].replace("cx", "sup").replace(
            "return time.time()",
            "return time.time()  # lmr: disable=LMR015"),
    )])
    assert analyze(graph=g, baseline="/nonexistent").findings == []
