"""Static task-contract checker + lowerability oracle.

Trimmed copy of the JAX package's ``analysis/contracts.py``: it reads a
USER task module statically, from the AST — no import executed (a task
module with a side-effecting import must not fire during validation).
Kept are the layers :func:`check_task` needs:

1. **Contract** (LMR020-022): required functions present, plugin arities
   right (``taskfn(emit)``, ``mapfn(key, value, emit)``,
   ``partitionfn(key)``, ``reducefn(key, values)``), and every
   ``emit(...)`` inside taskfn/mapfn passing exactly (key, value).
2. **Determinism** (LMR023-025): wall-clock reads, unseeded RNG draws,
   salted ``hash()`` in a partitionfn and unordered iteration.
3. **Lowerability** — the three-way verdict per function that the
   compiled engines (``engine/ingraph.py``, ``engine/hybrid.py``) read at
   task-load time: ``in-graph`` (a pure array/numeric program),
   ``store-plane`` (valid, deterministic, host-bound) or ``invalid``.
   The TASK verdict folds the data-plane functions only (mapfn,
   partitionfn, reducefn, combinerfn).

The one change from the JAX module: this oracle reads torch-surface
code. The array roots are ``torch``, ``np``/``numpy`` and ``math`` (a
``jnp`` call is an unknown root here, as ``pandas`` is there), plus the
names a module binds to the port's own kernel library by an import
(``from lua_mapreduce_tpu_torch import ops``): its ops are tensor
programs that a captured graph runs like any torch op. ``torch``'s
global-generator draws count as unseeded RNG (LMR023).

Module forms accepted (the same forms TaskSpec loads): a single module
defining several functions, or a package directory with one module per
function.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import sys
from typing import Dict, List, Optional, Set, Tuple

from lua_mapreduce_tpu_torch.analysis.lint import Finding
from lua_mapreduce_tpu_torch.analysis.rules import _chain
from lua_mapreduce_tpu_torch.engine.contract import _REQUIRED, FN_NAMES

# expected positional arity per plugin (engine/contract.py's surface)
_ARITY = {"taskfn": 1, "mapfn": 3, "partitionfn": 1, "reducefn": 2,
          "combinerfn": 2, "finalfn": 1}

# which functions must be deterministic (re-executed by speculation /
# chaos / replica recovery) — taskfn too: job enumeration re-runs on
# server restart; finalfn runs once on the server, exempt
_DETERMINISTIC_FNS = ("taskfn", "mapfn", "partitionfn", "reducefn",
                      "combinerfn")

VERDICT_INGRAPH = "in-graph"
VERDICT_STORE = "store-plane"
VERDICT_INVALID = "invalid"

_NUMERIC_BUILTINS = {"int", "float", "bool", "abs", "min", "max", "len",
                     "sum", "round", "pow", "divmod", "range",
                     "enumerate"}
_ARRAY_ROOTS = {"torch", "np", "numpy", "math"}
# the port's kernel library: a module-level import binding it (or one of
# its functions) makes that name an array root (or an array call)
_OPS_MODULE = "lua_mapreduce_tpu_torch.ops"

_RNG_DRAWS = {"random", "randint", "randrange", "choice", "choices",
              "shuffle", "sample", "uniform", "gauss", "getrandbits",
              "normal", "randn", "rand", "permutation"}


@dataclasses.dataclass(frozen=True)
class ContractRule:
    id: str
    severity: str
    title: str
    rationale: str


CONTRACT_RULES: Tuple[ContractRule, ...] = (
    ContractRule(
        "LMR020", "error", "required plugin function missing",
        "TaskSpec requires callable taskfn/mapfn/partitionfn/reducefn "
        "(engine/contract.py, reference server.lua:429-445); a missing "
        "one fails at configure time on the SERVER — this catches it "
        "before any fleet is provisioned."),
    ContractRule(
        "LMR021", "error", "plugin signature arity mismatch",
        "The engine calls taskfn(emit), mapfn(key, value, emit), "
        "partitionfn(key), reducefn(key, values), combinerfn(key, "
        "values), finalfn(pairs) positionally; a wrong arity raises "
        "TypeError inside a claimed job body, charging repetitions "
        "until the job marches to FAILED."),
    ContractRule(
        "LMR022", "error", "emit() must pass exactly (key, value)",
        "The emit callback serializes one (key, value) pair per call; "
        "any other arity raises inside the job body at runtime — and "
        "under speculation the clone fails identically, so the job "
        "burns its whole repetition budget."),
    ContractRule(
        "LMR023", "error", "determinism hazard: wall-clock / unseeded RNG",
        "Speculation's first-commit-wins keeps EITHER of two racing "
        "executions, chaos legs byte-compare re-runs, and replica "
        "recovery re-executes producers: user functions must be "
        "deterministic. time.time()/datetime.now()/unseeded RNG/"
        "os.urandom/uuid4 make two executions of the same job "
        "diverge silently."),
    ContractRule(
        "LMR024", "error", "determinism hazard: unordered iteration",
        "Iterating a set (per-process hash salt) or an unsorted "
        "os.listdir()/glob.glob() emits records in a "
        "process-dependent order — two executions of the same job "
        "publish different bytes, breaking replay/speculation "
        "byte-identity. Sort before iterating."),
    ContractRule(
        "LMR025", "error", "partition math must not use builtin hash()",
        "str hashing is salted PER PROCESS (PYTHONHASHSEED): two "
        "workers disagree on every key's partition, scattering one "
        "key's values across reducers. Use a stable hash (zlib.crc32, "
        "FNV, blake2b) — benchmarks/coord_task.py documents exactly "
        "this trap."),
)


@dataclasses.dataclass
class FunctionReport:
    name: str                  # plugin slot: "mapfn", ...
    rel: str                   # file the def lives in
    lineno: int
    verdict: str
    findings: List[Finding]
    reasons: List[str]         # why not in-graph (empty when eligible)


@dataclasses.dataclass
class TaskReport:
    spec: str
    verdict: str
    functions: Dict[str, FunctionReport]
    findings: List[Finding]    # module-level findings + per-function


# -- module resolution (static: never imports) -------------------------------

class _TaskSources:
    """The parsed source set of one task module spec: {fname: (rel,
    tree, def-node or None)} plus per-file module context for helper
    resolution."""

    def __init__(self):
        self.files: Dict[str, Tuple[str, ast.Module]] = {}  # rel->(src,tree)
        self.slots: Dict[str, Tuple[str, Optional[ast.AST]]] = {}

    def add_file(self, rel: str, source: str) -> Optional[ast.Module]:
        try:
            tree = ast.parse(source, filename=rel)
        except (SyntaxError, ValueError):
            return None
        self.files[rel] = (source, tree)
        return tree


def _module_defs(tree: ast.Module) -> Dict[str, ast.AST]:
    """Module-level name -> def node (or alias target's def): handles
    ``def reducefn(...)`` and ``combinerfn = reducefn``."""
    defs: Dict[str, ast.AST] = {}
    aliases: Dict[str, str] = {}
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[n.name] = n
        elif isinstance(n, ast.Assign) and isinstance(n.value, ast.Name):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    aliases[t.id] = n.value.id
    for alias, target in aliases.items():
        if target in defs and alias not in defs:
            defs[alias] = defs[target]
    return defs


def resolve_spec(spec: str) -> Optional[str]:
    """A module spec to a filesystem path: an existing file/dir wins;
    otherwise the dotted name is searched across cwd + sys.path."""
    if os.path.exists(spec):
        return spec
    parts = spec.split(".")
    for root in [os.getcwd()] + sys.path:
        if not root or not os.path.isdir(root):
            continue
        base = os.path.join(root, *parts)
        if os.path.isfile(base + ".py"):
            return base + ".py"
        if os.path.isdir(base):
            return base
    return None


def _load_sources(spec: str) -> Tuple[Optional[_TaskSources], Optional[str]]:
    path = resolve_spec(spec)
    if path is None:
        return None, f"module {spec!r} not found (as a path or on sys.path)"
    src = _TaskSources()
    if os.path.isfile(path):
        rel = os.path.basename(path)
        try:
            with open(path, encoding="utf-8") as f:
                tree = src.add_file(rel, f.read())
        except OSError as e:
            return None, f"cannot read {path}: {e}"
        if tree is None:
            return None, f"{path} does not parse"
        defs = _module_defs(tree)
        for fname in FN_NAMES:
            if fname in defs:
                src.slots[fname] = (rel, defs[fname])
        return src, None
    # package directory: __init__.py first, then one-module-per-function
    init = os.path.join(path, "__init__.py")
    if os.path.isfile(init):
        with open(init, encoding="utf-8") as f:
            tree = src.add_file("__init__.py", f.read())
        if tree is not None:
            defs = _module_defs(tree)
            for fname in FN_NAMES:
                if fname in defs:
                    src.slots[fname] = ("__init__.py", defs[fname])
    for fname in FN_NAMES:
        if fname in src.slots:
            continue
        sub = os.path.join(path, fname + ".py")
        if not os.path.isfile(sub):
            continue
        with open(sub, encoding="utf-8") as f:
            tree = src.add_file(fname + ".py", f.read())
        if tree is None:
            continue
        defs = _module_defs(tree)
        if fname in defs:
            src.slots[fname] = (fname + ".py", defs[fname])
    return src, None


# -- per-function checks -----------------------------------------------------

def _positional_arity(fn: ast.AST) -> Tuple[int, Optional[int]]:
    """(min, max) positional arity; max None = *args."""
    a = fn.args
    pos = a.posonlyargs + a.args
    n_default = len(a.defaults)
    lo = len(pos) - n_default
    hi = None if a.vararg else len(pos)
    return lo, hi


def _check_signature(fname: str, rel: str, fn: ast.AST) -> List[Finding]:
    want = _ARITY[fname]
    lo, hi = _positional_arity(fn)
    if lo <= want and (hi is None or want <= hi):
        return []
    sig = f"{lo}" if hi == lo else f"{lo}..{hi if hi is not None else '*'}"
    return [Finding("LMR021", "error", rel, fn.lineno, fn.col_offset,
                    f"{fname} takes {sig} positional arg(s); the engine "
                    f"calls it with {want}")]


def _emit_param(fname: str, fn: ast.AST) -> Optional[str]:
    a = fn.args
    pos = [x.arg for x in a.posonlyargs + a.args]
    idx = {"taskfn": 0, "mapfn": 2}.get(fname)
    if idx is None or idx >= len(pos):
        return None
    return pos[idx]


def _check_emit(fname: str, rel: str, fn: ast.AST) -> List[Finding]:
    emit = _emit_param(fname, fn)
    if emit is None:
        return []
    out = []
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id == emit:
            if any(isinstance(a, ast.Starred) for a in n.args):
                continue                     # unknowable statically
            if len(n.args) != 2 or n.keywords:
                out.append(Finding(
                    "LMR022", "error", rel, n.lineno, n.col_offset,
                    f"{fname} calls {emit}() with {len(n.args)} arg(s) "
                    "— the engine serializes exactly (key, value)"))
    return out


def _local_helpers(tree: ast.Module) -> Dict[str, ast.AST]:
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _ops_names(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    """(module aliases, function names) the module binds to the port's
    kernel library at module level: ``from lua_mapreduce_tpu_torch
    import ops [as o]``, ``import lua_mapreduce_tpu_torch.ops as o`` and
    ``from lua_mapreduce_tpu_torch.ops import matmul [as mm]``."""
    pkg, _, leaf = _OPS_MODULE.rpartition(".")
    roots: Set[str] = set()
    calls: Set[str] = set()
    for n in tree.body:
        if isinstance(n, ast.ImportFrom) and n.level == 0:
            for a in n.names:
                if n.module == pkg and a.name == leaf:
                    roots.add(a.asname or a.name)
                elif n.module == _OPS_MODULE:
                    calls.add(a.asname or a.name)
        elif isinstance(n, ast.Import):
            for a in n.names:
                if a.name == _OPS_MODULE and a.asname:
                    roots.add(a.asname)
    return roots, calls


def _reachable_helpers(fn: ast.AST, helpers: Dict[str, ast.AST]) \
        -> List[Tuple[str, ast.AST]]:
    """Module-local functions transitively called from ``fn`` — the
    closure the determinism/lowerability checks walk."""
    seen: Set[str] = set()
    order: List[Tuple[str, ast.AST]] = []
    frontier = [fn]
    while frontier:
        cur = frontier.pop()
        for n in ast.walk(cur):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name):
                name = n.func.id
                if name in helpers and name not in seen:
                    seen.add(name)
                    order.append((name, helpers[name]))
                    frontier.append(helpers[name])
    return order


def _determinism_findings(fname: str, rel: str, fn: ast.AST,
                          tree: ast.Module) -> List[Finding]:
    out: List[Finding] = []
    helpers = _local_helpers(tree)
    scopes = [(fname, fn)] + _reachable_helpers(fn, helpers)
    for sname, node in scopes:
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                c = _chain(n.func)
                if not c:
                    continue
                where = (f"{fname}()" if sname == fname
                         else f"{sname}() (called from {fname})")
                if c[0] == "time" and len(c) == 2:
                    out.append(Finding(
                        "LMR023", "error", rel, n.lineno, n.col_offset,
                        f"{'.'.join(c)}() in {where} — two executions "
                        "of the same job diverge"))
                elif c[:2] in (("datetime", "now"),) or \
                        (len(c) == 3 and c[0] == "datetime"
                         and c[2] in ("now", "today", "utcnow")):
                    out.append(Finding(
                        "LMR023", "error", rel, n.lineno, n.col_offset,
                        f"{'.'.join(c)}() in {where} — wall-clock read"))
                elif (c[0] in ("random", "torch") and len(c) == 2
                      and c[1] in _RNG_DRAWS) or \
                        (len(c) == 3 and c[0] in ("np", "numpy")
                         and c[1] == "random" and c[2] in _RNG_DRAWS):
                    out.append(Finding(
                        "LMR023", "error", rel, n.lineno, n.col_offset,
                        f"{'.'.join(c)}() in {where} — unseeded RNG "
                        "draw (seed an explicit Random(seed)/generator "
                        "derived from the job key)"))
                elif c == ("os", "urandom") or c == ("uuid", "uuid4"):
                    out.append(Finding(
                        "LMR023", "error", rel, n.lineno, n.col_offset,
                        f"{'.'.join(c)}() in {where} — entropy source"))
                elif c[-1] in ("listdir", "glob", "iglob", "scandir"):
                    if not _sorted_wrapped(n, node):
                        out.append(Finding(
                            "LMR024", "error", rel, n.lineno,
                            n.col_offset,
                            f"{'.'.join(c)}() in {where} without "
                            "sorted() — directory order is "
                            "filesystem-dependent"))
                elif c == ("hash",) and fname == "partitionfn":
                    out.append(Finding(
                        "LMR025", "error", rel, n.lineno, n.col_offset,
                        f"builtin hash() in {where} — salted per "
                        "process; workers will disagree on partitions"))
            elif isinstance(n, (ast.For, ast.comprehension)):
                it = n.iter
                if isinstance(it, ast.Set) or (
                        isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Name)
                        and it.func.id in ("set", "frozenset")):
                    where = (f"{fname}()" if sname == fname
                             else f"{sname}() (called from {fname})")
                    out.append(Finding(
                        "LMR024", "error", rel, it.lineno, it.col_offset,
                        f"iteration over a set in {where} — per-process "
                        "hash salt reorders it; sort first"))
    return out


def _sorted_wrapped(call: ast.Call, scope: ast.AST) -> bool:
    """Is this listdir/glob call the direct argument of sorted()?"""
    for n in ast.walk(scope):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id == "sorted" and call in n.args:
            return True
    return False


# -- lowerability ------------------------------------------------------------

def _ineligible_reasons(fname: str, fn: ast.AST, tree: ast.Module,
                        _memo: Optional[Dict[str, List[str]]] = None,
                        _stack: Optional[Set[str]] = None) -> List[str]:
    """Why this function is NOT liftable to the compiled plane (empty =
    in-graph eligible). Conservative whitelist walk: anything outside
    the pure-numeric surface disqualifies with a named reason."""
    helpers = _local_helpers(tree)
    ops_roots, ops_calls = _ops_names(tree)
    roots = _ARRAY_ROOTS | ops_roots
    emit = _emit_param(fname, fn)
    a = fn.args
    params = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
    reasons: List[str] = []
    _memo = _memo if _memo is not None else {}
    _stack = _stack if _stack is not None else set()

    def deny(node, why):
        if len(reasons) < 4:
            reasons.append(f"{why} (line {getattr(node, 'lineno', '?')})")

    for n in ast.walk(fn):
        if isinstance(n, (ast.With, ast.AsyncWith)):
            deny(n, "with-statement (resource IO)")
        elif isinstance(n, (ast.Try, ast.Raise)):
            deny(n, "exception control flow")
        elif isinstance(n, (ast.Global, ast.Nonlocal)):
            deny(n, "writes module state")
        elif isinstance(n, ast.While):
            deny(n, "data-dependent while-loop")
        elif isinstance(n, (ast.Yield, ast.YieldFrom, ast.Await)):
            deny(n, "generator/async")
        elif isinstance(n, ast.JoinedStr):
            deny(n, "string interpolation")
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            deny(n, "local import")
        elif isinstance(n, (ast.For, ast.comprehension)):
            it = n.iter
            ok = (isinstance(it, ast.Call)
                  and isinstance(it.func, ast.Name)
                  and it.func.id in ("range", "enumerate")) \
                or (isinstance(it, ast.Name) and it.id in params)
            if not ok:
                deny(it, "loop over a non-range, non-argument iterable")
        elif isinstance(n, ast.Call):
            c = _chain(n.func)
            if c is None:
                deny(n, "indirect call")
                continue
            if len(c) == 1:
                name = c[0]
                if name == emit or name in _NUMERIC_BUILTINS \
                        or name in ops_calls:
                    continue
                if name in helpers:
                    if name in _stack:
                        deny(n, f"recursive helper {name}()")
                        continue
                    if name not in _memo:
                        _stack.add(name)
                        _memo[name] = _ineligible_reasons(
                            name, helpers[name], tree, _memo, _stack)
                        _stack.discard(name)
                    if _memo[name]:
                        deny(n, f"helper {name}() is not in-graph "
                             f"eligible ({_memo[name][0]})")
                    continue
                if name in params:
                    deny(n, f"call to callback parameter {name!r}")
                    continue
                deny(n, f"call to {name}()")
            else:
                if c[0] in roots and "random" not in c \
                        and "debug" not in c:
                    continue
                deny(n, f"call to {'.'.join(c)}()")
    return reasons


# -- driver ------------------------------------------------------------------

def check_task(spec: str) -> TaskReport:
    src, err = _load_sources(spec)
    if src is None:
        f = Finding("LMR020", "error", spec, 0, 0, err)
        return TaskReport(spec, VERDICT_INVALID, {}, [f])
    findings: List[Finding] = []
    functions: Dict[str, FunctionReport] = {}
    for fname in FN_NAMES:
        slot = src.slots.get(fname)
        if slot is None:
            if fname in _REQUIRED:
                findings.append(Finding(
                    "LMR020", "error", spec, 0, 0,
                    f"required function {fname!r} not found in {spec} "
                    "(as a module-level def or alias)"))
            continue
        rel, node = slot
        _source, tree = src.files[rel]
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            findings.append(Finding(
                "LMR020", "error", rel, getattr(node, "lineno", 0), 0,
                f"{fname} is not a function definition"))
            functions[fname] = FunctionReport(
                fname, rel, getattr(node, "lineno", 0), VERDICT_INVALID,
                [], ["not a def"])
            continue
        fn_findings = _check_signature(fname, rel, node)
        fn_findings += _check_emit(fname, rel, node)
        invalid = bool(fn_findings)
        if fname in _DETERMINISTIC_FNS:
            fn_findings += _determinism_findings(fname, rel, node, tree)
        reasons = _ineligible_reasons(fname, node, tree)
        hazard = any(f.rule in ("LMR023", "LMR024", "LMR025")
                     for f in fn_findings)
        if invalid:
            verdict = VERDICT_INVALID
        elif not reasons and not hazard:
            verdict = VERDICT_INGRAPH
        else:
            verdict = VERDICT_STORE
            if hazard and not reasons:
                reasons = ["determinism hazard (see findings)"]
        functions[fname] = FunctionReport(fname, rel, node.lineno,
                                          verdict, fn_findings, reasons)
        findings.extend(fn_findings)

    missing = [f for f in _REQUIRED if f not in functions]
    if missing or any(functions[f].verdict == VERDICT_INVALID
                      for f in functions):
        task_verdict = VERDICT_INVALID
    else:
        data_plane = [f for f in ("mapfn", "partitionfn", "reducefn",
                                  "combinerfn") if f in functions]
        task_verdict = (VERDICT_INGRAPH
                        if all(functions[f].verdict == VERDICT_INGRAPH
                               for f in data_plane)
                        else VERDICT_STORE)
    findings.sort(key=Finding.key)
    return TaskReport(spec, task_verdict, functions, findings)


# the hybrid plane's leg membership: which functions must verdict
# in-graph for each stage of a store-plane task to compile. Mirrors
# engine/ingraph.py:hybrid_stage_legs — partitionfn is absent on purpose
# (it routes host-side on concrete keys in the shared publish tail), and
# combinerfn only gates the map leg when the task has one.
STAGE_FNS = {"map": ("mapfn", "combinerfn"), "reduce": ("reducefn",)}


def stage_report(rep: TaskReport) -> dict:
    """Per-stage lowering verdicts for the hybrid plane: for each leg,
    whether it compiles, each member function's verdict, and the rule
    ids + oracle reasons blocking it when it does not."""
    out = {}
    for stage, fns in STAGE_FNS.items():
        present = [f for f in fns if f in rep.functions]
        required_ok = fns[0] in rep.functions
        frs = [rep.functions[f] for f in present]
        compiled = required_ok and all(
            fr.verdict == VERDICT_INGRAPH for fr in frs)
        out[stage] = {
            "compiled": compiled,
            "functions": {f: rep.functions[f].verdict for f in present},
            "blocking": sorted({fi.rule for fr in frs
                                if fr.verdict != VERDICT_INGRAPH
                                for fi in fr.findings}),
            "reasons": [r for fr in frs
                        if fr.verdict != VERDICT_INGRAPH
                        for r in fr.reasons],
        }
    return out


def report_dict(rep: TaskReport) -> dict:
    return {
        "spec": rep.spec,
        "verdict": rep.verdict,
        "functions": {
            name: {"file": fr.rel, "line": fr.lineno,
                   "verdict": fr.verdict, "reasons": fr.reasons,
                   "findings": [f.to_json() for f in fr.findings]}
            for name, fr in rep.functions.items()},
        "stages": stage_report(rep),
        "findings": [f.to_json() for f in rep.findings],
        "count": len(rep.findings),
    }


def format_text(rep: TaskReport) -> str:
    lines = [f"task {rep.spec}: {rep.verdict}"]
    for name in FN_NAMES:
        fr = rep.functions.get(name)
        if fr is None:
            continue
        why = f"  ({fr.reasons[0]})" if fr.reasons else ""
        lines.append(f"  {name:<12} {fr.rel}:{fr.lineno:<5} "
                     f"{fr.verdict}{why}")
    for f in rep.findings:
        lines.append(f"  {f.path}:{f.line}:{f.col}: {f.rule} {f.message}")
    return "\n".join(lines)


def contract_rule_catalog() -> List[Dict[str, str]]:
    return [{"id": r.id, "severity": r.severity, "title": r.title,
             "rationale": r.rationale, "paths": ["<task modules>"]}
            for r in CONTRACT_RULES]


def utest() -> None:
    """Self-test: contract violations, determinism hazards, and the
    three-way verdict on in-memory fixtures plus the shipped examples."""
    import tempfile

    good = (
        "def taskfn(emit):\n"
        "    for j in range(4):\n"
        "        emit(j, j)\n"
        "def mapfn(key, value, emit):\n"
        "    emit(key % 2, value * value)\n"
        "def partitionfn(key):\n"
        "    return key % 2\n"
        "def reducefn(key, values):\n"
        "    return sum(values)\n"
    )
    bad = (
        "import time, random\n"
        "def taskfn(emit, extra):\n"
        "    emit(1)\n"
        "def mapfn(key, value, emit):\n"
        "    emit(key, value, time.time())\n"
        "    random.shuffle(value)\n"
        "def partitionfn(key):\n"
        "    return hash(key) % 4\n"
        "def reducefn(key, values):\n"
        "    for v in set(values):\n"
        "        pass\n"
        "    return values[0]\n"
    )
    with tempfile.TemporaryDirectory() as d:
        g = os.path.join(d, "goodtask.py")
        with open(g, "w") as f:
            f.write(good)
        rep = check_task(g)
        assert rep.verdict == VERDICT_INGRAPH, report_dict(rep)
        assert all(fr.verdict == VERDICT_INGRAPH
                   for fr in rep.functions.values())
        assert rep.findings == []

        b = os.path.join(d, "badtask.py")
        with open(b, "w") as f:
            f.write(bad)
        rep = check_task(b)
        assert rep.verdict == VERDICT_INVALID
        rules = {f.rule for f in rep.findings}
        assert {"LMR021", "LMR022", "LMR023", "LMR024",
                "LMR025"} <= rules, rules

        # a missing required function is LMR020 + invalid
        m = os.path.join(d, "half.py")
        with open(m, "w") as f:
            f.write("def mapfn(key, value, emit):\n    emit(key, value)\n")
        rep = check_task(m)
        assert rep.verdict == VERDICT_INVALID
        assert sum(1 for f in rep.findings if f.rule == "LMR020") == 3

    assert check_task("no.such.module").verdict == VERDICT_INVALID
