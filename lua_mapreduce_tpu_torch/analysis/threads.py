"""Thread-spawn graph: which thread roots may execute each function.

Copy of the JAX package's ``analysis/threads.py``.

The call graph (analysis/callgraph.py) answers *who calls whom*; this
module answers *who RUNS whom*.  Every ``threading.Thread(target=...)``
construction, every ``pool.submit(fn, ...)`` hand-off, and every
``FleetSupervisor(spawn=...)`` elastic hook is a **spawn site**: the
target resolves to an entry function, and everything reachable from
that entry (over the same call edges the dataflow pass follows) runs on
that spawned thread.  A function's **root set** is then:

- ``"main"`` when it is reachable from any top-of-graph function that
  is not itself a thread entry (public API, module import-time code,
  utest harnesses) — the spawning side of every hand-off;
- one label per spawn entry whose closure contains it (the label is the
  entry function's fid, so diagnostics read ``engine/worker.py::
  Worker._beating.beat``).

A shared attribute is *contested* when the union of its accessors'
root sets spans at least two roots — or one root marked **multi**
(spawned in a loop, through a pool, or through the elastic supervisor:
many instances of the same entry race each other).  That contested-ness
test is what keeps the lockset rules (analysis/lockset.py, LMR026+)
quiet on the large majority of fields that only one thread ever sees.

Deliberate limits (the callgraph's, inherited): targets aliased through
locals (``fn = self._loop; Thread(target=fn)``) resolve only when the
local was assigned a constructor result or a def in the same function;
``setattr``-installed entries contribute nothing.  Unresolved targets
are kept (``entry=None``) so the shutdown audit still sees the site.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from lua_mapreduce_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo,
                                                  build_callgraph)
from lua_mapreduce_tpu_torch.analysis.rules import _chain

MAIN = "main"

# call kinds a thread's closure follows: what the entry can actually
# execute. ``param`` stays out (a callback handed *to* the thread body
# is the caller's code — the spawn-site rules handle the hand-off).
_FOLLOW = {"direct", "method", "ctor", "interface"}


@dataclasses.dataclass(frozen=True)
class SpawnSite:
    """One place a new executing thread (or pool task / fleet member)
    is minted."""
    spawner: str             # fid of the constructing function
    rel: str
    line: int
    via: str                 # "thread" | "submit" | "fleet"
    entry: Optional[str]     # resolved entry fid (None = unresolvable)
    daemon: bool             # daemon=True on the Thread ctor
    multi: bool              # in a loop / pool / fleet: many instances
    target_src: str          # diagnostic: the target expression's text


class ThreadGraph:
    """Spawn sites + the per-function root sets derived from them."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        self.spawns: List[SpawnSite] = []
        self.entries: Set[str] = set()        # resolved entry fids
        self.multi_entries: Set[str] = set()  # entries with many instances
        self.roots: Dict[str, Set[str]] = {}  # fid -> {"main", entry fids}

    def roots_of(self, fid: str) -> Set[str]:
        """Root labels that may execute ``fid`` ({"main"} when the graph
        knows nothing — an unreached function is assumed caller-side)."""
        return self.roots.get(fid) or {MAIN}

    def contested(self, fids: Iterable[str]) -> bool:
        """Can two of these functions run concurrently? True when their
        root union spans >= 2 roots, or any shared root is multi-
        instance (the entry races itself)."""
        union: Set[str] = set()
        for fid in fids:
            union |= self.roots_of(fid)
        if len(union) >= 2:
            return True
        return bool(union & self.multi_entries)


# -- spawn-site detection -----------------------------------------------------


def _own_nodes(fi: FunctionInfo) -> Iterable[ast.AST]:
    """The function's own AST (lambdas included, nested defs/classes
    not) — mirrors CallGraph._own_calls' attribution."""
    if fi.qual == "<module>":
        roots = [n for n in fi.node.body
                 if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                       ast.ClassDef))]
    else:
        roots = list(fi.node.body)
    stack = list(roots)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _loop_lines(fi: FunctionInfo) -> Set[int]:
    """Line numbers inside for/while bodies of this function — a spawn
    there mints many instances."""
    lines: Set[int] = set()
    for n in _own_nodes(fi):
        if isinstance(n, (ast.For, ast.AsyncFor, ast.While)):
            for c in ast.walk(n):
                if hasattr(c, "lineno"):
                    lines.add(c.lineno)
    return lines


def _ctor_class_of(call: ast.Call) -> Optional[str]:
    """Class name a call mints: a direct ``Worker(...)`` ctor, or the
    base of a fluent builder chain ``Worker(...).configure(...)`` (the
    configure-returns-self idiom every engine object uses)."""
    c = _chain(call.func)
    if c and c[-1][:1].isupper():
        return c[-1]
    node = call.func
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Call):
        return _ctor_class_of(node)
    return None


def _returned_class(g: CallGraph, fid: str) -> Optional[str]:
    """The class a factory function returns: ``return Worker(...)`` or
    ``return w`` where ``w`` is a ctor-typed local (one level deep —
    enough for the CLI ``mint()`` worker factories)."""
    fi = g.functions.get(fid)
    if fi is None:
        return None
    locals_: Dict[str, str] = {}
    for n in _own_nodes(fi):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                and isinstance(n.targets[0], ast.Name) \
                and isinstance(n.value, ast.Call):
            cls = _ctor_class_of(n.value)
            if cls:
                locals_[n.targets[0].id] = cls
    for n in _own_nodes(fi):
        if isinstance(n, ast.Return) and n.value is not None:
            if isinstance(n.value, ast.Name) and n.value.id in locals_:
                return locals_[n.value.id]
            if isinstance(n.value, ast.Call):
                cls = _ctor_class_of(n.value)
                if cls:
                    return cls
    return None


def _local_ctor_types(fi: FunctionInfo,
                      g: Optional[CallGraph] = None) -> Dict[str, str]:
    """``w = Worker(...)`` locals: name -> class name (the minimal alias
    tracking spawn targets like ``Thread(target=w.execute)`` need).
    With a graph, also follows fluent builders and local factory calls
    (``w = mint(...)`` where mint returns a ctor-typed local)."""
    out: Dict[str, str] = {}
    for n in _own_nodes(fi):
        if not (isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and isinstance(n.value, ast.Call)):
            continue
        cls = _ctor_class_of(n.value)
        if cls is None and g is not None \
                and isinstance(n.value.func, ast.Name):
            target = _resolve_local_fn(g, fi, n.value.func.id)
            if target:
                cls = _returned_class(g, target)
        if cls:
            out[n.targets[0].id] = cls
    return out


def _resolve_local_fn(g: CallGraph, fi: FunctionInfo,
                      name: str) -> Optional[str]:
    nested = f"{fi.rel}::{fi.qual}.{name}"
    if nested in g.functions:
        return nested
    qual = fi.qual
    while "." in qual:
        qual = qual.rsplit(".", 1)[0]
        cand = f"{fi.rel}::{qual}.{name}"
        if cand in g.functions:
            return cand
    m = g.modules.get(fi.rel)
    if m is not None and name in m.functions:
        return m.functions[name]
    return None


def _resolve_class_method(g: CallGraph, rel: str, cls: str,
                          meth: str) -> Optional[str]:
    """``cls.meth`` resolved first in ``rel``'s module, else in any
    module defining a class of that name (unique match only)."""
    m = g.modules.get(rel)
    if m is not None:
        fid = g._resolve_method(m, cls, meth)
        if fid:
            return fid
    hits = []
    for om in g.modules.values():
        if cls in om.classes:
            fid = g._resolve_method(om, cls, meth)
            if fid:
                hits.append(fid)
    return hits[0] if len(set(hits)) == 1 else None


def _resolve_target(g: CallGraph, fi: FunctionInfo,
                    expr: ast.AST) -> List[Optional[str]]:
    """Entry fids a spawn-target expression can name.  A lambda target
    yields every function its body calls (the call graph attributes
    those call sites to the spawner, so the edges are already there).
    ``[None]`` = a site the graph cannot resolve."""
    m = g.modules[fi.rel]
    if isinstance(expr, ast.Lambda):
        lines = {c.lineno for c in ast.walk(expr)
                 if isinstance(c, ast.Call)}
        found = []
        for e in g.callees(fi.fid):
            if e.line in lines and e.kind in _FOLLOW:
                found.extend(_expand(g, e))
        return sorted(set(found)) or [None]
    if isinstance(expr, ast.Name):
        name = expr.id
        nested = f"{fi.rel}::{fi.qual}.{name}"
        if nested in g.functions:
            return [nested]
        # a def in an ENCLOSING function (Thread built in a helper of
        # the scope that defined the target)
        qual = fi.qual
        while "." in qual:
            qual = qual.rsplit(".", 1)[0]
            cand = f"{fi.rel}::{qual}.{name}"
            if cand in g.functions:
                return [cand]
        if name in m.functions:
            return [m.functions[name]]
        if name in m.from_imports:
            mod, attr = m.from_imports[name]
            rel = g._find_module(mod)
            if rel and attr in g.modules[rel].functions:
                return [g.modules[rel].functions[attr]]
        return [None]
    c = _chain(expr)
    if c and len(c) == 2:
        recv, meth = c
        if recv in ("self", "cls") and fi.cls:
            fid = g._resolve_method(m, fi.cls, meth)
            return [fid] if fid else [None]
        cls = _local_ctor_types(fi, g).get(recv)
        if cls:
            fid = _resolve_class_method(g, fi.rel, cls, meth)
            return [fid] if fid else [None]
    return [None]


def _expand(g: CallGraph, e) -> List[str]:
    if e.kind == "interface":
        return list(g.iface_targets(e.callee[len("<iface:"):-1]))
    if e.callee.startswith("<"):
        return []
    return [e.callee] if e.callee in g.functions else []


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _src(expr: ast.AST) -> str:
    try:
        return ast.unparse(expr)
    except Exception:
        return "<expr>"


def _spawn_sites(g: CallGraph, fi: FunctionInfo) -> Iterable[SpawnSite]:
    loops = _loop_lines(fi)
    for n in _own_nodes(fi):
        if not isinstance(n, ast.Call):
            continue
        c = _chain(n.func)
        if not c:
            continue
        line = n.lineno
        if c[-1] == "Thread" and (len(c) == 1 or c[-2] == "threading"):
            target = _kw(n, "target")
            if target is None:
                continue
            d = _kw(n, "daemon")
            daemon = isinstance(d, ast.Constant) and bool(d.value)
            for entry in _resolve_target(g, fi, target):
                yield SpawnSite(fi.fid, fi.rel, line, "thread", entry,
                                daemon, line in loops, _src(target))
        elif c[-1] == "submit" and len(c) >= 2 and n.args:
            # executor pool hand-off: many tasks share each pool thread
            for entry in _resolve_target(g, fi, n.args[0]):
                yield SpawnSite(fi.fid, fi.rel, line, "submit", entry,
                                False, True, _src(n.args[0]))
        elif c[-1] == "FleetSupervisor":
            target = _kw(n, "spawn") or (n.args[0] if n.args else None)
            if target is None:
                continue
            for entry in _resolve_target(g, fi, target):
                yield SpawnSite(fi.fid, fi.rel, line, "fleet", entry,
                                False, True, _src(target))


# -- root computation ---------------------------------------------------------


def _bfs(g: CallGraph, seeds: Sequence[str]) -> Set[str]:
    seen = set(seeds)
    frontier = list(seeds)
    while frontier:
        cur = frontier.pop()
        for e in g.callees(cur):
            if e.kind not in _FOLLOW:
                continue
            for callee in _expand(g, e):
                if callee not in seen:
                    seen.add(callee)
                    frontier.append(callee)
    return seen


def build_thread_graph(g: Optional[CallGraph] = None,
                       paths: Optional[Sequence[str]] = None) -> ThreadGraph:
    """The full pass: find spawn sites, resolve entries, compute root
    sets (main reachability + one closure per entry)."""
    if g is None:
        g = build_callgraph(paths)
    tg = ThreadGraph(g)
    for fid, fi in sorted(g.functions.items()):
        tg.spawns.extend(_spawn_sites(g, fi))
    for s in tg.spawns:
        if s.entry is not None:
            tg.entries.add(s.entry)
            if s.multi:
                tg.multi_entries.add(s.entry)
    # an entry spawned from two distinct sites also races itself
    by_entry: Dict[str, Set[Tuple[str, int]]] = {}
    for s in tg.spawns:
        if s.entry is not None:
            by_entry.setdefault(s.entry, set()).add((s.rel, s.line))
    for entry, sites in by_entry.items():
        if len(sites) > 1:
            tg.multi_entries.add(entry)

    # main reachability: BFS from every top-of-graph function that is
    # not a spawn-only entry. An entry somebody ALSO calls normally
    # keeps its main root through that caller; a target nobody calls
    # (the daemon loop pattern) stays thread-only.
    called: Set[str] = set()
    for edges in g.edges_from.values():
        for e in edges:
            called.update(_expand(g, e))
    spawn_only = {e for e in tg.entries if e not in called}
    seeds = [fid for fid in g.functions
             if fid not in called and fid not in spawn_only]
    main_set = _bfs(g, seeds)
    for fid in g.functions:
        r: Set[str] = set()
        if fid in main_set:
            r.add(MAIN)
        tg.roots[fid] = r
    for entry in sorted(tg.entries):
        for fid in _bfs(g, [entry]):
            tg.roots[fid].add(entry)
    for fid, r in tg.roots.items():
        if not r:
            r.add(MAIN)          # unreached: assume caller-side
    return tg


def shutdown_report(tg: ThreadGraph) -> List[dict]:
    """The thread-shutdown audit's input: every Thread spawn site with
    its daemon flag and whether the spawning module joins a thread at
    all (``.join(`` anywhere in the module — the bounded-stop check the
    leak test enforces dynamically)."""
    out = []
    for s in tg.spawns:
        if s.via != "thread":
            continue          # pool/fleet lifecycles are owner-managed
        mod = tg.graph.modules.get(s.rel)
        joins = mod is not None and ".join(" in mod.source
        out.append({"rel": s.rel, "line": s.line, "entry": s.entry,
                    "daemon": s.daemon, "module_joins": joins,
                    "target": s.target_src})
    return out


def utest() -> None:
    """Self-test: every spawn-site kind resolves on a fixture, root
    sets separate thread-only code from main code, and the real
    package's known daemon loops classify thread-only."""
    g = CallGraph.from_sources([
        ("engine/fx.py", (
            "import threading\n"
            "from sched.controller import FleetSupervisor\n"
            "class W:\n"
            "    def go(self):\n"
            "        def loop():\n"
            "            self.tick()\n"
            "        t = threading.Thread(target=loop, daemon=True)\n"
            "        t.start()\n"
            "        for i in range(3):\n"
            "            threading.Thread(target=self.run_one).start()\n"
            "        pool.submit(self.reduce_one, 1)\n"
            "        sup = FleetSupervisor(spawn=self.mint, retire=print,\n"
            "                              baseline=1, cap=2)\n"
            "    def tick(self):\n"
            "        self.shared = 1\n"
            "    def run_one(self):\n"
            "        pass\n"
            "    def reduce_one(self, i):\n"
            "        pass\n"
            "    def mint(self, i):\n"
            "        pass\n"
            "def main():\n"
            "    W().go()\n"
        )),
        ("sched/controller.py", (
            "class FleetSupervisor:\n"
            "    def __init__(self, spawn, retire, baseline, cap):\n"
            "        pass\n"
        )),
    ])
    tg = build_thread_graph(g)
    by = {(s.via, s.entry): s for s in tg.spawns}
    loop_fid = "engine/fx.py::W.go.loop"
    assert ("thread", loop_fid) in by
    assert by[("thread", loop_fid)].daemon
    assert not by[("thread", loop_fid)].multi
    assert ("thread", "engine/fx.py::W.run_one") in by
    assert by[("thread", "engine/fx.py::W.run_one")].multi  # in a loop
    assert ("submit", "engine/fx.py::W.reduce_one") in by
    assert ("fleet", "engine/fx.py::W.mint") in by
    # roots: loop + tick are thread-only; go/main are main-rooted;
    # tick is reachable ONLY from the loop entry
    assert tg.roots_of(loop_fid) == {loop_fid}
    assert tg.roots_of("engine/fx.py::W.tick") == {loop_fid}
    assert MAIN in tg.roots_of("engine/fx.py::W.go")
    # contested: go (main) vs tick (thread) span two roots; run_one is
    # multi — contested with itself
    assert tg.contested(["engine/fx.py::W.go", "engine/fx.py::W.tick"])
    assert tg.contested(["engine/fx.py::W.run_one"])
    assert not tg.contested(["engine/fx.py::W.go"])

    real = build_thread_graph()
    entries = {s.entry for s in real.spawns if s.entry}
    assert "engine/worker.py::Worker._beating.beat" in entries, entries
    assert "store/sharedfs.py::_writer_loop" in entries, entries
    beat = real.roots_of("engine/worker.py::Worker._beating.beat")
    assert MAIN not in beat, beat      # the daemon loop is thread-only
    # every Thread spawn in the package is daemon or its module joins
    for row in shutdown_report(real):
        assert row["daemon"] or row["module_joins"], row
