"""Whole-program call graph over the package (DESIGN §25).

Copy of the JAX package's ``analysis/callgraph.py``.

The per-function lint (analysis/rules.py) deliberately stops at one
frame: a helper *called* under the index flock is not re-checked inside
the locked region.  That limit is exactly what the interprocedural pass
(analysis/dataflow.py) removes — and it needs a call graph to walk.

This module builds one statically, from the AST alone (no imports are
executed — the analyzer must be runnable against a broken tree):

- **nodes** are functions: module-level defs, methods, nested defs
  (``outer.inner``), plus one ``<module>`` pseudo-function per file for
  import-time code;
- **edges** are resolved call sites, each tagged with a *kind* the
  dataflow pass uses to decide what to follow:

  - ``direct``  — ``f()`` resolved to a module function / nested def /
    ``from x import f`` target;
  - ``ctor``    — ``Cls()`` resolved to ``Cls.__init__``;
  - ``method``  — ``self.m()`` / ``Cls.m()`` resolved through the class
    and its (statically resolvable) bases;
  - ``interface`` — ``obj.m()`` where ``m`` belongs to the Store /
    FileBuilder / JobStore abstract surface: resolved to EVERY
    store-like implementation of ``m`` in the graph (the
    may-dispatch-anywhere approximation for the storage plane);
  - ``param``   — a call to one of the enclosing function's own
    parameters (a user callback — unresolvable, but exactly the thing
    the flock rule needs to see).

Deliberate limits (documented, like the per-function pass's): no alias
tracking through local variables (``g = self.load; g()`` is invisible),
lambdas merge into their enclosing function, and dynamically generated
methods (``setattr(cls, op, ...)``) contribute no edges.  The rules
that consume the graph are written so these limits fail *quiet*, never
noisy.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from lua_mapreduce_tpu_torch.analysis.lint import _iter_rel_files, _PKG_ROOT
from lua_mapreduce_tpu_torch.analysis.rules import _chain

# the abstract surfaces whose method names dispatch anywhere in the
# storage plane (store/base.py Store + FileBuilder, coord/jobstore.py
# JobStore). Kept as a literal so fixture graphs resolve identically.
_INTERFACE_BASES = {"Store", "FileBuilder", "JobStore"}

# a class "looks store-like" (eligible as an interface implementation)
# when its own name or any base name carries one of these markers
_IMPL_MARKERS = ("Store", "Builder", "Writer")


@dataclasses.dataclass(frozen=True)
class FunctionInfo:
    """One call-graph node."""
    fid: str                 # "rel::Qual" — globally unique
    rel: str                 # package-relative posix path
    qual: str                # "func", "Cls.method", "outer.inner"
    name: str                # bare name
    cls: Optional[str]       # owning class name, if a method
    lineno: int
    params: Tuple[str, ...]  # parameter names (self/cls dropped)
    node: ast.AST = dataclasses.field(compare=False, hash=False,
                                      repr=False)


@dataclasses.dataclass(frozen=True)
class Edge:
    caller: str
    callee: str
    line: int
    kind: str                # direct | ctor | method | interface | param


class _ClassInfo:
    def __init__(self, name: str, bases: List[Tuple[str, ...]]):
        self.name = name
        self.bases = bases                 # dotted chains, unresolved
        self.methods: Dict[str, str] = {}  # method name -> fid


class _ModuleInfo:
    def __init__(self, rel: str, source: str, tree: ast.Module):
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        # dotted name derived from the path: "store/base.py" -> "store.base"
        dotted = rel[:-3] if rel.endswith(".py") else rel
        dotted = dotted.replace("/", ".")
        if dotted.endswith(".__init__"):
            dotted = dotted[: -len(".__init__")]
        self.dotted = dotted
        self.imports: Dict[str, str] = {}          # alias -> dotted module
        self.from_imports: Dict[str, Tuple[str, str]] = {}  # alias ->(mod,attr)
        self.functions: Dict[str, str] = {}        # module-level name -> fid
        self.classes: Dict[str, _ClassInfo] = {}


class CallGraph:
    """The resolved whole-program graph plus the per-module source maps
    the deep rules need (line lookup for suppression, AST re-walks)."""

    def __init__(self):
        self.modules: Dict[str, _ModuleInfo] = {}      # rel -> module
        self.functions: Dict[str, FunctionInfo] = {}   # fid -> info
        self.edges_from: Dict[str, List[Edge]] = {}
        self._by_dotted: Dict[str, str] = {}           # dotted -> rel
        self._iface_methods: Set[str] = set()
        self._iface_impls: Dict[str, List[str]] = {}   # method -> [fid]
        self.unresolved = 0

    # -- construction -------------------------------------------------------

    @classmethod
    def from_sources(cls, sources: Sequence[tuple]) -> "CallGraph":
        """Build from ``[(rel, source), ...]`` (the fixture entry point)
        or ``[(rel, source, tree), ...]`` — run_audit hands over the
        trees lint already parsed so the combined pass parses once."""
        g = cls()
        for entry in sources:
            rel, src = entry[0], entry[1]
            tree = entry[2] if len(entry) > 2 else None
            if tree is None:
                try:
                    tree = ast.parse(src, filename=rel)
                except (SyntaxError, ValueError):
                    continue      # unparseable files are LMR000's problem
            g.modules[rel] = _ModuleInfo(rel, src, tree)
        g._index()
        g._resolve()
        return g

    def node_count(self) -> int:
        return len(self.functions)

    def edge_count(self) -> int:
        return sum(len(v) for v in self.edges_from.values())

    def callees(self, fid: str) -> List[Edge]:
        return self.edges_from.get(fid, [])

    def interface_methods(self) -> Set[str]:
        return set(self._iface_methods)

    # -- indexing pass ------------------------------------------------------

    def _index(self) -> None:
        for rel, m in sorted(self.modules.items()):
            self._by_dotted[m.dotted] = rel
        for rel, m in sorted(self.modules.items()):
            self._index_module(m)
        # the interface surface: method names declared on the abstract
        # bases, then every store-like implementation of each
        for m in self.modules.values():
            for ci in m.classes.values():
                if ci.name in _INTERFACE_BASES:
                    self._iface_methods.update(
                        n for n in ci.methods if not n.startswith("__"))
        for m in self.modules.values():
            for ci in m.classes.values():
                if not self._storelike(ci):
                    continue
                for name, fid in ci.methods.items():
                    if name in self._iface_methods:
                        self._iface_impls.setdefault(name, []).append(fid)

    @staticmethod
    def _storelike(ci: _ClassInfo) -> bool:
        names = [ci.name] + ["".join(b) for b in ci.bases]
        return any(mark in n for n in names for mark in _IMPL_MARKERS) \
            or any(b[-1] in _INTERFACE_BASES for b in ci.bases)

    def _index_module(self, m: _ModuleInfo) -> None:
        # imports
        for n in ast.walk(m.tree):
            if isinstance(n, ast.Import):
                for a in n.names:
                    if a.asname:
                        m.imports[a.asname] = a.name
                    else:
                        # ``import a.b`` binds ``a``; ``a.b.f`` then
                        # resolves through the chain itself
                        top = a.name.split(".")[0]
                        m.imports[top] = top
            elif isinstance(n, ast.ImportFrom):
                base = n.module or ""
                if n.level:      # relative: anchor at this module's package
                    pkg = m.dotted.rsplit(".", n.level)[0] \
                        if m.dotted.count(".") >= n.level else ""
                    base = f"{pkg}.{base}" if base and pkg else (pkg or base)
                for a in n.names:
                    if a.name == "*":
                        continue
                    m.from_imports[a.asname or a.name] = (base, a.name)

        # the module pseudo-function
        mod_fid = f"{m.rel}::<module>"
        self.functions[mod_fid] = FunctionInfo(
            fid=mod_fid, rel=m.rel, qual="<module>", name="<module>",
            cls=None, lineno=0, params=(), node=m.tree)

        def add_fn(node, qual, cls_name):
            fid = f"{m.rel}::{qual}"
            a = node.args
            params = tuple(x.arg for x in (a.posonlyargs + a.args
                                           + a.kwonlyargs)
                           if x.arg not in ("self", "cls"))
            self.functions[fid] = FunctionInfo(
                fid=fid, rel=m.rel, qual=qual, name=node.name,
                cls=cls_name, lineno=node.lineno, params=params, node=node)
            return fid

        def walk_body(body, prefix, cls_name):
            for n in body:
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{prefix}{n.name}"
                    fid = add_fn(n, qual, cls_name)
                    if not prefix:
                        m.functions[n.name] = fid
                    elif cls_name and prefix == f"{cls_name}.":
                        m.classes[cls_name].methods[n.name] = fid
                    walk_body(n.body, f"{qual}.", cls_name)
                elif isinstance(n, ast.ClassDef) and not prefix:
                    bases = [c for c in map(_chain, n.bases) if c]
                    m.classes[n.name] = _ClassInfo(n.name, bases)
                    walk_body(n.body, f"{n.name}.", n.name)
                elif isinstance(n, ast.ClassDef):
                    # nested class: methods indexed under a dotted qual,
                    # not resolvable as self-dispatch — keep the nodes
                    walk_body(n.body, f"{prefix}{n.name}.", None)
                else:
                    # defs behind if/try/except/with at ANY depth: the
                    # recursion walks every nested statement list (an
                    # import-fallback `except ImportError: def helper()`
                    # must still be a graph node)
                    for c in ast.iter_child_nodes(n):
                        if isinstance(c, (ast.stmt, ast.excepthandler)):
                            walk_body([c], prefix, cls_name)

        walk_body(m.tree.body, "", None)

    # -- resolution pass ----------------------------------------------------

    def _resolve(self) -> None:
        for rel, m in sorted(self.modules.items()):
            for fid, fi in list(self.functions.items()):
                if fi.rel != rel:
                    continue
                self._resolve_function(m, fi)

    def _own_calls(self, fi: FunctionInfo) -> Iterable[ast.Call]:
        """Call nodes belonging to this function: its own statements,
        lambdas included, nested defs/classes excluded."""
        if fi.qual == "<module>":
            roots = [n for n in fi.node.body
                     if not isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef,
                                           ast.ClassDef))]
        else:
            roots = list(fi.node.body)
        stack = list(roots)
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            if isinstance(n, ast.Call):
                yield n
            stack.extend(ast.iter_child_nodes(n))

    def _resolve_function(self, m: _ModuleInfo, fi: FunctionInfo) -> None:
        edges = self.edges_from.setdefault(fi.fid, [])
        nested = {}
        if fi.qual != "<module>":
            for n in fi.node.body:
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    nested[n.name] = f"{m.rel}::{fi.qual}.{n.name}"
        for call in self._own_calls(fi):
            e = self._resolve_call(m, fi, nested, call)
            if e is not None:
                edges.append(e)
            else:
                self.unresolved += 1

    def _resolve_call(self, m: _ModuleInfo, fi: FunctionInfo,
                      nested: Dict[str, str],
                      call: ast.Call) -> Optional[Edge]:
        line = call.lineno
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            if name in fi.params:
                return Edge(fi.fid, f"<param:{name}>", line, "param")
            if name in nested:
                return Edge(fi.fid, nested[name], line, "direct")
            if name in m.functions:
                return Edge(fi.fid, m.functions[name], line, "direct")
            if name in m.classes:
                init = m.classes[name].methods.get("__init__")
                return Edge(fi.fid, init, line, "ctor") if init else None
            if name in m.from_imports:
                return self._resolve_from_import(fi, m, name, line)
            return None
        if isinstance(func, ast.Attribute):
            meth = func.attr
            chain = _chain(func.value)
            if chain is not None:
                root = chain[0]
                if root in ("self", "cls") and fi.cls and len(chain) == 1:
                    fid = self._resolve_method(m, fi.cls, meth)
                    if fid:
                        return Edge(fi.fid, fid, line, "method")
                elif len(chain) == 1 and chain[0] in m.classes:
                    fid = self._resolve_method(m, chain[0], meth)
                    if fid:
                        return Edge(fi.fid, fid, line, "method")
                else:
                    target = self._module_target(m, chain)
                    if target is not None:
                        tm = self.modules.get(target)
                        if tm and meth in tm.functions:
                            return Edge(fi.fid, tm.functions[meth], line,
                                        "direct")
                        if tm and meth in tm.classes:
                            init = tm.classes[meth].methods.get(
                                "__init__")
                            if init:
                                return Edge(fi.fid, init, line, "ctor")
                        return None
            # fall through: unknown receiver — the interface surface
            if meth in self._iface_methods and self._iface_impls.get(meth):
                # one edge per implementation: dataflow fans out itself
                return Edge(fi.fid, f"<iface:{meth}>", line, "interface")
            return None
        return None

    def iface_targets(self, meth: str) -> List[str]:
        return list(self._iface_impls.get(meth, ()))

    def _resolve_from_import(self, fi: FunctionInfo, m: _ModuleInfo,
                             name: str, line: int) -> Optional[Edge]:
        mod, attr = m.from_imports[name]
        rel = self._find_module(mod)
        if rel is None:
            return None
        tm = self.modules[rel]
        if attr in tm.functions:
            return Edge(fi.fid, tm.functions[attr], line, "direct")
        if attr in tm.classes:
            init = tm.classes[attr].methods.get("__init__")
            if init:
                return Edge(fi.fid, init, line, "ctor")
        return None

    def _module_target(self, m: _ModuleInfo, chain: Tuple[str, ...]) \
            -> Optional[str]:
        """rel of the module a dotted receiver chain names, if any:
        ``import a.b as x; x.f()`` or ``from a import b; b.f()``."""
        root = chain[0]
        dotted = None
        if root in m.imports:
            dotted = m.imports[root]
            if len(chain) > 1:
                dotted = ".".join([dotted] + list(chain[1:]))
        elif root in m.from_imports:
            base, attr = m.from_imports[root]
            dotted = f"{base}.{attr}" if base else attr
            if len(chain) > 1:
                dotted = ".".join([dotted] + list(chain[1:]))
        if dotted is None:
            return None
        return self._find_module(dotted)

    def _find_module(self, dotted: str) -> Optional[str]:
        """Match a dotted import against known modules: exact, then
        suffix on a dot boundary (fixture graphs drop the package
        prefix; package files carry it)."""
        if dotted in self._by_dotted:
            return self._by_dotted[dotted]
        for known, rel in self._by_dotted.items():
            if dotted.endswith("." + known) or known.endswith("." + dotted):
                return rel
        return None

    def _resolve_method(self, m: _ModuleInfo, cls: str, meth: str,
                        _seen: Optional[Set[str]] = None) -> Optional[str]:
        """Resolve ``cls.meth`` through the class and its statically
        reachable bases (same module, or imported by name)."""
        _seen = _seen or set()
        key = f"{m.rel}:{cls}"
        if key in _seen:
            return None
        _seen.add(key)
        ci = m.classes.get(cls)
        if ci is None:
            return None
        if meth in ci.methods:
            return ci.methods[meth]
        for base in ci.bases:
            tail = base[-1]
            if tail in m.classes:
                fid = self._resolve_method(m, tail, meth, _seen)
                if fid:
                    return fid
            elif tail in m.from_imports:
                mod, attr = m.from_imports[tail]
                rel = self._find_module(mod)
                if rel:
                    fid = self._resolve_method(self.modules[rel], attr,
                                               meth, _seen)
                    if fid:
                        return fid
            elif len(base) > 1:
                rel = self._module_target(m, base[:-1])
                if rel:
                    fid = self._resolve_method(self.modules[rel], tail,
                                               meth, _seen)
                    if fid:
                        return fid
        return None


def build_callgraph(paths: Optional[Sequence[str]] = None) -> CallGraph:
    """Parse ``paths`` (default: the whole package) into a CallGraph.
    Path anchoring is lint's (_iter_rel_files): package files ALWAYS
    keep their package-relative path — ``deep lua_mapreduce_tpu/coord``
    must still see ``coord/``-scoped seeds — and fixture trees are
    relative to their root, so they carry the same scope prefixes."""
    if paths is None:
        paths = [_PKG_ROOT]
    sources: List[Tuple[str, str]] = []
    for f, rel in _iter_rel_files(paths):
        try:
            with open(f, encoding="utf-8") as fh:
                src = fh.read()
        except (UnicodeDecodeError, OSError):
            continue              # LMR000 territory, not the graph's
        sources.append((rel, src))
    return CallGraph.from_sources(sources)


def utest() -> None:
    """Self-test: resolution of every edge kind on a fixture pair, then
    a sanity pass over the real package."""
    g = CallGraph.from_sources([
        ("coord/a.py", (
            "from coord.b import helper\n"
            "import coord.b\n"
            "class Idx:\n"
            "    def top(self, cb):\n"
            "        self.low()\n"
            "        helper()\n"
            "        coord.b.other()\n"
            "        cb(1)\n"
            "    def low(self):\n"
            "        def inner():\n"
            "            return 1\n"
            "        return inner()\n"
        )),
        ("coord/b.py", (
            "def helper():\n"
            "    return other()\n"
            "def other():\n"
            "    return 2\n"
        )),
        ("store/s.py", (
            "class Store:\n"
            "    def lines(self, name):\n"
            "        raise NotImplementedError\n"
            "class MemStore(Store):\n"
            "    def lines(self, name):\n"
            "        return []\n"
            "def consume(store):\n"
            "    return store.lines('x')\n"
        )),
    ])
    kinds = {(e.caller.split("::")[1], e.callee, e.kind)
             for edges in g.edges_from.values() for e in edges}
    assert ("Idx.top", "coord/a.py::Idx.low", "method") in kinds
    assert ("Idx.top", "coord/b.py::helper", "direct") in kinds
    assert ("Idx.top", "coord/b.py::other", "direct") in kinds
    assert ("Idx.top", "<param:cb>", "param") in kinds
    assert ("Idx.low", "coord/a.py::Idx.low.inner", "direct") in kinds
    assert ("helper", "coord/b.py::other", "direct") in kinds
    assert ("consume", "<iface:lines>", "interface") in kinds
    impls = g.iface_targets("lines")
    assert "store/s.py::MemStore.lines" in impls
    assert "store/s.py::Store.lines" in impls

    real = build_callgraph()
    assert real.node_count() > 500, real.node_count()
    assert real.edge_count() > 1000, real.edge_count()
    # spot checks: the engine's spill factory call and a method edge
    assert any(e.callee.endswith("::Worker.run_one")
               for edges in real.edges_from.values() for e in edges), \
        "worker dispatch edge missing"
    assert "lines" in real.interface_methods()
    assert "claim_batch" in real.interface_methods()
