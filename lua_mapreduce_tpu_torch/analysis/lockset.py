"""Interprocedural lockset + lock-order analysis: the LMR026+ band.

Copy of the JAX package's ``analysis/lockset.py``.

The per-function rules can see one ``with self._lock:`` block; this
pass sees the whole locking *plane*.  It discovers every lock object
the package creates (instance / class / module / local scope), walks
each function once to summarize which locks guard which shared-field
accesses, then closes the summaries over the call graph
(analysis/callgraph.py) two ways:

- **may-held** (union): the locks some caller may hold when a function
  runs — feeds the global lock-acquisition-order graph (an acquisition
  under a may-held lock is an inter-procedural order edge) and LMR029
  (blocking work reachable while a lock is held).
- **must-held** (intersection): the locks every caller provably holds —
  feeds the per-access *lockset* (intra-procedurally held locks union
  must-held), so a helper only ever called under the guard counts as
  guarded.

Thread identity comes from the spawn graph (analysis/threads.py): a
field group is only *contested* when its accessors' root sets span two
thread roots (or one multi-instance root), which keeps the rules quiet
on single-threaded state.  ``Condition`` objects are lock-like — a
``with self._cond:`` region counts as guarded, so the Waiter's
notify/wait hand-off is modeled as happens-before rather than flagged.

The rule band (each fixture-paired in tests/test_torch_racecheck.py,
all SARIF-exported):

- **LMR026** — unguarded write/mutate of a multi-thread-reachable field
  that is lock-guarded elsewhere (the classic dropped-lock race).
- **LMR027** — inconsistent lockset: one field guarded by two disjoint
  locks in different places (each access is "locked", no pair excludes).
- **LMR028** — lock-order cycle across call boundaries (extends the
  per-function LMR003 ordering discipline interprocedurally), plus
  re-acquisition of a non-reentrant module/class-scope lock.
- **LMR029** — blocking store/coord RPC, ``time.sleep`` or an injected
  callback reachable while an in-process lock is held (the convoy /
  reentrancy hazard: IO latency multiplied into every waiter).
- **LMR030** — a mutable local published to a spawned thread (closure
  or ``args=``) and read back without a join/wait/queue hand-off.

Deliberate limits (documented, tested): ``lock.acquire()``/``release()``
call pairs are not modeled (the package uses ``with`` exclusively —
LMR001's no-bare-acquire discipline); lambda bodies defer execution and
are skipped when attributing held regions; instance locks are keyed by
creation site, so two *instances* of a class are one label (sound for
order edges, deliberately coarse).

``static_lock_model()`` exports the lock-site map, order edges and
cyclic labels for the runtime sanitizer (utils/lockcheck.py), which
replays real acquisition orders against this model; the seeded races
of KNOWN_RACES keep the static pass honest the other way.
"""

from __future__ import annotations

import ast
import dataclasses
import time
from collections import deque
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Set, Tuple

from lua_mapreduce_tpu_torch.analysis import rules as _r
from lua_mapreduce_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo,
                                                  build_callgraph)
from lua_mapreduce_tpu_torch.analysis.dataflow import _DATA_PLANE_CALLS
from lua_mapreduce_tpu_torch.analysis.lint import (Finding, _baseline_match,
                                             _line_disables_in,
                                             load_baseline)
from lua_mapreduce_tpu_torch.analysis.threads import (MAIN, ThreadGraph, _chain,
                                                _local_ctor_types, _own_nodes,
                                                build_thread_graph)

# call kinds the lock closures follow (same plane the thread graph runs)
_FOLLOW = {"direct", "method", "ctor", "interface"}

_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "cond"}

# method names that mutate the receiver collection in place
_MUTATORS = {"append", "extend", "insert", "pop", "popleft", "appendleft",
             "remove", "clear", "discard", "setdefault", "update", "add"}

# blocking surface for LMR029: the store/JobStore RPC set plus the
# data-plane calls LMR013 polices — minus names that collide with
# builtin collection mutators (list.remove is not store IO) and minus
# bare "write" (every file handle has one; write_bytes/build/read_range
# are the distinctive store spellings)
_BLOCKING_CALLS = (_r._RETRY_BOUNDARY_METHODS
                   | _DATA_PLANE_CALLS) - _MUTATORS - {"write"}

# spawn-site synchronization: a call to one of these between publish
# and read-back is the hand-off LMR030 wants to see
_SYNC_CALLS = {"join", "wait", "get", "result", "shutdown"}


@dataclasses.dataclass(frozen=True)
class ConcRule:
    id: str
    severity: str
    title: str
    rationale: str
    paths: Tuple[str, ...]


CONC_RULES: Tuple[ConcRule, ...] = (
    ConcRule(
        "LMR026", "error",
        "no unguarded writes to lock-guarded multi-thread fields",
        "A field that is written under a lock somewhere and plainly "
        "elsewhere has no lock at all: the unguarded write races every "
        "guarded reader the moment two thread roots can reach the "
        "accessors. The heartbeat/eviction/supervisor planes all share "
        "state this way — one dropped guard silently un-serializes "
        "them.", ()),
    ConcRule(
        "LMR027", "warning",
        "no inconsistent locksets across one field's accesses",
        "Two accesses each dutifully locked — under *different* locks "
        "with an empty intersection — exclude nothing: both critical "
        "sections run concurrently. Usually a refactor split one guard "
        "into two; the fix is picking one lock for the field.", ()),
    ConcRule(
        "LMR028", "error",
        "no interprocedural lock-order cycles",
        "Thread 1 holds A and takes B; thread 2 holds B and — three "
        "calls deep — takes A: a deadlock no single function shows. "
        "This extends the LMR003 ordering discipline across call "
        "boundaries via the global acquisition-order graph; it also "
        "flags re-acquiring a non-reentrant module/class lock on any "
        "call path that already holds it.", ()),
    ConcRule(
        "LMR029", "error",
        "no blocking store/coord RPC reachable while holding a lock",
        "An in-process lock held across store IO, a coord RPC, "
        "time.sleep or an injected callback turns one slow byte into a "
        "convoy: every thread needing the lock waits out the IO, and a "
        "callback that re-enters the lock deadlocks. Snapshot under "
        "the lock, do the IO outside it.", ()),
    ConcRule(
        "LMR030", "warning",
        "no cross-thread publish of a mutable local without a hand-off",
        "A list/dict built locally, handed to a Thread (closure or "
        "args=), then read back with no join/wait/queue in between is "
        "a data race on CPython internals and a logic race everywhere: "
        "the reader sees an arbitrary prefix of the writer's work. "
        "Hand results back through join, an Event, or a Queue.", ()),
)


# -- lock discovery -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LockInfo:
    label: str               # "rel::Cls.attr" | "rel::name" | "rel::qual.x"
    rel: str
    line: int                # creation-site line (0 = synthesized)
    kind: str                # "lock" | "rlock" | "cond"
    scope: str               # "instance" | "class" | "module" | "local"
    cls: Optional[str]
    name: str                # bare attribute/variable name


def _lock_ctor_kind(value: ast.AST) -> Optional[str]:
    if not isinstance(value, ast.Call):
        return None
    c = _chain(value.func)
    if not c or c[-1] not in _LOCK_CTORS:
        return None
    if len(c) == 1 or c[-2] == "threading":
        return _LOCK_CTORS[c[-1]]
    return None


def _lockish_name(name: str) -> bool:
    low = name.lower()
    return "lock" in low or "cond" in low or "mutex" in low


class _Pass:
    """One full concurrency analysis over a call graph + thread graph."""

    def __init__(self, g: CallGraph, tg: ThreadGraph):
        self.g = g
        self.tg = tg
        self.locks: Dict[str, LockInfo] = {}
        # (rel, cls) -> {attr: (rel2, cls2)} ctor-typed attributes
        self.attr_types: Dict[Tuple[str, str], Dict[str, Tuple[str, str]]] = {}
        # (rel, cls) -> attrs assigned from a bare __init__ parameter
        self.ctor_params: Dict[Tuple[str, str], Set[str]] = {}
        # (rel, cls) -> lock attribute names (excluded from field groups)
        self.lock_attrs: Dict[Tuple[str, str], Set[str]] = {}
        self.summaries: Dict[str, "_FnSummary"] = {}
        self.must: Dict[str, FrozenSet[str]] = {}
        self.may: Dict[str, Set[str]] = {}
        self.may_gen: Dict[str, Set[str]] = {}
        self.may_via: Dict[str, Tuple[str, int]] = {}
        self.order_edges: Dict[Tuple[str, str], "Acq"] = {}
        self.edges_gen: Set[Tuple[str, str]] = set()
        self.reacq: List["Acq"] = []
        self.cyclic: Set[str] = set()
        self.sccs: List[List[str]] = []
        self.raw: List[Finding] = []
        self._ident_cache: Dict[Tuple[str, str], Optional[Tuple[str, str]]] = {}

    # -- identities -----------------------------------------------------------

    def class_ident(self, rel: str, name: str) -> Optional[Tuple[str, str]]:
        key = (rel, name)
        if key in self._ident_cache:
            return self._ident_cache[key]
        out: Optional[Tuple[str, str]] = None
        m = self.g.modules.get(rel)
        if m is not None:
            if name in m.classes:
                out = (rel, name)
            elif name in m.from_imports:
                mod, attr = m.from_imports[name]
                r2 = self.g._find_module(mod)
                if r2 and attr in self.g.modules[r2].classes:
                    out = (r2, attr)
        if out is None:
            hits = [r for r, mm in self.g.modules.items()
                    if name in mm.classes]
            if len(hits) == 1:
                out = (hits[0], name)
        self._ident_cache[key] = out
        return out

    # -- phase 1: discovery ---------------------------------------------------

    def discover(self) -> None:
        for rel, m in sorted(self.g.modules.items()):
            for st in m.tree.body:
                self._try_lock_assign(st, rel, scope="module", cls=None,
                                      qual=None)
            for n in ast.walk(m.tree):
                if isinstance(n, ast.ClassDef):
                    for st in n.body:
                        self._try_lock_assign(st, rel, scope="class",
                                              cls=n.name, qual=None)
        for fid, fi in sorted(self.g.functions.items()):
            for n in _own_nodes(fi):
                if not isinstance(n, ast.Assign) or len(n.targets) != 1:
                    continue
                kind = _lock_ctor_kind(n.value)
                t = n.targets[0]
                if kind and isinstance(t, ast.Attribute):
                    c = _chain(t)
                    if c and len(c) == 2 and c[0] == "self" and fi.cls:
                        self._add_lock(f"{fi.rel}::{fi.cls}.{c[1]}", fi.rel,
                                       n.lineno, kind, "instance", fi.cls,
                                       c[1])
                elif kind and isinstance(t, ast.Name) \
                        and fi.qual != "<module>":
                    self._add_lock(f"{fi.rel}::{fi.qual}.{t.id}", fi.rel,
                                   n.lineno, kind, "local", None, t.id)
                # ctor-typed attribute / ctor-param attribute maps
                if isinstance(t, ast.Attribute) and fi.cls:
                    c = _chain(t)
                    if c and len(c) == 2 and c[0] == "self":
                        key = (fi.rel, fi.cls)
                        if isinstance(n.value, ast.Call):
                            vc = _chain(n.value.func)
                            if vc and vc[-1][:1].isupper():
                                ident = self.class_ident(fi.rel, vc[-1])
                                if ident:
                                    self.attr_types.setdefault(
                                        key, {})[c[1]] = ident
                        if fi.name == "__init__" \
                                and isinstance(n.value, ast.Name) \
                                and n.value.id in fi.params:
                            self.ctor_params.setdefault(key, set()).add(c[1])

    def _try_lock_assign(self, st: ast.AST, rel: str, scope: str,
                         cls: Optional[str], qual: Optional[str]) -> None:
        if not (isinstance(st, ast.Assign) and len(st.targets) == 1
                and isinstance(st.targets[0], ast.Name)):
            return
        kind = _lock_ctor_kind(st.value)
        if kind is None:
            return
        name = st.targets[0].id
        if scope == "class":
            self._add_lock(f"{rel}::{cls}.{name}", rel, st.lineno, kind,
                           "class", cls, name)
        else:
            self._add_lock(f"{rel}::{name}", rel, st.lineno, kind,
                           "module", None, name)

    def _add_lock(self, label: str, rel: str, line: int, kind: str,
                  scope: str, cls: Optional[str], name: str) -> None:
        if label not in self.locks:
            self.locks[label] = LockInfo(label, rel, line, kind, scope,
                                         cls, name)
            if cls is not None:
                self.lock_attrs.setdefault((rel, cls), set()).add(name)

    # -- lock-use resolution --------------------------------------------------

    def resolve_lock(self, fi: FunctionInfo,
                     expr: ast.AST) -> Optional[str]:
        """The label a with-context expression holds, or None when it
        is not an in-process lock (``_FLock(...)`` calls, files...)."""
        if isinstance(expr, ast.Call):
            return None                  # flock/ctx-manager ctors
        c = _chain(expr)
        if not c or not _lockish_name(c[-1]):
            return None
        last = c[-1]
        if len(c) == 2 and c[0] in ("self", "cls") and fi.cls:
            lbl = f"{fi.rel}::{fi.cls}.{last}"
            if lbl in self.locks:
                return lbl
            hit = self._base_lock(fi.rel, fi.cls, last, set())
            if hit:
                return hit
            cands = {L.label for L in self.locks.values()
                     if L.name == last and L.scope in ("instance", "class")}
            if len(cands) == 1:
                return cands.pop()
            return self._synth(lbl, fi.rel, "instance", fi.cls, last)
        if len(c) == 1:
            qual = fi.qual
            while True:
                lbl = f"{fi.rel}::{qual}.{last}"
                if lbl in self.locks:
                    return lbl
                if "." not in qual:
                    break
                qual = qual.rsplit(".", 1)[0]
            lbl = f"{fi.rel}::{last}"
            if lbl in self.locks:
                return lbl
            cands = {L.label for L in self.locks.values()
                     if L.name == last and L.scope == "module"}
            if len(cands) == 1:
                return cands.pop()
            return self._synth(f"{fi.rel}::{fi.qual}.{last}", fi.rel,
                               "local", None, last)
        if len(c) == 3 and c[0] == "self" and fi.cls:
            ident = self.attr_types.get((fi.rel, fi.cls), {}).get(c[1])
            if ident:
                lbl = f"{ident[0]}::{ident[1]}.{last}"
                if lbl in self.locks:
                    return lbl
                return self._synth(lbl, ident[0], "instance", ident[1], last)
        if len(c) == 2:
            ident = self.class_ident(fi.rel, c[0])
            if ident:                    # Cls._class_lock
                lbl = f"{ident[0]}::{ident[1]}.{last}"
                if lbl in self.locks:
                    return lbl
                hit = self._base_lock(ident[0], ident[1], last, set())
                if hit:
                    return hit
        return self._synth(f"{fi.rel}::{'.'.join(c)}", fi.rel, "local",
                           None, last)

    def _base_lock(self, rel: str, cls: str, name: str,
                   seen: Set[Tuple[str, str]]) -> Optional[str]:
        if (rel, cls) in seen:
            return None
        seen.add((rel, cls))
        m = self.g.modules.get(rel)
        ci = m.classes.get(cls) if m else None
        if ci is None:
            return None
        for bc in ci.bases:
            ident = self.class_ident(rel, bc[-1])
            if ident is None:
                continue
            lbl = f"{ident[0]}::{ident[1]}.{name}"
            if lbl in self.locks:
                return lbl
            hit = self._base_lock(ident[0], ident[1], name, seen)
            if hit:
                return hit
        return None

    def _synth(self, label: str, rel: str, scope: str, cls: Optional[str],
               name: str) -> str:
        # a lock-ish with-context we never saw created: keep it as a
        # site-less label (line 0 — absent from the runtime model)
        self._add_lock(label, rel, 0, "lock", scope, cls, name)
        return label

    # -- phase 2: per-function summaries -------------------------------------

    def summarize(self) -> None:
        for fid, fi in sorted(self.g.functions.items()):
            s = _FnSummary(self, fi)
            s.run()
            self.summaries[fid] = s

    # -- phase 3: propagation -------------------------------------------------

    def _succ(self) -> Dict[str, List[Tuple[str, int, str]]]:
        succ: Dict[str, List[Tuple[str, int, str]]] = {}
        for fid in self.g.functions:
            out: List[Tuple[str, int, str]] = []
            for e in self.g.callees(fid):
                if e.kind not in _FOLLOW:
                    continue
                for callee in self._expand(e):
                    out.append((callee, e.line, e.kind))
            succ[fid] = out
        return succ

    def _expand(self, e) -> Iterable[str]:
        if e.kind == "interface":
            return self.g.iface_targets(e.callee[len("<iface:"):-1])
        if e.callee.startswith("<"):
            return ()
        return (e.callee,) if e.callee in self.g.functions else ()

    def propagate(self) -> None:
        succ = self._succ()
        incoming: Dict[str, List[Tuple[str, int]]] = {}
        for fid, outs in succ.items():
            for callee, line, _kind in outs:
                incoming.setdefault(callee, []).append((fid, line))

        # must-held: intersection over incoming call sites; thread
        # entries and top-of-graph functions run with nothing held
        must: Dict[str, Optional[FrozenSet[str]]] = {
            fid: None for fid in self.g.functions}
        entries = set(self.tg.entries)
        seeds = {fid for fid in self.g.functions
                 if fid not in incoming} | entries
        wl = deque(sorted(seeds))
        for fid in seeds:
            must[fid] = frozenset()
        while wl:
            cur = wl.popleft()
            base = must[cur] or frozenset()
            s = self.summaries[cur]
            for callee, line, _kind in succ[cur]:
                if callee in entries:
                    continue             # spawned: starts lock-free
                contrib = base | s.call_held_must.get(line, frozenset())
                old = must[callee]
                new = contrib if old is None else (old & contrib)
                if new != old:
                    must[callee] = new
                    wl.append(callee)
        self.must = {fid: (v or frozenset()) for fid, v in must.items()}

        # may-held, twice. The PRECISE set (findings, order cycles)
        # skips interface edges: the callgraph resolves any bare
        # ``f.write(...)``-shaped call by storage-interface name
        # fan-out, and one such edge from inside a locked region would
        # smear that lock over every store implementation in the
        # package. The GENEROUS set (interface edges included) feeds
        # only the runtime model's edge list, where over-approximation
        # is the sound direction — the watchdog checks observed orders
        # by SUBSET against it.
        self.may = self._may_fixpoint(succ, with_iface=False,
                                      via=self.may_via)
        self.may_gen = self._may_fixpoint(succ, with_iface=True)

    def _may_fixpoint(self, succ, with_iface: bool,
                      via: Optional[Dict[str, Tuple[str, int]]] = None,
                      ) -> Dict[str, Set[str]]:
        may: Dict[str, Set[str]] = {fid: set() for fid in self.g.functions}
        wl = deque(sorted(self.g.functions))
        while wl:
            cur = wl.popleft()
            base = may[cur]
            s = self.summaries[cur]
            for callee, line, kind in succ[cur]:
                if kind == "interface" and not with_iface:
                    continue
                add = base | s.call_held_may.get(line, frozenset())
                if not add <= may[callee]:
                    may[callee] |= add
                    if via is not None:
                        via.setdefault(callee, (cur, line))
                    wl.append(callee)
        return may

    # -- phase 4: order graph -------------------------------------------------

    def order_graph(self) -> None:
        for fid in sorted(self.summaries):
            s = self.summaries[fid]
            ctx = self.may.get(fid, set())
            gen = self.may_gen.get(fid, set())
            for acq in s.acquisitions:
                for held in sorted(set(acq.held_before) | gen):
                    if held != acq.label:
                        self.edges_gen.add((held, acq.label))
                for held in sorted(set(acq.held_before) | ctx):
                    if held == acq.label:
                        L = self.locks.get(held)
                        if L and L.kind == "lock" \
                                and L.scope in ("module", "class"):
                            self.reacq.append(acq)
                        continue
                    self.order_edges.setdefault((held, acq.label), acq)
        # Tarjan SCC over the label digraph
        adj: Dict[str, List[str]] = {}
        for a, b in self.order_edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on: Set[str] = set()
        stack: List[str] = []
        counter = [0]

        def strong(v0: str) -> None:
            work = [(v0, 0)]
            while work:
                v, pi = work.pop()
                if pi == 0:
                    index[v] = low[v] = counter[0]
                    counter[0] += 1
                    stack.append(v)
                    on.add(v)
                recurse = False
                for i in range(pi, len(adj[v])):
                    w = adj[v][i]
                    if w not in index:
                        work.append((v, i + 1))
                        work.append((w, 0))
                        recurse = True
                        break
                    if w in on:
                        low[v] = min(low[v], index[w])
                if recurse:
                    continue
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on.discard(w)
                        comp.append(w)
                        if w == v:
                            break
                    if len(comp) > 1:
                        self.sccs.append(sorted(comp))
                        self.cyclic.update(comp)
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[v])

        for v in sorted(adj):
            if v not in index:
                strong(v)

    # -- phase 5: checks ------------------------------------------------------

    def lockset_of(self, acc: "FieldAccess") -> FrozenSet[str]:
        return acc.locks | self.must.get(acc.fid, frozenset())

    def check(self) -> None:
        self._check_fields()
        self._check_cycles()
        self._check_blocking()
        self._check_publish()

    def _check_fields(self) -> None:
        groups: Dict[Tuple[Tuple[str, str], str], List[FieldAccess]] = {}
        for s in self.summaries.values():
            for acc in s.accesses:
                groups.setdefault((acc.ident, acc.attr), []).append(acc)
        for (ident, attr), accs in sorted(groups.items()):
            eff = [a for a in accs if not a.in_init]
            if not eff:
                continue
            sets = {id(a): self.lockset_of(a) for a in eff}
            guarded = [a for a in eff if sets[id(a)]]
            if not guarded:
                continue                 # never locked: not this band's
            if not self.tg.contested({a.fid for a in eff}):
                continue                 # one thread root: no race
            guard_names = sorted({lbl for a in guarded
                                  for lbl in sets[id(a)]})
            for a in eff:
                if a.kind in ("write", "mutate") and not sets[id(a)]:
                    self.raw.append(Finding(
                        "LMR026", "error", a.rel, a.line, 0,
                        f"unguarded {a.kind} of {ident[1]}.{attr} — the "
                        f"field is guarded by {guard_names[0]} elsewhere "
                        f"and reachable from multiple thread roots"))
            distinct = {sets[id(a)] for a in guarded}
            if len(distinct) >= 2 \
                    and not frozenset.intersection(*distinct):
                counts: Dict[str, int] = {}
                for a in guarded:
                    for lbl in sets[id(a)]:
                        counts[lbl] = counts.get(lbl, 0) + 1
                modal = sorted(counts, key=lambda k: (-counts[k], k))[0]
                for a in guarded:
                    if modal not in sets[id(a)]:
                        self.raw.append(Finding(
                            "LMR027", "warning", a.rel, a.line, 0,
                            f"inconsistent lockset for {ident[1]}.{attr}: "
                            f"this access holds "
                            f"{sorted(sets[id(a)])[0]} but the field is "
                            f"mostly guarded by {modal} — the two "
                            f"critical sections do not exclude"))

    def _check_cycles(self) -> None:
        for acq in self.reacq:
            self.raw.append(Finding(
                "LMR028", "error", acq.rel, acq.line, 0,
                f"re-acquisition of non-reentrant {acq.label} on a call "
                f"path that already holds it (self-deadlock)"))
        for (a, b), acq in sorted(self.order_edges.items()):
            if a in self.cyclic and b in self.cyclic \
                    and any(a in comp and b in comp for comp in self.sccs):
                cyc = next(comp for comp in self.sccs
                           if a in comp and b in comp)
                self.raw.append(Finding(
                    "LMR028", "error", acq.rel, acq.line, 0,
                    f"lock-order cycle: acquiring {b} while holding {a} "
                    f"closes the cycle {' -> '.join(cyc)} — deadlock "
                    f"when two threads interleave the orders"))

    def _check_blocking(self) -> None:
        for fid in sorted(self.summaries):
            if "utest" in fid:
                continue
            s = self.summaries[fid]
            for blk in s.blocking:
                labels = blk.held or frozenset(self.may.get(fid, ()))
                if not labels:
                    continue
                lbl = sorted(labels)[0]
                via = ""
                if not blk.held:
                    w = self.may_via.get(fid)
                    if w:
                        via = f" (lock held by caller — via {w[0]}:{w[1]})"
                self.raw.append(Finding(
                    "LMR029", "error", blk.rel, blk.line, 0,
                    f"{blk.desc} while {lbl} is held{via} — blocking "
                    f"work under an in-process lock convoys every "
                    f"waiter; snapshot under the lock, block outside"))

    def _check_publish(self) -> None:
        for site in self.tg.spawns:
            if site.via != "thread":
                continue
            fi = self.g.functions.get(site.spawner)
            if fi is None or "utest" in fi.qual:
                continue
            call = None
            for n in _own_nodes(fi):
                if isinstance(n, ast.Call) and n.lineno == site.line:
                    c = _chain(n.func)
                    if c and c[-1] == "Thread":
                        call = n
                        break
            if call is None:
                continue
            shared = self._shared_names(fi, call, site)
            if not shared:
                continue
            mutable = set()
            for n in _own_nodes(fi):
                if isinstance(n, ast.Assign) and n.lineno <= site.line \
                        and len(n.targets) == 1 \
                        and isinstance(n.targets[0], ast.Name) \
                        and self._is_mutable_ctor(n.value):
                    mutable.add(n.targets[0].id)
            hot = shared & mutable
            if not hot:
                continue
            syncs = sorted(c.lineno for c in _r._calls(list(fi.node.body))
                           if (_chain(c.func) or ("",))[-1] in _SYNC_CALLS)
            for n in _own_nodes(fi):
                if isinstance(n, ast.Name) and n.id in hot \
                        and isinstance(n.ctx, ast.Load) \
                        and n.lineno > site.line \
                        and not any(site.line < ln <= n.lineno
                                    for ln in syncs):
                    self.raw.append(Finding(
                        "LMR030", "warning", fi.rel, n.lineno, 0,
                        f"reading {n.id!r} after publishing it to the "
                        f"thread spawned at line {site.line} with no "
                        f"join/wait/queue hand-off — the reader sees an "
                        f"arbitrary prefix of the writer's work"))

    def _shared_names(self, fi: FunctionInfo, call: ast.Call,
                      site) -> Set[str]:
        names: Set[str] = set()
        target = None
        for kw in call.keywords:
            if kw.arg == "target":
                target = kw.value
            elif kw.arg == "args" and isinstance(kw.value,
                                                 (ast.Tuple, ast.List)):
                for el in kw.value.elts:
                    if isinstance(el, ast.Name):
                        names.add(el.id)
        if isinstance(target, ast.Lambda):
            names.update(n.id for n in ast.walk(target.body)
                         if isinstance(n, ast.Name))
        elif site.entry and site.entry in self.g.functions:
            entry = self.g.functions[site.entry]
            if entry.qual.startswith(fi.qual + "."):    # nested closure
                names.update(n.id for n in ast.walk(entry.node)
                             if isinstance(n, ast.Name))
        return names

    @staticmethod
    def _is_mutable_ctor(value: ast.AST) -> bool:
        if isinstance(value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                              ast.DictComp, ast.SetComp)):
            return True
        if isinstance(value, ast.Call):
            c = _chain(value.func)
            return bool(c) and c[-1] in ("list", "dict", "set", "deque",
                                         "defaultdict", "bytearray")
        return False


# -- per-function summary -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FieldAccess:
    ident: Tuple[str, str]   # (rel, Cls) owning-class identity
    attr: str
    kind: str                # "read" | "write" | "mutate"
    rel: str
    line: int
    fid: str
    locks: FrozenSet[str]    # intra-procedurally held at the access
    in_init: bool


@dataclasses.dataclass(frozen=True)
class Acq:
    label: str
    rel: str
    line: int
    held_before: Tuple[str, ...]
    fid: str


@dataclasses.dataclass(frozen=True)
class BlockingCall:
    rel: str
    line: int
    desc: str
    held: FrozenSet[str]
    fid: str


class _FnSummary:
    def __init__(self, pass_: _Pass, fi: FunctionInfo):
        self.p = pass_
        self.fi = fi
        self.acquisitions: List[Acq] = []
        self.accesses: List[FieldAccess] = []
        self.blocking: List[BlockingCall] = []
        self.call_held_must: Dict[int, FrozenSet[str]] = {}
        self.call_held_may: Dict[int, FrozenSet[str]] = {}
        self._locals = {name: self.p.class_ident(fi.rel, cls)
                        for name, cls in _local_ctor_types(fi).items()}
        # module-level code and utest harnesses are single-threaded
        # callers: they contribute call edges but not field groups
        self._track_fields = fi.cls is not None or fi.qual != "<module>"
        if "utest" in fi.qual or fi.qual == "<module>":
            self._track_fields = False

    def run(self) -> None:
        self._walk(list(self.fi.node.body), ())

    def _walk(self, stmts: Sequence[ast.AST], held: Tuple[str, ...]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, (ast.With, ast.AsyncWith)):
                new = list(held)
                for item in st.items:
                    self._expr(item.context_expr, tuple(new))
                    lbl = self.p.resolve_lock(self.fi, item.context_expr)
                    if lbl:
                        self.acquisitions.append(Acq(
                            lbl, self.fi.rel, st.lineno, tuple(new),
                            self.fi.fid))
                        new.append(lbl)
                self._walk(st.body, tuple(new))
                continue
            for c in ast.iter_child_nodes(st):
                if not isinstance(c, ast.stmt):
                    self._expr(c, held)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if isinstance(sub, list) and sub \
                        and isinstance(sub[0], ast.stmt):
                    self._walk(sub, held)
            for h in getattr(st, "handlers", ()):
                self._walk(h.body, held)

    # -- expression scan ------------------------------------------------------

    def _expr(self, node: ast.AST, held: Tuple[str, ...]) -> None:
        if isinstance(node, ast.Lambda):
            return                       # deferred execution
        if isinstance(node, ast.Call):
            self._call(node, held)
            return
        if isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            self._field(node.value, "mutate", node, held)
            self._expr(node.slice, held)
            return
        if isinstance(node, ast.Attribute):
            if isinstance(node.ctx, ast.Store):
                kind = "write"
            elif isinstance(node.ctx, ast.Del):
                kind = "mutate"
            else:
                kind = "read"
            if not self._field(node, kind, node, held):
                self._expr(node.value, held)
            return
        for c in ast.iter_child_nodes(node):
            if not isinstance(c, ast.stmt):
                self._expr(c, held)

    def _call(self, node: ast.Call, held: Tuple[str, ...]) -> None:
        hs = frozenset(held)
        line = node.lineno
        if line in self.call_held_must:
            self.call_held_must[line] &= hs
            self.call_held_may[line] |= hs
        else:
            self.call_held_must[line] = hs
            self.call_held_may[line] = hs
        c = _chain(node.func)
        desc = None
        if c:
            if c == ("time", "sleep"):
                desc = "time.sleep()"
            elif len(c) >= 2 and c[-1] in _BLOCKING_CALLS and c[0] != "os" \
                    and not (len(c) == 2 and c[0] in ("self", "cls")):
                desc = f"store/RPC call {'.'.join(c)}()"
            elif len(c) == 1 and c[0] in self.fi.params:
                desc = f"call to parameter {c[0]!r} (injected callback)"
            elif len(c) == 2 and c[0] == "self" and self.fi.cls \
                    and c[1] in self.p.ctor_params.get(
                        (self.fi.rel, self.fi.cls), ()) \
                    and "clock" not in c[1].lower() \
                    and "now" not in c[1].lower():
                # injected clocks are exempt: LMR010 makes every clock
                # injectable repo-wide, and a clock read is a pure,
                # bounded callback — not a reentrancy/IO hazard
                desc = f"constructor-injected callback self.{c[1]}()"
        if desc:
            self.blocking.append(BlockingCall(self.fi.rel, line, desc, hs,
                                              self.fi.fid))
        f = node.func
        if isinstance(f, ast.Attribute):
            if f.attr in _MUTATORS:
                if not self._field(f.value, "mutate", f, held):
                    self._expr(f.value, held)
            else:
                self._expr(f.value, held)
        else:
            self._expr(f, held)
        for a in node.args:
            self._expr(a, held)
        for kw in node.keywords:
            self._expr(kw.value, held)

    def _field(self, expr: ast.AST, kind: str, anchor: ast.AST,
               held: Tuple[str, ...]) -> bool:
        if not self._track_fields:
            return False
        c = _chain(expr)
        if not c:
            return False
        fi = self.fi
        ident: Optional[Tuple[str, str]] = None
        attr: Optional[str] = None
        if len(c) == 2 and c[0] == "self" and fi.cls:
            ident, attr = (fi.rel, fi.cls), c[1]
        elif len(c) == 3 and c[0] == "self" and fi.cls:
            ident = self.p.attr_types.get((fi.rel, fi.cls), {}).get(c[1])
            attr = c[2]
        elif len(c) == 2:
            ident = self._locals.get(c[0])
            attr = c[1]
        if ident is None or attr is None:
            return False
        if attr in self.p.lock_attrs.get(ident, ()):
            return False                 # the lock itself, not a field
        self.accesses.append(FieldAccess(
            ident, attr, kind, fi.rel, getattr(anchor, "lineno", fi.lineno),
            fi.fid, frozenset(held), fi.name == "__init__"))
        return True


# -- entry points ---------------------------------------------------------


@dataclasses.dataclass
class ConcResult:
    findings: List[Finding]              # post-suppression
    raw: List[Finding]                   # pre-suppression (audit input)
    graph: CallGraph
    tgraph: ThreadGraph
    locks: Dict[str, LockInfo]
    order_edges: List[Tuple[str, str]]
    edges_gen: List[Tuple[str, str]]     # interface fan-out included
    cycles: List[List[str]]
    wall_s: float


def analyze_conc(paths: Optional[Sequence[str]] = None,
                 baseline: Optional[str] = None,
                 graph: Optional[CallGraph] = None,
                 tgraph: Optional[ThreadGraph] = None) -> ConcResult:
    """The full concurrency pass: locks, summaries, propagation, order
    graph, LMR026-030, suppression — one call."""
    t0 = time.perf_counter()
    if graph is None:
        graph = build_callgraph(paths)
    if tgraph is None:
        tgraph = build_thread_graph(graph)
    p = _Pass(graph, tgraph)
    p.discover()
    p.summarize()
    p.propagate()
    p.order_graph()
    p.check()
    best: Dict[tuple, Finding] = {}
    for f in p.raw:
        best.setdefault(f.key(), f)
    raw = sorted(best.values(), key=Finding.key)
    base = load_baseline(baseline)
    out = []
    for f in raw:
        m = graph.modules.get(f.path)
        if m is not None and f.rule in _line_disables_in(m.lines, f.line):
            continue
        if any(_baseline_match(e, f) for e in base):
            continue
        out.append(f)
    return ConcResult(out, raw, graph, tgraph, p.locks,
                      sorted(p.order_edges),
                      sorted(p.edges_gen | set(p.order_edges)),
                      sorted(p.sccs), time.perf_counter() - t0)


def run_conc(paths: Optional[Sequence[str]] = None,
             baseline: Optional[str] = None) -> List[Finding]:
    """Conc findings surviving suppression — the CLI/gate entry point."""
    return analyze_conc(paths, baseline).findings


def conc_rule_catalog() -> List[Dict[str, object]]:
    return [{"id": r.id, "severity": r.severity, "title": r.title,
             "rationale": r.rationale, "paths": list(r.paths) or ["<all>"]}
            for r in CONC_RULES]


def static_lock_model(res: Optional[ConcResult] = None) -> dict:
    """The runtime sanitizer's ground truth: creation-site -> label for
    every real Lock/RLock (Conditions wrap internal stdlib locks the
    watchdog never sees; synthesized labels have no site), the distinct-
    label order edges, and the labels on any static cycle."""
    if res is None:
        res = analyze_conc()
    sites = {f"{L.rel}:{L.line}": L.label for L in res.locks.values()
             if L.line > 0 and L.kind in ("lock", "rlock")}
    return {"locks": sites,
            "edges": sorted([a, b] for a, b in res.edges_gen),
            "cyclic": sorted({lbl for comp in res.cycles for lbl in comp})}


# -- seeded races (the protocol checker's discipline, applied here) ----------

KNOWN_RACES: Dict[str, Tuple[str, str, str]] = {
    # name -> (rel, expected rule, source)
    "dropped-lock-write": ("engine/fx_ledger.py", "LMR026", (
        "import threading\n"
        "class Ledger:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.total = 0\n"
        "    def start(self):\n"
        "        threading.Thread(target=self.add, daemon=True).start()\n"
        "    def add(self):\n"
        "        with self._lock:\n"
        "            self.total += 1\n"
        "    def drain(self):\n"
        "        out = self.total\n"
        "        self.total = 0\n"
        "        return out\n"
    )),
    "abba-deadlock": ("engine/fx_pair.py", "LMR028", (
        "import threading\n"
        "class Pair:\n"
        "    def __init__(self):\n"
        "        self._a_lock = threading.Lock()\n"
        "        self._b_lock = threading.Lock()\n"
        "        self.n = 0\n"
        "    def ab(self):\n"
        "        with self._a_lock:\n"
        "            with self._b_lock:\n"
        "                self.n += 1\n"
        "    def ba(self):\n"
        "        with self._b_lock:\n"
        "            self._steal()\n"
        "    def _steal(self):\n"
        "        with self._a_lock:\n"
        "            self.n -= 1\n"
    )),
}


def find_seeded(name: str) -> List[Finding]:
    """Run the pass on one seeded-race fixture; the expected rule's
    findings (the conc gate fails when this comes back empty — a pass
    that stops seeing a planted race has quietly lost its teeth)."""
    rel, rule, src = KNOWN_RACES[name]
    g = CallGraph.from_sources([(rel, src)])
    res = analyze_conc(graph=g, baseline="/nonexistent")
    return [f for f in res.findings if f.rule == rule]


def _fx(*files: Tuple[str, str]) -> ConcResult:
    g = CallGraph.from_sources(list(files))
    return analyze_conc(graph=g, baseline="/nonexistent")


def utest() -> None:
    """Self-test: each rule fires on its fixture and stays quiet on the
    clean twin, both seeded races re-find, suppression works, and the
    real package analyzes clean inside the wall budget."""
    # LMR026 via the seeded fixture; the unguarded-everywhere twin and
    # the queue-handoff twin stay quiet (no guard anywhere = not this
    # band's business; join-before-read = proper hand-off)
    hits = find_seeded("dropped-lock-write")
    assert hits and all(f.rule == "LMR026" for f in hits), hits
    assert any(f.line == 13 for f in hits), hits   # self.total = 0
    quiet = _fx(("engine/fx_solo.py", (
        "import threading\n"
        "class Solo:\n"
        "    def __init__(self):\n"
        "        self.v = 0\n"
        "    def start(self):\n"
        "        threading.Thread(target=self.bump, daemon=True).start()\n"
        "    def bump(self):\n"
        "        self.v += 1\n"
    )))
    assert not [f for f in quiet.findings if f.rule == "LMR026"], \
        quiet.findings

    # LMR027: one field, two disjoint guards, two thread roots
    mix = _fx(("engine/fx_mix.py", (
        "import threading\n"
        "class Mix:\n"
        "    def __init__(self):\n"
        "        self._a_lock = threading.Lock()\n"
        "        self._b_lock = threading.Lock()\n"
        "        self.q = 0\n"
        "    def start(self):\n"
        "        threading.Thread(target=self.w1, daemon=True).start()\n"
        "    def w1(self):\n"
        "        with self._a_lock:\n"
        "            self.q += 1\n"
        "    def w2(self):\n"
        "        with self._b_lock:\n"
        "            self.q -= 1\n"
    )))
    assert any(f.rule == "LMR027" for f in mix.findings), mix.findings
    consistent = _fx(("engine/fx_ok.py", (
        "import threading\n"
        "class Ok:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.q = 0\n"
        "    def start(self):\n"
        "        threading.Thread(target=self.w1, daemon=True).start()\n"
        "    def w1(self):\n"
        "        with self._lock:\n"
        "            self.q += 1\n"
        "    def w2(self):\n"
        "        with self._lock:\n"
        "            self.q -= 1\n"
    )))
    assert not [f for f in consistent.findings
                if f.rule in ("LMR026", "LMR027")], consistent.findings

    # LMR028: the seeded ABBA cycle (interprocedural — ba holds B and
    # takes A one call deep), plus module-lock re-acquisition; the
    # consistently-ordered twin stays quiet
    hits = find_seeded("abba-deadlock")
    assert hits and all(f.rule == "LMR028" for f in hits), hits
    re_acq = _fx(("engine/fx_re.py", (
        "import threading\n"
        "_lock = threading.Lock()\n"
        "def a():\n"
        "    with _lock:\n"
        "        b()\n"
        "def b():\n"
        "    with _lock:\n"
        "        pass\n"
    )))
    assert any(f.rule == "LMR028" and f.line == 7
               for f in re_acq.findings), re_acq.findings
    ordered = _fx(("engine/fx_ord.py", (
        "import threading\n"
        "class P:\n"
        "    def __init__(self):\n"
        "        self._a_lock = threading.Lock()\n"
        "        self._b_lock = threading.Lock()\n"
        "    def ab(self):\n"
        "        with self._a_lock:\n"
        "            with self._b_lock:\n"
        "                pass\n"
        "    def ab2(self):\n"
        "        with self._a_lock:\n"
        "            self._inner()\n"
        "    def _inner(self):\n"
        "        with self._b_lock:\n"
        "            pass\n"
    )))
    assert not [f for f in ordered.findings if f.rule == "LMR028"], \
        ordered.findings

    # LMR029: store IO under the lock (direct AND one call deep); the
    # hoisted twin stays quiet
    io = _fx(("engine/fx_io.py", (
        "import threading\n"
        "class Sink:\n"
        "    def __init__(self, store):\n"
        "        self._lock = threading.Lock()\n"
        "        self.store = store\n"
        "    def flush(self, name):\n"
        "        with self._lock:\n"
        "            return self.store.read_range(name, 0, 10)\n"
        "    def flush2(self, name):\n"
        "        with self._lock:\n"
        "            self._emit(name)\n"
        "    def _emit(self, name):\n"
        "        return self.store.read_range(name, 0, 10)\n"
    )))
    got = [f for f in io.findings if f.rule == "LMR029"]
    assert {f.line for f in got} == {8, 13}, io.findings
    hoisted = _fx(("engine/fx_ho.py", (
        "import threading\n"
        "class Sink:\n"
        "    def __init__(self, store):\n"
        "        self._lock = threading.Lock()\n"
        "        self.store = store\n"
        "        self.cache = None\n"
        "    def flush(self, name):\n"
        "        data = self.store.read_range(name, 0, 10)\n"
        "        with self._lock:\n"
        "            self.cache = data\n"
    )))
    assert not [f for f in hoisted.findings if f.rule == "LMR029"], \
        hoisted.findings
    # constructor-injected callback called under the lock
    cb = _fx(("engine/fx_cb.py", (
        "import threading\n"
        "class Sup:\n"
        "    def __init__(self, spawn):\n"
        "        self._lock = threading.Lock()\n"
        "        self.spawn = spawn\n"
        "    def grow(self):\n"
        "        with self._lock:\n"
        "            return self.spawn(1)\n"
    )))
    assert any(f.rule == "LMR029" and f.line == 8
               for f in cb.findings), cb.findings

    # LMR030: publish-without-handoff fires; the joined twin is quiet
    pub = _fx(("engine/fx_pub.py", (
        "import threading\n"
        "def run():\n"
        "    box = []\n"
        "    def fill():\n"
        "        box.append(1)\n"
        "    t = threading.Thread(target=fill)\n"
        "    t.start()\n"
        "    return box[0]\n"
    )))
    assert any(f.rule == "LMR030" and f.line == 8
               for f in pub.findings), pub.findings
    joined = _fx(("engine/fx_j.py", (
        "import threading\n"
        "def run():\n"
        "    box = []\n"
        "    def fill():\n"
        "        box.append(1)\n"
        "    t = threading.Thread(target=fill)\n"
        "    t.start()\n"
        "    t.join()\n"
        "    return box[0]\n"
    )))
    assert not [f for f in joined.findings if f.rule == "LMR030"], \
        joined.findings

    # inline suppression holds for conc findings too
    rel, _rule, src = KNOWN_RACES["dropped-lock-write"]
    sup = _fx((rel, src.replace(
        "        self.total = 0\n",
        "        self.total = 0  # lmr: disable=LMR026\n")))
    assert not [f for f in sup.findings if f.rule == "LMR026"], sup.findings

    # the real package: clean, deadlock-free, inside the wall budget,
    # with the known lock plane discovered and the model exportable
    res = analyze_conc()
    assert res.wall_s < 30.0, res.wall_s
    assert "trace/span.py::Tracer._lock" in res.locks, sorted(res.locks)
    assert "engine/push.py::BufferPool._lock" in res.locks
    assert res.findings == [], [str(f.__dict__) for f in res.findings[:8]]
    assert not any(len(c) > 1 for c in res.cycles), res.cycles
    model = static_lock_model(res)
    assert model["locks"] and not model["cyclic"], model
    assert all(":" in site for site in model["locks"])
    print("lockset utest ok")
