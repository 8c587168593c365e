"""The rule registry: every framework contract the lint pass enforces.

Each rule is one class (id, severity, title, rationale, path scope,
``check``).  The ids are stable — suppressions and the DESIGN §18
catalog reference them — and new rules append, never renumber.

Known analysis limits (deliberate: simple, predictable checks beat a
dataflow engine that nobody can audit):

- scope is one function at a time; a helper *called* under a lock is
  not re-checked inside the locked region (helpers that themselves
  misbehave are caught when their own body is linted);
- ``self.x = builder`` hands ownership to the object (the wrapper class
  is expected to expose/forward ``close``, as SegmentWriter does).

Copy of the JAX package's ``analysis/rules.py``. One rule changes its
target: LMR007 keeps its id, severity and intent (no host side effects
in code that runs once to be recorded), but what records a function
here is a CUDA-graph capture (``graphs.CapturedGraph``, ``graphs.scan``,
a ``torch.cuda.graph`` block) or an fx trace (``make_fx``), in the
directories where those functions live.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List, Optional, Sequence, Set, Tuple

from lua_mapreduce_tpu_torch.analysis.lint import FileContext, Finding, Rule

# --- shared AST helpers ----------------------------------------------------


def _chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """Dotted-name parts of a Name/Attribute expr ('a.b.c' → (a, b, c))."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


_SCOPE_BARRIERS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                   ast.Lambda)


def _own_walk(nodes: Sequence[ast.AST]) -> Iterable[ast.AST]:
    """Walk ``nodes`` without entering nested function/class scopes —
    one scope's own statements only (nested scopes are analyzed as
    their own _scopes entries)."""
    stack = list(nodes)
    while stack:
        n = stack.pop()
        if isinstance(n, _SCOPE_BARRIERS):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _scopes(tree: ast.Module):
    """(scope_node, body) for the module and every function, nested
    included — each analyzed independently."""
    yield tree, tree.body
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield n, n.body


def _parent_map(body: Sequence[ast.AST]) -> dict:
    par = {}
    for n in _own_walk(body):
        for c in ast.iter_child_nodes(n):
            par[c] = n
    return par


def _calls(body: Sequence[ast.AST]) -> Iterable[ast.Call]:
    for n in _own_walk(body):
        if isinstance(n, ast.Call):
            yield n


def _is_flock_ctor(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Call):
        c = _chain(expr.func)
        return bool(c) and c[-1] == "_FLock"
    return False


def _is_lock_expr(expr: ast.AST) -> bool:
    """A with-context that holds a lock: ``_FLock(...)`` or a dotted
    name whose last part mentions 'lock' (self._lock, _rounds_lock)."""
    if _is_flock_ctor(expr):
        return True
    c = _chain(expr)
    return bool(c) and "lock" in c[-1].lower()


def _locked_regions(body: Sequence[ast.AST]):
    """Locked critical sections in one function body.

    Yields ``(kind, lock_node, stmts)`` where kind is:
      - "lock":  a ``with <lock>:`` block (memory lock or _FLock);
      - "index": everything after ``fd = self._open_locked(...)`` —
        the idx engine's open/flock/operate/close discipline (the
        region runs to the end of the enclosing block, which is how
        the ``try: ... finally: os.close(fd)`` pattern is written).
    """
    for n in _own_walk(body):
        if isinstance(n, (ast.With, ast.AsyncWith)):
            if any(_is_lock_expr(i.context_expr) for i in n.items):
                yield "lock", n, n.body
    # index regions: the function's own statement list plus every
    # nested one (try/if/for bodies)
    lists = [list(body)]
    for n in _own_walk(body):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(n, field, None)
            if isinstance(stmts, list) and stmts:
                lists.append(stmts)
    for stmts in lists:
        for i, s in enumerate(stmts):
            if isinstance(s, ast.Assign) and isinstance(s.value, ast.Call):
                c = _chain(s.value.func)
                if c and c[-1] == "_open_locked":
                    yield "index", s, stmts[i + 1:]


# --- LMR001: builder / writer lifecycle ------------------------------------

_BUILDER_CTORS = {"writer_for", "SegmentWriter", "TextWriter"}


class BuilderLifecycleRule(Rule):
    id = "LMR001"
    severity = "error"
    title = "builders must be closed on all paths"
    rationale = (
        "A FileBuilder left unbuilt (failed user code, a raise between "
        "creation and build) holds a writer thread, an fd, and a .tmp. "
        "file; on a long-lived elastic worker those leak per retry. "
        "Every store.builder()/writer_for()/SegmentWriter/TextWriter "
        "bound to a name needs a with-block, or a finally/except that "
        "calls .close() on it (directly, or looping a container it was "
        "stored into). Passing the fresh builder straight into a "
        "wrapper call or returning it transfers ownership.")

    @staticmethod
    def _is_creation(call: ast.Call) -> bool:
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr == "builder" and not call.args
                and not call.keywords):
            return True
        c = _chain(call.func)
        return bool(c) and c[-1] in _BUILDER_CTORS

    @staticmethod
    def _closers(body: Sequence[ast.AST]) -> Set[str]:
        """Names reliably closed in this scope: with-blocks on the name,
        and .close() calls inside finally/except bodies (including the
        for-each-over-container form)."""
        closed: Set[str] = set()

        def scan(stmts):
            for n in _own_walk(stmts):
                if isinstance(n, ast.Call) and isinstance(
                        n.func, ast.Attribute) and n.func.attr == "close":
                    c = _chain(n.func.value)
                    if c:
                        closed.add(c[0])
                elif isinstance(n, ast.For):
                    it = n.iter
                    if isinstance(it, ast.Call) and isinstance(
                            it.func, ast.Attribute) \
                            and it.func.attr in ("values", "items"):
                        it = it.func.value
                    c = _chain(it)
                    if c and isinstance(n.target, ast.Name):
                        for m in _own_walk(n.body):
                            if (isinstance(m, ast.Call)
                                    and isinstance(m.func, ast.Attribute)
                                    and m.func.attr == "close"
                                    and isinstance(m.func.value, ast.Name)
                                    and m.func.value.id == n.target.id):
                                closed.add(c[0])

        for n in _own_walk(body):
            if isinstance(n, (ast.With, ast.AsyncWith)):
                for item in n.items:
                    c = _chain(item.context_expr)
                    if c and len(c) == 1:
                        closed.add(c[0])
            elif isinstance(n, ast.Try):
                if n.finalbody:
                    scan(n.finalbody)
                for h in n.handlers:
                    scan(h.body)
        return closed

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for _scope, body in _scopes(ctx.tree):
            par = _parent_map(body)
            closed = self._closers(body)
            for call in _calls(body):
                if not self._is_creation(call):
                    continue
                p = par.get(call)
                if isinstance(p, ast.withitem):
                    continue                      # with store.builder() as b
                if isinstance(p, (ast.Call, ast.keyword, ast.Return)):
                    continue                      # ownership transferred
                if isinstance(p, (ast.Assign, ast.NamedExpr)):
                    targets = (p.targets if isinstance(p, ast.Assign)
                               else [p.target])
                    names: Set[str] = set()
                    owned_by_object = False
                    for t in targets:
                        if isinstance(t, ast.Name):
                            names.add(t.id)
                        elif isinstance(t, ast.Subscript):
                            c = _chain(t.value)
                            if c:
                                names.add(c[0])
                        elif isinstance(t, ast.Attribute):
                            owned_by_object = True
                    if owned_by_object or names & closed:
                        continue
                    yield self.finding(
                        ctx, call,
                        f"builder bound to {sorted(names) or '<target>'} "
                        "is never closed on failure paths — use a "
                        "with-block or close it in a finally")
                else:
                    yield self.finding(
                        ctx, call,
                        "builder created and dropped — bind it and close "
                        "it, or pass it directly to its owner")


# --- LMR002: no foreign IO / callbacks under the index flock ---------------

_IDX_OS_ALLOWED = {"read", "write", "lseek", "close", "fstat", "pread",
                   "pwrite"}
_IDX_DENY_ROOTS = {"json", "tempfile", "subprocess", "shutil", "socket",
                   "urllib", "requests", "glob"}


class IndexFlockIORule(Rule):
    id = "LMR002"
    severity = "error"
    title = "no foreign IO or user callbacks under the index flock"
    rationale = (
        "The job index flock serializes every claim/commit in the "
        "cluster. Anything but fd-local record IO inside it — opening "
        "other files, JSON (de)serialization of payloads, store reads, "
        "user callbacks — multiplies the critical section by an "
        "unbounded cost and can deadlock against the payload path. "
        "Payload/manifest IO belongs before the lock (insert) or after "
        "release (claim's doc build), which is how filestore.py is "
        "structured.")
    paths = ("coord/",)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for scope, body in _scopes(ctx.tree):
            params: Set[str] = set()
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = scope.args
                params = {x.arg for x in (a.posonlyargs + a.args
                                          + a.kwonlyargs)} - {"self", "cls"}
            for kind, _node, stmts in _locked_regions(body):
                if kind != "index":
                    continue
                for call in _calls(stmts):
                    c = _chain(call.func)
                    if not c:
                        continue
                    if c[0] in ("open", "print", "input") and len(c) == 1:
                        yield self.finding(
                            ctx, call, f"{c[0]}() under the index flock")
                    elif c[0] in _IDX_DENY_ROOTS:
                        yield self.finding(
                            ctx, call,
                            f"{'.'.join(c)} under the index flock — do "
                            "payload/manifest IO outside the lock")
                    elif (c[0] == "os" and len(c) > 1
                          and c[1] not in _IDX_OS_ALLOWED
                          and c[1] != "path"):
                        yield self.finding(
                            ctx, call,
                            f"os.{c[1]} under the index flock (only "
                            "fd-local record IO is allowed)")
                    elif len(c) == 1 and c[0] in params:
                        yield self.finding(
                            ctx, call,
                            f"call to parameter {c[0]!r} under the index "
                            "flock — user callbacks must never run "
                            "inside the lock")


# --- LMR003: single lock-acquisition order ---------------------------------

_LOCKING_METHODS = {"_bump", "round_counts", "_open_locked"}


class LockOrderRule(Rule):
    id = "LMR003"
    severity = "error"
    title = "no second lock while holding one"
    rationale = (
        "The coordination plane has exactly one safe order: take ONE "
        "lock, operate, release. Acquiring a second lock (another "
        "_FLock, the index flock, the instance lock, or a method that "
        "takes the class-level rounds lock, like _bump) while holding "
        "one creates an AB/BA deadlock the churn tests can only find "
        "by luck.")
    paths = ("coord/",)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for _scope, body in _scopes(ctx.tree):
            for _kind, _node, stmts in _locked_regions(body):
                for n in _own_walk(stmts):
                    if isinstance(n, (ast.With, ast.AsyncWith)):
                        for item in n.items:
                            if _is_lock_expr(item.context_expr):
                                yield self.finding(
                                    ctx, n, "nested lock acquisition "
                                    "inside a locked region")
                    elif isinstance(n, ast.Call):
                        c = _chain(n.func)
                        if not c:
                            continue
                        if c[-1] == "_FLock" or (
                                c[0] == "fcntl" and len(c) > 1
                                and c[1] == "flock"):
                            yield self.finding(
                                ctx, n, f"{'.'.join(c)} acquired inside "
                                "a locked region")
                        elif c[-1] in _LOCKING_METHODS and len(c) > 1:
                            yield self.finding(
                                ctx, n,
                                f"{'.'.join(c)}() takes another lock — "
                                "call it before or after the critical "
                                "section")
                        elif c[-1] == "acquire":
                            yield self.finding(
                                ctx, n, "explicit .acquire() inside a "
                                "locked region")


# --- LMR004: no wall-clock reads under a coordination lock -----------------

_CLOCK_CALLS = {"time", "monotonic", "time_ns", "perf_counter"}


class WallclockUnderLockRule(Rule):
    id = "LMR004"
    severity = "error"
    title = "no time.time() inside a locked critical section"
    rationale = (
        "Lease math (claim stamps, heartbeats, staleness cutoffs) must "
        "use a timestamp decided BEFORE the lock: a wall-clock read "
        "inside the critical section moves with lock contention, so "
        "two runs of the same protocol order events differently — and "
        "it grows the hold time of the hottest lock in the system. "
        "Hoist ``now = time.time()`` above the acquisition (the index "
        "engines take ``now`` as an argument for exactly this reason).")
    paths = ("coord/",)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for _scope, body in _scopes(ctx.tree):
            for _kind, _node, stmts in _locked_regions(body):
                for call in _calls(stmts):
                    c = _chain(call.func)
                    if (c and len(c) == 2 and c[0] == "time"
                            and c[1] in _CLOCK_CALLS):
                        yield self.finding(
                            ctx, call,
                            f"{'.'.join(c)}() under a coordination lock "
                            "— hoist the clock read above the lock")


# --- LMR005: swallow-except hygiene ----------------------------------------

_LOG_ATTRS = {"warning", "error", "exception", "critical", "info", "debug",
              "log", "warn", "print_exc", "_exit", "exit"}


class SwallowExceptRule(Rule):
    id = "LMR005"
    severity = "error"
    title = "bare/BaseException handlers must re-raise or log"
    rationale = (
        "A handler that catches everything (bare except / "
        "BaseException) and neither re-raises nor logs erases the real "
        "failure — the async-writer and checkpoint threads have both "
        "shipped bugs where the worker's actual exception context "
        "vanished. Catch narrowly, or record what you swallowed. "
        "(``except Exception`` on a best-effort sweep path is allowed; "
        "this rule is about the catch-alls that also eat SystemExit/"
        "KeyboardInterrupt.)")

    @staticmethod
    def _catches_everything(h: ast.ExceptHandler) -> bool:
        if h.type is None:
            return True
        types = (h.type.elts if isinstance(h.type, ast.Tuple) else [h.type])
        for t in types:
            c = _chain(t)
            if c and c[-1] == "BaseException":
                return True
        return False

    @staticmethod
    def _handles(body: Sequence[ast.AST]) -> bool:
        for n in _own_walk(body):
            if isinstance(n, ast.Raise):
                return True
            if isinstance(n, ast.Call):
                c = _chain(n.func)
                if not c:
                    continue
                if c[-1] in _LOG_ATTRS or c[0] in ("print", "log"):
                    return True
        return False

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for n in ast.walk(ctx.tree):
            if isinstance(n, ast.ExceptHandler) \
                    and self._catches_everything(n) \
                    and not self._handles(n.body):
                yield self.finding(
                    ctx, n, "catch-all handler swallows the exception — "
                    "re-raise, log it, or narrow the except")


# --- LMR006: raw-bytes store contract --------------------------------------

class RawBytesContractRule(Rule):
    id = "LMR006"
    severity = "error"
    title = "read_range/size come in pairs; shims are latin-1"
    rationale = (
        "The v2 segment reader locates the trailer with size() and "
        "pulls frames with read_range(); a Store that overrides one "
        "natively but inherits the other's O(file) text shim silently "
        "mixes byte spaces (native bytes vs latin-1-decoded text) and "
        "either corrupts frames or re-reads whole files per range. "
        "Implement both or neither. Inside write_bytes/read_range/size "
        "the only legal text bridge is latin-1 — utf-8 is not "
        "byte-transparent (DESIGN §17).")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.ClassDef):
                continue
            bases = {c[-1] for c in map(_chain, n.bases) if c}
            methods = {m.name: m for m in n.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            if any(b == "Store" or b.endswith("Store") for b in bases):
                have = {"read_range", "size"} & set(methods)
                if len(have) == 1:
                    (name,) = have
                    other = ({"read_range", "size"} - have).pop()
                    yield self.finding(
                        ctx, methods[name],
                        f"{n.name} overrides {name}() but not {other}() "
                        "— the raw-bytes surface is a pair")
            for mname in ("write_bytes", "read_range", "size"):
                m = methods.get(mname)
                if m is None:
                    continue
                for call in _calls(m.body):
                    if isinstance(call.func, ast.Attribute) \
                            and call.func.attr in ("encode", "decode") \
                            and call.args \
                            and isinstance(call.args[0], ast.Constant) \
                            and str(call.args[0].value).lower().replace(
                                "-", "") != "latin1":
                        yield self.finding(
                            ctx, call,
                            f"{mname}() bridges text with "
                            f"{call.args[0].value!r} — only latin-1 maps "
                            "bytes 0-255 losslessly")


# --- LMR009: spill publishes go through the replication helper -------------

# the unreplicated record-writer factories (core/segment.py). A spill
# producer constructing one of these directly publishes exactly ONE
# copy, whatever the negotiated replication factor says.
_PLAIN_SPILL_FACTORIES = {"writer_for", "SegmentWriter", "TextWriter"}

# literal shapes of the coded stripe plane (faults/coded.py, DESIGN
# §27): "^<i>.<t>^" block prefixes and the "^M^" manifest marker.
# Matched against the LITERAL text of a string (for f-strings, the
# concatenated constant parts: f"^{i}.{t}^{name}" reduces to "^.^") —
# the documented analysis limit: names assembled through .join()/
# concatenation of variables are out of reach, literal prefixes are
# the shape every real offender has.
_STRIPE_BLOCK_RE = re.compile(r"\^(?:\d+|\*)?\.?\^|\^(?:\d+|\*)\.")
_STRIPE_MANIFEST_MARKER = "^M^"
_CODED_HOME = "faults/coded.py"


def _docstring_consts(tree: ast.Module) -> Set[int]:
    """id()s of every docstring Constant — prose that legitimately
    spells stripe names when documenting them."""
    out: Set[int] = set()
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef))]
    for s in scopes:
        body = getattr(s, "body", None)
        if body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            out.add(id(body[0].value))
    return out


def _stripe_literals(ctx: FileContext):
    """(node, literal_text) for every non-docstring string literal or
    f-string in the file, literal parts concatenated (an f-string
    counts once as a whole — its part constants are not re-yielded)."""
    skip = _docstring_consts(ctx.tree)
    for n in ast.walk(ctx.tree):
        if isinstance(n, ast.JoinedStr):
            skip.update(id(v) for v in n.values)
    for n in ast.walk(ctx.tree):
        if id(n) in skip:
            continue
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            yield n, n.value
        elif isinstance(n, ast.JoinedStr):
            yield n, "".join(v.value for v in n.values
                             if isinstance(v, ast.Constant)
                             and isinstance(v.value, str))


class ReplicatedSpillRule(Rule):
    id = "LMR009"
    severity = "error"
    title = "engine spill publishes must use the replication helper"
    rationale = (
        "Every run/spill publish in engine/ must go through "
        "faults.replicate.spill_writer(store, format, replication): it "
        "is the one place the negotiated replication factor turns into "
        "an r-way fanout at the placement function's addresses "
        "(DESIGN §20). A raw writer_for()/SegmentWriter()/TextWriter() "
        "in a producer publishes a single copy — silently "
        "under-replicated, invisible until the one copy is lost and a "
        "map re-run pays for it. (Result-file publishes use the plain "
        "store builder and are exempt: final results are deliberately "
        "not replicated.) Coded corollary (DESIGN §27): a \"^i.t^\" "
        "stripe-block name spelled as a literal outside faults/coded.py "
        "is a publish (or read) that bypasses the codec — a hand-rolled "
        "block misses the stripe manifest's CRC/placement contract and "
        "the scavenger's repair accounting; only the coded module may "
        "mint block names.")
    paths = ("engine/", "faults/")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.rel.startswith("engine/"):
            for n in ast.walk(ctx.tree):
                if not isinstance(n, ast.Call):
                    continue
                c = _chain(n.func)
                if c and c[-1] in _PLAIN_SPILL_FACTORIES:
                    yield self.finding(
                        ctx, n,
                        f"{c[-1]}(...) in engine/ publishes a single "
                        "unreplicated copy — route the spill through "
                        "faults.replicate.spill_writer so the negotiated "
                        "replication factor applies")
        if ctx.rel != _CODED_HOME:
            for node, text in _stripe_literals(ctx):
                if _STRIPE_BLOCK_RE.search(text):
                    yield self.finding(
                        ctx, node,
                        "stripe-block name constructed directly "
                        f"({text!r}) — \"^i.t^\" blocks exist only "
                        "behind the coded codec's manifest/CRC/"
                        "placement contract; use the faults.coded "
                        "helpers (stripe_patterns for matching, "
                        "CodedStore/publish_stripe for I/O)")


# --- LMR008: classified raisables across the retry boundary ----------------

# the op surfaces the retry layer wraps (DESIGN §19): store data-plane
# ops and coord RPCs. Raises inside these methods cross the retry
# boundary, so the retry layer must be able to classify them.
_RETRY_BOUNDARY_METHODS = {
    # Store / FileBuilder surface
    "lines", "read_range", "size", "list", "exists", "remove", "build",
    "write", "write_bytes", "_put", "_get", "_drain", "_flush_async",
    # JobStore RPC surface
    "claim", "claim_batch", "commit_batch", "release_batch", "heartbeat",
    "heartbeat_batch", "set_job_status", "set_job_times", "counts",
    "scavenge", "requeue_stale", "get_task", "put_task", "update_task",
    "delete_task", "insert_jobs", "insert_error", "drain_errors",
}

# generic exception types the taxonomy cannot place: raising one of
# these across the boundary forces the retry layer to guess. (ValueError/
# KeyError/FileNotFoundError etc. are fine — the central table maps
# them; StoreError subclasses are the preferred currency.)
_UNCLASSIFIED_RAISES = {"Exception", "BaseException", "RuntimeError",
                        "OSError", "IOError", "EnvironmentError",
                        "SystemError"}


class ClassifiedRaiseRule(Rule):
    id = "LMR008"
    severity = "error"
    title = "store/coord op raises must be classified StoreError shapes"
    rationale = (
        "Every store op and coord RPC runs under the transient-fault "
        "retry layer (faults/retry.py). A generic RuntimeError/OSError "
        "raised across that boundary cannot be classified: the retry "
        "layer either retries a deterministic failure (wasted backoff, "
        "masked bug) or gives up on a transient one (spurious job "
        "release). Raise a StoreError subclass (TransientStoreError / "
        "PermanentStoreError / NativeIndexError / NoTaskError ...) or a "
        "builtin the taxonomy maps (FileNotFoundError, TimeoutError, "
        "ValueError for data errors).")
    paths = ("store/", "coord/")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for scope, body in _scopes(ctx.tree):
            if not isinstance(scope, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                continue
            if scope.name not in _RETRY_BOUNDARY_METHODS:
                continue
            for n in _own_walk(body):
                if not isinstance(n, ast.Raise) or n.exc is None:
                    continue
                exc = n.exc
                if isinstance(exc, ast.Call):
                    exc = exc.func
                c = _chain(exc)
                if c and c[-1] in _UNCLASSIFIED_RAISES:
                    yield self.finding(
                        ctx, n,
                        f"raise {c[-1]} inside retry-boundary op "
                        f"{scope.name}() — use a classified StoreError "
                        "subclass so the retry layer can route it")


# --- LMR007: purity of functions run once at graph capture -----------------

# calls whose first positional argument is a function the port runs ONCE
# to record it: a CUDA-graph capture (graphs.CapturedGraph, graphs.scan)
# or an fx trace (make_fx). ``torch.cuda.graph(...)`` with-blocks are the
# statement form of the same capture.
_CAPTURE_NAMES = {"CapturedGraph", "scan", "make_fx"}
_IMPURE_ROOTS = {("np", "random"), ("numpy", "random"), ("random",),
                 ("time",)}


def _is_capture_block(expr: ast.AST) -> bool:
    """A with-item that captures its block: ``torch.cuda.graph(...)``."""
    if not isinstance(expr, ast.Call):
        return False
    c = _chain(expr.func)
    return bool(c) and len(c) >= 2 and c[-2:] == ("cuda", "graph")


def capture_blocks(body: Sequence[ast.AST]) -> Iterable[ast.With]:
    """The ``with torch.cuda.graph(...)`` blocks of one scope."""
    for n in _own_walk(body):
        if isinstance(n, (ast.With, ast.AsyncWith)) and any(
                _is_capture_block(i.context_expr) for i in n.items):
            yield n


def _capture_targets(expr: ast.AST,
                     cls: Optional[str]) -> List[Tuple[Optional[str], str]]:
    """(owning class or None, name) of each function a capture argument
    names: a bare name, ``self.m``/``cls.m`` inside class ``cls``, or the
    callees of a lambda's body."""
    if isinstance(expr, ast.Lambda):
        return [t for n in ast.walk(expr.body) if isinstance(n, ast.Call)
                for t in _capture_targets(n.func, cls)]
    c = _chain(expr)
    if c and len(c) == 1:
        return [(None, c[0])]
    if c and len(c) == 2 and c[0] in ("self", "cls") and cls:
        return [(cls, c[1])]
    return []


def _defs_with_owner(tree: ast.AST, owner: Optional[str] = None):
    """(class name or None, def) for every function under ``tree``: a
    class's own methods carry the class, every other def (module level,
    nested) None."""
    for c in ast.iter_child_nodes(tree):
        if isinstance(c, ast.ClassDef):
            yield from _defs_with_owner(c, c.name)
        elif isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield owner, c
            yield from _defs_with_owner(c, None)
        else:
            yield from _defs_with_owner(c, owner)


def captured_defs(tree: ast.Module) -> List[ast.AST]:
    """Every def of the module that a capture runs: passed (first
    positional) to a capture call, or called inside a
    ``torch.cuda.graph`` block, resolved within the module."""
    targets: Set[Tuple[Optional[str], str]] = set()

    def visit(node, cls):
        for c in ast.iter_child_nodes(node):
            inner = c.name if isinstance(c, ast.ClassDef) else cls
            if isinstance(c, ast.Call):
                ch = _chain(c.func)
                if ch and ch[-1] in _CAPTURE_NAMES and c.args:
                    targets.update(_capture_targets(c.args[0], cls))
            elif isinstance(c, (ast.With, ast.AsyncWith)) and any(
                    _is_capture_block(i.context_expr) for i in c.items):
                for n in _own_walk(c.body):
                    if isinstance(n, ast.Call):
                        targets.update(_capture_targets(n.func, cls))
            visit(c, inner)

    visit(tree, None)
    return [fn for owner, fn in _defs_with_owner(tree)
            if (owner, fn.name) in targets]


class CapturePurityRule(Rule):
    id = "LMR007"
    severity = "error"
    title = "no host side effects inside captured functions"
    rationale = (
        "A function handed to a capture (graphs.CapturedGraph, "
        "graphs.scan, a torch.cuda.graph block, make_fx) runs its "
        "Python body ONCE, when the graph is recorded; every replay "
        "runs only the recorded kernels. A numpy/stdlib RNG draw "
        "becomes a constant baked into every replay, time.time() "
        "measures the capture, and print/open fire at capture, not at "
        "replay. Draw from an explicit torch.Generator, and pass host "
        "values in as arguments (static tensors the replay reads).")
    paths = ("engine/", "graphs.py", "models/", "parallel/", "train/")

    def _impure(self, ctx: FileContext, nodes: Iterable[ast.AST],
                where: str) -> Iterable[Finding]:
        for m in nodes:
            if not isinstance(m, ast.Call):
                continue
            c = _chain(m.func)
            if not c:
                continue
            if len(c) == 1 and c[0] in ("open", "input"):
                yield self.finding(ctx, m, f"{c[0]}() inside {where}")
            elif len(c) == 1 and c[0] == "print":
                yield self.finding(
                    ctx, m, f"print() inside {where} fires once at "
                    "capture time, not at replay — print outside the "
                    "capture")
            elif any(c[:len(root)] == root for root in _IMPURE_ROOTS):
                yield self.finding(
                    ctx, m, f"{'.'.join(c)} inside {where} is evaluated "
                    "once at capture time — draw from an explicit "
                    "torch.Generator / pass host values as arguments")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        # the whole body, nested defs included — inner closures run
        # at capture with their parent
        for fn in captured_defs(ctx.tree):
            yield from self._impure(ctx, ast.walk(fn),
                                    f"captured function {fn.name!r}")
        for scope, body in _scopes(ctx.tree):
            name = getattr(scope, "name", "<module>")
            for block in capture_blocks(body):
                yield from self._impure(
                    ctx, _own_walk(block.body),
                    f"the torch.cuda.graph block of {name!r}")


# --- LMR010: trace/ span timing must use the injectable clock ---------------

_DIRECT_CLOCK_CALLS = {"time", "monotonic", "perf_counter", "time_ns",
                       "monotonic_ns", "perf_counter_ns"}


class InjectableClockRule(Rule):
    id = "LMR010"
    severity = "error"
    title = "trace code reads time only through the injectable clock"
    rationale = (
        "Every span timestamp in trace/ must flow through the Tracer's "
        "injectable clock (self._clock / tracer.clock()), never a bare "
        "time.time()/perf_counter() call: deterministic-trace tests "
        "replay exact timelines on a virtual clock, and a single direct "
        "wall-clock read silently splits the timeline into two time "
        "bases that no collector can re-align (the LMR004 discipline, "
        "extended from lock scopes to the whole tracing subsystem). "
        "Binding time.time as a DEFAULT (clock=time.time) is the one "
        "legal appearance — it is the injection point itself, a "
        "reference, not a read. Engine job timing (JobTimes) predates "
        "the tracer and stays on its own clock; the rule scopes to "
        "trace/ where determinism is the contract.")
    paths = ("trace/",)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.Call):
                continue
            c = _chain(n.func)
            if (c and len(c) == 2 and c[0] == "time"
                    and c[1] in _DIRECT_CLOCK_CALLS):
                yield self.finding(
                    ctx, n,
                    f"{'.'.join(c)}() in trace/ — route the read "
                    "through the Tracer's injectable clock "
                    "(self._clock() / tracer.clock())")


# --- LMR011: engine/coord waits go through the injectable Waiter ------------

class IdleWaitRule(Rule):
    id = "LMR011"
    severity = "error"
    title = "no bare time.sleep in coord/engine wait paths"
    rationale = (
        "Every wait in the coordination and engine planes — idle-poll "
        "backoff, barrier polls, retry delays, lock contention — must "
        "go through the sched Waiter (sched/waiter.py): a bare "
        "time.sleep() is a wait that NOTHING can interrupt, so one "
        "call silently re-opens the fixed-interval dispatch-latency "
        "floor the watch/notify layer removed (DESIGN §23), and it "
        "dodges the injectable-clock discipline virtual-time tests "
        "rely on. Call waiter.wait(timeout) (the NullWaiter degrades "
        "to exactly a sleep when notify is off); binding time.sleep as "
        "a DEFAULT (sleep=time.sleep) is the injection point itself — "
        "a reference, not a call — and stays legal.")
    paths = ("coord/", "engine/")

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for n in ast.walk(ctx.tree):
            if not isinstance(n, ast.Call):
                continue
            c = _chain(n.func)
            if c and len(c) == 2 and c[0] == "time" and c[1] == "sleep":
                yield self.finding(
                    ctx, n,
                    "time.sleep() in a coord/engine wait path — wait "
                    "through the injectable Waiter "
                    "(sched.waiter.channel_for(store).waiter().wait / "
                    "NullWaiter) so notifications can interrupt it")


# --- LMR012: inbox publishes go through spill_writer ------------------------

# literal markers of push-plane names (engine/push.py): inbox frame /
# tail fragments and the PUSH manifest namespace
_PUSH_NAME_MARKERS = ("INBOX", ".PUSH.")


class PushInboxPublishRule(Rule):
    id = "LMR012"
    severity = "error"
    title = "inbox publishes in engine/ must go through spill_writer"
    rationale = (
        "Every push-shuffle publish — inbox frames, eviction tails, "
        "PUSH manifests — must be built by a writer obtained from "
        "faults.replicate.spill_writer (DESIGN §24): it is the one "
        "place the negotiated replication factor becomes an r-way "
        "fanout at the placement addresses, and the failover/repair/"
        "blackout machinery assumes every inbox copy exists where the "
        "placement function says. A raw store builder (store.builder()"
        ".build(...)) publishing an INBOX-/PUSH-named file lands a "
        "single unreplicated copy that one lost target silently "
        "erases. Heuristic scope (the documented analysis limits): "
        "builds whose name argument carries a literal INBOX/.PUSH. "
        "part, receivers resolved within one function scope. Coded "
        "corollary (DESIGN §27): a \"^M^\" stripe-manifest name "
        "spelled as a literal outside faults/coded.py forges the "
        "visibility gate itself — a hand-written manifest makes a "
        "partial stripe readable (or hides a complete one), so only "
        "the coded module may mint manifest names.")
    paths = ("engine/", "faults/")

    @staticmethod
    def _literal_parts(node) -> str:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.JoinedStr):
            return "".join(v.value for v in node.values
                           if isinstance(v, ast.Constant)
                           and isinstance(v.value, str))
        return ""

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.rel.startswith("engine/"):
            for _scope, body in _scopes(ctx.tree):
                ok: Set[Tuple[str, ...]] = set()
                for n in _own_walk(body):
                    if isinstance(n, ast.Assign) \
                            and isinstance(n.value, ast.Call):
                        c = _chain(n.value.func)
                        if c and c[-1] == "spill_writer":
                            for t in n.targets:
                                tc = _chain(t)
                                if tc:
                                    ok.add(tc)
                for call in _calls(body):
                    if not (isinstance(call.func, ast.Attribute)
                            and call.func.attr == "build" and call.args):
                        continue
                    text = self._literal_parts(call.args[0])
                    if not any(m in text for m in _PUSH_NAME_MARKERS):
                        continue
                    recv = _chain(call.func.value)
                    if recv is not None and recv in ok:
                        continue
                    yield self.finding(
                        ctx, call,
                        "inbox/manifest publish built outside "
                        "spill_writer — a raw builder lands ONE "
                        "unreplicated copy; route the publish through "
                        "faults.replicate.spill_writer so the "
                        "negotiated replication factor applies")
        if ctx.rel != _CODED_HOME:
            for node, text in _stripe_literals(ctx):
                if _STRIPE_MANIFEST_MARKER in text:
                    yield self.finding(
                        ctx, node,
                        "stripe-manifest name constructed directly "
                        f"({text!r}) — \"^M^\" manifests ARE the "
                        "stripe visibility gate; minting one outside "
                        "faults.coded can expose a partial stripe. "
                        "Match them with faults.coded.manifest_pattern/"
                        "stripe_patterns, publish through the codec")


# --- LMR018: controller-owned knobs must ride the task-doc negotiation ------

# the attribute names of knobs the autotune controller owns when the
# task doc carries the "autotune" marker (sched/controller.py
# CONTROLLER_KNOBS, minus the ones with no per-worker attribute)
_CONTROLLER_KNOB_ATTRS = ("batch_k", "speculation", "push_budget_mb")


class AutotuneKnobBypassRule(Rule):
    id = "LMR018"
    severity = "error"
    title = "task-scoped engine code must read controller-owned knobs " \
            "through the task doc"
    rationale = (
        "The autotune controller (DESIGN §29) deploys its decisions by "
        "writing knob values onto the task document; the fleet follows "
        "the doc on its next poll. An engine/ hot path that handles a "
        "``task`` doc but reads ``self.batch_k`` / ``self.speculation`` "
        "/ ``self.push_budget_mb`` directly — without consulting "
        "``task.get(\"<knob>\")`` — silently pins the process-local "
        "value: the controller's change lands on the doc, every "
        "compliant worker follows it, and the bypassing path diverges "
        "from the fleet (a batch_k bypass splits lease sizing; a "
        "speculation bypass desynchronizes the straggler threshold). "
        "Heuristic scope (the documented analysis limits): function "
        "scopes that bind a ``task`` name, one scope at a time. Reads "
        "that ARE the negotiation — the same scope also reads "
        "``task.get(\"<same knob>\")`` (the own-override-else-doc "
        "pattern) — and knob values passed to ``put_task`` / "
        "``update_task`` (the deploy writes themselves) are exempt.")
    paths = ("engine/",)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for scope, body in _scopes(ctx.tree):
            if not isinstance(scope, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                continue
            has_task = any(a.arg == "task" for a in
                           scope.args.args + scope.args.kwonlyargs)
            if not has_task:
                has_task = any(
                    isinstance(n, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "task"
                            for t in n.targets)
                    for n in _own_walk(body))
            if not has_task:
                continue
            negotiated: Set[str] = set()
            for call in _calls(body):
                if (isinstance(call.func, ast.Attribute)
                        and call.func.attr == "get"
                        and _chain(call.func.value) == ("task",)
                        and call.args
                        and isinstance(call.args[0], ast.Constant)):
                    negotiated.add(call.args[0].value)
            par = _parent_map(body)
            for n in _own_walk(body):
                if not (isinstance(n, ast.Attribute)
                        and isinstance(n.ctx, ast.Load)
                        and n.attr in _CONTROLLER_KNOB_ATTRS
                        and _chain(n.value) == ("self",)):
                    continue
                if n.attr in negotiated:
                    continue
                cur, exempt = n, False
                while cur in par:
                    cur = par[cur]
                    if isinstance(cur, ast.Call):
                        c = _chain(cur.func)
                        if c and c[-1] in ("put_task", "update_task"):
                            exempt = True      # the deploy write itself
                            break
                if exempt:
                    continue
                yield self.finding(
                    ctx, n,
                    f"direct read of controller-owned knob "
                    f"self.{n.attr} in a task-scoped path — the "
                    f"autotune deploy lands on the task doc, so read "
                    f"the negotiated value (own override else "
                    f"task.get(\"{n.attr}\")) or the fleet diverges "
                    "when the controller retunes it")
