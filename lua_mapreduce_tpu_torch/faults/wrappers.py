"""Store/JobStore wrappers: deterministic injection + transparent retry.

Copy of the JAX package's ``faults/wrappers.py`` (the torch package imports
nothing of the JAX package).

Layering (router/engine wiring in store/router.py, engine/worker.py,
engine/server.py)::

    RetryingStore( TracingStore( FaultyStore( real Store ) ) )
    RetryingJobStore( TracingJobStore( FaultyJobStore( real JobStore ) ) )

The Faulty* layer exists only when a :class:`FaultPlan` is installed
(chaos suites, ``LMR_FAULT_PLAN`` env); the Tracing* layer (DESIGN §22,
lua_mapreduce_tpu_torch/trace/) only when a tracer is active (``--trace`` /
``LMR_TRACE``) — placed INSIDE the retry layer so every retry attempt
records its own span, and OVER the injection layer so injected faults
are visible as error-tagged attempt spans; the Retrying* layer exists
whenever the retry budget is > 0 (the production default). Fault-free,
trace-free overhead is one bound-method delegation per op — the ≤2%
bench budget.

Build/commit ambiguity: a transient error out of ``build`` may mean the
publish DID land (error-after-write) or landed torn. The retrying
builder resolves it by READBACK-VERIFY — ``exists`` + ``size`` against
the byte count it streamed — before retrying, so a retry never
publishes a duplicate spill segment and a torn publish is always
rebuilt. Replay needs the data: chunks are retained up to
``REPLAY_CAP_BYTES``; past the cap a transient build failure surfaces
as a classified TransientStoreError — the worker releases the job (no
repetition charge) and the re-execution republishes idempotently
(DESIGN §19).
"""

from __future__ import annotations

import logging
import threading
from typing import Iterator, List, Optional, Union

from lua_mapreduce_tpu_torch.faults.errors import (InjectedFault,
                                             InjectedPermanentFault,
                                             TransientStoreError)
from lua_mapreduce_tpu_torch.faults.plan import RPC_OPS, FaultPlan
from lua_mapreduce_tpu_torch.faults.retry import COUNTERS, RetryPolicy
from lua_mapreduce_tpu_torch.store.base import FileBuilder, Store

_log = logging.getLogger(__name__)

REPLAY_CAP_BYTES = 64 << 20     # retain chunks for build replay up to 64MB


def unwrap(obj):
    """The innermost real store/jobstore under any wrapper stack."""
    while hasattr(obj, "_inner"):
        obj = obj._inner
    return obj


# --------------------------------------------------------------------------
# deterministic injection
# --------------------------------------------------------------------------


class _FaultyBuilder(FileBuilder):
    """Builder that can tear or ghost-fail its publish per the plan."""

    def __init__(self, store: "FaultyStore"):
        self._store = store
        self._inner = store._inner.builder()
        self._chunks: List[Union[str, bytes]] = []

    def write(self, data: str) -> None:
        self._chunks.append(data)

    def write_bytes(self, data: bytes) -> None:
        self._chunks.append(data)

    def _feed(self, builder, chunks) -> None:
        for c in chunks:
            if isinstance(c, bytes):
                builder.write_bytes(c)
            else:
                builder.write(c)

    def build(self, name: str) -> None:
        kind = self._store._plan.decide("build", name)
        if kind is not None:
            COUNTERS.bump("faults_injected")
        if kind == "latency":
            self._store._plan.apply_latency()
            kind = None
        elif kind == "slow":
            self._store._plan.apply_slow()
            kind = None
        if kind == "torn":
            # publish a PREFIX (the crash-mid-upload shape an object
            # store can surface), then report failure: readback-verify
            # must see the short object and rebuild
            torn = self._torn_prefix()
            self._inner.close()
            with self._store._inner.builder() as tb:
                self._feed(tb, torn)
                tb.build(name)
            raise InjectedFault(f"injected torn write on build({name!r})",
                                op="build", name=name)
        self._feed(self._inner, self._chunks)
        self._inner.build(name)
        if kind == "error_after_write":
            raise InjectedFault(
                f"injected error-after-write on build({name!r}) — the "
                "publish LANDED", op="build", name=name)
        if kind in ("transient", "permanent"):    # pragma: no cover
            raise InjectedFault(f"injected {kind} on build({name!r})",
                                op="build", name=name)

    def _torn_prefix(self) -> List[Union[str, bytes]]:
        out: List[Union[str, bytes]] = []
        budget = max(1, sum(len(c) for c in self._chunks) // 2)
        for c in self._chunks:
            if budget <= 0:
                break
            out.append(c[:budget] if len(c) > budget else c)
            budget -= len(out[-1])
        return out

    def close(self) -> None:
        self._inner.close()


class FaultyStore(Store):
    """Store wrapper injecting the plan's faults ahead of each op.

    Deliberately exposes ONLY the portable Store surface — native
    shortcuts like ``local_path`` are hidden so injected faults cannot
    be bypassed by the C++ fast paths during chaos runs. Publishes are
    ambiguous by construction (the plan can tear them or ghost-fail
    them on ANY backend), so the retry layer always retains replay
    chunks under injection.
    """

    publish_ambiguous = True

    def __init__(self, inner: Store, plan: FaultPlan):
        self._inner = inner
        self._plan = plan

    def _gate(self, op: str, name: str) -> None:
        kind = self._plan.decide(op, name)
        if kind is None:
            return
        COUNTERS.bump("faults_injected")
        if kind == "latency":
            self._plan.apply_latency()
        elif kind == "slow":
            self._plan.apply_slow()
        elif kind == "permanent":
            raise InjectedPermanentFault(
                f"injected permanent fault on {op}({name!r})",
                op=op, name=name)
        else:
            raise InjectedFault(f"injected transient fault on "
                                f"{op}({name!r})", op=op, name=name)

    def builder(self) -> FileBuilder:
        return _FaultyBuilder(self)

    def lines(self, name: str) -> Iterator[str]:
        self._gate("lines", name)
        return self._inner.lines(name)

    def read_range(self, name: str, offset: int, length: int) -> bytes:
        self._gate("read_range", name)
        return self._inner.read_range(name, offset, length)

    def size(self, name: str) -> int:
        self._gate("size", name)
        return self._inner.size(name)

    def list(self, pattern: str) -> List[str]:
        self._gate("list", pattern)
        return self._inner.list(pattern)

    def exists(self, name: str) -> bool:
        self._gate("exists", name)
        return self._inner.exists(name)

    def remove(self, name: str) -> None:
        self._gate("remove", name)
        return self._inner.remove(name)

    def classify(self, exc: BaseException):
        return self._inner.classify(exc)


# --------------------------------------------------------------------------
# transparent retry
# --------------------------------------------------------------------------


class _RetryingBuilder(FileBuilder):
    """Streams through to the real builder; on backends whose publish
    can fail ambiguously (``Store.publish_ambiguous``) it also retains
    chunk refs for replay and resolves build failures by
    readback-verify. Atomic-publish backends skip retention entirely —
    a failed build there provably published nothing, so there is
    nothing to verify and replaying would only duplicate spill memory."""

    def __init__(self, store: "RetryingStore"):
        self._store = store
        self._inner = store._inner.builder()
        self._ambiguous = getattr(store._inner, "publish_ambiguous", True)
        self._chunks: Optional[List[Union[str, bytes]]] = \
            [] if self._ambiguous else None
        self._approx = 0

    def _retain(self, data) -> None:
        if self._chunks is not None:
            self._approx += len(data)
            if self._approx > REPLAY_CAP_BYTES:
                self._chunks = None     # too big to replay: verify-only
            else:
                self._chunks.append(data)

    def write(self, data: str) -> None:
        self._retain(data)
        self._inner.write(data)

    def write_bytes(self, data: bytes) -> None:
        self._retain(data)
        self._inner.write_bytes(data)

    def _expected_size(self) -> int:
        from lua_mapreduce_tpu_torch.store.base import encode_chunks
        return len(encode_chunks(self._chunks or []))

    def _landed(self, name: str, expected: int) -> bool:
        """Readback-verify: did an ambiguous publish actually land,
        whole? exists + size — both through the retrying store, so the
        verification itself survives transient blips."""
        try:
            if not self._store.exists(name):
                return False
            return self._store.size(name) == expected
        except Exception as exc:
            if self._store.classify(exc) is not None:
                return False            # can't verify → assume not landed
            raise

    def build(self, name: str) -> None:
        policy = self._store._policy
        classify = self._store._inner.classify
        try:
            self._inner.build(name)
            return
        except Exception as exc:
            if classify(exc) is not True:
                raise
            first = exc
        # ambiguous: the publish may have landed (whole or torn)
        expected = self._expected_size() if self._chunks is not None else -1
        if self._chunks is not None and self._landed(name, expected):
            COUNTERS.bump("build_verified")
            _log.warning("build(%r): transient error AFTER the publish "
                         "landed (%s) — verified by readback, not "
                         "retried", name, type(first).__name__)
            return
        if self._chunks is None:
            # no retained bytes to rebuild from — either an atomic-
            # publish backend (retention skipped by design: the failed
            # publish provably landed nothing) or a stream past the
            # replay cap (cannot readback-verify: exact byte count
            # unknown). Either way the fault is still a TRANSIENT piece
            # of infrastructure weather, so surface it CLASSIFIED: the
            # worker then releases the job (no repetition charge) and
            # the re-execution republishes idempotently. Raising
            # `first` raw would launder an infra fault into user code
            # and burn a repetition.
            why = (f"stream past the replay cap "
                   f"({REPLAY_CAP_BYTES >> 20}MB) — cannot verify or "
                   f"rebuild in place" if self._ambiguous else
                   "atomic-publish backend retains no replay bytes "
                   "(the failed publish landed nothing)")
            raise TransientStoreError(
                f"build({name!r}): transient failure; {why}; "
                f"releasing to job-level retry",
                op="build", name=name) from first

        def rebuild():
            self._inner.close()
            self._inner = self._store._inner.builder()
            for c in self._chunks:
                if isinstance(c, bytes):
                    self._inner.write_bytes(c)
                else:
                    self._inner.write(c)
            self._inner.build(name)

        policy.call(rebuild, op="build", name=name, classify=classify,
                    before_retry=lambda e: self._landed(name, expected))

    def close(self) -> None:
        self._inner.close()


class RetryingStore(Store):
    """Every portable store op behind the retry policy.

    ``lines`` retries the OPEN + FIRST record only: once a record has
    been yielded downstream, a silent restart would duplicate data, so
    mid-stream faults propagate (the merge layer's whole-file
    degradation in core/segment.py covers ranged readers).

    Unknown attributes (``local_path``, memfs test hooks) forward to the
    wrapped store so native fast paths keep working.
    """

    def __init__(self, inner: Store, policy: RetryPolicy):
        self._inner = inner
        self._policy = policy

    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    def _call(self, op, name, fn):
        return self._policy.call(fn, op=op, name=name,
                                 classify=self._inner.classify)

    def builder(self) -> FileBuilder:
        return _RetryingBuilder(self)

    def lines(self, name: str) -> Iterator[str]:
        def open_primed():
            it = iter(self._inner.lines(name))
            try:
                return next(it), it
            except StopIteration:
                return None, None

        first, it = self._call("lines", name, open_primed)
        if it is None:
            return
        yield first
        yield from it

    def read_range(self, name: str, offset: int, length: int) -> bytes:
        return self._call("read_range", name,
                          lambda: self._inner.read_range(name, offset,
                                                         length))

    def size(self, name: str) -> int:
        return self._call("size", name, lambda: self._inner.size(name))

    def list(self, pattern: str) -> List[str]:
        return self._call("list", pattern, lambda: self._inner.list(pattern))

    def exists(self, name: str) -> bool:
        return self._call("exists", name, lambda: self._inner.exists(name))

    def remove(self, name: str) -> None:
        return self._call("remove", name, lambda: self._inner.remove(name))

    def classify(self, exc: BaseException):
        return self._inner.classify(exc)


# --------------------------------------------------------------------------
# coord plane
# --------------------------------------------------------------------------

# JobStore methods wrapped by injection (Faulty*) and by retry
# (Retrying*). The retried set EXCLUDES the non-idempotent-on-replay
# ops: insert_jobs (a retried insert whose first attempt landed would
# double-insert; server-only, once per phase), pt_cas (same), and
# claim_batch — its index mutation lands under the flock BEFORE the
# claim-log append and payload resolution, so a transient error in
# those later steps retried as a fresh claim would lease ADDITIONAL
# jobs while the first lease sits orphaned (never heartbeaten, stale-
# requeued with a repetition charge — the exact bump this subsystem
# exists to prevent). An unretried claim failure simply surfaces to the
# worker's poll loop, which sleeps and re-polls; by then the stale
# requeue recovers any orphan WITHOUT this worker re-claiming blind.
# claim_spec shares the exclusion for the same shape (a landed first
# attempt would strand a TAKEN shadow lease nobody executes; harmless —
# the original still commits — but it holds a speculation-cap slot).
_WRAPPED_RPCS = tuple(sorted(RPC_OPS))
_RETRIED_RPCS = tuple(sorted(RPC_OPS - {"claim_batch", "claim_spec"}))


class _JobStoreProxy:
    """Shared delegation base: anything not explicitly wrapped forwards
    to the inner store (put_task, insert_jobs, jobs, pt_*, rounds...)."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


class FaultyJobStore(_JobStoreProxy):
    """Injects the plan's ``rpc_transient`` faults ahead of coord RPCs."""

    def __init__(self, inner, plan: FaultPlan):
        super().__init__(inner)
        self._plan = plan


class RetryingJobStore(_JobStoreProxy):
    """Coord RPCs behind the retry policy — the ``_RETRIED_RPCS`` set
    only, each of which is idempotent-on-retry under the CAS protocol:
    a commit/status CAS whose first attempt landed simply reports False
    on the replay (the expected state already moved on), never a double
    transition. Non-replayable ops (claim_batch, insert_jobs, pt_cas)
    pass through unretried — see the set's comment. Exception to the
    idempotence rule: the errors-stream ops (``insert_error`` append,
    ``drain_errors`` destructive read) are AT-LEAST-ONCE telemetry — a
    fault landing between the append/remove and the return can replay
    into a duplicate post-mortem entry, which is acceptable; losing the
    entry (or aborting a worker failure handler) is not."""

    def __init__(self, inner, policy: RetryPolicy):
        super().__init__(inner)
        self._policy = policy


def _make_rpc_wrappers():
    """Generate the per-op wrapped methods once, at import time — a
    hand-written 14-method wall of identical delegation would drift."""
    def faulty(op):
        def call(self, *args, **kw):
            # only a namespace-shaped first arg names the op stream:
            # update_task's fields dict would otherwise mint a fresh
            # occurrence key per call and defeat max_per_key
            ns = args[0] if args and isinstance(args[0], str) else op
            kind = self._plan.decide(op, ns)
            if kind is not None:
                COUNTERS.bump("faults_injected")
                if kind == "latency":       # pragma: no cover - rpc lat
                    self._plan.apply_latency()
                else:
                    raise InjectedFault(
                        f"injected transient fault on {op}({ns!r})",
                        op=op, name=ns)
            return getattr(self._inner, op)(*args, **kw)
        call.__name__ = op
        return call

    def retrying(op):
        def call(self, *args, **kw):
            ns = args[0] if args and isinstance(args[0], str) else op
            return self._policy.call(
                lambda: getattr(self._inner, op)(*args, **kw),
                op=op, name=ns, classify=self._inner.classify)
        call.__name__ = op
        return call

    for op in _WRAPPED_RPCS:
        setattr(FaultyJobStore, op, faulty(op))
    for op in _RETRIED_RPCS:
        setattr(RetryingJobStore, op, retrying(op))


_make_rpc_wrappers()


# --------------------------------------------------------------------------
# process-global plan install + wiring helpers
# --------------------------------------------------------------------------

_plan_lock = threading.Lock()
_installed_plan: Optional[FaultPlan] = None
_plan_generation = 0
_env_plans: dict = {}      # spec string -> parsed FaultPlan (one schedule
                           # per process per spec; NOT promoted to the
                           # installed slot, so un-setting the env var
                           # deactivates it)


def install_fault_plan(plan: Optional[FaultPlan]) -> None:
    """Install (or clear, with None) the process-wide fault plan. New
    stores built by the router and new engine wrappers pick it up; the
    chaos suite installs per-test and clears in a finally."""
    global _installed_plan, _plan_generation
    with _plan_lock:
        _installed_plan = plan
        _plan_generation += 1


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, else one parsed from ``LMR_FAULT_PLAN`` (the
    subprocess-fleet channel), else None. Env plans are memoized per
    spec string — one process, one schedule per spec — and deactivate
    when the variable is unset."""
    with _plan_lock:
        if _installed_plan is not None:
            return _installed_plan
    import os
    spec = os.environ.get("LMR_FAULT_PLAN")
    if not spec:
        return None
    with _plan_lock:
        plan = _env_plans.get(spec)
        if plan is None:
            plan = _env_plans[spec] = FaultPlan.from_spec(spec)
        return plan


def wiring_token() -> tuple:
    """Changes whenever the wrapper configuration would change — cache
    key for memoized wrapped stores (router's mem:tag instances)."""
    import os

    from lua_mapreduce_tpu_torch.faults.retry import config_generation
    from lua_mapreduce_tpu_torch.trace.span import trace_generation
    with _plan_lock:
        gen = _plan_generation
    return (gen, config_generation(), trace_generation(),
            os.environ.get("LMR_FAULT_PLAN") or "")


def wrap_store(store: Store) -> Store:
    """The router's one wiring point: injection (if a plan is active),
    tracing (if a tracer is active — DESIGN §22), then retry (if the
    budget is > 0), innermost to outermost."""
    from lua_mapreduce_tpu_torch.faults.retry import default_policy
    from lua_mapreduce_tpu_torch.trace.span import active_tracer
    plan = active_plan()
    if plan is not None:
        store = FaultyStore(store, plan)
    tracer = active_tracer()
    if tracer is not None:
        from lua_mapreduce_tpu_torch.trace.wrappers import TracingStore
        store = TracingStore(store, tracer)
    policy = default_policy()
    if policy.retries > 0:
        store = RetryingStore(store, policy)
    return store


def wrap_jobstore(store):
    """Worker/Server wiring point for the coord plane. Idempotent — an
    already-wrapped store passes through."""
    from lua_mapreduce_tpu_torch.trace.wrappers import TracingJobStore
    if isinstance(store, (RetryingJobStore, FaultyJobStore,
                          TracingJobStore)):
        return store
    from lua_mapreduce_tpu_torch.faults.retry import default_policy
    from lua_mapreduce_tpu_torch.trace.span import active_tracer
    plan = active_plan()
    if plan is not None:
        store = FaultyJobStore(store, plan)
    tracer = active_tracer()
    if tracer is not None:
        store = TracingJobStore(store, tracer)
    policy = default_policy()
    if policy.retries > 0:
        store = RetryingJobStore(store, policy)
    return store


def utest() -> None:
    """Self-test: injection determinism through the store surface,
    retry absorption, build readback-verify, torn-write rebuild."""
    import random

    from lua_mapreduce_tpu_torch.store.memfs import MemStore

    # error-after-write: publish lands once, ambiguity verified away
    plan = FaultPlan(3, error_after_write=1.0, max_per_key=1,
                     sleep=lambda s: None)
    policy = RetryPolicy(retries=3, base_ms=1, sleep=lambda s: None,
                         rng=random.Random(0))
    raw = MemStore()
    store = RetryingStore(FaultyStore(raw, plan), policy)
    with store.builder() as b:
        b.write("k 1\n")
        b.write_bytes(b"\x00\x01")
        b.build("amb")
    assert raw.size("amb") == 6
    assert plan.fired.get("error_after_write") == 1

    # torn write: the truncated publish is detected and rebuilt whole
    plan2 = FaultPlan(4, torn=1.0, max_per_key=1, sleep=lambda s: None)
    store2 = RetryingStore(FaultyStore(MemStore(), plan2), policy)
    with store2.builder() as b:
        for i in range(20):
            b.write(f"line {i:03d}\n")
        b.build("torn")
    assert len(list(store2.lines("torn"))) == 20
    assert plan2.fired.get("torn") == 1

    # read-side transient bursts absorbed; lines restarts pre-yield only
    plan3 = FaultPlan(5, transient=0.6, max_per_key=2, sleep=lambda s: None)
    raw3 = MemStore()
    with raw3.builder() as b:
        b.write("a 1\nb 2\n")
        b.build("r")
    store3 = RetryingStore(FaultyStore(raw3, plan3), policy)
    for _ in range(12):
        assert store3.read_range("r", 0, 3) == b"a 1"
        assert list(store3.lines("r")) == ["a 1\n", "b 2\n"]
        assert store3.exists("r") and store3.size("r") == 8
    assert unwrap(store3) is raw3

    # jobstore RPC injection + retry: commits survive an injected burst;
    # claim_batch is deliberately NOT retried (non-replayable — a landed
    # first attempt would orphan its lease), so its injected faults
    # surface to the caller (the worker's poll loop re-polls)
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore, make_job
    js = MemJobStore()
    js.insert_jobs("map_jobs", [make_job("k", 1)])
    plan4 = FaultPlan(6, rpc_transient=0.7, max_per_key=4,
                      sleep=lambda s: None)
    wrapped = RetryingJobStore(FaultyJobStore(js, plan4), policy)
    assert "claim_batch" not in RetryingJobStore.__dict__
    got = []
    for _ in range(8):          # the poll loop's re-poll, in miniature
        try:
            got = wrapped.claim_batch("map_jobs", "w1", 1)
            break
        except InjectedFault:
            continue
    assert len(got) == 1
    assert wrapped.commit_batch("map_jobs", "w1",
                                [(got[0]["_id"], None)]) == [got[0]["_id"]]
    assert unwrap(wrapped) is js

    # install/active/env plumbing
    install_fault_plan(plan4)
    try:
        assert active_plan() is plan4
        t0 = wiring_token()
    finally:
        install_fault_plan(None)
    assert active_plan() is None and wiring_token() != t0
    assert isinstance(wrap_store(MemStore()), RetryingStore)
    assert wrap_jobstore(wrapped) is wrapped
