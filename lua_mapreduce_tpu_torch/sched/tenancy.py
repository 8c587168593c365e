"""Multi-tenant scheduling — the fairness half of lmr-sched.

Port of ``lua_mapreduce_tpu/sched/tenancy.py`` (DESIGN §23).

The engine's job stores coordinate exactly ONE task: the task document
is a singleton, and every claim scans one set of namespaces. This
module turns one shared store into a multi-tenant control plane:

- :class:`Tenant` — a named share of the store with a fair-share
  ``weight`` and an optional admission quota (``max_pending``);
- :class:`TenantView` — a full JobStore facade for one tenant over the
  shared store: job namespaces are prefixed (``t~<tenant>~<ns>``), the
  task singleton moves into a per-tenant persistent document, and
  admission control runs inside ``insert_jobs``. A stock ``Server`` or
  ``Worker`` pointed at a view runs UNCHANGED — many concurrent tasks
  per store is just many views over it;
- :class:`FairScheduler` — stride scheduling over the tenants: each
  claimed job charges its tenant ``STRIDE_SCALE / weight`` virtual
  time, and the next claim round trip goes to the tenant with the
  LOWEST accumulated pass. Long-run throughput converges to the weight
  ratio, and — the starvation bound — a tenant flooding the store with
  tiny jobs can delay another tenant's next claim by at most one lease
  per scheduling round, never by its whole backlog;
- :class:`FairWorker` — a claim-and-execute loop serving every tenant
  through one pool member: per poll it asks the scheduler for the
  tenant order, delegates to that tenant's (stock, state-isolated)
  inner Worker, and charges the scheduler by jobs actually committed.
  The weighted-fair ordering is therefore applied at the claim entry
  point itself: WHICH tenant's ``claim_batch`` fires next is the
  scheduler's decision, so fairness needs no cooperation from the
  flooding tenant.

Admission control is the backpressure half: ``insert_jobs`` through a
view with ``max_pending`` set refuses (``AdmissionError``, classified
permanent — the retry layer must not burn backoff on a full queue) any
batch that would push the tenant's live jobs past its quota, and the
per-tenant admitted/rejected counters feed the bench and the tests.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import uuid
from typing import Dict, List, Optional, Sequence

from lua_mapreduce_tpu_torch.core.constants import (DEFAULT_SLEEP,
                                                    MAX_JOB_RETRIES, Status)
from lua_mapreduce_tpu_torch.coord.jobstore import JobStore
from lua_mapreduce_tpu_torch.faults.errors import (NoTaskError,
                                                   PermanentStoreError)

TENANT_SEP = "~"
_TENANT_NAME = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")

# live = occupying queue capacity: everything short of the terminal
# states counts against the admission quota
_LIVE_STATES = (Status.WAITING, Status.RUNNING, Status.BROKEN,
                Status.FINISHED)


class AdmissionError(PermanentStoreError):
    """A tenant's insert was refused by its admission quota. Permanent
    by classification: retrying the same insert against a full queue
    is deterministic failure — the submitter must drain or shed."""


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One tenant's scheduling contract: fair-share ``weight`` (claims
    converge to the weight ratio under contention) and an optional
    ``max_pending`` admission quota (live jobs per namespace)."""

    name: str
    weight: float = 1.0
    max_pending: Optional[int] = None

    def __post_init__(self):
        if not _TENANT_NAME.match(self.name):
            raise ValueError(f"tenant name {self.name!r} must match "
                             f"{_TENANT_NAME.pattern}")
        if not (self.weight > 0):
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError(f"tenant {self.name!r}: max_pending must be "
                             "≥ 1 (or None for unlimited)")


def tenant_ns(tenant: str, ns: str) -> str:
    """Physical namespace of a tenant's logical one. The prefix is
    path-safe (FileJobStore turns namespaces into ``<ns>.idx`` files),
    and ``~`` never appears in engine namespaces."""
    return f"t{TENANT_SEP}{tenant}{TENANT_SEP}{ns}"


class FairScheduler:
    """Stride scheduler: min-pass tenant claims next; each claimed job
    advances its tenant's pass by ``STRIDE_SCALE / weight``. Thread-safe
    — one instance serves a whole in-process pool, so the pool's
    AGGREGATE claim ordering is weighted-fair, not just each member's."""

    STRIDE_SCALE = 1 << 16

    def __init__(self, tenants: Sequence[Tenant]):
        if not tenants:
            raise ValueError("FairScheduler needs at least one tenant")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {sorted(names)}")
        self._lock = threading.Lock()
        self.tenants: Dict[str, Tenant] = {t.name: t for t in tenants}
        self._stride = {t.name: self.STRIDE_SCALE / t.weight
                        for t in tenants}
        self._pass: Dict[str, float] = {t.name: 0.0 for t in tenants}
        self._charged: Dict[str, int] = {t.name: 0 for t in tenants}

    def order(self) -> List[str]:
        """Tenant names, lowest pass first (name-tiebroken so equal
        shares alternate deterministically instead of starving on dict
        order)."""
        with self._lock:
            return sorted(self._pass, key=lambda n: (self._pass[n], n))

    def charge(self, tenant: str, jobs: int = 1) -> None:
        """Account ``jobs`` claimed work against ``tenant``'s share."""
        if jobs <= 0:
            return
        with self._lock:
            self._pass[tenant] += jobs * self._stride[tenant]
            self._charged[tenant] += jobs

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {n: {"pass": self._pass[n], "weight":
                        self.tenants[n].weight,
                        "charged": self._charged[n]}
                    for n in self._pass}


class TenantView(JobStore):
    """One tenant's JobStore facade over a shared concrete store.

    Namespace ops delegate with the tenant prefix applied; the task
    singleton lives in a per-tenant persistent document (optimistic
    timestamp CAS — the ``persistent_table`` discipline, so concurrent
    ``update_task`` folds from workers merge instead of clobbering);
    persistent tables are tenant-prefixed; the errors stream stays
    SHARED (one post-mortem log per store) with every entry tagged
    ``tenant``. ``_inner`` keeps :func:`faults.wrappers.unwrap` — and
    therefore the sched wakeup channels — resolving to the shared
    store, so all tenants ride one notify bus.

    Admission: with ``tenant.max_pending`` set, ``insert_jobs`` refuses
    batches that would push the namespace's live jobs past the quota.
    """

    def __init__(self, store, tenant: Tenant,
                 counters: Optional[Dict[str, int]] = None):
        from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
        self._inner = unwrap(store)
        self.tenant = tenant
        self.admission = counters if counters is not None else \
            {"admitted": 0, "rejected": 0}
        self._task_key = f"_task{TENANT_SEP}{tenant.name}"

    def _ns(self, ns: str) -> str:
        return tenant_ns(self.tenant.name, ns)

    # -- task singleton (per-tenant persistent document) -------------------

    def put_task(self, doc: dict) -> None:
        while True:
            cur = self._inner.pt_get(self._task_key)
            ts = cur.get("timestamp") if cur is not None else None
            d = dict(doc)
            d["timestamp"] = (ts or 0) + 1
            if self._inner.pt_cas(self._task_key, ts, d):
                return

    def get_task(self) -> Optional[dict]:
        doc = self._inner.pt_get(self._task_key)
        if doc is None:
            return None
        d = dict(doc)
        d.pop("timestamp", None)
        return d

    def update_task(self, fields: dict) -> None:
        while True:
            cur = self._inner.pt_get(self._task_key)
            if cur is None:
                raise NoTaskError(
                    f"no task document for tenant {self.tenant.name!r}")
            d = dict(cur)
            d.update(fields)
            d["timestamp"] = cur["timestamp"] + 1
            if self._inner.pt_cas(self._task_key, cur["timestamp"], d):
                return

    def delete_task(self) -> None:
        self._inner.pt_delete(self._task_key)

    # -- job queues --------------------------------------------------------

    def insert_jobs(self, ns, docs):
        q = self.tenant.max_pending
        docs = list(docs)
        if q is not None:
            counts = self._inner.counts(self._ns(ns))
            live = sum(counts[s] for s in _LIVE_STATES)
            if live + len(docs) > q:
                self.admission["rejected"] += len(docs)
                raise AdmissionError(
                    f"tenant {self.tenant.name!r}: insert of {len(docs)} "
                    f"job(s) into {ns!r} exceeds max_pending={q} "
                    f"({live} live)", op="insert_jobs", name=ns)
        self.admission["admitted"] += len(docs)
        return self._inner.insert_jobs(self._ns(ns), docs)

    def claim(self, ns, worker, preferred_ids=None, steal=True):
        return self._inner.claim(self._ns(ns), worker, preferred_ids, steal)

    def claim_batch(self, ns, worker, k=1, preferred_ids=None, steal=True):
        return self._inner.claim_batch(self._ns(ns), worker, k,
                                       preferred_ids, steal)

    def commit_batch(self, ns, worker, entries):
        return self._inner.commit_batch(self._ns(ns), worker, entries)

    def release_batch(self, ns, worker, job_ids):
        return self._inner.release_batch(self._ns(ns), worker, job_ids)

    def heartbeat_batch(self, ns, job_ids, worker):
        return self._inner.heartbeat_batch(self._ns(ns), job_ids, worker)

    def heartbeat(self, ns, job_id, worker):
        return self._inner.heartbeat(self._ns(ns), job_id, worker)

    def set_job_status(self, ns, job_id, status, expect=None,
                       expect_worker=None):
        return self._inner.set_job_status(self._ns(ns), job_id, status,
                                          expect, expect_worker)

    def get_job(self, ns, job_id):
        return self._inner.get_job(self._ns(ns), job_id)

    def jobs(self, ns):
        return self._inner.jobs(self._ns(ns))

    def job_workers(self, ns):
        return self._inner.job_workers(self._ns(ns))

    def set_job_times(self, ns, job_id, times):
        return self._inner.set_job_times(self._ns(ns), job_id, times)

    def counts(self, ns):
        return self._inner.counts(self._ns(ns))

    def scavenge(self, ns, max_retries=MAX_JOB_RETRIES):
        return self._inner.scavenge(self._ns(ns), max_retries)

    def requeue_stale(self, ns, older_than_s):
        return self._inner.requeue_stale(self._ns(ns), older_than_s)

    def speculate(self, ns, job_id):
        return self._inner.speculate(self._ns(ns), job_id)

    def claim_spec(self, ns, worker):
        return self._inner.claim_spec(self._ns(ns), worker)

    def cancel_spec(self, ns, job_id, worker):
        return self._inner.cancel_spec(self._ns(ns), job_id, worker)

    def drop_ns(self, ns):
        return self._inner.drop_ns(self._ns(ns))

    # -- shared surfaces ---------------------------------------------------

    def insert_error(self, worker, msg, info=None):
        tagged = dict(info or {})
        tagged.setdefault("tenant", self.tenant.name)
        return self._inner.insert_error(worker, msg, info=tagged)

    def drain_errors(self):
        return self._inner.drain_errors()

    def pt_get(self, name):
        return self._inner.pt_get(f"{self.tenant.name}{TENANT_SEP}{name}")

    def pt_cas(self, name, expected_ts, doc):
        return self._inner.pt_cas(
            f"{self.tenant.name}{TENANT_SEP}{name}", expected_ts, doc)

    def pt_delete(self, name):
        return self._inner.pt_delete(
            f"{self.tenant.name}{TENANT_SEP}{name}")

    def round_counts(self):
        return self._inner.round_counts()

    def classify(self, exc):
        return self._inner.classify(exc)


class FairWorker:
    """One pool member serving EVERY tenant under weighted fair share.

    Each tenant gets its own stock :class:`~engine.worker.Worker` over a
    :class:`TenantView` (state isolation for free: affinity caches,
    duration EWMAs, and release budgets are per-tenant because job ids
    collide across tenants). Per poll, the shared
    :class:`FairScheduler` orders the tenants by accumulated pass and
    the first tenant with claimable work executes — the claim round
    trip itself is what fairness rations. Committed jobs charge the
    scheduler, so a flood tenant's pass races ahead and the barrier
    tenant's next claim arrives within one scheduling round.

    The idle loop rides the sched wakeup channel of the SHARED store
    (capped jittered backoff interrupted by the Waiter), so dispatch
    stays millisecond-class across every tenant.
    """

    # full-poll refresh cadence for tenants the cheap claimable-counts
    # pre-filter skipped: phase flips that create claimable jobs are
    # caught by the filter itself; flips that don't (FINISHED) surface
    # within this many rounds — bounded staleness on the exit path only
    REFRESH_EVERY = 8

    def __init__(self, store, tenants: Sequence[Tenant],
                 name: Optional[str] = None,
                 scheduler: Optional[FairScheduler] = None,
                 verbose: bool = False, **worker_config):
        from lua_mapreduce_tpu_torch.engine.worker import Worker
        self.name = name or f"fair-{uuid.uuid4().hex[:8]}"
        self.store = store
        self.scheduler = scheduler if scheduler is not None \
            else FairScheduler(tenants)
        self.max_iter = int(worker_config.pop("max_iter", 20))
        self.max_sleep = float(worker_config.pop("max_sleep", 20.0))
        self.idle_poll_ms = worker_config.pop("idle_poll_ms", None)
        self._workers: Dict[str, Worker] = {}
        self._views: Dict[str, TenantView] = {}
        self._last_outcome: Dict[str, str] = {}
        self._round = 0
        for t in tenants:
            view = TenantView(store, t)
            w = Worker(view, name=f"{self.name}.{t.name}",
                       verbose=verbose)
            # inner workers never sleep — this loop owns all waiting —
            # and a huge max_iter keeps their own idle budget inert
            w.configure(max_iter=10 ** 9, **worker_config)
            self._views[t.name] = view
            self._workers[t.name] = w

    @property
    def jobs_executed(self) -> int:
        return sum(w.jobs_executed for w in self._workers.values())

    @staticmethod
    def _has_claimable(view: TenantView) -> bool:
        """Cheap pre-filter: index-count scan only (no task-doc read,
        no spec resolution, no payload copies) — the guard that keeps a
        wakeup at N-tenant scale from costing N full polls per pool
        member (the thundering-herd tax the bench exposed). Known
        bounded staleness: a speculation-OPEN straggler is status
        RUNNING, invisible to counts — a FairWorker reaches its
        clone-claim probe only on the periodic refresh round (≤
        REFRESH_EVERY polls late); the detector's retraction path
        already tolerates slow clone pickup."""
        for ns in ("map_jobs", "pre_jobs", "red_jobs"):
            c = view.counts(ns)
            if c[Status.WAITING] or c[Status.BROKEN]:
                return True
        return False

    def poll_once(self) -> str:
        """One fair round: tenants in pass order; the first with
        claimable work (per the cheap pre-filter) gets a full poll,
        executes, and is charged. Tenants with nothing claimable reuse
        their last outcome except on periodic refresh rounds (catching
        FINISHED flips). Aggregate outcome: "executed" the moment any
        tenant ran; "finished" when EVERY tenant's task is finished;
        "wait" when none has a task yet; else "idle"."""
        self._round += 1
        refresh = (self._round % self.REFRESH_EVERY) == 1
        outcomes = []
        for tn in self.scheduler.order():
            w = self._workers[tn]
            cached = self._last_outcome.get(tn)
            if (not refresh and cached is not None
                    and not self._has_claimable(self._views[tn])):
                outcomes.append(cached)
                continue
            before = w.jobs_executed
            out = w.poll_once()
            self._last_outcome[tn] = out if out != "executed" else "idle"
            if out == "executed":
                self.scheduler.charge(tn, max(1, w.jobs_executed - before))
                return "executed"
            outcomes.append(out)
        if outcomes and all(o == "finished" for o in outcomes):
            return "finished"
        if outcomes and all(o == "wait" for o in outcomes):
            return "wait"
        return "idle"

    def execute(self) -> int:
        """Run until ``max_iter`` consecutive quiet (timed-out) idle
        polls or every tenant's task finished. Returns total jobs
        executed. The wait discipline is Worker's exactly
        (sched.jittered_wait — one shared schedule): capped jittered
        backoff that the shared store's "jobs" wakeup channel
        interrupts, with only timed-out waits draining the idle budget
        (a flood tenant's notify traffic must not idle out the pool)."""
        import random

        from lua_mapreduce_tpu_torch.engine.worker import \
            resolve_idle_poll_s
        from lua_mapreduce_tpu_torch.sched.waiter import channel_for, \
            jittered_wait
        waiter = channel_for(self.store, "jobs").waiter()
        cap = resolve_idle_poll_s(self.idle_poll_ms, self.max_sleep)
        rng = random.Random(self.name)
        idle = 0
        sleep = DEFAULT_SLEEP
        while idle < self.max_iter:
            out = self.poll_once()
            if out == "executed":
                idle = 0
                sleep = DEFAULT_SLEEP
                continue
            if out == "finished":
                # EVERY tenant's task is finished: terminal for this
                # pool member whether or not it personally got work —
                # a late joiner must not idle out its whole budget
                # against a completed fleet
                break
            woken, sleep = jittered_wait(waiter, sleep, cap, rng,
                                         floor_s=DEFAULT_SLEEP)
            if not woken:
                idle += 1
        return self.jobs_executed


def dispatch_latencies(store, tenant: str, ns: str = "map_jobs"
                       ) -> List[float]:
    """Per-job dispatch latency (insert→first claim, seconds) of a
    tenant's namespace, read from the job records: ``started_time``
    (the claim stamp) minus ``creation_time`` (the insert stamp).
    Jobs never claimed are skipped. The store-side twin of the
    lmr-trace ``dispatch`` span, for tests/benches that run untraced."""
    from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
    out = []
    for doc in unwrap(store).jobs(tenant_ns(tenant, ns)):
        t0, t1 = doc.get("creation_time"), doc.get("started_time")
        if t0 and t1 and t1 >= t0:
            out.append(t1 - t0)
    return out


def utest() -> None:
    """Self-test: stride ordering converges to the weight ratio,
    admission quotas refuse floods, the tenant view isolates task docs
    and namespaces on the shared store."""
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore, make_job

    heavy, light = Tenant("heavy", weight=3.0), Tenant("light", weight=1.0)
    sched = FairScheduler([heavy, light])
    takes = []
    for _ in range(40):
        t = sched.order()[0]
        takes.append(t)
        sched.charge(t)
    ratio = takes.count("heavy") / max(1, takes.count("light"))
    assert 2.0 <= ratio <= 4.0, takes     # ~3:1 by stride construction

    store = MemJobStore()
    a = TenantView(store, Tenant("a", max_pending=3))
    b = TenantView(store, Tenant("b"))
    a.put_task({"status": "MAP", "spec": {}})
    assert b.get_task() is None            # task singletons are per-tenant
    a.update_task({"iteration": 2})
    assert a.get_task()["iteration"] == 2
    assert "timestamp" not in a.get_task()

    a.insert_jobs("map_jobs", [make_job(f"k{i}", i) for i in range(3)])
    try:
        a.insert_jobs("map_jobs", [make_job("k3", 3)])
    except AdmissionError:
        pass
    else:
        raise AssertionError("quota breach must be refused")
    assert a.admission == {"admitted": 3, "rejected": 1}
    b.insert_jobs("map_jobs", [make_job("x", 0)])    # b is unbounded

    # namespaces are disjoint on the shared store
    doc = a.claim("map_jobs", "w1")
    assert doc is not None and doc["_id"] == 0
    assert b.counts("map_jobs")[Status.WAITING] == 1
    assert store.counts(tenant_ns("a", "map_jobs"))[Status.RUNNING] == 1
    # draining one claimed job makes quota room again
    t5 = {"started": 0.0, "finished": 0.0, "written": 0.0, "cpu": 0.0,
          "real": 0.0}
    assert a.commit_batch("map_jobs", "w1", [(0, t5)]) == [0]
    a.insert_jobs("map_jobs", [make_job("k3", 3)])

    try:
        Tenant("bad~name")
    except ValueError:
        pass
    else:
        raise AssertionError("separator in tenant name must be rejected")
