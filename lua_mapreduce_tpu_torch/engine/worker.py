"""Elastic worker runtime.

Port of ``lua_mapreduce_tpu/engine/worker.py`` (reference
mapreduce/worker.lua, SURVEY.md §3.2): a polling loop that discovers the
task phase from the task document, claims jobs through the store's CAS,
executes them through ``engine/job.py``, and survives user-code failures
by marking jobs BROKEN and logging to the errors stream. Workers are
elastic — they may join or leave at any time; the pool is however many
of these loops run (threads in-process, or processes over a
``FileJobStore``: ``python -m lua_mapreduce_tpu_torch.cli.execute_worker``).

A worker runs its task on the card: the device is the task's
``init_args["device"]``, else ``"cuda"``, resolved when the worker loads
the task — a worker on a machine with no card raises unless the task
asks for ``device="cpu"``. The hybrid plane's compiled map and reduce
legs run there when the task document's negotiated stage split names
them (``engine/hybrid.py``).

Under a pipelined task the worker also claims the server's eager
``pre_merge`` jobs (``PRE_NS``) during the map phase; it writes spills
in the task document's ``segment_format`` unless configured with its
own. Coord RPCs go through ``faults/wrappers.wrap_jobstore`` (retry,
fault injection, trace spans); with a tracer active every job body is
a span and the worker flushes its spans into the task storage after
each lease and when it leaves.

The shuffle redundancy (``replication``: r placement copies, or with
``coding`` k+m erasure-coded stripes) and the push shuffle (``push``,
``push_budget_mb``) follow the task document unless the worker is
configured with its own. Under redundancy a reduce whose input has no
readable copy left raises :class:`LostShuffleDataError` naming the
files: the job is released, the error record carries ``lost_files``,
and the server repairs the files or requeues their producing maps,
which this worker claims in the reduce phase before any reduce job.

Speculative duplicate leases follow the task document's
``speculation`` factor: an idle worker with nothing claimable takes a
straggler's shadow lease (``claim_spec``) and races the original in
:meth:`Worker.run_one`; the first commit wins and the loser touches
nothing. Each worker folds its per-namespace job-duration EWMA into the
task document (``dur_ewma:<ns>``), which the server's straggler detector
reads and a fresh worker seeds its lease sizing from.

An idle worker waits on the store's "jobs" wakeup channel
(sched/waiter.py) between polls: a capped, jittered back-off (1.5x up
to ``idle_poll_ms``, else ``LMR_IDLE_POLL_MS``, else ``max_sleep``) that
an insert or a phase flip interrupts within milliseconds; only waits
that time out drain the idle budget. The worker bumps "jobs" when it
returns claimable work (a release, a BROKEN mark) and "done" when its
commits land (the server's barrier wakeup). With ``LMR_SCHED_NOTIFY=0``
the waits are plain sleeps. Under the task document's ``autotune``
marker the worker follows the controller-owned ``retry_base_ms`` and
``push_budget_mb`` keys (sched/controller.py).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import random
import threading
import time
import traceback
import uuid
from typing import Dict, List, Optional

from lua_mapreduce_tpu_torch.core.constants import (DEFAULT_SLEEP,
                                                    MAP_NS, MAX_IDLE_COUNT,
                                                    MAX_JOB_RETRIES,
                                                    MAX_WORKER_RETRIES,
                                                    PRE_NS, RED_NS, Status,
                                                    TaskStatus)
from lua_mapreduce_tpu_torch.coord.jobstore import JobStore
from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.job import (JobTimes, map_key_str,
                                                publish_map_groups,
                                                run_map_job,
                                                run_premerge_job,
                                                run_reduce_job)
from lua_mapreduce_tpu_torch.engine.placement import base_name
from lua_mapreduce_tpu_torch.engine.push import (BufferPool, lineage_token,
                                                 manifest_name, promote,
                                                 resolve_push_budget)
from lua_mapreduce_tpu_torch.faults.errors import (LostShuffleDataError,
                                                   StoreError,
                                                   classify_job_fault,
                                                   is_transient_job_fault)
from lua_mapreduce_tpu_torch.faults.coded import (check_redundancy,
                                                  doc_redundancy,
                                                  parse_coding,
                                                  redundancy_on)
from lua_mapreduce_tpu_torch.faults.plan import set_current_worker
from lua_mapreduce_tpu_torch.faults.replicate import reading_view
from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
from lua_mapreduce_tpu_torch.faults.wrappers import wrap_jobstore
from lua_mapreduce_tpu_torch.store.router import get_storage_from
from lua_mapreduce_tpu_torch.trace.span import active_tracer

_log = logging.getLogger(__name__)

# consecutive transient-infra poll failures a worker tolerates (with
# exponential backoff to 2 s) before giving up — far above the 3-strike
# user-code budget
MAX_INFRA_POLL_FAILURES = 10

_CONFIG_KEYS = ("max_iter", "max_sleep", "max_tasks", "max_jobs", "phases",
                "heartbeat_s", "batch_k", "batch_lease_s", "segment_format",
                "replication", "coding", "idle_poll_ms", "push",
                "push_budget_mb")


def resolve_idle_poll_s(idle_poll_ms, max_sleep: float) -> float:
    """The idle-poll cap in seconds: the longest an idle worker waits
    between claim scans (the lost-notification fallback period).
    Explicit knob, else ``LMR_IDLE_POLL_MS``, else ``max_sleep``; never
    above ``max_sleep`` (the idle budget is counted in polls of at most
    that length)."""
    if idle_poll_ms is None:
        env = os.environ.get("LMR_IDLE_POLL_MS")
        idle_poll_ms = float(env) if env else None
    if idle_poll_ms is None:
        return max_sleep
    if idle_poll_ms <= 0:
        raise ValueError(f"idle_poll_ms must be > 0, got {idle_poll_ms}")
    return min(max_sleep, idle_poll_ms / 1000.0)


# EWMA smoothing for the observed per-job duration that sizes batch
# leases (recent jobs dominate)
_DUR_ALPHA = 0.3

# blend weight for folding this worker's duration EWMA into the fleet
# aggregate on the task document: each worker pulls the doc value toward
# its own observation, so a straggler's slow observations are diluted by
# every healthy worker's folds — which keeps the detector's threshold
# honest
_FLEET_ALPHA = 0.3


class Worker:
    """Claim-and-execute loop (reference worker.lua:42-138)."""

    def __init__(self, store: JobStore, name: Optional[str] = None,
                 verbose: bool = False):
        # coord RPCs ride the retry layer (and an installed FaultPlan's
        # injection, and trace spans when a tracer is active)
        self.store = wrap_jobstore(store)
        self.name = name or f"worker-{uuid.uuid4().hex[:8]}-{os.getpid()}"
        self.verbose = verbose
        self.max_iter = 20
        self.max_sleep = 20.0
        self.max_tasks = 1
        # bounded lifetime in executed JOBS (None = unlimited)
        self.max_jobs = None
        # which phases this worker claims — ("map",) / ("reduce",) build
        # heterogeneous pools (fs.lua:143-160)
        self.phases = ("map", "reduce")
        # liveness beat while a job runs, so the server's stale requeue
        # measures SILENCE instead of elapsed time. None/0 disables.
        self.heartbeat_s = 60.0
        # batch leases: claim up to batch_k jobs in one control-plane
        # round trip, retire them in one commit. None = follow the task
        # document's batch_k. Within the cap the lease is sized from the
        # observed job duration so it holds about batch_lease_s of work.
        self.batch_k = None
        self.batch_lease_s = 5.0
        # spill encoding: None = follow the task document's
        # segment_format; an explicit "v1"/"v2" wins (readers sniff per
        # file, so a mixed fleet is valid)
        self.segment_format = None
        self._task_segment_format = None
        # shuffle redundancy and push: None = follow the task document
        self.replication = None
        self.coding = None
        self.push = None
        self.push_budget_mb = None
        self._task_replication = None
        self._task_coding = None
        self._task_push = None
        self._push_pool_obj = None      # lazy per-worker buffer pool
        # controller-owned knobs, followed only under the task doc's
        # "autotune" marker: the doc's push budget, and the retry base
        # last applied (configure_retry is process-global; re-applying
        # it every poll would churn the retry config)
        self._task_push_budget = None
        self._autotune_retry_ms = None
        self._last_spec = None          # where trace flushes publish
        self._dur_ewma: Dict[str, float] = {}   # ns -> smoothed real secs
        # the fleet aggregate on the task doc (ns -> seconds) and the
        # value this worker last pushed there; namespaces whose EWMA was
        # seeded from the doc, and how many of this worker's own jobs
        # have folded in since (a fresh worker's first job carries its
        # warm-up, which must not inflate the fleet aggregate)
        self._fleet_ewma: Dict[str, float] = {}
        self._ewma_pushed: Dict[str, float] = {}
        self._ewma_seeded: set = set()
        self._ewma_own_n: Dict[str, int] = {}
        self._speculation = 0.0         # the task doc's factor (0 = off)
        # hybrid compiled legs: the server negotiates the per-stage split
        # on the task doc; the leg engines are minted lazily per (spec,
        # split), and each leased map batch's compiled groupings are
        # stashed for _map_body
        self._task_engine = None
        self._task_hybrid_stages = None
        self._hybrid_rt = None     # (cache key, map engine, reduce fold)
        self._hybrid_stash: Dict[int, dict] = {}
        self._own_stages: Dict[int, Optional[dict]] = {}
        self._spec_cache: Dict[str, tuple] = {}
        self._spec_by_id = None         # (desc object, (spec, device))
        self.device = None              # the current task's device
        self._infra_released: Dict[tuple, int] = {}  # (ns, jid) -> count
        self._release_gen = None        # (task spec, iteration)
        self._affinity: list = []       # map-job ids this worker ran before
        self._idle_count = 0
        self.jobs_executed = 0
        # job bodies started, by label ("map", "pre_merge", "reduce"): a
        # body that failed and ran again counts each time
        self.bodies: Dict[str, int] = {}
        self._jobs_at_start = 0
        # idle waits ride the store's "jobs" wakeup waiter; idle_poll_ms
        # None = LMR_IDLE_POLL_MS, else max_sleep
        self.idle_poll_ms = None
        self._waiter_obj = None
        self._null_waiter = None
        self._jitter = random.Random(self.name)

    def configure(self, **params) -> "Worker":
        """Set the loop knobs; unknown keys are rejected (reference
        worker.lua:142-148)."""
        for k, v in params.items():
            if k not in _CONFIG_KEYS:
                raise KeyError(f"unknown worker config key {k!r}; "
                               f"known: {_CONFIG_KEYS}")
            if k == "segment_format" and v is not None:
                # fail at configure time, not as a per-job failure storm
                from lua_mapreduce_tpu_torch.core.segment import \
                    check_format
                check_format(v)
            if k == "replication" and v is not None:
                check_redundancy(v)     # an int factor or a "k+m" spec
            if k == "coding" and v is not None:
                parse_coding(v)
            if k == "idle_poll_ms" and v is not None and float(v) <= 0:
                raise ValueError(f"idle_poll_ms must be > 0, got {v}")
            setattr(self, k, v)
        return self

    # -- idle waits ---------------------------------------------------------

    def _waiter(self):
        """This worker's cursor on the store's "jobs" wakeup channel,
        minted lazily (the store type picks the backend; a NullWaiter
        when notify is off or the store is unknown)."""
        if self._waiter_obj is None:
            from lua_mapreduce_tpu_torch.sched.waiter import channel_for
            self._waiter_obj = channel_for(self.store, "jobs").waiter()
        return self._waiter_obj

    def _idle_wait(self, sleep: float):
        """One idle back-off step between polls (sched.jittered_wait, the
        one schedule Worker and FairWorker share). Returns ``(woken,
        next_sleep)``: a notification means re-poll now; a timeout is
        the lost-notification fallback."""
        from lua_mapreduce_tpu_torch.sched.waiter import jittered_wait
        cap = self._idle_cap()
        return jittered_wait(self._waiter(), sleep, cap, self._jitter,
                             floor_s=min(DEFAULT_SLEEP, cap))

    def _backoff_wait(self, delay: float) -> None:
        """Failure back-off sleep, deliberately not interruptible: the
        infra and user-code retry delays exist to guarantee recovery
        time, and a busy notify bus must not burn those budgets in
        milliseconds."""
        if self._null_waiter is None:
            from lua_mapreduce_tpu_torch.sched.waiter import NullWaiter
            self._null_waiter = NullWaiter()
        self._null_waiter.wait(delay)

    def _idle_cap(self) -> float:
        return resolve_idle_poll_s(self.idle_poll_ms, self.max_sleep)

    def _notify(self, topic: str) -> None:
        """Best-effort producer bump: "jobs" when this worker returned
        claimable work to the pool (release, broken), "done" when its
        commits landed (the server's barrier wakeup)."""
        from lua_mapreduce_tpu_torch.sched.waiter import notify
        notify(self.store, topic)

    # -- one poll ----------------------------------------------------------

    def poll_once(self) -> str:
        """One discovery+claim+execute round. Returns what happened:
        "wait" (no task yet), "idle" (nothing claimable), "out-of-phase"
        (a phase this worker doesn't claim), "executed", or "finished"."""
        task = self.store.get_task()
        if task is None or task.get("status") == TaskStatus.WAIT.value:
            self._infra_released.clear()
            return "wait"
        if task.get("status") == TaskStatus.FINISHED.value:
            self._infra_released.clear()
            return "finished"

        spec = self._get_spec(task["spec"])
        self._last_spec = spec
        iteration = int(task.get("iteration", 1))
        tracer = active_tracer()
        if tracer is not None:
            # job ids restart per iteration: spans carry the iteration
            tracer.set_iteration(iteration)
        # the per-job infra-release budget is scoped to ONE iteration of
        # ONE task: job ids restart at 0 every iteration
        gen = (task["spec"], iteration)
        if gen != self._release_gen:
            self._release_gen = gen
            self._infra_released.clear()
        self._task_engine = task.get("engine")
        self._task_hybrid_stages = task.get("hybrid_stages")
        self._task_segment_format = task.get("segment_format")
        self._task_replication = task.get("replication")
        self._task_coding = task.get("coding")
        self._task_push = task.get("push")
        self._speculation = float(task.get("speculation") or 0.0)
        # the fleet duration aggregate: one flat doc key per namespace
        # ("dur_ewma:<ns>", so concurrent folds of different namespaces
        # never revert each other); it seeds this worker's own EWMA, so a
        # fresh worker starts with calibrated lease sizing
        self._fleet_ewma = {k.split(":", 1)[1]: v for k, v in task.items()
                            if k.startswith("dur_ewma:")}
        for ns_key, val in self._fleet_ewma.items():
            if ns_key not in self._dur_ewma and val and val > 0:
                self._dur_ewma[ns_key] = float(val)
                self._ewma_seeded.add(ns_key)
        # controller-owned knobs ride the doc only under the server's
        # autotune marker
        if task.get("autotune"):
            self._follow_autotune(task)

        if task["status"] == TaskStatus.MAP.value:
            # the push shuffle's merge should keep pace with frame
            # production: with push on, pre-merge jobs are claimed
            # before maps; staged pipelining keeps them as idle-capacity
            # work behind the maps
            pre_first = bool(task.get("push")) and task.get("pipeline")

            def probe_pre():
                if "reduce" in self.phases and task.get("pipeline"):
                    jobs = self.store.claim_batch(
                        PRE_NS, self.name, self._effective_k(PRE_NS, task))
                    if jobs:
                        self._idle_count = 0
                        self._execute_batch(spec, PRE_NS, jobs)
                        return True
                return False

            if pre_first and probe_pre():
                return "executed"
            if "map" in self.phases:
                preferred = self._affinity if iteration > 1 else None
                steal = not preferred or self._idle_count >= MAX_IDLE_COUNT
                jobs = self.store.claim_batch(
                    MAP_NS, self.name, self._effective_k(MAP_NS, task),
                    preferred, steal=steal)
                if jobs:
                    self._idle_count = 0
                    self._execute_batch(spec, MAP_NS, jobs)
                    return "executed"
            # eager pre-merge rides inside the map phase behind the
            # reduce-phase filter; the doc marker gates the probe, so
            # barrier tasks pay no extra claim round trip
            if not pre_first and probe_pre():
                return "executed"
            # speculative duplicate leases: only a worker with nothing
            # claimable gets here, so clones never take capacity from
            # unstarted jobs; a speculation-off doc pays no probe
            if self._speculation:
                for spec_ns, phase in ((MAP_NS, "map"), (PRE_NS, "reduce")):
                    if phase not in self.phases:
                        continue
                    if spec_ns == PRE_NS and not task.get("pipeline"):
                        continue
                    clone = self.store.claim_spec(spec_ns, self.name)
                    if clone is not None:
                        self._idle_count = 0
                        self.run_one(spec, spec_ns, clone)
                        return "executed"
            if "map" not in self.phases:
                return "out-of-phase"
            self._idle_count += 1
            return "idle"

        if task["status"] == TaskStatus.REDUCE.value:
            # lost-data recovery: when every copy of a run or spill is
            # gone, the server requeues the PRODUCING map job (and
            # republishes the covering pre_merge) during the reduce
            # phase. The probes are gated on redundancy, so an
            # unreplicated fleet pays no extra claim round trip, and run
            # BEFORE the reduce claim: in a fleet of one dual-phase
            # worker a released lost-data reduce would otherwise be
            # reclaimed every poll and starve its own requeued producer
            if redundancy_on(doc_redundancy(task)):
                if "map" in self.phases:
                    jobs = self.store.claim_batch(
                        MAP_NS, self.name, self._effective_k(MAP_NS, task))
                    if jobs:
                        self._execute_batch(spec, MAP_NS, jobs)
                        return "executed"
                if "reduce" in self.phases and task.get("pipeline"):
                    jobs = self.store.claim_batch(
                        PRE_NS, self.name, self._effective_k(PRE_NS, task))
                    if jobs:
                        self._execute_batch(spec, PRE_NS, jobs)
                        return "executed"
            if "reduce" not in self.phases:
                return "out-of-phase"
            jobs = self.store.claim_batch(
                RED_NS, self.name, self._effective_k(RED_NS, task))
            if jobs:
                self._execute_batch(spec, RED_NS, jobs)
                return "executed"
            if self._speculation:
                clone = self.store.claim_spec(RED_NS, self.name)
                if clone is not None:
                    self.run_one(spec, RED_NS, clone)
                    return "executed"
            return "idle"

        raise RuntimeError(f"unknown task status {task['status']!r}")

    # -- batch-lease sizing --------------------------------------------------

    def _effective_k(self, ns: str, task: dict) -> int:
        """How many jobs the next lease should hold: this worker's
        ``batch_k`` (else the task document's), shrunk so one lease holds
        about ``batch_lease_s`` of work — long jobs degrade to k=1, an
        unknown duration probes with k=1 — and never past a bounded
        worker's remaining job budget."""
        cap = self.batch_k
        if cap is None:
            cap = int(task.get("batch_k") or 1)
        if self.max_jobs is not None:
            cap = min(cap, self.max_jobs - self.jobs_executed
                      + self._jobs_at_start)
        if cap <= 1:
            return max(1, cap)
        dur = self._dur_ewma.get(ns)
        if dur is None:
            return 1                    # first job calibrates the EWMA
        if dur <= 0:
            return cap
        return max(1, min(cap, int(self.batch_lease_s / dur)))

    def _note_duration(self, ns: str, real_s: float) -> None:
        prev = self._dur_ewma.get(ns)
        if prev is None:
            self._dur_ewma[ns] = real_s
        else:
            alpha = _DUR_ALPHA
            # a doc-seeded worker's FIRST own job carries its warm-up:
            # an overshoot of the seed folds at a quarter weight
            if (ns in self._ewma_seeded
                    and self._ewma_own_n.get(ns, 0) == 0
                    and real_s > prev):
                alpha = _DUR_ALPHA / 4.0
            self._dur_ewma[ns] = alpha * real_s + (1 - alpha) * prev
        self._ewma_own_n[ns] = self._ewma_own_n.get(ns, 0) + 1

    # -- job execution ------------------------------------------------------

    @contextlib.contextmanager
    def _beating(self, ns: str, jids: List[int],
                 revoked: Optional[threading.Event] = None):
        """Heartbeat every leased job every ``heartbeat_s`` seconds from
        ONE daemon thread while the job bodies run. Best effort: a failed
        beat logs and retries with backoff (a dead beat thread would let
        the server requeue a LIVE worker's job); the ownership CAS keeps
        correctness either way. ``revoked`` is set the moment a beat
        lands on fewer jobs than the lease holds: a lease member left the
        leased states under this worker (a speculative duplicate
        committed it first) — no extra RPC, the signal rides the
        beats."""
        if not self.heartbeat_s:
            yield
            return
        stop = threading.Event()

        def beat():
            failures = 0
            delay = self.heartbeat_s
            tracer = active_tracer()
            if tracer is not None:
                tracer.set_actor(self.name)    # beat spans name the worker
            while not stop.wait(delay):
                try:
                    n = self.store.heartbeat_batch(ns, jids, self.name)
                    if revoked is not None and n < len(jids):
                        revoked.set()
                    failures = 0
                    delay = self.heartbeat_s
                except Exception as e:
                    failures += 1
                    delay = min(self.heartbeat_s,
                                0.05 * (2.0 ** min(failures, 10)))
                    _log.warning("[%s] heartbeat failed (%dx: %s: %s); "
                                 "retrying in %.2fs", self.name, failures,
                                 type(e).__name__, e, delay)

        t = threading.Thread(target=beat, daemon=True,
                             name=f"{self.name}-hb-{ns}")
        t.start()
        try:
            yield
        finally:
            stop.set()
            t.join(timeout=5.0)

    # -- hybrid compiled legs ------------------------------------------------

    def _hybrid_stages(self, spec: TaskSpec):
        """The per-stage split this worker runs compiled: the task
        document's server-negotiated verdicts win. A doc that carries an
        engine knob but no split negotiated a non-hybrid plane. Only a
        doc with no engine knob at all falls back to this worker's own
        oracle pass, and only when LMR_ENGINE asks for it."""
        stages = self._task_hybrid_stages
        if isinstance(stages, dict):
            return stages
        if self._task_engine is not None:
            return None
        env = os.environ.get("LMR_ENGINE")
        if env not in ("hybrid", "auto"):
            return None
        key = id(spec)
        if key not in self._own_stages:
            from lua_mapreduce_tpu_torch.engine.ingraph import select_engine
            d = select_engine(spec, env)
            self._own_stages[key] = (d.stages if d.chosen == "hybrid"
                                     else None)
        return self._own_stages[key]

    def _hybrid_runtime(self, spec: TaskSpec):
        """(map engine, reduce fold) for the current task, minted lazily
        and cached per (spec, split), on this worker's device; a slot is
        None when that leg is off or retired after a failure."""
        stages = self._hybrid_stages(spec)
        if not stages or not any(stages.values()):
            return None, None
        key = (id(spec), bool(stages.get("map")),
               bool(stages.get("reduce")))
        if self._hybrid_rt is None or self._hybrid_rt[0] != key:
            from lua_mapreduce_tpu_torch.engine.hybrid import (
                HybridMapEngine, HybridReduceFold)
            dev = self.device
            self._hybrid_rt = (
                key,
                HybridMapEngine(spec, device=dev) if stages.get("map")
                else None,
                HybridReduceFold(spec, device=dev) if stages.get("reduce")
                else None)
        return self._hybrid_rt[1], self._hybrid_rt[2]

    def _stash_hybrid_map(self, spec: TaskSpec, jobs: List[dict]) -> None:
        """Run a leased map batch through the compiled map leg up front
        and stash the per-job groupings by job id for _map_body to
        publish inside the ordinary lease loop. Any failure leaves the
        stash empty and retires the leg for the task (counted, logged):
        the lease then runs interpreted, byte-identically."""
        self._hybrid_stash = {}
        engine, _ = self._hybrid_runtime(spec)
        if engine is None or not jobs:
            return
        t0 = time.time()
        try:
            per_job = engine.run_batch([(j["key"], j["value"])
                                        for j in jobs])
        except Exception as exc:        # noqa: BLE001 — degrade policy
            reason = f"{type(exc).__name__}: {exc}"
            COUNTERS.bump("hybrid_fallbacks")
            from lua_mapreduce_tpu_torch.engine.ingraph import \
                record_hybrid_fallback
            record_hybrid_fallback("map", reason)
            print(f"[{self.name}] compiled map leg failed ({reason}); map "
                  "jobs run interpreted", flush=True)
            self._hybrid_rt = (self._hybrid_rt[0], None, self._hybrid_rt[2])
            return
        self._hybrid_stash = {j["_id"]: g for j, g in zip(jobs, per_job)}
        COUNTERS.bump("hybrid_map_legs")
        tracer = active_tracer()
        if tracer is not None:
            # recorded after the leg with its measured window: no span is
            # open while the leg captures or replays
            now = tracer.clock()
            tracer.add("hybrid.run", now - (time.time() - t0), now,
                       ns="hybrid", stage="map", job_id=jobs[0]["_id"],
                       jobs=len(jobs), mode=engine.mode,
                       traces=engine.traces)

    # -- job bodies -----------------------------------------------------------

    def _segment_format(self) -> str:
        """The spill encoding this worker writes: its own override, else
        the task document's fleet default, else v1."""
        return self.segment_format or self._task_segment_format or "v1"

    def _replication(self):
        """The unified shuffle redundancy this worker publishes and reads
        with — an int factor or a Coding: its own coding override, else
        its own replication override, else the task document's deployed
        value (coding spec first), else 1 (off)."""
        if self.coding is not None:
            return check_redundancy(self.coding)
        if self.replication is not None:
            return check_redundancy(self.replication)
        return doc_redundancy({"replication": self._task_replication,
                               "coding": self._task_coding})

    def _push_on(self) -> bool:
        """Whether this worker publishes map output through the push
        shuffle: its own override, else the task document's marker."""
        if self.push is not None:
            return bool(self.push)
        return bool(self._task_push)

    def _push_pool(self):
        """This worker's memory-budgeted push buffer pool, minted lazily:
        the budget bounds what this loop's map bodies may hold in
        unpublished frames (``push_budget_mb``, else an autotuned task
        doc's controller-owned budget, else LMR_PUSH_BUDGET_MB, else the
        default)."""
        if self._push_pool_obj is None:
            budget = (self.push_budget_mb if self.push_budget_mb is not None
                      else self._task_push_budget)
            self._push_pool_obj = BufferPool(resolve_push_budget(budget))
        return self._push_pool_obj

    def _follow_autotune(self, task: dict) -> None:
        """Apply the task doc's controller-owned knobs; entered only under
        the doc's ``autotune`` marker. batch_k and speculation follow the
        doc anyway; this covers the two knobs that live in process
        state: the retry back-off base and the push pool's budget
        (re-budgeted in place: frames already charged keep their
        accounting, only the eviction threshold moves)."""
        v = task.get("retry_base_ms")
        if v is not None and v != self._autotune_retry_ms:
            from lua_mapreduce_tpu_torch.faults.retry import (
                configure_retry, retry_settings)
            configure_retry(retries=int(retry_settings()["retries"]),
                            base_ms=float(v))
            self._autotune_retry_ms = v
        b = task.get("push_budget_mb")
        if b is not None:
            self._task_push_budget = float(b)
            if self.push_budget_mb is None \
                    and self._push_pool_obj is not None:
                new_budget = int(float(b) * 1024 * 1024)
                if new_budget != self._push_pool_obj.budget:
                    self._push_pool_obj.budget = new_budget

    def _map_body(self, spec: TaskSpec, job: dict) -> JobTimes:
        store = get_storage_from(spec.storage)
        push_on = self._push_on()
        pool = self._push_pool() if push_on else None
        # a clone's pushes are QUARANTINED under its spec identity until
        # its commit wins (run_one promotes them)
        lineage = (lineage_token(self.name)
                   if push_on and job.get("speculative") else None)
        groups = self._hybrid_stash.pop(job["_id"], None)
        if groups is not None:
            # compiled map leg: mapfn+combiner already ran in the lease's
            # batch program — only the shared publish tail remains
            times = JobTimes(started=time.time())
            publish_map_groups(spec, store, str(job["_id"]), groups,
                               segment_format=self._segment_format(),
                               replication=self._replication(),
                               push=push_on, push_pool=pool,
                               spec_lineage=lineage,
                               fence=self._lease_fence(MAP_NS, job),
                               leftovers=job.get("leftovers") or ())
            times.finished = times.written = time.time()
            return times
        return run_map_job(spec, store, str(job["_id"]), job["key"],
                           job["value"],
                           segment_format=self._segment_format(),
                           replication=self._replication(), push=push_on,
                           push_pool=pool, spec_lineage=lineage,
                           fence=self._lease_fence(MAP_NS, job),
                           leftovers=job.get("leftovers") or ())

    def _premerge_body(self, spec: TaskSpec, job: dict) -> JobTimes:
        """Consolidate committed runs into a spill (pipelined shuffle);
        run_premerge_job's spill-exists short-circuit covers a
        lost-then-reclaimed job whose first claimant already published."""
        v = job["value"]
        return run_premerge_job(spec, get_storage_from(spec.storage),
                                v["files"], v["spill"],
                                segment_format=self._segment_format(),
                                replication=self._replication(),
                                fence=self._lease_fence(PRE_NS, job))

    def _reduce_body(self, spec: TaskSpec, job: dict) -> JobTimes:
        replication = self._replication()
        # the failover view: the visibility check below answers for
        # LOGICAL files (any surviving copy), and the merge's reads fail
        # over per file. Identity when redundancy is off.
        store = reading_view(get_storage_from(spec.storage), replication)
        result_store = (get_storage_from(spec.result_storage)
                        if spec.result_storage else store)
        v = job["value"]
        fence = self._lease_fence(RED_NS, job)
        # pull-integrity check: every producer's run must be visible
        # BEFORE the merge starts. A missing run fails loudly and names
        # its producer (the sshfs scp-from-mapper failure, fs.lua:148-157)
        # instead of silently reducing fewer runs. The ``.*`` glob covers
        # raw runs and pre-merged ``.SPILL-*`` inputs, never the
        # partition's own result file.
        visible = set(store.list(f"{spec.result_ns}.P{v['part']}.*"))
        missing = [f for f in v["files"] if f not in visible]
        if missing:
            if result_store.exists(v["result"]):
                # duplicate execution after a stale requeue: the first
                # claimant already published this partition (an atomic
                # build) and began deleting the consumed runs — finish
                # the claim and sweep the leftovers
                times = JobTimes(started=time.time())
                if fence is None or fence():
                    for name in v["files"]:
                        store.remove(name)
                times.finished = times.written = time.time()
                return times
            if redundancy_on(replication):
                # every copy gone: a recoverable loss, not a dead job —
                # released (no repetition charge), naming the files so
                # the server repairs them or requeues their producers
                raise LostShuffleDataError(
                    f"reduce {v['part']}: {len(missing)} run file(s) "
                    f"lost with no surviving replica: {missing[:3]} — "
                    "awaiting scavenger repair or producer re-run",
                    op="reduce", name=missing[0], files=missing)
            raise RuntimeError(
                f"reduce {v['part']}: {len(missing)} run file(s) not "
                f"visible in storage (producers: "
                f"{v.get('mappers') or 'unknown'}): {missing[:3]} — "
                "cross-host pools need a backend every host can reach")
        _, fold = self._hybrid_runtime(spec)
        times = run_reduce_job(spec, store, result_store, str(v["part"]),
                               v["files"], v["result"],
                               replication=replication, reduce_fold=fold,
                               fence=fence)
        if fold is not None and fold.take_used():
            COUNTERS.bump("hybrid_reduce_legs")
        return times

    _BODIES = {MAP_NS: _map_body, PRE_NS: _premerge_body,
               RED_NS: _reduce_body}
    _LABELS = {MAP_NS: "map", PRE_NS: "pre_merge", RED_NS: "reduce"}

    # -- tracing hooks --------------------------------------------------------

    def _body_span(self, ns: str, label: str, job: dict):
        """The job-body span: the claim → body → commit chain's middle
        link and the parent of every store op inside the body. A no-op
        context when tracing is off."""
        tracer = active_tracer()
        if tracer is None:
            return contextlib.nullcontext()
        attrs = {"speculative": True} if job.get("speculative") else {}
        return tracer.span(f"{label}.body", ns=ns, job_id=job["_id"],
                           attempt=int(job.get("repetitions") or 0),
                           **attrs)

    def _trace_flush(self, force: bool = False) -> None:
        """Publish buffered spans through the task's storage: a soft
        flush after each lease, a forced one when the worker leaves.
        Best effort — a failed flush re-buffers and never sinks a job."""
        tracer = active_tracer()
        if tracer is None or self._last_spec is None:
            return
        try:
            tracer.flush(get_storage_from(self._last_spec.storage),
                         force=force)
        except Exception as exc:
            _log.warning("[%s] trace flush failed (%s: %s); spans "
                         "re-buffered", self.name, type(exc).__name__, exc)

    def _execute_batch(self, spec: TaskSpec, ns: str,
                       jobs: List[dict]) -> None:
        """Execute a claimed lease back to back and retire it in one
        commit. The lease shares one heartbeat thread. A failure on job
        i commits the i completed jobs, RELEASES the unstarted tail back
        to WAITING (no repetition bump), then releases the failing job
        (a classified transient store fault, within this worker's
        budget) or marks it BROKEN, and re-raises. Jobs whose claim was
        lost mid-lease are skipped by the commit's ownership CAS; once a
        beat comes up short, each remaining job's lease is probed and a
        revoked one (a duplicate committed it) is not run at all."""
        body = self._BODIES[ns]
        label = self._LABELS[ns]
        if ns == MAP_NS:
            self._stash_hybrid_map(spec, jobs)
        jids = [j["_id"] for j in jobs]
        done: List[tuple] = []          # (jid, times_dict), commit order
        revoked = threading.Event()
        skipped: List[int] = []
        with self._beating(ns, jids, revoked=revoked):
            for pos, job in enumerate(jobs):
                if pos and revoked.is_set() \
                        and not self.store.heartbeat(ns, job["_id"],
                                                     self.name):
                    # this job's lease is confirmed gone (a speculative
                    # duplicate committed it): running it would be pure
                    # waste — the commit CAS would refuse it anyway
                    skipped.append(job["_id"])
                    continue
                sp = None
                self.bodies[label] = self.bodies.get(label, 0) + 1
                try:
                    with self._body_span(ns, label, job) as sp:
                        times = body(self, spec, job)
                except Exception as exc:
                    committed = self.store.commit_batch(ns, self.name, done)
                    self._settle_committed(ns, committed)
                    if committed:
                        self._notify("done")
                    if self.store.release_batch(ns, self.name,
                                                jids[pos + 1:]):
                        # the released tail is claimable again
                        self._notify("jobs")
                    if (is_transient_job_fault(exc)
                            and self._release_budget_ok(ns, job["_id"])):
                        self._release_infra(ns, job["_id"], exc, span=sp)
                    else:
                        self._mark_broken(ns, job["_id"], exc, span=sp)
                    raise
                self._note_duration(ns, times.real)
                done.append((job["_id"], _times_dict(times)))
                self._log(f"{label} job {job['_id']} done "
                          f"({times.real:.3f}s)"
                          + (f" [{pos + 1}/{len(jobs)}]"
                             if len(jobs) > 1 else ""))
        committed = self.store.commit_batch(ns, self.name, done)
        self._settle_committed(ns, committed)
        if committed:
            self._notify("done")     # the server's barrier wakeup
            # only WINNING observations calibrate the fleet aggregate: a
            # straggler whose commits keep losing must not inflate the
            # EWMA the detector compares it against
            self._persist_ewma(ns)
        lost = len(done) - len(committed)
        if lost:
            if self._speculation:
                # a lost claim under speculation is a lost commit race:
                # this worker was the straggler and a clone covered it
                won = set(committed)
                COUNTERS.bump("spec_wasted_s",
                              sum(t["real"] for jid, t in done
                                  if jid not in won and t))
            self._log(f"{label}: {lost} claim(s) lost mid-lease; yielded")
        if skipped:
            self._log(f"{label}: {len(skipped)} leased job(s) revoked "
                      "mid-lease (a duplicate committed first); skipped")
        self._trace_flush()

    # -- speculative execution (duplicate leases) ----------------------------

    def run_one(self, spec: TaskSpec, ns: str, job: dict) -> bool:
        """Execute ONE speculative clone of a straggler's job and race
        its commit against the original: first commit wins. A clone that
        loses, fails or sees its lease revoked never touches the job's
        status or repetitions — it dissolves its shadow lease
        (``cancel_spec``) and walks away; the original still owns the
        claim. Spill publishes are idempotent (atomic overwrites of
        deterministic bytes), which is what makes duplicate execution
        safe. Returns True when this clone WON the commit race."""
        jid = job["_id"]
        label = self._LABELS[ns]
        revoked = threading.Event()
        t0 = time.time()
        try:
            with self._beating(ns, [jid], revoked=revoked):
                # the original may have committed between claim_spec and
                # here; the beat also refreshes the shared record
                if not self.store.heartbeat(ns, jid, self.name):
                    self._spec_lost(ns, jid, 0.0,
                                    f"{label} clone {jid}: decided before "
                                    "the body started")
                    return False
                self.bodies[label] = self.bodies.get(label, 0) + 1
                with self._body_span(ns, label, job):
                    times = self._BODIES[ns](self, spec, job)
        except Exception as exc:
            self._spec_lost(ns, jid, time.time() - t0,
                            f"{label} clone {jid}: body failed "
                            f"({type(exc).__name__}: {exc}) — the original "
                            "keeps the lease, nothing charged")
            return False
        if revoked.is_set():
            # the beat saw the lease gone mid-body (the original won, or
            # the detector retracted this clone): the commit would miss
            self._spec_lost(ns, jid, time.time() - t0,
                            f"{label} clone {jid}: revoked mid-body — "
                            "commit skipped")
            return False
        push_map = ns == MAP_NS and self._push_on()
        over = push_map and manifest_name(
            spec.result_ns, map_key_str(jid)) in (job.get("leftovers") or ())
        if over:
            # the canonical manifest is an earlier iteration's leftover:
            # the commit makes the job WRITTEN and discovery may read the
            # canonical manifest at once, so this lineage is published
            # over the leftover first. Should the commit then lose, the
            # canonical lineage is this complete one, as when an original
            # publishes over a clone's promote.
            try:
                promote(get_storage_from(spec.storage), spec.result_ns,
                        map_key_str(jid), lineage_token(self.name),
                        self._replication(), publish_over=True)
            except Exception as exc:
                self._spec_lost(ns, jid, time.time() - t0,
                                f"{label} clone {jid}: promote over the "
                                f"leftover failed ({type(exc).__name__}: "
                                f"{exc}) — commit skipped")
                return False
        committed = self.store.commit_batch(ns, self.name,
                                            [(jid, _times_dict(times))])
        if not committed:
            self._spec_lost(ns, jid, time.time() - t0,
                            f"{label} clone {jid}: lost the commit race")
            return False
        if push_map and not over:
            # first-commit-wins decided: this clone's quarantined inbox
            # lineage becomes the visible one. Best effort — the
            # server's ensure_canonical promotes a complete spec lineage
            # behind a WRITTEN job whose promoter died here
            try:
                promote(get_storage_from(spec.storage), spec.result_ns,
                        map_key_str(jid), lineage_token(self.name),
                        self._replication())
            except Exception as exc:
                _log.warning("[%s] push promote failed (%s: %s); the "
                             "server's backstop covers it", self.name,
                             type(exc).__name__, exc)
        self._notify("done")
        COUNTERS.bump("spec_wins")
        self._note_duration(ns, times.real)
        self._settle_committed(ns, committed)
        self._persist_ewma(ns)
        self._log(f"{label} clone {jid} WON the commit race "
                  f"({times.real:.3f}s)")
        self._trace_flush()
        return True

    def _lease_fence(self, ns: str, job: dict):
        """The job body's lease check under speculation, else None.

        A straggler and its clone run one job at once by design, and the
        loser may finish after the winner's commit: late enough that the
        server has opened the next loop iteration, whose runs, spills and
        results reuse this iteration's names. The body calls the check
        right before it publishes and right before it sweeps consumed
        inputs, and does neither once this worker's lease (its claim or
        its shadow lease) is gone."""
        if not self._speculation:
            return None
        jid = job["_id"]
        return lambda: self.store.heartbeat(ns, jid, self.name)

    def _spec_lost(self, ns: str, jid: int, wasted_s: float,
                   msg: str) -> None:
        """A clone that did not win: dissolve the shadow lease and book
        the wasted seconds — no status op is ever issued."""
        self.store.cancel_spec(ns, jid, self.name)
        COUNTERS.bump("spec_cancelled")
        if wasted_s > 0:
            COUNTERS.bump("spec_wasted_s", wasted_s)
        self._log(msg)
        self._trace_flush()

    def _persist_ewma(self, ns: str) -> None:
        """Fold this worker's per-namespace duration EWMA into the task
        document's fleet aggregate, which the server's straggler detector
        and fresh workers read. Rides the lease-end commit and skips a
        value within 10% of the last one pushed, so the fault-free cost
        is one extra ``update_task`` per meaningful shift."""
        mine = self._dur_ewma.get(ns)
        if mine is None or mine <= 0:
            return
        # a doc-seeded worker waits for two own observations: before
        # that its estimate is mostly the doc's value plus one possibly
        # warm-up-inflated sample
        if ns in self._ewma_seeded and self._ewma_own_n.get(ns, 0) < 2:
            return
        last = self._ewma_pushed.get(ns)
        if last is not None and abs(mine - last) < 0.1 * last:
            return
        fleet = self._fleet_ewma.get(ns)
        merged = (mine if not fleet
                  else _FLEET_ALPHA * mine + (1 - _FLEET_ALPHA) * fleet)
        try:
            self.store.update_task({f"dur_ewma:{ns}": merged})
        except Exception:
            return          # no task doc / a store blip: purely advisory
        self._fleet_ewma[ns] = merged
        self._ewma_pushed[ns] = mine

    def _settle_committed(self, ns: str, committed: List[int]) -> None:
        """Book committed jobs: execution count + map affinity."""
        self.jobs_executed += len(committed)
        if ns == MAP_NS:
            for jid in committed:
                if jid not in self._affinity:
                    self._affinity.append(jid)

    @staticmethod
    def _error_info(ns: str, jid: int, exc: Exception,
                    span: Optional[dict] = None) -> dict:
        """Structured post-mortem fields for an errors-stream entry.
        Store faults that name a shuffle file also carry ``lost_files``
        (sorted logical names): the server's scavenger repairs each from
        a surviving copy, or requeues its producer when every copy is
        gone. Under tracing, ``span`` is the job-body span live when the
        fault fired: its deterministic id links the entry to its
        timeline."""
        info = {"exc_class": type(exc).__name__,
                "exc_msg": str(exc)[:500],
                "classification": classify_job_fault(exc),
                "ns": ns, "job_id": jid}
        if span is not None:
            info["span_id"] = span["sid"]
            info["span_worker"] = span["worker"]
        lost = getattr(exc, "lost_files", None)
        if lost:
            info["lost_files"] = sorted({base_name(n) for n in lost})
        elif (isinstance(exc, StoreError) and exc.name
              and exc.op in ("lines", "read_range", "size")):
            # a data-plane read fault names ONE file: the mid-stream
            # shape (the copy died under a running merge) that the
            # failover view cannot absorb without duplicating records
            info["lost_files"] = [base_name(exc.name)]
        return info

    def _release_budget_ok(self, ns: str, jid: int) -> bool:
        """Liveness backstop for the release path: this worker releases
        any one job at most MAX_JOB_RETRIES times; past that the
        'transient' fault is pinned to the job and it marches through
        BROKEN→FAILED like any deterministic failure."""
        key = (ns, jid)
        n = self._infra_released.get(key, 0) + 1
        self._infra_released[key] = n
        return n <= MAX_JOB_RETRIES

    def _release_infra(self, ns: str, jid: int, exc: Exception,
                       span: Optional[dict] = None) -> None:
        """Transient-infra failure path: job → WAITING with no repetition
        charge (CASed on ownership), error → errors stream."""
        if self.store.set_job_status(ns, jid, Status.WAITING,
                                     expect=(Status.RUNNING,),
                                     expect_worker=self.name):
            self._notify("jobs")     # claimable again: wake the fleet
        COUNTERS.bump("infra_releases")
        self.store.insert_error(self.name, self._abbrev_tb(),
                                info=self._error_info(ns, jid, exc,
                                                      span=span))
        self._log(f"job {jid}: transient infra fault "
                  f"({type(exc).__name__}) — released to WAITING, "
                  "no repetition charged")

    @staticmethod
    def _abbrev_tb(max_lines: int = 30) -> str:
        """The current exception's traceback, cut to its tail."""
        lines = traceback.format_exc().splitlines()
        if len(lines) > max_lines:
            lines = [f"... ({len(lines) - max_lines} traceback lines "
                     "elided) ..."] + lines[-max_lines:]
        return "\n".join(lines)

    def _mark_broken(self, ns: str, jid: int, exc: Exception,
                     span: Optional[dict] = None) -> None:
        """Job → BROKEN (+1 repetition) and error → errors stream
        (reference job.lua:322-342, cnn.lua:62-66). CASed on ownership
        AND on the job still being RUNNING, so a requeued (already
        counted) or scavenged (FAILED is terminal) job is left alone."""
        if self.store.set_job_status(ns, jid, Status.BROKEN,
                                     expect=(Status.RUNNING,),
                                     expect_worker=self.name):
            self._notify("jobs")     # BROKEN is claimable: wake the fleet
        self.store.insert_error(self.name, self._abbrev_tb(),
                                info=self._error_info(ns, jid, exc,
                                                      span=span))

    # -- main loop ----------------------------------------------------------

    def execute(self) -> int:
        """Run until ``max_iter`` idle polls or ``max_tasks`` tasks
        completed (reference worker.lua:42-138). Returns jobs executed.
        User-code errors mark the job BROKEN and count against
        MAX_WORKER_RETRIES: the worker dies after 3 consecutive failures
        (worker.lua:133-137). Classified transient store faults back off
        and re-poll instead (up to MAX_INFRA_POLL_FAILURES)."""
        self._jobs_at_start = self.jobs_executed
        # this thread's worker identity for the fault plane (the `slow`
        # kind routes by it) and the tracer (span worker fields)
        set_current_worker(self.name)
        tracer = active_tracer()
        if tracer is not None:
            tracer.set_actor(self.name)
        try:
            return self._execute_loop()
        finally:
            set_current_worker(None)
            # residual spans outlive the worker
            self._trace_flush(force=True)
            if tracer is not None:
                tracer.set_actor(None)

    def _execute_loop(self) -> int:
        retries = infra_fails = idle_iters = tasks_done = 0
        floor = min(DEFAULT_SLEEP, self._idle_cap())
        sleep = floor
        saw_work = False
        while idle_iters < self.max_iter and tasks_done < self.max_tasks:
            if (self.max_jobs is not None and
                    self.jobs_executed - self._jobs_at_start >= self.max_jobs):
                self._log(f"leaving after {self.max_jobs} jobs "
                          "(bounded lifetime)")
                break
            try:
                outcome = self.poll_once()
            except Exception as exc:
                if is_transient_job_fault(exc):
                    infra_fails += 1
                    if infra_fails >= MAX_INFRA_POLL_FAILURES:
                        self._log(f"coord/store still failing after "
                                  f"{infra_fails} backoffs; giving up")
                        raise
                    delay = min(2.0, 0.05 * (2.0 ** min(infra_fails, 10)))
                    _log.warning("[%s] poll failed on transient infra "
                                 "fault (%dx: %s: %s); retrying in %.2fs",
                                 self.name, infra_fails,
                                 type(exc).__name__, exc, delay)
                    self._backoff_wait(delay)
                    continue
                retries += 1
                if retries >= MAX_WORKER_RETRIES:
                    self._log(f"giving up after {retries} failures")
                    raise
                self._backoff_wait(floor)
                continue
            retries = infra_fails = 0
            if outcome == "executed":
                saw_work = True
                idle_iters = 0
                sleep = floor
            elif outcome == "finished" and saw_work:
                tasks_done += 1
                saw_work = False
            else:
                # capped jittered back-off the waiter interrupts
                # (worker.lua:100-102's growth, capped at the idle-poll
                # cap): a wakeup resets the interval. Only timed-out waits
                # drain the idle budget — a busy shared bus must not idle
                # this worker out in milliseconds — and a worker waiting
                # out the other phase must not burn it at all.
                woken, sleep = self._idle_wait(sleep)
                if not woken and outcome != "out-of-phase":
                    idle_iters += 1
        return self.jobs_executed

    # -- helpers ------------------------------------------------------------

    def _get_spec(self, desc: dict) -> TaskSpec:
        """The task's TaskSpec, built once per description (and its init
        hooks run once), with the device it runs on resolved — a card
        unless the task asks for the CPU."""
        cached = self._spec_by_id
        if cached is None or cached[0] is not desc:
            key = json.dumps(desc, sort_keys=True, default=str)
            entry = self._spec_cache.get(key)
            if entry is None:
                device = resolve_device(
                    (desc.get("init_args") or {}).get("device"))
                entry = (TaskSpec.from_description(desc), device)
                self._spec_cache[key] = entry
            self._spec_by_id = cached = (desc, entry)
        spec, self.device = cached[1]
        return spec

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[{self.name}] {msg}", flush=True)


def _times_dict(times: JobTimes) -> dict:
    return {"started": times.started, "finished": times.finished,
            "written": times.written, "cpu": times.cpu, "real": times.real}


def utest() -> None:
    """Self-test (reference worker.lua:172-173 — empty there; here the
    config surface and the idle path are actually exercised): unknown
    config keys are rejected, and an execute() against a task-less store
    idles out without claiming anything."""
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore

    w = Worker(MemJobStore(), name="utest-w")
    try:
        w.configure(bogus_key=1)
    except KeyError:
        pass
    else:
        raise AssertionError("unknown config key must be rejected")
    w.configure(max_iter=2, max_sleep=0.01)
    assert w.execute() == 0                 # nothing to claim: idles out
    assert w.jobs_executed == 0
