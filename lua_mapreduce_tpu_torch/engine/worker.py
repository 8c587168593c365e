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

Trimmed from the JAX worker, to be ported with ROADMAP A6b: the push
shuffle, speculative duplicate leases, autotune following, replication
and erasure coding, and the notify waiter. An idle worker polls on a
back-off that doubles up to ``max_sleep``. Those options are accepted
only at their "off" value, and a task document that deploys one of
them is refused.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
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
from lua_mapreduce_tpu_torch.engine.job import (JobTimes, publish_map_groups,
                                                run_map_job,
                                                run_premerge_job,
                                                run_reduce_job)
from lua_mapreduce_tpu_torch.faults.errors import (classify_job_fault,
                                                   is_transient_job_fault)
from lua_mapreduce_tpu_torch.faults.plan import set_current_worker
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
                "heartbeat_s", "batch_k", "batch_lease_s", "segment_format")

# JAX-worker options this port does not implement, with the values that
# select the behaviour it does implement (ROADMAP A6b)
_OFF_VALUES = {
    "replication": (None, 1),
    "coding": (None,),
    "idle_poll_ms": (None,),
    "push": (None, False),
    "push_budget_mb": (None,),
}

# EWMA smoothing for the observed per-job duration that sizes batch
# leases (recent jobs dominate)
_DUR_ALPHA = 0.3


def check_off(owner: str, name: str, value, off_values: dict) -> None:
    """Accept a trimmed option only at a value meaning "off"; any other
    value raises NotImplementedError naming the ROADMAP item that will
    port it."""
    if value not in off_values[name]:
        raise NotImplementedError(
            f"{owner} option {name}={value!r} is not ported to the torch "
            f"package yet (ROADMAP A6b; accepted: {off_values[name]})")


def check_task_doc(task: dict) -> None:
    """Refuse a task document that deploys a plane this port does not
    run (a JAX-package server sharing the store, say): a push shuffle,
    replication, coding, speculation or autotune. Running it without
    that plane would be a silently different run. The pipelined shuffle
    and both segment formats run here."""
    deployed = {
        "push": bool(task.get("push")),
        "replication": int(task.get("replication") or 1) != 1,
        "coding": bool(task.get("coding")),
        "speculation": bool(task.get("speculation")),
        "autotune": bool(task.get("autotune")),
    }
    on = [k for k, v in deployed.items() if v]
    if on:
        raise NotImplementedError(
            f"task document deploys {on}, which the torch package does "
            "not run yet (ROADMAP A6b)")


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
        self._last_spec = None          # where trace flushes publish
        self._dur_ewma: Dict[str, float] = {}   # ns -> smoothed real secs
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
        self._jobs_at_start = 0

    def configure(self, **params) -> "Worker":
        """Set the loop knobs; unknown keys are rejected (reference
        worker.lua:142-148), trimmed ones accepted only when off."""
        for k, v in params.items():
            if k in _OFF_VALUES:
                check_off("Worker", k, v, _OFF_VALUES)
                continue
            if k not in _CONFIG_KEYS:
                raise KeyError(f"unknown worker config key {k!r}; "
                               f"known: {_CONFIG_KEYS}")
            if k == "segment_format" and v is not None:
                # fail at configure time, not as a per-job failure storm
                from lua_mapreduce_tpu_torch.core.segment import \
                    check_format
                check_format(v)
            setattr(self, k, v)
        return self

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
        check_task_doc(task)

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

        if task["status"] == TaskStatus.MAP.value:
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
            # reduce-phase filter, as idle-capacity work (map progress
            # first); the doc marker gates the probe, so barrier tasks
            # pay no extra claim round trip
            if "reduce" in self.phases and task.get("pipeline"):
                jobs = self.store.claim_batch(
                    PRE_NS, self.name, self._effective_k(PRE_NS, task))
                if jobs:
                    self._idle_count = 0
                    self._execute_batch(spec, PRE_NS, jobs)
                    return "executed"
            if "map" not in self.phases:
                return "out-of-phase"
            self._idle_count += 1
            return "idle"

        if task["status"] == TaskStatus.REDUCE.value:
            if "reduce" not in self.phases:
                return "out-of-phase"
            jobs = self.store.claim_batch(
                RED_NS, self.name, self._effective_k(RED_NS, task))
            if jobs:
                self._execute_batch(spec, RED_NS, jobs)
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
        self._dur_ewma[ns] = (real_s if prev is None
                              else _DUR_ALPHA * real_s
                              + (1 - _DUR_ALPHA) * prev)

    # -- job execution ------------------------------------------------------

    @contextlib.contextmanager
    def _beating(self, ns: str, jids: List[int]):
        """Heartbeat every leased job every ``heartbeat_s`` seconds from
        ONE daemon thread while the job bodies run. Best effort: a failed
        beat logs and retries with backoff (a dead beat thread would let
        the server requeue a LIVE worker's job); the ownership CAS keeps
        correctness either way."""
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
                    self.store.heartbeat_batch(ns, jids, self.name)
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

    def _map_body(self, spec: TaskSpec, job: dict) -> JobTimes:
        store = get_storage_from(spec.storage)
        groups = self._hybrid_stash.pop(job["_id"], None)
        if groups is not None:
            # compiled map leg: mapfn+combiner already ran in the lease's
            # batch program — only the shared publish tail remains
            times = JobTimes(started=time.time())
            publish_map_groups(spec, store, str(job["_id"]), groups,
                               segment_format=self._segment_format())
            times.finished = times.written = time.time()
            return times
        return run_map_job(spec, store, str(job["_id"]), job["key"],
                           job["value"],
                           segment_format=self._segment_format())

    def _premerge_body(self, spec: TaskSpec, job: dict) -> JobTimes:
        """Consolidate committed runs into a spill (pipelined shuffle);
        run_premerge_job's spill-exists short-circuit covers a
        lost-then-reclaimed job whose first claimant already published."""
        v = job["value"]
        return run_premerge_job(spec, get_storage_from(spec.storage),
                                v["files"], v["spill"],
                                segment_format=self._segment_format())

    def _reduce_body(self, spec: TaskSpec, job: dict) -> JobTimes:
        store = get_storage_from(spec.storage)
        result_store = (get_storage_from(spec.result_storage)
                        if spec.result_storage else store)
        v = job["value"]
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
                for name in v["files"]:
                    store.remove(name)
                times.finished = times.written = time.time()
                return times
            raise RuntimeError(
                f"reduce {v['part']}: {len(missing)} run file(s) not "
                f"visible in storage (producers: "
                f"{v.get('mappers') or 'unknown'}): {missing[:3]} — "
                "cross-host pools need a backend every host can reach")
        _, fold = self._hybrid_runtime(spec)
        times = run_reduce_job(spec, store, result_store, str(v["part"]),
                               v["files"], v["result"], reduce_fold=fold)
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
        return tracer.span(f"{label}.body", ns=ns, job_id=job["_id"],
                           attempt=int(job.get("repetitions") or 0))

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
        lost mid-lease are skipped by the commit's ownership CAS."""
        body = self._BODIES[ns]
        label = self._LABELS[ns]
        if ns == MAP_NS:
            self._stash_hybrid_map(spec, jobs)
        jids = [j["_id"] for j in jobs]
        done: List[tuple] = []          # (jid, times_dict), commit order
        with self._beating(ns, jids):
            for pos, job in enumerate(jobs):
                sp = None
                try:
                    with self._body_span(ns, label, job) as sp:
                        times = body(self, spec, job)
                except Exception as exc:
                    committed = self.store.commit_batch(ns, self.name, done)
                    self._settle_committed(ns, committed)
                    self.store.release_batch(ns, self.name, jids[pos + 1:])
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
        lost = len(done) - len(committed)
        if lost:
            self._log(f"{label}: {lost} claim(s) lost mid-lease; yielded")
        self._trace_flush()

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
        Under tracing, ``span`` is the job-body span live when the fault
        fired: its deterministic id links the entry to its timeline."""
        info = {"exc_class": type(exc).__name__,
                "exc_msg": str(exc)[:500],
                "classification": classify_job_fault(exc),
                "ns": ns, "job_id": jid}
        if span is not None:
            info["span_id"] = span["sid"]
            info["span_worker"] = span["worker"]
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
        self.store.set_job_status(ns, jid, Status.WAITING,
                                  expect=(Status.RUNNING,),
                                  expect_worker=self.name)
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
        self.store.set_job_status(ns, jid, Status.BROKEN,
                                  expect=(Status.RUNNING,),
                                  expect_worker=self.name)
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
        floor = min(DEFAULT_SLEEP, self.max_sleep)
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
                    time.sleep(delay)
                    continue
                retries += 1
                if retries >= MAX_WORKER_RETRIES:
                    self._log(f"giving up after {retries} failures")
                    raise
                time.sleep(floor)
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
                # idle back-off (worker.lua:100-102), capped at max_sleep.
                # A worker waiting out the other phase must not burn its
                # idle budget and die before its phase opens.
                time.sleep(sleep)
                sleep = min(self.max_sleep, 2 * sleep)
                if outcome != "out-of-phase":
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
