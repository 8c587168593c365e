"""Single-controller orchestrator.

Port of ``lua_mapreduce_tpu/engine/server.py`` (reference
mapreduce/server.lua, SURVEY.md §3.1): owns the task lifecycle — insert
map jobs, wait for the elastic pool through the barrier poll (with the
BROKEN→FAILED scavenger, the stale requeue and the errors drain), build
reduce jobs from the discovered map-output partitions, fold statistics,
run finalfn, and honour the ``"loop"`` protocol. The task document in
the job store is the orchestrator checkpoint: a restarted server resumes
from it (server.lua:470-492's resume matrix), and a loop task's threaded
state is checkpointed beside it (``_state.<iteration>``).

The ``engine`` knob is the LocalExecutor's: an in-graph-verdicted task's
data plane runs as one captured program ON THIS SERVER, on the task's
``init_args["device"]`` (else ``"cuda"``), with no jobs inserted; the
hybrid rung's per-stage split is negotiated on the task document and
run by the workers.

``pipeline`` runs the pipelined shuffle: while map jobs run, the server
publishes eager ``pre_merge`` jobs over contiguous committed runs
(engine/premerge.py) and the reduce merges {spills + tail runs}; the
mode is sticky on resume from the task document. ``segment_format``
("v1"/"v2") is written to the task document for the workers. Coord RPCs
go through ``faults/wrappers.wrap_jobstore`` (retry, fault injection,
trace spans); with a tracer active the server records phase spans and
flushes the process's spans into the task storage.

``replication`` (an int r, or with ``coding`` a ``"k+m"`` spec) and
``push`` are written to the task document for the workers and are
sticky on resume, like ``pipeline``: a crashed redundant or push run
holds data that only a reader of the same mode can see. Under
redundancy the server runs the lost-file recovery: worker errors that
name ``lost_files`` are repaired from a surviving copy, or, when every
copy is gone, their producing map jobs are requeued during the reduce
phase (and a lost spill's pre-merge republished once they re-ran).

``speculation`` (None = ``LMR_SPECULATION``, else 0 = off) is the
straggler factor, written to the task document: the housekeeping pass
opens a speculative duplicate lease on a RUNNING job older than
``factor ×`` the fleet's duration EWMA for its namespace (folded onto the
task document by the workers), at most ``speculation_cap`` live clones
per namespace; idle workers race the clone against the original and the
first commit wins.

The barrier polls wait on the store's "done" wakeup channel
(sched/waiter.py): a worker's commit wakes them within milliseconds, and
a lost notification times out into the ``poll_interval`` poll. Inserts
and phase flips bump the "jobs" channel the idle workers wait on. With
``LMR_SCHED_NOTIFY=0`` every wait is the plain sleep; the output bytes
are the same either way.

``autotune`` (None = ``LMR_AUTOTUNE``, else off) runs the feedback
controller (sched/controller.py) on the housekeeping cadence: it
retunes batch_k, the push budget, the speculation factor, the retry
base and, with :meth:`Server.set_fleet`, the fleet size through the
task document, each change an ``autotune.<knob>`` span.

``ha`` (None = ``LMR_HA``, else off) runs the leader-lease election
(sched/lease.py) in :meth:`Server.loop`: the winner leads with every
server-side mutation fenced by its epoch; losers stand by on the
"leader" topic and take over mid-phase through the resume matrix when
the leader's lease (``lease_ttl_s``; None = ``LMR_LEASE_TTL_S``, else
10 s) expires.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from lua_mapreduce_tpu_torch.core.constants import (DEFAULT_SLEEP, MAP_NS,
                                                    MAX_JOB_RETRIES, PRE_NS,
                                                    RED_NS, Status,
                                                    TaskStatus)
from lua_mapreduce_tpu_torch.coord.jobstore import JobStore, make_job
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.job import JobTimes, map_key_str
from lua_mapreduce_tpu_torch.core.segment import (check_format,
                                                  purge_footer_cache)
from lua_mapreduce_tpu_torch.engine.local import (collect_task_jobs,
                                                  delete_results,
                                                  discover_partitions,
                                                  iter_results,
                                                  result_file_name)
from lua_mapreduce_tpu_torch.engine.premerge import (SPILL_TAG,
                                                     PremergeTracker,
                                                     discover_pipelined,
                                                     parse_spill_name,
                                                     run_name_re)
from lua_mapreduce_tpu_torch.engine.push import (INBOX_TAG, discover_push,
                                                 ensure_canonical,
                                                 manifest_files_by_part,
                                                 manifest_name,
                                                 parse_inbox_name,
                                                 parse_manifest_name,
                                                 push_file_lists,
                                                 resolve_push)
from lua_mapreduce_tpu_torch.faults.coded import (doc_fields, doc_redundancy,
                                                  redundancy_on,
                                                  resolve_redundancy)
from lua_mapreduce_tpu_torch.faults.replicate import reading_view, repair
from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
from lua_mapreduce_tpu_torch.faults.wrappers import unwrap, wrap_jobstore
from lua_mapreduce_tpu_torch.sched.lease import (STATE_NS, frame_state,
                                                 unframe_state)
from lua_mapreduce_tpu_torch.store.router import get_storage_from
from lua_mapreduce_tpu_torch.trace.span import TRACE_NS, active_tracer
from lua_mapreduce_tpu_torch.utils.stats import (IterationStats, TaskStats,
                                                 overlap_fraction)

def resolve_ha(arg) -> bool:
    """The HA knob: explicit argument, else the ``LMR_HA`` env
    ("1"/"true"/"yes"/"on"), else off. On, :meth:`Server.loop` runs the
    leader-lease election instead of assuming it is the only
    coordinator."""
    if arg is None:
        import os
        raw = os.environ.get("LMR_HA", "")
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return bool(arg)


def resolve_speculation(arg) -> float:
    """The straggler factor: explicit argument, else the
    ``LMR_SPECULATION`` env, else 0 (off). A RUNNING job older than
    ``factor × fleet duration EWMA`` gets a speculative duplicate lease;
    a factor below 1 would clone jobs younger than a typical job and is
    refused."""
    if arg is None:
        import os
        arg = os.environ.get("LMR_SPECULATION") or 0
    f = float(arg)
    if f and f < 1.0:
        raise ValueError(f"speculation factor {f} < 1 would clone jobs "
                         "younger than the typical job duration")
    return f


class PhaseFailed(RuntimeError):
    """A phase completed with FAILED jobs while the server ran in strict
    mode. The reference proceeds to finalfn on partial results
    (server.lua:192-205); for a finalfn that drives optimizer steps a
    partial gradient sum is a correctness hazard, so strict mode aborts
    instead. Carries the retained worker errors."""

    def __init__(self, phase: str, failed: int, total: int,
                 errors: List[dict]):
        self.phase = phase
        self.failed = failed
        self.total = total
        self.errors = list(errors)
        msg = (f"{phase} phase: {failed}/{total} job(s) FAILED after "
               f"{MAX_JOB_RETRIES} retries")
        if self.errors:
            msg += f"; last worker error:\n{self.errors[-1]['msg']}"
        super().__init__(msg)


class Server:
    """Orchestrate one task over an elastic worker pool.

    ``stale_timeout_s`` (None disables) requeues RUNNING jobs whose worker
    went SILENT — no claim or heartbeat within the window — so it bounds
    silence, not job duration. ``strict`` raises :class:`PhaseFailed` the
    moment a phase ends with FAILED jobs instead of feeding finalfn
    partial results. ``batch_k`` is the fleet's claim-lease size, written
    to the task document for workers with no ``batch_k`` of their own.
    ``engine`` (None = ``LMR_ENGINE``, else "auto") is the
    LocalExecutor's (module docstring); it is written to the task
    document and sticky on resume. ``pipeline`` and
    ``premerge_min_runs``/``premerge_max_runs`` drive the pipelined
    shuffle, ``segment_format`` the fleet's spill encoding,
    ``replication``/``coding`` the fleet's shuffle redundancy,
    ``push`` the push shuffle and ``speculation``/``speculation_cap``
    the straggler detector; ``autotune``/``autotune_config`` the
    feedback controller and ``ha``/``lease_ttl_s`` the leader lease
    (module docstring).
    """

    def __init__(self, store: JobStore, poll_interval: float = DEFAULT_SLEEP,
                 stale_timeout_s: Optional[float] = 600.0,
                 verbose: bool = False, strict: bool = False,
                 pipeline: bool = False, premerge_min_runs: int = 4,
                 premerge_max_runs: int = 8, batch_k: int = 1,
                 segment_format: str = "v1",
                 replication: Optional[int] = None,
                 coding: Optional[str] = None,
                 speculation: Optional[float] = None,
                 speculation_cap: int = 2,
                 push: Optional[bool] = None,
                 engine: Optional[str] = None,
                 autotune: Optional[bool] = None,
                 autotune_config=None,
                 ha: Optional[bool] = None,
                 lease_ttl_s: Optional[float] = None):
        from lua_mapreduce_tpu_torch.engine.ingraph import resolve_engine
        from lua_mapreduce_tpu_torch.sched.controller import \
            resolve_autotune
        # coord RPCs ride the retry layer (and an installed FaultPlan's
        # injection, and trace spans when a tracer is active)
        self.store = wrap_jobstore(store)
        self.poll_interval = poll_interval
        self.stale_timeout_s = stale_timeout_s
        self.verbose = verbose
        self.strict = strict
        self.pipeline = bool(pipeline)
        self.premerge_min_runs = premerge_min_runs
        self.premerge_max_runs = premerge_max_runs
        self.batch_k = max(1, int(batch_k))
        self.segment_format = check_format(segment_format)
        # the fleet's unified shuffle redundancy (an int or a Coding)
        self.replication = resolve_redundancy(replication, coding)
        self.push = resolve_push(push)
        self.engine = resolve_engine(engine)
        # the straggler factor (0 = off) and the live-clone cap per
        # namespace; the factor is deployed on the task document, and
        # workers gate their clone probe on it
        self.speculation = resolve_speculation(speculation)
        self.speculation_cap = max(1, int(speculation_cap))
        self._spec_taken_at: Dict[tuple, float] = {}  # (ns, jid) -> seen
        self._spec_scan_at: Dict[str, float] = {}     # ns -> last scan
        self._spill_repairs: Dict[str, tuple] = {}  # lost spill -> range
        # spill names the last _clean_runs could not remove (a copy on
        # an unreachable placement tag): older data under a name this
        # iteration must neither publish nor read
        self._unremoved_spills: frozenset = frozenset()
        self._map_ids: Optional[Dict[str, int]] = None
        self._ingraph = None           # IngraphRunner, built in loop()
        self.spec: Optional[TaskSpec] = None
        self.stats = TaskStats()
        self.finished_value: Any = None
        self.errors: List[dict] = []   # every drained worker error, kept
        self._data_store = None
        self._housekeep_at: Optional[float] = None
        self._waiter_obj = None        # the barrier's "done" cursor
        # the feedback controller (minted lazily) with its config
        # override, the elastic hook (set_fleet) and the last window's
        # counter and round snapshots
        self.autotune = resolve_autotune(autotune)
        self._autotune_config = autotune_config
        self._controller = None
        self._fleet_hook = None
        self._fleet_size: Optional[int] = None
        self._fleet_max: Optional[int] = None
        self._autotune_counters = None
        self._autotune_rounds = None
        # the leader lease (None = single coordinator); _took_over marks
        # a tenure that resumed a dead leader's run
        self.ha = resolve_ha(ha)
        self.lease_ttl_s = lease_ttl_s
        self._lease = None
        self._took_over = False

    # -- wakeups -------------------------------------------------------------

    def _waiter(self):
        """The barrier poll's cursor on the store's "done" channel:
        workers bump it when commits land; a lost notification times
        out into the ``poll_interval`` poll."""
        if self._waiter_obj is None:
            from lua_mapreduce_tpu_torch.sched.waiter import channel_for
            self._waiter_obj = channel_for(self.store, "done").waiter()
        return self._waiter_obj

    def _notify_jobs(self) -> None:
        """Announce claimable work or a phase flip on the "jobs"
        channel (the idle fleet's wakeup). Best effort."""
        from lua_mapreduce_tpu_torch.sched.waiter import notify
        notify(self.store, "jobs")

    # -- configuration ------------------------------------------------------

    def configure(self, spec: TaskSpec) -> "Server":
        """Validate and register the user program (server.lua:419-462).
        The spec must be module-path based so workers can load it, and
        its storage must be reachable by the pool's workers."""
        spec.describe()  # raises if not importable cross-process
        self._check_storage_reachable(spec)
        self.spec = spec
        return self

    def _check_storage_reachable(self, spec: TaskSpec) -> None:
        """A distributed pool needs storage every worker can see. Bare
        ``mem`` is private to each get_storage_from() call; ``mem:tag``
        is shared in-process only, so it cannot back a FileJobStore
        (multi-process) pool."""
        from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
        from lua_mapreduce_tpu_torch.store.router import parse_storage
        for spec_str in (spec.storage, spec.result_storage):
            if spec_str is None:
                continue
            backend, path = parse_storage(spec_str)
            if backend != "mem":
                continue
            if path is None:
                raise ValueError(
                    f"storage {spec_str!r}: bare 'mem' is private per "
                    "process — use 'mem:TAG' for in-process pools or "
                    "'shared:DIR' for multi-process pools")
            if isinstance(unwrap(self.store), FileJobStore):
                raise ValueError(
                    f"storage {spec_str!r} is in-process memory, but the "
                    "job store is a FileJobStore (multi-process pool) — "
                    "workers in other processes could not see the data; "
                    "use 'shared:DIR'")

    # -- main loop ----------------------------------------------------------

    def loop(self, progress: Optional[Callable[[str, float], None]] = None,
             strict: Optional[bool] = None) -> TaskStats:
        """Run the task to completion; returns aggregate stats.

        ``strict`` (when not None) overrides the constructor's flag for
        this run. Resume matrix (server.lua:470-492): a FINISHED task doc
        → drop the state and start fresh; REDUCE → skip the map phase
        (the spec is restored from the doc if none was configured);
        WAIT/MAP → resume the iteration in place, keeping WRITTEN jobs.
        The engine and the hybrid stage split are sticky from the doc.

        With ``ha`` on this first runs the leader-lease election: the
        winner leads through the path above with every mutation
        epoch-fenced; losers stand by on the "leader" topic and, when
        the leader's lease expires mid-task, take over by re-entering
        the resume matrix. A standby that sees another leader finish
        the task returns its own (empty) stats.
        """
        if not self.ha:
            return self._run(progress, strict)
        return self._ha_loop(progress, strict)

    def _ha_loop(self, progress, strict) -> TaskStats:
        """The election ladder: acquire → lead (fenced) → abdicate to
        standby on a takeover by another. The lease is released only on
        clean completion: an exception leaves it to expire, as a SIGKILL
        would, so the standby's takeover path is the same for both."""
        from lua_mapreduce_tpu_torch.faults.errors import StaleLeaderError
        from lua_mapreduce_tpu_torch.sched.lease import (FencedJobStore,
                                                         LeaderLease)
        lease = LeaderLease(self.store, ttl_s=self.lease_ttl_s)
        self._lease = lease
        waiter = lease.standby_waiter()
        tracer = active_tracer()
        seen_active = False      # a live (non-FINISHED) task was observed
        while True:
            # completion check BEFORE the acquire: a leader that finished
            # and released leaves an acquirable lease, and a standby
            # grabbing it would restart the finished task from scratch.
            # A server that never saw the task active (a fresh start on
            # a finished doc) runs: the ordinary fresh-start path.
            task = self.store.get_task()
            status = task.get("status") if task is not None else None
            if task is not None and status != TaskStatus.FINISHED.value:
                seen_active = True
            if seen_active and (task is None
                                or status == TaskStatus.FINISHED.value):
                # finished_value stays None: a standby never saw the
                # verdict; the results are in result storage
                return self.stats
            if lease.try_acquire():
                self._took_over = lease.took_over
                if lease.took_over:
                    COUNTERS.bump("leader_takeovers")
                    self._log(f"lease takeover: epoch {lease.epoch} "
                              f"as {lease.holder}")
                if tracer is not None:
                    kind = ("leader.takeover" if lease.took_over
                            else "leader.acquire")
                    with tracer.span(kind, epoch=lease.epoch,
                                     holder=lease.holder):
                        pass
                plain = self.store
                self.store = FencedJobStore(plain, lease)
                lease.start_renewal()
                try:
                    stats = self._run(progress, strict)
                except StaleLeaderError:
                    # fenced mid-run: another coordinator leads. Abdicate
                    # (never retry, never release: the lease is theirs)
                    # and stand by — if the new leader dies too, this
                    # server takes back over
                    lease.stop_renewal(release=False)
                    self.store = plain
                    self._log(f"fenced at epoch {lease.epoch}: "
                              "re-entering standby")
                    seen_active = True
                    continue
                except BaseException:
                    # crash path: stop renewing but do NOT release — the
                    # lease expires on its TTL, as after a SIGKILL
                    lease.stop_renewal(release=False)
                    self.store = plain
                    raise
                lease.stop_renewal(release=True)   # clean handback
                self.store = plain
                self._took_over = False
                return stats
            # standby: wait for the lease to move (the "leader" topic; a
            # lost notification degrades to the ttl/3 probe)
            COUNTERS.bump("standby_wakeups")
            waiter.wait(lease.ttl_s / 3.0)

    def _run(self, progress: Optional[Callable[[str, float], None]] = None,
             strict: Optional[bool] = None) -> TaskStats:
        """One coordinator tenure: the single-leader task loop (HA wraps
        it in the election above)."""
        if strict is not None:
            self.strict = strict
        t0 = time.time()
        skip_map = False
        sticky_stages = None
        iteration = 1
        tracer = active_tracer()
        if tracer is not None:
            tracer.set_actor("server")

        task = self.store.get_task()
        if task is not None and "spec" in task:
            status = task.get("status")
            if status == TaskStatus.FINISHED.value:
                self._drop_everything()
                task = None
            else:
                iteration = int(task.get("iteration", 1))
                if self.spec is None:
                    self.spec = TaskSpec.from_description(task["spec"])
                # a crashed in-graph run inserted no jobs: a store-plane
                # resume would wait on phases that never open (and the
                # reverse would strand claimable jobs) — the doc wins
                from lua_mapreduce_tpu_torch.engine.ingraph import \
                    resolve_engine
                self.engine = resolve_engine(task.get("engine", self.engine))
                # the hybrid split is sticky with the engine: a resumed
                # fleet keeps running the crashed run's compiled legs
                sticky_stages = task.get("hybrid_stages")
                # the shuffle mode is sticky too: a crashed pipelined
                # run left spills whose input runs are already deleted,
                # which a barrier resume's discovery would drop. batch_k
                # and segment_format are perf knobs (readers sniff per
                # file): the resuming server's values win
                self.pipeline = bool(task.get("pipeline", self.pipeline))
                # push and redundancy share the rule: a crashed push run's
                # data sits behind manifests, a crashed redundant run's
                # possibly only in replica copies or stripe blocks
                self.push = bool(task.get("push", self.push))
                self.replication = doc_redundancy(task, self.replication)
                self.store.update_task({"pipeline": self.pipeline,
                                        "push": self.push,
                                        "batch_k": self.batch_k,
                                        "segment_format":
                                            self.segment_format,
                                        "speculation": self.speculation,
                                        "engine": self.engine,
                                        "autotune": self.autotune,
                                        **doc_fields(self.replication)})
                self._notify_jobs()
                if status == TaskStatus.REDUCE.value:
                    skip_map = True
        if self.spec is None:
            raise RuntimeError("configure() a TaskSpec before loop()")
        if task is None:
            self.store.put_task({
                "_id": "unique",
                "status": TaskStatus.WAIT.value,
                "iteration": iteration,
                "spec": self.spec.describe(),
                # workers gate their pre_jobs probe on this marker
                "pipeline": self.pipeline,
                # and their map-publish mode on this one
                "push": self.push,
                # the fleet's default claim-lease size
                "batch_k": self.batch_k,
                # the fleet's spill encoding (readers sniff per file)
                "segment_format": self.segment_format,
                # the fleet's shuffle redundancy: the int factor and the
                # "k+m" coding spec ("" when coding is off)
                **doc_fields(self.replication),
                # the straggler factor: nonzero makes idle workers probe
                # for speculative duplicate leases
                "speculation": self.speculation,
                "engine": self.engine,
                # workers follow the controller-owned keys
                # (retry_base_ms, push_budget_mb) only under this marker
                "autotune": self.autotune,
                "started": time.time(),
            })
            self._notify_jobs()      # the task appeared: wake the workers

        self._data_store = get_storage_from(self.spec.storage)
        if task is None:
            # a fresh run purges a previous run's flushed spans (through
            # the raw store: telemetry housekeeping must not consume
            # FaultPlan occurrences) and must never restore a previous
            # task's loop state. An HA takeover is a resume of the dead
            # leader's run even on an edge where the doc is gone: its
            # spans stay, half of one timeline
            raw = unwrap(self._data_store)
            if not self._took_over:
                for name in raw.list(f"{TRACE_NS}.*"):
                    raw.remove(name)
            self._purge_loop_state()
        else:
            self._restore_loop_state(iteration)
        # the plain store repairs copies one by one (the scavenger);
        # discovery and cleanup go through the failover view, so a lost
        # primary with a surviving copy stays discoverable and sweeps
        # remove every copy. r = 1: the same object.
        store = reading_view(self._data_store, self.replication)
        result_store = (get_storage_from(self.spec.result_storage)
                        if self.spec.result_storage else self._data_store)

        from lua_mapreduce_tpu_torch.engine.ingraph import (IngraphRunner,
                                                            select_engine)
        decision = select_engine(self.spec, self.engine)
        if decision.chosen == "hybrid" and isinstance(sticky_stages, dict):
            decision.stages = {k: bool(v) for k, v in sticky_stages.items()}
        self._ingraph = IngraphRunner(self.spec, decision,
                                      device=self.spec.init_args.get(
                                          "device"),
                                      log=self._ingraph_log)
        if decision.chosen in ("ingraph", "hybrid"):
            self._log(f"engine: {decision.chosen} ({decision.reason})")
        # stage negotiation: every worker runs the SAME compiled legs
        # (and a resume finds them above); None clears a stale split
        self.store.update_task({"hybrid_stages": decision.stages
                                if decision.chosen == "hybrid" else None})

        while True:
            self._spill_repairs.clear()
            self._map_ids = None
            if tracer is not None:
                tracer.set_iteration(iteration)
            it_stats = IterationStats(iteration=iteration)
            it_t0 = time.time()
            rounds0 = self.store.round_counts()
            faults0 = COUNTERS.snapshot()

            # in-graph engine: the data plane runs as one program on this
            # server — no jobs, no phases, the result files land
            # directly. A failure under engine=auto degrades to the store
            # plane for good (counted, logged, doc-recorded) and THIS
            # iteration re-runs through the phases below; under
            # engine=ingraph it raises.
            ingraph_done = False
            if not skip_map and self._ingraph.active:
                delete_results(result_store, self.spec.result_ns)
                ingraph_done = self._ingraph.run_iteration(result_store,
                                                           iteration)
                if not ingraph_done:
                    self.store.update_task({"engine": "store"})
                    self.engine = "store"

            if not skip_map and not ingraph_done:
                delete_results(result_store, self.spec.result_ns)
                n_map = self._prepare_map(store)
                with self._phase_span("map", iteration):
                    if self.pipeline:
                        self._pipelined_map_phase(store, n_map, progress)
                    else:
                        self._wait_phase(MAP_NS, n_map, "map", progress)
                map_times = self._phase_times(MAP_NS)
                it_stats.map.fold(
                    map_times,
                    failed=self.store.counts(MAP_NS)[Status.FAILED])
                if self.pipeline:
                    pre_times = self._phase_times(PRE_NS)
                    it_stats.premerge.fold(
                        pre_times,
                        failed=self.store.counts(PRE_NS)[Status.FAILED])
                    it_stats.overlap_fraction = overlap_fraction(
                        map_times, pre_times)
            skip_map = False

            if not ingraph_done:
                n_red = self._prepare_reduce(store)
                if n_red:
                    with self._phase_span("reduce", iteration):
                        self._wait_phase(RED_NS, n_red, "reduce",
                                         progress)
                it_stats.reduce.fold(
                    self._phase_times(RED_NS),
                    failed=self.store.counts(RED_NS)[Status.FAILED])

            verdict: Any = None
            if self.spec.finalfn is not None:
                verdict = self.spec.finalfn(
                    iter_results(result_store, self.spec.result_ns))

            rounds1 = self.store.round_counts()
            it_stats.claim_rounds = rounds1["claim"] - rounds0["claim"]
            it_stats.commit_rounds = rounds1["commit"] - rounds0["commit"]
            it_stats.fold_fault_counters(
                COUNTERS.delta(faults0, COUNTERS.snapshot()))
            it_stats.wall_time = time.time() - it_t0
            self.stats.iterations.append(it_stats)
            self.store.update_task({"stats": it_stats.as_dict()})
            # end-of-iteration trace drain: everything the in-process
            # pool buffered lands in the store before the namespaces
            # roll over
            self._trace_flush(force=True)
            self._log(f"iteration {iteration}: cluster_time="
                      f"{it_stats.cluster_time:.2f}s "
                      f"wall={it_stats.wall_time:.2f}s")

            if verdict == "loop":
                iteration += 1
                # the threaded loop state is checkpointed BEFORE the WAIT
                # flip: a crash between the two resumes at the flip's
                # iteration and finds the state that feeds it
                self._save_loop_state(iteration)
                for ns in (MAP_NS, PRE_NS, RED_NS):
                    self.store.drop_ns(ns)
                self.store.update_task({"iteration": iteration,
                                        "status": TaskStatus.WAIT.value})
                self._notify_jobs()
                continue

            self.finished_value = verdict
            self.store.update_task({"status": TaskStatus.FINISHED.value})
            self._notify_jobs()      # waiting workers see FINISHED now
            if verdict is True:
                delete_results(result_store, self.spec.result_ns)
                self._purge_loop_state()
                self._drop_everything()
            break

        self.stats.wall_time = time.time() - t0
        return self.stats

    # -- loop-state checkpoint ----------------------------------------------

    def _save_loop_state(self, iteration: int) -> None:
        """Publish the program's threaded loop state (``save_state()``)
        as the CRC-framed ``_state.<iteration>`` file — named by the
        iteration it FEEDS. Keeps {N-1, N}: the save runs before the
        doc's iteration flip, so a crash in that window resumes at N-1
        and still finds its checkpoint. No-op without the hook pair."""
        save, _ = self.spec.state_hooks
        if save is None:
            return
        raw = unwrap(self._data_store)
        name = f"{STATE_NS}.{iteration}"
        with raw.builder() as b:
            b.write_bytes(frame_state(save()))
            b.build(name)
        keep = (name, f"{STATE_NS}.{iteration - 1}")
        for old in raw.list(f"{STATE_NS}.*"):
            if old not in keep:
                raw.remove(old)

    def _restore_loop_state(self, iteration: int) -> None:
        """Feed ``_state.<iteration>`` back through ``restore_state`` on
        resume. A missing or corrupt frame is ignored: the program then
        resumes from its init-time state."""
        _, restore = self.spec.state_hooks
        if restore is None:
            return
        raw = unwrap(self._data_store)
        name = f"{STATE_NS}.{iteration}"
        if not raw.exists(name):
            return
        try:
            state = unframe_state(raw.read_range(name, 0, raw.size(name)))
        except Exception as exc:    # torn/corrupt frame
            self._log(f"loop-state checkpoint {name} unreadable "
                      f"({exc}); resuming from init-time state")
            return
        restore(state)
        self._log(f"loop state restored from {name}")

    def _purge_loop_state(self) -> None:
        raw = unwrap(self._data_store)
        for name in raw.list(f"{STATE_NS}.*"):
            raw.remove(name)

    # -- phases -------------------------------------------------------------

    def _prepare_map(self, store) -> int:
        """Insert map jobs and open the MAP phase (server.lua:249-276).
        On resume with an unchanged job set, WRITTEN jobs are kept and
        in-flight claims left alone (dead ones fall to the stale
        requeue). On a fresh start or a changed taskfn shape, stale run
        files are purged first so old data can never reach a reduce."""
        jobs = collect_task_jobs(self.spec)
        existing = self.store.counts(MAP_NS)
        n_existing = sum(existing.values())
        if n_existing != len(jobs):
            if n_existing:
                self.store.drop_ns(MAP_NS)  # taskfn changed shape: restart
            self._clean_runs(store)
            self.store.insert_jobs(
                MAP_NS, [make_job(k, v) for k, v in jobs])
        self.store.update_task({"status": TaskStatus.MAP.value})
        # jobs AND the phase flip land before the wakeup, so a woken
        # worker's next poll finds claimable work
        self._notify_jobs()
        return len(jobs)

    def _clean_runs(self, store) -> None:
        """Drop every intermediate run file of this namespace: mapper
        runs (``ns.P*.M*``), pipelined spills (``ns.P*.SPILL-*``) and
        push inbox fragments (``ns.P*.INBOX-*``; the ``.M*`` glob also
        takes the ``ns.PUSH.M*`` manifests, which must go: a stale
        canonical manifest would win this iteration's publish)."""
        for pattern in (f"{self.spec.result_ns}.P*.M*",
                        f"{self.spec.result_ns}.P*.{SPILL_TAG}-*",
                        f"{self.spec.result_ns}.P*.{INBOX_TAG}-*"):
            for name in store.list(pattern):
                store.remove(name)
        # the sweep swallows a copy's failure to go, and a listing still
        # names the file while any copy is left
        self._unremoved_spills = frozenset(
            store.list(f"{self.spec.result_ns}.P*.{SPILL_TAG}-*"))
        if self._unremoved_spills:
            COUNTERS.bump("unremoved_spills", len(self._unremoved_spills))
            self._log(f"{len(self._unremoved_spills)} spill(s) could not "
                      f"be removed; this iteration ignores their names")
        # names just swept are reused by this iteration's maps with new
        # contents, which the footer cache's (name, size) key can miss
        purge_footer_cache(store)

    def _prepare_reduce(self, store) -> int:
        """Discover map-output partitions and insert one reduce job per
        non-empty partition (server.lua:279-329). Each reduce job records
        the PRODUCERS of its run files (server.lua:286-289), so a reduce
        that cannot see a run names the worker that wrote it."""
        self.store.drop_ns(RED_NS)
        if self.pipeline:
            # file lists rebuilt from storage: spills in place of the
            # run ranges they consumed, tail runs raw, in the canonical
            # merge order — the same on a crash/resume, where the
            # tracker state is gone
            map_keys = [map_key_str(d["_id"])
                        for d in self.store.jobs(MAP_NS)]
            parts = discover_pipelined(store, self.spec.result_ns,
                                       map_keys, push=self.push,
                                       replication=self.replication,
                                       ignore=self._unremoved_spills)
        elif self.push:
            # barrier + push: inbox fragments slot in at their map's
            # canonical position through the manifest gate
            map_keys = [map_key_str(d["_id"])
                        for d in self.store.jobs(MAP_NS)]
            parts = discover_push(store, self.spec.result_ns, map_keys,
                                  replication=self.replication)
        else:
            parts = discover_partitions(store, self.spec.result_ns)
        producer_by_id = {map_key_str(jid): w
                          for jid, w in self.store.job_workers(MAP_NS).items()}
        docs = []
        for part, files in sorted(parts.items()):
            mappers = set()
            for f in files:
                # run-file name is "<ns>.P<part>.M<map_job_id>" (spill
                # files carry no ".M" infix and resolve to no producer)
                producer = producer_by_id.get(f.rsplit(".M", 1)[-1])
                if producer is not None:
                    mappers.add(producer)
            docs.append(make_job(part, {
                "part": part,
                "files": files,
                "result": result_file_name(self.spec.result_ns, part),
                "mappers": sorted(mappers),
            }))
        if docs:
            self.store.insert_jobs(RED_NS, docs)
        self.store.update_task({"status": TaskStatus.REDUCE.value})
        self._notify_jobs()
        return len(docs)

    def _housekeep(self, *namespaces: str) -> None:
        """One poll's upkeep (server.lua:186-234), throttled to the
        poll_interval cadence: scavenge BROKEN≥retries → FAILED, requeue
        stale RUNNING and (with speculation on) open duplicate leases on
        stragglers in every given namespace, drain and retain worker
        errors, soft-flush the trace buffer. Under redundancy, drained
        errors naming ``lost_files`` feed the repair-or-requeue
        recovery."""
        now = time.time()
        if self._housekeep_at is not None \
                and now - self._housekeep_at < self.poll_interval:
            return
        self._housekeep_at = now
        for ns in namespaces:
            self.store.scavenge(ns, MAX_JOB_RETRIES)
            if self.stale_timeout_s is not None:
                if self.store.requeue_stale(ns, self.stale_timeout_s):
                    self._notify_jobs()   # requeued = claimable again
            if self.speculation:
                self._speculate_stragglers(ns)
        lost: List[str] = []
        for err in self.store.drain_errors():
            # the drain is destructive — always retain for diagnosis
            self.errors.append(err)
            lost.extend(err.get("lost_files") or ())
            self._log(f"worker error [{err['worker']}]: "
                      f"{err['msg'].splitlines()[-1] if err['msg'] else ''}")
        if redundancy_on(self.replication):
            if lost:
                self._recover_lost(sorted(set(lost)))
            if self._spill_repairs:
                self._settle_spill_repairs()
        # the feedback controller ticks on the same throttled cadence:
        # each decision is one housekeeping pass behind its evidence
        if self.autotune:
            try:
                self._autotune_tick(namespaces)
            except Exception as exc:
                # the controller is advisory: a store blip mid-tick
                # must not abort an iteration
                self._log(f"autotune tick failed ({type(exc).__name__}: "
                          f"{exc}); knobs hold")
        # soft flush: nothing happens below the tracer's threshold
        self._trace_flush()

    # -- self-tuning controller ---------------------------------------------

    def set_fleet(self, hook: Callable[[int], int], size: int,
                  max_workers: Optional[int] = None) -> None:
        """Install the elastic hook: ``hook(target) -> new size`` grows
        or gracefully retires pool members (sched.controller.
        FleetSupervisor). ``size`` is the current fleet; without a hook
        the controller still writes ``fleet_target`` on the task doc for
        the worker CLI's autoscaler."""
        self._fleet_hook = hook
        self._fleet_size = int(size)
        self._fleet_max = max_workers
        if self._controller is not None:
            # a hook attached mid-run: re-mint on the next tick so the
            # fleet knob arms with the true size
            self._controller = None

    def _build_controller(self):
        from lua_mapreduce_tpu_torch.engine.push import resolve_push_budget
        from lua_mapreduce_tpu_torch.faults.retry import retry_settings
        from lua_mapreduce_tpu_torch.sched.controller import \
            AutotuneController
        self._controller = AutotuneController(
            batch_k=self.batch_k,
            push_budget_mb=float(resolve_push_budget(None))
            if self.push else None,
            speculation=self.speculation or None,
            retry_base_ms=float(retry_settings()["base_ms"]),
            fleet=self._fleet_size,
            fleet_max=self._fleet_max,
            config=self._autotune_config)
        self._autotune_counters = COUNTERS.snapshot()
        self._autotune_rounds = self.store.round_counts()
        return self._controller

    def _autotune_tick(self, namespaces) -> None:
        """Gather one window's evidence and apply the controller's
        decisions through the task document. The observation RPCs are
        timed and fed to the controller's rolling p99 (the claim
        overhead proxy: same store, same round trip)."""
        from lua_mapreduce_tpu_torch.sched.controller import Observation
        c = self._controller or self._build_controller()
        waiting = running = 0
        t0 = time.perf_counter()
        for ns in namespaces:
            counts = self.store.counts(ns)
            waiting += counts[Status.WAITING] + counts[Status.BROKEN]
            running += counts[Status.RUNNING]
        if namespaces:
            c.note_rpc((time.perf_counter() - t0) / len(namespaces))
        task = self.store.get_task() or {}
        ewmas = [float(v) for k, v in task.items()
                 if k.startswith("dur_ewma:") and v and float(v) > 0]
        snap = COUNTERS.snapshot()
        delta = COUNTERS.delta(self._autotune_counters, snap)
        self._autotune_counters = snap
        rounds = self.store.round_counts()
        claim_d = rounds["claim"] - self._autotune_rounds["claim"]
        # commit round trips: the store-visible throughput proxy (one
        # per retired lease)
        commit_d = rounds["commit"] - self._autotune_rounds["commit"]
        self._autotune_rounds = rounds
        obs = Observation(
            t=time.time(),
            body_ewma_s=max(ewmas) if ewmas else None,
            rpc_p99_s=c.rpc_p99(),
            jobs_done=commit_d,
            claim_rounds=claim_d,
            push_frames=int(delta.get("push_frames", 0)),
            push_evictions=int(delta.get("push_evictions", 0)),
            spec_launched=int(delta.get("spec_launched", 0)),
            spec_wins=int(delta.get("spec_wins", 0)),
            spec_wasted_s=float(delta.get("spec_wasted_s", 0.0)),
            store_retries=int(delta.get("store_retries", 0)),
            waiting=waiting, running=running,
            fleet=self._fleet_size)
        for d in c.tick(obs):
            self._apply_decision(d)

    def _apply_decision(self, d) -> None:
        """Deploy one knob change as an operator would: the task doc for
        fleet-followed knobs, ``configure_retry`` for the process-local
        backoff, the hook for the fleet."""
        self._log(f"autotune: {d.knob} {d.old} -> {d.new} "
                  f"({d.metric}={d.observed:.4g}, "
                  f"threshold {d.threshold:.4g})")
        if d.knob == "batch_k":
            self.batch_k = int(d.new)
            self.store.update_task({"batch_k": self.batch_k})
        elif d.knob == "push_budget_mb":
            self.store.update_task({"push_budget_mb": float(d.new)})
        elif d.knob == "speculation":
            self.speculation = float(d.new)
            self.store.update_task({"speculation": self.speculation})
        elif d.knob == "retry_base_ms":
            from lua_mapreduce_tpu_torch.faults.retry import (
                configure_retry, retry_settings)
            configure_retry(retries=int(retry_settings()["retries"]),
                            base_ms=float(d.new))
            self.store.update_task({"retry_base_ms": float(d.new)})
        elif d.knob == "fleet":
            target = int(d.new)
            self.store.update_task({"fleet_target": target})
            if self._fleet_hook is not None:
                self._fleet_size = int(self._fleet_hook(target))
            self._notify_jobs()   # new members must find work promptly

    # -- tracing hooks -------------------------------------------------------

    def _phase_span(self, phase: str, iteration: int):
        """A span over a whole phase barrier (the waterfall's top row);
        a no-op context when tracing is off."""
        tracer = active_tracer()
        if tracer is None:
            return contextlib.nullcontext()
        return tracer.span(f"phase.{phase}", iteration=iteration)

    def _trace_flush(self, force: bool = False) -> None:
        """Publish the process tracer's buffered spans through the task
        storage: the server's own, and an in-process pool's. Best
        effort: telemetry never aborts an iteration."""
        tracer = active_tracer()
        if tracer is None or self._data_store is None:
            return
        try:
            tracer.flush(self._data_store, force=force)
        except Exception as exc:
            self._log(f"trace flush failed ({type(exc).__name__}: {exc});"
                      " spans re-buffered")

    # -- straggler detection (speculative execution) --------------------------

    def _speculate_stragglers(self, ns: str) -> None:
        """Open speculative duplicate leases on RUNNING jobs older than
        ``speculation ×`` the task doc's fleet EWMA for ``ns`` — oldest
        first, at most ``speculation_cap`` live clones per namespace;
        ``speculate``'s CAS makes repeated passes idempotent. A cold fleet
        (no EWMA on the doc yet) speculates nothing, so a phase whose
        jobs are all legitimately long never misfires.

        A TAKEN shadow lease whose job is still RUNNING ``threshold``
        after the detector first saw it taken means the clone died (a
        healthy clone finishes in about one EWMA): it is retracted
        (``cancel_spec`` with no holder) so the straggler can be cloned
        again instead of a dead clone pinning the cap. Retracting a slow
        LIVE clone is benign: its commit fails the ownership CAS.

        Scans are throttled to a quarter of the threshold: ``jobs()``
        copies payloads, which a per-poll scan would pay every poll."""
        counts = self.store.counts(ns)
        if not counts[Status.RUNNING]:
            return
        task = self.store.get_task() or {}
        ewma = task.get(f"dur_ewma:{ns}")
        if not ewma or ewma <= 0:
            return
        factor = float(task.get("speculation") or self.speculation)
        threshold = factor * ewma
        now = time.time()
        last = self._spec_scan_at.get(ns)
        if last is not None and now - last < threshold / 4:
            return
        self._spec_scan_at[ns] = now
        running = [d for d in self.store.jobs(ns)
                   if d["status"] == Status.RUNNING]
        taken = {d["_id"] for d in running if d.get("spec_state") == 2}
        for key in [k for k in self._spec_taken_at
                    if k[0] == ns and k[1] not in taken]:
            self._spec_taken_at.pop(key)      # resolved: forget
        active = 0
        for d in running:
            if not d.get("spec_state"):
                continue
            first = (self._spec_taken_at.setdefault((ns, d["_id"]), now)
                     if d["spec_state"] == 2 else None)
            if first is not None and now - first > threshold \
                    and self.store.cancel_spec(ns, d["_id"], None):
                COUNTERS.bump("spec_cancelled")
                self._spec_taken_at.pop((ns, d["_id"]), None)
                self._log(f"straggler: {ns} job {d['_id']} shadow lease "
                          "abandoned (clone silent past the threshold) — "
                          "retracted for re-cloning")
                d["spec_state"] = 0
                continue
            active += 1
        budget = self.speculation_cap - active
        if budget <= 0:
            return
        overdue = sorted(
            (d for d in running
             if not d.get("spec_state") and d.get("started_time")
             and now - d["started_time"] > threshold),
            key=lambda d: d["started_time"])
        for d in overdue[:budget]:
            if self.store.speculate(ns, d["_id"]):
                self._notify_jobs()   # idle workers probe for the clone
                COUNTERS.bump("spec_launched")
                self._log(f"straggler: {ns} job {d['_id']} RUNNING "
                          f"{now - d['started_time']:.2f}s > {factor:g}x "
                          f"EWMA {ewma:.3f}s — speculative duplicate "
                          "lease opened")

    # -- lost-file recovery --------------------------------------------------

    def _recover_lost(self, files: List[str]) -> None:
        """The scavenger's reconstruct-vs-requeue decision, per lost
        file: REPAIR from any surviving replica (milliseconds, no job
        state touched — counted ``replica_repairs``), and only when
        every copy is gone REQUEUE the producing map job(s) — the
        last-resort re-run the replication layer exists to avoid."""
        for name in files:
            if name in self._spill_repairs:
                continue            # republish already pending below
            verdict = repair(self._data_store, name, self.replication)
            if verdict != "lost":
                # intact/repaired: full redundancy restored; degraded:
                # a survivor still serves failover reads and the next
                # housekeeping pass retries the heal — never a re-run
                self._log(f"scavenge: {name} {verdict} "
                          "(a surviving replica serves it)")
                continue
            self._requeue_producers(name)

    def _map_id_by_key(self) -> Dict[str, int]:
        if self._map_ids is None:
            self._map_ids = {map_key_str(d["_id"]): d["_id"]
                             for d in self.store.jobs(MAP_NS)}
        return self._map_ids

    def _requeue_producers(self, name: str) -> None:
        """Every copy of ``name`` is gone: push its producer(s) back to
        WAITING (no repetition charge — the loss is not the job's
        fault) so the pool regenerates the data during the reduce
        phase (Worker's replication-gated map probe). A lost SPILL
        additionally needs its pre-merge republished once the covering
        map jobs land — tracked in ``_spill_repairs``. A lost push
        FRAGMENT (or manifest) requeues its producer too, after the
        stale canonical manifest is invalidated so the re-run's fresh
        lineage can publish — best-effort: a re-run under different
        memory pressure may fragment differently, and a reduce job
        holding the old file list then retries through the normal
        missing-runs ladder (DESIGN §24)."""
        ns = self.spec.result_ns
        m = run_name_re(ns).match(name)
        if m:
            self._requeue_maps([m.group(2)], name)
            return
        inbox = parse_inbox_name(ns, name)
        man = parse_manifest_name(ns, name) if inbox is None else None
        if inbox is not None or man is not None:
            key = inbox[1] if inbox is not None else man[0]
            # invalidate the lineage whose file is gone (every copy of
            # the canonical manifest, so publish-if-absent re-opens)
            view = reading_view(self._data_store, self.replication)
            try:
                view.remove(manifest_name(ns, key))
            except Exception:
                pass
            self._requeue_maps([key], name)
            return
        parsed = parse_spill_name(ns, name)
        if parsed is None:
            return          # not a shuffle file of this task (a result
                            # file, say): nothing to regenerate here
        part, a, b = parsed
        order = sorted(self._map_id_by_key())
        if self._requeue_maps(order[a:b + 1], name):
            self._spill_repairs[name] = (part, a, b)

    def _requeue_maps(self, map_keys, why_file: str) -> int:
        """WRITTEN→WAITING CAS per producer (a key already requeued —
        or re-running — fails the CAS and is simply not re-charged).
        Each landed requeue is a counted ``map_rerun`` and an
        errors-stream entry tagged ``spill-lost-requeue``, so lost-data
        re-runs are distinguishable from stale-worker requeues."""
        by_key = self._map_id_by_key()
        n = 0
        for key in map_keys:
            jid = by_key.get(key)
            if jid is None:
                continue
            if not self.store.set_job_status(MAP_NS, jid, Status.WAITING,
                                             expect=(Status.WRITTEN,)):
                continue
            n += 1
            COUNTERS.bump("map_reruns")
            self.store.insert_error(
                "server",
                f"map job {jid} requeued: shuffle file {why_file!r} lost "
                "with no surviving replica (last-resort re-run)",
                info={"classification": "spill-lost-requeue",
                      "ns": MAP_NS, "job_id": jid, "file": why_file})
            self._log(f"scavenge: {why_file} unrecoverable — map job "
                      f"{jid} requeued for re-run")
        if n:
            self._notify_jobs()
        return n

    def _settle_spill_repairs(self) -> None:
        """Republish the pre-merge for a lost spill once every covering
        map job re-ran: rebuild the canonical file list from storage
        (absent positions are transparent, engine/premerge.py) and
        insert a fresh pre_merge job — workers claim it through the
        reduce-phase probe and the retrying reduce job then finds its
        spill again."""
        view = reading_view(self._data_store, self.replication)
        ns = self.spec.result_ns
        by_key = self._map_id_by_key()
        status = {d["_id"]: d["status"] for d in self.store.jobs(MAP_NS)}
        order = sorted(by_key)
        run_re = run_name_re(ns)
        # settle-ready repairs first, so the push branch resolves ONE
        # file-list pass for the union of their keys — push_file_lists
        # opens with a full-namespace listing plus per-key manifest
        # reads, and paying that per repair per housekeeping pass would
        # turn many lost spills into O(repairs × namespace) RPCs (the
        # staged branch's per-partition glob stays per-repair: it is
        # one single-partition listing)
        ready: List[tuple] = []
        for spill, (part, a, b) in list(self._spill_repairs.items()):
            if view.exists(spill):
                self._spill_repairs.pop(spill)
                continue
            keys = order[a:b + 1]
            if not all(status.get(by_key[k]) == Status.WRITTEN
                       for k in keys if k in by_key):
                continue        # producers still re-running
            ready.append((spill, part, a, b, keys))
        push_lists = None
        if self.push and ready:
            union = sorted({k for _, _, _, _, keys in ready for k in keys})
            push_lists, _ = push_file_lists(view, ns, union,
                                            self.replication)
        for spill, part, a, b, keys in ready:
            wanted = set(keys)
            if push_lists is not None:
                # push re-runs re-emit manifest-gated inbox files, not
                # bare runs: the same canonical resolution the tracker
                # uses, computed once above for every ready repair
                files = [f for key in sorted(wanted)
                         for f in push_lists.get(key, {}).get(part, [])]
            else:
                files = [n for n in view.list(f"{ns}.P{part}.M*")
                         if (mm := run_re.match(n)) and mm.group(2) in wanted]
            if not files:
                self._spill_repairs.pop(spill)
                continue        # nothing re-emitted for this partition
            self.store.insert_jobs(PRE_NS, [make_job(
                f"repair.{part}.{a}-{b}",
                {"part": part, "seq": -1, "files": files,
                 "spill": spill})])
            self._notify_jobs()
            self._spill_repairs.pop(spill)
            self._log(f"scavenge: republished pre_merge for lost spill "
                      f"{spill} ({len(files)} run(s))")

    def _finish_phase(self, phase: str, counts: Dict[Status, int],
                      total: int) -> None:
        """End-of-phase FAILED handling: strict mode aborts with
        :class:`PhaseFailed`; the default warns on stderr (with the last
        retained worker error) and proceeds on partial results,
        reference-style."""
        if not counts[Status.FAILED]:
            return
        if self.strict:
            raise PhaseFailed(phase, counts[Status.FAILED], total,
                              self.errors)
        print(f"[server] {phase}: {counts[Status.FAILED]} job(s) "
              f"FAILED after {MAX_JOB_RETRIES} retries; "
              f"{len(self.errors)} worker error(s) retained in "
              f"Server.errors"
              + (f"; last:\n{self.errors[-1]['msg']}"
                 if self.errors else ""),
              file=sys.stderr)

    def _pipelined_map_phase(self, store, n_map: int,
                             progress: Optional[Callable[[str, float],
                                                         None]]) -> None:
        """Overlapped map + eager pre-merge barrier (the pipelined
        replacement for ``_wait_phase(MAP_NS, ...)``).

        Every poll: housekeeping over both namespaces; feed newly
        committed map jobs' runs to the :class:`PremergeTracker`;
        publish its eligible consolidation batches as ``pre_merge`` jobs
        (workers claim them while mappers still run); settle finished
        or failed pre-merge jobs — a FAILED one whose spill exists anyway
        counts as done, otherwise its range is poisoned and the reduce
        uses the raw runs. Returns once every map job and every
        published pre-merge job is terminal; nothing is published after
        the last map commits.
        """
        ns = self.spec.result_ns
        self.store.drop_ns(PRE_NS)
        tracker = PremergeTracker(
            ns, [map_key_str(d["_id"]) for d in self.store.jobs(MAP_NS)],
            min_runs=self.premerge_min_runs, max_runs=self.premerge_max_runs,
            avoid=self._unremoved_spills)
        for name in store.list(f"{ns}.P*.{SPILL_TAG}-*"):
            parsed = parse_spill_name(ns, name)    # crash/resume leftovers
            if parsed is not None and name not in self._unremoved_spills:
                tracker.note_existing_spill(*parsed, name=name)
        run_re = run_name_re(ns)
        seen_committed: set = set()
        pre_ids: Dict[int, tuple] = {}    # pre job id -> (part, seq)
        settled_pre: set = set()
        while True:
            self._housekeep(MAP_NS, PRE_NS)
            # gate the per-job snapshot on the cheap index counts
            mcounts = self.store.counts(MAP_NS)
            n_terminal = mcounts[Status.WRITTEN] + mcounts[Status.FAILED]
            newly = []
            if n_terminal > len(seen_committed):
                newly = [d for d in self.store.jobs(MAP_NS)
                         if d["status"] in (Status.WRITTEN, Status.FAILED)
                         and d["_id"] not in seen_committed]
            if newly:
                # ONE namespace listing shared by every newly committed
                # job of this poll
                runs_by_key: Dict[str, Dict[int, str]] = {}
                for name in store.list(f"{ns}.P*.M*"):
                    m = run_re.match(name)
                    if m:
                        runs_by_key.setdefault(m.group(2), {})[
                            int(m.group(1))] = name
                for d in newly:
                    seen_committed.add(d["_id"])
                    key = map_key_str(d["_id"])
                    if self.push:
                        # a committed push map's fragments resolve
                        # through the manifest gate; classic runs stay
                        # the fallback for push-off fleet members
                        man = ensure_canonical(store, ns, key,
                                               self.replication)
                        if man is not None:
                            tracker.note_map_committed(
                                key, manifest_files_by_part(man))
                            continue
                    # FAILED jobs contribute whatever partial runs they
                    # published, as the barrier path's discovery does
                    tracker.note_map_committed(key, runs_by_key.get(key, {}))
            map_done = len(seen_committed) >= n_map

            if not map_done:
                spills = tracker.take_eligible()
                if spills:
                    ids = self.store.insert_jobs(PRE_NS, [
                        make_job(f"{sp.part}.{sp.seq}",
                                 {"part": sp.part, "seq": sp.seq,
                                  "files": sp.files, "spill": sp.name})
                        for sp in spills])
                    for jid, sp in zip(ids, spills):
                        pre_ids[jid] = (sp.part, sp.seq)
                    self._notify_jobs()
                    self._log(f"published {len(spills)} pre_merge job(s) "
                              f"({len(seen_committed)}/{n_map} maps done)")

            pcounts = self.store.counts(PRE_NS)
            pre_terminal = pcounts[Status.WRITTEN] + pcounts[Status.FAILED]
            pre_docs = (self.store.jobs(PRE_NS)
                        if pre_terminal > len(settled_pre) else ())
            for d in pre_docs:
                jid = d["_id"]
                if jid in settled_pre or jid not in pre_ids:
                    continue
                if d["status"] == Status.WRITTEN:
                    settled_pre.add(jid)
                    tracker.spill_done(*pre_ids[jid])
                elif d["status"] == Status.FAILED:
                    settled_pre.add(jid)
                    part, seq = pre_ids[jid]
                    sp = tracker.spills.get((part, seq))
                    exists = sp is not None and store.exists(sp.name)
                    tracker.spill_failed(part, seq, spill_exists=exists)
                    self._log(f"pre_merge job {jid} FAILED; "
                              + ("spill present, kept" if exists else
                                 "range poisoned, reduce uses raw runs"))

            if progress is not None:
                progress("map", len(seen_committed) / max(n_map, 1))
            if map_done and len(settled_pre) >= len(pre_ids):
                self._finish_phase("map", self.store.counts(MAP_NS), n_map)
                return
            self._waiter().wait(self.poll_interval)

    def _wait_phase(self, ns: str, total: int, phase: str,
                    progress: Optional[Callable[[str, float], None]]) -> None:
        """Barrier poll (server.lua:186-234): every ``poll_interval`` —
        housekeeping, progress — until every job is WRITTEN or FAILED.
        Under redundancy the reduce wait keeps the map and pre-merge
        namespaces in its upkeep: recovery re-runs ride them during the
        reduce phase, and a killed re-run must fall to the stale
        requeue like any job."""
        namespaces = (ns,)
        if ns == RED_NS and redundancy_on(self.replication):
            namespaces = (RED_NS, MAP_NS, PRE_NS)
        while True:
            self._housekeep(*namespaces)
            counts = self.store.counts(ns)
            done = counts[Status.WRITTEN] + counts[Status.FAILED]
            if progress is not None:
                progress(phase, done / max(total, 1))
            if done >= total:
                self._finish_phase(phase, counts, total)
                return
            self._waiter().wait(self.poll_interval)

    # -- stats / cleanup ----------------------------------------------------

    def _phase_times(self, ns: str) -> List[JobTimes]:
        out = []
        for doc in self.store.jobs(ns):
            t = doc.get("times")
            if t:
                out.append(JobTimes(started=t["started"],
                                    finished=t["finished"],
                                    written=t["written"], cpu=t["cpu"]))
        return out

    def _drop_everything(self) -> None:
        """server_drop_collections (server.lua:331-345)."""
        for ns in (MAP_NS, PRE_NS, RED_NS):
            self.store.drop_ns(ns)
        self.store.delete_task()

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[server] {msg}", flush=True)

    @staticmethod
    def _ingraph_log(msg: str) -> None:
        """Engine-selection and fallback messages surface always: a
        silent plane switch is what the engine knob forbids."""
        print(f"[server] ingraph: {msg}", file=sys.stderr, flush=True)


def utest() -> None:
    """Self-test (reference server.lua:629-655 utest role, upgraded to a
    micro end-to-end): one server + one in-process worker over the
    in-memory job store run a 3-job task through map → shuffle → reduce
    → finalfn, and the stats/finished_value surfaces are checked."""
    import sys
    import threading
    import types

    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
    from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
    from lua_mapreduce_tpu_torch.engine.worker import Worker

    mod = types.ModuleType("_server_utest_mod")

    def taskfn(emit):
        for i in range(3):
            emit(str(i), list(range(i + 1)))

    def mapfn(key, values, emit):
        for v in values:
            emit("n", v)

    def reducefn(key, values):
        return sum(values)

    def finalfn(pairs):
        mod.result = {k: v for k, (v,) in pairs}   # keep results

    mod.taskfn, mod.mapfn, mod.reducefn = taskfn, mapfn, reducefn
    mod.partitionfn = lambda key: 0
    mod.finalfn = finalfn
    # the tasks name the CPU: a worker's device is the task's (the card by
    # default), and this self-test runs host-only
    sys.modules["_server_utest_mod"] = mod
    try:
        store = MemJobStore()
        spec = TaskSpec(taskfn="_server_utest_mod",
                        mapfn="_server_utest_mod",
                        partitionfn="_server_utest_mod",
                        reducefn="_server_utest_mod",
                        finalfn="_server_utest_mod",
                        storage="mem:_server_utest",
                        init_args={"device": "cpu"})
        server = Server(store, poll_interval=0.01).configure(spec)
        w = Worker(store).configure(max_iter=400, max_sleep=0.02)
        t = threading.Thread(target=w.execute, daemon=True)
        t.start()
        stats = server.loop()
        t.join(timeout=30)
        # sum over shards of 0..i = 0 + (0+1) + (0+1+2) = 4
        assert mod.result == {"n": 4}, mod.result
        it = stats.iterations[-1]
        assert it.map.count == 3 and it.map.failed == 0
        assert it.reduce.count == 1 and it.reduce.failed == 0

        # pipelined-shuffle leg: same task, eager pre-merge enabled AND
        # v2 framed segments negotiated through the task doc — result
        # must be identical (premerge count depends on worker timing,
        # so only the invariants are asserted)
        mod.result = None
        store2 = MemJobStore()
        spec2 = TaskSpec(taskfn="_server_utest_mod",
                         mapfn="_server_utest_mod",
                         partitionfn="_server_utest_mod",
                         reducefn="_server_utest_mod",
                         finalfn="_server_utest_mod",
                         storage="mem:_server_utest_pipe",
                         init_args={"device": "cpu"})
        server2 = Server(store2, poll_interval=0.01, pipeline=True,
                         premerge_min_runs=2,
                         segment_format="v2").configure(spec2)
        w2 = Worker(store2).configure(max_iter=400, max_sleep=0.02)
        t2 = threading.Thread(target=w2.execute, daemon=True)
        t2.start()
        stats2 = server2.loop()
        t2.join(timeout=30)
        assert mod.result == {"n": 4}, mod.result
        it2 = stats2.iterations[-1]
        assert it2.map.count == 3 and it2.reduce.failed == 0
        assert it2.premerge.failed == 0

        # HA leg (DESIGN §31): the same task under the leader-lease
        # election — one contender simply wins epoch 1, leads fenced,
        # and releases on completion; a late second contender observes
        # the FINISHED task and returns without ever leading
        mod.result = None
        store3 = MemJobStore()
        spec3 = TaskSpec(taskfn="_server_utest_mod",
                         mapfn="_server_utest_mod",
                         partitionfn="_server_utest_mod",
                         reducefn="_server_utest_mod",
                         finalfn="_server_utest_mod",
                         storage="mem:_server_utest_ha",
                         init_args={"device": "cpu"})
        server3 = Server(store3, poll_interval=0.01, ha=True,
                         lease_ttl_s=5.0).configure(spec3)
        w3 = Worker(store3).configure(max_iter=400, max_sleep=0.02)
        t3 = threading.Thread(target=w3.execute, daemon=True)
        t3.start()
        stats3 = server3.loop()
        t3.join(timeout=30)
        assert mod.result == {"n": 4}, mod.result
        assert stats3.iterations[-1].map.count == 3
        doc = store3.pt_get("leader")
        assert doc is not None and doc["epoch"] == 1 and not doc["holder"]
        standby = Server(store3, poll_interval=0.01, ha=True,
                         lease_ttl_s=5.0)
        spec3b = TaskSpec(taskfn="_server_utest_mod",
                          mapfn="_server_utest_mod",
                          partitionfn="_server_utest_mod",
                          reducefn="_server_utest_mod",
                          finalfn="_server_utest_mod",
                          storage="mem:_server_utest_ha",
                          init_args={"device": "cpu"})
        standby.configure(spec3b)
        # task doc is FINISHED: the next ha loop() leads a FRESH run —
        # assert instead the fenced guard surface directly: a lease
        # fenced by a successor epoch rejects mutations permanently
        from lua_mapreduce_tpu_torch.faults.errors import StaleLeaderError
        from lua_mapreduce_tpu_torch.sched.lease import (FencedJobStore,
                                                         LeaderLease)
        now = [0.0]
        zl = LeaderLease(store3, holder="z", ttl_s=1.0,
                         clock=lambda: now[0])
        assert zl.try_acquire() and zl.epoch == 2
        now[0] += 5.0
        nl = LeaderLease(store3, holder="n", ttl_s=1.0,
                         clock=lambda: now[0])
        assert nl.try_acquire() and nl.took_over
        fenced = FencedJobStore(store3, zl)
        try:
            fenced.update_task({"status": "MAP"})
            raise AssertionError("zombie write must be fenced")
        except StaleLeaderError as e:
            assert e.current_epoch == 3
    finally:
        del sys.modules["_server_utest_mod"]
