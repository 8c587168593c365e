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

Trimmed from the JAX server, to be ported with ROADMAP A6b: the push
shuffle, replication and erasure coding with their lost-file recovery,
speculation, autotune and ``set_fleet``, the HA leader lease and the
notify waiter (the barrier polls at ``poll_interval``). Those options
are accepted only at their "off" value; anything else raises
NotImplementedError.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
import zlib
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
from lua_mapreduce_tpu_torch.engine.worker import check_off
from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
from lua_mapreduce_tpu_torch.faults.wrappers import unwrap, wrap_jobstore
from lua_mapreduce_tpu_torch.store.router import get_storage_from
from lua_mapreduce_tpu_torch.trace.span import TRACE_NS, active_tracer
from lua_mapreduce_tpu_torch.utils.stats import (IterationStats, TaskStats,
                                                 overlap_fraction)

# JAX-server options this port does not implement, with the values that
# select the behaviour it does implement (ROADMAP A6b)
_OFF_VALUES = {
    "replication": (None, 1),
    "coding": (None,),
    "speculation": (None, 0),
    "speculation_cap": (2,),
    "push": (None, False),
    "autotune": (None, False),
    "autotune_config": (None,),
    "ha": (None, False),
    "lease_ttl_s": (None,),
}

# loop-state checkpoints: ``_state.<N>`` holds the state that FEEDS
# iteration N, CRC-framed (the JAX package's sched/lease.py:72-130
# format, so either package reads the other's checkpoint)
STATE_NS = "_state"
_STATE_MAGIC = b"LMRS1"


def frame_state(obj: Any) -> bytes:
    """CRC-framed encoding of a JSON-serializable loop state: magic +
    8-byte big-endian length + payload + crc32(payload). A torn write
    reads as corrupt, never as silently wrong state."""
    from lua_mapreduce_tpu_torch.core.serialize import to_plain
    payload = json.dumps(to_plain(obj), sort_keys=True,
                         separators=(",", ":")).encode("utf-8")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return (_STATE_MAGIC + len(payload).to_bytes(8, "big") + payload
            + crc.to_bytes(4, "big"))


def unframe_state(data: bytes) -> Any:
    """Decode and CRC-check a :func:`frame_state` frame; ValueError on
    truncation, a magic mismatch or a checksum failure."""
    if len(data) < len(_STATE_MAGIC) + 12 \
            or not data.startswith(_STATE_MAGIC):
        raise ValueError("loop-state frame: bad magic/truncated header")
    off = len(_STATE_MAGIC)
    n = int.from_bytes(data[off:off + 8], "big")
    payload = data[off + 8:off + 8 + n]
    if len(payload) != n:
        raise ValueError("loop-state frame: truncated payload")
    crc = int.from_bytes(data[off + 8 + n:off + 12 + n], "big")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise ValueError("loop-state frame: CRC mismatch")
    return json.loads(payload.decode("utf-8"))


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
    shuffle, ``segment_format`` the fleet's spill encoding.
    """

    def __init__(self, store: JobStore, poll_interval: float = DEFAULT_SLEEP,
                 stale_timeout_s: Optional[float] = 600.0,
                 verbose: bool = False, strict: bool = False,
                 pipeline: bool = False, premerge_min_runs: int = 4,
                 premerge_max_runs: int = 8, batch_k: int = 1,
                 segment_format: str = "v1", engine: Optional[str] = None,
                 **options):
        for name, value in options.items():
            if name not in _OFF_VALUES:
                raise TypeError(f"Server got an unexpected option {name!r}")
            check_off("Server", name, value, _OFF_VALUES)
        from lua_mapreduce_tpu_torch.engine.ingraph import resolve_engine
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
        self.engine = resolve_engine(engine)
        self._ingraph = None           # IngraphRunner, built in loop()
        self.spec: Optional[TaskSpec] = None
        self.stats = TaskStats()
        self.finished_value: Any = None
        self.errors: List[dict] = []   # every drained worker error, kept
        self._data_store = None
        self._housekeep_at: Optional[float] = None

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
        """
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
                self.store.update_task({"pipeline": self.pipeline,
                                        "batch_k": self.batch_k,
                                        "segment_format":
                                            self.segment_format,
                                        "engine": self.engine})
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
                # the fleet's default claim-lease size
                "batch_k": self.batch_k,
                # the fleet's spill encoding (readers sniff per file)
                "segment_format": self.segment_format,
                "engine": self.engine,
                "started": time.time(),
            })

        self._data_store = get_storage_from(self.spec.storage)
        if task is None:
            # a fresh run purges a previous run's flushed spans (through
            # the raw store: telemetry housekeeping must not consume
            # FaultPlan occurrences) and must never restore a previous
            # task's loop state
            raw = unwrap(self._data_store)
            for name in raw.list(f"{TRACE_NS}.*"):
                raw.remove(name)
            self._purge_loop_state()
        else:
            self._restore_loop_state(iteration)
        store = self._data_store
        result_store = (get_storage_from(self.spec.result_storage)
                        if self.spec.result_storage else store)

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
                continue

            self.finished_value = verdict
            self.store.update_task({"status": TaskStatus.FINISHED.value})
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
        return len(jobs)

    def _clean_runs(self, store) -> None:
        """Drop every intermediate run file of this namespace: mapper
        runs (``ns.P*.M*``) and pipelined spills (``ns.P*.SPILL-*``)."""
        for pattern in (f"{self.spec.result_ns}.P*.M*",
                        f"{self.spec.result_ns}.P*.{SPILL_TAG}-*"):
            for name in store.list(pattern):
                store.remove(name)
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
                                       map_keys)
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
        return len(docs)

    def _housekeep(self, *namespaces: str) -> None:
        """One poll's upkeep (server.lua:186-234), throttled to the
        poll_interval cadence: scavenge BROKEN≥retries → FAILED and
        requeue stale RUNNING in every given namespace, drain and retain
        worker errors, soft-flush the trace buffer."""
        now = time.time()
        if self._housekeep_at is not None \
                and now - self._housekeep_at < self.poll_interval:
            return
        self._housekeep_at = now
        for ns in namespaces:
            self.store.scavenge(ns, MAX_JOB_RETRIES)
            if self.stale_timeout_s is not None:
                self.store.requeue_stale(ns, self.stale_timeout_s)
        for err in self.store.drain_errors():
            # the drain is destructive — always retain for diagnosis
            self.errors.append(err)
            self._log(f"worker error [{err['worker']}]: "
                      f"{err['msg'].splitlines()[-1] if err['msg'] else ''}")
        # soft flush: nothing happens below the tracer's threshold
        self._trace_flush()

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
            min_runs=self.premerge_min_runs, max_runs=self.premerge_max_runs)
        for name in store.list(f"{ns}.P*.{SPILL_TAG}-*"):
            parsed = parse_spill_name(ns, name)    # crash/resume leftovers
            if parsed is not None:
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
                    # FAILED jobs contribute whatever partial runs they
                    # published, as the barrier path's discovery does
                    key = map_key_str(d["_id"])
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
            time.sleep(self.poll_interval)

    def _wait_phase(self, ns: str, total: int, phase: str,
                    progress: Optional[Callable[[str, float], None]]) -> None:
        """Barrier poll (server.lua:186-234): every ``poll_interval`` —
        housekeeping, progress — until every job is WRITTEN or FAILED."""
        while True:
            self._housekeep(ns)
            counts = self.store.counts(ns)
            done = counts[Status.WRITTEN] + counts[Status.FAILED]
            if progress is not None:
                progress(phase, done / max(total, 1))
            if done >= total:
                self._finish_phase(phase, counts, total)
                return
            time.sleep(self.poll_interval)

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
