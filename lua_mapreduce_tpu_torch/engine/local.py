"""Single-process MapReduce executor.

Copy of the JAX package's ``engine/local.py``: taskfn → map → shuffle →
reduce → finalfn, with the ``"loop"`` iteration protocol, in one process
with no coordinator. Map and reduce jobs run through engine/job.py, so
result files are byte-identical to the JAX package's LocalExecutor on
the same task.

``pipeline`` runs the pipelined shuffle: map and eager pre-merge share
the thread pool with no phase barrier (engine/premerge.py), and the
reduce merges {spills + tail runs}. ``segment_format`` picks the spill
encoding ("v1" text or "v2" framed segments, core/segment.py); result
files stay v1 text. With a tracer active (``trace/``) every job body is
a span, flushed into the task storage at the end of each iteration.

The ``engine`` knob (None = ``LMR_ENGINE``, else ``"auto"``) picks the
execution engine as the JAX executor does: ``"auto"`` consults the
static lowerability oracle at task load and runs an in-graph-verdicted
task's data plane as one captured program (engine/ingraph.py), or the
qualifying legs of a partly numeric task compiled (engine/hybrid.py),
else the store plane; ``"ingraph"`` and ``"hybrid"`` force a rung;
``"store"`` opts out. The compiled engines run on ``device`` (default:
the task's ``init_args["device"]``, else ``"cuda"``). As in the JAX
executor, an in-graph iteration ignores ``pipeline`` and the hybrid
compiled map leg runs only on the barrier path.

``replication`` (an int r, or with ``coding`` a ``"k+m"`` spec) publishes
every spill to r placement copies or as k+m erasure-coded stripes, and
reads fail over or decode from the survivors (faults/replicate.py,
faults/coded.py); ``push`` runs the push shuffle (engine/push.py) under
a memory budget of ``push_budget_mb``. Result bytes are the same with
either on or off.

``autotune`` (None = ``LMR_AUTOTUNE``, else off) runs the feedback
controller (sched/controller.py) once per iteration on that iteration's
stats: with no control plane there is no claim-RPC signal, so it owns
the push budget, the retry back-off base and the thread-pool width.
"""

from __future__ import annotations

import re
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from lua_mapreduce_tpu_torch.core.constants import MAX_TASKFN_VALUE_SIZE
from lua_mapreduce_tpu_torch.core.segment import (check_format,
                                                  purge_footer_cache)
from lua_mapreduce_tpu_torch.core.serialize import (load_record,
                                                    serialized_size)
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.job import (JobTimes, map_key_str,
                                                run_map_job,
                                                run_premerge_job,
                                                run_reduce_job)
from lua_mapreduce_tpu_torch.engine.premerge import (SPILL_TAG,
                                                     PremergeTracker,
                                                     discover_pipelined,
                                                     run_name_re,
                                                     sweep_leftovers)
from lua_mapreduce_tpu_torch.engine.push import (BufferPool,
                                                 discover_push,
                                                 ensure_canonical,
                                                 manifest_files_by_part,
                                                 resolve_push,
                                                 resolve_push_budget,
                                                 sweep_push_files)
from lua_mapreduce_tpu_torch.faults.coded import resolve_redundancy
from lua_mapreduce_tpu_torch.faults.replicate import reading_view
from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
from lua_mapreduce_tpu_torch.store.router import get_storage_from
from lua_mapreduce_tpu_torch.trace.span import TRACE_NS, active_tracer
from lua_mapreduce_tpu_torch.utils.stats import (IterationStats, TaskStats,
                                                 overlap_fraction)

# span namespaces, matching the distributed engine's job queues so one
# collector (trace/collect.py) reads both executors' timelines alike
_SPAN_NS = {"map": "map_jobs", "pre_merge": "pre_jobs",
            "reduce": "red_jobs"}


def collect_task_jobs(spec: TaskSpec) -> List[Tuple[Any, Any]]:
    """Run taskfn and validate its emissions (server.lua:249-276):
    duplicate job keys are an error; serialized job values are capped at
    MAX_TASKFN_VALUE_SIZE."""
    jobs: List[Tuple[Any, Any]] = []
    seen = set()

    def emit(key: Any, value: Any) -> None:
        if key in seen:
            raise ValueError(f"taskfn emitted duplicate job key {key!r} "
                             "(reference server.lua:259-261)")
        seen.add(key)
        size = serialized_size(value)
        if size > MAX_TASKFN_VALUE_SIZE:
            raise ValueError(
                f"taskfn value for key {key!r} is {size} bytes; max is "
                f"{MAX_TASKFN_VALUE_SIZE} (reference server.lua:263-267)")
        jobs.append((key, value))

    spec.taskfn(emit)
    return jobs


_PART_RE_TMPL = r"^{ns}\.P(\d+)\.M(.+)$"


def discover_partitions(store, result_ns: str,
                        ignore: Iterable[str] = ()) -> Dict[int, List[str]]:
    """Group map-output run files by partition (server.lua:291-312);
    run files come back in sorted (= map job) order. Names in ``ignore``
    (leftovers no sweep could remove and no map published over) are not
    read."""
    pat = re.compile(_PART_RE_TMPL.format(ns=re.escape(result_ns)))
    parts: Dict[int, List[str]] = {}
    for name in store.list(f"{result_ns}.P*.M*"):
        m = pat.match(name)
        if m and name not in ignore:
            parts.setdefault(int(m.group(1)), []).append(name)
    return parts


def result_file_name(result_ns: str, part: int) -> str:
    return f"{result_ns}.P{part}"


def iter_results(result_store, result_ns: str
                 ) -> Iterator[Tuple[Any, List[Any]]]:
    """Yield (key, values) over all partition result files in partition
    order — the finalfn pair iterator (server.lua:353-385)."""
    pat = re.compile(rf"^{re.escape(result_ns)}\.P(\d+)$")
    names = [n for n in result_store.list(f"{result_ns}.P*") if pat.match(n)]
    names.sort(key=lambda n: int(pat.match(n).group(1)))
    for name in names:
        for line in result_store.lines(name):
            line = line.strip()
            if line:
                yield load_record(line)


def delete_results(result_store, result_ns: str) -> None:
    """Drop all partition result files (server.lua:406-412 gc)."""
    pat = re.compile(rf"^{re.escape(result_ns)}\.P(\d+)$")
    for name in result_store.list(f"{result_ns}.P*"):
        if pat.match(name):
            result_store.remove(name)


class LocalExecutor:
    """Run a TaskSpec to completion in-process.

    ``map_parallelism`` > 1 runs map and reduce jobs on a thread pool —
    the in-process analog of N workers. ``max_iterations`` bounds the
    ``"loop"`` protocol. ``pipeline``, ``premerge_min_runs`` and
    ``premerge_max_runs`` drive the pipelined shuffle;
    ``segment_format`` the spill encoding; ``replication``/``coding``
    the shuffle redundancy and ``push``/``push_budget_mb`` the push
    shuffle; ``engine`` and ``device`` the execution engine and its
    device; ``autotune`` the feedback controller (module docstring).
    """

    def __init__(self, spec: TaskSpec, map_parallelism: int = 1,
                 max_iterations: int = 1000, pipeline: bool = False,
                 premerge_min_runs: int = 4, premerge_max_runs: int = 8,
                 segment_format: str = "v1", replication=None,
                 coding: Optional[str] = None, push: Optional[bool] = None,
                 push_budget_mb: Optional[float] = None, engine=None,
                 device=None, autotune: Optional[bool] = None):
        from lua_mapreduce_tpu_torch.sched.controller import \
            resolve_autotune
        self.spec = spec
        self.map_parallelism = max(1, map_parallelism)
        self.max_iterations = max_iterations
        self.pipeline = bool(pipeline)
        self.premerge_min_runs = premerge_min_runs
        self.premerge_max_runs = premerge_max_runs
        self.segment_format = check_format(segment_format)
        # the unified redundancy value: an int r or a Coding; 1 (the
        # default) is the unreplicated path
        self.replication = resolve_redundancy(replication, coding)
        # push shuffle: one memory-budgeted buffer pool shared by the
        # executor's map threads (its "worker")
        self.push = resolve_push(push)
        self._push_pool = (BufferPool(resolve_push_budget(push_budget_mb))
                           if self.push else None)
        self.store = get_storage_from(spec.storage)
        self.result_store = (get_storage_from(spec.result_storage)
                             if spec.result_storage else self.store)
        # discovery and cleanup address LOGICAL files through the
        # failover view (identity when redundancy is off)
        self._view = reading_view(self.store, self.replication)
        from lua_mapreduce_tpu_torch.engine.hybrid import HybridRunner
        from lua_mapreduce_tpu_torch.engine.ingraph import (IngraphRunner,
                                                            select_engine)
        self.engine_decision = select_engine(spec, engine)
        self.engine = self.engine_decision.chosen
        device = device if device is not None \
            else spec.init_args.get("device")

        def log(msg):
            print(f"[local] {msg}", file=sys.stderr)

        self._ingraph = IngraphRunner(spec, self.engine_decision,
                                      device=device, log=log)
        self._hybrid = HybridRunner(spec, self.engine_decision,
                                    device=device, log=log)
        # the feedback controller, minted on the first tick; the pool
        # width never drops below the user's map_parallelism
        self.autotune = resolve_autotune(autotune)
        self._controller = None
        self._pool_floor = self.map_parallelism
        self.stats = TaskStats()
        self.finished_value: Any = None

    def _traced(self, label: str, job_id, fn):
        """Run one job body under a trace span (the in-process analog of
        the Worker's body span), or plainly when tracing is off."""
        tracer = active_tracer()
        if tracer is None:
            return fn()
        tracer.set_actor("local")     # pool threads each declare it
        with tracer.span(f"{label}.body", ns=_SPAN_NS[label],
                         job_id=job_id, attempt=0):
            return fn()

    def _trace_flush(self) -> None:
        tracer = active_tracer()
        if tracer is None:
            return
        try:
            tracer.flush(self.store, force=True)
        except Exception as exc:
            print(f"[local] trace flush failed ({type(exc).__name__}: "
                  f"{exc}); spans re-buffered", file=sys.stderr)

    def _reduce_one(self, p, files) -> JobTimes:
        """One reduce job under its span, with the hybrid compiled fold
        plugged in (its None-means-interpret contract keeps the bytes)
        and its per-job counter hook."""
        t = self._traced(
            "reduce", p, lambda: run_reduce_job(
                self.spec, self.store, self.result_store, str(p), files,
                result_file_name(self.spec.result_ns, p),
                replication=self.replication,
                reduce_fold=self._hybrid.reduce_fold()))
        self._hybrid.note_reduce_job()
        return t

    def _map_one(self, i, k, v) -> JobTimes:
        return self._traced("map", i, lambda: run_map_job(
            self.spec, self.store, str(i), k, v,
            segment_format=self.segment_format,
            replication=self.replication, push=self.push,
            push_pool=self._push_pool))

    def _run_jobs(self, fns) -> List[JobTimes]:
        if self.map_parallelism == 1 or len(fns) <= 1:
            return [fn() for fn in fns]
        with ThreadPoolExecutor(max_workers=self.map_parallelism) as pool:
            return list(pool.map(lambda fn: fn(), fns))

    def run_one_iteration(self, iteration: int) -> Any:
        """One map→shuffle→reduce→final cycle; returns finalfn's verdict."""
        spec = self.spec
        tracer = active_tracer()
        if tracer is not None:
            tracer.set_iteration(iteration)
        it_stats = IterationStats(iteration=iteration)
        t0 = time.time()
        faults0 = COUNTERS.snapshot()
        # fresh result namespace per iteration: partitions that receive
        # no data must not leak last iteration's results
        # (server.lua:331-345)
        delete_results(self.result_store, spec.result_ns)
        # iteration rollover reuses run names with new contents; a
        # same-size rewrite would slip past the footer cache's key
        purge_footer_cache(self.store)
        if self.push:
            # a stale canonical manifest would win this iteration's
            # publish-if-absent race and name consumed files
            sweep_push_files(self._view, spec.result_ns)

        # in-graph engine: the whole data plane — map, shuffle, reduce —
        # runs as one program and the result files land directly;
        # taskfn/finalfn stay host-side. A build-time failure under
        # engine=auto degrades to the store plane for the rest of the
        # task (counted ingraph_fallbacks, logged, traced) and THIS
        # iteration re-runs through the store path right here.
        ran_ingraph = self._ingraph.active and \
            self._ingraph.run_iteration(self.result_store, iteration)
        # zero-leg forced hybrid leaves its once-per-task evidence here,
        # inside the iteration's counter window
        self._hybrid.ensure_evidence()
        if ran_ingraph:
            pass                 # results published by the compiled plane
        elif self.pipeline:
            # the compiled map leg is itself a batch barrier, so it
            # composes with the barrier path only; the pipelined map
            # stays interpreted (the reduce fold still applies)
            jobs = collect_task_jobs(spec)
            (map_times, pre_times, pre_failed,
             reduce_times) = self._run_pipelined(jobs)
            it_stats.map.fold(map_times)
            it_stats.premerge.fold(pre_times, failed=pre_failed)
            it_stats.overlap_fraction = overlap_fraction(map_times,
                                                         pre_times)
            it_stats.reduce.fold(reduce_times)
        else:
            jobs = collect_task_jobs(spec)
            # hybrid compiled map+combine leg: the whole iteration's map
            # jobs as ONE program, published through the same tail
            # run_map_job uses — a failure degrades right here and the
            # interpreted loop below runs instead
            if not self._hybrid.run_map_leg(
                    jobs, self.store, segment_format=self.segment_format,
                    iteration=iteration, replication=self.replication,
                    push=self.push, push_pool=self._push_pool):
                it_stats.map.fold(self._run_jobs([
                    (lambda k=k, v=v, i=i: self._map_one(i, k, v))
                    for i, (k, v) in enumerate(jobs)]))
            if self.push:
                parts = discover_push(
                    self._view, spec.result_ns,
                    [map_key_str(i) for i in range(len(jobs))],
                    replication=self.replication)
            else:
                parts = discover_partitions(self._view, spec.result_ns)
            it_stats.reduce.fold(self._run_jobs([
                (lambda p=p, files=files: self._reduce_one(p, files))
                for p, files in sorted(parts.items())]))

        verdict: Any = None
        if spec.finalfn is not None:
            verdict = spec.finalfn(iter_results(self.result_store,
                                                spec.result_ns))
        it_stats.fold_fault_counters(
            COUNTERS.delta(faults0, COUNTERS.snapshot()))
        it_stats.wall_time = time.time() - t0
        self.stats.iterations.append(it_stats)
        if self.autotune:
            try:
                self._autotune_tick(it_stats)
            except Exception as exc:
                print(f"[local] autotune tick failed ({type(exc).__name__}:"
                      f" {exc}); knobs hold", file=sys.stderr)
        self._trace_flush()
        return verdict

    # -- self-tuning controller ---------------------------------------------

    def _autotune_tick(self, it_stats: IterationStats) -> None:
        from lua_mapreduce_tpu_torch.sched.controller import (
            AutotuneConfig, AutotuneController, Observation)
        if self._controller is None:
            import os

            from lua_mapreduce_tpu_torch.faults.retry import retry_settings
            cap = max(self.map_parallelism,
                      min(AutotuneConfig().fleet_max, os.cpu_count() or 4))
            self._controller = AutotuneController(
                push_budget_mb=(self._push_pool.budget / (1024 * 1024)
                                if self._push_pool is not None else None),
                retry_base_ms=float(retry_settings()["base_ms"]),
                fleet=self.map_parallelism, fleet_max=cap)
        body = (it_stats.map.sum_real_time / it_stats.map.count
                if it_stats.map.count else None)
        obs = Observation(
            t=time.time(), body_ewma_s=body,
            jobs_done=it_stats.map.count + it_stats.reduce.count,
            push_frames=it_stats.push_frames,
            push_evictions=it_stats.push_evictions,
            spec_launched=it_stats.spec_launched,
            spec_wins=it_stats.spec_wins,
            spec_wasted_s=it_stats.spec_wasted_s,
            store_retries=it_stats.store_retries,
            # the loop protocol replays the same job census next
            # iteration: this iteration's map fan-out is the backlog the
            # pool faces again (the queue-depth analog)
            waiting=it_stats.map.count, running=0,
            fleet=self.map_parallelism)
        for d in self._controller.tick(obs):
            self._apply_decision(d)

    def _apply_decision(self, d) -> None:
        print(f"[local] autotune: {d.knob} {d.old} -> {d.new} "
              f"({d.metric}={d.observed:.4g}, threshold {d.threshold:.4g})",
              file=sys.stderr)
        if d.knob == "push_budget_mb" and self._push_pool is not None:
            self._push_pool.budget = int(float(d.new) * 1024 * 1024)
        elif d.knob == "retry_base_ms":
            from lua_mapreduce_tpu_torch.faults.retry import (
                configure_retry, retry_settings)
            configure_retry(retries=int(retry_settings()["retries"]),
                            base_ms=float(d.new))
        elif d.knob == "fleet":
            # pools are minted per _run_jobs call, so a width change
            # takes effect at the next iteration's first job wave; the
            # floor is the user's configured parallelism
            self.map_parallelism = max(self._pool_floor, int(d.new))

    def _run_pipelined(self, jobs) -> Tuple[List[JobTimes], List[JobTimes],
                                            int, List[JobTimes]]:
        """Map + eager pre-merge on ONE shared thread pool, no phase
        barrier between them; reduce tasks join the same pool once every
        map (and every launched pre-merge) finished.

        Each map completion feeds the tracker under a lock and submits
        any newly eligible consolidation batches at once, so a pre-merge
        can run while later mappers are still mid-flight. A failed
        pre-merge poisons its range and the reduce falls back to the raw
        runs; map/reduce exceptions propagate as in the barrier path.
        """
        spec = self.spec
        map_keys = [map_key_str(i) for i in range(len(jobs))]
        # every spill here is an earlier iteration's; one whose copy no
        # sweep could remove (an unreachable placement tag) keeps a name
        # this iteration neither publishes nor reads
        unremoved = sweep_leftovers(self._view,
                                    [f"{spec.result_ns}.P*.{SPILL_TAG}-*"])
        if unremoved:
            COUNTERS.bump("unremoved_spills", len(unremoved))
        tracker = PremergeTracker(spec.result_ns, map_keys,
                                  min_runs=self.premerge_min_runs,
                                  max_runs=self.premerge_max_runs,
                                  avoid=unremoved)
        run_re = run_name_re(spec.result_ns)
        lock = threading.Lock()
        map_times: List[JobTimes] = []
        pre_times: List[JobTimes] = []
        pre_futs: List = []
        pre_failed = [0]
        committed = [0]
        pool = ThreadPoolExecutor(max_workers=self.map_parallelism)

        def premerge_one(sp):
            try:
                t = self._traced(
                    "pre_merge", f"{sp.part}.{sp.seq}",
                    lambda: run_premerge_job(
                        spec, self.store, sp.files, sp.name,
                        segment_format=self.segment_format,
                        replication=self.replication))
            except Exception as e:
                # probe the store BEFORE taking the tracker lock: holding
                # it across storage IO would convoy every committing map
                spill_exists = self._view.exists(sp.name)
                with lock:
                    pre_failed[0] += 1
                    tracker.spill_failed(sp.part, sp.seq,
                                         spill_exists=spill_exists)
                print(f"[local] pre_merge {sp.name} failed; reduce falls "
                      f"back to raw runs: {type(e).__name__}: {e}",
                      file=sys.stderr)
                return
            with lock:
                pre_times.append(t)
                tracker.spill_done(sp.part, sp.seq)

        def map_one(i, k, v):
            t = self._map_one(i, k, v)
            produced = {}
            if self.push:
                man = ensure_canonical(self.store, spec.result_ns,
                                       map_keys[i], self.replication)
                if man is not None:
                    produced = manifest_files_by_part(man)
            if not produced:
                for name in self.store.list(
                        f"{spec.result_ns}.P*.M{map_keys[i]}"):
                    m = run_re.match(name)
                    if m and m.group(2) == map_keys[i]:
                        produced[int(m.group(1))] = name
            with lock:
                map_times.append(t)
                tracker.note_map_committed(map_keys[i], produced)
                committed[0] += 1
                if committed[0] < len(jobs):
                    # the LAST commit publishes nothing: a post-map
                    # spill would serialize in front of the reduce
                    for sp in tracker.take_eligible():
                        pre_futs.append(pool.submit(premerge_one, sp))
            return t

        try:
            map_futs = [pool.submit(map_one, i, k, v)
                        for i, (k, v) in enumerate(jobs)]
            for f in map_futs:
                f.result()
            for f in list(pre_futs):
                f.result()
            parts = discover_pipelined(self._view, spec.result_ns, map_keys,
                                       push=self.push,
                                       replication=self.replication,
                                       ignore=unremoved)
            red_futs = [pool.submit(
                lambda p=p, files=files: self._reduce_one(p, files))
                for p, files in sorted(parts.items())]
            reduce_times = [f.result() for f in red_futs]
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        return map_times, pre_times, pre_failed[0], reduce_times

    def clean_namespace(self) -> None:
        """Drop every file under this task's result namespace in both
        stores (server.lua:331-345, 237-245), through the failover view:
        logical listing, removal of every copy."""
        for store in {id(self.store): self._view,
                      id(self.result_store): reading_view(
                          self.result_store, self.replication)}.values():
            for name in store.list(f"{self.spec.result_ns}.P*"):
                store.remove(name)

    def run(self) -> TaskStats:
        """Run iterations until finalfn stops looping (server.lua:466-611,
        387-403: "loop" → repeat; True → drop results; else keep)."""
        self.clean_namespace()
        # purge a previous run's flushed spans, through the raw store
        # (telemetry housekeeping must not consume FaultPlan occurrences)
        raw = unwrap(self.store)
        for name in raw.list(f"{TRACE_NS}.*"):
            raw.remove(name)
        t0 = time.time()
        iteration = 1
        while iteration <= self.max_iterations:
            verdict = self.run_one_iteration(iteration)
            if verdict == "loop":
                iteration += 1
                continue
            self.finished_value = verdict
            if verdict is True:
                delete_results(self.result_store, self.spec.result_ns)
            break
        else:
            raise RuntimeError(
                f"exceeded max_iterations={self.max_iterations}")
        self.stats.wall_time = time.time() - t0
        return self.stats

    def results(self) -> Iterator[Tuple[Any, List[Any]]]:
        """Iterate final results (valid when finalfn did not return True)."""
        return iter_results(self.result_store, self.spec.result_ns)
