"""Single-process MapReduce executor.

Copy of the JAX package's ``engine/local.py`` barrier path: taskfn →
map → shuffle → reduce → finalfn, with the ``"loop"`` iteration protocol,
in one process with no coordinator. Map and reduce jobs run through
engine/job.py, so result files are byte-identical to the JAX package's
LocalExecutor on the same task.

The JAX executor's other planes (pipelined shuffle, push shuffle,
replication and erasure coding, the in-graph and hybrid engines, the
autotune controller, v2 segments) are later slices. Their options are
accepted only at the value that means "off"; any other value raises, so
a caller never gets a silently different run.
"""

from __future__ import annotations

import re
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Tuple

from lua_mapreduce_tpu_torch.core.constants import MAX_TASKFN_VALUE_SIZE
from lua_mapreduce_tpu_torch.core.serialize import (load_record,
                                                    serialized_size)
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.job import (JobTimes, run_map_job,
                                                run_reduce_job)
from lua_mapreduce_tpu_torch.store.router import get_storage_from
from lua_mapreduce_tpu_torch.utils.stats import IterationStats, TaskStats

# JAX-executor options this port does not implement, with the values
# that select the behaviour it does implement
_OFF_VALUES = {
    "pipeline": (False,),
    "push": (None, False),
    "push_budget_mb": (None,),
    "replication": (None, 1),
    "coding": (None,),
    "autotune": (None, False),
    "engine": (None, "store"),
    "segment_format": ("v1",),
}


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


def discover_partitions(store, result_ns: str) -> Dict[int, List[str]]:
    """Group map-output run files by partition (server.lua:291-312);
    run files come back in sorted (= map job) order."""
    pat = re.compile(_PART_RE_TMPL.format(ns=re.escape(result_ns)))
    parts: Dict[int, List[str]] = {}
    for name in store.list(f"{result_ns}.P*.M*"):
        m = pat.match(name)
        if m:
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
    ``"loop"`` protocol.
    """

    def __init__(self, spec: TaskSpec, map_parallelism: int = 1,
                 max_iterations: int = 1000, **options):
        for name, value in options.items():
            off = _OFF_VALUES.get(name)
            if off is None:
                raise TypeError(f"LocalExecutor got an unexpected option "
                                f"{name!r}")
            if value not in off:
                raise ValueError(
                    f"LocalExecutor option {name}={value!r} is not "
                    f"implemented by the torch port (accepted: {off})")
        self.spec = spec
        self.map_parallelism = max(1, map_parallelism)
        self.max_iterations = max_iterations
        self.store = get_storage_from(spec.storage)
        self.result_store = (get_storage_from(spec.result_storage)
                             if spec.result_storage else self.store)
        self.stats = TaskStats()
        self.finished_value: Any = None

    def _run_jobs(self, fns) -> List[JobTimes]:
        if self.map_parallelism == 1 or len(fns) <= 1:
            return [fn() for fn in fns]
        with ThreadPoolExecutor(max_workers=self.map_parallelism) as pool:
            return list(pool.map(lambda fn: fn(), fns))

    def run_one_iteration(self, iteration: int) -> Any:
        """One map→shuffle→reduce→final cycle; returns finalfn's verdict."""
        spec = self.spec
        it_stats = IterationStats(iteration=iteration)
        t0 = time.time()
        # fresh result namespace per iteration: partitions that receive
        # no data must not leak last iteration's results
        # (server.lua:331-345)
        delete_results(self.result_store, spec.result_ns)

        jobs = collect_task_jobs(spec)
        it_stats.map.fold(self._run_jobs([
            (lambda k=k, v=v, i=i: run_map_job(spec, self.store, str(i), k,
                                               v))
            for i, (k, v) in enumerate(jobs)]))

        parts = discover_partitions(self.store, spec.result_ns)
        it_stats.reduce.fold(self._run_jobs([
            (lambda p=p, files=files: run_reduce_job(
                spec, self.store, self.result_store, str(p), files,
                result_file_name(spec.result_ns, p)))
            for p, files in sorted(parts.items())]))

        verdict: Any = None
        if spec.finalfn is not None:
            verdict = spec.finalfn(iter_results(self.result_store,
                                                spec.result_ns))
        it_stats.wall_time = time.time() - t0
        self.stats.iterations.append(it_stats)
        return verdict

    def clean_namespace(self) -> None:
        """Drop every file under this task's result namespace in both
        stores (server.lua:331-345, 237-245)."""
        for store in {id(self.store): self.store,
                      id(self.result_store): self.result_store}.values():
            for name in store.list(f"{self.spec.result_ns}.P*"):
                store.remove(name)

    def run(self) -> TaskStats:
        """Run iterations until finalfn stops looping (server.lua:466-611,
        387-403: "loop" → repeat; True → drop results; else keep)."""
        self.clean_namespace()
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
