"""Map/reduce job execution — the host-side data path.

Copy of the JAX package's ``engine/job.py`` (reference mapreduce/job.lua)
on its v1-text, unreplicated, staged path: no push shuffle, no native
map/merge/reduce kernels, no compiled reduce fold. Result bytes are
identical to the JAX package's on the same inputs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

from lua_mapreduce_tpu_torch.core import tuples
from lua_mapreduce_tpu_torch.core.constants import MAX_MAP_RESULT
from lua_mapreduce_tpu_torch.core.merge import merge_iterator
from lua_mapreduce_tpu_torch.core.segment import writer_for
from lua_mapreduce_tpu_torch.core.serialize import (assert_serializable,
                                                    dump_record, sorted_keys,
                                                    to_plain)
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.store.base import Store


@dataclasses.dataclass
class JobTimes:
    """Per-job timing (reference job.lua:117-152)."""
    started: float
    finished: float = 0.0
    written: float = 0.0
    cpu: float = 0.0

    @property
    def real(self) -> float:
        return self.written - self.started


def _intern_if_seq(v: Any) -> Any:
    return tuples.intern(v) if isinstance(v, (list, tuple)) else v


def make_map_emit(result: Dict[Any, List[Any]], combiner):
    """Build the map-side ``emit`` closure (reference job.lua:66-97).

    Groups values per interned key in memory; when a key accumulates more
    than MAX_MAP_RESULT values and a combiner exists, combine in place
    (job.lua:92-96). Emitted keys/values pass through :func:`to_plain`,
    so a tensor serializes exactly as its ``.tolist()``.
    """
    def emit(key: Any, value: Any) -> None:
        key = _intern_if_seq(to_plain(key))
        value = _intern_if_seq(to_plain(value))
        bucket = result.get(key)
        if bucket is None:
            bucket = result[key] = []
        bucket.append(value)
        if combiner is not None and len(bucket) > MAX_MAP_RESULT:
            result[key] = [to_plain(combiner(key, bucket))]
    return emit


def map_key_str(job_id: Any) -> str:
    """Canonical run-name form of a map job id: canonical decimals are
    zero-padded to 8 digits so lexicographic run-name order — the order
    the merge concatenates equal-key values in — equals job order."""
    s = str(job_id)
    if s.isdigit() and str(int(s)) == s:
        return f"{int(s):08d}"
    return s


def map_output_name(result_ns: str, part: int, map_key: Any) -> str:
    """Intermediate run-file name ``<ns>.P<part>.M<mapkey>``
    (reference job.lua:208-214)."""
    return f"{result_ns}.P{part}.M{map_key_str(map_key)}"


def run_map_job(spec: TaskSpec, store: Store, job_id: str,
                map_key: Any, map_value: Any) -> JobTimes:
    """Execute one map job and write per-partition sorted run files.

    Mirrors job.lua:154-228: run the user mapfn with the grouping emit,
    sort keys, apply the combiner per key, route keys through
    partitionfn, write one atomic (overwriting) file per non-empty
    partition.
    """
    times = JobTimes(started=time.time())
    cpu0 = time.process_time()
    result: Dict[Any, List[Any]] = {}
    combiner = spec.combinerfn
    spec.mapfn(map_key, map_value, make_map_emit(result, combiner))
    times.finished = time.time()

    writers: Dict[int, Any] = {}
    try:
        for key in sorted_keys(result.keys()):
            values = result[key]
            if combiner is not None and len(values) > 1:
                values = [to_plain(combiner(key, values))]
            for v in values:
                assert_serializable(v, f"map value for key {key!r}")
            part = int(spec.partitionfn(key))
            if part < 0:
                raise ValueError(
                    f"partitionfn({key!r}) returned negative {part}")
            w = writers.get(part)
            if w is None:
                w = writers[part] = writer_for(store)
            w.add(key, values)
        for part, w in writers.items():
            w.build(map_output_name(spec.result_ns, part, job_id))
    finally:
        for w in writers.values():
            w.close()

    times.cpu = time.process_time() - cpu0
    times.written = time.time()
    return times


def run_reduce_job(spec: TaskSpec, store: Store, result_store: Store,
                   part_key: str, run_files: List[str],
                   result_file: str) -> JobTimes:
    """Execute one reduce job: k-way merge a partition's runs, fold with
    reducefn, publish the partition result (job.lua:230-296).

    Flagged (assoc ∧ commut ∧ idempotent) reducers skip reducefn on
    singleton groups (264-275); results land in the *result* store
    (249-251, 287); consumed run files are deleted after success (293).
    """
    times = JobTimes(started=time.time())
    cpu0 = time.process_time()
    fast = spec.fast_path
    reducefn = spec.reducefn
    builder = result_store.builder()
    try:
        for key, values in merge_iterator(store, run_files):
            if fast and len(values) == 1:
                reduced = values[0]
            else:
                reduced = to_plain(reducefn(key, values))
            assert_serializable(reduced, f"reduce value for key {key!r}")
            builder.write(dump_record(key, [reduced]) + "\n")
        times.finished = time.time()
        builder.build(result_file)
    finally:
        builder.close()
    times.cpu = time.process_time() - cpu0
    times.written = time.time()

    for name in run_files:
        store.remove(name)
    return times
