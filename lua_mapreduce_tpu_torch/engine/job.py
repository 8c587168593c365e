"""Map/reduce job execution — the host-side data path.

Copy of the JAX package's ``engine/job.py`` (reference mapreduce/job.lua)
— v1 text or v2 framed segments, the pipelined shuffle's pre-merge
job, r-way replicated or k+m erasure-coded spills (faults/replicate.py,
faults/coded.py) and the push shuffle (engine/push.py). The hybrid
plane's compiled map leg and reduce fold plug in through
:func:`publish_map_groups` and ``run_reduce_job(reduce_fold=)``. Result
bytes are identical to the JAX package's on the same inputs.

On a store with ``local_path`` (``shared:``, unreplicated) the native
C++ paths take over where they apply: a mapfn tagged ``native_map``
runs the word-count map (core/native_wcmap.py), a reducefn tagged
``native_reduce = "sum"`` (associative and commutative) folds inside
the merge pass, and the pre-merge and reduce merges run in one C++
pass (core/native_merge.py). The Python path stays the semantic truth
and the fallback for anything the native side refuses.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterable, List

from lua_mapreduce_tpu_torch.core import tuples
from lua_mapreduce_tpu_torch.core.constants import MAX_MAP_RESULT
from lua_mapreduce_tpu_torch.core.merge import merge_iterator
from lua_mapreduce_tpu_torch.core.native_merge import (
    native_merge_records, native_merge_reduce_sum, native_premerge)
from lua_mapreduce_tpu_torch.core.segment import check_format
from lua_mapreduce_tpu_torch.core.serialize import (assert_serializable,
                                                    dump_record, sorted_keys,
                                                    to_plain)
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.premerge import run_name_re
from lua_mapreduce_tpu_torch.engine.push import manifest_name
from lua_mapreduce_tpu_torch.faults.replicate import (reading_view,
                                                      spill_writer)
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
                map_key: Any, map_value: Any,
                segment_format: str = "v1", replication=1,
                push: bool = False, push_pool=None,
                spec_lineage: str = None, fence=None,
                leftovers: Iterable[str] = ()) -> JobTimes:
    """Execute one map job and write per-partition sorted run files.

    Mirrors job.lua:154-228: run the user mapfn with the grouping emit,
    then publish the grouping through :func:`publish_map_groups`.
    ``segment_format`` picks the run-file encoding, ``"v1"`` text lines
    or ``"v2"`` framed segments (core/segment.py); readers sniff per
    file. ``replication`` is the unified redundancy value: an int fans
    each run file out to r placement copies, a ``"k+m"``/Coding spec
    publishes erasure-coded stripes instead; 1 is the plain path.
    ``push`` publishes through the push shuffle (engine/push.py): each
    partition's records land as frame files in the reducer inbox as
    frames fill, bounded by ``push_pool``'s memory budget, gated by the
    manifest published last. ``spec_lineage`` quarantines a speculative
    clone's pushes under its identity. Output records and their merge
    order are the same either way. ``fence`` is the lease check
    :func:`publish_map_groups` calls before it publishes; ``leftovers``
    are files of this job's key that the iteration-start sweep could
    not remove (:func:`publish_over_leftovers`).
    """
    check_format(segment_format)
    # discovery and stale-file removal address every copy; under
    # redundancy the view hides local_path (a native map writing only
    # the primary would silently under-replicate)
    store = reading_view(store, replication)
    times = JobTimes(started=time.time())
    cpu0 = time.process_time()
    # declared-intent native map: a mapfn tagged ``native_map`` promises
    # the C++ pass computes exactly what mapfn + partitionfn would
    native = getattr(spec.mapfn, "native_map", None)
    if native is not None and native.get("kind") == "wordcount_file":
        from lua_mapreduce_tpu_torch.core.native_wcmap import run_native_map
        if not push and leftovers and (fence is None or fence()):
            # the native pass writes the partitions it emits to over these
            publish_over_leftovers(spec, store, job_id, leftovers,
                                   segment_format, replication)
        if run_native_map(store, native, str(map_value), spec.result_ns,
                          job_id):
            times.cpu = time.process_time() - cpu0
            times.finished = times.written = time.time()
            return times
    result: Dict[Any, List[Any]] = {}
    spec.mapfn(map_key, map_value,
               make_map_emit(result, spec.combiner_for_map))
    times.finished = time.time()
    publish_map_groups(spec, store, job_id, result,
                       segment_format=segment_format,
                       replication=replication, push=push,
                       push_pool=push_pool, spec_lineage=spec_lineage,
                       fence=fence, leftovers=leftovers)
    times.cpu = time.process_time() - cpu0
    times.written = time.time()
    return times


def publish_map_groups(spec: TaskSpec, store: Store, job_id: str,
                       result: Dict[Any, List[Any]],
                       segment_format: str = "v1", replication=1,
                       push: bool = False, push_pool=None,
                       spec_lineage: str = None, fence=None,
                       leftovers: Iterable[str] = ()) -> None:
    """Publish one map job's grouped emissions — the one publish tail
    every map producer shares: the interpreted path (run_map_job above)
    and the compiled hybrid map leg (engine/hybrid.py) both land here,
    so combiner folding, serializability validation and partition
    routing are byte-identical by construction across the planes.

    Sort keys, apply the combiner per key, route keys through
    partitionfn, write one atomic (overwriting) file per non-empty
    partition (job.lua:154-228). One emit loop for both publish modes,
    so validation never differs between push-on and push-off runs; only
    the per-record sink differs: staged writers built at the end, or
    push frames streamed as buffers fill, the manifest last.

    ``fence`` (speculation: a duplicate may run this job at once) is
    called right before the staged writers publish; False means the
    job's lease is gone, and nothing is published. Run-file names repeat
    across loop iterations, so a duplicate that lost its race must not
    publish late over the next iteration's runs. For the same reason a
    file of this job's key that the iteration-start sweep could not
    remove (``leftovers``) is published over, never left beside this
    job's output (:func:`publish_over_leftovers`).
    """
    combiner = spec.combiner_for_map
    writers: Dict[int, Any] = {}
    pw = None
    try:
        if push:
            from lua_mapreduce_tpu_torch.engine.push import PushWriter
            pw = PushWriter(store, spec.result_ns, map_key_str(job_id),
                            replication=replication, pool=push_pool,
                            lineage=spec_lineage)
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
            if pw is not None:
                pw.add(part, key, values)
                continue
            w = writers.get(part)
            if w is None:
                w = writers[part] = spill_writer(store, segment_format,
                                                 replication)
            w.add(key, values)
        if pw is not None:
            pw.finish(publish_over=manifest_name(
                spec.result_ns, map_key_str(job_id)) in leftovers)
        elif fence is None or fence():
            publish_over_leftovers(spec, store, job_id, leftovers,
                                   segment_format, replication,
                                   skip=writers)
            for part, w in writers.items():
                w.build(map_output_name(spec.result_ns, part, job_id))
    finally:
        # an unbuilt builder (failed user code) releases its writer
        # thread, fd and tempfile now, not at GC
        if pw is not None:
            pw.close()
        for w in writers.values():
            w.close()


def publish_over_leftovers(spec: TaskSpec, store: Store, job_id: str,
                           leftovers: Iterable[str], segment_format: str,
                           replication, skip=()) -> None:
    """An empty run over each of this job's run files among
    ``leftovers`` (an earlier iteration's, which the iteration-start
    sweep could not remove) whose partition is not in ``skip`` (the
    partitions the job publishes itself): every run under this job's
    name is then this iteration's, and a partition it emits nothing to
    reads nothing of the old file."""
    run_re = run_name_re(spec.result_ns)
    key = map_key_str(job_id)
    for name in sorted(leftovers):
        m = run_re.match(name)
        if m is None or m.group(2) != key or int(m.group(1)) in skip:
            continue
        w = spill_writer(store, segment_format, replication)
        try:
            w.build(name)
        finally:
            w.close()


def run_premerge_job(spec: TaskSpec, store: Store, run_files: List[str],
                     spill_file: str,
                     segment_format: str = "v1",
                     replication=1, fence=None) -> JobTimes:
    """Eagerly consolidate committed sorted runs into one spill run —
    the pipelined-shuffle work unit (engine/premerge.py).

    Pure reorganization: equal-key value lists are concatenated in the
    given (canonical) file order and never folded — no combiner, no
    reducefn — so the final reduce sees the same inputs whether or not
    its runs were pre-merged. Consumed inputs are deleted only after the
    spill publishes atomically; an existing spill (a duplicate execution
    after a stale requeue) short-circuits to a sweep of any leftover
    inputs. Under ``replication`` the input reads fail over across
    copies, the spill publish fans out and the sweep removes every copy.
    ``fence`` (see :func:`run_reduce_job`) is checked before the merge
    and again before each sweep.
    """
    check_format(segment_format)
    store = reading_view(store, replication)
    times = JobTimes(started=time.time())
    cpu0 = time.process_time()
    if store.exists(spill_file):
        if fence is None or fence():
            for name in run_files:
                store.remove(name)
        times.cpu = time.process_time() - cpu0
        times.finished = times.written = time.time()
        return times
    missing = [f for f in run_files if not store.exists(f)]
    if missing:
        raise RuntimeError(
            f"pre_merge {spill_file}: {len(missing)} input run(s) missing "
            f"with no spill published: {missing[:3]}")
    if fence is not None and not fence():
        times.finished = times.written = time.time()
        times.cpu = time.process_time() - cpu0
        return times
    # the native one-pass merge publishes a v1 TEXT spill whatever the
    # negotiated format (readers sniff per file); under redundancy the
    # view hides local_path and the Python path's publish fans out
    if not native_premerge(store, run_files, spill_file):
        writer = spill_writer(store, segment_format, replication)
        try:
            merged = native_merge_records(store, run_files)
            if merged is None:
                merged = merge_iterator(store, run_files)
            for key, values in merged:
                writer.add(key, values)
            writer.build(spill_file)
        finally:
            writer.close()
    times.finished = time.time()
    if fence is None or fence():
        for name in run_files:
            store.remove(name)
    times.cpu = time.process_time() - cpu0
    times.written = time.time()
    return times


def run_reduce_job(spec: TaskSpec, store: Store, result_store: Store,
                   part_key: str, run_files: List[str],
                   result_file: str, replication=1,
                   reduce_fold=None, fence=None) -> JobTimes:
    """Execute one reduce job: k-way merge a partition's runs, fold with
    reducefn, publish the partition result (job.lua:230-296).

    Flagged (assoc ∧ commut ∧ idempotent) reducers skip reducefn on
    singleton groups (264-275); results land in the *result* store
    (249-251, 287); consumed run files are deleted after success (293).
    Under ``replication`` every input read fails over across copies and
    the sweep removes every copy; the result file is never replicated.

    ``reduce_fold`` is the hybrid plane's compiled-reduce hook
    (engine/hybrid.py): a callable ``(key, values) -> plain-or-None``
    tried where the interpreted reducefn would run. ``None`` means "this
    group is outside what the fold compiled for" and falls through to
    the interpreted reducefn, group by group — so a retired or partial
    fold can change speed, never results. The singleton fast path stays
    ahead of it.

    ``fence`` is given where a duplicate of this job may run at once
    (speculation): a callable that is True while this execution still
    holds the job's lease. It is called before the result publishes and
    again before the consumed runs are swept; once it is False neither
    happens. The runs of the next loop iteration reuse these names, so a
    duplicate that lost its race and swept late would delete them.
    """
    store = reading_view(store, replication)
    times = JobTimes(started=time.time())
    cpu0 = time.process_time()
    fast = spec.fast_path
    reducefn = spec.reducefn
    # fully native reduce: a reducer declared ``native_reduce = "sum"``
    # and flagged associative + commutative folds inside the C++ merge
    # pass (idempotency is not needed: every value is summed once)
    if (spec.associative and spec.commutative
            and getattr(reducefn, "native_reduce", None) == "sum"
            and native_merge_reduce_sum(store, run_files, result_store,
                                        result_file)):
        times.finished = times.written = time.time()
        times.cpu = time.process_time() - cpu0
        if fence is None or fence():
            for name in run_files:
                store.remove(name)
        return times
    builder = result_store.builder()
    try:
        merged = native_merge_records(store, run_files)
        if merged is None:
            merged = merge_iterator(store, run_files)
        for key, values in merged:
            if fast and len(values) == 1:
                reduced = values[0]
            else:
                reduced = None
                if reduce_fold is not None:
                    reduced = reduce_fold(key, values)
                if reduced is None:
                    reduced = to_plain(reducefn(key, values))
            assert_serializable(reduced, f"reduce value for key {key!r}")
            builder.write(dump_record(key, [reduced]) + "\n")
        times.finished = time.time()
        held = fence is None or fence()
        if held:
            builder.build(result_file)
    finally:
        builder.close()
    times.cpu = time.process_time() - cpu0
    times.written = time.time()

    if held and (fence is None or fence()):
        for name in run_files:
            store.remove(name)
    return times
