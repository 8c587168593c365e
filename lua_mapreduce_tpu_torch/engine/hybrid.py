"""Stage-granular lowering: the hybrid rung between ``ingraph`` and
``store``.

Port of the JAX package's ``engine/hybrid.py``. The static oracle
(``analysis/contracts.py``) verdicts per *function*, so a task whose
whole data plane cannot lower may still have legs that can:

- **compiled map+combine** (:class:`HybridMapEngine`): the iteration's
  map jobs run as ONE program — built once, captured once on a card and
  replayed (the two tiers of ``engine/ingraph.py``: a collective tier
  dealing uniform numeric-keyed jobs over the mesh's ``dp`` axis, and an
  unrolled tier for concrete/heterogeneous job keys). The fetched
  per-job groupings then flow through the SAME publish tail as the
  interpreted plane (``engine/job.py`` ``publish_map_groups``).
  partitionfn is NOT required to lower: it routes host-side on the
  concrete emitted keys inside that shared tail.
- **compiled reduce** (:class:`HybridReduceFold`): the host-side k-way
  merge stays (``run_reduce_job``), but each multi-value group is
  folded by one device sum instead of the interpreted reducefn — gated
  by the SAME two structural proofs as the in-graph psum tier
  (``_sum_fold`` ∧ ``_singleton_passthrough``), so only reducers
  provably equal to an elementwise sum fold there; everything else
  falls through to the interpreted fold, group by group.

Fallback policy: the hybrid rung NEVER crashes, even when forced
(``engine="hybrid"``). An oracle-rejected leg stays interpreted from the
start; a build-time failure retires that leg for the rest of the task
and its jobs run interpreted. Every degrade leaves evidence — a log
line and a ``hybrid_fallbacks`` count; successes count as
``hybrid_map_legs`` / ``hybrid_reduce_legs``.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from lua_mapreduce_tpu_torch.core.serialize import to_plain
from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.ingraph import (
    COMPILE_LOCK, EngineDecision, LoweringUnsupported, _Compiled,
    _flatten_out, _gather_coalesced, _group_signature, _rebuild, _run_map,
    _singleton_passthrough, _stack_slots, _sum_fold, _unflatten_out,
    _value_leaves, record_hybrid_fallback)
from lua_mapreduce_tpu_torch.trace.span import active_tracer


# --------------------------------------------------------------------------
# compiled map+combine leg
# --------------------------------------------------------------------------

class _MapPlan:
    """The jit tier's output plan: per job, per emitted key (emit
    order), per value — the flat-output slice and value structure fixed
    by the build run."""

    def __init__(self):
        # per job: [(emit_key, [(treedef, start, count), ...]), ...]
        self.jobs: List[list] = []

    def finish(self, per_job: List["collections.OrderedDict"]) -> tuple:
        # reset first: the body runs more than once
        self.jobs = []
        flat: List = []
        for groups in per_job:
            entries = []
            for k, vs in groups.items():
                vals = []
                for v in vs:
                    leaves, td = _flatten_out(v)
                    vals.append((td, len(flat), len(leaves)))
                    flat.extend(leaves)
                entries.append((k, vals))
            self.jobs.append(entries)
        return tuple(flat)

    def unflatten(self, outputs: list, n_jobs: int) -> List[dict]:
        res = []
        for entries in self.jobs[:n_jobs]:
            groups: Dict[Any, list] = {}
            for k, vals in entries:
                groups[k] = [
                    to_plain(_unflatten_out(td, list(outputs[s:s + c])))
                    for td, s, c in vals]
            res.append(groups)
        return res


class _StackedMapPlan:
    """The collective tier's plan: every job emits the same keys the
    same number of times (checked at build), and each output leaf
    carries a leading job axis — job j's value is row j."""

    def __init__(self):
        # [(emit_key, [(treedef, start, count), ...])] — shared by jobs
        self.entries: List[tuple] = []

    def unflatten(self, outputs: list, n_jobs: int) -> List[dict]:
        res = []
        for j in range(n_jobs):
            groups: Dict[Any, list] = {}
            for k, vals in self.entries:
                groups[k] = [
                    to_plain(_unflatten_out(
                        td, [outputs[s + i][j] for i in range(c)]))
                    for td, s, c in vals]
            res.append(groups)
        return res


class HybridMapEngine(_Compiled):
    """Build-once batched map+combine for one TaskSpec.

    :meth:`run_batch` takes the iteration's ``(map_key, map_value)``
    pairs and returns each job's ``{emitted_key: [plain values]}``
    grouping — exactly what make_map_emit accumulates on the interpreted
    plane, with the same combiner rule (folded in the program for groups
    longer than one). The caller feeds each grouping to
    ``engine/job.py:publish_map_groups``, so validation and partition
    routing are shared code, not a parallel implementation.

    Tiers mirror ``engine/ingraph.py``: **shard_map** deals uniform
    numeric-keyed jobs over the ``dp`` axis (padded with job-0 replays
    whose rows the host discards; with more than one rank the rows are
    all-gathered so every rank publishes every job); **jit** unrolls
    concrete job keys. ``traces`` counts builds.
    """

    what = "hybrid map"

    def run_batch(self, pairs: List[Tuple[Any, Any]]) -> List[dict]:
        """Map+combine every ``(map_key, map_value)`` pair through one
        program; returns per-job plain groupings in input order. Raises
        (the caller degrades) when the batch is outside the compilable
        surface."""
        keys = [k for k, _ in pairs]
        prepped = [_value_leaves(v, f"jobs[{i}].value")
                   for i, (_, v) in enumerate(pairs)]
        outputs = self._execute(keys, prepped)
        return self._plan.unflatten(outputs, len(keys))

    def _body_shard_map(self, keys, prepped):
        spec, axis, dev = self.spec, self.axis, self.device
        n, rank = self._ranks()
        mesh = self._mesh
        J = len(keys)
        L = -(-J // n)
        lo = rank * L
        struct = prepped[0][1]
        plan = _StackedMapPlan()

        def body(inputs):
            karr, leaves = inputs[0], inputs[1:]
            slot_groups = [
                _run_map(spec, karr[lo + i],
                         _rebuild(struct, [leaf[lo + i] for leaf in leaves]),
                         dev)
                for i in range(L)]
            sig0 = _group_signature(slot_groups[0])
            for g in slot_groups[1:]:
                if _group_signature(g) != sig0:
                    raise LoweringUnsupported(
                        "emission structure diverges across map jobs — "
                        "the batched tier needs every job to emit the "
                        "same keys the same number of times")
            plan.entries = []               # one run owns the plan
            flat: List = []
            for key, m in sig0:
                vals = []
                for vi in range(m):
                    stacked, td = _stack_slots([g[key][vi]
                                                for g in slot_groups])
                    vals.append((td, len(flat), len(stacked)))
                    flat.extend(stacked)
                plan.entries.append((key, vals))
            if not flat:
                raise LoweringUnsupported(
                    "map jobs emitted nothing on the batched tier")
            if n > 1:
                flat = _gather_coalesced(flat, mesh, axis)
            return tuple(flat)

        return body, plan

    def _body_jit(self, keys, prepped):
        spec, dev = self.spec, self.device
        plan = _MapPlan()
        structs = [st for _, st in prepped]
        counts = [len(leaves) for leaves, _ in prepped]

        def body(inputs):
            per_job = []
            pos = 0
            for j, key in enumerate(keys):
                leaves = list(inputs[pos:pos + counts[j]])
                pos += counts[j]
                per_job.append(
                    _run_map(spec, key, _rebuild(structs[j], leaves), dev))
            return plan.finish(per_job)

        return body, plan


# --------------------------------------------------------------------------
# compiled reduce leg
# --------------------------------------------------------------------------

class HybridReduceFold:
    """run_reduce_job's ``reduce_fold`` hook: fold multi-value groups
    with one device sum instead of the interpreted reducefn.

    Gated per (key, arity, value-structure) signature by the SAME two
    structural proofs as the in-graph psum tier — the fold must be
    provably the elementwise sum (``_sum_fold``) AND the singleton
    reducefn call provably the identity (``_singleton_passthrough``,
    which then restores the user's own output structure with one host
    call). Unproven or non-numeric groups return ``None`` and the
    interpreted reducefn runs — a partial fold can change speed, never
    bytes. Any error retires the fold for the rest of the task with
    counted evidence; so does a proof-cache blowup (pathologically many
    distinct signatures), because proving would cost more than folding
    saves. Integer groups sum in int64, as the interpreted fold over
    Python ints does.
    """

    MAX_PROBES = 64

    def __init__(self, spec: TaskSpec, device=None):
        self.spec = spec
        self._device_arg = device
        self._device: Optional[torch.device] = None
        self.retired = False
        self.retire_reason: Optional[str] = None
        self.folded_groups = 0
        self._used = False
        self._proofs: Dict[tuple, bool] = {}
        self._lock = threading.Lock()       # reduce jobs may run in threads

    def take_used(self) -> bool:
        """True once per window in which the fold actually folded —
        the executor's per-job ``hybrid_reduce_legs`` bump."""
        u = self._used
        self._used = False
        return u

    def __call__(self, key, values):
        if self.retired or len(values) < 2:
            return None
        try:
            return self._fold(key, values)
        except Exception as e:              # noqa: BLE001 — policy point
            self._retire(f"{type(e).__name__}: {e}")
            return None

    def _retire(self, reason: str) -> None:
        from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
        self.retired = True
        self.retire_reason = reason
        COUNTERS.bump("hybrid_fallbacks")
        print(f"[hybrid] compiled reduce retired: {reason}",
              file=sys.stderr)

    def _proven(self, key, prepped) -> bool:
        struct = prepped[0][1]
        token = key if isinstance(key, (int, float, str)) \
            and type(key) is not bool else repr(key)
        sig = (token, len(prepped), struct)
        with self._lock, COMPILE_LOCK:
            proven = self._proofs.get(sig)
            if proven is None:
                if len(self._proofs) >= self.MAX_PROBES:
                    self._retire(
                        f"more than {self.MAX_PROBES} distinct (key, arity, "
                        "structure) signatures — per-group proof probing "
                        "would cost more than the compiled fold saves")
                    return False
                template = _rebuild(struct, [torch.from_numpy(a)
                                             for a in prepped[0][0]])
                proven = (_sum_fold(self.spec, key, template, len(prepped))
                          and _singleton_passthrough(self.spec, key,
                                                     template))
                self._proofs[sig] = proven
        return proven

    def _fold(self, key, values):
        try:
            prepped = [_value_leaves(v, "reduce.value") for v in values]
        except LoweringUnsupported:
            return None                     # group not numeric — interpret
        if len({st for _, st in prepped}) != 1:
            return None
        if not self._proven(key, prepped):
            return None
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        sums = []
        with COMPILE_LOCK:
            for li in range(len(prepped[0][0])):
                rows = torch.from_numpy(np.stack([p[0][li]
                                                  for p in prepped]))
                wide = (torch.int64 if rows.dtype == torch.int32
                        else rows.dtype)
                sums.append(rows.to(self._device).sum(0, dtype=wide).cpu())
        rebuilt = _rebuild(prepped[0][1], sums)
        # the proven-identity singleton pass restores the user's own
        # output structure (dict insertion order, dtype converts) so
        # serialization matches the interpreted plane exactly
        reduced = to_plain(self.spec.reducefn(key, [rebuilt]))
        with self._lock:
            self.folded_groups += 1
            self._used = True
        return reduced


# --------------------------------------------------------------------------
# executor-side driver
# --------------------------------------------------------------------------

class HybridRunner:
    """LocalExecutor's hybrid driver: owns the per-leg engines, the
    counters, and the degrade policy — the shape of IngraphRunner."""

    def __init__(self, spec: TaskSpec, decision: EngineDecision,
                 mesh=None, device=None, log=None):
        self.spec = spec
        self.decision = decision
        stages = decision.stages or {}
        on = decision.chosen == "hybrid"
        self.map_engine = HybridMapEngine(spec, mesh=mesh, device=device) \
            if on and stages.get("map") else None
        self.fold = HybridReduceFold(spec, device=device) \
            if on and stages.get("reduce") else None
        self._log = log or (lambda msg: print(f"[hybrid] {msg}",
                                              file=sys.stderr))
        self._evidence_done = False
        if on:
            self._log(f"hybrid plane selected: {decision.reason}")

    @property
    def active(self) -> bool:
        return self.decision.chosen == "hybrid"

    def reduce_fold(self):
        """The run_reduce_job hook, or None once retired/absent."""
        if self.fold is not None and not self.fold.retired:
            return self.fold
        return None

    def ensure_evidence(self) -> None:
        """Forced ``engine=hybrid`` with ZERO qualifying legs runs pure
        store-plane — once per task, leave the counted and logged record
        that the request degraded."""
        if self._evidence_done:
            return
        self._evidence_done = True
        if self.active and self.map_engine is None and self.fold is None:
            from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
            reason = ("no stage qualifies for the hybrid plane: "
                      f"{self.decision.reason}")
            COUNTERS.bump("hybrid_fallbacks")
            record_hybrid_fallback("task", reason)
            self._log(reason)

    def run_map_leg(self, jobs, store, segment_format: str = "v1",
                    iteration: int = 0, replication=1, push=False,
                    push_pool=None, leftovers=()) -> bool:
        """Build/replay the whole iteration's map jobs as one program
        and publish every job through the shared tail. True = spills
        published (the caller skips the interpreted map); False =
        degraded (for the rest of the task — counted, logged and traced)
        and the caller runs the interpreted map phase. ``leftovers``:
        files the iteration-start sweep could not remove, which each
        job's publish writes over where they are its own."""
        from lua_mapreduce_tpu_torch.engine.job import publish_map_groups
        from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
        if self.map_engine is None or not jobs:
            return False
        tracer = active_tracer()
        t0 = time.time()
        try:
            per_job = self.map_engine.run_batch(jobs)
            for i, groups in enumerate(per_job):
                publish_map_groups(self.spec, store, str(i), groups,
                                   segment_format=segment_format,
                                   replication=replication, push=push,
                                   push_pool=push_pool, leftovers=leftovers)
        except Exception as exc:            # noqa: BLE001 — policy point
            reason = f"{type(exc).__name__}: {exc}"
            COUNTERS.bump("hybrid_fallbacks")
            record_hybrid_fallback("map", reason)
            self._log(f"iteration {iteration}: compiled map leg failed "
                      f"({reason}); map jobs run interpreted")
            self.map_engine = None
            return False
        COUNTERS.bump("hybrid_map_legs")
        if tracer is not None:
            # recorded after the leg, with its measured window: no span
            # is open while the leg captures or replays
            now = tracer.clock()
            tracer.add("hybrid.run", now - (time.time() - t0), now,
                       ns="hybrid", stage="map", job_id=iteration,
                       jobs=len(jobs), mode=self.map_engine.mode,
                       traces=self.map_engine.traces)
        return True

    def note_reduce_job(self) -> None:
        """Post-reduce-job counter hook: one ``hybrid_reduce_legs``
        bump per reduce job in which the fold actually folded."""
        if self.fold is not None and self.fold.take_used():
            from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
            COUNTERS.bump("hybrid_reduce_legs")


def utest() -> None:
    """Host-only self-test: plan round-trips and fold gating (the
    compiled tiers run under the cpu-pinned pytest conftest,
    tests/test_hybrid.py)."""
    plan = _MapPlan()
    out = plan.finish([collections.OrderedDict([("a", [1, 2]), ("b", [3])]),
                       collections.OrderedDict([("a", [4])])])
    assert out == (1, 2, 3, 4)
    jobs = plan.unflatten(out, 2)
    assert jobs == [{"a": [1, 2], "b": [3]}, {"a": [4]}]
    assert plan.unflatten(out, 1) == [{"a": [1, 2], "b": [3]}]
