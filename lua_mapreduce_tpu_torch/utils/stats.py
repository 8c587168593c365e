"""Per-phase / per-iteration statistics.

Copy of the JAX package's ``utils/stats.py`` (the torch package imports
nothing of the JAX package).

Analog of the reference's tracing subsystem (SURVEY.md §5): per-job
lifecycle timestamps (creation/started/finished/written, cpu_time,
real_time — job.lua:117-152, task.lua:294-299) aggregated into per-phase
sums and cluster wall time = max(written) − min(started)
(server.lua:155-183). The reference computes the aggregation with MongoDB
server-side JavaScript mapreduce; here it is a plain fold over JobTimes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from lua_mapreduce_tpu_torch.engine.job import JobTimes


@dataclasses.dataclass
class PhaseStats:
    """One phase's aggregate (reference stats schema task.lua:44-56)."""
    count: int = 0
    failed: int = 0
    sum_cpu_time: float = 0.0
    sum_real_time: float = 0.0
    cluster_time: float = 0.0   # max(written) - min(started)

    def fold(self, times: List[JobTimes], failed: int = 0) -> "PhaseStats":
        self.count = len(times)
        self.failed = failed
        if times:
            self.sum_cpu_time = sum(t.cpu for t in times)
            self.sum_real_time = sum(t.real for t in times)
            self.cluster_time = (max(t.written for t in times) -
                                 min(t.started for t in times))
        return self

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def overlap_fraction(map_times: List[JobTimes],
                     premerge_times: List[JobTimes]) -> float:
    """Fraction of pre-merge wall time hidden behind the map phase.

    The pipelined shuffle's effectiveness metric: per pre-merge job, the
    part of its started→written window that falls before the last map
    job's written time is overlapped (free); the rest extended the
    iteration. 1.0 = every pre-merge second was hidden under still-running
    mappers; 0.0 = no overlap (or no pre-merge ran).
    """
    if not map_times or not premerge_times:
        return 0.0
    map_end = max(t.written for t in map_times)
    total = sum(t.real for t in premerge_times)
    if total <= 0.0:
        return 0.0
    hidden = sum(max(0.0, min(t.written, map_end) - t.started)
                 for t in premerge_times)
    return min(1.0, hidden / total)


# the counter-key → IterationStats-field fold, shared by BOTH executors
# (fold_fault_counters below). Grown by PRs 5-7; store_faults is the one
# composite: un-absorbed transient bursts PLUS injected FaultPlan events.
COUNTER_FOLD = {
    "store_retries": ("retries",),
    "store_faults": ("retry_exhausted", "faults_injected"),
    "infra_releases": ("infra_releases",),
    "degraded_reads": ("degraded_reads",),
    "failover_reads": ("failover_reads",),
    "replica_repairs": ("replica_repairs",),
    "map_reruns_avoided": ("map_reruns_avoided",),
    "map_reruns": ("map_reruns",),
    "decode_reads": ("decode_reads",),
    "stripe_repairs": ("stripe_repairs",),
    "spec_launched": ("spec_launched",),
    "spec_wins": ("spec_wins",),
    "spec_cancelled": ("spec_cancelled",),
    "spec_wasted_s": ("spec_wasted_s",),
    "push_frames": ("push_frames",),
    "push_evictions": ("push_evictions",),
    "ingraph_iterations": ("ingraph_iterations",),
    "ingraph_fallbacks": ("ingraph_fallbacks",),
    "hybrid_map_legs": ("hybrid_map_legs",),
    "hybrid_reduce_legs": ("hybrid_reduce_legs",),
    "hybrid_fallbacks": ("hybrid_fallbacks",),
    "autotune_decisions": ("autotune_decisions",),
    "autotune_vetoes": ("autotune_vetoes",),
    "autotune_scale_events": ("autotune_scale_events",),
    "leader_takeovers": ("leader_takeovers",),
    "fenced_writes": ("fenced_writes",),
    "standby_wakeups": ("standby_wakeups",),
}
_FLOAT_COUNTERS = frozenset({"spec_wasted_s"})


@dataclasses.dataclass
class IterationStats:
    """Stats for one map→reduce iteration (server.lua:536-601), plus the
    pipelined-shuffle pre-merge phase when it ran."""
    iteration: int
    map: PhaseStats = dataclasses.field(default_factory=PhaseStats)
    reduce: PhaseStats = dataclasses.field(default_factory=PhaseStats)
    premerge: PhaseStats = dataclasses.field(default_factory=PhaseStats)
    wall_time: float = 0.0
    overlap_fraction: float = 0.0   # see overlap_fraction() above
    # control-plane round trips observed through the server's job-store
    # instance this iteration (JobStore.round_counts deltas). In-process
    # pools share that instance, so these count the whole pool's claim
    # and commit traffic — the batch-lease protocol's effectiveness
    # metric (claim_rounds << job count when batch_k amortizes); in
    # multi-process pools each worker process counts its own and the
    # coord bench aggregates them explicitly.
    claim_rounds: int = 0
    commit_rounds: int = 0
    # fault-plane accounting (DESIGN §19), folded from the process-global
    # FaultCounters deltas exactly like the round counters above:
    #   store_retries  — transient store/coord faults absorbed by a
    #                    backoff-retry (the op eventually succeeded)
    #   store_faults   — faults that were NOT absorbed silently: retry
    #                    budgets exhausted + injected FaultPlan events
    #   infra_releases — jobs released back to WAITING on transient
    #                    infra faults (no repetition charged)
    #   degraded_reads — ranged segment reads that fell back to a
    #                    whole-file read (the degradation ladder's
    #                    read-side rung)
    # replica-aware shuffle accounting (DESIGN §20), same fold:
    #   failover_reads     — shuffle files served from a non-primary
    #                        replica after the primary failed
    #   replica_repairs    — replica copies rebuilt from a survivor by
    #                        the scavenger (under-replication healed
    #                        without re-running the producer)
    #   map_reruns_avoided — map re-executions the replication layer
    #                        made unnecessary (one per failed-over or
    #                        repaired file); the chaos gate asserts the
    #                        companion map_reruns stays ZERO while this
    #                        climbs
    #   map_reruns         — last-resort producer requeues (every
    #                        replica of a file gone)
    # erasure-coded shuffle accounting (DESIGN §27), same fold:
    #   decode_reads       — stripes reassembled from parity survivors
    #                        after a block loss/corruption (one per
    #                        logical file — the inline recovery twin of
    #                        failover_reads)
    #   stripe_repairs     — stripes the scavenger rebuilt to full k+m
    #                        blocks from ≥k survivors (the coded twin
    #                        of replica_repairs)
    # speculative-execution accounting (DESIGN §21), same fold:
    #   spec_launched  — duplicate leases the straggler detector opened
    #   spec_wins      — commit races a CLONE won (the original's
    #                    commit degraded to a zero-repetition no-op)
    #   spec_cancelled — clones that lost, failed, or observed their
    #                    revocation (job state untouched either way)
    #   spec_wasted_s  — seconds EITHER duplicate (clone or disowned
    #                    original) spent on work that lost its commit
    #                    race (the duplicate-execution trade's cost
    #                    side; the bench's wasted-work fraction)
    # push-shuffle accounting (DESIGN §24), same fold:
    #   push_frames    — inbox frame files published by pushing maps
    #   push_evictions — partition buffers evicted to the staged tail
    #                    path under memory-budget pressure (the
    #                    degrade-to-staged rung; >0 proves a budgeted
    #                    run survived via eviction, not OOM)
    # in-graph engine accounting (DESIGN §26), same fold:
    #   ingraph_iterations — iterations whose whole data plane ran as
    #                        the compiled shard_map/jit program
    #                        (engine/ingraph.py) instead of store jobs
    #   ingraph_fallbacks  — runtime degrades to the store plane (the
    #                        oracle accepted the task but lowering
    #                        raised at trace time — logged, traced as
    #                        an ``ingraph.fallback`` span, never a
    #                        crash under engine=auto)
    # hybrid engine accounting (DESIGN §28), same fold:
    #   hybrid_map_legs    — map-job batches executed as one compiled
    #                        map+combine program whose partitions were
    #                        published through the ordinary spill path
    #                        (engine/hybrid.py)
    #   hybrid_reduce_legs — reduce jobs whose per-group fold ran as
    #                        the jitted compiled reducefn instead of
    #                        the interpreted per-record call
    #   hybrid_fallbacks   — compiled legs that degraded back to the
    #                        interpreted store plane at trace/run time
    #                        (logged, traced as ``hybrid.fallback``
    #                        spans, never a crash)
    # autotune controller accounting (DESIGN §29), same fold:
    #   autotune_decisions    — knob changes the feedback controller
    #                           applied (each one also an
    #                           ``autotune.<knob>`` evidence span)
    #   autotune_vetoes       — changes the evidence warranted but the
    #                           stability gates (per-knob cooldown /
    #                           flip lockout) suppressed
    #   autotune_scale_events — the elastic subset of decisions: fleet
    #                           grow/retire targets issued
    # HA leader-lease accounting (DESIGN §31), same fold:
    #   leader_takeovers — lease acquisitions that BUMPED the epoch past
    #                      a dead/expired leader's (a mid-run takeover;
    #                      the first election of a run is epoch 1 and
    #                      not counted)
    #   fenced_writes    — server-side mutations REJECTED by the fencing
    #                      check (a zombie leader's write attempts; each
    #                      one is also an errors-stream entry carrying
    #                      the epoch evidence)
    #   standby_wakeups  — standby election probes (leader-topic wakeup
    #                      or TTL-bounded timeout) that found the lease
    #                      still held. LocalExecutor folds all three as
    #                      zeros by construction: no lease exists
    #                      in-process.
    store_retries: int = 0
    store_faults: int = 0
    infra_releases: int = 0
    degraded_reads: int = 0
    failover_reads: int = 0
    replica_repairs: int = 0
    map_reruns_avoided: int = 0
    map_reruns: int = 0
    decode_reads: int = 0
    stripe_repairs: int = 0
    spec_launched: int = 0
    spec_wins: int = 0
    spec_cancelled: int = 0
    spec_wasted_s: float = 0.0
    push_frames: int = 0
    push_evictions: int = 0
    ingraph_iterations: int = 0
    ingraph_fallbacks: int = 0
    hybrid_map_legs: int = 0
    hybrid_reduce_legs: int = 0
    hybrid_fallbacks: int = 0
    autotune_decisions: int = 0
    autotune_vetoes: int = 0
    autotune_scale_events: int = 0
    leader_takeovers: int = 0
    fenced_writes: int = 0
    standby_wakeups: int = 0

    def fold_fault_counters(self, delta: Dict[str, float]
                            ) -> "IterationStats":
        """Fold a FaultCounters delta (COUNTERS.delta of per-iteration
        snapshots) into the counter fields — the ONE place the
        counter-key → stats-field mapping lives. Server.loop and
        LocalExecutor.run_one_iteration both route through here, so the
        two executors cannot drift apart in which counters they surface
        (they did, briefly: the local executor silently never folded
        infra_releases; the drift test in tests/test_trace.py pins the
        key sets identical)."""
        for field, keys in COUNTER_FOLD.items():
            val = sum(delta.get(k, 0) for k in keys)
            setattr(self, field,
                    float(val) if field in _FLOAT_COUNTERS else int(val))
        return self

    @property
    def cluster_time(self) -> float:
        """map+reduce cluster time — the reference's headline metric
        (README.md:68-70). Pre-merge time is deliberately NOT added:
        overlapped work is already inside the map window, and counting
        the spill-over would double-charge what wall_time captures."""
        return self.map.cluster_time + self.reduce.cluster_time

    def as_dict(self) -> dict:
        return {
            "iteration": self.iteration,
            "map": self.map.as_dict(),
            "reduce": self.reduce.as_dict(),
            "premerge": self.premerge.as_dict(),
            "overlap_fraction": self.overlap_fraction,
            "claim_rounds": self.claim_rounds,
            "commit_rounds": self.commit_rounds,
            "store_retries": self.store_retries,
            "store_faults": self.store_faults,
            "infra_releases": self.infra_releases,
            "degraded_reads": self.degraded_reads,
            "failover_reads": self.failover_reads,
            "replica_repairs": self.replica_repairs,
            "map_reruns_avoided": self.map_reruns_avoided,
            "map_reruns": self.map_reruns,
            "decode_reads": self.decode_reads,
            "stripe_repairs": self.stripe_repairs,
            "spec_launched": self.spec_launched,
            "spec_wins": self.spec_wins,
            "spec_cancelled": self.spec_cancelled,
            "spec_wasted_s": self.spec_wasted_s,
            "push_frames": self.push_frames,
            "push_evictions": self.push_evictions,
            "ingraph_iterations": self.ingraph_iterations,
            "ingraph_fallbacks": self.ingraph_fallbacks,
            "hybrid_map_legs": self.hybrid_map_legs,
            "hybrid_reduce_legs": self.hybrid_reduce_legs,
            "hybrid_fallbacks": self.hybrid_fallbacks,
            "autotune_decisions": self.autotune_decisions,
            "autotune_vetoes": self.autotune_vetoes,
            "autotune_scale_events": self.autotune_scale_events,
            "leader_takeovers": self.leader_takeovers,
            "fenced_writes": self.fenced_writes,
            "standby_wakeups": self.standby_wakeups,
            "cluster_time": self.cluster_time,
            "wall_time": self.wall_time,
        }


@dataclasses.dataclass
class TaskStats:
    """Whole-task stats across iterations."""
    iterations: List[IterationStats] = dataclasses.field(default_factory=list)
    wall_time: float = 0.0

    @property
    def last(self) -> Optional[IterationStats]:
        return self.iterations[-1] if self.iterations else None

    def as_dict(self) -> dict:
        return {
            "iterations": [s.as_dict() for s in self.iterations],
            "wall_time": self.wall_time,
        }


def utest() -> None:
    """Self-test (reference server.lua:629-655 utest role: the stats
    aggregation — per-phase sums + cluster time = max(written) −
    min(started), server.lua:155-183)."""
    times = [JobTimes(started=1.0, finished=2.0, written=3.0, cpu=0.5),
             JobTimes(started=2.0, finished=4.0, written=6.0, cpu=1.5)]
    ph = PhaseStats().fold(times, failed=1)
    assert ph.count == 2 and ph.failed == 1
    assert abs(ph.sum_cpu_time - 2.0) < 1e-9
    assert abs(ph.sum_real_time - (2.0 + 4.0)) < 1e-9
    assert abs(ph.cluster_time - (6.0 - 1.0)) < 1e-9
    red = PhaseStats().fold(
        [JobTimes(started=6.0, finished=7.0, written=8.0, cpu=1.0)])
    it = IterationStats(iteration=1, map=ph, reduce=red)
    assert abs(it.cluster_time - (5.0 + 2.0)) < 1e-9
    d = TaskStats(iterations=[it]).as_dict()
    assert d["iterations"][0]["map"]["count"] == 2
    assert d["iterations"][0]["premerge"]["count"] == 0
    assert d["iterations"][0]["claim_rounds"] == 0
    assert d["iterations"][0]["commit_rounds"] == 0
    # overlap: map ends at 6.0; one pre-merge fully inside (2→4), one
    # half outside (5→7): hidden = 2 + 1 of real = 2 + 2 → 3/4
    pre = [JobTimes(started=2.0, finished=3.0, written=4.0, cpu=0.1),
           JobTimes(started=5.0, finished=6.0, written=7.0, cpu=0.1)]
    assert abs(overlap_fraction(times, pre) - 0.75) < 1e-9
    assert overlap_fraction([], pre) == 0.0
    assert overlap_fraction(times, []) == 0.0
    # the shared counter fold: composite store_faults, float passthrough,
    # zeroed absent keys, and every folded field present in as_dict
    it2 = IterationStats(iteration=2).fold_fault_counters(
        {"retries": 3, "faults_injected": 1, "retry_exhausted": 2,
         "spec_wasted_s": 1.5})
    assert it2.store_retries == 3 and it2.store_faults == 3
    assert it2.spec_wasted_s == 1.5 and it2.infra_releases == 0
    assert set(COUNTER_FOLD) <= set(it2.as_dict())
