"""Per-phase / per-iteration statistics.

Copy of the JAX package's ``utils/stats.py`` (reference job.lua:117-152,
server.lua:155-183), trimmed to the fields the barrier LocalExecutor
fills: per-phase sums, cluster time = max(written) − min(started), and
the compiled engines' counters (``COUNTER_FOLD``'s engine entries).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from lua_mapreduce_tpu_torch.engine.job import JobTimes


@dataclasses.dataclass
class PhaseStats:
    """One phase's aggregate (reference stats schema task.lua:44-56)."""
    count: int = 0
    sum_cpu_time: float = 0.0
    sum_real_time: float = 0.0
    cluster_time: float = 0.0   # max(written) - min(started)

    def fold(self, times: List[JobTimes]) -> "PhaseStats":
        self.count = len(times)
        if times:
            self.sum_cpu_time = sum(t.cpu for t in times)
            self.sum_real_time = sum(t.real for t in times)
            self.cluster_time = (max(t.written for t in times) -
                                 min(t.started for t in times))
        return self


# the counter-key → IterationStats-field fold (fold_fault_counters
# below), trimmed to the compiled engines' counters:
#   ingraph_iterations — iterations whose whole data plane ran as one
#                        compiled program (engine/ingraph.py)
#   ingraph_fallbacks  — runtime degrades to the store plane under
#                        engine="auto" (logged, never a crash)
#   hybrid_map_legs    — map-job batches run as one compiled program
#                        (engine/hybrid.py)
#   hybrid_reduce_legs — reduce jobs whose per-group fold ran compiled
#   hybrid_fallbacks   — compiled legs that degraded back to the
#                        interpreted plane (logged)
COUNTER_FOLD = {
    "ingraph_iterations": ("ingraph_iterations",),
    "ingraph_fallbacks": ("ingraph_fallbacks",),
    "hybrid_map_legs": ("hybrid_map_legs",),
    "hybrid_reduce_legs": ("hybrid_reduce_legs",),
    "hybrid_fallbacks": ("hybrid_fallbacks",),
}


@dataclasses.dataclass
class IterationStats:
    """Stats for one map→reduce iteration (server.lua:536-601)."""
    iteration: int
    map: PhaseStats = dataclasses.field(default_factory=PhaseStats)
    reduce: PhaseStats = dataclasses.field(default_factory=PhaseStats)
    wall_time: float = 0.0
    ingraph_iterations: int = 0
    ingraph_fallbacks: int = 0
    hybrid_map_legs: int = 0
    hybrid_reduce_legs: int = 0
    hybrid_fallbacks: int = 0

    def fold_fault_counters(self, delta: Dict[str, int]
                            ) -> "IterationStats":
        """Fold a FaultCounters delta (``faults/retry.COUNTERS.delta`` of
        per-iteration snapshots) into the counter fields — the one place
        the counter-key → stats-field mapping lives."""
        for field, keys in COUNTER_FOLD.items():
            setattr(self, field, int(sum(delta.get(k, 0) for k in keys)))
        return self

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["cluster_time"] = self.cluster_time
        return d

    @property
    def cluster_time(self) -> float:
        """map+reduce cluster time (reference README.md:68-70)."""
        return self.map.cluster_time + self.reduce.cluster_time


@dataclasses.dataclass
class TaskStats:
    """Whole-task stats across iterations."""
    iterations: List[IterationStats] = dataclasses.field(default_factory=list)
    wall_time: float = 0.0
