"""Per-phase / per-iteration statistics.

Copy of the JAX package's ``utils/stats.py`` (reference job.lua:117-152,
server.lua:155-183), trimmed to the fields the barrier LocalExecutor
fills: per-phase sums and cluster time = max(written) − min(started).
"""

from __future__ import annotations

import dataclasses
from typing import List

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


@dataclasses.dataclass
class IterationStats:
    """Stats for one map→reduce iteration (server.lua:536-601)."""
    iteration: int
    map: PhaseStats = dataclasses.field(default_factory=PhaseStats)
    reduce: PhaseStats = dataclasses.field(default_factory=PhaseStats)
    wall_time: float = 0.0

    @property
    def cluster_time(self) -> float:
        """map+reduce cluster time (reference README.md:68-70)."""
        return self.map.cluster_time + self.reduce.cluster_time


@dataclasses.dataclass
class TaskStats:
    """Whole-task stats across iterations."""
    iterations: List[IterationStats] = dataclasses.field(default_factory=list)
    wall_time: float = 0.0
