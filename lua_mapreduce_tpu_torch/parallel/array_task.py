"""The array-task contract.

Port of ``lua_mapreduce_tpu/parallel/array_task.py``: the six roles of
engine/contract.TaskSpec restated for array programs with static
shapes, run over a mesh by :class:`~lua_mapreduce_tpu_torch.parallel.
tpu_engine.TpuExecutor`:

    taskfn   →  the input provider: a global batch (a tree of arrays)
                whose leading axis is split over the mesh's ``dp`` axis
                (one shard ≈ one map job)
    mapfn    →  shard → keyed tree of tensors (the tree's structure IS
                the key space, so it is static — the analog of the
                APRIL-ANN example's per-parameter gradient keys,
                common.lua:85-104)
    combinerfn → local fold over the shard before any communication
    partitionfn → for bucketed shuffles: shard → [P, ...] bucket tensor
                (P = num_partitions, the NUM_REDUCERS analog; bucketing
                is the user's, padding included)
    reducefn →  the associative op across ranks (``reduce_op``)
    finalfn  →  reduced tree → the caller's decision ("loop" protocol)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass
class ArrayTaskSpec:
    """A MapReduce program over tensors.

    ``reduce_op``: one of "sum", "mean", "max", "min" — associative ops
    with a native cross-rank collective.
    """

    mapfn: Callable[..., Any]
    reduce_op: str = "sum"
    combinerfn: Optional[Callable[[Any], Any]] = None
    partitionfn: Optional[Callable[[Any], Any]] = None
    num_partitions: Optional[int] = None
    finalfn: Optional[Callable[[Any], Any]] = None

    def __post_init__(self):
        if self.reduce_op not in ("sum", "mean", "max", "min"):
            raise ValueError(f"reduce_op {self.reduce_op!r} not associative-"
                             "collective; use sum|mean|max|min")
        if self.partitionfn is not None and not self.num_partitions:
            raise ValueError("bucketed shuffle needs num_partitions")
