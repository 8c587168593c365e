"""Parallel layer of the port: SPMD MapReduce over a mesh of ranks.

Port of ``lua_mapreduce_tpu/parallel/``, the layer that makes the
framework data-parallel. When the user's map/reduce functions are
tensor programs, the map → combine → shuffle → reduce cycle runs on
every rank of a ``torch.distributed`` world at once:

- the map phase is split over the mesh's ``dp`` axis (one shard per
  rank — the analog of one map job per worker, SURVEY.md §2.5);
- the combiner is per-rank pre-reduction before any communication (the
  in-map combiner, job.lua:92-96);
- keyed reduction is an all-reduce / reduce-scatter over the axis's
  process group (the reference's grad-sum reducefn, common.lua:112-137);
- the partitionfn shuffle is ``all_to_all`` (partition files + reduce
  jobs, SURVEY.md §2.6).

``mesh`` builds the mesh (NCCL on the card, gloo on the CPU) and
``spawn`` a world on one box; ``collectives`` holds the transport,
``zero1`` the sharded optimizer state, ``tpu_engine`` the executor.
``ring_attention`` is the single-device attention oracle and the ring
body on one shard (the multi-shard ring, zigzag and Ulysses are the
sequence-parallel slice, like the multihost helpers).
"""

from lua_mapreduce_tpu_torch.parallel.mesh import (host_mesh, make_mesh,
                                                   spawn)
from lua_mapreduce_tpu_torch.parallel.array_task import ArrayTaskSpec
from lua_mapreduce_tpu_torch.parallel.tpu_engine import (TpuExecutor,
                                                         differentiable_keyed)

__all__ = ["make_mesh", "host_mesh", "spawn", "ArrayTaskSpec",
           "TpuExecutor", "differentiable_keyed"]
