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
``ring_attention`` holds the sequence-parallel attention (the ring,
zigzag and Ulysses) and the single-device oracle; ``moe`` the
expert-parallel mixture-of-experts FFN; ``pipeline`` the GPipe
schedule over a ``pp`` axis; ``multihost`` the multi-host world
(``initialize_multihost``), meshes of any number of axes with the host
boundary on one (``make_multihost_mesh``) and the host-local batch
helpers.
"""

from lua_mapreduce_tpu_torch.parallel.mesh import (host_mesh, make_mesh,
                                                   spawn)
from lua_mapreduce_tpu_torch.parallel.array_task import ArrayTaskSpec
from lua_mapreduce_tpu_torch.parallel.tpu_engine import (TpuExecutor,
                                                         differentiable_keyed)
from lua_mapreduce_tpu_torch.parallel.multihost import (global_batch_array,
                                                        initialize_multihost,
                                                        make_multihost_mesh)

__all__ = ["make_mesh", "host_mesh", "spawn", "ArrayTaskSpec",
           "TpuExecutor", "differentiable_keyed", "initialize_multihost",
           "make_multihost_mesh", "global_batch_array"]
