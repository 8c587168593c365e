"""Collective primitives over a mesh axis — the shuffle's transport.

Port of ``lua_mapreduce_tpu/parallel/collectives.py``. The JAX ops run
inside ``shard_map`` and name the axis of the enclosing mesh; here each
rank is a process, so every function takes the mesh and the axis name
and runs the collective over that axis's process group
(``mesh.group(axis)``). Each maps to one ``torch.distributed`` call per
leaf, NCCL on the card and gloo on the CPU:

==========================  ======================================
JAX op                      torch call
==========================  ======================================
``psum``                    ``all_reduce(SUM)``
``pmean``                   ``all_reduce(SUM)``, then ÷ n (gloo has
                            no ``AVG``)
``pmax`` / ``pmin``         ``all_reduce(MAX / MIN)``
``psum_scatter(tiled)``     ``reduce_scatter_tensor``
``all_to_all(tiled=False)`` ``all_to_all_single`` over the leading
                            bucket axis
``all_gather(tiled)``       ``all_gather_into_tensor``
``ppermute``                ``batch_isend_irecv``
==========================  ======================================

Trees are dicts, lists or tuples of tensors (torch's pytrees). Every
function returns new tensors and leaves its inputs as they were. The
mapping to the reference is the JAX module's: psum is the reducefn with
the assoc+commut flags, reduce-scatter one reduce job per partition
(server.lua:300-325), all_to_all the partitionfn shuffle, all_gather
the result collection, ppermute the ring's neighbour exchange.
"""

from __future__ import annotations

import warnings
from typing import Any

import torch
import torch.distributed as dist

from torch.utils._pytree import tree_map


def _all_reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, op=op, group=mesh.group(axis))
    return y


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return psum(x, mesh, axis) / mesh.shape[axis]


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MIN)


def psum_tree(tree: Any, mesh, axis: str) -> Any:
    """Sum every leaf across ``axis`` (the full all-reduce)."""
    return tree_map(lambda x: psum(x, mesh, axis), tree)


def pmean_tree(tree: Any, mesh, axis: str) -> Any:
    return tree_map(lambda x: pmean(x, mesh, axis), tree)


def _quiet(call, *args, **kwargs):
    """Run a collective whose name newer torch marks deprecated (the
    replacements are missing from older torch): the warning says
    nothing about this program."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return call(*args, **kwargs)


def psum_scatter(x: torch.Tensor, mesh, axis: str, scatter_dimension: int = 0,
                 tiled: bool = True) -> torch.Tensor:
    """``lax.psum_scatter``: the sum across ``axis``, of which rank i
    keeps slice i along ``scatter_dimension`` (tiled: a block of
    size/n; untiled: that dimension must be n and is dropped)."""
    n = mesh.shape[axis]
    if x.shape[scatter_dimension] % n or (
            not tiled and x.shape[scatter_dimension] != n):
        raise ValueError(f"dimension {scatter_dimension} of {tuple(x.shape)} "
                         f"does not scatter over {axis}={n}")
    src = x.movedim(scatter_dimension, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    _quiet(dist.reduce_scatter_tensor, out, src, group=mesh.group(axis))
    if not tiled:
        return out[0]
    return out.movedim(0, scatter_dimension)


def reduce_scatter_tree(tree: Any, mesh, axis: str,
                        scatter_dimension: int = 0, tiled: bool = True
                        ) -> Any:
    """Sum across ``axis`` but scatter the result: rank i keeps slice i
    along ``scatter_dimension``. Half the wire bytes of psum when each
    reducer needs only its own partition."""
    return tree_map(lambda x: psum_scatter(x, mesh, axis, scatter_dimension,
                                           tiled), tree)


def all_to_all_buckets(x: torch.Tensor, mesh, axis: str,
                       bucket_dim: int = 0) -> torch.Tensor:
    """The shuffle: ``x`` has ``mesh.shape[axis]`` buckets along
    ``bucket_dim`` (one per partition, from the caller's partitionfn);
    afterwards rank p holds every rank's bucket p, in rank order along
    ``bucket_dim`` — the map-output-files → reduce-job-input relabeling
    of server_prepare_reduce (server.lua:291-312)."""
    n = mesh.shape[axis]
    if x.shape[bucket_dim] != n:
        raise ValueError(f"all_to_all needs {n} buckets along dimension "
                         f"{bucket_dim}, got {tuple(x.shape)}")
    src = x.movedim(bucket_dim, 0).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axis))
    return out.movedim(0, bucket_dim)


def all_gather(x: torch.Tensor, mesh, axis: str,
               gather_dimension: int = 0) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: every rank's ``x`` concatenated
    along ``gather_dimension`` in rank order."""
    n = mesh.shape[axis]
    src = x.movedim(gather_dimension, 0).contiguous()
    out = src.new_empty((src.shape[0] * n,) + src.shape[1:])
    _quiet(dist.all_gather_into_tensor, out, src, group=mesh.group(axis))
    return out.movedim(0, gather_dimension)


def all_gather_tree(tree: Any, mesh, axis: str, gather_dimension: int = 0
                    ) -> Any:
    return tree_map(lambda x: all_gather(x, mesh, axis, gather_dimension),
                    tree)


def ppermute_ring(x: torch.Tensor, mesh, axis: str, shift: int = 1
                  ) -> torch.Tensor:
    """Rotate shards around the ring: rank i's ``x`` goes to rank
    (i + shift) % n, and rank i receives rank (i - shift) % n's. The
    building block of ring schedules (ring attention, ring all-reduce)."""
    n = mesh.shape[axis]
    if shift % n == 0:
        return x.clone()
    group = mesh.group(axis)
    ranks = dist.get_process_group_ranks(group)
    me = mesh.axis_index(axis)
    send = x.contiguous()
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, ranks[(me + shift) % n], group),
        dist.P2POp(dist.irecv, recv, ranks[(me - shift) % n], group)])
    for r in reqs:
        r.wait()
    return recv
