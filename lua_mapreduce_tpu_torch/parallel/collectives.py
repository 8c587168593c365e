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
``all_to_all(tiled=True)``  ``all_to_all_single`` over the blocks of
                            ``split_axis``, concatenated on
                            ``concat_axis``
``all_gather(tiled)``       ``all_gather_into_tensor``
``ppermute``                ``batch_isend_irecv``
==========================  ======================================

Trees are dicts, lists or tuples of tensors (torch's pytrees). Every
function returns new tensors and leaves its inputs as they were; these
forms carry no gradient (their inputs are detached). The differentiable
forms at the end of the module — :func:`ring_hops` (the ring's
``ppermute`` hops), :func:`all_to_all`, :func:`mean_over`, the
shard_map boundaries :func:`shard_replicated` /
:func:`gather_replicated`, the Megatron pair :func:`copy_to` /
:func:`reduce_from` and the pipeline's one-hop :func:`ring_hop` — are
``autograd.Function`` s whose backward is the adjoint collective. The
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
    y = x.detach().clone()
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
    src = x.detach().movedim(gather_dimension, 0).contiguous()
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


# ------------------------------------------------ differentiable forms
#
# ``torch.distributed`` calls carry no gradient, but the JAX package's
# sequence- and expert-parallel bodies differentiate through
# ``ppermute``, ``all_to_all`` and ``pmean`` (shard_map transposes
# them). These ``autograd.Function`` forms give each collective its
# adjoint, a collective too, so every rank's backward posts the same
# sequence of calls as its forward did, in reverse.


def all_to_all_tiled(x: torch.Tensor, mesh, axis: str, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``, non-differentiable: ``x`` splits
    into ``n`` blocks along ``split_axis``, block j goes to rank j, and
    the blocks received are concatenated along ``concat_axis`` in rank
    order."""
    n = mesh.shape[axis]
    if x.shape[split_axis] % n:
        raise ValueError(f"dimension {split_axis} of {tuple(x.shape)} does "
                         f"not split over {axis}={n}")
    src = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axis))
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return all_to_all_tiled(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return (all_to_all_tiled(g, mesh, axis, concat_axis, split_axis),
                None, None, None, None)


def _mean_axes(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    for a in axes:
        x = pmean(x, mesh, a)
    return x


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _mean_axes(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        # the mean is symmetric (every rank's output is (1/n)·Σ inputs):
        # its adjoint is the mean of the cotangents
        return _mean_axes(g, *ctx.args), None, None


class _RingHops(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, n_hops):
        ctx.args = (mesh, axis)
        hops = [x.clone()]
        for _ in range(n_hops):
            hops.append(ppermute_ring(hops[-1], mesh, axis, 1))
        return tuple(hops)

    @staticmethod
    def backward(ctx, *grads):
        # an unused hop's cotangent arrives as zeros: every rank rotates
        # back through every hop, whichever blocks its own loss used
        mesh, axis = ctx.args
        acc = grads[-1]
        for g in reversed(grads[:-1]):
            acc = g + ppermute_ring(acc, mesh, axis, -1)
        return acc, None, None, None


def ring_hops(x: torch.Tensor, mesh, axis: str, n_hops: int):
    """The blocks a ring holds: ``x`` (hop 0) and ``x`` rotated by
    1..``n_hops`` ranks, as ONE differentiable collective. Its backward
    runs on every rank that uses any of the blocks — hop 0, the local
    one, is used everywhere — and posts all ``n_hops`` reverse
    rotations there, so a rank whose causal mask skips some hops still
    matches its neighbours' sends (a node per hop would leave a skipped
    hop out of that rank's backward)."""
    return _RingHops.apply(x, mesh, axis, n_hops)


def all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """:func:`all_to_all_tiled` with a gradient: the backward is the
    inverse all_to_all (``split_axis`` and ``concat_axis`` swapped)."""
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def mean_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of ``x`` over one mesh axis or several (``lax.pmean``
    over a tuple of axes) with a gradient: the backward is the same
    mean of the cotangent."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return _MeanOver.apply(x, mesh, axes)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim, x.shape[dim])
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, size = ctx.args
        i = mesh.axis_index(axis)
        return g.narrow(dim, i * size, size), None, None, None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {axis}={n}")
        size = x.shape[dim] // n
        return x.narrow(dim, mesh.axis_index(axis) * size, size).clone()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return all_gather(g, mesh, axis, dim), None, None, None


def shard_replicated(x: torch.Tensor, mesh, axis: str, dim: int
                     ) -> torch.Tensor:
    """This rank's block of a tensor every rank holds alike (shard_map's
    ``in_specs`` split along ``dim`` over ``axis``). The backward
    gathers the blocks' cotangents: the gradient of the replicated
    input, whole, on every rank."""
    return _Shard.apply(x, mesh, axis, dim)


def gather_replicated(x: torch.Tensor, mesh, axis: str, dim: int
                      ) -> torch.Tensor:
    """Every rank's block concatenated along ``dim`` (shard_map's
    ``out_specs``). The backward takes this rank's block of the
    cotangent, which every rank holds alike when each computes the same
    loss from the gathered tensor."""
    return _Gather.apply(x, mesh, axis, dim)


# ----------------------------------------- tensor / pipeline parallel
#
# The Megatron pair. A replicated activation that meets an axis-sharded
# weight enters through ``copy_to`` (Megatron's f: identity forward,
# psum backward — the transpose ``shard_map`` inserts by itself where a
# replicated value meets a varying one), and a partial product leaves
# through ``reduce_from`` (Megatron's g: psum forward, identity
# backward).


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, *ctx.args), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return ppermute_ring(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return ppermute_ring(g, *ctx.args, -1), None, None


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` as it is, whose gradient is summed over ``axis``: the
    entry of a value every rank of the axis holds alike into work that
    each rank does on its own slice (Megatron's f). Each rank's
    backward then holds the whole gradient of ``x``."""
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (``lax.psum``) whose backward
    hands each rank the cotangent as it is (Megatron's g): the exit of
    per-slice partial products into a value every rank holds alike."""
    return _ReduceFrom.apply(x, mesh, axis)


def ring_hop(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """One differentiable hop round the ring: rank i's ``x`` goes to
    rank i + 1; the backward rotates the cotangent back by one. A
    pipeline posts one a tick, so every rank whose graph holds the
    hop's output posts the reverse hop in its backward."""
    return _RingHop.apply(x, mesh, axis)
