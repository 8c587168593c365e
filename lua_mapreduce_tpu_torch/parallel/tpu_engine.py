"""The SPMD MapReduce executor.

Port of ``lua_mapreduce_tpu/parallel/tpu_engine.py``. The JAX executor
compiles an :class:`ArrayTaskSpec` into one jitted ``shard_map`` over a
mesh; here every rank of the mesh is a process that runs the same
program on its own shard, and the cross-shard steps are
``torch.distributed`` collectives over the mesh axis's group
(``parallel/collectives.py``). The two shuffle shapes are the JAX
module's (SURVEY.md §2.5-2.6):

- **keyed** (:meth:`TpuExecutor.run_keyed`): mapfn's output tree is the
  key space; the reduction is an associative collective across the axis
  (all-reduce and friends). The APRIL-ANN DP-SGD shape: map = shard
  gradient, combine = local fold, reduce = all-reduce.
- **bucketed** (:meth:`TpuExecutor.run_bucketed`): the user's
  partitionfn buckets each shard's output into a leading axis of
  NUM_PARTITIONS; ``all_to_all`` sends bucket p to its rank, and a local
  fold finishes the reduce. The partitionfn → per-partition reduce-job
  shape, with the shuffle riding the interconnect instead of files.

Every rank calls with the same global inputs (the SPMD convention a
multi-controller JAX run follows too) and takes its own rows of them.
:meth:`TpuExecutor.run_loop` is ``lax.scan`` over a step: on a card the
step is captured once in a CUDA graph and replayed (``graphs.scan``).
:func:`differentiable_keyed` is the keyed shape as an autograd
primitive.
"""

from __future__ import annotations

from typing import Any

import torch

from lua_mapreduce_tpu_torch import graphs
from lua_mapreduce_tpu_torch.parallel import collectives as C
from lua_mapreduce_tpu_torch.parallel.array_task import ArrayTaskSpec
from torch.utils._pytree import tree_map

_CROSS = {
    "sum": C.psum,
    "mean": C.pmean,
    "max": C.pmax,
    "min": C.pmin,
}


def _mean(b: torch.Tensor) -> torch.Tensor:
    if not b.is_floating_point():
        b = b.float()          # jnp.mean of integers is float32
    return b.mean(0)


_LOCAL = {
    "sum": lambda b: b.sum(0, dtype=b.dtype),
    "mean": _mean,
    "max": lambda b: b.amax(0),
    "min": lambda b: b.amin(0),
}


def shard_rows(x, mesh, axis: str) -> torch.Tensor:
    """This rank's rows of a global array: the leading axis split into
    ``mesh.shape[axis]`` equal blocks, block ``mesh.axis_index(axis)``,
    on the mesh's device (only those rows are copied there). A leading
    axis that does not split evenly raises."""
    x = torch.as_tensor(x)
    n = mesh.shape[axis]
    if x.dim() == 0 or x.shape[0] % n:
        raise ValueError(f"leading axis of {tuple(x.shape)} does not split "
                         f"over {axis}={n}")
    per = x.shape[0] // n
    i = mesh.axis_index(axis)
    return x[i * per:(i + 1) * per].to(mesh.device)


class TpuExecutor:
    """Execute a MapReduce over a mesh.

    ``axis`` names the mesh axis that plays the map-shard role (default
    ``dp``). Every rank of the world constructs the executor and makes
    the same calls.
    """

    def __init__(self, spec: ArrayTaskSpec, mesh, axis: str = "dp"):
        self.spec = spec
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.shape[axis]

    def shard_inputs(self, batch) -> Any:
        """This rank's shard of a global batch (the taskfn role: each
        rank's slice is its map job)."""
        return tree_map(lambda x: shard_rows(x, self.mesh, self.axis), batch)

    def _map_combine(self, batch) -> Any:
        out = self.spec.mapfn(self.shard_inputs(batch))
        if self.spec.combinerfn is not None:
            out = self.spec.combinerfn(out)
        return out

    def run_keyed(self, batch) -> Any:
        """map → combine → all-reduce. Returns the reduced tree, the same
        on every rank (like every reference worker seeing the final
        reduce output in GridFS)."""
        cross = _CROSS[self.spec.reduce_op]
        result = tree_map(lambda x: cross(x, self.mesh, self.axis),
                          self._map_combine(batch))
        if self.spec.finalfn is not None:
            return self.spec.finalfn(result)
        return result

    def run_bucketed(self, batch) -> Any:
        """map → combine → partition → all_to_all shuffle → local
        reduce. Returns this rank's partitions: rank p holds partitions
        [p*per_dev, (p+1)*per_dev), the leading axis of each leaf (one
        "reduce job per partition", server.lua:300-325)."""
        spec, n = self.spec, self.n_shards
        if spec.partitionfn is None:
            raise ValueError("bucketed mode needs spec.partitionfn")
        num_p = spec.num_partitions
        if num_p % n:
            raise ValueError(
                f"num_partitions={num_p} must be a multiple of the mesh "
                f"axis size {n} (pad partitions; empty ones are cheap)")
        per_dev = num_p // n
        local = _LOCAL[spec.reduce_op]

        def shuffle_reduce(b):
            # [num_p, ...] → [n, per_dev, ...]: outer = destination rank;
            # after the exchange the outer axis is the source mapper
            b = b.reshape((n, per_dev) + tuple(b.shape[1:]))
            b = C.all_to_all_buckets(b, self.mesh, self.axis)
            return local(b)      # the k-way merge + reducefn

        result = tree_map(shuffle_reduce,
                          spec.partitionfn(self._map_combine(batch)))
        if spec.finalfn is not None:
            return spec.finalfn(result)
        return result

    def run_loop(self, init_state, step_fn, n_steps: int):
        """``state, out = step_fn(state)`` for ``n_steps`` iterations;
        returns the final state and the outputs stacked per step. The
        zero-round-trip hot loop: on a card the step is captured once in
        a CUDA graph (collectives included) and replayed — the
        counterpart of the JAX executor's ``lax.scan`` under ``jit``.
        ``step_fn`` calls this executor's collectives through closures,
        as the JAX one does."""
        state = tree_map(lambda x: torch.as_tensor(x).to(self.mesh.device),
                         init_state)
        return graphs.scan(step_fn, state, n_steps, tag="run_loop")


class _Replicated(torch.autograd.Function):
    """The identity on a replicated parameter whose backward sums its
    cotangent over the axis: shard_map's automatic psum of the
    cotangents of replicated inputs (Megatron's "f")."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return C.psum(g, ctx.mesh, ctx.axis), None, None


class _Cross(torch.autograd.Function):
    """The cross-rank sum (or mean) whose backward is the identity (the
    mean's: 1/n) — psum's transpose inside shard_map (Megatron's "g")."""

    @staticmethod
    def forward(ctx, x, mesh, axis, mean):
        y = C.psum(x, mesh, axis)
        ctx.scale = 1.0 / mesh.shape[axis] if mean else 1.0
        return y * ctx.scale if mean else y

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None, None


def differentiable_keyed(mapfn, mesh, axis: str = "dp",
                         reduce_op: str = "mean"):
    """A DIFFERENTIABLE keyed MapReduce primitive (the DrJAX shape,
    arXiv:2403.07128).

    ``mapfn(params, shard) -> tree`` runs on each rank's rows of the
    global batch; the returned ``f(params, batch) -> reduced`` gives the
    cross-rank reduction on every rank, and gradients flow through both
    the map and the collective: the replicated parameters pass through
    :class:`_Replicated` and the outputs through :class:`_Cross`, so
    ``torch.autograd.grad(loss(f(p, batch)), p)`` is the gradient of the
    global loss on every rank.

    Only ``sum`` and ``mean``: max/min have no differentiation rule in
    the JAX package, and the port keeps its contract (use
    :meth:`TpuExecutor.run_keyed` for forward-only max/min).
    """
    if reduce_op not in ("sum", "mean"):
        raise ValueError(
            f"differentiable_keyed needs reduce_op 'sum' or 'mean', got "
            f"{reduce_op!r} — pmax/pmin are not differentiable; use "
            "TpuExecutor.run_keyed for forward-only max/min")
    mean = reduce_op == "mean"

    def f(params, batch):
        p = tree_map(lambda t: _Replicated.apply(t, mesh, axis), params)
        shard = tree_map(lambda x: shard_rows(x, mesh, axis), batch)
        return tree_map(lambda x: _Cross.apply(x, mesh, axis, mean),
                        mapfn(p, shard))

    return f
