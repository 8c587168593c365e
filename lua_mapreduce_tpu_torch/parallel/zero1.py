"""ZeRO-1: optimizer state sharded over the data-parallel axis.

Port of ``lua_mapreduce_tpu/parallel/zero1.py``. Parameters stay
replicated, but gradients REDUCE-SCATTER over dp instead of
all-reducing; each dp rank applies the optimizer to its 1/n_dp chunk of
every parameter only (holding only that chunk of the optimizer state:
SGD's momentum and Adam's moments shrink by n_dp), and the updated
chunks ALL-GATHER back into full parameters. The same wire traffic as
an all-reduce (reduce-scatter + all-gather is the ring all-reduce, split
around the update), optimizer memory ÷ n_dp.

The chunk layout is the JAX module's exactly: per leaf, flatten,
zero-pad to a multiple of n_dp, split evenly (:func:`_pad_flat`). The
optimizer therefore sees flat chunks — right for every ELEMENTWISE
optimizer (SGD, momentum, Adam, ...). Here the optimizer is a
``torch.optim`` optimizer over this rank's chunk tensors, which
:func:`init_state` makes; ``torch.distributed.optim.
ZeroRedundancyOptimizer`` is not used: it gives whole parameters to
ranks, which is not this layout.

Every helper runs on each rank of the mesh (the JAX helpers run inside
``shard_map``) and makes the same collective calls on all of them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch
import torch.nn.functional as F

from lua_mapreduce_tpu_torch.parallel import collectives as C


def _chunk_len(n: int, n_dp: int) -> int:
    return -(-n // n_dp)


def _pad_flat(x: torch.Tensor, n_dp: int) -> Tuple[torch.Tensor, int]:
    """(flat zero-padded tensor, chunk length) — THE chunk layout,
    shared by every helper so gradient and parameter chunks can never
    desynchronize."""
    flat = x.reshape(-1)
    c = _chunk_len(flat.numel(), n_dp)
    return F.pad(flat, (0, c * n_dp - flat.numel())), c


def chunk_of_rank(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """This rank's (chunk,) slice of a replicated tensor (flatten, pad
    to n_dp chunks, take chunk ``axis_index``)."""
    flat, c = _pad_flat(x, mesh.shape[axis])
    i = mesh.axis_index(axis)
    return flat[i * c:(i + 1) * c]


def scatter_mean_grads(grads: Dict[str, torch.Tensor], mesh, axis: str
                       ) -> Dict[str, torch.Tensor]:
    """Per leaf: reduce-scatter the flattened gradient over dp and
    divide — each rank receives its chunk of the dp-MEAN gradient."""
    n_dp = mesh.shape[axis]
    return {k: C.psum_scatter(_pad_flat(g, n_dp)[0], mesh, axis) / n_dp
            for k, g in grads.items()}


def gather_params(chunks: Dict[str, torch.Tensor],
                  templates: Dict[str, torch.Tensor], mesh, axis: str
                  ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`chunk_of_rank` over a dict: all-gather each
    leaf's chunks along dp, drop the padding, restore the template's
    shape and dtype."""
    out = {}
    for k, t in templates.items():
        flat = C.all_gather(chunks[k], mesh, axis)
        out[k] = flat[:t.numel()].reshape(t.shape).to(t.dtype)
    return out


def init_state(make_optimizer: Callable[[Iterable[torch.Tensor]],
                                        torch.optim.Optimizer],
               params: Dict[str, torch.Tensor], mesh, *,
               dp_axis: str = "dp"
               ) -> Tuple[Dict[str, torch.Tensor], torch.optim.Optimizer]:
    """The distributed optimizer state: this rank's parameter chunks as
    new leaf tensors (``ceil(numel / n_dp)`` elements each) and
    ``make_optimizer(chunks)``, an optimizer whose state is therefore
    chunk-sized. Returns (chunks by name, optimizer)."""
    chunks = {k: chunk_of_rank(p.detach(), mesh, dp_axis).clone()
              for k, p in params.items()}
    return chunks, make_optimizer(list(chunks.values()))


@torch.no_grad()
def update_chunks(optimizer: torch.optim.Optimizer,
                  params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor],
                  chunks: Dict[str, torch.Tensor], mesh, axis: str) -> None:
    """The whole ZeRO-1 update, shared by every step body: reduce-scatter
    the (this rank's, not yet averaged) grads, load this rank's chunk of
    each parameter into its chunk tensor, step the optimizer on the
    chunks, all-gather the updated parameters and copy them into
    ``params`` in place (the JAX function returns new params; the
    port's trainer keeps its tensors, which a captured step reads)."""
    g_chunks = scatter_mean_grads(grads, mesh, axis)
    for k, c in chunks.items():
        c.copy_(chunk_of_rank(params[k], mesh, axis))
        c.grad = g_chunks[k]
    optimizer.step()
    for k, v in gather_params(chunks, params, mesh, axis).items():
        params[k].copy_(v)
