"""Pipeline parallelism: GPipe-style microbatch schedule over a ``pp``
mesh axis.

Port of ``lua_mapreduce_tpu/parallel/pipeline.py``. Consecutive layer
groups live on consecutive ranks (layer-stacked weights cut along their
leading axis), and microbatches flow through the ring — one hop per
tick carries each microbatch's activations to the next stage while
every stage works on a different microbatch. The schedule is the
classic (n_micro + n_stages − 1)-tick GPipe grid. The JAX package
writes it as one ``lax.scan`` and lets reverse-mode AD transpose it;
here the ticks are a Python loop and each hop is
``collectives.ring_hop``, whose backward is the reverse hop, so
autograd runs the backward pipeline with no hand-written schedule.

Every rank runs the same program: stage 0 swaps in the next microbatch
by ``torch.where`` on a tensor condition (so the received tensor stays
in its graph and its backward posts every tick's reverse hop, as every
other rank's does), and the last stage's outputs leave through one
masked psum over the axis after the loop. Bubble ticks compute on zeros
or stale activations that no output reads.
"""

from __future__ import annotations

from typing import Callable

import torch

from lua_mapreduce_tpu_torch.parallel import collectives as C


def pipeline_apply(stage_fn: Callable, x_micro: torch.Tensor, *, mesh,
                   pp_axis: str, n_stages: int) -> torch.Tensor:
    """Run microbatches through the pipeline, on every rank of
    ``pp_axis``.

    - ``stage_fn(x) -> x`` applies THIS rank's layer group (it closes
      over the rank's slice of the layer-stacked weights).
    - ``x_micro``: (n_micro, mb, ...) stage-0 inputs, alike on every
      rank (only stage 0 reads them).

    Returns (n_micro, mb, ...) outputs of the LAST stage on every rank:
    the psum of each rank's masked outputs, whose backward hands every
    rank the cotangent whole (``collectives.reduce_from``)."""
    n_micro = x_micro.shape[0]
    stage = mesh.axis_index(pp_axis)
    first = torch.tensor(stage == 0, device=x_micro.device)
    last = torch.tensor(stage == n_stages - 1, device=x_micro.device)
    buf = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(n_micro + n_stages - 1):
        # receive the previous stage's activations (stage 0 receives the
        # last stage's and keeps them in its graph, unused)
        recv = C.ring_hop(buf, mesh, pp_axis)
        buf = stage_fn(torch.where(first, x_micro[min(t, n_micro - 1)],
                                   recv))
        # microbatch m leaves the last stage at tick m + n_stages - 1;
        # the bubble ticks before are dropped before the collective
        if t >= n_stages - 1:
            outs.append(torch.where(last, buf, torch.zeros_like(buf)))
    return C.reduce_from(torch.stack(outs), mesh, pp_axis)
