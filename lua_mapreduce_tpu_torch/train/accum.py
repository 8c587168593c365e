"""Gradient accumulation: the microbatch value-and-grad fold.

Port of ``lua_mapreduce_tpu/train/accum.py``. The batch splits on its
leading axis into ``accum`` equal microbatches; each microbatch's
forward and backward run in turn, so one microbatch's activations are
live at a time, and the mean (loss, grads) equals the whole batch's up
to float associativity. Running sums are f32 whatever the parameter
dtype; the mean is cast back to each parameter's dtype.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch


def accum_value_and_grad(loss_fn: Callable, params: Dict[str, torch.Tensor],
                         arrays: Sequence[torch.Tensor], accum: int
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean of ``loss_fn(params, *microbatch)`` and of its gradient with
    respect to every tensor of ``params`` over ``accum`` equal
    microbatches of ``arrays``. ``loss_fn`` must be a MEAN over examples,
    so equal-size microbatch gradients average exactly to the whole
    batch's. Returns (detached f32 loss, {name: grad}); a parameter the
    loss does not reach gets a zero gradient, as under ``jax.grad``."""
    rows = arrays[0].shape[0]
    if rows % accum:
        raise ValueError(f"per-device batch of {rows} rows does not "
                         f"split into grad_accum={accum}")
    micro = [a.reshape(accum, rows // accum, *a.shape[1:]) for a in arrays]
    names = list(params)
    leaves = [params[n] for n in names]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    g_sum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    for i in range(accum):
        loss = loss_fn(params, *(m[i] for m in micro))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for acc, g in zip(g_sum, grads):
            if g is not None:
                acc += g.float()
        loss_sum += loss.detach().float()
    return loss_sum / accum, {n: (g / accum).to(p.dtype)
                              for n, g, p in zip(names, g_sum, leaves)}
