"""The optimizers of the LM trainer, as the JAX package's optax ones.

``sgd`` and ``adam`` build ``torch.optim`` optimizers that take the same
steps as ``optax.sgd(lr, momentum)`` and ``optax.adam(lr)``, with their
state created at construction (the zeros the first ``step()`` would
create), so a fresh optimizer already has the structure a checkpoint
holds: :func:`state_tree` and :func:`load_state_tree` carry that state
through ``train/checkpoint.py``, wrapped in :class:`F32Master` or not.
"""

from __future__ import annotations

from typing import Any, Iterable

import torch

from lua_mapreduce_tpu_torch.train.precision import F32Master


def _materialize(opt: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """Create the state the first ``step()`` would create: SGD's momentum
    buffer as zeros (0·momentum + g is g, the buffer torch would clone),
    Adam's step count 0 and zero moments."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if isinstance(opt, torch.optim.Adam):
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
            elif group["momentum"]:
                st["momentum_buffer"] = torch.zeros_like(p)
    return opt


def sgd(params: Iterable[torch.Tensor], lr: float,
        momentum: float = 0.0) -> torch.optim.SGD:
    """``optax.sgd(lr, momentum)``: torch's SGD with dampening 0 and
    nesterov off keeps optax's trace b = g + momentum·b and steps −lr·b."""
    return _materialize(torch.optim.SGD(list(params), lr=lr,
                                        momentum=momentum, dampening=0.0,
                                        nesterov=False))


def adam(params: Iterable[torch.Tensor], lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: torch's Adam with optax's defaults b1 = 0.9,
    b2 = 0.999, eps = 1e-8 added outside the square root of the
    bias-corrected second moment — the same formula."""
    return _materialize(torch.optim.Adam(list(params), lr=lr,
                                         betas=(0.9, 0.999), eps=1e-8))


def state_tree(opt) -> Any:
    """The optimizer's state as a tree of tensors: a list of per-parameter
    dicts, and under :class:`F32Master` the sub-f32 masters beside it."""
    if isinstance(opt, F32Master):
        return {"masters": [m for p, m in zip(opt.params, opt.masters)
                            if m is not p],
                "inner": state_tree(opt.inner)}
    return [dict(opt.state[p]) for g in opt.param_groups
            for p in g["params"]]


@torch.no_grad()
def load_state_tree(opt, tree: Any) -> None:
    """Copy a :func:`state_tree` (e.g. loaded from a checkpoint) into
    ``opt``'s state in place, keeping each tensor's device and dtype."""
    if isinstance(opt, F32Master):
        own = [m for p, m in zip(opt.params, opt.masters) if m is not p]
        for m, saved in zip(own, tree["masters"]):
            m.copy_(saved)
        load_state_tree(opt.inner, tree["inner"])
        return
    params = [p for g in opt.param_groups for p in g["params"]]
    for p, saved in zip(params, tree):
        for k, v in saved.items():
            opt.state[p][k].copy_(v)
