"""Mixed-precision training: f32 master weights around an optimizer.

Port of ``lua_mapreduce_tpu/train/precision.py``. A bf16 parameter
cannot absorb an update smaller than its own ulp, so late-training
updates round to zero; an f32 MASTER copy of every sub-f32 parameter
takes the updates at full precision, and the working copy becomes the
master rounded to the parameter dtype after each step. The JAX package
wraps an optax transformation; in torch idiom the wrapper holds a
``torch.optim`` optimizer over the masters:

    opt = with_f32_master(params.values(), lambda ms: optim.adam(ms, 1e-3))
"""

from __future__ import annotations

from typing import Callable, Iterable, List

import torch


class F32Master:
    """An optimizer over f32 masters of ``params`` (see
    :func:`with_f32_master`); ``step()`` reads each parameter's
    ``.grad``, as a ``torch.optim`` optimizer's does."""

    def __init__(self, params: Iterable[torch.Tensor],
                 make_inner: Callable[[List[torch.Tensor]], object]):
        self.params = list(params)
        # sub-f32 params get f32 masters; f32 or wider ones are their own
        self.masters = [p.detach().float().clone()
                        if p.dtype.itemsize < 4 else p for p in self.params]
        self.inner = make_inner(self.masters)

    @torch.no_grad()
    def step(self) -> None:
        """Gradients cast to the masters' dtype, the inner optimizer
        steps the masters, each working parameter becomes its master
        rounded to the parameter's dtype."""
        for p, m in zip(self.params, self.masters):
            if m is not p:
                m.grad = None if p.grad is None else p.grad.to(m.dtype)
        self.inner.step()
        for p, m in zip(self.params, self.masters):
            if m is not p:
                p.copy_(m)


def with_f32_master(params: Iterable[torch.Tensor],
                    make_inner: Callable[[List[torch.Tensor]], object]
                    ) -> F32Master:
    """Wrap the optimizer ``make_inner(masters)`` so it steps f32 masters
    of the sub-f32 ``params`` (the JAX package's
    ``with_f32_master(optimizer)``: updates land on the masters, each
    working parameter then equals its master rounded to its dtype)."""
    return F32Master(params, make_inner)
