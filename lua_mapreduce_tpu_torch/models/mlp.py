"""Digits MLP — the flagship DP-training model.

Port of ``lua_mapreduce_tpu/models/mlp.py``: the reference trains
"256 inputs 128 tanh 10 log_softmax" (examples/APRIL-ANN/init.lua:12).
Parameters are a plain dict of tensors keyed W0/b0, W1/b1, … (the
per-parameter-name key space the MapReduce example emits). The function
is the JAX ``mlp_apply``'s, but its products and its log_softmax go
through the port's kernels (``ops.matmul``, ``ops.log_softmax``), as the
JAX package's LeNet and ResNet route theirs; the bias add, the tanh and
the label gather stay plain torch, as they stay outside any kernel in
the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Union

import torch

from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.device import resolve_device

Params = Dict[str, torch.Tensor]

DIGITS_SIZES = (256, 128, 10)   # init.lua:12


def init_mlp(seed: Union[int, torch.Generator] = 0,
             sizes: Sequence[int] = DIGITS_SIZES,
             dtype: torch.dtype = torch.float32,
             device: Optional[Union[str, torch.device]] = None) -> Params:
    """Glorot-uniform weights, zero biases (keys W0/b0, W1/b1, …).

    Values come from a CPU ``torch.Generator`` (``seed`` or the given
    generator) and are then moved to ``device`` (default ``"cuda"``), so
    the same seed gives the same parameters on every device. They are
    not the JAX package's numbers for the same seed (another RNG); carry
    JAX parameters across with ``convert.params_from_jax``.
    """
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    params: Params = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        w = (torch.rand((fan_in, fan_out), generator=gen) * 2 - 1) * bound
        params[f"W{i}"] = w.to(device=dev, dtype=dtype)
        params[f"b{i}"] = torch.zeros((fan_out,), dtype=dtype, device=dev)
    return params


def n_layers(params: Params) -> int:
    return sum(1 for k in params if k.startswith("W"))


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """tanh hidden layers, log_softmax output (init.lua:12)."""
    L = n_layers(params)
    for i in range(L - 1):
        x = torch.tanh(ops.matmul(x, params[f"W{i}"]) + params[f"b{i}"])
    logits = ops.matmul(x, params[f"W{L-1}"]) + params[f"b{L-1}"]
    return ops.log_softmax(logits)


def nll_loss(params: Params, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    """Mean negative log-likelihood over a batch (labels are int
    classes)."""
    logp = mlp_apply(params, x)
    return -logp.gather(1, y.long()[:, None]).mean()


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    return (mlp_apply(params, x).argmax(dim=1) == y.long()).float().mean()


def flops_per_example(sizes: Sequence[int] = DIGITS_SIZES) -> int:
    """Forward+backward matmul FLOPs per example (≈ 3 × 2 × Σ
    fan_in·fan_out)."""
    fwd = sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))
    return 3 * fwd
