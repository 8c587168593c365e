"""LeNet-5 — the CIFAR-10 conv model.

Port of ``lua_mapreduce_tpu/models/lenet.py``: conv 5x5x6 → tanh →
maxpool 2x2 → conv 5x5x16 → tanh → maxpool 2x2 → fc120 → fc84 → fc10 →
log_softmax, on 32x32x3 inputs. The convs run ``ops.conv2d`` (im2col →
the matmul kernel), the pools ``ops.maxpool2d`` (the pool kernel), the
output ``ops.log_softmax`` (the softmax kernel); the FC layers are plain
``@``, as the JAX model leaves them to XLA outside any Pallas kernel.

Layouts are the JAX package's: activations NHWC, weights HWIO. Params
are a flat name→tensor dict with the JAX model's names
(``c1_W``, ``c1_b``, …, ``f3_b``), so ``convert.params_from_jax``
carries them across unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Union

import torch

from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.device import resolve_device

Params = Dict[str, torch.Tensor]

CIFAR_SHAPE = (32, 32, 3)
N_CLASSES = 10

# (name, kernel, c_out) and (name, d_out): LeNet-5 on 32x32x3 inputs
_CONVS = (("c1", 5, 6), ("c2", 5, 16))
_FCS = (("f1", 120), ("f2", 84), ("f3", N_CLASSES))


def _flat_dim(input_shape: Sequence[int]) -> int:
    h, w, _ = input_shape
    for (_, k, _c) in _CONVS:
        h, w = (h - k + 1) // 2, (w - k + 1) // 2   # VALID conv, 2x2 pool
    return h * w * _CONVS[-1][2]


def init_lenet(seed: Union[int, torch.Generator] = 0,
               input_shape: Sequence[int] = CIFAR_SHAPE,
               dtype: torch.dtype = torch.float32,
               device: Optional[Union[str, torch.device]] = None) -> Params:
    """Glorot-uniform weights, zero biases; conv weights HWIO.

    Values come from a CPU ``torch.Generator`` and are then moved to
    ``device`` (default ``"cuda"``); they are not the JAX package's
    numbers for the same seed — carry JAX parameters across with
    ``convert.params_from_jax``.
    """
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))

    def uniform(shape, bound):
        w = (torch.rand(shape, generator=gen) * 2 - 1) * bound
        return w.to(device=dev, dtype=dtype)

    params: Params = {}
    c_in = input_shape[-1]
    for name, k, c_out in _CONVS:
        bound = math.sqrt(6.0 / (k * k * c_in + k * k * c_out))
        params[f"{name}_W"] = uniform((k, k, c_in, c_out), bound)
        params[f"{name}_b"] = torch.zeros((c_out,), dtype=dtype, device=dev)
        c_in = c_out
    d_in = _flat_dim(input_shape)
    for name, d_out in _FCS:
        params[f"{name}_W"] = uniform((d_in, d_out),
                                      math.sqrt(6.0 / (d_in + d_out)))
        params[f"{name}_b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
        d_in = d_out
    return params


def lenet_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(N,32,32,3) → (N,10) log-probabilities."""
    for name, _k, _c in _CONVS:
        x = ops.conv2d(x, params[f"{name}_W"], params[f"{name}_b"],
                       padding="VALID")
        x = torch.tanh(x)
        x = ops.maxpool2d(x, window=2)
    x = x.reshape(x.shape[0], -1)
    for name, _d in _FCS[:-1]:
        x = torch.tanh(x @ params[f"{name}_W"] + params[f"{name}_b"])
    name = _FCS[-1][0]
    logits = x @ params[f"{name}_W"] + params[f"{name}_b"]
    return ops.log_softmax(logits)


def nll_loss(params: Params, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    logp = lenet_apply(params, x)
    return -logp.gather(1, y.long()[:, None]).mean()


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    return (lenet_apply(params, x).argmax(dim=1) == y.long()).float().mean()


def flops_per_example(input_shape: Sequence[int] = CIFAR_SHAPE) -> int:
    """Fwd+bwd matmul-equivalent FLOPs per example (MFU accounting)."""
    h, w, c_in = input_shape
    fwd = 0
    for _name, k, c_out in _CONVS:
        ho, wo = h - k + 1, w - k + 1
        fwd += 2 * ho * wo * k * k * c_in * c_out
        h, w, c_in = ho // 2, wo // 2, c_out
    d_in = h * w * c_in
    for _name, d_out in _FCS:
        fwd += 2 * d_in * d_out
        d_in = d_out
    return 3 * fwd
