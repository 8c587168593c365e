"""Carry parameters between the JAX package and the port.

The two packages draw initial weights from different RNGs, so a parity
run starts both from the same numbers carried across as numpy arrays:
``params_from_jax`` turns a dict of arrays (``np.asarray`` of the JAX
leaves) into tensors, ``params_to_numpy`` turns tensors back into
arrays the JAX package accepts.

bfloat16 crosses as its 16 bits: an ml_dtypes ``bfloat16`` array is
viewed as uint16 and reinterpreted as ``torch.bfloat16`` without
importing ml_dtypes (the machine with the card does not have it), and a
bf16 tensor comes back widened to float32, which holds every bf16 value
exactly.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from lua_mapreduce_tpu_torch.device import resolve_device


def array_to_tensor(a) -> torch.Tensor:
    """One numpy (or ml_dtypes bfloat16) array as a CPU tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a, copy=True, order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def tensor_to_array(t: torch.Tensor) -> np.ndarray:
    """One tensor as a numpy array (bfloat16 widened to float32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def params_from_jax(np_params: Mapping[str, object],
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, torch.Tensor]:
    """A dict of JAX-package arrays as tensors on ``device`` (default
    ``"cuda"``), dtypes kept."""
    dev = resolve_device(device)
    return {k: array_to_tensor(v).to(dev) for k, v in np_params.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    """A dict of tensors as numpy arrays for the JAX package."""
    return {k: tensor_to_array(v) for k, v in params.items()}
