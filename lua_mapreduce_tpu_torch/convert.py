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
                    device: Optional[Union[str, torch.device]] = None, *,
                    mesh=None, ep_axis: str = "dp",
                    mp_axis: Optional[str] = None,
                    pp_axis: Optional[str] = None
                    ) -> Dict[str, torch.Tensor]:
    """A dict of JAX-package arrays as tensors on ``device`` (default
    ``"cuda"``; the mesh's device when ``mesh`` is given), dtypes kept.

    With ``mesh`` every rank takes its own slice, so both packages
    start from the same numbers: by default each MoE expert stack is
    cut to this rank's E/ep experts along ``ep_axis``
    (``models.transformer.shard_params_moe``); with ``mp_axis`` the
    dict is the JAX 3-D one (``shard_params_3d``'s head-structured tp
    weights) and each tp weight is cut to this rank's mp slice; with
    ``pp_axis`` it is the JAX pipeline stack (``stack_params_pp``'s
    ``layers_*``) and each stack is cut to this stage's layers."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    dev = mesh.device if mesh is not None and device is None \
        else resolve_device(device)
    out = {k: array_to_tensor(v) for k, v in np_params.items()}
    if mesh is not None:
        if mp_axis is not None:
            specs = tt.param_specs_3d(mp_axis)
            out = {k: (v if tt._spec_for(k, specs) is None else
                       tt._shard_spec(v, mesh, tt._spec_for(k, specs)))
                   for k, v in out.items()}
        elif pp_axis is not None:
            out = {k: (tt._block_of(v, mesh, pp_axis, 0)
                       if k.startswith("layers_") else v)
                   for k, v in out.items()}
        else:
            out = tt.shard_params_moe(out, mesh, ep_axis=ep_axis)
    return {k: v.contiguous().to(dev) for k, v in out.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor], *, mesh=None,
                    ep_axis: str = "dp", mp_axis: Optional[str] = None,
                    pp_axis: Optional[str] = None) -> Dict[str, np.ndarray]:
    """A dict of tensors as numpy arrays for the JAX package. With
    ``mesh`` the params are this rank's slices and are gathered whole
    (every rank calls it): the expert stacks over ``ep_axis``, or with
    ``mp_axis`` the tp weights over mp (the JAX 3-D dict), or with
    ``pp_axis`` the layer stacks over pp (the JAX pipeline stack)."""
    if mesh is not None:
        from lua_mapreduce_tpu_torch.models import transformer as tt
        from lua_mapreduce_tpu_torch.parallel import collectives as C
        if mp_axis is not None:
            params = tt._gather_params_3d(params, mesh, mp_axis=mp_axis)
        elif pp_axis is not None:
            params = {k: (C.all_gather(v, mesh, pp_axis)
                          if k.startswith("layers_") else v)
                      for k, v in params.items()}
        else:
            specs = tt.param_specs_moe(ep_axis)
            params = {k: (v if tt._spec_for(k, specs) is None
                          else C.all_gather(v, mesh, ep_axis))
                      for k, v in params.items()}
    return {k: tensor_to_array(v) for k, v in params.items()}
