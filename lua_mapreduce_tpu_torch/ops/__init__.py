"""Kernel library: hand-written Hopper kernels beside plain versions.

The JAX package's ``ops/`` holds Pallas kernels for the TPU with XLA
compositions beside them (``ops/__init__.py:70-101`` picks one per
``backend=``). Here the choice follows the tensor's device instead:

- a CPU tensor runs the op's plain PyTorch version (the CPU tests and
  the oracle the kernel is held against on the card);
- a CUDA tensor launches the op's CUDA kernel (``csrc/*.cu``, built at
  first use by ``ops/_build.py``) or raises — there is no fallback from
  the kernel to the plain version.

Each launch adds one to its kernel's count (:func:`launch_counts`), so
a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import threading
from typing import Dict

import torch

KERNELS = ("matmul_f32", "matmul_bf16", "rowwise_softmax", "flash_fwd",
           "decode", "q8")

_launches: Dict[str, int] = {k: 0 for k in KERNELS}
_launch_lock = threading.Lock()


def count_launch(kernel: str) -> None:
    """Record one launch of ``kernel`` (called by the wrappers right
    after a successful launch, and nowhere else)."""
    with _launch_lock:
        _launches[kernel] += 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    with _launch_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _launch_lock:
        for k in _launches:
            _launches[k] = 0


def device_kind(*tensors: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``: where an op on ``tensors`` runs. Mixed
    or other devices raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"} or kinds == {"cuda"}:
        if len({t.device for t in tensors}) > 1:
            raise ValueError(f"operands on different devices: "
                             f"{sorted(str(t.device) for t in tensors)}")
        return kinds.pop()
    raise ValueError(f"ops run on cpu or cuda tensors, got devices "
                     f"{sorted(str(t.device) for t in tensors)}")


from lua_mapreduce_tpu_torch.ops.matmul import matmul  # noqa: E402
from lua_mapreduce_tpu_torch.ops.softmax import log_softmax, softmax  # noqa: E402
from lua_mapreduce_tpu_torch.ops.attention import flash_attention  # noqa: E402
from lua_mapreduce_tpu_torch.ops.decode import (decode_attention,  # noqa: E402
                                                quantize_kv)
from lua_mapreduce_tpu_torch.ops.q8 import q8_matmul, quantize_q8  # noqa: E402

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts", "device_kind",
           "matmul", "log_softmax", "softmax", "flash_attention",
           "decode_attention", "quantize_kv", "q8_matmul", "quantize_q8"]
