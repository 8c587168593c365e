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
a run can show that its main path went through the kernels. A CUDA graph
replays kernels without running the wrappers, so the launches a capture
passes through are recorded, not counted (:func:`recording_launches`),
and credited once per replay (:func:`credit_launches`): the counts keep
meaning "kernels that ran".
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator

import torch

KERNELS = ("matmul_f32", "matmul_bf16", "rowwise_softmax", "flash_fwd",
           "flash_bwd_dq", "flash_bwd_dkv", "decode", "q8", "pool")

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


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[str, int]]:
    """Within the block, launches are recorded instead of counted: the
    yielded dict holds, on exit, the launches per kernel the block passed
    through, and the counts are as they were before it. Wrap a CUDA graph
    capture in it — captured kernels do not run — and credit the dict at
    every replay."""
    with _launch_lock:
        before = dict(_launches)
    tally: Dict[str, int] = {}
    try:
        yield tally
    finally:
        with _launch_lock:
            for k, n in before.items():
                if _launches[k] != n:
                    tally[k] = _launches[k] - n
                _launches[k] = n


def credit_launches(tally: Dict[str, int]) -> None:
    """Count the launches of ``tally`` (from :func:`recording_launches`)
    once: what one replay of a captured graph ran."""
    with _launch_lock:
        for k, n in tally.items():
            _launches[k] += n


def alignment(*byte_values: int) -> int:
    """The largest power of two up to 16 that divides every value (an
    address or a pitch in bytes): what a kernel's plan reads to choose
    16-byte accesses."""
    a = 16
    for v in byte_values:
        while v % a:
            a //= 2
    return a


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
from lua_mapreduce_tpu_torch.ops.conv import conv2d  # noqa: E402
from lua_mapreduce_tpu_torch.ops.pool import avgpool2d, maxpool2d  # noqa: E402

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts",
           "recording_launches", "credit_launches", "device_kind",
           "matmul", "log_softmax", "softmax", "flash_attention",
           "decode_attention", "quantize_kv", "q8_matmul", "quantize_q8",
           "conv2d", "maxpool2d", "avgpool2d"]
