"""Row-wise log_softmax / softmax over the last axis — the kernel and
its plain versions.

Port of ``lua_mapreduce_tpu/ops/softmax.py``: the Pallas
``_log_softmax_kernel`` and ``_softmax_kernel`` become one CUDA kernel
with a mode flag (``csrc/softmax.cu``; its source note says what bounds
it and what the design does about it). All math is f32, the output is
in the input dtype. The backward passes stay analytic and elementwise in
plain torch, outside the kernel, as in the JAX op (softmax.py:94-95,
113-114):

    y = log_softmax(x):  dx = g − exp(y)·Σg
    y = softmax(x):      dx = y·(g − Σ(g·y))
"""

from __future__ import annotations

import torch

from lua_mapreduce_tpu_torch.ops import _build, count_launch, device_kind

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODE_LOG_SOFTMAX = 0
_MODE_SOFTMAX = 1


def log_softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """max, shift, exp, sum, log — in f32, cast back to x's dtype."""
    xf = x.float()
    shifted = xf - xf.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))
    return (shifted - lse).to(x.dtype)


def softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """max, shift, exp, normalise — in f32, cast back to x's dtype."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def rowwise_softmax_cuda(x: torch.Tensor, mode: int) -> torch.Tensor:
    """Launch ``csrc/softmax.cu`` on a CUDA tensor: rows are every
    leading index, the reduction runs over the last axis. A
    non-contiguous ``x`` is made contiguous first (one copy)."""
    if x.dtype not in _CODES:
        raise TypeError(f"softmax kernel takes float32/bfloat16, got "
                        f"{x.dtype}")
    if x.dim() == 0:
        raise ValueError("softmax over the last axis needs at least 1-D")
    n = x.shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    y = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows == 0 or n == 0:
        return y.view(x.shape)
    lib = _build.library("softmax")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmr_rowwise_softmax(x2.data_ptr(), y.data_ptr(), rows, n,
                                     _CODES[x.dtype], mode, stream)
    _build.check(lib, rc, "softmax kernel launch")
    count_launch("rowwise_softmax")
    return y.view(x.shape)


def _log_softmax_fwd(x: torch.Tensor) -> torch.Tensor:
    if device_kind(x) == "cpu":
        return log_softmax_plain(x)
    return rowwise_softmax_cuda(x, _MODE_LOG_SOFTMAX)


def _softmax_fwd(x: torch.Tensor) -> torch.Tensor:
    if device_kind(x) == "cpu":
        return softmax_plain(x)
    return rowwise_softmax_cuda(x, _MODE_SOFTMAX)


class _LogSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _log_softmax_fwd(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g - torch.exp(y) * g.sum(dim=-1, keepdim=True)


class _Softmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _softmax_fwd(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return y * (g - (g * y).sum(dim=-1, keepdim=True))


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable log-softmax over the last axis."""
    return _LogSoftmax.apply(x)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable softmax over the last axis."""
    return _Softmax.apply(x)
