"""maxpool2d / avgpool2d over NHWC — the pool kernel and its plain
version.

Port of ``lua_mapreduce_tpu/ops/pool.py``: the Pallas ``_pool_kernel``
becomes ``csrc/pool.cu`` (one kernel, max and avg modes; its source note
says what bounds it and what the design does about it). ``_pool_plain``
is ``_pool_xla`` line for line: KH·KW strided slices combined with
``torch.maximum`` or ``+`` in the same order (i outer, j inner); avg
sums in the input dtype, then divides.

The backward is the autograd of ``_pool_plain`` on the saved input, on
either device, as ``_pool_p_bwd`` differentiates ``_pool_xla`` outside
any Pallas kernel. ``F.max_pool2d``'s backward would differ: it routes a
tied window's whole gradient to one element, where ``torch.maximum``
(like ``lax.max``) splits it equally between the tied operands.
"""

from __future__ import annotations

import torch

from lua_mapreduce_tpu_torch.ops import _build, count_launch, device_kind
from lua_mapreduce_tpu_torch.ops.conv import _norm_stride

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"max": 0, "avg": 1}


def _out_hw(x: torch.Tensor, window, stride):
    (kh, kw), (sh, sw) = window, stride
    if x.dim() != 4:
        raise ValueError(f"pooling takes NHWC 4-D input, got "
                         f"{tuple(x.shape)}")
    _, h, w, _ = x.shape
    if kh > h or kw > w:
        raise ValueError(f"window {kh}x{kw} larger than the input {h}x{w}")
    return (h - kh) // sh + 1, (w - kw) // sw + 1


def _pool_plain(x: torch.Tensor, window, stride, mode: str) -> torch.Tensor:
    """KH·KW strided slices combined elementwise (``_pool_xla``)."""
    kh, kw = window
    sh, sw = stride
    ho, wo = _out_hw(x, window, stride)
    out = None
    for i in range(kh):
        for j in range(kw):
            s = x[:, i:i + (ho - 1) * sh + 1:sh, j:j + (wo - 1) * sw + 1:sw, :]
            if out is None:
                out = s
            else:
                out = torch.maximum(out, s) if mode == "max" else out + s
    if mode == "avg":
        out = out / (kh * kw)
    return out


def pool_cuda(x: torch.Tensor, window, stride, mode: str) -> torch.Tensor:
    """Launch ``csrc/pool.cu`` on a CUDA tensor (NHWC; a non-contiguous
    ``x`` is made contiguous first, one copy)."""
    if x.dtype not in _CODES:
        raise TypeError(f"pool kernel takes float32/bfloat16, got {x.dtype}")
    if mode not in _MODES:
        raise ValueError(f"unknown pool mode {mode!r}")
    ho, wo = _out_hw(x, window, stride)
    x = x.contiguous()
    n, h, w, c = x.shape
    y = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.library("pool")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmr_pool(x.data_ptr(), y.data_ptr(), n, h, w, c,
                          window[0], window[1], stride[0], stride[1],
                          _CODES[x.dtype], _MODES[mode], stream)
    _build.check(lib, rc, "pool kernel launch")
    count_launch("pool")
    return y


class _Pool(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    the autograd of ``_pool_plain`` (``_pool_p_fwd``/``_pool_p_bwd`` of
    the JAX op)."""

    @staticmethod
    def forward(ctx, x, window, stride, mode):
        ctx.save_for_backward(x)
        ctx.cfg = (window, stride, mode)
        if device_kind(x) == "cpu":
            return _pool_plain(x, window, stride, mode)
        return pool_cuda(x, window, stride, mode)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            y = _pool_plain(xd, *ctx.cfg)
        (dx,) = torch.autograd.grad(y, xd, g)
        return dx, None, None, None


def _pool(x, window, stride, mode):
    window = _norm_stride(window)
    stride = _norm_stride(stride if stride is not None else window)
    return _Pool.apply(x, window, stride, mode)


def maxpool2d(x: torch.Tensor, window=2, stride=None) -> torch.Tensor:
    """VALID max pooling over NHWC; stride defaults to the window."""
    return _pool(x, window, stride, "max")


def avgpool2d(x: torch.Tensor, window=2, stride=None) -> torch.Tensor:
    """VALID average pooling over NHWC; stride defaults to the window."""
    return _pool(x, window, stride, "avg")
