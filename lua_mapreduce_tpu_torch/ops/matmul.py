"""``a @ b`` with an f32 accumulator — the matmul kernel and its plain
version.

Port of ``lua_mapreduce_tpu/ops/matmul.py``: the Pallas ``_matmul_kernel``
becomes ``csrc/matmul.cu`` (a tiled Hopper GEMM; its source note says
what bounds it and what the design does about it), and the custom VJP
``_mm_bwd`` becomes :class:`_MatMul`, whose backward runs dA = g·Bᵀ and
dB = Aᵀ·g through the same kernel. The transposes are stride views, not
copies: the kernel reads its operands through (row, col) strides.

Inputs are float32 or bfloat16 2-D tensors; the output defaults to the
promoted input dtype (``out_dtype`` overrides it). Operands of different
dtypes are cast to the promoted dtype before the kernel launch (one
copy of the narrower operand), which is what the JAX op computes too.
"""

from __future__ import annotations

from typing import Optional

import torch

from lua_mapreduce_tpu_torch.ops import _build, count_launch, device_kind

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_F32_TILE_M = 64        # csrc/matmul.cu f32k::BM
_BF16_TILE_M = 128      # csrc/matmul.cu bf16k::BM
_MAX_GRID_Y = 65535


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version: both operands widened to f32, one f32 product
    (f32 accumulation), one cast to ``out_dtype``."""
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``csrc/matmul.cu`` on CUDA tensors ``a`` (M, K) and ``b``
    (K, N), any non-negative strides; returns a contiguous (M, N)."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    if a.dtype not in _CODES or out_dtype not in _CODES:
        raise TypeError(f"matmul kernel takes float32/bfloat16 inputs and "
                        f"outputs, got {a.dtype} -> {out_dtype}")
    m, k = a.shape
    n = b.shape[1]
    tile_m = _F32_TILE_M if a.dtype == torch.float32 else _BF16_TILE_M
    if -(-m // tile_m) > _MAX_GRID_Y:
        raise ValueError(f"matmul kernel: M={m} exceeds its grid limit "
                         f"({_MAX_GRID_Y * tile_m} rows)")
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    lib = _build.library("matmul")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmr_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                            m, n, k, a.stride(0), a.stride(1),
                            b.stride(0), b.stride(1), _CODES[a.dtype],
                            _CODES[out_dtype], stream)
    _build.check(lib, rc, "matmul kernel launch")
    count_launch("matmul_f32" if a.dtype == torch.float32
                 else "matmul_bf16")
    return c


def _product(a: torch.Tensor, b: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    if device_kind(a, b) == "cpu":
        return matmul_plain(a, b, out_dtype)
    return matmul_cuda(a, b, out_dtype)


class _MatMul(torch.autograd.Function):
    """Forward and both backward products through the same kernel
    (``_mm_fwd``/``_mm_bwd`` of the JAX op)."""

    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return _product(a, b, out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _product(g, b.t(), a.dtype)
        if ctx.needs_input_grad[1]:
            db = _product(a.t(), g, b.dtype)
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a @ b`` for 2-D ``a`` (M, K) and ``b`` (K, N) with f32
    accumulation; differentiable. CPU tensors take the plain version,
    CUDA tensors the kernel."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contracting dims differ: {a.shape[1]} vs "
                         f"{b.shape[0]}")
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return _MatMul.apply(a, b, out_dtype)
