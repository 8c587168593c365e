"""``a @ b`` with an f32 accumulator — the matmul kernel and its plain
version.

Port of ``lua_mapreduce_tpu/ops/matmul.py``: the Pallas ``_matmul_kernel``
becomes ``csrc/matmul.cu`` (a split-K scheduler over, in bf16, a
pipelined TMA + wgmma mainloop shared with q8, ``csrc/gemm_sm90.cuh``,
and a general kernel for layouts TMA cannot read; in f32, full FP32 FMA
kernels: 128-wide tiles fed by a cp.async ring, or a 64×64 tile for the
digits step's small products; its source note says what bounds it and
what the design does about it; :func:`matmul_kernel_plan` says which
kernel and split a product takes), and the custom VJP
``_mm_bwd`` becomes :class:`_MatMul`, whose backward runs dA = g·Bᵀ and
dB = Aᵀ·g through the same kernel. The transposes are stride views, not
copies: the kernel reads its operands through (row, col) strides.

Inputs are float32 or bfloat16 2-D tensors; the output defaults to the
promoted input dtype (``out_dtype`` overrides it). Operands of different
dtypes are cast to the promoted dtype before the kernel launch (one
copy of the narrower operand), which is what the JAX op computes too.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from lua_mapreduce_tpu_torch.ops import _build, count_launch, device_kind

_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the shortest tile of each dtype's kernels in csrc/matmul.cu (f32:
# F32_SMALL_TILE and F32_BM; bf16: BM): M rides grid.y in every kernel,
# so this bounds the rows any of them takes
_TILE_M = {torch.float32: 64, torch.bfloat16: 128}
_MAX_GRID_Y = 65535
# lmr_matmul_plan's codes: the kernel (csrc/matmul.cu's Path) and how a
# wide f32 kernel copies an operand's tiles (f32w::Copy: 16- or 8-byte
# pieces in place, elements along the tile's axis, elements along K)
KERNEL_NAMES = ("f32 64x64", "f32 128x128", "f32 128x64", "bf16 tma",
                "bf16 general")
COPY_NAMES = ("v16", "v8", "e4c", "e4k")
_SPLITS = {}    # lmr_matmul_splits' answers, by device, product and layout


def matmul_plain(a: torch.Tensor, b: torch.Tensor,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version: both operands widened to f32, one f32 product
    (f32 accumulation), one cast to ``out_dtype``."""
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


class MatmulPlan(NamedTuple):
    kernel: str              # a KERNEL_NAMES entry
    splits: int              # K split (1: none)
    chunk: int               # K units (16 f32, 64 bf16) per split
    a_copy: Optional[str]    # a COPY_NAMES entry for the wide f32 kernels
    b_copy: Optional[str]


def matmul_kernel_plan(a: torch.Tensor, b: torch.Tensor) -> MatmulPlan:
    """The kernel, split and copy modes ``csrc/matmul.cu`` takes for
    ``a @ b`` (CUDA tensors of one dtype) on their device."""
    lib = _build.library("matmul")
    plan = (ctypes.c_int * 5)()
    with torch.cuda.device(a.device):
        lib.lmr_matmul_plan(a.data_ptr(), b.data_ptr(), a.shape[0],
                            b.shape[1], a.shape[1], *a.stride(),
                            *b.stride(), _CODES[a.dtype], plan)
    if plan[1] < 1:
        raise RuntimeError("matmul kernel: the device could not be queried "
                           "for its split policy")
    return MatmulPlan(KERNEL_NAMES[plan[0]], plan[1], plan[2],
                      COPY_NAMES[plan[3]] if plan[3] >= 0 else None,
                      COPY_NAMES[plan[4]] if plan[4] >= 0 else None)


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
    if -(-m // _TILE_M[a.dtype]) > _MAX_GRID_Y:
        raise ValueError(f"matmul kernel: M={m} exceeds its grid limit "
                         f"({_MAX_GRID_Y * _TILE_M[a.dtype]} rows)")
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    lib = _build.library("matmul")
    code = _CODES[a.dtype]
    strides = (*a.stride(), *b.stride())
    with torch.cuda.device(a.device):
        # the K-split policy lives in csrc/matmul.cu (the layout picks the
        # kernel, the kernel the split); it says how much f32 scratch the
        # split needs. Its answer depends on the device, the shape, the
        # strides, the dtype and whether each operand is 16-byte aligned,
        # and is remembered here: a training step asks for the same few
        # dozen products again and again.
        key = (a.device.index, m, n, k, strides, a.data_ptr() % 16 == 0,
               b.data_ptr() % 16 == 0, code)
        splits = _SPLITS.get(key)
        if splits is None:
            splits = lib.lmr_matmul_splits(a.data_ptr(), b.data_ptr(), m, n,
                                           k, *strides, code)
            if splits < 1:
                raise RuntimeError("matmul kernel: the device could not be "
                                   "queried for its split policy")
            if len(_SPLITS) >= 4096:
                _SPLITS.clear()
            _SPLITS[key] = splits
        part = (torch.empty((splits, m, n), dtype=torch.float32,
                            device=a.device) if splits > 1 else None)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmr_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                            part.data_ptr() if part is not None else None,
                            m, n, k, *strides, code, _CODES[out_dtype],
                            stream)
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
