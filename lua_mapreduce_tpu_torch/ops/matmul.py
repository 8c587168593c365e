"""``a @ b`` with an f32 accumulator — the matmul kernel and its plain
version.

Port of ``lua_mapreduce_tpu/ops/matmul.py``: the Pallas ``_matmul_kernel``
becomes ``csrc/matmul.cu`` (a planner over, in bf16, a pipelined TMA +
wgmma mainloop, ``csrc/gemm_sm90.cuh``, with 64-, 128- or
256-wide tiles, a TMA-store epilogue and split-K summed inside a thread
block cluster, and a general wgmma kernel for layouts TMA cannot read;
in f32, full FP32 FMA kernels: 128-wide tiles fed by a cp.async ring, or
a 64×64 tile for the digits step's small products; its source note says
what bounds it and what the design does about it;
:func:`matmul_kernel_plan` says which kernel, tile, split, reduction and
epilogue a product takes, and :func:`bf16_plan` mirrors the bf16 cost
model), and the custom VJP
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
import math
from typing import NamedTuple, Optional, Sequence, Tuple

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
# the bf16 kernels' epilogues of an unsplit tile (gemm_sm90.cuh's Epi)
# and how the general kernel's tiles reach shared memory (bf16k::Mode)
EPI_NAMES = ("regs", "tma")
MODE_NAMES = ("vec_c", "vec_r", "scalar", "flat_c", "flat_r")
_SLABS = {}     # lmr_matmul_slab's answers, by device, product and layout

# csrc/matmul.cu's bf16 cost model (bf16_plan); the CPU tests read these
# from the source
BF16_PEAK_GFLOPS = 989000
WG_RATE_PCT = 60
WG64_RATE_PCT = 40
GEN_RATE_PCT = 40
HBM_GBS = 3000
REGS_STORE_GBS = 500
ITEM_NS = 2000
CTA_NS = 2000
CLUSTER_NS = 4000
GEN_STEP_NS = 500
SLAB_NS = 5000
WG_MAX_CLUSTER = 8
PATH_TMA, PATH_GENERAL = 3, 4


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
    # bf16 only (None for f32):
    tile: Optional[str] = None       # "128x64", "128x128" or "128x256"
    cluster: int = 1                 # CTAs of a cluster split (1: none)
    reduce: Optional[str] = None     # "none", "cluster" or "slab"
    epilogue: Optional[str] = None   # an unsplit tile's: "tma" or "regs"
    a_mode: Optional[str] = None     # the general kernel's MODE_NAMES
    b_mode: Optional[str] = None
    resident: int = 0                # general kernel's blocks an SM


def matmul_kernel_plan(a: torch.Tensor, b: torch.Tensor) -> MatmulPlan:
    """The kernel, split, copy modes and, in bf16, the tile, reduction
    and epilogue that ``csrc/matmul.cu`` takes for ``a @ b`` (CUDA
    tensors of one dtype) on their device."""
    lib = _build.library("matmul")
    plan = (ctypes.c_int * 11)()
    with torch.cuda.device(a.device):
        lib.lmr_matmul_plan_ex(a.data_ptr(), b.data_ptr(), a.shape[0],
                               b.shape[1], a.shape[1], *a.stride(),
                               *b.stride(), _CODES[a.dtype], plan)
    if plan[1] < 1:
        raise RuntimeError("matmul kernel: the device could not be queried "
                           "for its split policy")
    out = MatmulPlan(KERNEL_NAMES[plan[0]], plan[1], plan[2],
                     COPY_NAMES[plan[3]] if plan[3] >= 0 else None,
                     COPY_NAMES[plan[4]] if plan[4] >= 0 else None)
    if plan[5] < 0:
        return out
    reduce = ("none" if plan[1] == 1 else
              "cluster" if plan[6] > 1 else "slab")
    return out._replace(
        tile=f"128x{plan[5]}", cluster=plan[6], reduce=reduce,
        epilogue=EPI_NAMES[plan[7]] if plan[1] == 1 else None,
        a_mode=MODE_NAMES[plan[8]] if plan[8] >= 0 else None,
        b_mode=MODE_NAMES[plan[9]] if plan[9] >= 0 else None,
        resident=plan[10])


def matmul_cluster_sms() -> Tuple[int, ...]:
    """The SMs that clusters of 1 to WG_MAX_CLUSTER CTAs of the wgmma
    kernel can use on the current card, by size (the occupancy query
    ``bf16_plan`` reads; 0 where a size does not fit)."""
    lib = _build.library("matmul")
    out = (ctypes.c_int * WG_MAX_CLUSTER)()
    _build.check(lib, lib.lmr_matmul_cluster_sms(out), "matmul cluster query")
    return tuple(out)


class Bf16Plan(NamedTuple):
    splits: int
    chunk: int       # K units of 64 a split
    bn: int          # tile width
    cluster: int     # 1, or the split summed in a cluster
    epi: int         # an EPI_NAMES index


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bf16_plan(m: int, n: int, k: int, path: int, sms: int,
              cluster_sms: Sequence[int], gen_per_sm: int = 0) -> Bf16Plan:
    """Mirror of csrc/matmul.cu::bf16_plan (its note: the candidates and
    their costs), for the wgmma kernel (``path`` PATH_TMA) or the general
    one, on a card of ``sms`` SMs whose clusters of 1-8 CTAs can use
    ``cluster_sms[size - 1]`` SMs, with ``gen_per_sm`` blocks of the
    general kernel resident an SM. Every operation is the C++'s in its
    order, so the two agree exactly."""
    units = _cdiv(k, 64)
    peak, bw = BF16_PEAK_GFLOPS * 1e9, HBM_GBS * 1e9
    regs_bw = REGS_STORE_GBS * 1e9
    ab = (float(m) * k + float(k) * n) * 2 / bw
    c_bytes = float(m) * n * 2
    best = [Bf16Plan(1, units, 64 if n <= 64 else 128, 1, 0), 1e30]

    def consider(t, s, c, bn, cl, epi):
        if t < 0.97 * best[1]:
            best[:] = [Bf16Plan(s, c, bn, cl, epi), t]

    def splits():
        for s in range(1, min(units, 8 * sms) + 1):
            c = _cdiv(units, s)
            if _cdiv(units, c) == s:
                yield s, c
    if path != PATH_TMA:
        bn = 64 if n <= 64 else 128
        per = float(gen_per_sm) if gen_per_sm > 0 else 1.0
        tiles = float(_cdiv(m, 128) * _cdiv(n, bn))
        t_unit = 2.0 * 128 * bn * 64 * per / (
            peak * GEN_RATE_PCT / 100 / sms)
        t_unit = max(t_unit, GEN_STEP_NS * 1e-9)
        for s, c in splits():
            work = math.ceil(tiles * s / (sms * per)) * (
                c * t_unit + CTA_NS * 1e-9)
            mem = ab + c_bytes / regs_bw
            if s > 1:
                mem += 2.0 * s * m * n * 4 / bw
            t = max(work, mem)
            if s > 1:
                t += SLAB_NS * 1e-9
            consider(t, s, c, bn, 1, 0)
        return best[0]
    for bn in (256, 128, 64)[2 if n <= 64 else 1 if n <= 128 else 0:]:
        tiles = float(_cdiv(m, 128) * _cdiv(n, bn))
        t_mma = 2.0 * 128 * bn * 64 / (
            peak * (WG64_RATE_PCT if bn == 64 else WG_RATE_PCT) / 100 / sms)
        c_tma = bn <= 128 and n % 8 == 0
        for s, c in splits():
            work = c * t_mma + ITEM_NS * 1e-9
            if s == 1:
                mem = ab + c_bytes / (bw if c_tma else regs_bw)
                consider(max(math.ceil(tiles / sms) * work, mem), 1, c, bn,
                         1, 1 if c_tma else 0)
                continue
            if s <= WG_MAX_CLUSTER and cluster_sms[s - 1] > 0:
                t = math.ceil(tiles * s / cluster_sms[s - 1]) * (
                    work + CLUSTER_NS * 1e-9)
                consider(max(t, ab + c_bytes / bw), s, c, bn, s, 0)
            t = math.ceil(tiles * s / sms) * work
            mem = ab + c_bytes / bw + 2.0 * s * m * n * 4 / bw
            consider(max(t, mem) + SLAB_NS * 1e-9, s, c, bn, 1, 0)
    return best[0]


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
        # the plan lives in csrc/matmul.cu (the layout picks the kernel,
        # the kernel the split and how it is summed); it says how much
        # f32 scratch a slab split needs (a cluster split sums in the
        # kernel and needs none). Its answer depends on the device, the
        # shape, the strides, the dtype and whether each operand is
        # 16-byte aligned, and is remembered here: a training step asks
        # for the same few dozen products again and again.
        key = (a.device.index, m, n, k, strides, a.data_ptr() % 16 == 0,
               b.data_ptr() % 16 == 0, code)
        slab = _SLABS.get(key)
        if slab is None:
            slab = lib.lmr_matmul_slab(a.data_ptr(), b.data_ptr(), m, n, k,
                                       *strides, code)
            if slab < 0:
                raise RuntimeError("matmul kernel: the device could not be "
                                   "queried for its split policy")
            if len(_SLABS) >= 4096:
                _SLABS.clear()
            _SLABS[key] = slab
        part = (torch.empty((slab, m, n), dtype=torch.float32,
                            device=a.device) if slab > 0 else None)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmr_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                            part.data_ptr() if part is not None else None,
                            m, n, k, *strides, code, _CODES[out_dtype],
                            stream)
    _build.check(lib, rc, "matmul kernel launch")
    count_launch("matmul_f32" if a.dtype == torch.float32
                 else "matmul_bf16")
    return c


def matmul_forced(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype,
                  bn: int, splits: int, cluster: int = 1,
                  epilogue: str = "regs") -> torch.Tensor:
    """The wgmma kernel on bf16 CUDA operands TMA can read, at a given
    plan (``csrc/matmul.cu``'s ``lmr_matmul_forced``: tile width ``bn``,
    ``splits``, ``cluster`` 1 or the split, an unsplit tile's
    ``epilogue``), for the tests and for timing a plan the cost model
    does not pick. Raises on a plan the kernel cannot run."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError("matmul_forced takes bfloat16 operands")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    part = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=a.device)
            if splits > 1 and cluster == 1 else None)
    lib = _build.library("matmul")
    with torch.cuda.device(a.device):
        rc = lib.lmr_matmul_forced(
            a.data_ptr(), b.data_ptr(), c.data_ptr(),
            part.data_ptr() if part is not None else None, m, n, k,
            *a.stride(), *b.stride(), _CODES[out_dtype], bn, splits,
            cluster, EPI_NAMES.index(epilogue),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "matmul kernel launch at a forced plan")
    count_launch("matmul_bf16")
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
