"""Row-wise log_softmax / softmax over the last axis — the kernel and
its plain versions.

Port of ``lua_mapreduce_tpu/ops/softmax.py``: the Pallas
``_log_softmax_kernel`` and ``_softmax_kernel`` become one CUDA source
with a mode flag (``csrc/softmax.cu``; its source note says what bounds
it and what the design does about it). Which of its three branches runs
(a warp per narrow row, a register-resident block per wide row, or a
streaming block past the register cap), with 16-byte or one-element
accesses, is :func:`softmax_plan`'s choice, a pure function that the C
entry point checks. All math is f32, the output is in the input dtype.
The backward passes stay analytic and elementwise in plain torch,
outside the kernel, as in the JAX op (softmax.py:94-95, 113-114):

    y = log_softmax(x):  dx = g − exp(y)·Σg
    y = softmax(x):      dx = y·(g − Σ(g·y))
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lua_mapreduce_tpu_torch.ops import (_build, alignment, count_launch,
                                        device_kind)

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODE_LOG_SOFTMAX = 0
_MODE_SOFTMAX = 1

# the kernels' instantiations, as csrc/softmax.cu defines them
BRANCHES = ("warp", "regs", "stream")
WARP_MAX_N = 1024
WARP_ROWS = 4
WARP_ELEMS = (1, 2, 4, 8, 16, 32)
REGS_ELEMS = (16, 32)
REGS_MAX_THREADS = 512
REGS_MAX_N = REGS_MAX_THREADS * REGS_ELEMS[-1]      # the register cap
STREAM_THREADS = 512
STREAM_LOADS = 4


class SoftmaxPlan(NamedTuple):
    """One launch of ``csrc/softmax.cu``: its branch, whether it makes
    16-byte accesses, the elements a thread holds (warp, regs) or the
    accesses it makes a step (stream), and the launch shape."""
    branch: str
    vector: bool
    per_thread: int
    threads: int
    rows_per_block: int
    blocks: int

    @property
    def name(self) -> str:
        return f"{self.branch}/{'v16' if self.vector else 'scalar'}"


def softmax_plan(rows: int, n: int, dtype: torch.dtype,
                 align: int) -> SoftmaxPlan:
    """The branch and launch shape for ``rows`` rows of ``n`` elements of
    ``dtype`` whose pointers and row pitches are ``align``-byte aligned
    (:func:`alignment`): a warp per row up to ``WARP_MAX_N``, a block
    holding its row in registers up to ``REGS_MAX_N``, a streaming block
    past it. 16-byte accesses where the rows allow them, else one
    element per access."""
    if dtype not in _CODES:
        raise TypeError(f"softmax kernel takes float32/bfloat16, got "
                        f"{dtype}")
    if rows < 1 or n < 1:
        raise ValueError(f"softmax plan needs rows, n >= 1, got {rows}, {n}")
    item = 4 if dtype == torch.float32 else 2
    vector = align >= 16 and (n * item) % 16 == 0
    width = 16 // item if vector else 1
    if n <= WARP_MAX_N:
        need = -(-n // 32)
        e = next(e for e in WARP_ELEMS if e >= max(need, width))
        return SoftmaxPlan("warp", vector, e, 32 * WARP_ROWS, WARP_ROWS,
                           -(-rows // WARP_ROWS))
    if n <= REGS_MAX_N:
        # 16 elements a thread while that takes at most 256 threads
        e = REGS_ELEMS[0] if n <= REGS_ELEMS[0] * 256 else REGS_ELEMS[1]
        threads = -(-n // (32 * e)) * 32
        return SoftmaxPlan("regs", vector, e, threads, 1, rows)
    return SoftmaxPlan("stream", vector, STREAM_LOADS, STREAM_THREADS, 1,
                       rows)


def _rows_view(x: torch.Tensor):
    """x as (rows, n) rows with unit column stride and a row pitch of at
    least n (one copy when it is not so), that pitch, and the plan for
    them (the output is a fresh allocation, 16-byte aligned)."""
    n = x.shape[-1]
    x2 = x.reshape(-1, n)
    rows = x2.shape[0]
    if (n > 1 and x2.stride(1) != 1) or (rows > 1 and x2.stride(0) < n):
        x2 = x2.contiguous()
    ldx = x2.stride(0) if rows > 1 else n
    plan = softmax_plan(rows, n, x.dtype,
                        alignment(x2.data_ptr(), ldx * x2.element_size()))
    return x2, ldx, plan


def softmax_kernel_plan(x: torch.Tensor) -> SoftmaxPlan:
    """The plan :func:`rowwise_softmax_cuda` launches for ``x``."""
    return _rows_view(x)[2]


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
    leading index, the reduction runs over the last axis. Rows with a
    unit column stride are read in place at their pitch (a view such as
    ``x[:, 1:]``); other layouts are made contiguous first (one copy)."""
    if x.dtype not in _CODES:
        raise TypeError(f"softmax kernel takes float32/bfloat16, got "
                        f"{x.dtype}")
    if x.dim() == 0:
        raise ValueError("softmax over the last axis needs at least 1-D")
    if x.numel() == 0:
        return torch.empty_like(x, memory_format=torch.contiguous_format)
    x2, ldx, plan = _rows_view(x)
    rows, n = x2.shape
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    lib = _build.library("softmax")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmr_softmax(x2.data_ptr(), y.data_ptr(), rows, n, ldx,
                             _CODES[x.dtype], mode,
                             BRANCHES.index(plan.branch), int(plan.vector),
                             plan.per_thread, plan.threads,
                             plan.rows_per_block, plan.blocks, stream)
    _build.check(lib, rc, f"softmax kernel launch ({plan.name})")
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
