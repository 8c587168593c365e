"""maxpool2d / avgpool2d over NHWC — the pool kernel and its plain
version.

Port of ``lua_mapreduce_tpu/ops/pool.py``: the Pallas ``_pool_kernel``
becomes ``csrc/pool.cu`` (one kernel template, max and avg modes; its
source note says what bounds it and what the design does about it).
Whether it runs its vector branch (16-byte chunks of a pixel's
channels) or its general one (bf16 pairs or single elements), and its
launch shape, is :func:`pool_plan`'s choice, a pure function that the C
entry point checks. ``_pool_plain``
is ``_pool_xla`` line for line: KH·KW strided slices combined with
``torch.maximum`` or ``+`` in the same order (i outer, j inner); avg
sums in the input dtype, then divides.

The backward is the gradient of ``_pool_plain`` on the saved input, on
either device, as ``_pool_p_bwd`` differentiates ``_pool_xla`` outside
any Pallas kernel; ``_pool_grad`` writes it out in closed form.
``F.max_pool2d``'s backward would differ: it routes a tied window's
whole gradient to one element, where ``torch.maximum`` (like ``lax.max``)
splits it equally between the tied operands.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lua_mapreduce_tpu_torch.ops import (_build, alignment, count_launch,
                                        device_kind)
from lua_mapreduce_tpu_torch.ops.conv import (_norm_stride, _sum_windows,
                                              _windows)

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"max": 0, "avg": 1}

# the kernel's limits, as csrc/pool.cu defines them
BRANCHES = ("vector", "general")
POOL_MAX_THREADS = 256
POOL_MAX_GRID_YZ = 65535
_INT32_MAX = 2 ** 31 - 1


class PoolPlan(NamedTuple):
    """One launch of ``csrc/pool.cu``: its branch, the elements of one
    access (16 bytes' worth, a bf16 pair or 1), the block (chunks of a
    pixel, output columns, output rows) and the grid (column tiles, row
    tiles, images)."""
    branch: str
    width: int
    block: Tuple[int, int, int]
    grid: Tuple[int, int, int]

    @property
    def name(self) -> str:
        return f"{self.branch}/w{self.width}"


def _split(extent: int, most: int) -> int:
    """A tile of at most ``most`` that covers ``extent`` in as few tiles
    as possible, as evenly as possible."""
    tiles = -(-extent // max(1, most))
    return -(-extent // tiles)


def pool_plan(n: int, h: int, w: int, c: int, window, stride,
              dtype: torch.dtype, align: int) -> PoolPlan:
    """The branch and launch shape for pooling an (n, h, w, c) NHWC
    tensor of ``dtype`` whose pointer is ``align``-byte aligned
    (:func:`alignment`; the output is a fresh allocation, 16-byte
    aligned, and the C entry point checks both): 16-byte chunks along C
    when a pixel is a whole number of them (bf16 C % 8 == 0, f32
    C % 4 == 0), else bf16 pairs (even C, 4-byte aligned) or single
    elements. One thread per (output pixel, chunk); the block takes the
    chunks of a pixel first, then output columns, then output rows."""
    if dtype not in _CODES:
        raise TypeError(f"pool kernel takes float32/bfloat16, got {dtype}")
    (kh, kw), (sh, sw) = window, stride
    if min(n, h, w, c, kh, kw, sh, sw) < 1 or kh > h or kw > w:
        raise ValueError(f"no VALID pooling of {(n, h, w, c)} by window "
                         f"{window}, stride {stride}")
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    if h * w * c > _INT32_MAX:
        raise ValueError(f"pool kernel indexes an image in 32 bits: "
                         f"{h}x{w}x{c} is too large")
    item = 4 if dtype == torch.float32 else 2
    if align >= 16 and (c * item) % 16 == 0:
        branch, width = "vector", 16 // item
    elif item == 2 and align >= 4 and c % 2 == 0:
        branch, width = "general", 2
    else:
        branch, width = "general", 1
    chunks = c // width
    bx = min(chunks, POOL_MAX_THREADS)
    by = _split(wo, POOL_MAX_THREADS // bx)
    bz = _split(ho, POOL_MAX_THREADS // (bx * by))
    grid = (-(-wo // by), -(-ho // bz), min(n, POOL_MAX_GRID_YZ))
    if grid[1] > POOL_MAX_GRID_YZ:
        raise ValueError(f"pool kernel grid: {ho} output rows are too many")
    return PoolPlan(branch, width, (bx, by, bz), grid)


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


def pool_kernel_plan(x: torch.Tensor, window, stride) -> PoolPlan:
    """The plan :func:`pool_cuda` launches for a contiguous ``x`` (its
    output is a fresh allocation, 16-byte aligned)."""
    return pool_plan(*x.shape, window, stride, x.dtype,
                     alignment(x.data_ptr()))


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
    plan = pool_kernel_plan(x, window, stride)
    lib = _build.library("pool")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmr_pool(x.data_ptr(), y.data_ptr(), n, h, w, c,
                          window[0], window[1], stride[0], stride[1],
                          _CODES[x.dtype], _MODES[mode],
                          BRANCHES.index(plan.branch), plan.width,
                          *plan.block, *plan.grid, stream)
    _build.check(lib, rc, f"pool kernel launch ({plan.name})")
    count_launch("pool")
    return y


def _pool_grad(x: torch.Tensor, g: torch.Tensor, window, stride,
               mode: str) -> torch.Tensor:
    """The gradient of ``_pool_plain`` at x for the output gradient g,
    without differentiating it op by op. avg: every window element gets
    g / (KH·KW). max: ``_pool_plain`` folds the window with pairwise
    maximums m_j = max(m_{j-1}, s_j), and ``torch.maximum`` (like
    ``lax.max``) sends a tied pair half the gradient each, so element j
    gets g times its share of step j (1 if it won, 1/2 on a tie, 0 if it
    lost; element 0 enters at step 1) times the shares the running
    maximum kept at every later step. The shares are powers of two, so
    the products are exact and equal the op-by-op autograd's. Windows
    are then summed back with ``F.fold``."""
    kh, kw = window
    sh, sw = stride
    ho, wo = _out_hw(x, window, stride)
    n, c = x.shape[0], x.shape[-1]
    if mode == "avg":
        gs = (g / (kh * kw))[:, :, :, None, None, :].expand(
            n, ho, wo, kh, kw, c)
        return _sum_windows(gs, x.shape, sh, sw)
    s = _windows(x, kh, kw, sh, sw, ho, wo).reshape(n, ho, wo, kh * kw, c)
    run = torch.cummax(s, dim=3).values[:, :, :, :-1]   # m_0 .. m_{K-2}
    nxt = s[:, :, :, 1:]                                # s_1 .. s_{K-1}
    tie = run == nxt
    won = torch.where(tie, 0.5, (nxt > run).to(g.dtype))      # s_j's share
    kept = torch.where(tie, 0.5, (run > nxt).to(g.dtype))     # m_{j-1}'s
    # the share the running maximum keeps from step j + 1 to the end
    later = torch.cat([kept.flip(3).cumprod(3).flip(3),
                       torch.ones_like(kept[:, :, :, :1])], dim=3)
    share = torch.cat([later[:, :, :, :1], won * later[:, :, :, 1:]], dim=3)
    gs = (g[:, :, :, None, :] * share).reshape(n, ho, wo, kh, kw, c)
    return _sum_windows(gs, x.shape, sh, sw)


class _Pool(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    ``_pool_grad``, the gradient of ``_pool_plain`` (``_pool_p_fwd``/
    ``_pool_p_bwd`` of the JAX op)."""

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
        return _pool_grad(x, g, *ctx.cfg), None, None, None


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
