"""Flash attention — the forward and backward kernels and their plain
versions.

Port of ``lua_mapreduce_tpu/ops/attention.py``: the Pallas
``_flash_kernel_nolse`` and ``_flash_kernel`` become ``csrc/flash.cu``
with an lse flag (a TMA + wgmma kernel for the layouts TMA can read, a
general kernel for the rest: :func:`flash_kernel_path`), and the
FlashAttention-2 backward ``_flash_bwd_dq_kernel`` /
``_flash_bwd_dkv_kernel`` become two CUDA kernels
(``csrc/flash_bwd.cu``: TMA + wgmma kernels for the layouts TMA can
read, general kernels for the rest: :func:`flash_bwd_kernel_path`);
each source's note says what bounds it and what the design does about
it. Layout is the JAX op's public one, (B, L, H, D), read through
strides by the kernels.

The autograd Function runs the forward with the lse kernel whenever a
gradient will be needed, keeping the f32 out and the lse as residuals,
and its backward takes a cotangent for both outputs, as the JAX op's
two ``custom_vjp`` pairs do. CPU tensors take the plain versions, CUDA
tensors the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from lua_mapreduce_tpu_torch.ops import _build, count_launch, device_kind

_NEG_INF = -1e30
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)           # csrc/flash.cu instantiations
_MAX_GRID_Y = 65535


def _tile_mask(rows, cols, causal: bool, window: int, seq_len: int,
               q_offset: int = 0):
    """Visibility of (row, col) score entries — the mask definition the
    kernel's column test and the plain version share. ``window`` > 0
    also hides keys more than window-1 positions behind the query;
    ``q_offset`` shifts the query rows after the key columns."""
    rows = rows + q_offset
    valid = cols < seq_len
    if causal:
        valid = valid & (rows >= cols)
    if window:
        valid = valid & (rows - cols < window)
    return valid


def flash_attention_plain(q, k, v, causal: bool, scale: float,
                          with_lse: bool = False, window: int = 0,
                          q_offset: int = 0):
    """The plain version (the JAX op's ``_attn_reference_xla``): f32
    scores, masked softmax, a row with no visible column gives 0.
    Returns the input dtype, or (f32 out, (B, L, H) f32 lse)."""
    group = q.shape[2] // k.shape[2]
    if group > 1:                   # GQA: each kv head serves a group
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    mask = None
    if causal or window:
        lq, lk = s.shape[-2], s.shape[-1]
        rows = torch.arange(lq, device=s.device)[:, None]
        cols = torch.arange(lk, device=s.device)[None, :]
        mask = _tile_mask(rows, cols, causal, window, lk, q_offset)
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    if mask is not None:
        p = torch.where(mask.any(dim=-1)[None, None, :, None], p, 0.0)
    out32 = torch.einsum("bhlm,bmhd->blhd", p, v.float())
    if not with_lse:
        return out32.to(q.dtype)
    lse = torch.logsumexp(s, dim=-1)                    # (B, H, L)
    return out32, lse.permute(0, 2, 1)                  # (B, L, H)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool,
                              window: int = 0, q_offset: int = 0,
                              g_lse=None, scale: Optional[float] = None):
    """The plain backward (the FA2 formulas of ``_bwd_tile`` in torch):
    Δ = rowsum(do∘o) − g_lse in f32 from the f32 out, p = exp(s − lse)
    where visible, ds = p∘(do·vᵀ − Δ)·scale, dq = ds·k, dk = dsᵀ·q,
    dv = pᵀ·do, summed over each kv head's group of q heads. ``do`` is
    cast to q's dtype before the products, and p and ds are rounded to
    it as product operands, as the TPU kernels do. ``lse`` and ``g_lse``
    are (B, L, H). Returns (dq, dk, dv) in q/k/v's dtypes. ``scale``
    (default 1/√d) exists for the smoke script's negative control."""
    b, l, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    scale = d ** -0.5 if scale is None else scale
    delta = (do.float() * o.float()).sum(-1)            # (B, L, H)
    if g_lse is not None:
        delta = delta - g_lse.float()
    do_c = do.to(q.dtype).float()
    kr = k.repeat_interleave(group, dim=2).float()
    vr = v.repeat_interleave(group, dim=2).float()
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), kr) * scale
    rows = torch.arange(l, device=q.device)[:, None]
    cols = torch.arange(l, device=q.device)[None, :]
    mask = _tile_mask(rows, cols, causal, window, l, q_offset)
    lse_t = lse.float().permute(0, 2, 1)[..., None]     # (B, H, L, 1)
    p = torch.where(mask, torch.exp(torch.where(mask, s - lse_t, 0.0)),
                    0.0)
    del s
    dp = torch.einsum("blhd,bmhd->bhlm", do_c, vr)
    ds = p * (dp - delta.permute(0, 2, 1)[..., None]) * scale
    del dp
    ds_c = ds.to(q.dtype).float()
    del ds
    dq = torch.einsum("bhlm,bmhd->blhd", ds_c, kr)
    dk = torch.einsum("bhlm,blhd->bmhd", ds_c, q.float())
    del ds_c
    dv = torch.einsum("bhlm,blhd->bmhd", p.to(q.dtype).float(), do_c)
    dk = dk.reshape(b, l, hkv, group, d).sum(3)
    dv = dv.reshape(b, l, hkv, group, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_kernel_operands(q, k, v, what: str) -> None:
    """What the forward and backward kernels take: f32 or bf16 operands
    of one dtype, head dims 64 or 128, batch·heads within the grid."""
    b, _, h, d = q.shape
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes float32/bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what} takes head dims {_HEAD_DIMS}, got {d}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"{what}: batch·heads = {b * h} exceeds its grid "
                         f"limit {_MAX_GRID_Y}")


def _unit_stride(*xs):
    return tuple(x if x.stride(-1) == 1 else x.contiguous() for x in xs)


_PATHS = {0: "general", 1: "tma", 2: "f32"}

# csrc/flash.cu's TMA kernel: q tiles of FLASH_BQ rows; the host orders at
# most FLASH_ORDER_MAX of them (wsk::ORDER_MAX)
FLASH_BQ, FLASH_ORDER_MAX = 128, 1024


class FlashPlan(NamedTuple):
    """The TMA kernel's schedule: ``grid`` persistent blocks (one an SM,
    at most one an item) take the nq·(B·H) (batch·head, q tile) items one
    at a time from a counter, in walk order: the batch·heads in chunks of
    ``chunk`` (whose K and V fit in half the L2), within a chunk by rank
    with the chunk's batch·heads fastest; ``order[r]`` is the q tile of
    rank r and ``live[q]`` the kv tiles of ``kv_tile`` keys q tile q
    sees."""
    grid: int
    chunk: int
    order: Tuple[int, ...]
    live: Tuple[int, ...]
    kv_tile: int


def flash_kv_tile(d: int) -> int:
    """The TMA kernel's kv tile (``wsk::kv_tile``): 128 keys at head dim
    64, 64 at 128."""
    return 128 if d == 64 else 64


def flash_live_tiles(row0: int, rows: int, bk: int, seq_len: int,
                     causal: bool, window: int) -> int:
    """How many kv tiles of ``bk`` keys the q rows [row0, row0 + rows)
    (offset rows) see: csrc/flash.cu's ``live_range`` bounds, the JAX
    op's ``_tile_live`` algebra."""
    hi = -(-seq_len // bk) - 1
    lo = 0
    if causal:
        hi = min((row0 + rows - 1) // bk, hi)
    if window:
        first = row0 - window + 1
        lo = first // bk if first > 0 else 0
    return hi - lo + 1 if hi >= lo else 0


def flash_plan(b: int, l: int, h: int, hkv: int, d: int, causal: bool,
               window: int, q_offset: int, sms: int,
               l2_bytes: int) -> FlashPlan:
    """Mirror of csrc/flash.cu::wsk::make_walk on a card of ``sms`` SMs
    and ``l2_bytes`` of L2: batch·heads in chunks whose K and V (a q
    head's share of its kv head's, bf16) fit in half the L2; the q tiles
    heaviest first by live kv tiles, a later tile first among equals
    (descending tiles past FLASH_ORDER_MAX of them); a grid of
    min(items, sms) blocks."""
    bk = flash_kv_tile(d)
    nq = -(-l // FLASH_BQ)
    live = tuple(flash_live_tiles(q * FLASH_BQ + q_offset, FLASH_BQ, bk, l,
                                  causal, window) for q in range(nq))
    if nq <= FLASH_ORDER_MAX:
        order = tuple(sorted(range(nq), key=lambda q: (-live[q], -q)))
    else:
        order = tuple(range(nq - 1, -1, -1))
    kv = l * d * 4 // (h // hkv)
    chunk = min(max(l2_bytes // 2 // kv, 1), b * h)
    return FlashPlan(min(nq * b * h, sms), chunk, order, live, bk)


def flash_items(plan: FlashPlan, bh: int) -> List[Tuple[int, int]]:
    """The (batch·head, q tile) items in the order the blocks take them
    (``wsk::walk_decode`` of item 0, 1, ...)."""
    nq, out = len(plan.order), []
    per = plan.chunk * nq
    for it in range(nq * bh):
        ch, rem = divmod(it, per)
        cw = min(plan.chunk, bh - ch * plan.chunk)
        out.append((ch * plan.chunk + rem % cw, plan.order[rem // cw]))
    return out


def flash_kernel_plan(b: int, l: int, h: int, hkv: int, d: int,
                      causal: bool, window: int = 0,
                      q_offset: int = 0) -> FlashPlan:
    """The schedule csrc/flash.cu's TMA kernel takes for these shapes on
    the current card (``lmr_flash_plan``), for holding against
    :func:`flash_plan`."""
    nq = -(-l // FLASH_BQ)
    out = (ctypes.c_int * (3 + nq))()
    lib = _build.library("flash")
    _build.check(lib, lib.lmr_flash_plan(b, l, h, hkv, d, int(causal),
                                         window, q_offset,
                                         ctypes.addressof(out), nq),
                 f"flash plan for B={b}, L={l}, H={h}/{hkv}, D={d}")
    bk = flash_kv_tile(d)
    live = tuple(flash_live_tiles(q * FLASH_BQ + q_offset, FLASH_BQ, bk, l,
                                  causal, window) for q in range(nq))
    return FlashPlan(out[0], out[1], tuple(out[3:3 + nq]), live, bk)


# the TMA kernel's item counters, one int32 a (device, stream)
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _item_counter(device) -> torch.Tensor:
    """The int32 that the TMA kernel's walk counts its items in, holding
    0 (each launch leaves it at 0 again): one a (device, stream), made
    once and zeroed on that stream, so that launches on one stream share
    it in order and launches on two streams never do. Under a CUDA graph
    capture a fresh zeroed int in the graph's memory, so that no graph
    shares an int with launches outside it."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros((1,), device=device, dtype=torch.int32)
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    counter = _COUNTERS.get(key)
    if counter is None:
        counter = _COUNTERS[key] = torch.zeros((1,), device=device,
                                               dtype=torch.int32)
    return counter


def flash_kernel_path(q, k, v) -> str:
    """Which kernel of ``csrc/flash.cu`` :func:`flash_attention_cuda`
    runs for these CUDA operands (``lmr_flash_path``, a predicate on
    their layout): ``"tma"`` (the TMA + wgmma kernel: bf16, 16-byte
    aligned bases, strides multiples of 8 elements), ``"general"`` (the
    mma.sync kernel: other bf16 layouts) or ``"f32"``."""
    _check_kernel_operands(q, k, v, "flash kernel")
    q, k, v = _unit_stride(q, k, v)
    b, l, h, d = q.shape
    path = _build.library("flash").lmr_flash_path(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), b, l, h, k.shape[2], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], _CODES[q.dtype])
    return _PATHS[path]


def flash_attention_cuda(q, k, v, *, causal: bool, window: int = 0,
                         q_offset: int = 0, with_lse: bool = False):
    """Launch ``csrc/flash.cu`` on CUDA tensors q (B, L, H, D) and k/v
    (B, L, H_kv, D) of one dtype (f32 or bf16), any batch/seq/head
    strides. Returns a contiguous (B, L, H, D) out — f32 when
    ``with_lse``, with the (B, L, H) f32 lse — else in the input dtype."""
    b, l, h, d = q.shape
    hkv = k.shape[2]
    _check_kernel_operands(q, k, v, "flash kernel")
    q, k, v = _unit_stride(q, k, v)
    out = torch.empty((b, l, h, d), device=q.device,
                      dtype=torch.float32 if with_lse else q.dtype)
    lse = (torch.empty((b, l, h), device=q.device, dtype=torch.float32)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    lib = _build.library("flash")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmr_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            _item_counter(q.device).data_ptr(), b, l, h, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
            window, q_offset, _CODES[q.dtype], int(with_lse), stream)
    _build.check(lib, rc, "flash kernel launch")
    count_launch("flash_fwd")
    return (out, lse) if with_lse else out


# the decomposition modes of lmr_flash_fwd_forced
FLASH_MODES = {"kernel": 0, "products": 1, "softmax": 2, "loads": 3}


def flash_forced(q, k, v, *, causal: bool, window: int = 0,
                 q_offset: int = 0, mode: str = "kernel"):
    """The TMA + wgmma kernel at head dim 64 without the lse, on bf16
    CUDA operands TMA can describe, in decomposition mode ``mode`` (a
    FLASH_MODES key: the kernel, its products alone with P = S, its
    softmax alone with no product issued, or its loads alone; all but
    the first compute no attention and are for timing): phase 2's
    decomposition. Raises on operands the kernel does not take."""
    b, l, h, d = q.shape
    _check_kernel_operands(q, k, v, "flash kernel")
    out = torch.empty((b, l, h, d), device=q.device, dtype=q.dtype)
    lib = _build.library("flash")
    with torch.cuda.device(q.device):
        rc = lib.lmr_flash_fwd_forced(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _item_counter(q.device).data_ptr(), b, l, h, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
            window, q_offset, FLASH_MODES[mode],
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, f"flash kernel launch ({mode})")
    count_launch("flash_fwd")
    return out


def _check_bwd_operands(q, k, v, do, what: str) -> None:
    """The forward's operand checks, and ``do`` in q's dtype and shape."""
    _check_kernel_operands(q, k, v, what)
    if do.dtype != q.dtype or do.shape != q.shape:
        raise TypeError(f"{what}: do must be {q.dtype} {tuple(q.shape)}, "
                        f"got {do.dtype} {tuple(do.shape)}")


def flash_bwd_kernel_path(q, k, v, do) -> str:
    """Which kernels of ``csrc/flash_bwd.cu`` the dq and dkv launches
    run for these CUDA operands (``lmr_flash_bwd_path``, a predicate on
    their layout, as :func:`flash_kernel_path` is the forward's):
    ``"tma"`` (the TMA + wgmma kernels: bf16 q/k/v/do, 16-byte aligned
    bases, strides multiples of 8 elements), ``"general"`` (the mma.sync
    kernels: other bf16 layouts) or ``"f32"``."""
    _check_bwd_operands(q, k, v, do, "flash backward kernel")
    q, k, v, do = _unit_stride(q, k, v, do)
    b, l, h, d = q.shape
    path = _build.library("flash_bwd").lmr_flash_bwd_path(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), b, l, h,
        k.shape[2], d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *do.stride()[:3], _CODES[q.dtype])
    return _PATHS[path]


def _bwd_launch(entry: str, kernel: str, q, k, v, do, lse, delta, outs,
                causal, window, q_offset):
    """One backward kernel of ``csrc/flash_bwd.cu``: q/k/v/do through
    their strides, lse and Δ contiguous (B, L, H) f32, ``outs``
    contiguous in q's dtype."""
    b, l, h, d = q.shape
    _check_bwd_operands(q, k, v, do, f"{kernel} kernel")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or x.shape != (b, l, h) or \
                not x.is_contiguous():
            raise TypeError(f"{kernel} kernel: {name} must be a contiguous "
                            f"(B, L, H) float32 tensor")
    q, k, v, do = _unit_stride(q, k, v, do)
    if outs[0].numel() == 0:
        return
    lib = _build.library("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            *(x.data_ptr() for x in outs), *((None,) * (2 - len(outs))),
            b, l, h, k.shape[2], d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *do.stride()[:3], int(causal), window,
            q_offset, _CODES[q.dtype], stream)
    _build.check(lib, rc, f"{kernel} kernel launch")
    count_launch(kernel)


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, *, causal: bool,
                      window: int = 0, q_offset: int = 0):
    """dq through the dq kernel: ``do`` in q's dtype, ``lse`` and Δ
    (with the lse cotangent already folded in) contiguous (B, L, H) f32.
    Returns a contiguous (B, L, H, D) dq in q's dtype."""
    dq = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    _bwd_launch("lmr_flash_bwd_dq", "flash_bwd_dq", q, k, v, do, lse, delta,
                (dq,), causal, window, q_offset)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool,
                       window: int = 0, q_offset: int = 0):
    """(dk, dv) through the dkv kernel, operands as
    :func:`flash_bwd_dq_cuda`'s. Returns contiguous (B, L, H_kv, D)
    tensors in k's dtype."""
    dk = torch.empty(k.shape, device=k.device, dtype=k.dtype)
    dv = torch.empty(v.shape, device=v.device, dtype=v.dtype)
    _bwd_launch("lmr_flash_bwd_dkv", "flash_bwd_dkv", q, k, v, do, lse,
                delta, (dk, dv), causal, window, q_offset)
    return dk, dv


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool,
                             window: int = 0, q_offset: int = 0,
                             g_lse=None):
    """The backward on the card: Δ = rowsum(do∘o) − g_lse in f32 from
    the f32 out (one elementwise pass in torch, O(L·d), as the JAX
    package leaves it to XLA), ``do`` cast to q's dtype, then the dq and
    the dkv kernels. Returns (dq, dk, dv)."""
    delta = (do.float() * o.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.contiguous()
    lse = lse.float().contiguous()
    do = do.to(q.dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class _FlashForward(torch.autograd.Function):
    """The forward through the kernel (CUDA) or the plain version (CPU).

    With ``needs_grad`` the forward runs the lse form and keeps the f32
    out and the lse as residuals (JAX ``_flash_fwd`` / ``_flash_lse_fwd``);
    without it, one launch of the form asked for. The backward takes a
    cotangent for out and, with ``with_lse``, for lse — either may be
    None — and runs the dq/dkv kernels (CUDA) or the plain backward
    (CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, with_lse,
                needs_grad):
        cpu = device_kind(q, k, v) == "cpu"

        def fwd(lse_form):
            if cpu:
                return flash_attention_plain(
                    q, k, v, causal, 1.0 / float(q.shape[-1]) ** 0.5,
                    with_lse=lse_form, window=window, q_offset=q_offset)
            return flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        with_lse=lse_form)
        if not needs_grad:
            return fwd(with_lse)
        out32, lse = fwd(True)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.set_materialize_grads(False)
        ctx.cfg = (causal, window, q_offset, with_lse, cpu)
        if with_lse:
            return out32, lse
        return out32.to(q.dtype)

    @staticmethod
    def backward(ctx, g_out, g_lse=None):
        causal, window, q_offset, with_lse, cpu = ctx.cfg
        q, k, v, out32, lse = ctx.saved_tensors
        if g_out is None and g_lse is None:
            return (None,) * 8
        if g_out is None:
            g_out = torch.zeros_like(out32)
        bwd = flash_attention_bwd_plain if cpu else flash_attention_bwd_cuda
        dq, dk, dv = bwd(q, k, v, out32, lse, g_out, causal, window=window,
                         q_offset=q_offset, g_lse=g_lse)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = False, window: int = 0,
                    q_offset: int = 0, return_lse: bool = False):
    """Exact softmax attention, (B, L, H, D) → (B, L, H, D).

    k/v may carry fewer heads than q (H_kv dividing H): q head ``h``
    attends kv head ``h // (H/H_kv)``. ``window`` > 0 (implies causal)
    hides keys more than window-1 positions back; ``q_offset`` (window
    only) shifts the query rows after the keys. ``return_lse=True`` also
    returns the per-row logsumexp (B, L, H) f32, and the out is then f32.

    Differentiable through both outputs. CPU tensors take the plain
    versions, CUDA tensors the kernels (forward; dq and dkv in the
    backward); a gradient is prepared for when grad mode is on and q, k
    or v requires one."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes (B, L, H, D) operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if window:
        if not causal:
            raise ValueError("sliding window (window > 0) implies "
                             "causal attention")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if q_offset:
        if not window:
            raise ValueError("q_offset only applies to windowed "
                             "attention (the banded-ring case)")
        if q_offset < 0:
            raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if (q.shape[0], q.shape[1], q.shape[3]) != \
            (k.shape[0], k.shape[1], k.shape[3]):
        raise ValueError(f"q/k shapes incompatible: {tuple(q.shape)} vs "
                         f"{tuple(k.shape)} (batch, seq, head_dim must "
                         f"match)")
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"GQA needs q heads divisible by kv heads: {q.shape[2]} "
            f"vs {k.shape[2]}")
    dt = torch.promote_types(q.dtype, torch.promote_types(k.dtype, v.dtype))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    return _FlashForward.apply(q, k, v, bool(causal), int(window),
                               int(q_offset), bool(return_lse), needs_grad)
