"""Flash attention — the forward and backward kernels and their plain
versions.

Port of ``lua_mapreduce_tpu/ops/attention.py``: the Pallas
``_flash_kernel_nolse`` and ``_flash_kernel`` become ``csrc/flash.cu``
with an lse flag (a TMA + wgmma kernel for the layouts TMA can read, a
general kernel for the rest: :func:`flash_kernel_path`), and the
FlashAttention-2 backward ``_flash_bwd_dq_kernel`` /
``_flash_bwd_dkv_kernel`` become ``csrc/flash_bwd.cu``: at head dim 64,
for the layouts TMA can read, one kernel that forms all three
gradients in one pass (dq summed into an f32 workspace in a fixed
order, :func:`flash_bwd_plan`); at head dim 128 and for the other
layouts, a dq kernel and a dkv kernel (:func:`flash_bwd_kernel_path`);
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


# the TMA kernels' counters, one int32 buffer a (device, stream)
_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _item_counter(device, n: int = 1) -> torch.Tensor:
    """``n`` int32 holding 0 that a TMA kernel's walk counts in (each
    launch leaves them at 0 again): the forward's item counter, the
    one-pass backward's item counter and its tiles' partial counts. One
    buffer a (device, stream), made and zeroed on that stream and grown
    when a launch needs more, so that launches on one stream share it in
    order and launches on two streams never do. Under a CUDA graph
    capture fresh zeroed ints in the graph's memory, so that no graph
    shares them with launches outside it."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros((n,), device=device, dtype=torch.int32)
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(
            (max(n, 2 * buf.numel()) if buf is not None else n,),
            device=device, dtype=torch.int32)
    return buf[:n]


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
    """Which kernels of ``csrc/flash_bwd.cu`` the backward runs for these
    CUDA operands (``lmr_flash_bwd_path``, a predicate on their layout,
    as :func:`flash_kernel_path` is the forward's): ``"tma"`` (the TMA +
    wgmma kernels: bf16 q/k/v/do, 16-byte aligned bases, strides
    multiples of 8 elements; the one-pass kernel at head dim 64, the dq
    and dkv kernels at 128), ``"general"`` (the mma.sync kernels: other
    bf16 layouts) or ``"f32"``."""
    _check_bwd_operands(q, k, v, do, "flash backward kernel")
    q, k, v, do = _unit_stride(q, k, v, do)
    b, l, h, d = q.shape
    path = _build.library("flash_bwd").lmr_flash_bwd_path(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), b, l, h,
        k.shape[2], d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *do.stride()[:3], _CODES[q.dtype])
    return _PATHS[path]


# csrc/flash_bwd.cu's one-pass kernel (opk): items of FLASH_BWD_BK keys
# (a batch·kv head's key tile), steps of FLASH_BWD_BQ q rows, head dim
# FLASH_BWD_D; its dq workspace tile is FLASH_BWD_BQ × FLASH_BWD_D f32
FLASH_BWD_BK, FLASH_BWD_BQ, FLASH_BWD_D = 128, 64, 64
_LOG2E = 1.4426950408889634


class FlashBwdPlan(NamedTuple):
    """The one-pass kernel's schedule: ``grid`` persistent blocks (one
    an SM, at most one an item) take the nk·(B·H_kv) (batch·kv head, key
    tile) items one at a time from a counter, in walk order: the batch·kv
    heads in chunks of ``chunk`` (whose q, do, K and V fit in half the
    L2), within a chunk the key tiles last first, the chunk's batch·kv
    heads fastest."""
    grid: int
    chunk: int
    nk: int


def flash_bwd_plan(b: int, l: int, h: int, hkv: int, sms: int,
                   l2_bytes: int) -> FlashBwdPlan:
    """Mirror of csrc/flash_bwd.cu::opk::make_walk on a card of ``sms``
    SMs and ``l2_bytes`` of L2."""
    nk = -(-l // FLASH_BWD_BK)
    nbytes = (2 * (h // hkv) + 2) * l * FLASH_BWD_D * 2
    chunk = min(max(l2_bytes // 2 // nbytes, 1), b * hkv)
    return FlashBwdPlan(min(nk * b * hkv, sms), chunk, nk)


def flash_bwd_items(plan: FlashBwdPlan, bhk: int) -> List[Tuple[int, int]]:
    """The (batch·kv head, key tile) items in the order the blocks take
    them (``opk::walk_decode`` of item 0, 1, ...)."""
    per, out = plan.chunk * plan.nk, []
    for it in range(plan.nk * bhk):
        ch, rem = divmod(it, per)
        cw = min(plan.chunk, bhk - ch * plan.chunk)
        out.append((ch * plan.chunk + rem % cw, plan.nk - 1 - rem // cw))
    return out


def flash_bwd_q_tiles(kt: int, l: int, causal: bool, window: int,
                      q_offset: int) -> Tuple[int, int]:
    """The q tiles [lo, hi] of FLASH_BWD_BQ rows that key tile ``kt``
    (FLASH_BWD_BK keys) sees: csrc/flash_bwd.cu's ``q_range``, the JAX
    op's ``_q_clamp`` bounds (empty when hi < lo)."""
    lo, hi = 0, -(-l // FLASH_BWD_BQ) - 1
    k0 = kt * FLASH_BWD_BK
    if causal:
        lo = max((k0 - q_offset) // FLASH_BWD_BQ, 0)
    if window:
        hi = min((k0 + FLASH_BWD_BK - 2 + window - q_offset)
                 // FLASH_BWD_BQ, hi)
    return lo, hi


def flash_bwd_key_tiles(qt: int, l: int, causal: bool, window: int,
                        q_offset: int) -> Tuple[int, int]:
    """The key tiles [lo, hi] that q tile ``qt`` sees: csrc/flash_bwd.cu's
    ``kv_range``, the JAX op's ``_kv_clamp`` bounds. Its dq partials are
    summed from hi down to lo."""
    lo, hi = 0, -(-l // FLASH_BWD_BK) - 1
    row0 = qt * FLASH_BWD_BQ + q_offset
    if causal:
        hi = min((row0 + FLASH_BWD_BQ - 1) // FLASH_BWD_BK, hi)
    if window:
        first = row0 - window + 1
        lo = first // FLASH_BWD_BK if first > 0 else 0
    return lo, hi


def flash_bwd_steps(plan: FlashBwdPlan, b: int, l: int, h: int, hkv: int,
                    causal: bool, window: int, q_offset: int
                    ) -> List[Tuple[Tuple[int, int], List[Tuple[int, int,
                                                                int]]]]:
    """Each item of the walk with its steps, in the kernel's order (q
    tiles ascending, the group's q heads fastest): (q tile index
    (b·H + h)·nq + qt, the partials added before this one, the count it
    leaves: 0 after the last)."""
    nq, group = -(-l // FLASH_BWD_BQ), h // hkv
    out = []
    for bhk, kt in flash_bwd_items(plan, b * hkv):
        bb, hk = divmod(bhk, hkv)
        lo, hi = flash_bwd_q_tiles(kt, l, causal, window, q_offset)
        steps = []
        for qt in range(lo, hi + 1):
            klo, klast = flash_bwd_key_tiles(qt, l, causal, window, q_offset)
            for g in range(group):
                steps.append(((bb * h + hk * group + g) * nq + qt,
                              klast - kt, 0 if kt == klo else klast - kt + 1))
        out.append(((bhk, kt), steps))
    return out


def flash_bwd_kernel_plan(b: int, l: int, h: int, hkv: int) -> FlashBwdPlan:
    """The schedule csrc/flash_bwd.cu's one-pass kernel takes for these
    shapes on the current card (``lmr_flash_bwd_plan``), for holding
    against :func:`flash_bwd_plan`."""
    out = (ctypes.c_int * 3)()
    lib = _build.library("flash_bwd")
    _build.check(lib, lib.lmr_flash_bwd_plan(b, l, h, hkv,
                                             ctypes.addressof(out)),
                 f"flash backward plan for B={b}, L={l}, H={h}/{hkv}")
    return FlashBwdPlan(out[0], out[1], out[2])


# the one-pass kernel's decomposition modes (lmr_flash_bwd's mode)
FLASH_BWD_MODES = {"kernel": 0, "products": 1, "elementwise": 2,
                   "loads": 3}


def flash_bwd_rows_plain(o, lse, do, g_lse=None):
    """The one-pass kernel's rows in torch: (B, H, nq·64, 2) f32 holding
    {lse·log2(e), Δ·scale} for each (b, h, l), Δ = rowsum(do∘o) − g_lse in
    f32 from ``do`` as given, zero past L — the plain version of
    ``lmr_flash_bwd_prep``."""
    b, l, h, d = o.shape
    nq = -(-l // FLASH_BWD_BQ)
    rows = torch.zeros((b, h, nq * FLASH_BWD_BQ, 2), device=o.device,
                       dtype=torch.float32)
    rows[:, :, :l, 0] = lse.float().permute(0, 2, 1) * _LOG2E
    delta = (do.float() * o.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    rows[:, :, :l, 1] = delta.permute(0, 2, 1) * d ** -0.5
    return rows


def flash_bwd_q_tile_written(qt: int, l: int, causal: bool, window: int,
                            q_offset: int) -> bool:
    """Does a step of the one-pass kernel write q tile ``qt``'s dq?
    csrc/flash_bwd.cu's ``dq_written``: its last contributor (key tile
    ``lo`` of :func:`flash_bwd_key_tiles`) does where that key tile's q
    tiles include it; the others get the pre-pass's zeros."""
    klo, khi = flash_bwd_key_tiles(qt, l, causal, window, q_offset)
    if klo > khi:
        return False
    lo, hi = flash_bwd_q_tiles(klo, l, causal, window, q_offset)
    return lo <= qt <= hi


def flash_bwd_rows_cuda(o, lse, do, g_lse=None, dq=None, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """The one-pass kernel's rows through ``lmr_flash_bwd_prep`` (one
    pass over o and do; as :func:`flash_bwd_rows_plain`): o, lse and
    g_lse are read as contiguous f32, do as contiguous f32 or bf16. With
    ``dq`` (the one-pass launch's contiguous bf16 dq) the same pass
    zeroes the q tiles that launch will not write under this mask
    (:func:`flash_bwd_q_tile_written`)."""
    b, l, h, d = o.shape
    if d != FLASH_BWD_D:
        raise ValueError(f"flash_bwd_prep takes head dim {FLASH_BWD_D}, "
                         f"got {d}")
    nq = -(-l // FLASH_BWD_BQ)
    rows = torch.empty((b, h, nq * FLASH_BWD_BQ, 2), device=o.device,
                       dtype=torch.float32)
    if nq * FLASH_BWD_BQ > l:
        rows[:, :, l:].zero_()
    if do.dtype not in (torch.float32, torch.bfloat16):
        do = do.float()
    o, lse, do = (x.contiguous() for x in (o.float(), lse.float(), do))
    gl = None if g_lse is None else g_lse.float().contiguous()
    if dq is not None and (dq.dtype != torch.bfloat16 or dq.shape != o.shape
                           or not dq.is_contiguous()):
        raise TypeError("flash_bwd_prep: dq must be a contiguous bf16 "
                        f"{tuple(o.shape)} tensor")
    lib = _build.library("flash_bwd")
    with torch.cuda.device(o.device):
        rc = lib.lmr_flash_bwd_prep(
            o.data_ptr(), do.data_ptr(), lse.data_ptr(),
            None if gl is None else gl.data_ptr(), rows.data_ptr(),
            None if dq is None else dq.data_ptr(), b, l, h,
            nq * FLASH_BWD_BQ, int(causal), window, q_offset,
            _CODES[do.dtype], torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "flash_bwd_prep kernel launch")
    count_launch("flash_bwd_prep")
    return rows


def _one_pass(q, k, v, o, lse, do, dob, causal, window, q_offset, g_lse,
              mode: int):
    """The backward through the one-pass kernel: the rows' lse·log2(e)
    and Δ·scale (:func:`flash_bwd_rows_cuda`, Δ = rowsum(do∘o) − g_lse
    in f32 from ``do`` as given; the same pass zeroes the q tiles of dq
    no key tile sees), then one launch on ``dob`` (do in q's dtype),
    which writes dq, dk and dv through an f32 workspace of its own."""
    b, l, h, d = q.shape
    dq = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    rows = flash_bwd_rows_cuda(o, lse, do, g_lse, dq, causal=causal,
                               window=window, q_offset=q_offset)
    q, k, v, dob = _unit_stride(q, k, v, dob)
    tiles = b * h * -(-l // FLASH_BWD_BQ)
    ws = torch.empty((tiles * FLASH_BWD_BQ * d,), device=q.device,
                     dtype=torch.float32)
    dk = torch.empty(k.shape, device=k.device, dtype=k.dtype)
    dv = torch.empty(v.shape, device=v.device, dtype=v.dtype)
    ctr = _item_counter(q.device, 1 + tiles)
    lib = _build.library("flash_bwd")
    with torch.cuda.device(q.device):
        rc = lib.lmr_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dob.data_ptr(),
            rows.data_ptr(), ws.data_ptr(), dq.data_ptr(), ctr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, l, h, k.shape[2], d,
            *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *dob.stride()[:3], int(causal),
            window, q_offset, mode, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "flash_bwd kernel launch")
    count_launch("flash_bwd")
    return dq, dk, dv


def flash_bwd_forced(q, k, v, o, lse, do, *, causal: bool, window: int = 0,
                     q_offset: int = 0, mode: str = "kernel"):
    """The whole one-pass backward (bf16 CUDA operands TMA can describe,
    head dim 64) with its kernel in decomposition mode ``mode`` (a
    FLASH_BWD_MODES key: the kernel, its products alone with Pᵀ = Sᵀ and
    dSᵀ = dPᵀ, its elementwise part alone with no product issued, or its
    loads and dq sums alone; all but the first compute no gradient and
    are for timing): phase 2's decomposition. Raises on operands the
    kernel does not take."""
    dob = do.to(q.dtype)
    _check_bwd_operands(q, k, v, dob, "flash_bwd kernel")
    return _one_pass(q, k, v, o, lse, do, dob, causal, window, q_offset,
                     None, FLASH_BWD_MODES[mode])


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
    Returns a contiguous (B, L, H, D) dq in q's dtype. bf16 operands at
    head dim 64 that TMA can describe are refused: they take the one-pass
    kernel (:func:`flash_attention_bwd_cuda`)."""
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
    """The backward on the card, ``do`` cast once to q's dtype: for bf16
    at head dim 64 in a layout TMA can describe the rows' pre-pass and
    the one-pass kernel; else Δ = rowsum(do∘o) − g_lse in f32 from the
    f32 out (elementwise passes in torch, O(L·d), as the JAX package
    leaves it to XLA) and the dq and the dkv kernels. Returns (dq, dk,
    dv)."""
    dob = do.to(q.dtype)
    if q.shape[-1] == FLASH_BWD_D and \
            flash_bwd_kernel_path(q, k, v, dob) == "tma":
        return _one_pass(q, k, v, o, lse, do, dob, causal, window,
                         q_offset, g_lse, 0)
    delta = (do.float() * o.float()).sum(-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    delta = delta.contiguous()
    lse = lse.float().contiguous()
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    dq = flash_bwd_dq_cuda(q, k, v, dob, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, dob, lse, delta, **kw)
    return dq, dk, dv


class _FlashForward(torch.autograd.Function):
    """The forward through the kernel (CUDA) or the plain version (CPU).

    With ``needs_grad`` the forward runs the lse form and keeps the f32
    out and the lse as residuals (JAX ``_flash_fwd`` / ``_flash_lse_fwd``);
    without it, one launch of the form asked for. The backward takes a
    cotangent for out and, with ``with_lse``, for lse — either may be
    None — and runs the backward kernels (CUDA: :func:`flash_attention_
    bwd_cuda`) or the plain backward (CPU)."""

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
