"""Flash attention forward — the kernel and its plain version.

Port of the forward half of ``lua_mapreduce_tpu/ops/attention.py``: the
Pallas ``_flash_kernel_nolse`` and ``_flash_kernel`` become one CUDA
kernel with an lse flag (``csrc/flash.cu``; its source note says what
bounds it and what the design does about it). Layout is the JAX op's
public one, (B, L, H, D), read through strides by the kernel.

The backward (the FlashAttention-2 dq/dkv kernels) is not ported yet
(ROADMAP B5): :class:`_FlashForward`'s backward raises, so no gradient
ever flows through the plain version in its place.
"""

from __future__ import annotations

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


def flash_attention_cuda(q, k, v, *, causal: bool, window: int = 0,
                         q_offset: int = 0, with_lse: bool = False):
    """Launch ``csrc/flash.cu`` on CUDA tensors q (B, L, H, D) and k/v
    (B, L, H_kv, D) of one dtype (f32 or bf16), any batch/seq/head
    strides. Returns a contiguous (B, L, H, D) out — f32 when
    ``with_lse``, with the (B, L, H) f32 lse — else in the input dtype."""
    b, l, h, d = q.shape
    hkv = k.shape[2]
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32/bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {_HEAD_DIMS}, "
                         f"got {d}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"flash kernel: batch·heads = {b * h} exceeds "
                         f"its grid limit {_MAX_GRID_Y}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
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
            lse.data_ptr() if with_lse else None, b, l, h, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
            window, q_offset, _CODES[q.dtype], int(with_lse), stream)
    _build.check(lib, rc, "flash kernel launch")
    count_launch("flash_fwd")
    return (out, lse) if with_lse else out


class _FlashForward(torch.autograd.Function):
    """The forward through the kernel (CUDA) or the plain version (CPU);
    the backward is ROADMAP B5 and raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, with_lse):
        if device_kind(q, k, v) == "cpu":
            scale = 1.0 / float(q.shape[-1]) ** 0.5
            return flash_attention_plain(q, k, v, causal, scale,
                                         with_lse=with_lse, window=window,
                                         q_offset=q_offset)
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, with_lse=with_lse)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash_attention has no backward in the port yet: the "
            "FlashAttention-2 dq/dkv kernels are ROADMAP B5")


def flash_attention(q, k, v, *, causal: bool = False, window: int = 0,
                    q_offset: int = 0, return_lse: bool = False):
    """Exact softmax attention, (B, L, H, D) → (B, L, H, D).

    k/v may carry fewer heads than q (H_kv dividing H): q head ``h``
    attends kv head ``h // (H/H_kv)``. ``window`` > 0 (implies causal)
    hides keys more than window-1 positions back; ``q_offset`` (window
    only) shifts the query rows after the keys. ``return_lse=True`` also
    returns the per-row logsumexp (B, L, H) f32, and the out is then f32.

    CPU tensors take the plain version, CUDA tensors the kernel.
    Forward only: a backward through it raises (ROADMAP B5)."""
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
    return _FlashForward.apply(q, k, v, bool(causal), int(window),
                               int(q_offset), bool(return_lse))
