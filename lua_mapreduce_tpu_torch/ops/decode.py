"""Decode attention — one query position against the KV cache: the
kernel and its plain version.

Port of ``lua_mapreduce_tpu/ops/decode.py``: the Pallas
``_decode_kernel`` becomes ``csrc/decode.cu``, a split-S kernel and a
combine that merges the splits in a fixed order (its source note says
what bounds it and what the design does about it). Caches are held as
(B, H_kv, S, D), per-(batch, head) rows contiguous — the layout
``models/transformer.py``'s ``greedy_decode`` owns. The current
position ``t`` is a Python int or a 0-d integer tensor on the operands'
device; the kernel reads it from device memory (an int becomes a device
scalar by one fill kernel, never a host→device copy), so a decode step
captured in a CUDA graph is replayed at every position with no host
round trip.
"""

from __future__ import annotations

import operator

import torch

from lua_mapreduce_tpu_torch.ops import _build, count_launch, device_kind
from lua_mapreduce_tpu_torch.ops.attention import _tile_mask

_NEG_INF = -1e30
_KINDS = {torch.float32: 0, torch.bfloat16: 1}      # csrc/decode.cu kinds
_KIND_BF16_INT8 = 2
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)
_SPLITS = {}    # lmr_decode_splits' answers, by device and shape


def quantize_kv(x):
    """Per-row symmetric int8 quantization of cache rows: ``x``
    (..., D) → (int8 rows, f32 scales (...,)), scale = amax/127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def decode_attention_plain(q, k, v, t, roll: bool, k_scale=None,
                           v_scale=None):
    """The plain version (the JAX op's ``_decode_xla``): f32 scores over
    the visible slots, softmax, p rounded to the value dtype (bf16 when
    the cache is int8, after the v scale folds in) before an f32 value
    product. ``t`` is an int or a 0-d integer tensor. Returns f32
    (B, H_kv, G, D)."""
    d = q.shape[-1]
    s_len = k.shape[2]
    if k_scale is None:
        # bf16 products are exact in f32: this is the f32 accumulation
        s = torch.einsum("bkgd,bkmd->bkgm", q.float(), k.float())
    else:
        s = torch.einsum("bkgd,bkmd->bkgm", q.to(torch.bfloat16).float(),
                         k.to(torch.bfloat16).float())
        s = s * k_scale[:, :, None, :]
    s = s / torch.sqrt(torch.tensor(float(d)))
    seen = torch.arange(s_len, device=s.device)[None, None, None, :]
    if roll:
        vis = (seen <= t) | (t >= s_len)
    else:
        vis = _tile_mask(t, seen, True, 0, s_len)
    s = torch.where(vis, s, _NEG_INF)
    w = torch.softmax(s, dim=-1)
    if v_scale is None:
        return torch.einsum("bkgm,bkmd->bkgd", w.to(v.dtype).float(),
                            v.float())
    w = (w * v_scale[:, :, None, :]).to(torch.bfloat16)
    return torch.einsum("bkgm,bkmd->bkgd", w.float(),
                        v.to(torch.bfloat16).float())


def _decode_partial_plain(q, k, v, lo: int, hi: int, k_scale=None,
                          v_scale=None):
    """One split's state over the visible positions [lo, hi), as the
    split kernel forms it: f32 scores (scaled as ``decode_attention_
    plain`` scales them), m their max, p = exp(s − m) unnormalised, l =
    Σ p in f32, acc = Σ p·v with p rounded as the plain version rounds
    its weights. Returns m, l (B, H_kv, G) and acc (B, H_kv, G, D); an
    empty range gives the empty state (−1e30, 0, 0)."""
    b, hkv, g, d = q.shape
    if hi <= lo:
        return (torch.full((b, hkv, g), _NEG_INF, device=q.device),
                torch.zeros((b, hkv, g), device=q.device),
                torch.zeros((b, hkv, g, d), device=q.device))
    k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    if k_scale is None:
        s = torch.einsum("bkgd,bkmd->bkgm", q.float(), k.float())
    else:
        s = torch.einsum("bkgd,bkmd->bkgm", q.to(torch.bfloat16).float(),
                         k.to(torch.bfloat16).float())
        s = s * k_scale[:, :, None, lo:hi]
    s = s / torch.sqrt(torch.tensor(float(d)))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    if v_scale is None:
        w, vv = p.to(v.dtype).float(), v.float()
    else:
        w = (p * v_scale[:, :, None, lo:hi]).to(torch.bfloat16).float()
        vv = v.to(torch.bfloat16).float()
    return m, p.sum(-1), torch.einsum("bkgm,bkmd->bkgd", w, vv)


def _merge_splits_plain(m, l, acc):
    """The plain version of the combine: splits' states m, l (R, n, G)
    and acc (R, n, G, D) merged as M = max mₛ, L = Σ lₛ·e^(mₛ−M), O =
    Σ accₛ·e^(mₛ−M) / max(L, 1e-30). Returns f32 (R, G, D)."""
    m, l, acc = m.float(), l.float(), acc.float()
    f = torch.exp(m - m.amax(1, keepdim=True))
    return (acc * f[..., None]).sum(1) / (l * f).sum(1).clamp_min(
        1e-30)[..., None]


def _aligned(x):
    """``x`` contiguous with a 16-byte aligned base (the kernel's vector
    loads); copies only a tensor that is not."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _device_position(t, device) -> torch.Tensor:
    """``t`` as the 0-d int64 tensor on ``device`` the kernel reads: an
    int through one fill kernel (no host→device copy, so it can be
    captured), a tensor as it is (converted only if its dtype differs)."""
    if isinstance(t, torch.Tensor):
        return t if t.dtype == torch.int64 else t.to(torch.int64)
    return torch.full((), t, dtype=torch.int64, device=device)


def decode_attention_cuda(q, k, v, t, roll: bool, k_scale=None,
                          v_scale=None):
    """Launch ``csrc/decode.cu`` on CUDA tensors. q (B, H_kv, G, D) any
    strides with a contiguous head dim; k/v (B, H_kv, S, D) f32/bf16, or
    int8 with f32 (B, H_kv, S) scales; ``t`` an int or a 0-d integer
    tensor on the card. Returns f32 (B, H_kv, G, D)."""
    b, hkv, g, d = q.shape
    s_len = k.shape[2]
    if k_scale is not None:
        if k.dtype != torch.int8 or v.dtype != torch.int8:
            raise TypeError(f"scaled decode takes int8 k/v, got {k.dtype}, "
                            f"{v.dtype}")
        kind = _KIND_BF16_INT8
        q = q.to(torch.bfloat16)
        k_scale = _aligned(k_scale.float())
        v_scale = _aligned(v_scale.float())
    else:
        dt = torch.promote_types(q.dtype,
                                 torch.promote_types(k.dtype, v.dtype))
        if dt not in _KINDS:
            raise TypeError(f"decode kernel takes float32/bfloat16 caches "
                            f"(or int8 with scales), got {dt}")
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        kind = _KINDS[dt]
    if d not in _HEAD_DIMS:
        raise ValueError(f"decode kernel takes head dims {_HEAD_DIMS}, "
                         f"got {d}")
    if g not in _GROUPS:
        raise ValueError(f"decode kernel takes query groups {_GROUPS} per "
                         f"kv head, got {g}")
    if q.stride(-1) != 1:
        q = q.contiguous()
    k, v = _aligned(k), _aligned(v)
    t = _device_position(t, q.device)
    out = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = _build.library("decode")
    with torch.cuda.device(q.device):
        # the split policy lives in csrc/decode.cu, from the capacity
        # s_len (never t); the wrapper only sizes the splits' scratch
        n_split = decode_splits(b * hkv, s_len, d, g, kind)
        scratch = [None] * 3
        if n_split > 1:
            rows = b * hkv
            scratch = [torch.empty((rows, n_split, g), dtype=torch.float32,
                                   device=q.device) for _ in range(2)]
            scratch.append(torch.empty((rows, n_split, g, d),
                                       dtype=torch.float32, device=q.device))
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmr_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr() if k_scale is not None else None,
            v_scale.data_ptr() if v_scale is not None else None,
            out.data_ptr(),
            *(x.data_ptr() if x is not None else None for x in scratch),
            t.data_ptr(), int(roll), b, hkv, g, d, s_len, *q.stride()[:3],
            kind, stream)
    _build.check(lib, rc, "decode kernel launch")
    count_launch("decode")
    return out


def decode_splits(rows: int, s_len: int, d: int, g: int, kind: int) -> int:
    """How many splits ``csrc/decode.cu`` cuts each (batch, kv-head)
    row's cache into on the current device (``lmr_decode_splits``), for
    ``rows`` = B·H_kv, capacity ``s_len``, head dim ``d``, ``g`` query
    heads per kv head and the cache kind. Remembered per device."""
    key = (torch.cuda.current_device(), rows, s_len, d, g, kind)
    n = _SPLITS.get(key)
    if n is None:
        n = _build.library("decode").lmr_decode_splits(rows, s_len, d, g,
                                                       kind)
        if n < 1:
            raise RuntimeError(f"decode kernel: no split policy for rows "
                               f"{rows}, S {s_len}, d {d}, G {g}, kind "
                               f"{kind} on this device")
        _SPLITS[key] = n
    return n


def merge_splits_cuda(m, l, acc):
    """The combine kernel of ``csrc/decode.cu`` alone, on CUDA split
    states laid out as the decode kernel writes them: m, l (R, n, G) and
    acc (R, n, G, D) f32. Returns f32 (R, G, D)."""
    rows, n_split, g, d = acc.shape
    if m.shape != (rows, n_split, g) or l.shape != m.shape:
        raise ValueError(f"split states (R, n, G) and (R, n, G, D) "
                         f"expected, got {tuple(m.shape)}, "
                         f"{tuple(l.shape)}, {tuple(acc.shape)}")
    m, l, acc = (x.float().contiguous() for x in (m, l, acc))
    out = torch.empty((rows, g, d), dtype=torch.float32, device=acc.device)
    lib = _build.library("decode")
    with torch.cuda.device(acc.device):
        rc = lib.lmr_decode_combine(
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(), rows,
            n_split, g, d, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "decode combine kernel launch")
    count_launch("decode")
    return out


def decode_attention(q, k, v, t, *, roll: bool = False, k_scale=None,
                     v_scale=None):
    """One decode position's attention against the KV cache.

    q: (B, H_kv, G, D) — the G query heads grouped under each kv head;
    k, v: (B, H_kv, S, D) caches; ``t``: the current position, a Python
    int or a 0-d integer tensor on the operands' device (what a captured
    decode step passes). Slots with index > t are invisible unless
    ``roll`` and the rolling cache is full. For an int8 cache pass ``k_scale``/``v_scale``
    (B, H_kv, S) f32 from :func:`quantize_kv`. Returns f32 (B, H_kv, G,
    D). CPU tensors take the plain version, CUDA tensors the kernel."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if isinstance(t, torch.Tensor):
        if t.dim() != 0 or t.dtype.is_floating_point \
                or t.dtype.is_complex or t.dtype == torch.bool:
            raise ValueError(f"t must be an int or a 0-d integer tensor, "
                             f"got a {t.dtype} tensor of shape "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"t lies on {t.device}, the operands on "
                             f"{q.device}")
    else:
        t = operator.index(t)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention takes q (B, H_kv, G, D) and "
                         f"k/v (B, H_kv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (q.shape[0], q.shape[1], q.shape[3]) != \
            (k.shape[0], k.shape[1], k.shape[3]):
        raise ValueError(f"q/cache shapes incompatible: {tuple(q.shape)} "
                         f"vs {tuple(k.shape)}")
    if k_scale is not None and (k_scale.shape != k.shape[:3]
                                or v_scale.shape != k.shape[:3]):
        raise ValueError(f"scales must be (B, H_kv, S) = {tuple(k.shape[:3])}, "
                         f"got {tuple(k_scale.shape)}, "
                         f"{tuple(v_scale.shape)}")
    tensors = [q, k, v] + ([k_scale, v_scale] if k_scale is not None else [])
    if device_kind(*tensors) == "cpu":
        return decode_attention_plain(q, k, v, t, roll, k_scale, v_scale)
    return decode_attention_cuda(q, k, v, t, roll, k_scale, v_scale)
