"""Decoder-only transformer LM — serving and training, on one device or
over a (dp, sp), (dp, sp, mp) or (pp,) mesh.

Port of ``lua_mapreduce_tpu/models/transformer.py``:
:func:`init_transformer`, the oracle :func:`transformer_apply`,
:func:`prefill`, KV-cached :func:`greedy_decode` (prefill or
position-scan ingestion, GQA, sliding window with a rolling cache, int8
KV cache, greedy or sampled tokens; on a card one step captured in a
CUDA graph and replayed per position), the int8 serving copy
:func:`quantize_lm`, switch / top-k mixture-of-experts blocks
(``parallel/moe.py``), and the LM trainer: :func:`lm_loss_local` and
:func:`make_train_step` (ring, zigzag or Ulysses attention,
``cfg.remat``, gradient accumulation, ZeRO-1). With a mesh (the port's
``parallel.mesh.Mesh`` with axes ``("dp", "sp")``, one rank a process)
the batch shards over ``dp`` and the sequence over ``sp``; MoE expert
stacks shard over ``dp`` (:func:`shard_params_moe`);
:func:`make_sharded_apply` and ``prefill(mesh=)`` are the sharded
forwards. :func:`make_train_step_3d` adds Megatron tensor
parallelism over ``mp`` (params from :func:`shard_params_3d`) and
:func:`make_train_step_pp` the GPipe pipeline over ``pp`` (params from
:func:`shard_params_pp`). On a card the attention runs the port's flash
kernels (forward; dq and dkv in the backward) and decode kernel, and
the projections of a quantized dict run the q8 kernel; plain dense
projections ``y @ W``, the tp products, the expert products (f32
``bmm``), the unquantized head and the loss's log_softmax stay torch,
as the JAX package leaves them to XLA.

Params are a flat name→tensor dict with the JAX package's names and
layouts (carry JAX params across with ``convert.params_from_jax``).
Activations are (B, L, D); heads split D as (H, D/H).
"""

from __future__ import annotations

import dataclasses
import functools
import contextlib
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.graphs import CapturedGraph, on_side_stream
from lua_mapreduce_tpu_torch.ops.attention import flash_attention
from lua_mapreduce_tpu_torch.ops.decode import decode_attention, quantize_kv
from lua_mapreduce_tpu_torch.ops.q8 import q8_matmul, quantize_q8
from lua_mapreduce_tpu_torch.parallel import collectives as C
from lua_mapreduce_tpu_torch.parallel import moe as _moe
from lua_mapreduce_tpu_torch.parallel import zero1 as _z1
from lua_mapreduce_tpu_torch.parallel.pipeline import pipeline_apply
from lua_mapreduce_tpu_torch.parallel.ring_attention import (
    _ring_shard, _ring_shard_zigzag, _ulysses_shard, _zigzag_check,
    _zigzag_perm, attention_reference)
from lua_mapreduce_tpu_torch.train.accum import accum_value_and_grad

Params = Dict[str, torch.Tensor]

_NEG_INF = -1e30      # top-k's mask fill, as the JAX package's


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 512
    # grouped-query attention: 0 = n_heads (plain MHA), else a divisor
    n_kv_heads: int = 0
    # rotary position embeddings (no pos_emb table); even head_dim
    rope: bool = False
    rope_base: float = 10000.0
    # "ln" (pre-LN with bias) or "rms" (RMSNorm, scale only)
    norm: str = "ln"
    # "gelu" (2-matmul MLP with biases) or "swiglu" (gate/up/down)
    ffn: str = "gelu"
    # sliding-window attention: at most the last `window` positions
    window: int = 0
    # mixture-of-experts: > 0 replaces every block's dense FFN with a
    # switch-routed expert FFN (parallel/moe.py); capacity is required
    # and is per routing group (a rank's tile; the whole batch on one
    # device); moe_top_k > 1 is Mixtral-style top-k routing
    moe_experts: int = 0
    moe_capacity: int = 0
    moe_aux_weight: float = 0.01
    moe_top_k: int = 1
    # rematerialization: recompute each block's forward in the backward
    remat: bool = False

    @staticmethod
    def tiny() -> "TransformerConfig":
        return TransformerConfig(vocab=64, d_model=32, n_heads=4,
                                 n_layers=2, d_ff=64, max_seq=128)

    @staticmethod
    def llama_style(**kw) -> "TransformerConfig":
        """The modern decoder recipe: RoPE + RMSNorm + SwiGLU + GQA
        (pass ``n_kv_heads``); any field overridable via ``kw``."""
        base = dict(rope=True, norm="rms", ffn="swiglu")
        base.update(kw)
        return TransformerConfig(**base)


def flops_per_token(cfg: TransformerConfig, seq_len: int,
                    causal: bool = True) -> float:
    """Matmul FLOPs per token for one train step (fwd + bwd ≈ 3× fwd),
    counted as the JAX package counts them: qkv + out projections,
    attention score and value contractions (halved when causal, the
    mean visible keys under a window), the dense FFN and the tied head."""
    d, dff = cfg.d_model, cfg.d_ff
    hd = d // cfg.n_heads
    qkv_proj = 2.0 * d * (cfg.n_heads + 2 * kv_heads(cfg)) * hd
    if cfg.window and causal:
        we = min(cfg.window, seq_len)
        visible = (we * (we + 1) / 2 + (seq_len - we) * we) / seq_len
        attn = 4.0 * d * visible
    else:
        attn = 4.0 * seq_len * d * (0.5 if causal else 1.0)
    ffn = (6.0 if cfg.ffn == "swiglu" else 4.0) * d * dff
    per_layer = qkv_proj + 2.0 * d * d + attn + ffn
    fwd = cfg.n_layers * per_layer + 2.0 * d * cfg.vocab
    return 3.0 * fwd


def kv_heads(cfg: TransformerConfig) -> int:
    """Effective kv head count (n_kv_heads, defaulting to n_heads)."""
    hkv = cfg.n_kv_heads or cfg.n_heads
    if cfg.n_heads % hkv:
        raise ValueError(f"n_kv_heads={hkv} must divide "
                         f"n_heads={cfg.n_heads}")
    return hkv


def _check_arch(cfg: TransformerConfig) -> None:
    """Architecture-knob validation shared by init and every entry."""
    if cfg.norm not in ("ln", "rms"):
        raise ValueError(f"unknown norm {cfg.norm!r} (want 'ln'|'rms')")
    if cfg.ffn not in ("gelu", "swiglu"):
        raise ValueError(f"unknown ffn {cfg.ffn!r} "
                         f"(want 'gelu'|'swiglu')")
    if cfg.rope and (cfg.d_model // cfg.n_heads) % 2:
        raise ValueError("rope needs an even head_dim; got "
                         f"{cfg.d_model // cfg.n_heads}")
    if cfg.moe_experts and cfg.ffn != "gelu":
        raise ValueError("MoE blocks use the switch-gelu expert FFN; "
                         "ffn='swiglu' applies to dense blocks only")
    if cfg.window < 0:
        raise ValueError(f"window must be >= 0, got {cfg.window}")


def _check_moe(cfg: TransformerConfig, n_ep: Optional[int] = None) -> None:
    if cfg.moe_experts and cfg.moe_capacity <= 0:
        raise ValueError(
            "moe_experts > 0 requires an explicit moe_capacity (it is "
            "per routing group; see TransformerConfig)")
    if cfg.moe_top_k < 1:
        raise ValueError(f"moe_top_k must be >= 1, got {cfg.moe_top_k}")
    if cfg.moe_experts and cfg.moe_top_k > cfg.moe_experts:
        raise ValueError(f"moe_top_k={cfg.moe_top_k} exceeds "
                         f"moe_experts={cfg.moe_experts}")
    if n_ep is not None and cfg.moe_experts % n_ep:
        raise ValueError(f"moe_experts={cfg.moe_experts} not divisible "
                         f"by the expert-parallel axis size {n_ep}")


def init_transformer(seed: Union[int, torch.Generator] = 0,
                     cfg: TransformerConfig = TransformerConfig(),
                     dtype: torch.dtype = torch.float32,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Params:
    """Flat params with the JAX package's names and shapes: tok/pos
    embeddings (0.02·N(0,1)), per layer a fused qkv and an out
    projection, the FFN and two norms, a final norm; the LM head is tied
    to the token embedding; with ``cfg.moe_experts`` each block's FFN
    is a router and E stacked experts (``parallel.moe.init_moe``,
    prefix ``L{i}_moe``). Values come from a CPU ``torch.Generator``
    (``seed``), then move to ``device`` (default ``"cuda"``) and
    ``dtype`` — not the JAX package's numbers for the same seed."""
    _check_moe(cfg)
    _check_arch(cfg)
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    d, ff = cfg.d_model, cfg.d_ff
    hd = d // cfg.n_heads
    qkv_cols = (cfg.n_heads + 2 * kv_heads(cfg)) * hd

    def normal(*shape, scale):
        w = torch.randn(shape, generator=gen) * scale
        return w.to(device=dev, dtype=dtype)

    def const(value, n):
        return torch.full((n,), value, dtype=dtype, device=dev)

    params: Params = {"tok_emb": normal(cfg.vocab, d, scale=0.02)}
    if not cfg.rope:
        params["pos_emb"] = normal(cfg.max_seq, d, scale=0.02)
    for i in range(cfg.n_layers):
        p = f"L{i}"
        params[f"{p}_qkv_W"] = normal(d, qkv_cols, scale=d ** -0.5)
        params[f"{p}_out_W"] = normal(d, d, scale=d ** -0.5)
        if cfg.moe_experts:
            params.update(_moe.init_moe(gen, d, ff, cfg.moe_experts, dtype,
                                        dev, prefix=f"{p}_moe"))
        elif cfg.ffn == "swiglu":
            params[f"{p}_ff1_W"] = normal(d, ff, scale=d ** -0.5)   # gate
            params[f"{p}_ff3_W"] = normal(d, ff, scale=d ** -0.5)   # up
            params[f"{p}_ff2_W"] = normal(ff, d, scale=ff ** -0.5)  # down
        else:
            params[f"{p}_ff1_W"] = normal(d, ff, scale=d ** -0.5)
            params[f"{p}_ff1_b"] = const(0.0, ff)
            params[f"{p}_ff2_W"] = normal(ff, d, scale=ff ** -0.5)
            params[f"{p}_ff2_b"] = const(0.0, d)
        for ln in ("ln1", "ln2"):
            params[f"{p}_{ln}_g"] = const(1.0, d)
            if cfg.norm == "ln":
                params[f"{p}_{ln}_b"] = const(0.0, d)
    params["lnf_g"] = const(1.0, d)
    if cfg.norm == "ln":
        params["lnf_b"] = const(0.0, d)
    return params


def _head(params: Params, x):
    """The tied LM head ``x @ tok_emb.T`` — through the int8 kernel when
    the serving dict carries ``head::q8`` (quantize_lm)."""
    if "head::q8" in params:
        return _mm(params, "head", x)
    return x @ params["tok_emb"].T


def _mm(params: Params, key: str, y):
    """``y @ params[key]`` — through the weight-only int8 op when the
    dict carries ``key::q8`` + ``key::scale`` (see :func:`quantize_lm`)."""
    qk = key + "::q8"
    if qk in params:
        shp = y.shape
        out = q8_matmul(y.reshape(-1, shp[-1]), params[qk],
                        params[key + "::scale"])
        return out.reshape(*shp[:-1], out.shape[-1])
    return y @ params[key]


def quantize_lm(params: Params) -> Params:
    """Weight-only int8 serving copy: every per-block 2-D projection
    (qkv / out / ff*) becomes ``name::q8`` (int8) + ``name::scale`` (f32
    per output channel), and the tied head gets an int8 copy
    (``head::q8``, contiguous (D, vocab)) while tok_emb stays for the
    embedding gather; biases, norms, MoE routers and expert stacks
    (3-D, batched f32 products) stay full precision."""
    out = {}
    for k, v in params.items():
        if (k.endswith("_W") and v.dim() == 2
                and ("_qkv_" in k or "_out_" in k or "_ff" in k)):
            q, s = quantize_q8(v)
            out[k + "::q8"] = q
            out[k + "::scale"] = s.reshape(-1)
        else:
            out[k] = v
    qh, sh = quantize_q8(params["tok_emb"].T)
    out["head::q8"] = qh.contiguous()
    out["head::scale"] = sh.reshape(-1)
    return out


def _layer_norm(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _norm(params: Params, name: str, x, cfg: TransformerConfig, eps=1e-5):
    """The block norm: pre-LN (scale+bias) or RMSNorm (scale only)."""
    g = params[f"{name}_g"]
    if cfg.norm == "rms":
        ms = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + eps) * g
    return _layer_norm(x, g, params[f"{name}_b"], eps)


def _rope(x, pos, base: float):
    """Rotary embedding: rotate each (i, i+hd/2) pair of head dims by
    pos·base^(-2i/hd). x (B, L, H*, hd), pos (L,) global positions.
    Rotation-half convention; angles in f32, result in x.dtype."""
    half = x.shape[-1] // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = pos.float()[:, None] * freqs[None, :]          # (L, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _ffn(params: Params, p: str, y, cfg: TransformerConfig,
         ep: Optional[Tuple[object, str]] = None):
    """The block's FFN: dense, or the switch-MoE FFN when
    ``cfg.moe_experts`` > 0 — experts local when ``ep`` is None, else
    sharded over the mesh axis of ``ep = (mesh, axis)``; the whole
    (B, L) tile is one routing group. Returns (out, aux loss)."""
    if cfg.moe_experts:
        b, l, d = y.shape
        kw = dict(capacity=cfg.moe_capacity, prefix=f"{p}_moe",
                  top_k=cfg.moe_top_k)
        if ep is None:
            out, aux = _moe.moe_ffn_reference(params, y.reshape(b * l, d),
                                              **kw)
        else:
            out, aux = _moe.moe_ffn_shard(params, y.reshape(b * l, d),
                                          mesh=ep[0], ep_axis=ep[1], **kw)
        return out.reshape(b, l, d), aux
    if cfg.ffn == "swiglu":
        gate = F.silu(_mm(params, f"{p}_ff1_W", y))
        up = _mm(params, f"{p}_ff3_W", y)
        return _mm(params, f"{p}_ff2_W", gate * up), 0.0
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(_mm(params, f"{p}_ff1_W", y) + params[f"{p}_ff1_b"],
               approximate="tanh")
    return _mm(params, f"{p}_ff2_W", h) + params[f"{p}_ff2_b"], 0.0


def _split_qkv(qkv, cfg: TransformerConfig):
    """(B, L, (H+2H_kv)·hd) → q (B, L, H, hd), k/v (B, L, H_kv, hd),
    strided views of the fused projection."""
    b, l = qkv.shape[:2]
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    hkv = kv_heads(cfg)
    q = qkv[..., :h * hd].reshape(b, l, h, hd)
    k = qkv[..., h * hd:(h + hkv) * hd].reshape(b, l, hkv, hd)
    v = qkv[..., (h + hkv) * hd:].reshape(b, l, hkv, hd)
    return q, k, v


def _block(params: Params, i: int, x, cfg: TransformerConfig, attn_fn,
           pos, ep: Optional[Tuple[object, str]] = None,
           kv_sink: Optional[list] = None):
    """One pre-norm decoder block; ``attn_fn(q, k, v) -> out`` (one
    device's or a sequence-parallel body); ``pos`` the global positions
    of the L rows (rope); ``ep`` the MoE FFN's expert-parallel (mesh,
    axis). ``kv_sink`` (a list) captures this block's (k, v) — rotated
    k under rope — for the decode cache. Returns (x, moe aux)."""
    p = f"L{i}"
    b, l, d = x.shape
    y = _norm(params, f"{p}_ln1", x, cfg)
    q, k, v = _split_qkv(_mm(params, f"{p}_qkv_W", y), cfg)
    if cfg.rope:
        q = _rope(q, pos, cfg.rope_base)
        k = _rope(k, pos, cfg.rope_base)
    if kv_sink is not None:
        kv_sink.append((k, v))
    a = attn_fn(q, k, v).reshape(b, l, d)
    x = x + _mm(params, f"{p}_out_W", a)
    y = _norm(params, f"{p}_ln2", x, cfg)
    out, aux = _ffn(params, p, y, cfg, ep)
    return x + out, aux


def _check_seq(global_len: int, cfg: TransformerConfig) -> None:
    if global_len > cfg.max_seq:
        raise ValueError(
            f"sequence length {global_len} exceeds max_seq={cfg.max_seq}")


def _forward(params: Params, tokens, pos, cfg: TransformerConfig, attn_fn,
             block=None):
    """Shared body: tokens (B, L), pos (L,) global positions. Returns
    (logits, summed moe aux; 0.0 for dense blocks). With ``cfg.remat``
    each block runs under
    ``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint``):
    its activations are dropped after the forward and recomputed in the
    backward, so the block's forward — its flash kernel included — runs
    twice in a training step."""
    block = block or _block
    x = params["tok_emb"][tokens]
    if not cfg.rope:
        x = x + params["pos_emb"][pos]
    aux_total = 0.0
    for i in range(cfg.n_layers):
        if cfg.remat:
            x, aux = checkpoint(block, params, i, x, cfg, attn_fn, pos,
                                use_reentrant=False)
        else:
            x, aux = block(params, i, x, cfg, attn_fn, pos)
        aux_total = aux_total + aux
    x = _norm(params, "lnf", x, cfg)
    return _head(params, x), aux_total


def prefill(params: Params, prompt, *,
            cfg: TransformerConfig = TransformerConfig(),
            total: Optional[int] = None, mesh=None, attn: str = "ring",
            dp_axis: str = "dp", sp_axis: str = "sp"):
    """Parallel prompt ingestion: one causal forward over the (B, P)
    prompt (flash attention) yields every layer's (k, v) — the decode KV
    cache — and the last position's logits.

    Returns ``(caches, last_logits)``: caches maps ``L{i}_{k,v}`` to
    (B, total, H_kv, hd) in tok_emb's dtype, zero-padded past P (total
    defaults to P); last_logits is (B, vocab) f32. Logits are computed
    for every prompt position and the last taken, as the JAX package
    does. MoE configs route the whole (B, P) prompt as one group.

    With ``mesh`` the forward runs sequence-parallel (``attn`` ring,
    zigzag or Ulysses over ``sp_axis``; the batch over ``dp_axis`` when
    it divides, else replicated): every rank passes the same prompt,
    runs its tile, and gets the whole caches and logits. Dense configs
    only, as in the JAX package."""
    b, p_len = prompt.shape
    if p_len < 1:
        raise ValueError("prompt must contain at least one token")
    _check_arch(cfg)
    total = p_len if total is None else total
    if total < p_len:
        raise ValueError(f"total={total} shorter than the prompt {p_len}")
    _check_seq(total, cfg)
    cfg_fwd = dataclasses.replace(cfg, remat=False)  # capture ≠ remat
    tokens = torch.as_tensor(prompt).to(params["tok_emb"].device).long()
    sink: list = []
    if mesh is None:
        logits, _ = _forward(
            params, tokens, torch.arange(p_len, device=tokens.device),
            cfg_fwd,
            lambda q, k, v: flash_attention(q, k, v, causal=True,
                                            window=cfg.window),
            block=functools.partial(_block, kv_sink=sink))
        kvs = sink
    else:
        if cfg.moe_experts:
            raise ValueError("sequence-parallel prefill supports dense "
                             "configs; MoE prefills single-device")
        if cfg.window and attn != "ring":
            raise ValueError("sequence-parallel sliding-window prefill "
                             "runs the banded ring (attn='ring')")
        n_sp = mesh.shape[sp_axis]
        attn_shard = _attn_shard_fn(attn, n_sp, cfg, mesh=mesh,
                                    sp_axis=sp_axis)
        tokens, perm = _maybe_zigzag(attn, n_sp, tokens)
        # an inference batch smaller than dp replicates the batch axis
        # and shards only the sequence
        bdp = dp_axis if b % mesh.shape[dp_axis] == 0 else None
        tile = _tile(tokens, mesh, bdp, sp_axis)
        pos = _shard_pos(attn, mesh.axis_index(sp_axis), n_sp,
                         tile.shape[1], tile.device)
        logits, _ = _forward(params, tile, pos, cfg_fwd, attn_shard,
                             block=functools.partial(_block, kv_sink=sink))
        ks = torch.stack([kk for kk, _ in sink])   # (nl, B, Lloc, Hkv, hd)
        vs = torch.stack([vv for _, vv in sink])
        logits = _untile(logits, mesh, bdp, sp_axis, 0)
        ks, vs = (_untile(x, mesh, bdp, sp_axis, 1) for x in (ks, vs))
        if perm is not None:                 # back to standard order
            inv = torch.as_tensor(perm.argsort(), device=tokens.device)
            logits, ks, vs = logits[:, inv], ks[:, :, inv], vs[:, :, inv]
        kvs = [(ks[i], vs[i]) for i in range(cfg.n_layers)]
    caches = {}
    dt = params["tok_emb"].dtype
    for i, (k, v) in enumerate(kvs):
        for name, c in ((f"L{i}_k", k), (f"L{i}_v", v)):
            buf = torch.zeros((b, total) + tuple(c.shape[2:]), dtype=dt,
                              device=c.device)
            buf[:, :p_len] = c
            caches[name] = buf
    return caches, logits[:, -1].float()


# sampling's counter-based generator: the murmur3 finalizer and three odd
# 32-bit multipliers (golden ratio, murmur3's) that spread the counters
_M32 = 0xFFFFFFFF
_MIX = (0x85EBCA6B, 0xC2B2AE35)
_SPREAD = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)


def _mul32(x, c: int):
    """(x · c) mod 2³² for int64 tensors x in [0, 2³²) and a constant c
    < 2³², in 16-bit halves so no product leaves int64's range."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    """murmur3's 32-bit finalizer on int64 tensors in [0, 2³²)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _MIX[0])
    h = h ^ (h >> 13)
    h = _mul32(h, _MIX[1])
    return h ^ (h >> 16)


def _gumbel(key: int, t, rows: int, cols: int, device):
    """Gumbel noise (rows, cols) f64, a pure function of (key, t, row,
    column): the counters are hashed, never drawn from a stateful
    generator, so a captured decode step draws fresh noise at every
    replay's t, and every path that samples position t draws the same."""
    key = int(key) & ((1 << 64) - 1)
    if not isinstance(t, torch.Tensor):
        t = torch.full((), t, dtype=torch.int64, device=device)
    t = t.long() & _M32
    h = _fmix32(_mul32(t, _SPREAD[0]) ^ (key & _M32))
    h = _fmix32(h ^ (key >> 32))
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    h = _fmix32(h ^ _mul32(r, _SPREAD[1]))
    h = _fmix32(h ^ _mul32(c, _SPREAD[2]))
    u = (h.double() + 0.5) / 2.0 ** 32                  # (0, 1)
    return -torch.log(-torch.log(u))


def select_token(logits, t, *, temperature: float = 0.0,
                 top_k: Optional[int] = None, key=None):
    """The next token from (B, vocab) logits at position ``t`` (an int or
    a 0-d integer tensor) — the JAX ``greedy_decode``'s ``select``:
    argmax at temperature 0; else logits/temperature in f32, everything
    below the k-th largest set to −1e30 under ``top_k``, and a
    categorical draw by Gumbel-max with noise from ``key`` (an int) and
    (t, row, vocab index). The bits differ from ``jax.random``'s; the
    distribution is the same. Returns int64 (B,)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    lg = logits.float() / temperature
    if top_k is not None and top_k < lg.shape[-1]:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
        lg = torch.where(lg >= kth, lg, _NEG_INF)
    g = _gumbel(key, t, lg.shape[0], lg.shape[1], lg.device)
    return torch.argmax(lg.double() + g, dim=-1)


def greedy_decode(params: Params, prompt, n_new: int, *,
                  cfg: TransformerConfig = TransformerConfig(),
                  temperature: float = 0.0, top_k: Optional[int] = None,
                  key=None, use_prefill: bool = False, mesh=None,
                  attn: str = "ring", dp_axis: str = "dp",
                  sp_axis: str = "sp", kv_q8: bool = False):
    """KV-cached decoding: (B, P) prompt → (B, P+n_new) int32.

    Per-layer caches are (B, H_kv, S, D) (H_kv < H under GQA), written
    in place one row per position; each step attends its one query
    against the cache through ``decode_attention``. Inside the prompt
    the next input is the given token; after it, the chosen one:
    argmax, or with ``temperature > 0`` a sample (``top_k`` keeps the k
    largest logits; ``key``, an int, seeds the counter-based noise, so
    the same key gives the same tokens on either ingestion path). A
    sliding window smaller than the sequence makes each cache a rolling
    buffer of ``window`` slots (position p in slot p mod window).

    ``kv_q8=True`` stores the caches int8 with per-row f32 scales
    (``quantize_kv``); rows quantize as they are written, prefill caches
    once at the boundary. ``use_prefill=True`` ingests the prompt with
    :func:`prefill` and steps only the generation positions; otherwise
    every position steps through the decode loop.

    The loop is the JAX ``lax.scan``'s counterpart: the step keeps the
    position, the cache slot and the tokens in device tensors. On a card
    the first step runs eagerly and the step is then captured once in a
    CUDA graph (``graphs.CapturedGraph``) and replayed for the other
    positions, with no host round trip until the result; on the CPU the
    same step runs eagerly.

    MoE configs route per step: the group at position t is that step's
    B tokens, with capacity ``min(moe_capacity, B)`` (a bucket never
    holds more than B tokens, so the clamp changes no drop, only the
    dispatch shapes); the routing reads nothing back to the host, so the
    step still captures. When no bucket overflows, decode equals the
    full forward's tokens; under overflow the drop order differs from
    prefill's whole-prompt group, as in the JAX package.

    ``mesh`` (with ``use_prefill``) runs the prefill sequence-parallel
    (``attn`` over ``dp_axis``/``sp_axis``, see :func:`prefill`); the
    decode loop then runs on every rank alike."""
    _check_arch(cfg)
    if cfg.moe_experts:
        _check_moe(cfg)
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature > 0 and key is None:
        raise ValueError("sampling (temperature > 0) needs a PRNG key")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    b, p_len = prompt.shape
    if p_len < 1:
        raise ValueError("prompt must contain at least one token "
                         "(an empty prompt would silently return an "
                         "empty continuation)")
    total = p_len + n_new
    _check_seq(total, cfg)
    dev = params["tok_emb"].device
    prompt = torch.as_tensor(prompt).to(dev).long()
    if n_new == 0:
        return prompt.to(torch.int32)
    # the per-step routing group is B tokens: clamp the dispatch capacity
    step_cfg = (dataclasses.replace(cfg, moe_capacity=min(cfg.moe_capacity,
                                                          b))
                if cfg.moe_experts else cfg)
    h, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    hkv = kv_heads(cfg)
    g = h // hkv
    roll = bool(cfg.window) and cfg.window < total
    cache_len = cfg.window if roll else total
    select = functools.partial(select_token, temperature=temperature,
                               top_k=top_k, key=key)
    # the loop's device state: the output tokens (the prompt, then each
    # step's token at t + 1) and the position t
    out = torch.zeros((b, total), dtype=torch.long, device=dev)
    out[:, :p_len] = prompt
    t = torch.zeros((), dtype=torch.long, device=dev)

    def step():
        """Position t through every layer: its cache rows written in
        place (the JAX scan carries updated copies through
        dynamic_update_slice), its token written at t + 1 (inside the
        prompt the given one stays), t advanced."""
        pos = t.view(1)
        x = params["tok_emb"][out.index_select(1, pos)[:, 0]]   # (B, D)
        if not cfg.rope:
            x = x + params["pos_emb"].index_select(0, pos)
        x = x[:, None, :]                               # (B, 1, D)
        slot = pos % cache_len if roll else pos
        for i in range(cfg.n_layers):
            pfx = f"L{i}"
            y = _norm(params, f"{pfx}_ln1", x, cfg)
            q, k, v = _split_qkv(_mm(params, f"{pfx}_qkv_W", y), cfg)
            if cfg.rope:
                q = _rope(q, pos, cfg.rope_base)
                k = _rope(k, pos, cfg.rope_base)
            # (B, 1, H_kv, D) → (B, H_kv, 1, D) cache rows; q grouped
            # kv-head major, the (B, H_kv, G, D) decode_attention takes
            k, v = k.transpose(1, 2), v.transpose(1, 2)
            q = q.reshape(b, hkv, g, hd)
            scales = {}
            if kv_q8:
                k, ks_row = quantize_kv(k)
                v, vs_row = quantize_kv(v)
                caches[f"{pfx}_ks"].index_copy_(2, slot, ks_row)
                caches[f"{pfx}_vs"].index_copy_(2, slot, vs_row)
                scales = {"k_scale": caches[f"{pfx}_ks"],
                          "v_scale": caches[f"{pfx}_vs"]}
            caches[f"{pfx}_k"].index_copy_(2, slot, k)
            caches[f"{pfx}_v"].index_copy_(2, slot, v)
            a = decode_attention(q, caches[f"{pfx}_k"], caches[f"{pfx}_v"],
                                 t, roll=roll, **scales)
            a = a.to(x.dtype).reshape(b, 1, cfg.d_model)
            x = x + _mm(params, f"{pfx}_out_W", a)
            y = _norm(params, f"{pfx}_ln2", x, cfg)
            ff, _ = _ffn(params, pfx, y, step_cfg)
            x = x + ff
        x = _norm(params, "lnf", x, cfg)
        nxt = select(_head(params, x)[:, 0], t)
        given = out.index_select(1, pos + 1)[:, 0]
        out.index_copy_(1, pos + 1,
                        torch.where(pos + 1 < p_len, given, nxt)[:, None])
        t.add_(1)

    if use_prefill:
        caches, last_logits = prefill(params, prompt, cfg=cfg, total=total,
                                      mesh=mesh, attn=attn, dp_axis=dp_axis,
                                      sp_axis=sp_axis)
        # prefill's public contract is (B, S, H_kv, D); the decode loop
        # holds (B, H_kv, S, D) — one transpose at the boundary
        caches = {n: c.transpose(1, 2).contiguous()
                  for n, c in caches.items()}
        if kv_q8:
            quant = {}
            for n, c in caches.items():
                quant[n], quant[n + "s"] = quantize_kv(c)
            caches = quant
        if roll:
            # fold the prompt cache into the rolling layout: slot j holds
            # the last prompt position ≡ j (mod window)
            if p_len >= cache_len:
                j = torch.arange(cache_len, device=dev)
                src = p_len - 1 - ((p_len - 1 - j) % cache_len)
                caches = {n: c[:, :, src].contiguous()
                          for n, c in caches.items()}
            else:
                caches = {n: c[:, :, :cache_len].contiguous()
                          for n, c in caches.items()}
        out[:, p_len] = select(last_logits, p_len - 1)
        t.fill_(p_len)
    else:
        cache_dtype = torch.int8 if kv_q8 else params["tok_emb"].dtype
        caches = {f"L{i}_{kv}": torch.zeros((b, hkv, cache_len, hd),
                                            dtype=cache_dtype, device=dev)
                  for i in range(cfg.n_layers) for kv in ("k", "v")}
        if kv_q8:
            caches.update({f"L{i}_{kv}s": torch.zeros(
                (b, hkv, cache_len), dtype=torch.float32, device=dev)
                for i in range(cfg.n_layers) for kv in ("k", "v")})
    # positions t .. total - 2 step (the last position's prediction
    # would fall past the output)
    n_steps = total - 1 - (p_len if use_prefill else 0)
    if n_steps > 0 and dev.type == "cuda":
        # the first step runs eagerly and writes real state; the capture
        # runs no kernel, so it does not step a position twice
        on_side_stream(step)
        if n_steps > 1:
            graph = CapturedGraph(step, tag="decode step")
            for _ in range(n_steps - 1):
                graph.replay()
    else:
        for _ in range(n_steps):
            step()
    return out.to(torch.int32)


def transformer_apply(params: Params, tokens, *,
                      cfg: TransformerConfig = TransformerConfig()):
    """Single-device oracle: (B, L) tokens → (B, L, vocab) logits."""
    _check_seq(tokens.shape[1], cfg)
    tokens = tokens.to(params["tok_emb"].device).long()
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    logits, _ = _forward(params, tokens, pos, cfg,
                         functools.partial(attention_reference, causal=True,
                                           window=cfg.window))
    return logits


# ------------------------------------------------------------ training


def _attn_shard_fn(attn: str, n_sp: int, cfg: TransformerConfig, *,
                   mesh=None, sp_axis: str = "sp",
                   n_heads: Optional[int] = None):
    """The sequence-parallel attention body over ``n_sp`` shards of
    ``mesh``'s ``sp_axis`` (``mesh`` may be None for one shard),
    resolved strictly at factory time: a typo'd name or an infeasible
    head split fails here, not inside a collective."""
    n_heads = cfg.n_heads if n_heads is None else n_heads
    if cfg.window and attn != "ring":
        raise ValueError(
            "sliding-window attention (cfg.window > 0) runs "
            "sequence-parallel as the BANDED contiguous ring "
            "(attn='ring'); zigzag balances full-causal work a window "
            "already bounds, and ulysses materializes full-sequence "
            "heads per device")
    kw = dict(n_shards=n_sp, causal=True, mesh=mesh, axis=sp_axis)
    if attn == "ring":
        return functools.partial(_ring_shard, window=cfg.window, **kw)
    if attn == "zigzag":
        return functools.partial(_ring_shard_zigzag, **kw)
    if attn == "ulysses":
        if n_heads % n_sp:
            raise ValueError(
                f"ulysses needs n_heads divisible by the {sp_axis} axis: "
                f"{n_heads} heads over {n_sp} devices")
        if kv_heads(cfg) % n_sp:
            raise ValueError(
                f"ulysses needs n_kv_heads divisible by the {sp_axis} "
                f"axis: {kv_heads(cfg)} kv heads over {n_sp} devices "
                f"(ring/zigzag have no such constraint)")
        return functools.partial(_ulysses_shard, **kw)
    raise ValueError(f"unknown attn {attn!r} "
                     f"(want 'ring', 'zigzag' or 'ulysses')")


def _shard_pos(attn: str, my: int, n_sp: int, l_loc: int, device):
    """This shard's global positions: contiguous for ring/ulysses, the
    two-stripe layout for zigzag (``ring_attention._zigzag_perm``)."""
    if attn == "zigzag":
        h = l_loc // 2
        r = torch.arange(h, device=device)
        return torch.cat([my * h + r, (2 * n_sp - 1 - my) * h + r])
    return my * l_loc + torch.arange(l_loc, device=device)


def _maybe_zigzag(attn: str, n_sp: int, *seqs, pre_permuted: bool = False):
    """The zigzag permutation applied to global (B, L) sequence tensors
    (identity for other schedules). Returns the permuted tensors and the
    permutation (None when not zigzag), so a forward can un-permute its
    outputs; ``pre_permuted=True`` validates without permuting."""
    if attn != "zigzag":
        return (*seqs, None)
    _zigzag_check(seqs[0].shape[1], n_sp)
    perm = _zigzag_perm(seqs[0].shape[1], n_sp)
    if pre_permuted:
        return (*seqs, perm)
    idx = torch.as_tensor(perm, device=seqs[0].device)
    return (*(s[:, idx] for s in seqs), perm)


def _block_of(x, mesh, axis: Optional[str], dim: int):
    """This rank's block of ``x`` along ``dim`` over ``axis`` (all of it
    when ``axis`` is None)."""
    if axis is None:
        return x
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {axis}={n}")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.axis_index(axis) * size, size)


def _tile(x, mesh, dp_axis: Optional[str], sp_axis: str):
    """This rank's (batch, seq) tile of a global (B, L, ...) tensor."""
    return _block_of(_block_of(x, mesh, dp_axis, 0), mesh, sp_axis, 1)


def _untile(x, mesh, dp_axis: Optional[str], sp_axis: str, b_dim: int):
    """Inverse of :func:`_tile` by all_gather, the batch axis at
    ``b_dim`` and the sequence right after it: every rank gets the
    whole tensor."""
    x = C.all_gather(x, mesh, sp_axis, b_dim + 1)
    return x if dp_axis is None else C.all_gather(x, mesh, dp_axis, b_dim)


def _mesh_axes(mesh, dp_axis: str, sp_axis: str) -> Tuple[int, int]:
    """(n_dp, n_sp) of ``mesh`` (1, 1 for None). Any other axis of the
    mesh (an ``mp`` or ``pp`` axis) replicates the computation, as the
    JAX ``shard_map`` does with an axis no spec names: every rank of it
    runs the same tile and holds the same result."""
    if mesh is None:
        return 1, 1
    sizes = dict(mesh.shape)
    for a in (dp_axis, sp_axis):
        if a not in sizes:
            raise ValueError(f"the mesh has axes {tuple(sizes)}; the LM "
                             f"step needs {dp_axis!r} and {sp_axis!r}")
    return sizes[dp_axis], sizes[sp_axis]


def make_sharded_apply(cfg: TransformerConfig, mesh, *, attn: str = "ring",
                       dp_axis: str = "dp", sp_axis: str = "sp"):
    """The forward over the mesh: ``apply(params, tokens) -> logits``.
    Every rank passes the same global (B, L) tokens; each runs its
    (batch over ``dp``, sequence over ``sp``) tile with the attention
    sequence-parallel, and every rank gets the whole (B, L, vocab)
    logits. Dense params are the replicated dict; with
    ``cfg.moe_experts`` the expert stacks shard over ``dp`` and params
    come from :func:`shard_params_moe`."""
    _check_arch(cfg)
    n_dp, n_sp = _mesh_axes(mesh, dp_axis, sp_axis)
    attn_shard = _attn_shard_fn(attn, n_sp, cfg, mesh=mesh, sp_axis=sp_axis)
    if cfg.moe_experts:
        _check_moe(cfg, n_dp)
    block = functools.partial(
        _block, ep=(mesh, dp_axis) if cfg.moe_experts else None)

    def apply(params: Params, tokens):
        tokens = torch.as_tensor(tokens).to(params["tok_emb"].device).long()
        tokens, perm = _maybe_zigzag(attn, n_sp, tokens)
        tile = _tile(tokens, mesh, dp_axis, sp_axis)
        l_loc = tile.shape[1]
        _check_seq(l_loc * n_sp, cfg)
        pos = _shard_pos(attn, mesh.axis_index(sp_axis), n_sp, l_loc,
                         tile.device)
        out = _untile(_forward(params, tile, pos, cfg, attn_shard,
                               block=block)[0], mesh, dp_axis, sp_axis, 0)
        if perm is None:
            return out
        return out[:, torch.as_tensor(perm.argsort(), device=out.device)]

    return apply


def _mean_nll(logits, targets):
    """Mean next-token NLL — the loss tail of every execution form."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0].mean()


def lm_loss_local(params: Params, tokens, targets, cfg: TransformerConfig,
                  attn_fn, pos, block=None):
    """Mean next-token NLL (+ weighted MoE aux loss, 0 for dense blocks)
    of (B, L) tokens against targets the caller shifted."""
    logits, aux = _forward(params, tokens, pos, cfg, attn_fn, block=block)
    return _mean_nll(logits, targets) + cfg.moe_aux_weight * aux


def param_specs_moe(ep_axis: str = "dp") -> Dict[str, str]:
    """Name suffix → the mesh axis that shards the param's leading
    (experts) axis — the JAX ``P(ep_axis)`` specs: the expert FFN
    stacks; the router and every other param are replicated."""
    return {s: ep_axis for s in ("_moe_w1", "_moe_b1", "_moe_w2", "_moe_b2")}


def _spec_for(name: str, specs: Dict[str, object]):
    """The spec of param ``name`` under ``specs`` (suffix match): the
    sharding axis (MoE) or per-dimension axes (3-D); None when the
    param is replicated."""
    return next((a for suffix, a in specs.items() if name.endswith(suffix)),
                None)


def shard_params_moe(params: Params, mesh, *, ep_axis: str = "dp"
                     ) -> Params:
    """This rank's params: every expert stack cut to the rank's
    E/ep experts along its leading axis, the rest as given."""
    specs = param_specs_moe(ep_axis)
    return {k: (v if _spec_for(k, specs) is None
                else _block_of(v, mesh, ep_axis, 0).clone())
            for k, v in params.items()}


def make_train_step(cfg: TransformerConfig, optimizer, *, mesh=None,
                    attn: str = "ring", grad_accum: int = 1,
                    zigzag_layout: bool = False, zero1: bool = False,
                    dp_axis: str = "dp", sp_axis: str = "sp"):
    """The LM train step, ``step(params, tokens, targets) -> loss``.

    The JAX package's ``make_train_step(cfg, mesh, optimizer)`` returns
    a pure ``step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)`` jitted with donated buffers. Here the step is
    stateful: ``optimizer`` is a ``torch.optim`` optimizer (or
    :class:`~lua_mapreduce_tpu_torch.train.precision.F32Master`) built
    over the tensors of ``params``, and holds what ``opt_state`` holds;
    the step computes the loss and its gradient (through
    ``accum_value_and_grad`` over ``grad_accum`` microbatches when > 1),
    writes each gradient to its parameter's ``.grad``, steps the
    optimizer — the parameters update in place — and returns the loss,
    a detached 0-d tensor.

    ``mesh`` (the port's ``Mesh`` with ``dp_axis`` and ``sp_axis``; one
    rank a process) makes the step SPMD: every rank calls it with its
    (B/dp, L/sp) tile of the batch (:func:`shard_batch`), attention runs
    sequence-parallel over ``sp`` (``attn`` ring, zigzag or Ulysses),
    and the loss is the global mean. Each rank differentiates its own
    tile's loss; the collectives' backward carries the other ranks'
    shares, and a replicated param's gradient is then averaged over
    (dp, sp). With ``cfg.moe_experts`` the expert stacks shard over
    ``dp`` (params from :func:`shard_params_moe`): a stack's gradient
    already holds every dp peer's tokens (the all_to_all's backward) and
    is averaged over ``sp`` and divided by n_dp.

    ``zigzag_layout=True`` (``attn="zigzag"`` only) declares the tiles
    already in zigzag order (``shard_batch(..., schedule="zigzag")``);
    otherwise a zigzag step gathers each tile's sequence over ``sp`` and
    takes its zigzag tile. ``zero1=True`` shards the optimizer state
    over ``dp`` (``parallel/zero1.py``): ``optimizer`` is then the
    ``(chunks, optimizer)`` pair of ``zero1.init_state``, the gradient
    is averaged over ``sp`` and reduce-scattered over ``dp``, each rank
    steps its chunks (an F32Master's f32 masters live in them), and the
    chunks all-gather back into ``params``. Dense configs only."""
    if zigzag_layout and attn != "zigzag":
        raise ValueError("zigzag_layout=True requires attn='zigzag'")
    if zero1 and cfg.moe_experts:
        raise ValueError("zero1 shards optimizer state over dp, "
                         "which MoE already spends on experts")
    if zero1 and mesh is None:
        raise ValueError("zero1 shards the optimizer state over a mesh's "
                         "dp axis: pass mesh=")
    _check_arch(cfg)
    n_dp, n_sp = _mesh_axes(mesh, dp_axis, sp_axis)
    attn_fn = _attn_shard_fn(attn, n_sp, cfg, mesh=mesh, sp_axis=sp_axis)
    ep = None
    if cfg.moe_experts:
        if grad_accum > 1:
            raise ValueError(
                "grad_accum > 1 with moe_experts > 0 would silently "
                "change the numbers: MoE capacity and the aux loss are "
                "defined per device tile, so quarter-size microbatches "
                "drop/route tokens differently than the whole tile")
        _check_moe(cfg, n_dp)
        ep = None if mesh is None else (mesh, dp_axis)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    block = functools.partial(_block, ep=ep)
    chunks = None
    if zero1:
        chunks, optimizer = optimizer
    tile_grads = _tile_value_and_grad(cfg, mesh, attn, attn_fn, block,
                                      grad_accum, zigzag_layout, sp_axis)
    specs = param_specs_moe(dp_axis) if cfg.moe_experts else {}

    def reduce_grads(grads: Params) -> Params:
        out = {}
        for k, g in grads.items():
            if _spec_for(k, specs) is not None:
                out[k] = C.psum(g, mesh, sp_axis) / (n_sp * n_dp)
            else:
                out[k] = C.pmean(C.pmean(g, mesh, sp_axis), mesh, dp_axis)
        return out

    def step(params: Params, tokens, targets):
        loss, grads = tile_grads(params, tokens, targets)
        if mesh is not None:
            loss = C.pmean(C.pmean(loss, mesh, sp_axis), mesh, dp_axis)
            if zero1:
                grads = {k: C.pmean(g, mesh, sp_axis)
                         for k, g in grads.items()}
                _z1.update_chunks(optimizer, params, grads, chunks, mesh,
                                  dp_axis)
                return loss
            grads = reduce_grads(grads)
        _apply(optimizer, params, grads)
        return loss

    return step


def _tile_value_and_grad(cfg: TransformerConfig, mesh, attn: str, attn_fn,
                         block, grad_accum: int, zigzag_layout: bool,
                         sp_axis: str):
    """``fn(params, tokens, targets) -> (loss, grads)`` of this rank's
    (B/dp, L/sp) tile: the tile's mean loss (detached) and its gradient
    with respect to every param (zeros where the loss does not reach),
    through ``accum_value_and_grad`` over ``grad_accum`` microbatches
    when > 1 — the part every SPMD step form shares. The collectives'
    backward carries the other ranks' shares; the caller averages."""
    n_sp = 1 if mesh is None else mesh.shape[sp_axis]
    my_sp = 0 if mesh is None else mesh.axis_index(sp_axis)
    permute_tiles = attn == "zigzag" and not zigzag_layout

    def zigzag_tile(x):
        """The zigzag tile of a contiguous one: the global sequence of
        this rank's rows gathered over sp, permuted, this rank's block
        taken (the JAX step's per-step cross-shard gather)."""
        full = x if mesh is None else C.all_gather(x, mesh, sp_axis, 1)
        full, _ = _maybe_zigzag("zigzag", n_sp, full)
        return full if mesh is None else _block_of(full, mesh, sp_axis, 1)

    def value_and_grad(params: Params, tokens, targets):
        dev = params["tok_emb"].device
        tokens = torch.as_tensor(tokens).to(dev).long()
        targets = torch.as_tensor(targets).to(dev).long()
        if permute_tiles:
            tokens, targets = zigzag_tile(tokens), zigzag_tile(targets)
        elif attn == "zigzag":
            _zigzag_check(tokens.shape[1] * n_sp, n_sp)
        l_loc = tokens.shape[1]
        _check_seq(l_loc * n_sp, cfg)
        pos = _shard_pos(attn, my_sp, n_sp, l_loc, dev)

        def loss_fn(p, tok, tgt):
            return lm_loss_local(p, tok, tgt, cfg, attn_fn, pos, block=block)

        # under a mesh every rank reruns a rematerialized block whole, so
        # each posts the block's collectives again, whatever it saved
        with (set_checkpoint_early_stop(False) if mesh is not None
              else contextlib.nullcontext()):
            if grad_accum == 1:
                loss = loss_fn(params, tokens, targets)
                grads = torch.autograd.grad(loss, list(params.values()),
                                            allow_unused=True)
                grads = dict(zip(params, grads))
                loss = loss.detach()
            else:
                loss, grads = accum_value_and_grad(
                    loss_fn, params, (tokens, targets), grad_accum)
        return loss, {k: torch.zeros_like(p) if grads[k] is None
                      else grads[k] for k, p in params.items()}

    return value_and_grad


def _apply(optimizer, params: Params, grads: Params) -> None:
    """Write each gradient to its param's ``.grad`` and step."""
    for k, p in params.items():
        p.grad = grads[k]
    optimizer.step()


def shard_batch(mesh, tokens, targets, dp_axis: str = "dp",
                sp_axis: str = "sp", schedule: str = "contiguous"):
    """This rank's (B/dp, L/sp) tile of a global (B, L) batch, as int64
    tensors on the mesh's device — what a step built with ``mesh``
    takes. ``schedule="zigzag"`` permutes both into zigzag sequence
    order first (for steps built with ``zigzag_layout=True``); tokens
    and targets ride the same permutation, so the next-token pairing is
    kept row by row."""
    tokens, targets = (torch.as_tensor(x).long() for x in (tokens, targets))
    if schedule == "zigzag":
        n_sp = mesh.shape[sp_axis]
        _zigzag_check(tokens.shape[1], n_sp)
        perm = torch.as_tensor(_zigzag_perm(tokens.shape[1], n_sp),
                               device=tokens.device)
        tokens, targets = tokens[:, perm], targets[:, perm]
    elif schedule != "contiguous":
        raise ValueError(f"unknown schedule {schedule!r}")
    return tuple(_tile(x, mesh, dp_axis, sp_axis).to(mesh.device)
                 for x in (tokens, targets))


# ------------------------------------------ 3-D form: dp × sp × mp (tp)
#
# Attention heads and MLP hidden units shard over ``mp``; activations
# stay replicated across mp at block boundaries through one psum after
# the attention out-projection and one after the second MLP product
# (the Megatron pattern), and each mp slice runs the sp ring over ITS
# heads. The JAX package needs no hand-written collective for the
# gradient: ``shard_map``'s transpose sums a replicated value's
# cotangent over mp where it meets an mp-sharded weight. Here that sum
# is ``collectives.copy_to`` (Megatron's f), placed by hand before the
# qkv and ff1/ff3 products, and the forward psum is
# ``collectives.reduce_from`` (g), so every replicated param's gradient
# is whole and equal on every mp rank and an mp-sharded param's is its
# slice's. The loss is averaged over (dp, sp) only, and so is every
# gradient afterwards: summing the replicated ones over mp as well
# would count the heads' share mp times.
#
# tp weights take head-structured layouts, so a spec splits them per
# head rather than per raw column: qkv (d, 3, H, hd) on H, the
# out-projection (H, hd, d) on H, the MLP (d, ff) / (ff, d) on ff.

def param_specs_3d(mp_axis: str = "mp") -> Dict[str, tuple]:
    """Name suffix → the mesh axis per dimension (None: whole) of the
    tp-sharded params, as the JAX ``PartitionSpec`` s; every other
    param is replicated."""
    return {
        "_qkv_W": (None, None, mp_axis, None),
        "_out_W": (mp_axis, None, None),
        "_ff1_W": (None, mp_axis),
        "_ff1_b": (mp_axis,),
        "_ff3_W": (None, mp_axis),     # swiglu up (columns, like gate)
        "_ff2_W": (mp_axis, None),
    }


def _shard_spec(x, mesh, spec: tuple):
    """This rank's block of ``x`` under ``spec`` (an axis or None per
    dimension)."""
    for dim, axis in enumerate(spec):
        x = _block_of(x, mesh, axis, dim)
    return x


def _gather_spec(x, mesh, spec: tuple):
    """Inverse of :func:`_shard_spec` by all_gather (every rank calls
    it and gets the whole tensor)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = C.all_gather(x, mesh, axis, dim)
    return x


def _check_mha(cfg: TransformerConfig) -> None:
    if kv_heads(cfg) != cfg.n_heads:
        raise ValueError("the 3-D tp path shards the fused qkv by head "
                         "and supports MHA only; GQA composes with "
                         "dp/sp (make_train_step) in the current build")


def shard_params_3d(params: Params, mesh, cfg: TransformerConfig, *,
                    mp_axis: str = "mp") -> Params:
    """This rank's params for :func:`make_train_step_3d`: the tp weights
    reshaped to their head-structured layouts and cut to this rank's mp
    slice (its H/mp heads, its d_ff/mp hidden units); the rest as given
    (inverse: :func:`unshard_params_3d`). Takes the canonical dict or
    one already in the head-structured layouts (the JAX package's 3-D
    dict, as numpy arrays through ``convert.params_from_jax``)."""
    _check_mha(cfg)
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    specs = param_specs_3d(mp_axis)
    out: Params = {}
    for name, w in params.items():
        spec = _spec_for(name, specs)
        if spec is None:
            out[name] = w
            continue
        if name.endswith("_qkv_W"):
            w = w.reshape(d, 3, h, hd)
        elif name.endswith("_out_W"):
            w = w.reshape(h, hd, d)
        out[name] = _shard_spec(w.detach(), mesh, spec).clone()
    return out


def _gather_params_3d(params: Params, mesh, *, mp_axis: str = "mp"
                     ) -> Params:
    """Every rank's mp slices gathered back: the JAX package's 3-D
    dict (head-structured tp weights, whole). Every rank calls it."""
    specs = param_specs_3d(mp_axis)
    return {k: (v if _spec_for(k, specs) is None
                else _gather_spec(v.detach(), mesh, _spec_for(k, specs)))
            for k, v in params.items()}


def unshard_params_3d(params: Params, cfg: TransformerConfig, mesh, *,
                      mp_axis: str = "mp") -> Params:
    """Back to the canonical 2-D layouts (for checkpoints and the
    oracle). The JAX function reshapes global arrays; here each rank
    holds its slice, so this gathers over ``mp`` first and takes the
    mesh — every rank calls it and gets the whole dict."""
    d = cfg.d_model
    out: Params = {}
    for name, w in _gather_params_3d(params, mesh, mp_axis=mp_axis).items():
        if name.endswith("_qkv_W"):
            w = w.reshape(d, 3 * d)
        elif name.endswith("_out_W"):
            w = w.reshape(d, d)
        out[name] = w
    return out


def _block_tp(params: Params, i: int, x, cfg: TransformerConfig, attn_fn,
              pos, *, mesh, mp_axis: str):
    """One decoder block on this rank's tp slices; x enters and leaves
    replicated across mp. The fused qkv product of this slice's heads
    is one GEMM whose q, k, v are strided views (as the 2-D block's);
    rope rotates this slice's heads by the same global ``pos``; swiglu
    shards gate/up columns and down rows like gelu's ff1/ff2."""
    p = f"L{i}"
    b, l, d = x.shape
    y = C.copy_to(_norm(params, f"{p}_ln1", x, cfg), mesh, mp_axis)
    w_qkv = params[f"{p}_qkv_W"]                 # (d, 3, H/mp, hd)
    h_loc, hd = w_qkv.shape[2], w_qkv.shape[3]
    q, k, v = (y @ w_qkv.reshape(d, -1)).reshape(b, l, 3, h_loc,
                                                 hd).unbind(2)
    if cfg.rope:
        q = _rope(q, pos, cfg.rope_base)
        k = _rope(k, pos, cfg.rope_base)
    a = attn_fn(q, k, v).reshape(b, l, h_loc * hd)   # this slice's heads
    w_out = params[f"{p}_out_W"].reshape(h_loc * hd, d)
    x = x + C.reduce_from(a @ w_out, mesh, mp_axis)  # Megatron sync 1
    y = C.copy_to(_norm(params, f"{p}_ln2", x, cfg), mesh, mp_axis)
    if cfg.ffn == "swiglu":
        h = F.silu(y @ params[f"{p}_ff1_W"]) * (y @ params[f"{p}_ff3_W"])
        return x + C.reduce_from(h @ params[f"{p}_ff2_W"], mesh,
                                 mp_axis), 0.0
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(y @ params[f"{p}_ff1_W"] + params[f"{p}_ff1_b"],
               approximate="tanh")
    partial = C.reduce_from(h @ params[f"{p}_ff2_W"], mesh, mp_axis)
    return x + partial + params[f"{p}_ff2_b"], 0.0


def make_train_step_3d(cfg: TransformerConfig, mesh, optimizer, *,
                       attn: str = "ring", dp_axis: str = "dp",
                       sp_axis: str = "sp", mp_axis: str = "mp",
                       grad_accum: int = 1, zigzag_layout: bool = False):
    """The LM train step over a (dp, sp, mp) mesh,
    ``step(params, tokens, targets) -> loss``, stateful as
    :func:`make_train_step`'s: ``params`` are this rank's, from
    :func:`shard_params_3d`, ``optimizer`` is built over them, and
    tokens/targets are this rank's (B/dp, L/sp) tile
    (:func:`shard_batch`; every mp rank of a (dp, sp) cell takes the
    same tile). Heads and MLP units shard over ``mp`` (the Megatron
    pair, see above), the sequence over ``sp`` with ``attn`` ring,
    zigzag or Ulysses over each mp slice's heads, the batch over
    ``dp``. ``grad_accum`` and ``zigzag_layout`` as in
    :func:`make_train_step`. The loss is the global mean; every
    gradient is averaged over (dp, sp). MHA dense configs only."""
    if zigzag_layout and attn != "zigzag":
        raise ValueError("zigzag_layout=True requires attn='zigzag'")
    _check_arch(cfg)
    _, n_sp = _mesh_axes(mesh, dp_axis, sp_axis)
    n_mp = mesh.shape[mp_axis]
    if cfg.n_heads % n_mp:
        raise ValueError(f"n_heads={cfg.n_heads} not divisible by "
                         f"{mp_axis}={n_mp}")
    _check_mha(cfg)
    if cfg.moe_experts:
        raise ValueError("MoE blocks are not supported on the 3-D tp "
                         "path; use make_train_step (experts over dp)")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    # the ulysses divisibility check sees the PER-TP-SLICE head count
    attn_fn = _attn_shard_fn(attn, n_sp, cfg, mesh=mesh, sp_axis=sp_axis,
                             n_heads=cfg.n_heads // n_mp)
    block = functools.partial(_block_tp, mesh=mesh, mp_axis=mp_axis)
    tile_grads = _tile_value_and_grad(cfg, mesh, attn, attn_fn, block,
                                      grad_accum, zigzag_layout, sp_axis)

    def mean_dp_sp(x):
        return C.pmean(C.pmean(x, mesh, sp_axis), mesh, dp_axis)

    def step(params: Params, tokens, targets):
        loss, grads = tile_grads(params, tokens, targets)
        _apply(optimizer, params, {k: mean_dp_sp(g)
                                   for k, g in grads.items()})
        return mean_dp_sp(loss)

    return step


# --------------------------------- pipeline form: layer groups over pp
#
# The decoder blocks are homogeneous, so their weights stack on a
# leading layer axis and cut over ``pp``: each stage owns n_layers/pp
# consecutive layers and runs them in turn. The embedding, the tied head
# and the final norm are replicated: every rank embeds the microbatches
# alike and scores the (psum-broadcast) last-stage outputs alike, so
# only the block stack rides the pipeline (parallel/pipeline.py). Dense
# FFN blocks only — tp and MoE compose with dp/sp, not with this axis.

def _layer_weight_names(params: Params) -> list:
    """Per-layer weight suffixes, from the ACTUAL keys (the set varies
    with cfg.ffn / cfg.norm — a fixed list would silently drop swiglu's
    ff3 or fail on rms's missing biases)."""
    return sorted(k[len("L0_"):] for k in params if k.startswith("L0_"))


def stack_params_pp(params: Params, cfg: TransformerConfig) -> Params:
    """Per-layer weights → one leading-layer-axis stack per weight name
    (``layers_<name>``); embeddings and the final norm pass through."""
    if cfg.moe_experts:
        raise ValueError("pipeline form supports dense blocks only")
    out: Params = {k: v for k, v in params.items() if not k.startswith("L")}
    for name in _layer_weight_names(params):
        out[f"layers_{name}"] = torch.stack(
            [params[f"L{i}_{name}"].detach() for i in range(cfg.n_layers)])
    return out


def unstack_params_pp(stacked: Params, cfg: TransformerConfig, mesh=None, *,
                      pp_axis: str = "pp") -> Params:
    """Inverse of :func:`stack_params_pp` (canonical per-layer names).
    With ``mesh`` the stacks are this rank's layers
    (:func:`shard_params_pp`) and are gathered over ``pp`` first —
    every rank calls it and gets the whole dict."""
    out: Params = {k: v for k, v in stacked.items()
                   if not k.startswith("layers_")}
    for k, v in stacked.items():
        if k.startswith("layers_"):
            w = v.detach() if mesh is None else C.all_gather(v, mesh,
                                                             pp_axis)
            for i in range(cfg.n_layers):
                out[f"L{i}_{k[len('layers_'):]}"] = w[i]
    return out


def shard_params_pp(params: Params, mesh, cfg: TransformerConfig, *,
                    pp_axis: str = "pp") -> Params:
    """This rank's params for :func:`make_train_step_pp`: the layer
    stacks cut to this stage's n_layers/pp layers, the rest as given."""
    return {k: (_block_of(v, mesh, pp_axis, 0).clone()
                if k.startswith("layers_") else v)
            for k, v in stack_params_pp(params, cfg).items()}


def _block_stacked(w: Params, x, cfg: TransformerConfig, pos):
    """One dense decoder block from a single layer's weight dict (no
    name prefixes) with whole-sequence local attention — the pipeline
    stage body. Delegates to :func:`_block`, so the pipeline computes
    the very model of the oracle it is held against."""
    prefixed = {f"L0_{k}": v for k, v in w.items()}
    out, _aux = _block(prefixed, 0, x, cfg,
                       functools.partial(attention_reference, causal=True,
                                         window=cfg.window), pos)
    return out


def make_train_step_pp(cfg: TransformerConfig, mesh, optimizer, *,
                       n_micro: int, pp_axis: str = "pp"):
    """The pipeline-parallel LM train step over a (pp,) mesh,
    ``step(params, tokens, targets) -> loss``, stateful as
    :func:`make_train_step`'s: ``params`` are this rank's, from
    :func:`shard_params_pp`, and every rank passes the whole (B, L)
    batch (B divisible by ``n_micro``). The (n_micro + pp − 1)-tick
    GPipe grid runs forward through :func:`parallel.pipeline.
    pipeline_apply` and autograd runs it backward.

    Every rank computes the same loss from the broadcast outputs, so
    the head's and the final norm's gradients are whole on each; the
    embedding reaches the loss only through stage 0's injection, so the
    microbatches enter through ``collectives.copy_to`` over ``pp`` (its
    backward sums stage 0's cotangent to every rank); a layer's
    gradient stays on the rank that owns it. No gradient is summed over
    ``pp`` afterwards — that would count the head's pp times.

    The stage attends through ``attention_reference``. The JAX
    package's forces ``backend="xla"`` there, so its pipeline stage
    runs no Pallas kernel; the port's calls ``flash_attention``, so on
    a card the stage launches the flash forward (the lse form, under
    autograd) and the dq / dkv backward kernels. The function is the
    same. Every tick runs every local layer, bubbles included."""
    _check_arch(cfg)
    n_pp = mesh.shape[pp_axis]
    if cfg.n_layers % n_pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"{pp_axis}={n_pp}")
    if cfg.moe_experts:
        raise ValueError("pipeline form supports dense blocks only")

    def step(params: Params, tokens, targets):
        dev = params["tok_emb"].device
        tokens = torch.as_tensor(tokens).to(dev).long()
        targets = torch.as_tensor(targets).to(dev).long()
        _check_seq(tokens.shape[1], cfg)
        b, l = tokens.shape
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by "
                             f"n_micro={n_micro}")
        tok_m = tokens.reshape(n_micro, b // n_micro, l)
        tgt_m = targets.reshape(n_micro, b // n_micro, l)
        local = {k[len("layers_"):]: v for k, v in params.items()
                 if k.startswith("layers_")}
        n_local = cfg.n_layers // n_pp
        pos = torch.arange(l, device=dev)
        x_micro = params["tok_emb"][tok_m]
        if not cfg.rope:
            x_micro = x_micro + params["pos_emb"][pos]
        x_micro = C.copy_to(x_micro, mesh, pp_axis)

        def stage(x):
            for j in range(n_local):
                x = _block_stacked({n: w[j] for n, w in local.items()}, x,
                                   cfg, pos)
            return x

        outs = pipeline_apply(stage, x_micro, mesh=mesh, pp_axis=pp_axis,
                              n_stages=n_pp)          # (M, mb, l, d)
        loss = _mean_nll(_norm(params, "lnf", outs, cfg)
                         @ params["tok_emb"].T, tgt_m)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        _apply(optimizer, params, {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)})
        return loss.detach()

    return step
