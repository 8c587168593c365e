"""Decoder-only transformer LM — single-device serving and training.

Port of ``lua_mapreduce_tpu/models/transformer.py`` for one device:
:func:`init_transformer`, the oracle :func:`transformer_apply`,
:func:`prefill`, KV-cached :func:`greedy_decode` (prefill or
position-scan ingestion, GQA, sliding window with a rolling cache, int8
KV cache, greedy or sampled tokens; on a card one step captured in a
CUDA graph and replayed per position), the int8 serving copy
:func:`quantize_lm`, and the LM trainer: :func:`lm_loss_local` and
:func:`make_train_step` (ring attention on one shard, ``cfg.remat``,
gradient accumulation). On a card the attention runs the port's flash
kernels (forward; dq and dkv in the backward) and decode kernel, and
the projections of a quantized dict run the q8 kernel; plain dense
projections ``y @ W``, the unquantized head and the loss's log_softmax
stay torch, as the JAX package leaves them to XLA.

Not in the port yet, and raising: MoE blocks, sequence parallelism
(``mesh=`` beyond one device, zigzag, Ulysses) and ZeRO-1.

Params are a flat name→tensor dict with the JAX package's names and
layouts (carry JAX params across with ``convert.params_from_jax``).
Activations are (B, L, D); heads split D as (H, D/H).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.graphs import CapturedGraph, on_side_stream
from lua_mapreduce_tpu_torch.ops.attention import flash_attention
from lua_mapreduce_tpu_torch.ops.decode import decode_attention, quantize_kv
from lua_mapreduce_tpu_torch.ops.q8 import q8_matmul, quantize_q8
from lua_mapreduce_tpu_torch.parallel.ring_attention import (
    _ring_shard, attention_reference)
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
    # mixture-of-experts (not in the port yet: raises)
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


def _no_moe(cfg: TransformerConfig) -> None:
    if cfg.moe_experts:
        raise NotImplementedError(
            "MoE blocks are not in the port yet (ROADMAP A5: "
            "parallel/moe.py); serve a dense config")


def init_transformer(seed: Union[int, torch.Generator] = 0,
                     cfg: TransformerConfig = TransformerConfig(),
                     dtype: torch.dtype = torch.float32,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Params:
    """Flat params with the JAX package's names and shapes: tok/pos
    embeddings (0.02·N(0,1)), per layer a fused qkv and an out
    projection, the FFN and two norms, a final norm; the LM head is tied
    to the token embedding. Values come from a CPU ``torch.Generator``
    (``seed``), then move to ``device`` (default ``"cuda"``) and
    ``dtype`` — not the JAX package's numbers for the same seed."""
    _check_moe(cfg)
    _check_arch(cfg)
    _no_moe(cfg)
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
        if cfg.ffn == "swiglu":
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
    embedding gather; biases and norms are untouched."""
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


def _ffn(params: Params, p: str, y, cfg: TransformerConfig):
    """The block's dense FFN. Returns (out, aux loss 0.0)."""
    _no_moe(cfg)
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
           pos, kv_sink: Optional[list] = None):
    """One pre-norm decoder block; ``attn_fn(q, k, v) -> out``; ``pos``
    the global positions of the L rows (rope). ``kv_sink`` (a list)
    captures this block's (k, v) — rotated k under rope — for the decode
    cache. Returns (x, moe aux 0.0)."""
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
    out, aux = _ffn(params, p, y, cfg)
    return x + out, aux


def _check_seq(global_len: int, cfg: TransformerConfig) -> None:
    if global_len > cfg.max_seq:
        raise ValueError(
            f"sequence length {global_len} exceeds max_seq={cfg.max_seq}")


def _forward(params: Params, tokens, pos, cfg: TransformerConfig, attn_fn,
             block=None):
    """Shared body: tokens (B, L), pos (L,) global positions. Returns
    (logits, moe aux 0.0). With ``cfg.remat`` each block runs under
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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sequence-parallel prefill (mesh=) is not in the port yet "
            "(ROADMAP A5: parallel/ring_attention.py)")


def prefill(params: Params, prompt, *,
            cfg: TransformerConfig = TransformerConfig(),
            total: Optional[int] = None, mesh=None):
    """Parallel prompt ingestion: one causal forward over the (B, P)
    prompt (flash attention) yields every layer's (k, v) — the decode KV
    cache — and the last position's logits.

    Returns ``(caches, last_logits)``: caches maps ``L{i}_{k,v}`` to
    (B, total, H_kv, hd) in tok_emb's dtype, zero-padded past P (total
    defaults to P); last_logits is (B, vocab) f32. Logits are computed
    for every prompt position and the last taken, as the JAX package
    does. Single device only (``mesh`` raises)."""
    b, p_len = prompt.shape
    if p_len < 1:
        raise ValueError("prompt must contain at least one token")
    _check_arch(cfg)
    _no_mesh(mesh)
    total = p_len if total is None else total
    if total < p_len:
        raise ValueError(f"total={total} shorter than the prompt {p_len}")
    _check_seq(total, cfg)
    cfg_fwd = dataclasses.replace(cfg, remat=False)  # capture ≠ remat
    tokens = prompt.to(params["tok_emb"].device).long()
    sink: list = []
    logits, _ = _forward(
        params, tokens, torch.arange(p_len, device=tokens.device), cfg_fwd,
        lambda q, k, v: flash_attention(q, k, v, causal=True,
                                        window=cfg.window),
        block=functools.partial(_block, kv_sink=sink))
    caches = {}
    dt = params["tok_emb"].dtype
    for i, (k, v) in enumerate(sink):
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
                  kv_q8: bool = False):
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
    same step runs eagerly. MoE configs and ``mesh`` raise
    NotImplementedError: not in the port yet."""
    _check_arch(cfg)
    if cfg.moe_experts:
        _check_moe(cfg)
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature > 0 and key is None:
        raise ValueError("sampling (temperature > 0) needs a PRNG key")
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    _no_moe(cfg)
    _no_mesh(mesh)
    b, p_len = prompt.shape
    if p_len < 1:
        raise ValueError("prompt must contain at least one token "
                         "(an empty prompt would silently return an "
                         "empty continuation)")
    total = p_len + n_new
    _check_seq(total, cfg)
    dev = params["tok_emb"].device
    prompt = prompt.to(dev).long()
    if n_new == 0:
        return prompt.to(torch.int32)
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
            ff, _ = _ffn(params, pfx, y, cfg)
            x = x + ff
        x = _norm(params, "lnf", x, cfg)
        nxt = select(_head(params, x)[:, 0], t)
        given = out.index_select(1, pos + 1)[:, 0]
        out.index_copy_(1, pos + 1,
                        torch.where(pos + 1 < p_len, given, nxt)[:, None])
        t.add_(1)

    if use_prefill:
        caches, last_logits = prefill(params, prompt, cfg=cfg, total=total)
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


def _attn_shard_fn(attn: str, n_sp: int, cfg: TransformerConfig):
    """The attention body of the train step, resolved strictly at
    factory time: ``"ring"`` is the ring body on ``n_sp`` shards (one,
    in the port); ``"zigzag"`` and ``"ulysses"`` are the
    sequence-parallel slice and raise."""
    if cfg.window and attn != "ring":
        raise ValueError(
            "sliding-window attention (cfg.window > 0) runs "
            "sequence-parallel as the BANDED contiguous ring "
            "(attn='ring'); zigzag balances full-causal work a window "
            "already bounds, and ulysses materializes full-sequence "
            "heads per device")
    if attn == "ring":
        return functools.partial(_ring_shard, n_shards=n_sp, causal=True,
                                 window=cfg.window)
    if attn in ("zigzag", "ulysses"):
        raise NotImplementedError(
            f"attn={attn!r} is a sequence-parallel schedule, not in the "
            f"port yet (ROADMAP A5); use attn='ring' on one device")
    raise ValueError(f"unknown attn {attn!r} "
                     f"(want 'ring', 'zigzag' or 'ulysses')")


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


def _single_device(mesh) -> None:
    """``mesh`` is None or a mesh of one device: anything whose
    ``shape`` (or the object itself) maps axis names to sizes of 1."""
    if mesh is None:
        return
    sizes = dict(getattr(mesh, "shape", mesh))
    if any(int(n) != 1 for n in sizes.values()):
        raise NotImplementedError(
            f"a {sizes} mesh is data/sequence parallel, not in the port "
            f"yet (ROADMAP A3/A5); pass mesh=None for one device")


def make_train_step(cfg: TransformerConfig, optimizer, *, mesh=None,
                    attn: str = "ring", grad_accum: int = 1,
                    zero1: bool = False):
    """The single-device LM train step, ``step(params, tokens, targets)
    -> loss``.

    The JAX package's ``make_train_step(cfg, mesh, optimizer)`` returns
    a pure ``step(params, opt_state, tokens, targets) -> (params,
    opt_state, loss)`` jitted with donated buffers. Here the step is
    stateful: ``optimizer`` is a ``torch.optim`` optimizer (or
    :class:`~lua_mapreduce_tpu_torch.train.precision.F32Master`) built
    over the tensors of ``params``, and holds what ``opt_state`` holds;
    the step computes the mean next-token NLL and its gradient (through
    ``accum_value_and_grad`` over ``grad_accum`` microbatches when > 1),
    writes each gradient to its parameter's ``.grad``, steps the
    optimizer — the parameters update in place — and returns the loss,
    a detached 0-d tensor. ``tokens``/``targets`` are (B, L) integer
    tensors or arrays, moved to the parameters' device.

    Attention is ``attn="ring"`` on one shard (``_ring_shard``: the flash
    op's lse form merged into the ring accumulator, so its backward
    takes the lse cotangent too). ``mesh`` beyond one device, zigzag,
    Ulysses, ``zero1`` and MoE configs raise NotImplementedError;
    ``grad_accum > 1`` with MoE keeps the JAX package's ValueError."""
    if zero1:
        raise NotImplementedError(
            "zero1 shards optimizer state over a data-parallel axis, not "
            "in the port yet (ROADMAP A5)")
    _single_device(mesh)
    _check_arch(cfg)
    if cfg.moe_experts:
        if grad_accum > 1:
            raise ValueError(
                "grad_accum > 1 with moe_experts > 0 would silently "
                "change the numbers: MoE capacity and the aux loss are "
                "defined per device tile, so quarter-size microbatches "
                "drop/route tokens differently than the whole tile")
        _check_moe(cfg, 1)
    _no_moe(cfg)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    attn_fn = _attn_shard_fn(attn, 1, cfg)

    def step(params: Params, tokens, targets):
        dev = params["tok_emb"].device
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        _check_seq(tokens.shape[1], cfg)
        pos = torch.arange(tokens.shape[1], device=dev)

        def loss_fn(p, tok, tgt):
            return lm_loss_local(p, tok, tgt, cfg, attn_fn, pos)

        if grad_accum == 1:
            loss = loss_fn(params, tokens, targets)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            grads = dict(zip(params, grads))
            loss = loss.detach()
        else:
            loss, grads = accum_value_and_grad(
                loss_fn, params, (tokens, targets), grad_accum)
        for k, p in params.items():
            g = grads[k]
            p.grad = torch.zeros_like(p) if g is None else g
        optimizer.step()
        return loss

    return step
