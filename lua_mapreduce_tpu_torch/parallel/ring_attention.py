"""Ring attention on one shard, and the single-device oracle.

Port of ``lua_mapreduce_tpu/parallel/ring_attention.py:53-187``. The
ring folds each key/value block through the flash op's ``return_lse``
form and merges the partial outputs by logaddexp weights; here it runs
with ``n_shards == 1``, where the only block is the local one: the
causal fold takes the diagonal branch, and with a window it is hop 0 of
the banded ring. That is the attention the single-device LM train step
runs, so its gradient flows through both the out and the lse of the
flash op. The multi-shard ring (KV rotation between devices), zigzag
and Ulysses come with the sequence-parallel slice.
"""

from __future__ import annotations

import torch

from lua_mapreduce_tpu_torch.ops.attention import flash_attention

_NEG_INF = -1e30      # finite mask fill: -inf breaks the m-subtraction


def attention_reference(q, k, v, *, causal: bool = False, window: int = 0):
    """Single-device softmax attention, (B, L, H, D) layout — one oracle
    for the whole port (delegates to the kernel library's
    ``flash_attention``: the plain version on the CPU, the kernel on a
    card)."""
    return flash_attention(q, k, v, causal=causal, window=window)


def _flash_block(q, kb, vb, causal: bool, window: int = 0,
                 q_offset: int = 0):
    """One attention block through the flash op, returning (out, lse):
    f32 out and (B, L, H) lse, the mergeable-softmax state."""
    return flash_attention(q, kb, vb, causal=causal, return_lse=True,
                           window=window, q_offset=q_offset)


def _merge_block(o, lse, blk):
    """Merge a block's (out_b, lse_b) into the running normalized
    (o, lse) by logaddexp weights; all f32, (B, Lq, H, D) / (B, Lq, H)."""
    ob, lseb = blk
    lse_new = torch.logaddexp(lse, lseb)
    w_old = torch.exp(lse - lse_new)[..., None]
    w_new = torch.exp(lseb - lse_new)[..., None]
    return o * w_old + ob.float() * w_new, lse_new


def _causal_switch(src: int, my: int, o, lse, full_fn, diag_fn):
    """Fold of an aligned causal block pair: src < my → full attention,
    src == my → the diagonal (causal) block, src > my → skipped."""
    if src < my:
        return _merge_block(o, lse, full_fn())
    if src == my:
        return _merge_block(o, lse, diag_fn())
    return o, lse


def _ring_init(q):
    """(o, lse) accumulators: zeros and -1e30, f32. (The JAX package
    derives them from q for shard_map's varying-axes typing; torch needs
    no such link.)"""
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:-1], _NEG_INF, dtype=torch.float32,
                     device=q.device)
    return o, lse


def _ring_shard(q, k, v, *, n_shards: int, causal: bool, window: int = 0):
    """The ring body on one shard: start the (o, lse) accumulator, fold
    the local block once, return o in q's dtype. ``n_shards > 1`` is the
    sequence-parallel ring and raises."""
    if n_shards != 1:
        raise NotImplementedError(
            f"ring attention over {n_shards} shards is the sequence-"
            f"parallel slice, not in the port yet (ROADMAP A7); run one "
            f"shard")
    o, lse = _ring_init(q)
    if causal and window:
        # hop 0 of the banded ring: the local block, live on every shard
        o, lse = _merge_block(o, lse, _flash_block(q, k, v, True,
                                                   window=window))
        return o.to(q.dtype)
    my = 0
    if causal:
        o, lse = _causal_switch(my, my, o, lse,
                                lambda: _flash_block(q, k, v, False),
                                lambda: _flash_block(q, k, v, True))
    else:
        o, lse = _merge_block(o, lse, _flash_block(q, k, v, False))
    return o.to(q.dtype)
