"""Sequence parallelism: ring attention and Ulysses all-to-all.

Port of ``lua_mapreduce_tpu/parallel/ring_attention.py``. Both compute
exactly softmax attention over a sequence sharded on a mesh axis
(default ``"sp"``), (B, L, H, D) layout:

- **Ring** (:func:`ring_attention`): local q stays, the (k, v) block
  rotates one neighbour per hop (:func:`collectives.ring_hops`, the
  port's ``ppermute``), and each hop folds the block it holds through
  the flash op's ``return_lse`` form, merged into an f32 (o, lse)
  accumulator by logaddexp weights — on a card every fold is the flash
  kernel forward, and in training its dq / dkv kernels. Causal blocks
  are full, diagonal or skipped by shard index; ``window > 0`` is the
  banded ring, which stops after the hops that hold a visible key.
- **Zigzag** (``schedule="zigzag"``): shard d holds stripes d and
  2P-1-d, balancing the causal ring; each hop folds its block by
  quadrant.
- **Ulysses** (:func:`ulysses_attention`): one all_to_all reshards
  sequence → heads, each rank attends its heads over the whole
  sequence, a second reshards back.

Each rank is a process of a ``torch.distributed`` world. The bodies
(``_ring_shard`` and friends) take this rank's shard and run on every
rank; the public functions take the global (B, L, H, D) tensors on
every rank alike, run the body on this rank's shard, and gather the
output — a drop-in for the JAX functions, gradients included. Every
rank posts the same collectives on every hop, skipped fold or not.
"""

from __future__ import annotations

import numpy as np
import torch

from lua_mapreduce_tpu_torch.ops.attention import flash_attention
from lua_mapreduce_tpu_torch.parallel import collectives as C

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


def _hops(k, v, mesh, axis: str, n: int):
    """The (k, v) blocks a ring holds: the local one (hop 0), then after
    each of ``n`` hops the block of the next shard back. k and v rotate
    stacked, through one :func:`collectives.ring_hops` node, so every
    rank's backward posts the same ``n`` send/recv pairs even where its
    causal mask skips a block."""
    if n == 0:
        return [(k, v)]
    return [(kv[0], kv[1]) for kv in C.ring_hops(torch.stack([k, v]), mesh,
                                                  axis, n)]


def _ring_shard(q, k, v, *, n_shards: int, causal: bool, window: int = 0,
                mesh=None, axis: str = "sp"):
    """The ring body on this rank's shard: fold the local block, then
    ``n_shards - 1`` hops, after hop i holding the block of shard
    (my - i) mod n. With ``window`` (causal) the banded ring: hop i's
    fold is the kernel's banded mask at the offset i·L_loc, and the
    ring stops after ceil((window - 1) / L_loc) hops. Returns o in q's
    dtype. ``mesh`` may be None for one shard."""
    my = mesh.axis_index(axis) if n_shards > 1 else 0
    l_loc = q.shape[1]
    o, lse = _ring_init(q)
    if causal and window:
        hops = min(n_shards - 1, (window + l_loc - 2) // l_loc)
        blocks = _hops(k, v, mesh, axis, hops)
        # hop 0, the local block, is live on every shard
        o, lse = _merge_block(o, lse, _flash_block(q, *blocks[0], True,
                                                   window=window))
        for i, (kb, vb) in enumerate(blocks[1:], 1):
            # wrapped sources (my < i) lie above the causal diagonal
            if my >= i:
                o, lse = _merge_block(o, lse, _flash_block(
                    q, kb, vb, True, window=window, q_offset=i * l_loc))
        return o.to(q.dtype)

    def fold(o, lse, kb, vb, src):
        if causal:
            return _causal_switch(src, my, o, lse,
                                  lambda: _flash_block(q, kb, vb, False),
                                  lambda: _flash_block(q, kb, vb, True))
        return _merge_block(o, lse, _flash_block(q, kb, vb, False))

    for i, (kb, vb) in enumerate(_hops(k, v, mesh, axis, n_shards - 1)):
        o, lse = fold(o, lse, kb, vb, (my - i) % n_shards)
    return o.to(q.dtype)


def _zigzag_perm(seq_len: int, n_shards: int) -> np.ndarray:
    """Global zigzag permutation: shard d holds stripe d and stripe
    2P-1-d (one from each end of the sequence), so every shard's
    visible share of a causal ring hop is about equal."""
    h = seq_len // (2 * n_shards)
    idx = []
    for d in range(n_shards):
        idx.extend(range(d * h, (d + 1) * h))
        idx.extend(range((2 * n_shards - 1 - d) * h, (2 * n_shards - d) * h))
    return np.asarray(idx)


def _zigzag_check(seq_len: int, n_shards: int) -> None:
    """Every zigzag entry point's validation: two stripes a shard."""
    if seq_len % (2 * n_shards):
        raise ValueError(f"zigzag needs seq len divisible by 2×sp: "
                         f"{seq_len} vs {2 * n_shards}")


def _take_seq(x, idx: np.ndarray):
    """``x[:, idx]`` for a numpy array or a tensor (moved to x's
    device)."""
    if isinstance(x, torch.Tensor):
        return x[:, torch.as_tensor(idx, device=x.device)]
    return x[:, idx]


def to_zigzag(x, n_shards: int):
    """Standard → zigzag sequence layout on axis 1 of ``x`` (a numpy
    array or a tensor, (B, L, ...)). Apply once, and run the zigzag
    entry points with ``layout="zigzag"``."""
    _zigzag_check(x.shape[1], n_shards)
    return _take_seq(x, _zigzag_perm(x.shape[1], n_shards))


def from_zigzag(x, n_shards: int):
    """Inverse of :func:`to_zigzag` (zigzag → standard order)."""
    _zigzag_check(x.shape[1], n_shards)
    return _take_seq(x, _zigzag_perm(x.shape[1], n_shards).argsort())


def _ring_shard_zigzag(q, k, v, *, n_shards: int, causal: bool, mesh=None,
                       axis: str = "sp"):
    """Zigzag body: local rows are [low stripe ‖ high stripe]. Each
    block folds by quadrant: (q_low, k_low) full / causal / skipped by
    shard index, (q_high, k_low) always full, (q_high, k_high) the
    mirrored diagonal, (q_low, k_high) always masked and omitted."""
    h = q.shape[1] // 2
    my = mesh.axis_index(axis) if n_shards > 1 else 0
    q_lo, q_hi = q[:, :h], q[:, h:]
    o, lse = _ring_init(q)

    def fold(o, lse, kb, vb, src):
        if not causal:
            return _merge_block(o, lse, _flash_block(q, kb, vb, False))
        k_lo, k_hi = kb[:, :h], kb[:, h:]
        v_lo, v_hi = vb[:, :h], vb[:, h:]
        o_lo, lse_lo = _causal_switch(
            src, my, o[:, :h], lse[:, :h],
            lambda: _flash_block(q_lo, k_lo, v_lo, False),
            lambda: _flash_block(q_lo, k_lo, v_lo, True))
        o_hi, lse_hi = _merge_block(o[:, h:], lse[:, h:],
                                    _flash_block(q_hi, k_lo, v_lo, False))
        o_hi, lse_hi = _causal_switch(
            my, src, o_hi, lse_hi,
            lambda: _flash_block(q_hi, k_hi, v_hi, False),
            lambda: _flash_block(q_hi, k_hi, v_hi, True))
        return torch.cat([o_lo, o_hi], dim=1), torch.cat([lse_lo, lse_hi],
                                                         dim=1)

    for i, (kb, vb) in enumerate(_hops(k, v, mesh, axis, n_shards - 1)):
        o, lse = fold(o, lse, kb, vb, (my - i) % n_shards)
    return o.to(q.dtype)


def _ulysses_shard(q, k, v, *, n_shards: int, causal: bool, mesh=None,
                   axis: str = "sp"):
    """Ulysses body: all_to_all sequence-sharded → head-sharded, this
    rank's heads over the whole sequence through the flash op, and
    all_to_all back."""
    if n_shards == 1:
        return flash_attention(q, k, v, causal=causal)

    def seq_to_heads(x):                 # (B, L/P, H, D) → (B, L, H/P, D)
        return C.all_to_all(x, mesh, axis, split_axis=2, concat_axis=1)

    out = flash_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                          causal=causal)
    return C.all_to_all(out, mesh, axis, split_axis=1, concat_axis=2)


def _sharded_call(body, q, k, v, mesh, axis: str):
    """Run ``body`` on this rank's sequence shard of the global q, k, v
    (alike on every rank) and gather the output: the JAX shard_map with
    in/out specs P(None, axis), gradients to the global inputs."""
    q, k, v = (C.shard_replicated(x, mesh, axis, 1) for x in (q, k, v))
    return C.gather_replicated(body(q, k, v, n_shards=mesh.shape[axis],
                                    mesh=mesh, axis=axis), mesh, axis, 1)


def ring_attention(q, k, v, mesh, *, axis: str = "sp",
                   causal: bool = False, schedule: str = "contiguous",
                   layout: str = "seq", window: int = 0):
    """Exact attention over a sequence sharded on ``axis`` of ``mesh``.

    Every rank passes the same global (B, L, H, D) tensors and gets the
    whole output; L must divide by the axis size. ``schedule="zigzag"``
    load-balances the causal ring (inputs permuted, the output
    un-permuted); ``layout="zigzag"`` declares q/k/v already in zigzag
    order and returns the output in that order. ``window`` (causal,
    contiguous schedule) is the banded ring."""
    n_shards = mesh.shape[axis]
    if schedule not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring schedule {schedule!r}")
    if layout not in ("seq", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    if window:
        if not causal:
            raise ValueError("windowed ring attention implies causal")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if schedule == "zigzag":
            raise ValueError("the banded ring runs the contiguous "
                             "schedule (zigzag balances full-causal "
                             "work; a window already bounds per-device "
                             "work by construction)")
    if layout == "zigzag" and schedule != "zigzag":
        raise ValueError("layout='zigzag' requires schedule='zigzag'")
    permute = schedule == "zigzag" and layout == "seq"
    if schedule == "zigzag":
        _zigzag_check(q.shape[1], n_shards)
    elif q.shape[1] % n_shards:
        raise ValueError(
            f"seq len {q.shape[1]} not divisible by {axis}={n_shards}")
    if permute:
        q, k, v = (to_zigzag(x, n_shards) for x in (q, k, v))
    if schedule == "zigzag":
        def body(*a, **kw):
            return _ring_shard_zigzag(*a, causal=causal, **kw)
    else:
        def body(*a, **kw):
            return _ring_shard(*a, causal=causal, window=window, **kw)
    out = _sharded_call(body, q, k, v, mesh, axis)
    return from_zigzag(out, n_shards) if permute else out


def ulysses_attention(q, k, v, mesh, *, axis: str = "sp",
                      causal: bool = False):
    """Exact attention via the all-to-all (Ulysses) reshard; global
    tensors on every rank, as :func:`ring_attention`. Heads and kv
    heads must divide by the axis size."""
    n_shards = mesh.shape[axis]
    if q.shape[2] % n_shards:
        raise ValueError(
            f"{q.shape[2]} heads not divisible by {axis}={n_shards}")
    if k.shape[2] % n_shards:
        raise ValueError(
            f"{k.shape[2]} kv heads not divisible by {axis}={n_shards} "
            f"(GQA over ulysses reshards BOTH head sets)")
    if q.shape[1] % n_shards:
        raise ValueError(
            f"seq len {q.shape[1]} not divisible by {axis}={n_shards}")

    def body(*a, **kw):
        return _ulysses_shard(*a, causal=causal, **kw)
    return _sharded_call(body, q, k, v, mesh, axis)
