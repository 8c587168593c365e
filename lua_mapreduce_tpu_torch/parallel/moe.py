"""Expert parallelism: switch-style mixture-of-experts with all_to_all
token routing.

Port of ``lua_mapreduce_tpu/parallel/moe.py``. The router is a learned
partitionfn: each token picks its top-k experts, tokens are bucketed per
expert under a fixed capacity (static shapes), and one ``all_to_all``
over the ``ep`` mesh axis carries every rank's buckets to the ranks
owning those experts; a second brings the expert outputs home, where the
gates' combine weights merge them.

Capacity semantics are the switch transformer's: per routing group
(a rank's token tile), expert e keeps the first ``capacity`` tokens
routed to it in token order, later rounds of top-k after earlier ones;
overflow tokens are dropped (combine weight zero, so they pass through
the residual). The load-balancing auxiliary loss is E · Σ_e (fraction
routed_e / k) · mean gate_e.

Two forms share one body: :func:`moe_ffn_reference` (one device, every
expert local) and :func:`moe_ffn_shard` (experts sharded over a mesh
axis, each rank holding E/ep of every expert stack). Routing is the
sorted form by default — an argsort of the expert assignments and row
gathers, whose backward is gathers too (``_DispatchGather``,
``_CombineGather``) — with the one-hot einsum form as its oracle
(``impl="einsum"``). The expert FFN is a pair of batched f32 products,
``torch.bmm``, as the JAX package leaves its einsums to XLA.

The routing path never reads a value back to the host: counts are a
fixed-size ``scatter_add_``, top-k is a stable descending sort (ties go
to the lower expert index, as ``lax.top_k``'s do), and one-hot masks are
comparisons — so a CUDA graph can capture a decode step through it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from lua_mapreduce_tpu_torch.parallel import collectives as C

Params = Dict[str, torch.Tensor]


def init_moe(seed: Union[int, torch.Generator], d_model: int, d_ff: int,
             n_experts: int, dtype: torch.dtype = torch.float32,
             device: Union[str, torch.device] = "cpu",
             prefix: str = "moe") -> Params:
    """Router and per-expert FFN weights (E stacked), flat name→tensor,
    with the JAX package's names, shapes and scales (router and w1
    N(0,1)/√d, w2 N(0,1)/√d_ff, zero biases). Values come from a CPU
    ``torch.Generator`` — not the JAX package's numbers."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))

    def normal(*shape, scale):
        w = torch.randn(shape, generator=gen) * scale
        return w.to(device=device, dtype=dtype)

    s1, s2 = d_model ** -0.5, d_ff ** -0.5
    return {
        f"{prefix}_router_W": normal(d_model, n_experts, scale=s1),
        f"{prefix}_w1": normal(n_experts, d_model, d_ff, scale=s1),
        f"{prefix}_b1": torch.zeros((n_experts, d_ff), dtype=dtype,
                                    device=device),
        f"{prefix}_w2": normal(n_experts, d_ff, d_model, scale=s2),
        f"{prefix}_b2": torch.zeros((n_experts, d_model), dtype=dtype,
                                    device=device),
    }


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot by comparison: an index outside [0, n) is a zero row
    (``jax.nn.one_hot``'s rule; ``F.one_hot`` raises and syncs)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _gates(x, router_w):
    return torch.softmax(x.float() @ router_w.float(), dim=-1)   # (T, E)


def _top_k(gates: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest gates' expert indices per token, largest first,
    equal gates in ascending index order (``lax.top_k``'s order; the
    order ``torch.topk`` gives equal values is unspecified)."""
    return torch.sort(gates, dim=-1, descending=True,
                      stable=True).indices[:, :k]


def _route(x, router_w, n_experts: int, capacity: int, top_k: int = 1):
    """The one-hot oracle: (dispatch (T, E, C), combine (T, E, C),
    aux). Round j's tokens take slots after rounds < j's; combine
    weights are renormalized over the selected k before the drop."""
    gates = _gates(x, router_w)
    t = x.shape[0]
    dev = gates.device
    counts = torch.zeros(n_experts, device=dev)
    dispatch = torch.zeros((t, n_experts, capacity), device=dev)
    combine = torch.zeros((t, n_experts, capacity), device=dev)
    sel_sum = torch.zeros(t, device=dev)
    frac = torch.zeros(n_experts, device=dev)
    topk_idx = _top_k(gates, top_k)
    for j in range(top_k):
        onehot = _one_hot(topk_idx[:, j], n_experts)            # (T, E)
        pos = ((torch.cumsum(onehot, dim=0) - 1.0)
               + counts[None, :]) * onehot
        kept = onehot * (pos < capacity)
        counts = counts + kept.sum(0)
        pos_c = _one_hot(pos.sum(-1).long(), capacity)          # (T, C)
        disp_j = kept[:, :, None] * pos_c[:, None, :]
        gate_j = (gates * kept).sum(-1)
        dispatch = dispatch + disp_j
        combine = combine + disp_j * gate_j[:, None, None]
        sel_sum = sel_sum + (gates * onehot).sum(-1)
        frac = frac + onehot.mean(0)
    if top_k > 1:
        combine = combine / sel_sum.clamp_min(1e-9)[:, None, None]
    prob = gates.mean(0)
    aux = n_experts * ((frac / top_k) * prob).sum()
    return dispatch, combine, aux


def _route_sorted(x, router_w, n_experts: int, capacity: int,
                  top_k: int = 1):
    """Routing with :func:`_route`'s semantics as a permutation: one
    stable argsort of the (k·T,) assignments orders them by (expert,
    round, token); ranks within each expert come from an exclusive
    cumsum of the counts. Returns token_of_slot, round_of_slot (E, C)
    int64, slot_valid (E, C) bool, slot_of_tok (k, T) int64 (E·C when
    dropped), gate_of_tok (k, T) f32 (zero when dropped) and aux."""
    gates = _gates(x, router_w)
    t = x.shape[0]
    dev = gates.device
    tk = t * top_k
    topk_idx = _top_k(gates, top_k)                             # (T, k)
    # flat order i = j·T + t is (round, token)-lex: _route's fill order
    expert_flat = topk_idx.T.reshape(-1)                        # (k·T,)
    order = torch.argsort(expert_flat, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.long, device=dev)
    counts.scatter_add_(0, expert_flat, torch.ones_like(expert_flat))
    starts = torch.cumsum(counts, 0) - counts                   # exclusive
    expert_sorted = expert_flat[order]
    rank_sorted = torch.arange(tk, device=dev) - starts[expert_sorted]
    slot_sorted = torch.where(rank_sorted < capacity,
                              expert_sorted * capacity + rank_sorted,
                              n_experts * capacity)
    slot_of_tok = torch.empty_like(slot_sorted).scatter_(
        0, order, slot_sorted).reshape(top_k, t)
    cols = torch.arange(capacity, device=dev)
    pos = (starts[:, None] + cols[None, :]).clamp(0, tk - 1)    # (E, C)
    slot_valid = cols[None, :] < counts[:, None]
    token_of_slot = (order % t)[pos]
    round_of_slot = (order // t)[pos]
    sel_gates = torch.gather(gates, 1, topk_idx)                # (T, k)
    kept_tok = slot_of_tok < n_experts * capacity
    gate_of_tok = torch.where(kept_tok, sel_gates.T, 0.0)
    if top_k > 1:
        gate_of_tok = gate_of_tok / sel_gates.sum(1).clamp_min(1e-9)[None]
    prob = gates.mean(0)
    frac = counts.float() / t
    aux = n_experts * ((frac / top_k) * prob).sum()
    return (token_of_slot, round_of_slot, slot_valid, slot_of_tok,
            gate_of_tok, aux)


def _flat_with_sentinel(a):
    """(E, C, d) → (E·C + 1, d) with a zero row at E·C, the row every
    dropped ``slot_of_tok`` entry reads."""
    e, c, d = a.shape
    return torch.cat([a.reshape(e * c, d), a.new_zeros((1, d))])


class _DispatchGather(torch.autograd.Function):
    """(T, d) tokens → (E, C, d) expert buckets by a row gather; the
    backward is the inverse gather through ``slot_of_tok`` (kept slots
    and kept (round, token) pairs are a bijection), not a scatter-add."""

    @staticmethod
    def forward(ctx, xf, token_of_slot, slot_valid, slot_of_tok):
        ctx.save_for_backward(slot_of_tok)
        return torch.where(slot_valid[..., None], xf[token_of_slot], 0.0)

    @staticmethod
    def backward(ctx, dxe):
        slot_of_tok, = ctx.saved_tensors
        dx = _flat_with_sentinel(dxe)[slot_of_tok].sum(0)       # (T, d)
        return dx, None, None, None


class _CombineGather(torch.autograd.Function):
    """(E, C, d) expert outputs → (T, d) tokens, gate-weighted. Both
    cotangents (the outputs' and the gates', through which the router
    trains) are gathers over the slot↔token bijection."""

    @staticmethod
    def forward(ctx, ye, gate_of_tok, token_of_slot, round_of_slot,
                slot_valid, slot_of_tok):
        ctx.save_for_backward(ye, gate_of_tok, token_of_slot,
                              round_of_slot, slot_valid, slot_of_tok)
        return (gate_of_tok[..., None]
                * _flat_with_sentinel(ye)[slot_of_tok]).sum(0)

    @staticmethod
    def backward(ctx, dout):
        (ye, gate_of_tok, token_of_slot, round_of_slot, slot_valid,
         slot_of_tok) = ctx.saved_tensors
        gate_of_slot = gate_of_tok[round_of_slot, token_of_slot]  # (E, C)
        dye = torch.where(slot_valid[..., None],
                          gate_of_slot[..., None] * dout[token_of_slot], 0.0)
        dgate = (_flat_with_sentinel(ye)[slot_of_tok]
                 * dout[None, :, :]).sum(-1)
        return dye, dgate, None, None, None, None


def _expert_ffn(w1, b1, w2, b2, x):
    """Batched expert FFN, x (E, C, d) → (E, C, d), f32: two ``bmm``
    (the JAX einsum pair), tanh-approximate GELU as ``jax.nn.gelu``."""
    h = F.gelu(torch.bmm(x, w1) + b1[:, None, :], approximate="tanh")
    return torch.bmm(h, w2) + b2[:, None, :]


def _moe_ffn(params: Params, x, capacity: int, prefix: str,
             ep: Optional[Tuple[object, str]], top_k: int = 1,
             impl: str = "sorted"):
    """One body for both forms: ``ep`` None keeps every expert local;
    ``(mesh, axis)`` adds the two all_to_all shuffles (experts sharded
    over ``axis``) and averages the aux loss over it."""
    w = {k[len(prefix) + 1:]: v for k, v in params.items()
         if k.startswith(prefix + "_")}
    n_experts = w["router_W"].shape[1]          # the global expert count
    xf = x.float()
    if impl == "sorted":
        (tok_of_slot, round_of_slot, slot_valid, slot_of_tok, gate_of_tok,
         aux) = _route_sorted(x, w["router_W"], n_experts, capacity,
                              top_k=top_k)
        xe = _DispatchGather.apply(xf, tok_of_slot, slot_valid, slot_of_tok)
    elif impl == "einsum":
        dispatch, combine, aux = _route(x, w["router_W"], n_experts,
                                        capacity, top_k=top_k)
        xe = torch.einsum("tec,td->ecd", dispatch, xf)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    if ep is not None:
        # (E, C, d) → (E/ep, ep·C, d): rank p receives every peer's
        # buckets for its local experts — the shuffle
        xe = C.all_to_all(xe, *ep, split_axis=0, concat_axis=1)
    ye = _expert_ffn(w["w1"].float(), w["b1"].float(), w["w2"].float(),
                     w["b2"].float(), xe)
    if ep is not None:
        ye = C.all_to_all(ye, *ep, split_axis=1, concat_axis=0)
    if impl == "sorted":
        out = _CombineGather.apply(ye, gate_of_tok, tok_of_slot,
                                   round_of_slot, slot_valid, slot_of_tok)
    else:
        out = torch.einsum("tec,ecd->td", combine, ye)
    if ep is not None:
        aux = C.mean_over(aux, *ep)
    return out.to(x.dtype), aux


def moe_ffn_reference(params: Params, x, *, capacity: int,
                      prefix: str = "moe", top_k: int = 1,
                      impl: str = "sorted"):
    """Single-device oracle: (T, d) tokens → ((T, d) out, aux loss)."""
    return _moe_ffn(params, x, capacity, prefix, None, top_k=top_k,
                    impl=impl)


def moe_ffn_shard(params: Params, x, *, capacity: int, mesh,
                  ep_axis: str, prefix: str = "moe", top_k: int = 1,
                  impl: str = "sorted"):
    """Expert-parallel form, run on every rank of ``mesh``: the router
    is replicated, the expert stacks are this rank's E/ep experts;
    ``x`` is this rank's (T, d) tile, routed on its own (capacity per
    tile), so the result equals the reference applied tile by tile.
    Gradients flow through the all_to_alls: an expert stack's gradient
    on a rank holds every ep peer's tokens' share."""
    return _moe_ffn(params, x, capacity, prefix, (mesh, ep_axis),
                    top_k=top_k, impl=impl)
