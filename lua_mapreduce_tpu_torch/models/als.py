"""ALS matrix factorization — the second iterative-state workload
(BASELINE.json config 5).

Port of ``lua_mapreduce_tpu/models/als.py``. Alternating least squares
on an observed ratings matrix R ≈ U Vᵀ with an observation mask W, in
the reference's looping-MapReduce shape (SURVEY.md §3.5): each round the
"map" solves the user factors of a shard of users given the replicated
item factors V, then folds that shard's contribution to every item's
normal equations; the "reduce" sums those (k×k, k) partials across
shards (an all-reduce with a mesh); the "final" solves every item's
system and loops. Users stay split over ``dp`` for the whole fit, and on
a card a round is captured once in a CUDA graph and replayed
(``graphs.scan``).

The JAX module writes the normal equations as a ``vmap`` of per-row
products and a three-operand ``einsum``; contracted in pairs at
MovieLens-1M's shape that einsum builds a (users, items, rank)
intermediate of ~5.7 GB. Here each side is one product instead:
A_u = W · (V⊗V) and b = (W∘R) · V for the users, A_i = Wᵀ · (U⊗U) and
b = (W∘R)ᵀ · U for the items, (rows, ratings)·(ratings, rank²) products
through the port's matmul kernel (``ops.matmul``, f32). The batched
rank×rank systems (SPD: + λI) are solved by Cholesky —
``cholesky_ex`` and two triangular solves, none of which waits for the
host (``torch.linalg.solve`` checks for singular matrices on the host,
which a captured round cannot do).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from lua_mapreduce_tpu_torch import graphs, ops
from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.parallel import collectives as C
from lua_mapreduce_tpu_torch.parallel.tpu_engine import shard_rows


class ALSResult(NamedTuple):
    user_factors: torch.Tensor  # (n_users, k)
    item_factors: torch.Tensor  # (n_items, k)
    rmse: torch.Tensor          # scalar: final masked train RMSE
    history: torch.Tensor       # (n_iters,) RMSE per iteration


def init_item_factors(seed: Union[int, torch.Generator], n_items: int,
                      rank: int, scale: float = 0.1) -> torch.Tensor:
    """``scale`` × standard normal (n_items, rank) factors on the CPU,
    from an int seed or a CPU ``torch.Generator`` (the JAX key's
    counterpart; the numbers differ from the JAX package's)."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    return scale * torch.randn((n_items, rank), generator=gen)


def _outer_rows(v: torch.Tensor) -> torch.Tensor:
    """(n, k) → (n, k²): each row's outer product v vᵀ, flattened."""
    return (v[:, :, None] * v[:, None, :]).reshape(v.shape[0], -1)


def _spd_solve(a: torch.Tensor, b: torch.Tensor, reg: float) -> torch.Tensor:
    """Solve (a_i + reg·I) x_i = b_i for a batch of SPD (k, k) systems."""
    k = a.shape[-1]
    eye = reg * torch.eye(k, dtype=a.dtype, device=a.device)
    lower, _ = torch.linalg.cholesky_ex(a + eye)
    y = torch.linalg.solve_triangular(lower, b[..., None], upper=False)
    return torch.linalg.solve_triangular(lower.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def _solve_users(r: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                 reg: float) -> torch.Tensor:
    """Per-user ridge solve, batched: for each user u,
    (Vᵀ W_u V + λI) x = Vᵀ W_u r_u. r/w are this shard's (n_u, n_items)."""
    k = v.shape[1]
    a = ops.matmul(w, _outer_rows(v)).reshape(-1, k, k)   # Σ_i w_ui v_i v_iᵀ
    b = ops.matmul(w * r, v)                              # Σ_i w_ui r_ui v_i
    return _spd_solve(a, b, reg)


def _item_partials(r: torch.Tensor, w: torch.Tensor, u: torch.Tensor):
    """This shard's contribution to every item's normal equations:
    A_i += Σ_u w_ui u_u u_uᵀ, b_i += Σ_u w_ui r_ui u_u — the quantity the
    reduce phase sums (associative and commutative, the combiner
    contract of SURVEY.md §2.5)."""
    k = u.shape[1]
    a = ops.matmul(w.t(), _outer_rows(u)).reshape(-1, k, k)   # (n_items, k, k)
    b = ops.matmul((w * r).t(), u)                            # (n_items, k)
    return a, b


@torch.no_grad()
def als_fit(ratings, mask, item_factors0, *, n_iters: int = 10,
            reg: float = 0.1, mesh=None, axis: str = "dp",
            device: Optional[Union[str, torch.device]] = None) -> ALSResult:
    """Run ``n_iters`` ALS rounds from item factors ``item_factors0``.

    With a ``mesh``, every rank passes the same global ratings/mask and
    keeps its users (rows, split over ``axis``); item factors stay
    replicated and the item-step normal equations are all-reduced; the
    final user factors are all-gathered, so every rank returns the same
    result. Without a mesh the fit runs on ``device`` (default
    ``"cuda"``). ``history[i]`` is the masked RMSE measured with the
    factors produced by round i.
    """
    if mesh is not None:
        dev = mesh.device
        r = shard_rows(ratings, mesh, axis).float()
        w = shard_rows(mask, mesh, axis).float()
    else:
        dev = resolve_device(device)
        r = torch.as_tensor(ratings).to(dev, torch.float32)
        w = torch.as_tensor(mask).to(dev, torch.float32)
    v0 = torch.as_tensor(item_factors0).to(dev, torch.float32)

    def one_iter(v):
        u = _solve_users(r, w, v, reg)                  # map: user shard
        a, b = _item_partials(r, w, u)                  # combine
        if mesh is not None:
            a, b = C.psum_tree((a, b), mesh, axis)      # reduce
        v_new = _spd_solve(a, b, reg)
        err = w * (ops.matmul(u, v_new.t()) - r)
        sq, cnt = (err ** 2).sum(), w.sum()
        if mesh is not None:
            sq, cnt = C.psum_tree((sq, cnt), mesh, axis)
        return v_new, torch.sqrt(sq / cnt.clamp_min(1.0))

    v, hist = graphs.scan(one_iter, v0, n_iters, tag="als round")
    u = _solve_users(r, w, v, reg)
    if mesh is not None:
        u = C.all_gather(u, mesh, axis)
    return ALSResult(u, v, hist[-1], hist)
