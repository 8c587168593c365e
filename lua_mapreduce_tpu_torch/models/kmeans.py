"""k-means — the iterative-state workload (BASELINE.json config 5:
"Iterative k-means / ALS … persistent_table.lua state across MapReduce
iters").

Port of ``lua_mapreduce_tpu/models/kmeans.py``. Lloyd's algorithm has
the reference's looping-MapReduce shape (SURVEY.md §3.5): map = assign
each point of a shard to its nearest centroid and fold per-cluster
partial sums, reduce = sum the partials across shards, final =
recompute the centroids and loop. With a mesh the points stay split
over the ``dp`` axis for the whole fit (each rank holds its rows), the
reduce is an all-reduce, and on a card the iteration is captured once
in a CUDA graph and replayed ``n_iters`` times (``graphs.scan``, the
JAX module's ``lax.scan``): no host round trip between iterations,
``history`` stays on the device. The two products of an iteration,
x·cᵀ and one_hotᵀ·x, go through the port's matmul kernel (``ops.
matmul``, f32), as the JAX module's ``@`` goes to the MXU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from lua_mapreduce_tpu_torch import graphs, ops
from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.parallel import collectives as C
from lua_mapreduce_tpu_torch.parallel.tpu_engine import shard_rows


class KMeansResult(NamedTuple):
    centroids: torch.Tensor     # (k, d)
    inertia: torch.Tensor       # scalar: sum of squared distances
    history: torch.Tensor       # (n_iters,) inertia per iteration


def _assign_fold(x: torch.Tensor, centroids: torch.Tensor):
    """Per-shard map+combine: nearest-centroid one-hot fold.

    Distances via the expanded form — the x·cᵀ term is one (shard, k)
    product; ‖x‖² is constant in the argmin and omitted. The one-hot is
    a comparison against the cluster ids (``F.one_hot`` checks its input
    on the host). Returns (per-cluster sums (k, d), counts (k,), inertia
    scalar)."""
    k = centroids.shape[0]
    xc = ops.matmul(x, centroids.t())                       # (n, k)
    d2 = (centroids ** 2).sum(1)[None, :] - 2.0 * xc
    nearest = d2.argmin(1)                                  # (n,)
    one_hot = (nearest[:, None] == torch.arange(
        k, device=x.device)[None, :]).to(x.dtype)           # (n, k)
    sums = ops.matmul(one_hot.t(), x)                       # (k, d)
    counts = one_hot.sum(0)                                 # (k,)
    # Σ‖x‖² + Σ(‖c‖² − 2x·c) at each point's cluster: the JAX module's
    # Σ one_hot·d2 without its (n, k) product
    inertia = (x ** 2).sum() + d2.gather(1, nearest[:, None]).sum()
    return sums, counts, inertia


def _update(centroids: torch.Tensor, sums: torch.Tensor,
            counts: torch.Tensor) -> torch.Tensor:
    """New centroid = cluster mean; empty clusters keep their centroid
    (the reference engine's empty-partition tolerance, SURVEY.md §6) —
    a ``torch.where``, not a branch on the host."""
    safe = counts.clamp_min(1.0)[:, None]
    return torch.where(counts[:, None] > 0, sums / safe, centroids)


def init_centroids(seed: Union[int, torch.Generator], x: np.ndarray, k: int,
                   method: str = "kmeans++") -> torch.Tensor:
    """Seed centroids (a CPU tensor), deterministic in ``seed`` (an int,
    or a CPU ``torch.Generator`` in place of the JAX key; the two
    packages draw different seeds from their keys, so parity runs feed
    both the same ``centroids0``). ``"kmeans++"`` (default) does greedy
    D²-weighted sampling on the host (a once-per-fit cost);
    ``"random"`` picks k distinct points uniformly."""
    x = np.asarray(x)
    if isinstance(seed, torch.Generator):
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=seed))
    rng = np.random.RandomState(seed)
    if method == "random":
        return torch.from_numpy(x[rng.choice(len(x), k, replace=False)])
    if method != "kmeans++":
        raise ValueError(f"unknown init method {method!r}")
    # greedy k-means++: each step samples a few D²-weighted candidates
    # and keeps the one that lowers the potential most
    n_trials = 2 + int(np.log(max(k, 2)))
    chosen = x[rng.randint(len(x))][None, :]
    d2 = np.sum((x - chosen[0]) ** 2, axis=-1)
    for _ in range(k - 1):
        cand = rng.choice(len(x), size=n_trials, p=d2 / d2.sum())
        cand_d2 = np.minimum(
            d2[None, :],
            np.sum((x[None, :, :] - x[cand][:, None, :]) ** 2, axis=-1))
        best = int(np.argmin(cand_d2.sum(axis=1)))
        chosen = np.concatenate([chosen, x[cand[best]][None, :]])
        d2 = cand_d2[best]
    return torch.from_numpy(chosen)


@torch.no_grad()
def kmeans_fit(x, centroids0, *, n_iters: int = 20, mesh=None,
               axis: str = "dp",
               device: Optional[Union[str, torch.device]] = None
               ) -> KMeansResult:
    """Run ``n_iters`` Lloyd iterations from ``centroids0``.

    With a ``mesh``, every rank passes the same global ``x`` and keeps
    its rows of it (the leading axis split over ``axis``); the fold is
    all-reduced, so every rank returns the same result, on the mesh's
    device. Without one the fit runs on ``device`` (default ``"cuda"``).
    ``history[i]`` is the inertia of the assignment against the
    iteration-i centroids — history[-1] lags the returned centroids by
    one update, the classic assign-then-update bookkeeping.
    """
    if mesh is not None:
        dev = mesh.device
        x = shard_rows(x, mesh, axis).float()
    else:
        dev = resolve_device(device)
        x = torch.as_tensor(x).to(dev).float()
    c0 = torch.as_tensor(centroids0).to(dev).float()

    def one_iter(centroids):
        sums, counts, inertia = _assign_fold(x, centroids)
        if mesh is not None:
            sums, counts, inertia = C.psum_tree((sums, counts, inertia),
                                                mesh, axis)
        return _update(centroids, sums, counts), inertia

    c, hist = graphs.scan(one_iter, c0, n_iters, tag="kmeans iteration")
    return KMeansResult(c, hist[-1], hist)


def assign(x, centroids) -> torch.Tensor:
    """Nearest-centroid labels for ``x`` (one device: ``x``'s)."""
    x = torch.as_tensor(x)
    centroids = torch.as_tensor(centroids).to(x.device)
    xc = ops.matmul(x, centroids.t())
    d2 = (centroids ** 2).sum(1)[None, :] - 2.0 * xc
    return d2.argmin(1)
