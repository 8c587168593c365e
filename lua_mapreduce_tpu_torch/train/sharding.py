"""Sharded dataset pipeline — the misc/make_sharded.lua analog.

Port of ``lua_mapreduce_tpu/train/sharding.py``, in the same layout:
:func:`make_sharded` writes an (x, y) dataset into N atomic shard files
in a store (``mem:`` or ``shared:``; ``builder()`` of
``store/{memfs,sharedfs}.py``) through the port's checkpoint format,
plus a JSON manifest; :class:`ShardedDataset` streams the shards back —
whole-shard reads for the map phase (one shard = one map split, the
reference's 197-split contract) or host-sliced batch streams for
multi-host data-parallel training, where each host reads only the
shards it owns (shard i → host i % n_hosts).

The two packages read each other's layouts: the shard files are
checkpoint files of the shared format and the manifest is the same
JSON line. With the same ``np.random.RandomState`` both readers yield
the same batches in the same order; the port's are CPU tensors.
"""

from __future__ import annotations

import json
from typing import Iterator, List, Tuple

import numpy as np
import torch

from lua_mapreduce_tpu_torch.train import checkpoint as ckpt

_LIKE = (0, 0)      # (x, y): the structure load_pytree rebuilds


def _shard_name(prefix: str, i: int) -> str:
    return f"{prefix}.S{i:04d}"


def make_sharded(store, prefix: str, x, y, n_shards: int) -> List[str]:
    """Split (x, y) — numpy arrays or tensors — row-wise into
    ``n_shards`` files ``<prefix>.S<i>`` (atomic builds: readers never
    see a partial shard) and publish ``<prefix>.manifest`` last, so a
    manifest's existence implies every shard it names is complete."""
    if not 1 <= n_shards <= len(x):
        raise ValueError(f"n_shards={n_shards} not in [1, {len(x)}]")
    if store.exists(f"{prefix}.manifest"):
        # re-sharding: retire the old layout manifest-first (readers fail
        # at open, not mid-epoch) and delete ALL old shards — a smaller
        # new n_shards must not leak orphans the new manifest never names
        ShardedDataset(store, prefix).remove()
    names = []
    bounds = np.linspace(0, len(x), n_shards + 1, dtype=int)
    for i in range(n_shards):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        name = _shard_name(prefix, i)
        ckpt.save_pytree(store, name, (x[lo:hi], y[lo:hi]))
        names.append(name)
    with store.builder() as b:
        b.write(json.dumps({"v": 1, "n_shards": n_shards, "n": int(len(x)),
                            "sizes": np.diff(bounds).tolist(),
                            "x_shape": [int(n) for n in x.shape[1:]],
                            "x_dtype": ckpt._dtype_name(x),
                            "y_dtype": ckpt._dtype_name(y)}) + "\n")
        b.build(f"{prefix}.manifest")
    return names


class ShardedDataset:
    """Reader over a :func:`make_sharded` layout (either package's)."""

    def __init__(self, store, prefix: str):
        self.store = store
        self.prefix = prefix
        if not store.exists(f"{prefix}.manifest"):
            raise FileNotFoundError(f"{prefix}.manifest")
        self.meta = json.loads(next(iter(
            store.lines(f"{prefix}.manifest"))))
        self.n_shards: int = self.meta["n_shards"]
        self.n_examples: int = self.meta["n"]

    # -- map-phase view: one shard = one split ----------------------------

    def shard_names(self) -> List[str]:
        """The task splits a taskfn emits (WordCountBig taskfn analog)."""
        return [_shard_name(self.prefix, i) for i in range(self.n_shards)]

    def load_shard(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return ckpt.load_pytree(self.store, _shard_name(self.prefix, i),
                                _LIKE)

    # -- training view: host-local streaming batches ----------------------

    def _host_shards(self, host_id: int, n_hosts: int) -> List[int]:
        if not 0 <= host_id < n_hosts:
            raise ValueError(f"host_id={host_id} not in [0, {n_hosts})")
        return [i for i in range(self.n_shards) if i % n_hosts == host_id]

    def steps_per_epoch(self, batch_size: int, n_hosts: int = 1) -> int:
        """Full batches the SLOWEST host can produce per epoch — the
        common step count every host must use: in SPMD training each step
        is a collective program, so hosts running unequal step counts
        deadlock the mesh. Computed from the manifest's shard sizes, so
        every host derives the same number without communicating.

        Raises rather than returning 0 (a silent 0 would make every
        host's epoch a no-op): every host must own at least one shard
        (shard i → host i % n_hosts requires n_shards ≥ n_hosts) and the
        smallest host's share must cover one full batch."""
        sizes = self.meta["sizes"]
        if self.n_shards < n_hosts:
            raise ValueError(
                f"{self.n_shards} shards cannot feed {n_hosts} hosts — "
                f"re-shard with n_shards >= n_hosts")
        steps = min(
            sum(sizes[i] for i in self._host_shards(h, n_hosts))
            // batch_size
            for h in range(n_hosts))
        if steps == 0:
            raise ValueError(
                f"batch_size={batch_size} exceeds the smallest host's "
                f"share ({min(sizes)}-example shards over {n_hosts} "
                f"hosts) — every epoch would yield zero steps")
        return steps

    def batches(self, batch_size: int, *, rng: np.random.RandomState,
                host_id: int = 0, n_hosts: int = 1, drop_remainder=True
                ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Stream batches for one epoch, reading only this host's shards
        (shard i → host i % n_hosts). Shard visit order and intra-shard
        order reshuffle per call, drawn from ``rng`` as the JAX reader
        draws them; a leftover smaller than ``batch_size`` carries over
        into the next shard, so shard boundaries never force short
        batches.

        With ``drop_remainder`` (the SPMD-training contract) every host
        yields exactly :meth:`steps_per_epoch` batches — surplus batches
        on hosts that own more examples are dropped so no host runs a
        collective step its peers never enter. ``drop_remainder=False``
        is the complete-sweep view (map-phase analytics): every example
        owned by this host is yielded, final short batch included."""
        mine = self._host_shards(host_id, n_hosts)
        max_steps = self.steps_per_epoch(batch_size, n_hosts) \
            if drop_remainder else None
        steps = 0
        order = rng.permutation(len(mine))
        x_rest, y_rest = None, None
        for k in order:
            x, y = self.load_shard(mine[k])
            perm = torch.as_tensor(rng.permutation(len(x)))
            x, y = x[perm], y[perm]
            if x_rest is not None and len(x_rest):
                x = torch.cat([x_rest, x])
                y = torch.cat([y_rest, y])
            n_full = (len(x) // batch_size) * batch_size
            for lo in range(0, n_full, batch_size):
                if max_steps is not None and steps >= max_steps:
                    return
                yield x[lo:lo + batch_size], y[lo:lo + batch_size]
                steps += 1
            x_rest, y_rest = x[n_full:], y[n_full:]
        if not drop_remainder and x_rest is not None and len(x_rest):
            yield x_rest, y_rest

    def remove(self) -> None:
        """Delete the manifest FIRST, then the shards (idempotent) — the
        manifest-implies-complete invariant stays true for concurrent
        readers; a reader that loses the race fails at open time, not
        mid-epoch."""
        self.store.remove(f"{self.prefix}.manifest")
        for name in self.shard_names():
            self.store.remove(name)
