"""csrc/matmul.cu's split-K sum, in numpy float32: K cut into the plan's
chunks of whole 64-deep K-tiles, one f32 partial a chunk, the partials
added in rank order (the K order) and cast once. A cluster split (the
ranks' partials summed through distributed shared memory) and a slab
split (``splitk_reduce_kernel``) add in this one order, so given the
kernel's own partials — its unsplit product over each chunk, f32 out —
the model is the card's split result bit for bit. The CPU tests feed it
numpy's partials and hold it to the plain version and the JAX op; the
card tests feed it the kernel's.
"""

import numpy as np
import torch


def chunks(k, splits):
    """The K ranges of the ranks of a ``splits``-way split of K: equal
    chunks of whole K-tiles of 64, the last rank taking the rest."""
    units = -(-k // 64)
    per = -(-units // splits)
    assert -(-units // per) == splits, (k, splits)
    return [(r * per * 64, min(k, (r + 1) * per * 64))
            for r in range(splits)]


def rank_order_sum(partials):
    """The partials (f32 arrays of one shape) added in rank order."""
    total = np.array(partials[0], dtype=np.float32)
    for p in partials[1:]:
        total = (total + np.asarray(p, dtype=np.float32)).astype(np.float32)
    return total


def to_dtype(x, dtype):
    """The kernel's one cast of an f32 sum (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        dtype)


def split_product(a, b, splits, out_dtype=torch.float32):
    """a (M, K) and b (K, N) float32 arrays: the split's result, each
    chunk's partial one numpy f32 product."""
    parts = [a[:, k0:k1] @ b[k0:k1] for k0, k1 in chunks(a.shape[1], splits)]
    return to_dtype(rank_order_sum(parts), out_dtype)
