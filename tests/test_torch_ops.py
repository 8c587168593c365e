"""Port ops ≡ JAX ops: the same numpy inputs through the JAX package's
kernels (Pallas, interpret mode on the CPU) and the port's ops (their
plain versions on the CPU), with the JAX package's own tolerances
(tests/test_ops.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lua_mapreduce_tpu import ops as jops
from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.convert import array_to_tensor, tensor_to_array

RTOL = 1e-4   # tests/test_ops.py:16-17
ATOL = 1e-4


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------- matmul

@pytest.mark.parametrize("m,k,n", [
    (8, 128, 128),          # single tile
    (256, 256, 256),        # exact multi-tile
    (100, 70, 50),          # ragged
    (1, 256, 10),           # vector-ish
    (200, 128, 10),         # digits validation logits
])
def test_matmul_matches_jax(m, k, n):
    a, b = rand(m, k, seed=1), rand(k, n, seed=2)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b),
                       backend="pallas_interpret", block_m=128,
                       block_n=128, block_k=128)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_matmul_bf16_inputs_f32_out_matches_jax():
    a = jnp.asarray(rand(64, 256, seed=3)).astype(jnp.bfloat16)
    b = jnp.asarray(rand(256, 64, seed=4)).astype(jnp.bfloat16)
    want = jops.matmul(a, b, backend="pallas_interpret",
                       out_dtype=jnp.float32)
    ta, tb = array_to_tensor(np.asarray(a)), array_to_tensor(np.asarray(b))
    assert ta.dtype == torch.bfloat16
    got = ops.matmul(ta, tb, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    # bf16 products are exact in f32; only the summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    # default out dtype is the promoted input dtype, as in JAX
    assert ops.matmul(ta, tb).dtype == torch.bfloat16


def test_matmul_shape_mismatch():
    with pytest.raises(ValueError):
        jops.matmul(jnp.zeros((4, 5)), jnp.zeros((6, 7)),
                    backend="pallas_interpret")
    with pytest.raises(ValueError, match="contracting"):
        ops.matmul(torch.zeros(4, 5), torch.zeros(6, 7))
    with pytest.raises(ValueError, match="2-D"):
        ops.matmul(torch.zeros(2, 4, 5), torch.zeros(5, 7))


def test_matmul_strided_operands():
    """Transposed views (the backward's operands) give the same product
    as contiguous copies."""
    a, b = torch.from_numpy(rand(40, 24, seed=5)), torch.from_numpy(
        rand(30, 40, seed=6))
    got = ops.matmul(a.t(), b.t())
    want = ops.matmul(a.t().contiguous(), b.t().contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("m,k,n", [(16, 32, 8), (33, 70, 10)])
def test_matmul_grads_match_jax(m, k, n):
    a, b = rand(m, k, seed=7), rand(k, n, seed=8)

    def loss(a, b):
        return jnp.sum(jops.matmul(a, b, backend="pallas_interpret") ** 2)

    ga, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    (ops.matmul(ta, tb) ** 2).sum().backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb),
                               rtol=RTOL, atol=ATOL)


def test_matmul_backward_skips_unneeded_grad(monkeypatch):
    """dA is not computed when A needs no grad (the MLP's input): one
    forward product and one backward product, not two."""
    import sys
    mm = sys.modules["lua_mapreduce_tpu_torch.ops.matmul"]
    calls = []
    real = mm._product
    monkeypatch.setattr(mm, "_product",
                        lambda a, b, dt: calls.append(a.shape) or
                        real(a, b, dt))
    a = torch.from_numpy(rand(8, 16, seed=9))
    b = torch.from_numpy(rand(16, 4, seed=10)).requires_grad_(True)
    (gb,) = torch.autograd.grad(ops.matmul(a, b).sum(), [b])
    assert gb.shape == (16, 4)
    assert calls == [(8, 16), (16, 8)]      # a·b, then aᵀ·g only


# --------------------------------------------------------------- softmax

@pytest.mark.parametrize("shape", [(4, 10), (33, 257), (2, 3, 100),
                                   (128, 10)])
def test_log_softmax_matches_jax(shape):
    x = rand(*shape, seed=5) * 10.0
    want = jops.log_softmax(jnp.asarray(x), backend="pallas_interpret")
    got = ops.log_softmax(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_softmax_matches_jax_and_rows_sum_to_one():
    x = rand(16, 40, seed=6) * 5.0
    want = jops.softmax(jnp.asarray(x), backend="pallas_interpret")
    got = ops.softmax(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_log_softmax_extreme_values_stable():
    x = np.array([[1e4, -1e4, 0.0, 5.0]], np.float32)
    want = jops.log_softmax(jnp.asarray(x), backend="pallas_interpret")
    got = ops.log_softmax(torch.from_numpy(x))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_log_softmax_bf16_keeps_dtype():
    x = jnp.asarray(rand(8, 64, seed=11)).astype(jnp.bfloat16)
    want = jops.log_softmax(x, backend="pallas_interpret")
    got = ops.log_softmax(array_to_tensor(np.asarray(x)))
    assert got.dtype == torch.bfloat16
    # both compute in f32 and round once to bf16 (8 mantissa bits)
    np.testing.assert_allclose(tensor_to_array(got),
                               np.asarray(want).astype(np.float32),
                               rtol=1e-2, atol=1e-2)


def test_log_softmax_grad_matches_jax():
    x = rand(8, 33, seed=30) * 4.0

    def loss(x):
        return jnp.sum(jops.log_softmax(x, backend="pallas_interpret") ** 2)

    want = jax.grad(loss)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    (ops.log_softmax(tx) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


def test_softmax_grad_matches_jax():
    x = rand(6, 20, seed=31) * 3.0

    def loss(x):
        return jnp.sum(jops.softmax(x, backend="pallas_interpret") ** 3)

    want = jax.grad(loss)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    (ops.softmax(tx) ** 3).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-6)


# ------------------------------------------------------------- dispatch

def test_cpu_tensors_take_the_plain_version():
    """No kernel launches for CPU tensors: the counts stay put."""
    before = ops.launch_counts()
    ops.matmul(torch.ones(3, 4), torch.ones(4, 5))
    ops.log_softmax(torch.ones(3, 4))
    ops.softmax(torch.ones(3, 4))
    assert ops.launch_counts() == before
    assert set(before) == set(ops.KERNELS)


@pytest.mark.parametrize("op", ["matmul", "log_softmax", "softmax"])
def test_non_cpu_non_cuda_tensors_raise(op):
    """A tensor that is neither on the CPU nor on a card never reaches
    the plain version."""
    x = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        if op == "matmul":
            ops.matmul(x, x)
        else:
            getattr(ops, op)(x)


def test_mixed_devices_raise():
    with pytest.raises(ValueError):
        ops.matmul(torch.ones(2, 2), torch.empty(2, 2, device="meta"))
