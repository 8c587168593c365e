"""Port weight-only int8 matmul ≡ JAX's: ``quantize_q8`` gives the same
bytes, and the port's op (its plain version on the CPU) agrees with the
JAX package's Pallas kernel (interpret mode) at tests/test_q8.py's
tolerance, 2e-2. As there, the comparison is precision-matched: the
kernel rounds x to bf16 and the plain version does not, so the port is
given x already rounded to bf16 (held in f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lua_mapreduce_tpu import ops as jops
from lua_mapreduce_tpu.ops.q8 import _dequant_matmul_xla
from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.convert import array_to_tensor, tensor_to_array


def _wx(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(k, n).astype(np.float32),
            rng.randn(m, k).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_q8_bytes_equal_jax(dtype):
    w, _ = _wx(0, 1, 300, 130)
    w[:, 7] = 0.0                               # an all-zero column
    jw = jnp.asarray(w, getattr(jnp, dtype))
    wq, ws = jops.quantize_q8(jw)
    gq, gs = ops.quantize_q8(array_to_tensor(np.asarray(jw)))
    assert gq.dtype == torch.int8 and gs.shape == (1, 130)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("m,k,n", [(4, 300, 500),     # ragged
                                   (1, 256, 128),     # decode matvec
                                   (33, 128, 200),
                                   (4, 1024, 3072)])  # serving qkv width
def test_matches_jax_kernel(m, k, n):
    w, x = _wx(1, m, k, n)
    q, s = jops.quantize_q8(jnp.asarray(w))
    want = jops.q8_matmul(jnp.asarray(x), q, s.reshape(-1),
                          backend="pallas_interpret")
    xb = torch.from_numpy(x).bfloat16().float()
    got = ops.q8_matmul(xb, array_to_tensor(np.asarray(q)),
                        array_to_tensor(np.asarray(s)).reshape(-1))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_plain_version_is_the_jax_oracle():
    w, x = _wx(2, 8, 512, 256)
    q, s = jops.quantize_q8(jnp.asarray(w))
    want = _dequant_matmul_xla(jnp.asarray(x), q, s.reshape(1, -1))
    got = ops.q8_matmul(torch.from_numpy(x), array_to_tensor(np.asarray(q)),
                        array_to_tensor(np.asarray(s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bf16_x_keeps_dtype():
    w, x = _wx(3, 4, 128, 64)
    q, s = ops.quantize_q8(torch.from_numpy(w))
    xb = jnp.asarray(x, jnp.bfloat16)
    jq, js = jops.quantize_q8(jnp.asarray(w))
    want = jops.q8_matmul(xb, jq, js.reshape(-1), backend="pallas_interpret")
    got = ops.q8_matmul(array_to_tensor(np.asarray(xb)), q, s.reshape(-1))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(tensor_to_array(got),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_validation():
    w, x = _wx(4, 2, 64, 32)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    q, s = ops.quantize_q8(tw)
    with pytest.raises(ValueError, match="int8"):
        ops.q8_matmul(tx, tw, s.reshape(-1))
    with pytest.raises(ValueError, match="contraction"):
        ops.q8_matmul(tx[:, :32], q, s.reshape(-1))
    with pytest.raises(ValueError, match="channels"):
        ops.q8_matmul(tx, q, s.reshape(-1)[:16])
    with pytest.raises(ValueError, match="rank-2"):
        ops.q8_matmul(tx[None], q, s)
