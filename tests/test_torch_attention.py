"""Port flash attention ≡ JAX flash attention: the same numpy inputs
through the JAX package's Pallas kernel (interpret mode on the CPU) and
the port's op (its plain version on the CPU), with the JAX package's
tolerances (tests/test_attention_op.py: f32 2e-5 out, 1e-5 lse; bf16
2e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lua_mapreduce_tpu.ops.attention import flash_attention as jflash
from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.convert import array_to_tensor, tensor_to_array
from lua_mapreduce_tpu_torch.ops.attention import (_tile_mask,
                                                   flash_attention_plain)

F32 = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b=2, l=96, h=4, hkv=None, d=32):
    rng = np.random.RandomState(seed)
    hkv = hkv or h
    q = (rng.randn(b, l, h, d) * 0.5).astype(np.float32)
    k = (rng.randn(b, l, hkv, d) * 0.5).astype(np.float32)
    v = (rng.randn(b, l, hkv, d) * 0.5).astype(np.float32)
    return q, k, v


def _both(q, k, v, block_q=32, block_k=128, **kw):
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  backend="pallas_interpret", block_q=block_q,
                  block_k=block_k, **kw)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    return got, want


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_matches_jax_kernel(causal):
    got, want = _both(*_qkv(0), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (2, 96, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("l", [70, 200], ids=["one-kv-tile", "two-kv-tiles"])
def test_ragged_length(l):
    got, want = _both(*_qkv(1, l=l), causal=True, block_q=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("window", [1, 17, 64])
def test_sliding_window(window):
    got, want = _both(*_qkv(2, l=150), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("hkv", [1, 2])
def test_gqa(hkv):
    got, want = _both(*_qkv(3, h=4, hkv=hkv), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_return_lse(causal):
    (go, gl), (wo, wl) = _both(*_qkv(4, l=200), causal=causal,
                               return_lse=True)
    assert go.dtype == torch.float32 and gl.shape == (2, 200, 4)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), **F32)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5,
                               atol=1e-5)


def test_all_masked_rows_give_zero():
    """A q_offset more than `window` past every key (the banded ring's
    far block) leaves rows with no visible key: out 0, lse ≈ -1e30."""
    q, k, v = _qkv(5, l=40)
    (go, gl), (wo, wl) = _both(q, k, v, causal=True, window=8, q_offset=44,
                               return_lse=True)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), **F32)
    # row i sits at 44 + i and sees keys (36 + i, 39]: rows 3+ see none
    assert np.all(go.numpy()[:, 3:] == 0.0)
    assert np.all(gl.numpy()[:, 3:] < -1e29)
    assert np.all(np.asarray(wl)[:, 3:] < -1e29)
    np.testing.assert_allclose(gl.numpy()[:, :3], np.asarray(wl)[:, :3],
                               rtol=1e-5, atol=1e-5)


def test_q_offset_window_partial():
    got, want = _both(*_qkv(6, l=64), causal=True, window=20, q_offset=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_bf16_matches_jax_kernel():
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16) for x in _qkv(7))
    want = jflash(q, k, v, causal=True, backend="pallas_interpret")
    got = ops.flash_attention(*(array_to_tensor(np.asarray(x))
                                for x in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(tensor_to_array(got),
                               np.asarray(want).astype(np.float32),
                               rtol=2e-2, atol=2e-2)


def test_mixed_dtypes_promoted():
    q, k, v = _qkv(8)
    got = ops.flash_attention(torch.from_numpy(q).bfloat16(),
                              torch.from_numpy(k), torch.from_numpy(v),
                              causal=True)
    assert got.dtype == torch.float32


def test_validation_matches_jax():
    q, k, v = (torch.from_numpy(x) for x in _qkv(9))
    with pytest.raises(ValueError, match="shapes differ"):
        ops.flash_attention(q, k[:, :64], v)
    with pytest.raises(ValueError, match="implies causal"):
        ops.flash_attention(q, k, v, window=4)
    with pytest.raises(ValueError, match="q_offset only"):
        ops.flash_attention(q, k, v, causal=True, q_offset=3)
    with pytest.raises(ValueError, match="divisible"):
        ops.flash_attention(q, k[:, :, :3], v[:, :, :3])
    with pytest.raises(ValueError, match="incompatible"):
        ops.flash_attention(q, k[..., :16], v[..., :16])


def test_backward_raises_not_implemented():
    """The backward no longer raises NotImplementedError: on the CPU it
    runs the plain FlashAttention-2 backward, and its gradients equal
    ``jax.grad`` of the JAX package's Pallas backward (interpret mode)
    at the f32 gradient tolerance."""
    import jax
    q, k, v = _qkv(10)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, causal=True)
    w = np.arange(out.numel()).reshape(out.shape) % 7
    (out * torch.from_numpy(w.astype(np.float32))).sum().backward()

    def loss(q, k, v):
        o = jflash(q, k, v, causal=True, backend="pallas_interpret",
                   block_q=32, block_k=128)
        return jnp.sum(o * jnp.asarray(w, jnp.float32))
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                              for x in (q, k, v)))
    for x, g in zip((qt, kt, vt), want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-4)


def test_tile_mask_matches_jax():
    from lua_mapreduce_tpu.ops.attention import _tile_mask as jmask
    rows = np.arange(40)[:, None]
    cols = np.arange(40)[None, :]
    for causal, window, off in [(True, 0, 0), (True, 7, 0), (True, 7, 12),
                                (False, 0, 0)]:
        want = np.asarray(jmask(jnp.asarray(rows), jnp.asarray(cols), causal,
                                window, 33, off))
        got = _tile_mask(torch.from_numpy(rows), torch.from_numpy(cols),
                         causal, window, 33, off).numpy()
        np.testing.assert_array_equal(got, want)


def test_plain_version_is_the_jax_reference():
    from lua_mapreduce_tpu.ops.attention import _attn_reference_xla
    q, k, v = _qkv(11, hkv=2)
    want = _attn_reference_xla(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), True, 0.25, window=9)
    got = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), True, 0.25, window=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
