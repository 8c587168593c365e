"""Port decode attention ≡ JAX decode attention: the same numpy inputs
through the JAX package's Pallas decode kernel (interpret mode on the
CPU) and the port's op (its plain version on the CPU), over the
(shape, t, roll) matrix of tests/test_decode_op.py and with its
tolerances (f32 2e-5, bf16 2e-2, int8 5e-3); ``quantize_kv`` gives the
same bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lua_mapreduce_tpu.ops.decode import _decode_xla
from lua_mapreduce_tpu.ops.decode import decode_attention as jdecode
from lua_mapreduce_tpu.ops.decode import quantize_kv as jquantize_kv
from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.convert import array_to_tensor
from lua_mapreduce_tpu_torch.ops.decode import (_decode_partial_plain,
                                                _merge_splits_plain,
                                                decode_attention_plain)

SHAPES = [(2, 4, 1, 64, 256),       # MHA g=1
          (2, 2, 4, 64, 384),       # GQA
          (1, 1, 8, 128, 512),
          (2, 2, 2, 64, 300),       # ragged: S % block_s != 0
          (1, 2, 1, 64, 1000)]


def _args(b, hkv, g, d, s_len, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hkv, g, d).astype(np.float32),
            rng.randn(b, hkv, s_len, d).astype(np.float32),
            rng.randn(b, hkv, s_len, d).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("roll", [False, True])
def test_matches_jax_kernel(shape, roll):
    q, k, v = _args(*shape)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for t in [0, 5, shape[-1] // 2, shape[-1] - 1]:
        want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.int32(t), roll=roll, backend="pallas_interpret")
        got = ops.decode_attention(tq, tk, tv, t, roll=roll)
        assert got.dtype == torch.float32 and got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5, err_msg=f"t={t} roll={roll}")


def test_bf16_matches_jax_kernel():
    q, k, v = (jnp.asarray(x, jnp.bfloat16)
               for x in _args(2, 2, 2, 64, 300, seed=9))
    tq, tk, tv = (array_to_tensor(np.asarray(x)) for x in (q, k, v))
    for t in [0, 150, 299]:
        want = jdecode(q, k, v, jnp.int32(t), backend="pallas_interpret")
        got = ops.decode_attention(tq, tk, tv, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                                   atol=2e-2)


def test_rolling_full_cache_all_slots_visible():
    q, k, v = _args(1, 2, 2, 64, 128, seed=3)
    want = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.int32(500), roll=True, backend="pallas_interpret")
    got = ops.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               500, roll=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_t_zero_attends_only_first_slot():
    q, k, v = _args(1, 2, 1, 64, 256, seed=4)
    got = ops.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)), 0)
    np.testing.assert_allclose(got.numpy(), v[:, :, 0:1, :], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 4, 1, 64, 256), (2, 2, 2, 64, 300)])
@pytest.mark.parametrize("roll", [False, True])
def test_int8_cache_matches_jax_kernel(shape, roll):
    q, k, v = _args(*shape, seed=7)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    kq, ks = jquantize_kv(jnp.asarray(k))
    vq, vs = jquantize_kv(jnp.asarray(v))
    tq = array_to_tensor(np.asarray(jq))
    tk, tks, tv, tvs = (array_to_tensor(np.asarray(x))
                        for x in (kq, ks, vq, vs))
    for t in [0, shape[-1] // 2, shape[-1] - 1]:
        want = jdecode(jq, kq, vq, jnp.int32(t), roll=roll, k_scale=ks,
                       v_scale=vs, backend="pallas_interpret")
        got = ops.decode_attention(tq, tk, tv, t, roll=roll, k_scale=tks,
                                   v_scale=tvs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3,
                                   atol=5e-3, err_msg=f"t={t} roll={roll}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bytes_equal_jax(dtype):
    x = jnp.asarray(np.random.RandomState(12).randn(2, 3, 50, 64) * 3,
                    getattr(jnp, dtype))
    x = x.at[0, 0, 0].set(0)                    # an all-zero row: 1e-8 floor
    wq, ws = jquantize_kv(x)
    gq, gs = ops.quantize_kv(array_to_tensor(np.asarray(x)))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_scales_must_come_together():
    q, k, v = (torch.from_numpy(x) for x in _args(1, 1, 1, 64, 128))
    kq, ks = ops.quantize_kv(k)
    with pytest.raises(ValueError, match="together"):
        ops.decode_attention(q, kq, v, 0, k_scale=ks)


def test_shape_validation():
    q, k, v = (torch.from_numpy(x) for x in _args(1, 2, 1, 64, 128))
    with pytest.raises(ValueError, match="incompatible"):
        ops.decode_attention(q[..., :32], k, v, 0)
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, v[:, :, :64], 0)


# The split kernel's algebra: each split's state over its clamped range,
# merged in split order, is the whole softmax. (shape, n_split, t, roll);
# splits are ceil(S / n_split) long, as csrc/decode.cu cuts them; t
# leaves later splits empty, sits inside the first, on a boundary, at
# S - 1, or rolls past S.
SPLIT_CASES = [((2, 2, 1, 64, 256), 1, 255, False),
               ((2, 2, 4, 64, 384), 3, 10, False),       # inside split 0
               ((2, 2, 4, 64, 384), 3, 127, False),      # split 0 ends
               ((2, 2, 4, 64, 384), 3, 128, False),      # split 1 starts
               ((1, 1, 8, 128, 512), 7, 511, False),     # ragged last split
               ((2, 2, 2, 64, 300), 4, 200, False),      # split 3 empty
               ((2, 2, 2, 64, 300), 4, 700, True)]       # rolled: all live


@pytest.mark.parametrize("kind", ["float32", "int8"])
@pytest.mark.parametrize("shape,n_split,t,roll", SPLIT_CASES)
def test_split_states_merge_to_plain_and_jax(kind, shape, n_split, t, roll):
    q, k, v = _args(*shape, seed=11)
    b, hkv, g, d, s_len = shape
    n_live = s_len if (roll and t >= s_len) else min(t + 1, s_len)
    split_len = -(-s_len // n_split)
    if kind == "int8":
        jq = jnp.asarray(q).astype(jnp.bfloat16)
        kq, ks = jquantize_kv(jnp.asarray(k))
        vq, vs = jquantize_kv(jnp.asarray(v))
        want_jax = _decode_xla(jq, kq, vq, jnp.int32(t), roll, ks, vs)
        tq, tk, tv, tks, tvs = (array_to_tensor(np.asarray(x))
                                for x in (jq, kq, vq, ks, vs))
        scales = dict(k_scale=tks, v_scale=tvs)
        tol = dict(rtol=5e-3, atol=5e-3)
    else:
        want_jax = _decode_xla(*(jnp.asarray(x) for x in (q, k, v)),
                               jnp.int32(t), roll)
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        scales = {}
        tol = dict(rtol=2e-5, atol=2e-5)
    states = [_decode_partial_plain(tq, tk, tv, z * split_len,
                                    min((z + 1) * split_len, n_live),
                                    **scales) for z in range(n_split)]
    empty = [z for z in range(n_split) if z * split_len >= n_live]
    for z in empty:
        assert bool((states[z][0] == -1e30).all())
        assert bool((states[z][1] == 0).all())
        assert bool((states[z][2] == 0).all())
    if shape[-1] == 300 and not roll:
        assert empty == [3]
    m, l, acc = (torch.stack([st[i] for st in states], dim=2)
                 for i in range(3))
    got = _merge_splits_plain(m.reshape(b * hkv, n_split, g),
                              l.reshape(b * hkv, n_split, g),
                              acc.reshape(b * hkv, n_split, g, d))
    got = got.reshape(b, hkv, g, d)
    want = decode_attention_plain(tq, tk, tv, t, roll, **scales)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jax), **tol)
