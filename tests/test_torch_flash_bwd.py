"""Port flash attention backward ≡ the JAX package's FlashAttention-2
backward.

The same numpy inputs go through ``jax.grad`` of the JAX op with
``backend="pallas_interpret"`` (its dq/dkv Pallas kernels in interpret
mode on the CPU) and through torch autograd of the port's op (its plain
backward on the CPU), for ``return_lse=True`` with the loss
``sum(o²) + 0.1·sum(lse)`` (``bench_flash_grad_error``'s, so the lse
cotangent reaches the backward) and ``return_lse=False`` with
``sum(o²)``. Gradients agree at the JAX package's f32 gradient
tolerance, 1e-4 (tests/test_attention_op.py). The plain backward
``flash_attention_bwd_plain`` is also held against torch autograd of
the plain forward, ``g_lse`` included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lua_mapreduce_tpu.ops.attention import flash_attention as jflash
from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.ops.attention import (flash_attention_bwd_plain,
                                                   flash_attention_plain)

GRAD = dict(rtol=1e-4, atol=1e-4)
# (label, L, q heads, kv heads, causal, window, q_offset, block_q)
CASES = [
    ("full", 64, 4, 4, False, 0, 0, 32),
    ("causal", 64, 4, 4, True, 0, 0, 32),
    ("ragged", 50, 4, 4, True, 0, 0, 16),
    ("gqa-2to1", 48, 4, 2, True, 0, 0, 16),
    ("gqa-4to1", 48, 8, 2, True, 0, 0, 16),
    ("window", 64, 4, 4, True, 17, 0, 16),
    ("window-q_offset", 64, 4, 2, True, 20, 10, 16),
    ("window-q_offset-all-masked-rows", 40, 2, 2, True, 8, 44, 8),
]


def _qkv(seed, l, h, hkv, d=16, b=2):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(b, l, n, d) * 0.5).astype(np.float32)
                 for n in (h, hkv, hkv))


def _jax_grads(q, k, v, with_lse, block_q, **kw):
    def loss(q, k, v):
        out = jflash(q, k, v, backend="pallas_interpret", block_q=block_q,
                     block_k=128, return_lse=with_lse, **kw)
        if with_lse:
            o, lse = out
            return jnp.sum(o ** 2) + 0.1 * jnp.sum(lse)
        return jnp.sum(out ** 2)
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(x) for x in g]


def _port_grads(q, k, v, with_lse, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, return_lse=with_lse, **kw)
    if with_lse:
        o, lse = out
        loss = (o ** 2).sum() + 0.1 * lse.sum()
    else:
        loss = (out ** 2).sum()
    loss.backward()
    return [x.grad.numpy() for x in (qt, kt, vt)]


@pytest.mark.parametrize("with_lse", [True, False], ids=["lse", "nolse"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_grads_match_jax_pallas_backward(case, with_lse):
    _, l, h, hkv, causal, window, q_offset, block_q = case
    q, k, v = _qkv(len(case[0]), l, h, hkv)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = _jax_grads(q, k, v, with_lse, block_q, **kw)
    got = _port_grads(q, k, v, with_lse, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, **GRAD, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_is_autograd_of_plain_forward(case):
    """dq, dk, dv of ``flash_attention_bwd_plain`` with random out and
    lse cotangents equal torch autograd through
    ``flash_attention_plain``'s lse form (rows with no visible key carry
    no lse gradient into the scores there either)."""
    _, l, h, hkv, causal, window, q_offset, _ = case
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, l, h, hkv))
    g_out = torch.from_numpy(rng.randn(2, l, h, 16).astype(np.float32))
    g_lse = torch.from_numpy(rng.randn(2, l, h).astype(np.float32))
    scale = 16 ** -0.5
    qa, ka, va = (x.clone().requires_grad_(True) for x in (q, k, v))
    o, lse = flash_attention_plain(qa, ka, va, causal, scale, with_lse=True,
                                   window=window, q_offset=q_offset)
    ((o * g_out).sum() + (lse * g_lse).sum()).backward()
    o0, lse0 = flash_attention_plain(q, k, v, causal, scale, with_lse=True,
                                     window=window, q_offset=q_offset)
    got = flash_attention_bwd_plain(q, k, v, o0, lse0, g_out, causal,
                                    window=window, q_offset=q_offset,
                                    g_lse=g_lse)
    for name, g, w in zip(("dq", "dk", "dv"), got,
                          (qa.grad, ka.grad, va.grad)):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5, msg=name)


def test_bf16_backward_rounds_like_the_kernel():
    """bf16 operands: the gradients come back bf16 and stay within the
    JAX package's bf16 gradient tolerance (0.1, test_bf16_grads) of the
    f32 gradients."""
    q, k, v = _qkv(11, 48, 4, 2)
    want = _port_grads(q, k, v, True, causal=True)
    qt, kt, vt = (torch.from_numpy(x).bfloat16().requires_grad_(True)
                  for x in (q, k, v))
    o, lse = ops.flash_attention(qt, kt, vt, causal=True, return_lse=True)
    ((o ** 2).sum() + 0.1 * lse.sum()).backward()
    for x, w in zip((qt, kt, vt), want):
        assert x.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(x.grad.float().numpy(), w, rtol=0.1,
                                   atol=0.1)


def test_no_grad_forward_launch_form_unchanged():
    """Without a gradient the forward returns the asked-for form and
    keeps no residuals; with one, out is q's dtype for return_lse=False
    and f32 with the lse for return_lse=True."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv(12, 32, 2, 2))
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and out.grad_fn is None
    qg = q.clone().requires_grad_(True)
    out = ops.flash_attention(qg, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and out.grad_fn is not None
    o, lse = ops.flash_attention(qg, k, v, causal=True, return_lse=True)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    with torch.no_grad():
        assert ops.flash_attention(qg, k, v, causal=True).grad_fn is None


def test_unused_output_cotangents():
    """Either output of the lse form may go unused: a loss on the lse
    alone, or on the out alone, differentiates (a missing cotangent is
    zero)."""
    q, k, v = _qkv(13, 40, 2, 2)
    for use in ("out", "lse"):
        qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                      for x in (q, k, v))
        o, lse = ops.flash_attention(qt, kt, vt, causal=True,
                                     return_lse=True)
        (o.sum() if use == "out" else lse.sum()).backward()

        def f(q, k, v, use=use):
            o, lse = jflash(q, k, v, causal=True, backend="xla",
                            return_lse=True)
            return jnp.sum(o) if use == "out" else jnp.sum(lse)
        want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
        for x, w in zip((qt, kt, vt), want):
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **GRAD)
