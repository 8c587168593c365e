"""Port LM serving path ≡ the JAX package's: the same JAX-initialised
params (carried across with ``convert.params_from_jax``) through the
JAX model (its default XLA path on the CPU) and the port's model (its
plain versions on the CPU), at ``tiny()``, a llama-style GQA config and
a sliding-window config. Logits agree at f32 1e-4; greedy tokens are
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lua_mapreduce_tpu.models import transformer as jt
from lua_mapreduce_tpu_torch.convert import params_from_jax, params_to_numpy
from lua_mapreduce_tpu_torch.models import transformer as tt

TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = {
    "tiny": {},
    "llama_gqa": dict(rope=True, norm="rms", ffn="swiglu", n_kv_heads=2),
    "window": dict(window=8),
}


def _cfgs(name):
    kw = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=128, **CONFIGS[name])
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


def _params(jc, seed=0):
    jp = jt.init_transformer(jax.random.PRNGKey(seed), jc)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu")
    return jp, tp


def _tokens(b, l, seed=1):
    return np.random.RandomState(seed).randint(0, 64, (b, l)).astype(np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_transformer_apply_logits(name):
    jc, tc = _cfgs(name)
    jp, tp = _params(jc)
    toks = _tokens(2, 20)
    want = jt.transformer_apply(jp, jnp.asarray(toks), cfg=jc)
    got = tt.transformer_apply(tp, torch.from_numpy(toks), cfg=tc)
    assert got.shape == (2, 20, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_caches_and_last_logits(name):
    jc, tc = _cfgs(name)
    jp, tp = _params(jc, seed=2)
    toks = _tokens(2, 12, seed=3)
    jcache, jlast = jt.prefill(jp, jnp.asarray(toks), cfg=jc, total=17)
    tcache, tlast = tt.prefill(tp, torch.from_numpy(toks), cfg=tc, total=17)
    assert sorted(tcache) == sorted(jcache)
    for n in jcache:
        assert tcache[n].shape == jcache[n].shape       # (B, total, H_kv, D)
        np.testing.assert_allclose(tcache[n].numpy(), np.asarray(jcache[n]),
                                   **TOL, err_msg=n)
    assert tlast.dtype == torch.float32
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("use_prefill", [False, True],
                         ids=["scan", "prefill"])
def test_greedy_tokens_exact(name, use_prefill):
    jc, tc = _cfgs(name)
    jp, tp = _params(jc, seed=4)
    toks = _tokens(2, 10, seed=5)
    want = jt.greedy_decode(jp, jnp.asarray(toks), 12, cfg=jc,
                            use_prefill=use_prefill)
    got = tt.greedy_decode(tp, torch.from_numpy(toks), 12, cfg=tc,
                           use_prefill=use_prefill)
    assert got.dtype == torch.int32 and got.shape == (2, 22)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_quantize_lm_dict_byte_equal(name):
    jc, _ = _cfgs(name)
    jp, tp = _params(jc, seed=6)
    jq = jt.quantize_lm(jp)
    tq = tt.quantize_lm(tp)
    assert sorted(tq) == sorted(jq)
    for k, v in jq.items():
        got = tq[k]
        assert tuple(got.shape) == v.shape, k
        if k.endswith("::q8"):
            assert got.dtype == torch.int8 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("use_prefill", [False, True],
                         ids=["scan", "prefill"])
def test_int8_weights_and_kv_cache_decode(name, use_prefill):
    """The full int8 serving config (quantize_lm + kv_q8): tokens exact
    against the JAX package's run of the same config."""
    jc, tc = _cfgs(name)
    jp, tp = _params(jc, seed=7)
    toks = _tokens(2, 10, seed=8)
    want = jt.greedy_decode(jt.quantize_lm(jp), jnp.asarray(toks), 12,
                            cfg=jc, use_prefill=use_prefill, kv_q8=True)
    got = tt.greedy_decode(tt.quantize_lm(tp), torch.from_numpy(toks), 12,
                           cfg=tc, use_prefill=use_prefill, kv_q8=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rolling_window_prompt_longer_than_window():
    """window < prompt: the prefill cache folds into the rolling layout
    (slot j holds the last prompt position ≡ j mod window)."""
    jc, tc = _cfgs("window")
    jp, tp = _params(jc, seed=9)
    toks = _tokens(1, 19, seed=10)
    for kv_q8 in (False, True):
        want = jt.greedy_decode(jp, jnp.asarray(toks), 9, cfg=jc,
                                use_prefill=True, kv_q8=kv_q8)
        got = tt.greedy_decode(tp, torch.from_numpy(toks), 9, cfg=tc,
                               use_prefill=True, kv_q8=kv_q8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_n_new_zero_returns_the_prompt():
    _, tc = _cfgs("tiny")
    tp = tt.init_transformer(0, tc, device="cpu")
    toks = torch.from_numpy(_tokens(2, 5))
    for use_prefill in (False, True):
        out = tt.greedy_decode(tp, toks, 0, cfg=tc, use_prefill=use_prefill)
        np.testing.assert_array_equal(out.numpy(), toks.numpy())


def test_init_transformer_names_and_shapes_match_jax():
    for name in CONFIGS:
        jc, tc = _cfgs(name)
        jp = jt.init_transformer(jax.random.PRNGKey(0), jc)
        tp = tt.init_transformer(0, tc, device="cpu")
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: v.shape for k, v in jp.items()}
    bf = tt.init_transformer(0, tc, dtype=torch.bfloat16, device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in bf.values())


def test_flops_per_token_matches_jax():
    for name in CONFIGS:
        jc, tc = _cfgs(name)
        for seq in (16, 128):
            assert tt.flops_per_token(tc, seq) == jt.flops_per_token(jc, seq)


def test_unported_options_raise():
    _, tc = _cfgs("tiny")
    tp = tt.init_transformer(0, tc, device="cpu")
    toks = torch.from_numpy(_tokens(1, 4))
    moe = tt.TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=2,
                               d_ff=64, max_seq=128, moe_experts=2,
                               moe_capacity=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        tt.init_transformer(0, moe, device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        tt.greedy_decode(tp, toks, 2, cfg=moe)
    with pytest.raises(NotImplementedError, match="mesh"):
        tt.prefill(tp, toks, cfg=tc, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        tt.greedy_decode(tp, toks, 2, cfg=tc, use_prefill=True,
                         mesh=object())
    # sampling is ported (tests/test_torch_sampling.py): it runs
    out = tt.greedy_decode(tp, toks, 2, cfg=tc, temperature=0.7, key=0)
    assert tuple(out.shape) == (1, 6) and out.dtype == torch.int32
    with pytest.raises(ValueError, match="PRNG key"):
        tt.greedy_decode(tp, toks, 2, cfg=tc, temperature=0.7)
    import dataclasses
    # remat is ported: the checkpointed forward equals the plain one
    torch.testing.assert_close(
        tt.transformer_apply(tp, toks, cfg=dataclasses.replace(tc,
                                                               remat=True)),
        tt.transformer_apply(tp, toks, cfg=tc), rtol=0, atol=0)
    # prefill drops remat for its capture forward, as the JAX one does
    tt.prefill(tp, toks, cfg=dataclasses.replace(tc, remat=True))


def test_validation_matches_jax():
    _, tc = _cfgs("tiny")
    tp = tt.init_transformer(0, tc, device="cpu")
    with pytest.raises(ValueError, match="at least one token"):
        tt.greedy_decode(tp, torch.zeros((1, 0), dtype=torch.long), 2,
                         cfg=tc)
    with pytest.raises(ValueError, match="max_seq"):
        tt.greedy_decode(tp, torch.zeros((1, 120), dtype=torch.long), 20,
                         cfg=tc)
    with pytest.raises(ValueError, match="temperature"):
        tt.greedy_decode(tp, torch.zeros((1, 3), dtype=torch.long), 2,
                         cfg=tc, temperature=-1.0)
    with pytest.raises(ValueError, match="shorter"):
        tt.prefill(tp, torch.zeros((1, 5), dtype=torch.long), cfg=tc,
                   total=3)
    with pytest.raises(ValueError, match="norm"):
        tt.init_transformer(0, tt.TransformerConfig(norm="bn"),
                            device="cpu")


def test_quantize_lm_dict_survives_convert():
    """A JAX ``quantize_lm`` dict of a bf16 model — int8 ``::q8``, f32
    ``::scale`` and bf16 leaves — crosses to tensors with every dtype
    kept and comes back unchanged: int8 and f32 bytes equal, bf16 values
    equal (widened exactly to f32, as ``params_to_numpy`` documents)."""
    jc, _ = _cfgs("llama_gqa")
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                      jt.init_transformer(jax.random.PRNGKey(11), jc))
    jq = {k: np.asarray(v) for k, v in jt.quantize_lm(jp).items()}
    tq = params_from_jax(jq, device="cpu")
    back = params_to_numpy(tq)
    assert sorted(back) == sorted(jq)
    for k, v in jq.items():
        if k.endswith("::q8"):
            assert tq[k].dtype == torch.int8 and back[k].dtype == np.int8
        elif k.endswith("::scale"):
            assert tq[k].dtype == torch.float32
            assert back[k].dtype == np.float32
        else:
            assert tq[k].dtype == torch.bfloat16, k
            assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], v.astype(back[k].dtype),
                                      err_msg=k)
        if v.dtype.name == "bfloat16":       # and back to the same bits
            np.testing.assert_array_equal(
                np.asarray(jnp.asarray(back[k]).astype(jnp.bfloat16)), v)
