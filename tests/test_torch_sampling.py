"""Sampling in the port's decode loop, and the decode op's device
position, on the CPU.

``greedy_decode(temperature > 0, top_k)`` follows the JAX ``select``
(``lua_mapreduce_tpu/models/transformer.py``: logits/temperature in
f32, everything below the k-th largest set to −1e30, a categorical
draw). The port's noise is counter-based — a hash of (key, t, row,
vocab index) — so it cannot reproduce ``jax.random``'s bits: these tests
hold its DISTRIBUTION against softmax(l/T) restricted to the top k by a
chi-square test, and its properties (top_k=1 is greedy, one key gives
one sequence on both ingestion paths) against the JAX package's
greedy tokens. The step's position is a device tensor (a captured
decode step reads it from device memory): ``decode_attention`` with a
0-d tensor ``t`` equals the int ``t``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from lua_mapreduce_tpu.models import transformer as jt
from lua_mapreduce_tpu_torch.convert import params_from_jax
from lua_mapreduce_tpu_torch.models import transformer as tt
from lua_mapreduce_tpu_torch.ops.decode import decode_attention, quantize_kv

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


def _prompt(b=3, l=10, seed=1):
    return np.random.RandomState(seed).randint(0, 64, (b, l)).astype(
        np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("use_prefill", [False, True])
def test_top_k_1_equals_greedy_and_jax(name, use_prefill):
    jc, tc = _cfgs(name)
    jp, tp = _params(jc, seed=2)
    toks = _prompt()
    want = np.asarray(jt.greedy_decode(jp, jnp.asarray(toks), 8, cfg=jc,
                                       use_prefill=use_prefill))
    got = tt.greedy_decode(tp, torch.from_numpy(toks), 8, cfg=tc,
                           use_prefill=use_prefill, temperature=0.7,
                           top_k=1, key=11)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_key_one_sequence_on_both_paths(name):
    """The same key gives the same tokens, by the position scan and by
    prefill alike (the noise of position t is a function of t, as JAX's
    fold_in(key, t)); another key gives others."""
    _, tc = _cfgs(name)
    tp = tt.init_transformer(3, tc, device="cpu")
    toks = torch.from_numpy(_prompt(seed=4))
    kw = dict(cfg=tc, temperature=1.0, key=5)
    a = tt.greedy_decode(tp, toks, 10, **kw)
    b = tt.greedy_decode(tp, toks, 10, **kw)
    c = tt.greedy_decode(tp, toks, 10, use_prefill=True, **kw)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(a[:, :10], toks.int())
    assert int(a.min()) >= 0 and int(a.max()) < tc.vocab
    d = tt.greedy_decode(tp, toks, 10, cfg=tc, temperature=1.0,
                         key=5 + (1 << 40))
    assert not torch.equal(a, d)
    e = tt.greedy_decode(tp, toks, 10, cfg=tc, temperature=1.0, key=5,
                         top_k=3, use_prefill=True)
    assert torch.equal(e, tt.greedy_decode(tp, toks, 10, cfg=tc,
                                           temperature=1.0, key=5, top_k=3))


@pytest.mark.parametrize("temperature,top_k", [(1.0, None), (0.7, 3),
                                               (2.0, 5), (0.5, 8)])
@pytest.mark.parametrize("axis", ["rows", "positions"])
def test_draws_follow_the_tempered_top_k_softmax(temperature, top_k, axis):
    """20,000 draws from fixed logits over a vocab of 8 — across batch
    rows at one t, or across positions t in one row — pass a chi-square
    test at p > 1e-3 against softmax(l/T) over the top k, and never
    choose a token outside it."""
    logits = torch.tensor([[1.3, -0.4, 0.2, 2.1, -1.7, 0.9, 0.0, 1.1]])
    n = 20000
    if axis == "rows":
        toks = tt.select_token(logits.expand(n, 8), 17,
                               temperature=temperature, top_k=top_k, key=3)
    else:
        toks = torch.cat([tt.select_token(logits, t, temperature=temperature,
                                          top_k=top_k, key=3)
                          for t in range(n)])
    lg = logits[0].double() / temperature
    keep = torch.ones(8, dtype=torch.bool)
    if top_k is not None and top_k < 8:
        keep = lg >= torch.topk(lg, top_k).values[-1]
    p = torch.softmax(torch.where(keep, lg, -torch.inf), 0)
    counts = torch.bincount(toks, minlength=8)
    assert int(counts[~keep].sum()) == 0
    obs, exp = counts[keep].double(), n * p[keep]
    assert float(stats.chisquare(obs.numpy(), exp.numpy()).pvalue) > 1e-3


def test_noise_is_a_pure_function_of_its_counters():
    g1 = tt._gumbel(9, torch.tensor(5), 4, 16, "cpu")
    assert torch.equal(g1, tt._gumbel(9, 5, 4, 16, "cpu"))
    assert not torch.equal(g1, tt._gumbel(9, 6, 4, 16, "cpu"))
    assert not torch.equal(g1, tt._gumbel(10, 5, 4, 16, "cpu"))
    # the whole 64-bit key counts, and t past 2^31 still hashes
    assert not torch.equal(g1, tt._gumbel(9 + (1 << 33), 5, 4, 16, "cpu"))
    assert torch.isfinite(tt._gumbel(1, (1 << 35) + 7, 2, 8, "cpu")).all()
    big = tt._gumbel(2, 0, 200, 500, "cpu")
    assert abs(float(big.mean()) - 0.5772156649) < 0.02   # Euler-Mascheroni
    assert torch.isfinite(big).all()


def test_sampling_validation_matches_jax():
    """The JAX package's ValueErrors, message for message."""
    jc, tc = _cfgs("tiny")
    jp, tp = _params(jc)
    toks = _prompt(1, 3)
    bad = [dict(temperature=-1.0), dict(temperature=0.5),
           dict(temperature=0.5, key=1, top_k=0)]
    for kw in bad:
        jkw = dict(kw)
        if "key" in jkw:
            jkw["key"] = jax.random.PRNGKey(1)
        with pytest.raises(ValueError) as want:
            jt.greedy_decode(jp, jnp.asarray(toks), 2, cfg=jc, **jkw)
        with pytest.raises(ValueError) as got:
            tt.greedy_decode(tp, torch.from_numpy(toks), 2, cfg=tc, **kw)
        assert str(got.value) == str(want.value), kw


# ------------------------------------------- the decode op's position t

@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("roll", [False, True])
def test_decode_attention_tensor_t_equals_int_t(kind, roll):
    gen = torch.Generator().manual_seed(0)
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    q = torch.randn(2, 2, 4, 64, generator=gen).to(dtype)
    k = torch.randn(2, 2, 24, 64, generator=gen).to(dtype)
    v = torch.randn(2, 2, 24, 64, generator=gen).to(dtype)
    scales = {}
    if kind == "int8":
        k, ks = quantize_kv(k)
        v, vs = quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    for t in (0, 5, 23, 24, 40):
        want = decode_attention(q, k, v, t, roll=roll, **scales)
        for dt in (torch.int64, torch.int32):
            got = decode_attention(q, k, v, torch.tensor(t, dtype=dt),
                                   roll=roll, **scales)
            assert torch.equal(got, want), (t, dt)


def test_decode_attention_rejects_a_bad_t():
    q = torch.zeros(1, 1, 1, 64)
    k = torch.zeros(1, 1, 8, 64)
    for t in (torch.tensor([3]), torch.tensor(3.0), torch.tensor(True)):
        with pytest.raises(ValueError, match="0-d integer"):
            decode_attention(q, k, k, t)
    with pytest.raises(TypeError):
        decode_attention(q, k, k, 3.0)
