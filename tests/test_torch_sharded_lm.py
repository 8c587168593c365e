"""The port's sequence-, data- and expert-parallel LM against the JAX
package, on gloo CPU worlds.

The same numpy inputs and JAX-initialised parameters go through the JAX
package on the 8 virtual CPU devices of ``tests/conftest.py`` and
through the port on every rank of a world started by
``parallel.mesh.spawn`` (per-rank bodies in
``tests/torch_parallel_ranks.py::sharded_lm_cases``), one world per
size for all of this file's cases:

- 2 ranks: ring, zigzag, Ulysses and the banded ring over sp = 2;
- 4 ranks: the same over sp = 4, and the LM over dp 2 × sp 2 —
  ``make_sharded_apply`` (MHA, GQA, llama-style, MoE),
  ``make_train_step`` (ring, zigzag, pre-permuted zigzag, Ulysses,
  grad_accum with remat, a window, MoE experts over dp, ZeRO-1 in f32
  and in bf16 with f32 masters), sharded ``prefill`` and decode.

Counterparts of ``tests/test_ring_attention.py``, the sharded and MoE
cases of ``tests/test_transformer.py``, ``test_gqa.py``,
``test_modern_lm.py``, ``test_sliding_window.py::TestBandedRing`` and
``test_precision.py:67``, at their tolerances: attention 2e-5 forward
(3e-5 banded) and 1e-4 gradients; the sharded forward and the zigzag
and Ulysses steps 2e-4 (MoE forward 3e-4); grad_accum 1e-5; the window
step's first loss 2e-5; ZeRO-1 against the replicated step 1e-5 in f32
and (test_precision's) 1e-3 on the loss, 2e-2 on parameters in bf16.
Against the JAX step (another summation order over four ranks), losses
rtol 1e-5 and parameters 1e-4 / 1e-5, as tests/test_torch_lm_train.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_parallel_ranks as ranks
from lua_mapreduce_tpu.models import transformer as jt
from lua_mapreduce_tpu.parallel import ring_attention as jra
from lua_mapreduce_tpu.parallel.mesh import make_mesh as jax_mesh
from lua_mapreduce_tpu_torch.parallel import spawn

FWD, GRAD, BAND = (2e-5, 2e-5), (1e-4, 1e-4), (3e-5, 3e-5)
SHARDED = dict(rtol=2e-4, atol=2e-4)
PARAMS = dict(rtol=1e-4, atol=1e-5)
WINDOWS = (1, 5, 16, 40, 128)
TINY = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=128)
CFGS = {
    "tiny": TINY,
    "gqa": dict(TINY, rope=True, norm="rms", ffn="swiglu", n_kv_heads=2),
    "modern": dict(TINY, rope=True, norm="rms", ffn="swiglu"),
    "window": dict(TINY, window=8),
    "moe": dict(TINY, moe_experts=4, moe_capacity=128),
    "zero1": dict(vocab=64, d_model=32, n_heads=4, n_kv_heads=2,
                  n_layers=1, d_ff=48, max_seq=64, rope=True, norm="rms",
                  ffn="swiglu"),
}


def _jcfg(name):
    return jt.TransformerConfig(**CFGS[name])


def _np_params(name, seed):
    return {k: np.asarray(v) for k, v in
            jt.init_transformer(jax.random.PRNGKey(seed), _jcfg(name)).items()}


def _inputs():
    rng = np.random.RandomState(0)
    qkv = tuple((rng.randn(2, 128, 8, 16) * 0.5).astype(np.float32)
                for _ in range(3))
    seq = np.random.RandomState(5).randint(0, 64, (4, 65))
    seq3 = np.random.RandomState(3).randint(0, 64, (4, 65))
    seqz = np.random.RandomState(1).randint(0, 64, (8, 17))
    return {
        "qkv": qkv, "w": rng.randn(2, 128, 8, 16).astype(np.float32),
        "windows": WINDOWS, "cfgs": CFGS,
        "params": {name: _np_params(name, seed) for name, seed in (
            ("tiny", 3), ("gqa", 1), ("modern", 2), ("window", 4),
            ("moe", 0), ("zero1", 0))},
        "apply_tok": np.random.RandomState(0).randint(0, 64, (4, 64)),
        "apply_tok_moe": np.random.RandomState(0).randint(0, 64, (4, 32)),
        "tok": seq[:, :-1].astype(np.int32),
        "tgt": seq[:, 1:].astype(np.int32),
        "tok3": seq3[:, :-1].astype(np.int32),
        "tgt3": seq3[:, 1:].astype(np.int32),
        "tok_z": seqz[:, :-1].astype(np.int32),
        "tgt_z": seqz[:, 1:].astype(np.int32),
        "prompt": np.random.RandomState(22).randint(0, 64, (2, 16)),
    }


D = _inputs()


@functools.lru_cache(maxsize=None)
def _world(n):
    """One world of ``n`` ranks for all of this file's cases of that
    size."""
    return spawn(ranks.sharded_lm_cases, n, D, device="cpu", timeout_s=400)


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def world(request):
    return request.param, _world(request.param)


@pytest.fixture(scope="module")
def lm():
    """The LM cases, from the 4-rank world (dp 2 × sp 2)."""
    return [o["lm"] for o in _world(4)]


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(dp=2, mp=2, devices=jax.devices("cpu")[:4],
                    axis_names=("dp", "sp"))


# ------------------------------------------------------------- attention

@functools.lru_cache(maxsize=None)
def _attn_oracle(causal, window=0):
    q, k, v = (jnp.asarray(x) for x in D["qkv"])
    w = jnp.asarray(D["w"])

    def f(q, k, v):
        return jnp.sum(jra.attention_reference(q, k, v, causal=causal,
                                               window=window) * w)
    o = jra.attention_reference(q, k, v, causal=causal, window=window)
    return np.asarray(o), [np.asarray(g) for g in
                           jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


@pytest.mark.parametrize("schedule", ["ring", "zigzag", "ulysses"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attention_matches_oracle(world, schedule, causal):
    """Ring, zigzag and Ulysses over sp ranks equal the single-device
    oracle, forward and the gradients with respect to q, k and v, on
    every rank (tests/test_ring_attention.py)."""
    _, out = world
    want, wgrads = _attn_oracle(causal)
    name = f"{schedule}_{'causal' if causal else 'full'}"
    for o in out:
        got, grads = o["attn"][name]
        np.testing.assert_allclose(got, want, rtol=FWD[0], atol=FWD[1])
        for g, wg, what in zip(grads, wgrads, "qkv"):
            np.testing.assert_allclose(g, wg, rtol=GRAD[0], atol=GRAD[1],
                                       err_msg=f"d{what}")


@pytest.mark.parametrize("w", WINDOWS, ids=lambda w: f"w{w}")
def test_banded_ring_matches_windowed_oracle(world, w):
    """Windows smaller than, equal to and larger than a shard: the
    banded ring's forward and gradients against the windowed oracle
    (test_sliding_window.py::TestBandedRing)."""
    _, out = world
    want, wgrads = _attn_oracle(True, window=w)
    for o in out:
        got, grads = o["attn"][f"band_w{w}"]
        np.testing.assert_allclose(got, want, rtol=BAND[0], atol=BAND[1])
        for g, wg in zip(grads, wgrads):
            np.testing.assert_allclose(g, wg, rtol=GRAD[0], atol=GRAD[1])


def test_zigzag_layout_and_bf16(world):
    """layout='zigzag' on pre-permuted inputs equals the seq layout
    once un-permuted; bf16 in, f32 accumulate, close to the f32
    oracle."""
    n, out = world
    want, _ = _attn_oracle(True)
    jz = jra.to_zigzag(D["qkv"][0], n)
    assert np.array_equal(jra.from_zigzag(jz, n), D["qkv"][0])
    for o in out:
        np.testing.assert_allclose(o["attn"]["zigzag_layout"],
                                   o["attn"]["zigzag_causal"][0],
                                   rtol=FWD[0], atol=FWD[1])
        np.testing.assert_allclose(o["attn"]["bf16_ring"], want, rtol=0.1,
                                   atol=0.05)


def test_attention_rejections(world):
    _, out = world
    for o in out:
        e = o["attn"]["errors"]
        assert "not divisible" in e["indivisible"]
        assert "heads not divisible" in e["heads"]
        assert "zigzag" in e["zigzag_len"]
        assert "schedule" in e["schedule"]
        assert "requires schedule" in e["layout"]


# ------------------------------------------------------------------- LM

@pytest.mark.parametrize("name", ["tiny", "gqa", "modern"])
@pytest.mark.parametrize("attn", ["ring", "zigzag", "ulysses"])
def test_sharded_forward_matches_oracle(lm, name, attn):
    """make_sharded_apply over dp 2 × sp 2 equals the JAX oracle's
    logits (test_transformer.py, test_gqa.py, test_modern_lm.py)."""
    params = {k: jnp.asarray(v) for k, v in D["params"][name].items()}
    want = np.asarray(jt.transformer_apply(
        params, jnp.asarray(D["apply_tok"], jnp.int32), cfg=_jcfg(name)))
    for o in lm:
        np.testing.assert_allclose(o[f"apply_{name}_{attn}"], want,
                                   **SHARDED)


def test_moe_sharded_forward_matches_oracle(lm):
    """Experts over dp with a capacity nothing overflows: the sharded
    MoE forward equals the single-device oracle (3e-4)."""
    params = {k: jnp.asarray(v) for k, v in D["params"]["moe"].items()}
    want = np.asarray(jt.transformer_apply(
        params, jnp.asarray(D["apply_tok_moe"], jnp.int32),
        cfg=_jcfg("moe")))
    for o in lm:
        np.testing.assert_allclose(o["apply_moe"], want, rtol=3e-4,
                                   atol=3e-4)


@functools.lru_cache(maxsize=None)
def _jax_steps(jmesh, name, n_steps, lr=0.1, attn="ring"):
    cfg = _jcfg(name)
    params = {k: jnp.asarray(v) for k, v in D["params"][name].items()}
    if cfg.moe_experts:
        params = jt.shard_params_moe(params, jmesh)
    opt = optax.sgd(lr)
    step = jt.make_train_step(cfg, jmesh, opt, attn=attn)
    st, losses = opt.init(params), []
    td = jt.shard_batch(jmesh, jnp.asarray(D["tok"]), jnp.asarray(D["tgt"]))
    for _ in range(n_steps):
        params, st, loss = step(params, st, *td)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("attn", ["ring", "zigzag", "zigzag_pre",
                                  "ulysses"])
def test_train_step_matches_jax(lm, jmesh, attn):
    """Two SGD steps over dp 2 × sp 2 against the JAX ring step on its
    2 × 2 mesh: losses and parameters at the JAX-parity tolerances;
    zigzag (in-step and pre-permuted) and Ulysses are drop-ins for the
    ring within 2e-4, and every rank holds the same parameters."""
    want_l, want_p = _jax_steps(jmesh, "tiny", 2)
    for o in lm:
        losses, params = o[f"step_{attn}"]
        ring_l, ring_p = o["step_ring"]
        np.testing.assert_allclose(losses, want_l, rtol=1e-5)
        np.testing.assert_allclose(losses, ring_l, rtol=0, atol=2e-5)
        for k, v in want_p.items():
            np.testing.assert_allclose(params[k], v, **PARAMS, err_msg=k)
            np.testing.assert_allclose(params[k], ring_p[k], **SHARDED)
            np.testing.assert_array_equal(params[k], lm[0][f"step_{attn}"]
                                          [1][k])


def test_moe_train_step_matches_jax(lm, jmesh):
    """MoE with experts over dp (each rank's slice of every stack, from
    ``params_from_jax(mesh=)``) and the sequence over sp: two SGD steps
    equal the JAX step's losses and parameters — the router's gradient
    averaged over (dp, sp), an expert slice's over sp and scaled by
    1/dp; ``params_to_numpy(mesh=)`` gathers the stacks back whole."""
    want_l, want_p = _jax_steps(jmesh, "moe", 2)
    for o in lm:
        losses, params = o["moe"]
        np.testing.assert_allclose(losses, want_l, rtol=1e-5)
        for k, v in want_p.items():
            np.testing.assert_allclose(params[k], v, **PARAMS, err_msg=k)


def test_grad_accum_and_remat_compose_with_sp(lm):
    """grad_accum=2 with remat equals the whole tile (1e-5; loss 2e-6);
    remat alone equals the plain step's loss (1e-6)."""
    for o in lm:
        (l1,), p1 = o["accum1"]
        (l2,), p2 = o["accum2"]
        (lp,), _ = o["remat_plain"]
        assert abs(l1 - l2) < 2e-6
        assert np.isclose(l1, lp, rtol=1e-6)
        for k in p1:
            np.testing.assert_allclose(p2[k], p1[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_windowed_step_loss_matches_oracle(lm):
    """The banded ring in the train step: its first loss is the
    windowed oracle's mean NLL (2e-5)."""
    params = {k: jnp.asarray(v) for k, v in D["params"]["window"].items()}
    logits = jt.transformer_apply(params, jnp.asarray(D["tok"]),
                                  cfg=_jcfg("window"))
    logp = jax.nn.log_softmax(logits)
    want = -float(jnp.mean(jnp.take_along_axis(
        logp, jnp.asarray(D["tgt"])[..., None], -1)))
    for o in lm:
        assert abs(o["window"][0][0] - want) < 2e-5


def test_grads_cover_every_param(lm):
    """A Ulysses step moves every parameter: each name gets a
    gradient through the collectives."""
    before = D["params"]["tiny"]
    for o in lm:
        moved = [k for k in before
                 if not np.allclose(before[k], o["moved"][k])]
        assert set(moved) == set(before)


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_zero1_matches_replicated(lm, tag):
    """ZeRO-1 over dp with sp 2: 4 steps equal the replicated step's —
    f32 SGD with momentum at 1e-5; bf16 params with f32 masters under
    Adam at test_precision.py's limits (loss 1e-3, parameters 2e-2),
    each master f32 and ceil(numel / 2) elements (dp-sharded)."""
    tol = (dict(rtol=1e-5, atol=1e-6) if tag == "f32"
           else dict(rtol=2e-2, atol=2e-2))
    numels = sorted(-(-v.size // 2) for v in D["params"]["zero1"].values())
    for o in lm:
        z, r = o[f"zero1_{tag}_1"], o[f"zero1_{tag}_0"]
        if tag == "f32":
            np.testing.assert_allclose(z["losses"], r["losses"], **tol)
        else:
            assert abs(z["losses"][-1] - r["losses"][-1]) < 1e-3
            assert all(dt == "torch.float32" for dt, _ in z["masters"])
            assert sorted(n for _, n in z["masters"]) == numels
        for k in r["params"]:
            np.testing.assert_allclose(z["params"][k], r["params"][k],
                                       **tol, err_msg=k)


def test_prefill_and_decode_over_the_mesh(lm):
    """Sequence-parallel prefill (ring and zigzag) yields the
    single-device prefill's caches and last logits (2e-4); greedy
    decode through it gives the single-device tokens, with a window
    too (test_transformer.py, test_sliding_window.py)."""
    cfg = _jcfg("tiny")
    params = {k: jnp.asarray(v) for k, v in D["params"]["tiny"].items()}
    prompt = jnp.asarray(D["prompt"], jnp.int32)
    want_c, want_l = jt.prefill(params, prompt, cfg=cfg, total=20)
    tokens = np.asarray(jt.greedy_decode(params, prompt, 4, cfg=cfg))
    wp = {k: jnp.asarray(v) for k, v in D["params"]["window"].items()}
    wtokens = np.asarray(jt.greedy_decode(wp, prompt, 5,
                                          cfg=_jcfg("window")))
    for o in lm:
        for attn in ("ring", "zigzag"):
            caches, logits = o[f"prefill_{attn}"]
            np.testing.assert_allclose(logits, np.asarray(want_l),
                                       **SHARDED, err_msg=attn)
            for name, c in want_c.items():
                np.testing.assert_allclose(caches[name], np.asarray(c),
                                           **SHARDED, err_msg=name)
        assert np.array_equal(o["decode_mesh"], tokens)
        assert np.array_equal(o["decode_window_mesh"], wtokens)


def test_factory_rejections(lm):
    """The JAX package's ValueErrors, raised at factory time on every
    rank."""
    for o in lm:
        e = o["errors"]
        assert "unknown attn" in e["attn"] and "unknown attn" in \
            e["apply_attn"]
        assert "requires attn" in e["layout"]
        assert "BANDED" in e["window"]
        assert "ulysses needs n_heads" in e["heads"]
        assert "not divisible" in e["experts"]
        assert "zero1" in e["zero1_moe"]
        assert "grad_accum" in e["accum_moe"]
        assert "dense" in e["moe_prefill"]
        assert "max_seq" in e["max_seq"]


def test_jax_references_agree_on_the_step(jmesh):
    """The JAX step the port is held to is itself the oracle's: its
    first ring loss on dp 2 × sp 2 is the single-device mean NLL."""
    params = {k: jnp.asarray(v) for k, v in D["params"]["tiny"].items()}
    logits = jt.transformer_apply(params, jnp.asarray(D["tok"]),
                                  cfg=_jcfg("tiny"))
    logp = jax.nn.log_softmax(logits)
    want = -float(jnp.mean(jnp.take_along_axis(
        logp, jnp.asarray(D["tgt"])[..., None], -1)))
    losses, _ = _jax_steps(jmesh, "tiny", 2)
    assert abs(losses[0] - want) < 2e-5
