"""The port's tensor- and pipeline-parallel LM steps against the JAX
package's, on gloo CPU worlds.

The same numpy inputs and JAX-initialised parameters go through the JAX
package on the 8 virtual CPU devices of ``tests/conftest.py`` and
through the port on every rank of a world started by
``parallel.mesh.spawn`` (rank bodies in
``tests/torch_parallel_ranks.py::tp_pp_cases``), one world per size:

- 8 ranks: ``make_train_step_3d`` over (dp, sp, mp) = (2, 2, 2) from the
  JAX package's 3-D dict (``shard_params_3d``, each rank its mp slice) —
  ring, zigzag (in-step and pre-permuted), grad_accum, the modern (rope,
  RMS, SwiGLU) config, 50 Adam steps, the validations; and the 2-D
  entry points on the 3-D mesh, which replicate over mp as the JAX
  ones do;
- 4 ranks: ``make_train_step_pp`` over pp = 4 from the JAX pipeline
  stack, and the 3-D step over (1, 2, 2) with ring and Ulysses;
- 2 ranks: the pipeline over pp = 2 with the modern config and with a
  sliding window.

Counterparts of ``tests/test_transformer.py::Test3D`` and
``TestPipeline``, ``TestMoE::test_moe_rejected_on_3d_path``,
``test_modern_lm.py:149, 177``, ``test_gqa.py:194`` and
``test_sliding_window.py:275``, at their tolerances: one step against
the 2-D step or the single device, loss rtol 1e-5 and parameters 2e-4;
zigzag against ring 2e-5 on the loss; grad_accum against the whole tile
2e-6 / 1e-5; the modern and windowed losses 2e-5. One JAX
``make_train_step_3d`` step at (2, 2, 2) and one ``make_train_step_pp``
step at pp = 4 are run here and held against the port's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_parallel_ranks as ranks
from lua_mapreduce_tpu.models import transformer as jt
from lua_mapreduce_tpu.parallel.mesh import make_mesh as jax_mesh
from lua_mapreduce_tpu_torch.parallel import spawn

STEP = dict(rtol=2e-4, atol=2e-4)
TINY = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq=128)
MODERN = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=48,
              max_seq=128, rope=True, norm="rms", ffn="swiglu")
CFGS = {
    "tiny": TINY,
    "modern": MODERN,
    "moe": dict(TINY, moe_experts=8, moe_capacity=256),
    "pp": dict(TINY, n_layers=4),
    "modern_pp": MODERN,
    "window_pp": dict(MODERN, window=8),
}


def _jcfg(name):
    return jt.TransformerConfig(**CFGS[name])


def _init(name, seed):
    return jt.init_transformer(jax.random.PRNGKey(seed), _jcfg(name))


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _mesh3():
    return jax.sharding.Mesh(
        np.array(jax.devices("cpu")[:8]).reshape(2, 2, 2), ("dp", "sp", "mp"))


def _seq(seed, b, l):
    s = np.random.RandomState(seed).randint(0, 64, (b, l + 1))
    return s[:, :-1].astype(np.int32), s[:, 1:].astype(np.int32)


def _shifted(seed, b, l):
    start = np.random.RandomState(seed).randint(0, 64, (b, 1))
    s = (start + np.arange(l + 1)) % 64
    return s[:, :-1].astype(np.int32), s[:, 1:].astype(np.int32)


def _inputs():
    d = {"cfgs": CFGS, "params": {}}
    P = d["params"]
    P["tiny7"] = _np(_init("tiny", 7))
    P["modern10"] = _np(_init("modern", 10))
    for name, seed in (("tiny", 7), ("tiny", 12), ("tiny", 2),
                       ("modern", 10)):
        P[f"{name}{seed}_3d"] = _np(jt.shard_params_3d(
            _init(name, seed), _mesh3(), _jcfg(name)))
    for key, name, seed in (("pp3_stack", "pp", 3), ("pp4_stack", "pp", 4),
                            ("modern11_pp", "modern_pp", 11),
                            ("window6_pp", "window_pp", 6)):
        P[key] = _np(jt.stack_params_pp(_init(name, seed), _jcfg(name)))
    for tag, (tok, tgt) in (
            ("", _seq(0, 4, 32)), ("_a", _seq(11, 4, 32)),
            ("_m", _seq(9, 4, 32)), ("_l", _shifted(1, 8, 32)),
            ("_p", _seq(0, 8, 32)), ("_pl", _shifted(1, 8, 32)),
            ("_pm", _seq(12, 4, 16)), ("_w", _seq(7, 4, 32))):
        d[f"tok{tag}"], d[f"tgt{tag}"] = tok, tgt
    return d


D = _inputs()


@functools.lru_cache(maxsize=None)
def _world(n):
    return spawn(ranks.tp_pp_cases, n, D, device="cpu", timeout_s=600)


@pytest.fixture(scope="module")
def w8():
    return _world(8)


@pytest.fixture(scope="module")
def w4():
    return _world(4)


@pytest.fixture(scope="module")
def w2():
    return _world(2)


def _oracle_loss(name, params, tok, tgt):
    """The single-device mean NLL — the loss a step returns."""
    p = {k: jnp.asarray(v) for k, v in params.items()}
    logp = jax.nn.log_softmax(jt.transformer_apply(
        p, jnp.asarray(tok), cfg=_jcfg(name)))
    return -float(jnp.mean(jnp.take_along_axis(
        logp, jnp.asarray(tgt)[..., None], -1)))


@functools.lru_cache(maxsize=None)
def _jax_3d_step():
    """One JAX make_train_step_3d SGD(0.1) step at (2, 2, 2), ring."""
    opt = optax.sgd(0.1)
    step = jt.make_train_step_3d(_jcfg("tiny"), _mesh3(), opt, attn="ring")
    p = jt.shard_params_3d(_init("tiny", 7), _mesh3(), _jcfg("tiny"))
    p, _, loss = step(p, opt.init(p), *jt.shard_batch(
        _mesh3(), jnp.asarray(D["tok"]), jnp.asarray(D["tgt"])))
    return float(loss), _np(jt.unshard_params_3d(p, _jcfg("tiny")))


@functools.lru_cache(maxsize=None)
def _jax_2d_step(on_3d):
    """One JAX make_train_step SGD(0.1) step over (dp 2, sp 2) — or on
    the (2, 2, 2) mesh, whose mp axis the step replicates over."""
    opt = optax.sgd(0.1)
    mesh = _mesh3() if on_3d else jax_mesh(
        dp=2, mp=2, devices=jax.devices("cpu")[:4], axis_names=("dp", "sp"))
    step = jt.make_train_step(_jcfg("tiny"), mesh, opt, attn="ring")
    p = _init("tiny", 7)
    p, _, loss = step(p, opt.init(p), *jt.shard_batch(
        mesh, jnp.asarray(D["tok"]), jnp.asarray(D["tgt"])))
    return float(loss), _np(p)


def _assert_params(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **(tol or STEP))


# ------------------------------------------------------------------ 3-D

def test_3d_step_matches_jax_3d_and_2d(w8):
    """One SGD step through the port's 3-D form at (2, 2, 2) equals the
    JAX package's 3-D step and its 2-D (dp, sp) step (loss rtol 1e-5,
    parameters 2e-4); every rank ends with the same canonical params
    (the Megatron pair leaves replicated gradients whole on every mp
    rank)."""
    jl3, jp3 = _jax_3d_step()
    jl2, jp2 = _jax_2d_step(False)
    for o in w8:
        (loss,), params, _ = o["3d_ring"]
        np.testing.assert_allclose(loss, jl3, rtol=1e-5)
        np.testing.assert_allclose(loss, jl2, rtol=1e-5)
        _assert_params(params, jp3)
        _assert_params(params, jp2)
        for k in params:
            np.testing.assert_array_equal(params[k], w8[0]["3d_ring"][1][k])


def test_3d_gradients_whole_on_every_mp_rank(w8):
    """The Megatron pair's trap: without f before the qkv and ff1
    products a replicated param's gradient holds only this slice's
    heads; summed over mp again after f it counts them mp times. Every
    gradient of the step — replicated ones (norms, embeddings, ff2_b)
    and the mp slices gathered — is the same on every rank and equal to
    the JAX 3-D step's, read as (before − after) / lr, within 2e-4."""
    _, jp3 = _jax_3d_step()
    p0 = D["params"]["tiny7"]
    for o in w8:
        grads = o["3d_ring"][2]
        for k, g in grads.items():
            np.testing.assert_array_equal(g, w8[0]["3d_ring"][2][k])
            np.testing.assert_allclose(g, (p0[k] - jp3[k]) / 0.1, err_msg=k,
                                       **STEP)


def test_3d_mesh_ranks_cover_the_cube(w8):
    assert sorted(o["index"] for o in w8) == sorted(
        (a, b, c) for a in range(2) for b in range(2) for c in range(2))


@pytest.mark.parametrize("form", ["zigzag", "zigzag_pre"])
def test_3d_zigzag_matches_3d_ring(w8, form):
    """attn='zigzag' on the 3-D mesh, permuted in the step or fed
    pre-permuted: loss within 2e-5 of the contiguous ring, parameters
    2e-4."""
    for o in w8:
        (lr,), pr, _ = o["3d_ring"]
        (lz,), pz, _ = o[f"3d_{form}"]
        assert abs(lr - lz) < 2e-5
        _assert_params(pz, pr)


def test_3d_grad_accum_matches_whole_tile(w8):
    for o in w8:
        (l1,), p1, _ = o["3d_accum1"]
        (l2,), p2, _ = o["3d_accum2"]
        assert abs(l1 - l2) < 2e-6
        _assert_params(p2, p1, rtol=1e-5, atol=1e-6)


def test_3d_modern_matches_oracle(w8, w4):
    """rope + RMS + SwiGLU on the 3-D mesh (MHA): the step's loss is
    the oracle's within 2e-5 at (2, 2, 2) and at (1, 2, 2) with ring and
    Ulysses (test_modern_lm.py:149); the (1, 2, 2) parameters equal the
    (2, 2, 2) ones within 2e-4."""
    want = _oracle_loss("modern", D["params"]["modern10"], D["tok_m"],
                        D["tgt_m"])
    ref = w8[0]["3d_modern"][1]
    for o in w8:
        assert abs(o["3d_modern"][0][0] - want) < 2e-5
    for o in w4:
        for attn in ("ring", "ulysses"):
            (loss,), params, _ = o[f"3d122_{attn}"]
            assert abs(loss - want) < 2e-5
            _assert_params(params, ref)


def test_3d_training_learns(w8):
    """50 Adam(3e-3) steps on a shifted-sequence task: the loss falls
    below a third of the first."""
    for o in w8:
        losses = o["3d_learns"]
        assert losses[-1] < losses[0] / 3, (losses[0], losses[-1])


def test_2d_entry_points_replicate_over_mp(w8):
    """make_train_step and make_sharded_apply on a (dp, sp, mp) mesh run
    as the JAX ones do there — mp replicates them: the step equals the
    JAX step on the 3-D mesh (itself equal to the (dp, sp) step) and
    the forward equals the oracle."""
    jl, jp = _jax_2d_step(True)
    jl2, jp2 = _jax_2d_step(False)
    assert jl == jl2
    _assert_params(jp, jp2, rtol=0, atol=0)
    p = {k: jnp.asarray(v) for k, v in D["params"]["tiny7"].items()}
    want = np.asarray(jt.transformer_apply(p, jnp.asarray(D["tok"]),
                                           cfg=_jcfg("tiny")))
    for o in w8:
        (loss,), params = o["2d_on_3d"]
        np.testing.assert_allclose(loss, jl, rtol=1e-5)
        _assert_params(params, jp, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(o["apply_on_3d"], want, **STEP)


@pytest.mark.parametrize("case,words", [
    ("heads", "not divisible"), ("moe", "not supported"),
    ("gqa", "MHA only"), ("gqa_shard", "MHA only"),
    ("layout", "requires attn"), ("ulysses", "ulysses needs n_heads")])
def test_3d_validations(w8, case, words):
    """The JAX ValueErrors, with their words: heads not divisible by
    mp, MoE, GQA (the step and shard_params_3d), zigzag_layout without
    zigzag, and Ulysses' per-slice head count."""
    for o in w8:
        assert o["errors"][case] is not None and words in o["errors"][case]


# ------------------------------------------------------------- pipeline

@functools.lru_cache(maxsize=None)
def _jax_pp_reference():
    """The single-device SGD(0.1) step, and one JAX make_train_step_pp
    step over pp = 4 (n_micro 4)."""
    cfg, opt = _jcfg("pp"), optax.sgd(0.1)
    tok, tgt = jnp.asarray(D["tok_p"]), jnp.asarray(D["tgt_p"])
    params0 = _init("pp", 3)

    def loss_fn(p):
        logp = jax.nn.log_softmax(jt.transformer_apply(p, tok, cfg=cfg))
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], -1))

    l_ref, g_ref = jax.value_and_grad(loss_fn)(params0)
    up, _ = opt.update(g_ref, opt.init(params0))
    p_ref = _np(optax.apply_updates(params0, up))
    pp_mesh = jax.sharding.Mesh(np.array(jax.devices("cpu")[:4]), ("pp",))
    step = jt.make_train_step_pp(cfg, pp_mesh, opt, n_micro=4)
    pp = jt.shard_params_pp(params0, pp_mesh, cfg)
    pp, _, l_pp = step(pp, opt.init(pp), tok, tgt)
    return float(l_ref), p_ref, float(l_pp), _np(jt.unstack_params_pp(pp,
                                                                      cfg))


def test_pp_step_matches_single_device_and_jax(w4):
    """One SGD step through the port's 4-stage pipeline equals the same
    step on one device and the JAX package's pipeline step (loss rtol
    1e-5, parameters 2e-4) — forward and backward, every rank alike."""
    l_ref, p_ref, l_jpp, p_jpp = _jax_pp_reference()
    for o in w4:
        (loss,), params = o["pp4"]
        np.testing.assert_allclose(loss, l_ref, rtol=1e-5)
        np.testing.assert_allclose(loss, l_jpp, rtol=1e-5)
        _assert_params(params, p_ref)
        _assert_params(params, p_jpp)


def test_pipeline_training_learns(w4):
    for o in w4:
        losses = o["pp4_learns"]
        assert losses[-1] < losses[0] / 3, (losses[0], losses[-1])


@pytest.mark.parametrize("case,words", [
    ("layers", "not divisible"), ("moe", "dense blocks only"),
    ("batch", "not divisible by n_micro")])
def test_pp_validations(w4, case, words):
    for o in w4:
        assert o["pp_errors"][case] is not None
        assert words in o["pp_errors"][case]


def test_pp_modern_runs(w2):
    """The llama-style key set (no biases, ff3) stacks and unstacks
    whole (test_modern_lm.py:177) and one pp = 2 step's loss is finite
    and the oracle's (2e-5)."""
    from lua_mapreduce_tpu_torch.convert import params_from_jax
    from lua_mapreduce_tpu_torch.models import transformer as tt
    cfg = tt.TransformerConfig(**CFGS["modern_pp"])
    canon = _np(_init("modern_pp", 11))
    tp = params_from_jax(canon, device="cpu")
    rt = tt.unstack_params_pp(tt.stack_params_pp(tp, cfg), cfg)
    assert set(rt) == set(canon)
    for k in canon:
        np.testing.assert_array_equal(rt[k].numpy(), canon[k])
    want = _oracle_loss("modern_pp", canon, D["tok_pm"], D["tgt_pm"])
    for o in w2:
        (loss,), params = o["pp2_modern"]
        assert np.isfinite(loss) and abs(loss - want) < 2e-5
        assert set(params) == set(canon)


def test_pipeline_supports_window(w2):
    """pp does not shard the sequence, so windowed attention runs
    there, and the pp loss is the windowed oracle's (2e-5;
    test_sliding_window.py:275)."""
    want = _oracle_loss("window_pp", _np(_init("window_pp", 6)), D["tok_w"],
                        D["tgt_w"])
    for o in w2:
        assert abs(o["pp2_window"][0][0] - want) < 2e-5
