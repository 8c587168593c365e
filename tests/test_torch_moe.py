"""The port's mixture-of-experts (``parallel/moe.py`` and the MoE blocks
of ``models/transformer.py``) against the JAX package, on the CPU.

Counterparts of every test in ``tests/test_moe.py``, each holding the
port to the JAX function on the same numpy inputs and JAX-initialised
parameters (carried across with ``convert.params_from_jax``): routing,
capacity drops, top-2, sorted against einsum routing (outputs and
gradients), MoE decode and prefill. The expert-parallel cases run the
port in a gloo world of 2 ranks (``parallel.mesh.spawn``; rank bodies in
``tests/torch_parallel_ranks.py::moe_cases``) against the JAX
reference applied tile by tile. Tolerances are that file's: 2e-5 shard
against tile (2e-4 at top-2), sorted against einsum 1e-5 / 1e-6 and
gradients 2e-4 / 1e-5; the port against JAX at the same limits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from lua_mapreduce_tpu.models import transformer as jt
from lua_mapreduce_tpu.parallel import moe as jm
from lua_mapreduce_tpu_torch.convert import params_from_jax, params_to_numpy
from lua_mapreduce_tpu_torch.models import transformer as tt
from lua_mapreduce_tpu_torch.parallel import moe as tm
from lua_mapreduce_tpu_torch.parallel import spawn

D, FF, E, CAP = 16, 32, 8, 4
N_EP = 2
SORTED = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=2e-4, atol=1e-5)
SHARD = dict(rtol=2e-5, atol=2e-5)


def _np_params(seed=0):
    return {k: np.asarray(v) for k, v in
            jm.init_moe(jax.random.PRNGKey(seed), D, FF, E).items()}


P0 = _np_params()


def _tokens(seed, t=32):
    return np.random.RandomState(seed).randn(t, D).astype(np.float32)


def _both(params=P0):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            params_from_jax(params, device="cpu"))


def _run(params, x, **kw):
    """(JAX out, JAX aux, port out, port aux) of moe_ffn_reference."""
    jp, tp = _both(params)
    jo, ja = jm.moe_ffn_reference(jp, jnp.asarray(x), **kw)
    to, ta = tm.moe_ffn_reference(tp, torch.from_numpy(x), **kw)
    return np.asarray(jo), float(ja), to.numpy(), float(ta)


def _collapsed(*experts):
    """A router that sends every positive token to ``experts`` in
    order (first the highest)."""
    w = np.zeros((D, E), np.float32)
    for i, e in enumerate(experts):
        w[:, e] = 100.0 - i
    return dict(P0, moe_router_W=w)


def test_init_moe_shapes_and_scales():
    """init_moe's names, shapes and scales are the JAX package's."""
    got = tm.init_moe(0, D, FF, E)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in P0.items()}
    assert abs(float(got["moe_w1"].std()) - D ** -0.5) < 0.02
    assert abs(float(got["moe_w2"].std()) - FF ** -0.5) < 0.02
    assert float(got["moe_b1"].abs().sum()) == 0.0


def test_reference_routes_and_combines():
    jo, ja, to, ta = _run(P0, _tokens(0), capacity=CAP)
    assert to.shape == (32, D) and np.isfinite(to).all()
    assert 0.5 < ta < float(E)
    np.testing.assert_allclose(to, jo, **SORTED)
    assert abs(ta - ja) <= 1e-5 * abs(ja)


@pytest.mark.parametrize("top_k", [1, 2])
def test_capacity_drops_overflow_tokens(top_k):
    """Every token forced onto one expert (two at top-2, sharing their
    slots): only the first CAP tokens get output, the rest are dropped —
    as in the JAX function."""
    x = np.abs(_tokens(1 if top_k == 1 else 4, t=16))
    experts = (3,) if top_k == 1 else (2, 5)
    jo, _, to, _ = _run(_collapsed(*experts), x, capacity=CAP, top_k=top_k)
    norms = np.linalg.norm(to, axis=-1)
    assert (norms[:CAP] > 1e-6).all()
    np.testing.assert_allclose(norms[CAP:], 0.0, atol=1e-6)
    np.testing.assert_allclose(to, jo, **SORTED)


def test_top2_matches_dense_composition_with_big_capacity():
    """Capacity ≥ T: top-2 routing equals running every expert on every
    token and mixing each token's two highest-gated experts with their
    renormalised gates (computed here in numpy)."""
    x = _tokens(3)
    _, _, to, _ = _run(P0, x, capacity=32, top_k=2)
    w = {k[len("moe_"):]: v.astype(np.float64) for k, v in P0.items()}
    logits = x @ w["router_W"]
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    pre = np.einsum("td,edf->tef", x, w["w1"]) + w["b1"][None]
    h = 0.5 * pre * (1 + np.tanh(np.sqrt(2 / np.pi)
                                 * (pre + 0.044715 * pre ** 3)))
    ye = np.einsum("tef,efd->ted", h, w["w2"]) + w["b2"][None]
    top2 = np.argsort(gates, axis=-1)[:, -2:]
    g2 = np.take_along_axis(gates, top2, axis=-1)
    g2 = g2 / g2.sum(-1, keepdims=True)
    want = np.einsum("tk,tkd->td", g2,
                     np.take_along_axis(ye, top2[:, :, None], axis=1))
    np.testing.assert_allclose(to, want, rtol=2e-4, atol=2e-5)


def test_top_k_ties_take_the_lower_expert():
    """A zero router gives every expert the same gate: lax.top_k picks
    experts 0, 1, ... in order, and so does the port (torch.topk's order
    for equal values is unspecified)."""
    p = dict(P0, moe_router_W=np.zeros((D, E), np.float32))
    x = _tokens(6, t=8)
    for k in (1, 2, 3):
        jo, _, to, _ = _run(p, x, capacity=8, top_k=k)
        np.testing.assert_allclose(to, jo, **SORTED)
    idx = tm._top_k(torch.full((4, E), 0.125), 3)
    assert idx.tolist() == [[0, 1, 2]] * 4


@pytest.mark.parametrize("impl", ["sorted", "einsum"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cap", [CAP, 64])
def test_outputs_match_jax(impl, top_k, cap):
    """Each routing form against the JAX function of the same form."""
    jo, ja, to, ta = _run(P0, _tokens(7, t=48), capacity=cap, top_k=top_k,
                          impl=impl)
    np.testing.assert_allclose(to, jo, **SORTED)
    assert abs(ta - ja) <= 1e-5 * abs(ja)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cap", [CAP, 64])
def test_sorted_matches_einsum_oracle(top_k, cap):
    x = torch.from_numpy(_tokens(7, t=48))
    tp = params_from_jax(P0, device="cpu")
    want, aux_w = tm.moe_ffn_reference(tp, x, capacity=cap, top_k=top_k,
                                       impl="einsum")
    got, aux_g = tm.moe_ffn_reference(tp, x, capacity=cap, top_k=top_k)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SORTED)
    assert abs(float(aux_g) - float(aux_w)) <= 1e-5 * abs(float(aux_w))


@pytest.mark.parametrize("top_k", [1, 2])
def test_sorted_matches_einsum_under_heavy_overflow(top_k):
    """The router collapsed onto one expert: most tokens drop, and the
    fill order (round-major, then token order) agrees."""
    x = torch.from_numpy(np.abs(_tokens(8, t=24)))
    tp = params_from_jax(_collapsed(3), device="cpu")
    want, _ = tm.moe_ffn_reference(tp, x, capacity=CAP, top_k=top_k,
                                   impl="einsum")
    got, _ = tm.moe_ffn_reference(tp, x, capacity=CAP, top_k=top_k)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SORTED)


@pytest.mark.parametrize("top_k", [1, 2])
def test_grads_match_einsum_oracle_and_jax(top_k):
    """Σ out² + 0.01·aux: the sorted form's gradients (the scatter-free
    backward) equal the einsum form's and the JAX sorted form's, for x
    and every parameter."""
    x = _tokens(9, t=32)

    def jloss(params, xx):
        out, aux = jm.moe_ffn_reference(params, xx, capacity=CAP,
                                        top_k=top_k)
        return jnp.sum(out ** 2) + 0.01 * aux

    jp, _ = _both()
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    grads = {}
    for impl in ("einsum", "sorted"):
        tp = {k: v.requires_grad_(True) for k, v in
              params_from_jax(P0, device="cpu").items()}
        xt = torch.from_numpy(x).requires_grad_(True)
        out, aux = tm.moe_ffn_reference(tp, xt, capacity=CAP, top_k=top_k,
                                        impl=impl)
        g = torch.autograd.grad((out ** 2).sum() + 0.01 * aux,
                                [xt] + list(tp.values()))
        grads[impl] = dict(zip(["x"] + list(tp), (t.numpy() for t in g)))
    want = {"x": np.asarray(jg_x), **{k: np.asarray(v)
                                      for k, v in jg_p.items()}}
    for k, v in grads["sorted"].items():
        np.testing.assert_allclose(v, grads["einsum"][k], **GRADS,
                                   err_msg=k)
        np.testing.assert_allclose(v, want[k], **GRADS, err_msg=k)


# ------------------------------------------------ expert-parallel, ep = 2

@pytest.fixture(scope="module")
def world():
    d = {"params": P0, "x": _tokens(2, t=N_EP * 16),
         "x2": _tokens(5, t=N_EP * 8), "cap": CAP, "ff": FF, "e": E}
    return d, spawn(ranks.moe_cases, N_EP, d, device="cpu", timeout_s=240)


def _per_tile(x, **kw):
    jp, _ = _both()
    tiles = np.split(x, N_EP)
    return np.concatenate([np.asarray(jm.moe_ffn_reference(
        jp, jnp.asarray(t), capacity=CAP, **kw)[0]) for t in tiles])


@pytest.mark.parametrize("case", ["shard", "top2", "einsum"])
def test_shard_matches_per_tile_reference(world, case):
    """moe_ffn_shard with experts over 2 ranks equals the JAX reference
    applied per tile (2e-5; top-2 2e-4); sorted and einsum routing agree
    inside the sharded form too."""
    d, out = world
    x = d["x2"] if case == "top2" else d["x"]
    kw = {"top_k": 2} if case == "top2" else {}
    want = _per_tile(x, **kw)
    tol = dict(rtol=2e-4, atol=2e-5) if case == "top2" else SHARD
    got = np.concatenate([o[case][0] for o in out])
    np.testing.assert_allclose(got, want, **tol)
    assert all(np.isfinite(o[case][1]) for o in out)
    if case == "einsum":
        np.testing.assert_allclose(
            got, np.concatenate([o["shard"][0] for o in out]), **SHARD)


def test_shard_gradients_match_jax(world):
    """Gradients through both all_to_alls: the mean over ep of each
    tile's Σ out² + 0.01·aux, against the JAX reference's gradient of
    the same mean over tiles — x's rows, the router (summed over ep),
    and each rank's slice of the expert stacks."""
    d, out = world
    jp, _ = _both()

    def loss(params, x):
        tiles = jnp.split(x, N_EP)
        ls = [jnp.sum(jm.moe_ffn_reference(params, t, capacity=CAP)[0] ** 2)
              + 0.01 * jm.moe_ffn_reference(params, t, capacity=CAP)[1]
              for t in tiles]
        # moe_ffn_shard averages aux over ep: each tile's loss carries
        # the mean aux, which sums to the same total
        return sum(ls) / N_EP
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(d["x"]))
    np.testing.assert_allclose(np.concatenate([o["grad_x"] for o in out]),
                               np.asarray(gx), **GRADS)
    for i, o in enumerate(out):
        for k, g in o["grad_p"].items():
            want = np.asarray(gp[k])
            if k.startswith(("moe_w", "moe_b")):
                want = np.split(want, N_EP)[i]
            np.testing.assert_allclose(g, want, **GRADS, err_msg=k)


def test_moe_trains_and_uses_multiple_experts(world):
    """An ep-sharded regression task reduces its loss below 0.6× the
    first and keeps the router spread over ≥ 3 experts."""
    _, out = world
    losses = out[0]["train_losses"]
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])
    for o in out:
        np.testing.assert_allclose(o["train_losses"], losses, rtol=1e-6)
    x = np.random.RandomState(3).randn(128, D).astype(np.float32)
    used = np.unique((x @ out[0]["train_router"]).argmax(-1)).size
    assert used >= 3, f"router collapsed to {used} experts"


# ----------------------------------------------------------- MoE in the LM

def _lm_cfgs(n_experts=4, capacity=64, **kw):
    base = dict(vocab=32, d_model=16, n_heads=2, n_layers=2, d_ff=24,
                max_seq=32, moe_experts=n_experts, moe_capacity=capacity)
    base.update(kw)
    return jt.TransformerConfig(**base), tt.TransformerConfig(**base)


def _lm_params(jc, seed):
    jp = jt.init_transformer(jax.random.PRNGKey(seed), jc)
    return jp, params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                               device="cpu")


def test_init_transformer_moe_params_match_jax_layout():
    jc, tc = _lm_cfgs()
    jp = jt.init_transformer(jax.random.PRNGKey(0), jc)
    tp = tt.init_transformer(0, tc, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    bad = dataclasses.replace(tc, moe_top_k=5)
    with pytest.raises(ValueError, match="moe_top_k"):
        tt.init_transformer(0, bad, device="cpu")
    with pytest.raises(ValueError, match="moe_capacity"):
        tt.init_transformer(0, dataclasses.replace(tc, moe_capacity=0),
                            device="cpu")


def test_decode_golden_vs_dense_on_identical_experts():
    """MoE decode equals dense decode when every expert is the dense FFN
    (zero router: gates 1/E, ties to expert 0; w2 scaled by E), token
    for token — on the port, as in the JAX package."""
    jc, tc = _lm_cfgs()
    dc = dataclasses.replace(tc, moe_experts=0, moe_capacity=0)
    dense = tt.init_transformer(7, dc, device="cpu")
    moe = {k: v for k, v in dense.items() if "_ff" not in k}
    e = tc.moe_experts
    for i in range(tc.n_layers):
        p = f"L{i}"
        moe[f"{p}_moe_router_W"] = torch.zeros(tc.d_model, e)
        moe[f"{p}_moe_w1"] = dense[f"{p}_ff1_W"][None].repeat(e, 1, 1)
        moe[f"{p}_moe_b1"] = dense[f"{p}_ff1_b"][None].repeat(e, 1)
        moe[f"{p}_moe_w2"] = (e * dense[f"{p}_ff2_W"])[None].repeat(e, 1, 1)
        moe[f"{p}_moe_b2"] = (e * dense[f"{p}_ff2_b"])[None].repeat(e, 1)
    prompt = torch.from_numpy(np.random.RandomState(3).randint(0, 32, (3, 5)))
    got = tt.greedy_decode(moe, prompt, 6, cfg=tc)
    want = tt.greedy_decode(dense, prompt, 6, cfg=dc)
    assert torch.equal(got, want)


def test_decode_matches_jax_and_full_forward_rerun():
    """No bucket overflows (capacity ≥ B·L): the port's MoE decode gives
    the JAX decode's tokens and re-running the full forward at every
    prefix; prefill ingestion gives the same tokens."""
    jc, tc = _lm_cfgs(capacity=3 * 32)
    jp, tp = _lm_params(jc, 11)
    prompt = np.random.RandomState(5).randint(0, 32, (3, 4)).astype(np.int32)
    want = np.asarray(jt.greedy_decode(jp, jnp.asarray(prompt), 6, cfg=jc))
    got = tt.greedy_decode(tp, torch.from_numpy(prompt), 6, cfg=tc)
    assert np.array_equal(got.numpy(), want)
    toks = torch.from_numpy(prompt).long()
    for _ in range(6):
        nxt = tt.transformer_apply(tp, toks, cfg=tc)[:, -1].argmax(-1)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    assert np.array_equal(got.numpy(), toks.numpy())
    pre = tt.greedy_decode(tp, torch.from_numpy(prompt), 6, cfg=tc,
                           use_prefill=True)
    assert torch.equal(pre, got)


def test_prefill_moe_matches_jax():
    """MoE prefill routes the whole (B, P) prompt as one group: caches
    and last logits equal the JAX prefill's (1e-4); the sharded prefill
    refuses MoE."""
    jc, tc = _lm_cfgs(n_experts=2, capacity=8)
    jp, tp = _lm_params(jc, 0)
    prompt = np.random.RandomState(2).randint(0, 32, (2, 8)).astype(np.int32)
    jcache, jlast = jt.prefill(jp, jnp.asarray(prompt), cfg=jc, total=12)
    tcache, tlast = tt.prefill(tp, torch.from_numpy(prompt), cfg=tc,
                               total=12)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
    for k, v in jcache.items():
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    assert tuple(tcache["L0_k"].shape) == (2, 12, 2, 8)
    with pytest.raises(ValueError, match="shorter than the prompt"):
        tt.prefill(tp, torch.from_numpy(prompt), cfg=tc, total=0)


def test_decode_sampling_moe():
    """Temperature sampling on the MoE path is deterministic per key and
    stays in the vocabulary; a capacity-less config is refused."""
    jc, tc = _lm_cfgs()
    _, tp = _lm_params(jc, 1)
    prompt = torch.tensor([[1, 2, 3]])
    a = tt.greedy_decode(tp, prompt, 5, cfg=tc, temperature=0.8, key=4)
    b = tt.greedy_decode(tp, prompt, 5, cfg=tc, temperature=0.8, key=4)
    assert torch.equal(a, b) and bool((a < tc.vocab).all())
    with pytest.raises(ValueError, match="moe_capacity"):
        tt.greedy_decode(tp, prompt, 2,
                         cfg=dataclasses.replace(tc, moe_capacity=0))


def test_quantize_lm_keeps_experts_full_precision():
    """quantize_lm leaves the router and expert stacks as they are and
    quantizes the attention projections and the head; the quantized MoE
    model decodes the JAX quantized model's tokens."""
    jc, tc = _lm_cfgs(capacity=3 * 32)
    jp, tp = _lm_params(jc, 3)
    q = tt.quantize_lm(tp)
    for k, v in tp.items():
        if "_moe_" in k:
            assert torch.equal(q[k], v), k
    assert "L0_qkv_W::q8" in q and "head::q8" in q
    jq = jt.quantize_lm(jp)
    assert sorted(q) == sorted(jq)
    prompt = np.random.RandomState(8).randint(0, 32, (2, 5)).astype(np.int32)
    want = np.asarray(jt.greedy_decode(jq, jnp.asarray(prompt), 5, cfg=jc))
    got = tt.greedy_decode(q, torch.from_numpy(prompt), 5, cfg=tc)
    assert np.array_equal(got.numpy(), want)


def test_moe_train_step_matches_jax_single_device():
    """The MoE step on one device (experts local) against the JAX step
    on a 1 × 1 mesh: 3 SGD-momentum steps, losses rtol 1e-5, every
    parameter 1e-4 / 1e-5; top-2 too."""
    import optax
    from jax.sharding import Mesh
    from lua_mapreduce_tpu_torch.train import optim
    mesh = Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1), ("dp", "sp"))
    seq = np.random.RandomState(1).randint(0, 32, (4, 17))
    tok, tgt = seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)
    for top_k in (1, 2):
        jc, tc = _lm_cfgs(capacity=32, moe_top_k=top_k)
        jp, tp = _lm_params(jc, 2)
        tp = {k: v.requires_grad_(True) for k, v in tp.items()}
        opt = optax.sgd(0.1, momentum=0.9)
        step = jt.make_train_step(jc, mesh, opt, attn="ring")
        st, jl = opt.init(jp), []
        for _ in range(3):
            jp, st, loss = step(jp, st, *jt.shard_batch(
                mesh, jnp.asarray(tok), jnp.asarray(tgt)))
            jl.append(float(loss))
        tstep = tt.make_train_step(tc, optim.sgd(tp.values(), 0.1,
                                                 momentum=0.9))
        tl = [float(tstep(tp, tok, tgt)) for _ in range(3)]
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        for k, v in jp.items():
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(v),
                                       rtol=1e-4, atol=1e-5, err_msg=k)


def test_params_to_numpy_round_trip_with_experts():
    """convert carries the MoE stacks across unchanged."""
    jc, _ = _lm_cfgs()
    jp, tp = _lm_params(jc, 4)
    back = params_to_numpy(tp)
    for k, v in jp.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
