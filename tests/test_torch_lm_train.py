"""Port LM training path ≡ the JAX package's, on the CPU.

The same JAX-initialised parameters (carried across with
``convert.params_from_jax``) and the same numpy tokens go through the
JAX ``make_train_step`` on a 1×1 ``(dp, sp)`` mesh with
``attn="ring"`` (its ring body on one shard: the flash op's lse form,
the XLA reference on the CPU) and through the port's ``make_train_step``
(the plain versions on the CPU), with optax's optimizers against their
``train/optim.py`` counterparts. Tolerances, f32: losses rtol 1e-5;
every parameter after 3 steps rtol 1e-4 / atol 1e-5. bf16 with f32
masters is stated at its test. The port's ``train_lm`` script is held
against the JAX script's loss curve, and its resume against the run
that never stopped, byte for byte.
"""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from lua_mapreduce_tpu.models import transformer as jt
from lua_mapreduce_tpu.train.precision import with_f32_master as j_master
from lua_mapreduce_tpu_torch.convert import params_from_jax
from lua_mapreduce_tpu_torch.models import transformer as tt
from lua_mapreduce_tpu_torch.train import optim
from lua_mapreduce_tpu_torch.train.precision import with_f32_master

LOSS_RTOL = 1e-5
PARAMS = dict(rtol=1e-4, atol=1e-5)
CONFIGS = {
    "tiny": {},
    "llama_gqa": dict(rope=True, norm="rms", ffn="swiglu", n_kv_heads=2),
    "window": dict(window=8),
}
OPTIMIZERS = {
    "sgd_momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                     lambda ps: optim.sgd(ps, 0.1, momentum=0.9)),
    "adam": (lambda: optax.adam(3e-3), lambda ps: optim.adam(ps, 3e-3)),
}


def _cfgs(name, **extra):
    kw = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq=128, **CONFIGS[name], **extra)
    return jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)


def _mesh():
    return Mesh(np.array(jax.devices("cpu")[:1]).reshape(1, 1), ("dp", "sp"))


def _params(jc, seed=0, dtype=None):
    jp = jt.init_transformer(jax.random.PRNGKey(seed), jc)
    if dtype is not None:
        jp = jax.tree.map(lambda x: x.astype(dtype), jp)
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu")
    return jp, {k: v.requires_grad_(True) for k, v in tp.items()}


def _batch(b=4, l=32, seed=1):
    seq = np.random.RandomState(seed).randint(0, 64, (b, l + 1))
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def _jax_run(jc, opt, jp, tok, tgt, steps=3):
    mesh = _mesh()
    step = jt.make_train_step(jc, mesh, opt, attn="ring")
    st, losses = opt.init(jp), []
    for _ in range(steps):
        jp, st, loss = step(jp, st, *jt.shard_batch(
            mesh, jnp.asarray(tok), jnp.asarray(tgt)))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in jp.items()}, st


@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_matches_jax(name, opt_name):
    jc, tc = _cfgs(name)
    jp, tp = _params(jc)
    tok, tgt = _batch()
    j_opt, t_opt = OPTIMIZERS[opt_name]
    want_losses, want, _ = _jax_run(jc, j_opt(), jp, tok, tgt)
    step = tt.make_train_step(tc, t_opt(tp.values()))
    losses = [float(step(tp, tok, tgt)) for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert sorted(tp) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(tp[k].detach().numpy(), v, **PARAMS,
                                   err_msg=k)


def test_remat_matches_non_remat_grads():
    """cfg.remat recomputes each block in the backward: loss and grads
    equal the saved-activation path (tests/test_transformer.py's
    test_remat_matches_non_remat_grads, on the port)."""
    jc, tc = _cfgs("tiny")
    _, tp = _params(jc)
    tok, tgt = (torch.from_numpy(x).long() for x in _batch(2, 8, seed=0))
    pos = torch.arange(tok.shape[1])
    attn = functools.partial(tt.attention_reference, causal=True)
    out = []
    for c in (tc, dataclasses.replace(tc, remat=True)):
        loss = tt.lm_loss_local(tp, tok, tgt, c, attn, pos)
        out.append((float(loss.detach()),
                    torch.autograd.grad(loss, list(tp.values()))))
    (l0, g0), (l1, g1) = out
    assert np.allclose(l0, l1, rtol=1e-6)
    for k, a, b in zip(tp, g0, g1):
        torch.testing.assert_close(b, a, rtol=2e-5, atol=1e-6, msg=k)


def test_grad_accum_matches_whole_batch():
    """grad_accum=2 with remat on equals the un-accumulated step
    (tests/test_transformer.py's test_grad_accum_matches_whole_tile)."""
    jc, tc = _cfgs("tiny", remat=True)
    tok, tgt = _batch(8, 64, seed=6)
    outs = {}
    for accum in (1, 2):
        _, tp = _params(jc, seed=8)
        step = tt.make_train_step(tc, optim.sgd(tp.values(), 0.1),
                                  grad_accum=accum)
        outs[accum] = (float(step(tp, tok, tgt)), tp)
    assert abs(outs[1][0] - outs[2][0]) < 2e-6
    for k in outs[1][1]:
        torch.testing.assert_close(outs[2][1][k], outs[1][1][k], rtol=1e-5,
                                   atol=1e-6, msg=k)


def test_ring_step_equals_the_oracle_step():
    """The ring body on one shard (flash lse form + logaddexp merge)
    gives the loss and gradients of the plain attention oracle."""
    jc, tc = _cfgs("llama_gqa")
    _, tp = _params(jc, seed=3)
    tok, tgt = (torch.from_numpy(x).long() for x in _batch(2, 16, seed=4))
    pos = torch.arange(16)
    out = []
    for attn in (tt._attn_shard_fn("ring", 1, tc),
                 functools.partial(tt.attention_reference, causal=True)):
        loss = tt.lm_loss_local(tp, tok, tgt, tc, attn, pos)
        out.append((float(loss.detach()),
                    torch.autograd.grad(loss, list(tp.values()))))
    assert np.isclose(out[0][0], out[1][0], rtol=1e-6)
    for k, a, b in zip(tp, out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=k)


def test_f32_master_matches_jax_wrapper_on_the_same_grads():
    """F32Master(adam) against JAX with_f32_master(optax.adam) fed the
    same bf16 gradients for 3 steps: f32 masters within 1e-6, bf16
    working parameters equal (each is its master rounded)."""
    rng = np.random.RandomState(2)
    p0 = {"w": rng.randn(16, 8).astype(np.float32) * 0.5,
          "b": rng.randn(8).astype(np.float32) * 0.1}
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p0.items()}
    tp = params_from_jax({k: np.asarray(v) for k, v in jp.items()},
                         device="cpu")
    j_opt = j_master(optax.adam(3e-3))
    st = j_opt.init(jp)
    t_opt = with_f32_master(tp.values(), lambda ms: optim.adam(ms, 3e-3))
    for _ in range(3):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
        jg = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()}
        upd, st = j_opt.update(jg, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = params_from_jax({k: np.asarray(jg[k])},
                                     device="cpu")[k]
        t_opt.step()
    for i, k in enumerate(tp):
        assert tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tp[k].float().numpy(),
                                      np.asarray(jp[k]).astype(np.float32))
        np.testing.assert_allclose(t_opt.masters[i].numpy(),
                                   np.asarray(st[0][k]), rtol=1e-6,
                                   atol=1e-7)


def test_f32_master_adam_train_step_matches_jax():
    """bf16 working parameters, f32 masters under Adam(3e-3), 3 train
    steps against JAX ``with_f32_master(optax.adam(3e-3))``. bf16
    tolerances: the losses (bf16 scalars) within 1e-2 relative; every
    master within 6·lr of JAX's (three Adam steps, each about lr in
    size: a gradient rounded differently in bf16 can flip a small
    component's sign), and the masters' difference normwise within 0.15
    of the update they took (the forward and backward round to bf16 at
    other places in XLA and torch)."""
    jc, tc = _cfgs("tiny")
    jp, tp = _params(jc, dtype=jnp.bfloat16)
    m0 = {k: v.detach().float().numpy().copy() for k, v in tp.items()}
    tok, tgt = _batch()
    want_losses, want, st = _jax_run(jc, j_master(optax.adam(3e-3)), jp,
                                     tok, tgt)
    opt = with_f32_master(tp.values(), lambda ms: optim.adam(ms, 3e-3))
    step = tt.make_train_step(tc, opt)
    losses = [float(step(tp, tok, tgt)) for _ in range(3)]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-2)
    num = den = 0.0
    for i, k in enumerate(tp):
        assert tp[k].dtype == torch.bfloat16
        got, ref = opt.masters[i].numpy(), np.asarray(st[0][k])
        np.testing.assert_allclose(got, ref, rtol=0, atol=6 * 3e-3,
                                   err_msg=k)
        num += float(((got - ref) ** 2).sum())
        den += float(((ref - m0[k]) ** 2).sum())
        np.testing.assert_array_equal(tp[k].detach().float().numpy(),
                                      opt.masters[i].bfloat16().float()
                                      .numpy())
    assert (num / den) ** 0.5 <= 0.15


def _port_args(tmp=None, **kw):
    from lua_mapreduce_tpu_torch.examples.lm import train_lm
    argv = ["--device", "cpu", "--seq", "32", "--batch", "4"]
    for k, v in kw.items():
        flag = "--" + k.replace("_", "-")
        argv += [flag] if v is True else [flag, str(v)]
    return train_lm.build_parser().parse_args(argv)


def test_train_lm_matches_the_jax_script(monkeypatch):
    """``train_lm.run`` with --dp 1 --sp 1 --attn ring --steps 6 on the
    synthetic task (remat on, grad_accum 2, Adam 3e-3) against the JAX
    script's ``run`` from the same initial parameters: equal loss curves
    (both logged rounded to 4 decimals, so within 2e-4)."""
    from examples.lm.train_lm import run as jax_run
    from lua_mapreduce_tpu_torch.examples.lm import train_lm
    jargs = argparse.Namespace(
        dp=1, sp=1, seq=32, batch=4, steps=6, grad_accum=2, attn="ring",
        kv_heads=0, modern=False, window=0, zero1=False, bf16=False,
        ckpt=None, ckpt_every=10, data=None, target_loss=None,
        out_json=None, resume=False)
    want = jax_run(jargs)
    jc = jt.TransformerConfig(vocab=64, d_model=64, n_heads=4, n_layers=2,
                              d_ff=128, max_seq=32, remat=True)
    jp = jt.init_transformer(jax.random.PRNGKey(0), jc)
    carried = {k: np.asarray(v) for k, v in jp.items()}

    def init_from_jax(seed, cfg, dtype=torch.float32, device=None):
        return params_from_jax(carried, device=device)
    monkeypatch.setattr(train_lm.tt, "init_transformer", init_from_jax)
    got = train_lm.run(_port_args(steps=6, dp=1, sp=1, attn="ring"))
    assert [s for s, _ in got["losses"]] == [s for s, _ in want["losses"]]
    np.testing.assert_allclose([x for _, x in got["losses"]],
                               [x for _, x in want["losses"]], rtol=0,
                               atol=2e-4)
    assert got["platform"] == "cpu" and got["steps"] == 6


def test_train_lm_over_a_mesh_matches_the_jax_script(tmp_path):
    """``train_lm`` in a gloo world of 4 ranks — --dp 2 --sp 2 with
    --attn zigzag --zero1, --attn ulysses, and --attn ring --bf16 — from
    the JAX initial parameters (and the first stopped at step 3 with a
    checkpoint, then resumed): the zigzag + ZeRO-1 loss curve equals
    the JAX script's at the same flags (logged rounded to 4 decimals, so
    within 2e-4), the others the port's one-device curve (the bf16
    losses, bf16 scalars reduced in another order, rtol 1e-2 as in
    test_f32_master_adam_train_step_matches_jax);
    every rank logs the same curve and reports the real dp, sp and
    zero1; the resumed run logs the never-stopped run's losses."""
    import torch_parallel_ranks as ranks
    from examples.lm.train_lm import run as jax_run
    from lua_mapreduce_tpu_torch.examples.lm import train_lm
    from lua_mapreduce_tpu_torch.parallel import spawn
    jc = jt.TransformerConfig(vocab=64, d_model=64, n_heads=4, n_layers=2,
                              d_ff=128, max_seq=32, remat=True)
    carried = {k: np.asarray(v) for k, v in
               jt.init_transformer(jax.random.PRNGKey(0), jc).items()}
    def flags(steps, *extra):
        return ["--device", "cpu", "--seq", "32", "--batch", "4", "--steps",
                str(steps), "--dp", "2", "--sp", "2", *extra]
    zz = ("--attn", "zigzag", "--zero1")
    ck = ("--ckpt", f"shared:{tmp_path}", "--ckpt-every", "3")
    runs = [flags(6, *zz), flags(6, "--attn", "ulysses"),
            flags(6, "--attn", "ring", "--bf16"), flags(3, *zz, *ck),
            flags(6, *zz, *ck, "--resume")]
    out = spawn(ranks.train_lm_cases, 4, {"params": carried, "runs": runs},
                device="cpu", timeout_s=400)
    want = jax_run(argparse.Namespace(
        dp=2, sp=2, seq=32, batch=4, steps=6, grad_accum=2, attn="zigzag",
        kv_heads=0, modern=False, window=0, zero1=True, bf16=False,
        ckpt=None, ckpt_every=10, data=None, target_loss=None,
        out_json=None, resume=False))
    one = {}
    for bf16 in (False, True):
        def init_from_jax(seed, cfg, dtype=torch.float32, device=None):
            return params_from_jax(carried, device=device)
        orig = train_lm.tt.init_transformer
        train_lm.tt.init_transformer = init_from_jax
        try:
            one[bf16] = train_lm.run(_port_args(
                steps=6, dp=1, sp=1, **({"bf16": True} if bf16 else {})))
        finally:
            train_lm.tt.init_transformer = orig
    for rank in out:
        for summary, ref, tol in ((rank[0], want, dict(rtol=0, atol=2e-4)),
                                  (rank[1], one[False],
                                   dict(rtol=0, atol=2e-4)),
                                  (rank[2], one[True], dict(rtol=1e-2))):
            assert [s for s, _ in summary["losses"]] == \
                [s for s, _ in ref["losses"]]
            np.testing.assert_allclose([x for _, x in summary["losses"]],
                                       [x for _, x in ref["losses"]], **tol)
        assert rank[0]["config"]["dp"] == 2 and rank[0]["config"]["sp"] == 2
        assert rank[0]["config"]["zero1"] and not rank[1]["config"]["zero1"]
        assert rank[0]["losses"] == out[0][0]["losses"]
        # ZeRO-1 over dp 2: each dp rank's chunks in lm.dp{i}.ckpt, and
        # the resumed run logs the never-stopped run's losses
        assert rank[4]["resumed_at"] == 3
        straight, resumed = dict(rank[0]["losses"]), dict(rank[4]["losses"])
        common = {s for s in straight if s > 3} & set(resumed)
        assert common and all(straight[s] == resumed[s] for s in common)
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.suffix == ".ckpt") == ["lm.dp0.ckpt", "lm.dp1.ckpt"]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_train_lm_resume_is_exact(tmp_path, bf16):
    """--ckpt shared:<dir> --ckpt-every 3, then --resume to step 6,
    equals the run that never stopped: the same logged losses after the
    resume, and the step-6 checkpoints (parameters, optimizer state and
    its f32 masters, step) byte for byte."""
    from lua_mapreduce_tpu_torch.examples.lm import train_lm
    extra = {"bf16": True} if bf16 else {}
    straight = train_lm.run(_port_args(
        steps=6, ckpt=f"shared:{tmp_path}/a", ckpt_every=3, **extra))
    train_lm.run(_port_args(steps=3, ckpt=f"shared:{tmp_path}/b",
                            ckpt_every=3, **extra))
    resumed = train_lm.run(_port_args(steps=6, ckpt=f"shared:{tmp_path}/b",
                                      ckpt_every=3, resume=True, **extra))
    assert resumed["resumed_at"] == 3
    tail = {s: x for s, x in straight["losses"] if s > 3}
    tail2 = {s: x for s, x in resumed["losses"] if s > 3}
    assert set(tail) & set(tail2)
    for s in set(tail) & set(tail2):
        assert tail[s] == tail2[s], s
    a = (tmp_path / "a" / "lm.ckpt").read_bytes()
    b = (tmp_path / "b" / "lm.ckpt").read_bytes()
    assert a == b


def test_async_checkpoint_is_read_by_both_packages(tmp_path):
    """AsyncCheckpoint publishes the text format both packages load; a
    background failure re-raises at wait()."""
    from lua_mapreduce_tpu.store.router import get_storage_from as j_store
    from lua_mapreduce_tpu.train import checkpoint as j_ckpt
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    from lua_mapreduce_tpu_torch.train import checkpoint as ckpt
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "h": torch.ones(3, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    store = get_storage_from(f"shared:{tmp_path}")
    saver = ckpt.AsyncCheckpoint()
    saver.submit(store, "t.ckpt", tree)
    saver.wait()
    assert ckpt.exists(store, "t.ckpt")
    back = ckpt.load_pytree(store, "t.ckpt", tree, check_dtypes=True)
    for k in ("w", "h"):
        assert torch.equal(back["params"][k], tree["params"][k])
    like = {"params": {"w": np.zeros((2, 3), np.float32),
                       "h": jnp.zeros(3, jnp.bfloat16)},
            "step": np.zeros((), np.int32)}
    jback = j_ckpt.load_pytree(j_store(f"shared:{tmp_path}"), "t.ckpt", like)
    np.testing.assert_array_equal(jback["params"]["w"],
                                  tree["params"]["w"].numpy())
    assert int(jback["step"]) == 7

    class Broken:
        def builder(self):
            raise OSError("disk full")
    saver.submit(Broken(), "x", tree)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        saver.wait()


def test_unported_options_raise():
    """No option of the LM trainer is left unported: a mesh axis beyond
    (dp, sp) replicates the 2-D step, as the JAX ``make_train_step``
    does on a (dp, sp, mp) mesh, so the step builds there, and so does
    the 3-D step (both run on a (2, 2, 2) world in
    tests/test_torch_tp_pp.py). The JAX package's ValueErrors stay;
    zigzag and Ulysses run on one shard (the ring's loss, 1e-6), and
    train_lm asks for a world of dp·sp ranks."""
    import types

    from lua_mapreduce_tpu_torch.examples.lm import train_lm
    _, tc = _cfgs("tiny")
    _, tp = _params(_cfgs("tiny")[0])
    opt = optim.sgd(tp.values(), 0.1)
    mesh3 = types.SimpleNamespace(shape={"dp": 1, "sp": 1, "mp": 2},
                                  axis_index=lambda axis: 0)
    assert callable(tt.make_train_step(tc, opt, mesh=mesh3))
    assert callable(tt.make_train_step_3d(tc, mesh3, opt))
    with pytest.raises(ValueError, match="mesh="):
        tt.make_train_step(tc, opt, zero1=True)
    with pytest.raises(ValueError, match="unknown attn"):
        tt.make_train_step(tc, opt, attn="ringg")
    with pytest.raises(ValueError, match="BANDED"):
        tt.make_train_step(dataclasses.replace(tc, window=4), opt,
                           attn="zigzag")
    with pytest.raises(ValueError, match="requires attn"):
        tt.make_train_step(tc, opt, zigzag_layout=True)
    moe = dataclasses.replace(tc, moe_experts=2, moe_capacity=4)
    with pytest.raises(ValueError, match="grad_accum"):
        tt.make_train_step(moe, opt, grad_accum=2)
    with pytest.raises(ValueError, match="zero1"):
        tt.make_train_step(moe, opt, zero1=True)
    tok, tgt = _batch(2, 8)
    losses = {}
    for attn in ("ring", "zigzag", "ulysses"):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in tp.items()}
        losses[attn] = float(tt.make_train_step(
            tc, optim.sgd(p.values(), 0.1), attn=attn)(p, tok, tgt))
    assert np.allclose(losses["zigzag"], losses["ring"], rtol=1e-6)
    assert np.allclose(losses["ulysses"], losses["ring"], rtol=1e-6)
    step = tt.make_train_step(tc, opt, grad_accum=3)
    with pytest.raises(ValueError, match="grad_accum=3"):
        step(tp, *_batch(4, 8))
    # --profile is ported (tests/test_torch_harness.py runs it)
    for kw in ({"dp": 2}, {"sp": 2}, {"dp": 2, "sp": 2}):
        with pytest.raises(SystemExit, match="needs a world of"):
            train_lm.run(_port_args(steps=1, **kw))


def test_params_from_jax_gives_trainable_leaves():
    """Carried-across parameters, f32 and bf16 (a 16-bit view), are leaf
    tensors that take requires_grad and a torch optimizer."""
    jc, _ = _cfgs("tiny")
    for dtype in (None, jnp.bfloat16):
        _, tp = _params(jc, dtype=dtype)
        assert all(v.is_leaf and v.requires_grad for v in tp.values())
        opt = optim.sgd(tp.values(), 0.1)
        loss = sum((v.float() ** 2).sum() for v in tp.values())
        loss.backward()
        before = {k: v.detach().clone() for k, v in tp.items()}
        opt.step()
        assert all(not torch.equal(tp[k], before[k]) for k in tp
                   if before[k].abs().sum() > 0)
