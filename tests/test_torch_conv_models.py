"""The conv-family training slice, port ≡ JAX package on the CPU:
LeNet-5 and ResNet-18 (``tiny()``, the ImageNet stem, and the ImageNet
topology at 64x64) — log-probabilities, loss and every parameter's
gradient from JAX parameters carried across — and three trainer steps
against the JAX ``DataParallelTrainer`` on a 1-device mesh. Tolerances
are the JAX package's op tolerance (tests/test_ops.py:16-17)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lua_mapreduce_tpu.models import lenet as jax_lenet
from lua_mapreduce_tpu.models import resnet as jax_resnet
from lua_mapreduce_tpu.parallel.mesh import host_mesh
from lua_mapreduce_tpu.train.harness import (DataParallelTrainer as
                                             JaxTrainer,
                                             TrainConfig as JaxConfig)
from lua_mapreduce_tpu_torch.convert import (params_from_jax,
                                             params_to_numpy)
from lua_mapreduce_tpu_torch.models import lenet, resnet
from lua_mapreduce_tpu_torch.train.data import make_images
from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                   TrainConfig)

RTOL = ATOL = 1e-4


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _check_model(jax_apply, jax_loss, port_apply, port_loss, npp, x, y):
    """log-probs, loss and every gradient of the port against JAX."""
    want_logp = np.asarray(jax.jit(jax_apply)(npp, jnp.asarray(x)))
    want_loss, want_g = jax.jit(jax.value_and_grad(jax_loss))(
        npp, jnp.asarray(x), jnp.asarray(y))
    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(npp, device="cpu").items()}
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    logp = port_apply(params, tx)
    np.testing.assert_allclose(logp.detach().numpy(), want_logp, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(logp.detach().exp().sum(1).numpy(), 1.0,
                               atol=1e-4)
    loss = port_loss(params, tx, ty)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) < ATOL
    _close({k: p.grad.numpy() for k, p in params.items()}, _np(want_g))
    for k, p in params.items():     # every parameter carries a gradient
        assert float(p.grad.abs().max()) > 0.0, k


# ------------------------------------------------------------------ LeNet

def test_lenet_apply_loss_and_grads_match_jax():
    npp = _np(jax_lenet.init_lenet(jax.random.PRNGKey(1)))
    x, y, _, _ = make_images(seed=0, n_train=8, n_val=1)
    _check_model(jax_lenet.lenet_apply, jax_lenet.nll_loss,
                 lenet.lenet_apply, lenet.nll_loss, npp, x, y)
    tp = params_from_jax(npp, device="cpu")
    assert float(lenet.accuracy(tp, torch.from_numpy(x),
                                torch.from_numpy(y))) == pytest.approx(
        float(jax_lenet.accuracy(npp, jnp.asarray(x), jnp.asarray(y))))


def test_init_lenet_matches_jax_names_shapes_and_bounds():
    ref = _np(jax_lenet.init_lenet(jax.random.PRNGKey(0)))
    a = lenet.init_lenet(7, device="cpu")
    b = lenet.init_lenet(torch.Generator().manual_seed(7), device="cpu")
    assert list(a) == list(ref)
    for k in ref:
        assert tuple(a[k].shape) == ref[k].shape
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        assert float(a[k].abs().max()) <= float(np.abs(ref[k]).max()) * 1.2
    assert lenet.init_lenet(0, dtype=torch.bfloat16,
                            device="cpu")["c1_W"].dtype == torch.bfloat16
    assert lenet.flops_per_example() == jax_lenet.flops_per_example()
    assert lenet._flat_dim(lenet.CIFAR_SHAPE) == 400


# ----------------------------------------------------------------- ResNet

def _resnet_case(cfg_kw, batch, seed):
    jcfg = jax_resnet.ResNetConfig(**cfg_kw)
    pcfg = resnet.ResNetConfig(**cfg_kw)
    npp = _np(jax_resnet.init_resnet(jax.random.PRNGKey(seed), jcfg))
    x = np.random.RandomState(seed).rand(batch, *jcfg.input_shape).astype(
        np.float32)
    y = np.random.RandomState(seed + 1).randint(
        0, jcfg.n_classes, batch).astype(np.int32)
    return jcfg, pcfg, npp, x, y


def _check_resnet(cfg_kw, batch, seed):
    jcfg, pcfg, npp, x, y = _resnet_case(cfg_kw, batch, seed)
    _check_model(lambda p, x: jax_resnet.resnet_apply(p, x, cfg=jcfg),
                 jax_resnet.make_loss(jcfg),
                 lambda p, x: resnet.resnet_apply(p, x, cfg=pcfg),
                 resnet.make_loss(pcfg), npp, x, y)


def test_resnet_tiny_apply_loss_and_grads_match_jax():
    _check_resnet(dataclass_kw(jax_resnet.ResNetConfig.tiny()), 4, 1)


def test_resnet_imagenet_stem_matches_jax():
    """7x7/2 SAME conv (pads (2, 3)), GroupNorm, relu, -inf pad, 3x3/2
    max pool — values and the gradient of every stem parameter and of
    the input."""
    cfg_kw = dict(input_shape=(64, 64, 3), n_classes=10, widths=(64,),
                  blocks_per_stage=(1,))
    jcfg, pcfg, npp, x, _ = _resnet_case(cfg_kw, 2, 3)
    stem = {k: v for k, v in npp.items() if k.startswith("stem")}

    def jloss(p, x):
        return jnp.mean(jax_resnet._stem(p, x, jcfg, "xla") ** 2)

    want = np.asarray(jax_resnet._stem(stem, jnp.asarray(x), jcfg, "xla"))
    want_g = jax.jit(jax.grad(jloss, argnums=(0, 1)))(stem, jnp.asarray(x))
    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(stem, device="cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out = resnet._stem(params, tx, pcfg)
    assert tuple(out.shape) == (2, 16, 16, 64) == want.shape
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    (out ** 2).mean().backward()
    _close({k: p.grad.numpy() for k, p in params.items()}, _np(want_g[0]))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g[1]),
                               rtol=RTOL, atol=ATOL)


def test_resnet_tiny_bf16_apply_and_loss_match_jax():
    """bf16 parameters and inputs, as the card benchmark trains: the
    port's GroupNorm takes f32 statistics and rounds once, the
    reference rounds at each bf16 step. Held at the JAX suite's bf16
    tolerance (2e-2, tests/test_precision.py): one bf16 ulp of a
    log-probability near -4 is 0.03125, within 2e-2 + 2e-2·4."""
    jcfg, pcfg, _, x, y = _resnet_case(
        dataclass_kw(jax_resnet.ResNetConfig.tiny()), 4, 1)
    npp = _np(jax_resnet.init_resnet(jax.random.PRNGKey(1), jcfg,
                                     dtype=jnp.bfloat16))
    xb = jnp.asarray(x, jnp.bfloat16)
    want_logp = np.asarray(jax.jit(
        lambda p, x: jax_resnet.resnet_apply(p, x, cfg=jcfg))(npp, xb),
        np.float32)
    want_loss = float(jax.jit(jax_resnet.make_loss(jcfg))(
        npp, xb, jnp.asarray(y)))
    params = params_from_jax(npp, device="cpu")
    assert {v.dtype for v in params.values()} == {torch.bfloat16}
    tx = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    logp = resnet.resnet_apply(params, tx, cfg=pcfg)
    assert logp.dtype == torch.bfloat16
    np.testing.assert_allclose(logp.float().numpy(), want_logp, rtol=2e-2,
                               atol=2e-2)
    loss = float(resnet.make_loss(pcfg)(params, tx,
                                        torch.from_numpy(y).long()))
    assert loss == pytest.approx(want_loss, rel=2e-2, abs=2e-2)


@pytest.mark.heavy
def test_resnet_imagenet_topology_64_matches_jax():
    """Full ResNet-18 wiring at 64x64 (tests/test_models.py:70-81): the
    ImageNet stem and all four stages, 1000 classes."""
    _check_resnet(dict(input_shape=(64, 64, 3), n_classes=1000), 2, 0)


def test_init_resnet_matches_jax_names_and_shapes():
    for cfg in (jax_resnet.ResNetConfig.tiny(),
                jax_resnet.ResNetConfig.imagenet18(),
                jax_resnet.ResNetConfig.cifar18()):
        shapes = jax.eval_shape(lambda: jax_resnet.init_resnet(
            jax.random.PRNGKey(0), cfg))
        pcfg = resnet.ResNetConfig(**dataclass_kw(cfg))
        got = resnet.init_resnet(0, pcfg, device="cpu")
        assert set(got) == set(shapes)
        for k, s in shapes.items():
            assert tuple(got[k].shape) == s.shape, k
        assert resnet.flops_per_example(pcfg) == \
            jax_resnet.flops_per_example(cfg)
    p = resnet.init_resnet(0, resnet.ResNetConfig.tiny(),
                           dtype=torch.bfloat16, device="cpu")
    assert {v.dtype for v in p.values()} == {torch.bfloat16}


def dataclass_kw(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


# ---------------------------------------------------------------- trainer

@pytest.mark.parametrize("model", ["lenet", "resnet_tiny"])
def test_trainer_three_steps_match_jax_single_device_mesh(model):
    """Three ``run_steps`` on one batch (the benchmark's hot loop),
    f32, against the JAX trainer on ``host_mesh(1)``: per-step losses
    and the final parameters within 1e-4."""
    if model == "lenet":
        npp = _np(jax_lenet.init_lenet(jax.random.PRNGKey(5)))
        jloss, ploss = jax_lenet.nll_loss, lenet.nll_loss
        x, y, _, _ = make_images(seed=6, n_train=16, n_val=1)
    else:
        jcfg = jax_resnet.ResNetConfig.tiny()
        npp = _np(jax_resnet.init_resnet(jax.random.PRNGKey(5), jcfg))
        jloss = jax_resnet.make_loss(jcfg)
        ploss = resnet.make_loss(resnet.ResNetConfig.tiny())
        x, y, _, _ = make_images(seed=6, n_train=8, n_val=1,
                                 shape=jcfg.input_shape)
    jtr = JaxTrainer(jloss, npp, host_mesh(1), JaxConfig(batch_size=len(x)))
    ptr = DataParallelTrainer(ploss, params_from_jax(npp, device="cpu"),
                              TrainConfig(batch_size=len(x)), device="cpu")
    want = np.asarray(jtr.run_steps(x, y, 3))
    got = ptr.run_steps(x, y, 3)
    assert tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert float(got[-1]) < float(got[0])
    _close(params_to_numpy(ptr.params), _np(jtr.params))


# --------------------------------------------------- no silent CPU fallback

def test_conv_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lenet.init_lenet(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resnet.init_resnet(0, resnet.ResNetConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DataParallelTrainer(lenet.nll_loss,
                            lenet.init_lenet(0, device="cpu"))
