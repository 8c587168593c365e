"""The digits DP-SGD slice, port ≡ JAX package on the CPU: the MLP and
its gradients on carried-across parameters, checkpoints that cross-load
both ways (bf16 included), three MapReduce iterations of mr_train from
one shared initial checkpoint, and five trainer steps. Also: the port's
entry points refuse to run on the CPU unless asked to."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import examples.digits.mr_train as jax_mr
from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxTaskSpec
from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxExecutor
from lua_mapreduce_tpu.models import mlp as jax_mlp
from lua_mapreduce_tpu.parallel.mesh import host_mesh
from lua_mapreduce_tpu.store.memfs import MemStore as JaxMemStore
from lua_mapreduce_tpu.train import checkpoint as jax_ckpt
from lua_mapreduce_tpu.train.harness import (DataParallelTrainer as
                                             JaxTrainer,
                                             TrainConfig as JaxConfig)
from lua_mapreduce_tpu_torch.convert import (params_from_jax,
                                             params_to_numpy)
from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
from lua_mapreduce_tpu_torch.examples.digits import mr_train as port_mr
from lua_mapreduce_tpu_torch.models import mlp
from lua_mapreduce_tpu_torch.store.memfs import MemStore
from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore
from lua_mapreduce_tpu_torch.train import checkpoint as ckpt
from lua_mapreduce_tpu_torch.train.data import make_digits
from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                   TrainConfig)

RTOL = ATOL = 1e-4      # tests/test_ops.py:16-17
SIZES = (64, 32, 10)


def _jax_params(sizes=SIZES, seed=0):
    return {k: np.asarray(v) for k, v in
            jax_mlp.init_mlp(jax.random.PRNGKey(seed), sizes).items()}


def _close(got, want, **kw):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k, **kw)


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("sizes", [SIZES, (256, 128, 10), (48, 40, 24, 10)])
def test_mlp_apply_loss_and_grads_match_jax(sizes):
    npp = _jax_params(sizes, seed=3)
    x, y, _, _ = make_digits(seed=1, n_train=32, n_val=1, dim=sizes[0])
    want_logp = jax_mlp.mlp_apply(npp, jnp.asarray(x))
    want_loss, want_g = jax.value_and_grad(jax_mlp.nll_loss)(
        npp, jnp.asarray(x), jnp.asarray(y))

    params = {k: v.requires_grad_(True)
              for k, v in params_from_jax(npp, device="cpu").items()}
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(mlp.mlp_apply(params, tx).detach().numpy(),
                               np.asarray(want_logp), rtol=RTOL, atol=ATOL)
    loss = mlp.nll_loss(params, tx, ty)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) < ATOL
    _close({k: p.grad for k, p in params.items()}, want_g)
    assert float(mlp.accuracy(params, tx, ty)) == pytest.approx(
        float(jax_mlp.accuracy(npp, jnp.asarray(x), jnp.asarray(y))))
    assert mlp.flops_per_example(sizes) == jax_mlp.flops_per_example(sizes)


def test_init_mlp_shapes_and_seed():
    a = mlp.init_mlp(7, SIZES, device="cpu")
    b = mlp.init_mlp(torch.Generator().manual_seed(7), SIZES, device="cpu")
    ref = _jax_params()
    assert list(a) == list(ref)
    for k in ref:
        assert tuple(a[k].shape) == ref[k].shape
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    bound = np.sqrt(6.0 / (64 + 32))
    assert float(a["W0"].abs().max()) <= bound
    assert mlp.init_mlp(0, (8, 4), dtype=torch.bfloat16,
                        device="cpu")["W0"].dtype == torch.bfloat16


# ------------------------------------------------------------ checkpoints

def _lines(store, name):
    return list(store.lines(name))


def test_checkpoint_cross_loads_both_ways_including_bf16():
    npp = _jax_params()
    jax_tree = {"params": npp,
                "vel": {k: np.full_like(v, 0.5) for k, v in npp.items()},
                "half": jnp.asarray(np.linspace(-2, 2, 12, dtype=np.float32)
                                    .reshape(3, 4)).astype(jnp.bfloat16)}
    js = JaxMemStore()
    jax_ckpt.save_pytree(js, "m.ckpt", jax_tree)

    # JAX → port: every leaf back in its written dtype, bf16 included
    port_tree = {"params": params_from_jax(npp, device="cpu"),
                 "vel": {k: torch.full(v.shape, 0.5) for k, v in npp.items()},
                 "half": params_from_jax(
                     {"h": np.asarray(jax_tree["half"])}, device="cpu")["h"]}
    ps = MemStore()
    ps._files["m.ckpt"] = "".join(_lines(js, "m.ckpt"))
    loaded = ckpt.load_pytree(ps, "m.ckpt", port_tree, check_dtypes=True,
                              check_shapes=True)
    assert loaded["half"].dtype == torch.bfloat16
    torch.testing.assert_close(loaded["half"], port_tree["half"], rtol=0,
                               atol=0)
    _close({k: v.numpy() for k, v in loaded["params"].items()}, npp)

    # port → JAX: byte-identical files, and the JAX loader reads them
    ckpt.save_pytree(ps, "p.ckpt", port_tree)
    assert _lines(ps, "p.ckpt") == _lines(js, "m.ckpt")
    js._files["p.ckpt"] = "".join(_lines(ps, "p.ckpt"))
    back = jax_ckpt.load_pytree(js, "p.ckpt", jax_tree, check_dtypes=True)
    assert back["half"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["half"], np.float32),
                                  np.asarray(jax_tree["half"], np.float32))

    with pytest.raises(ValueError, match="template expects"):
        ckpt.load_pytree(ps, "p.ckpt", {**port_tree, "half": torch.zeros(
            3, 4)}, check_dtypes=True)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_pytree(ps, "p.ckpt", {"params": port_tree["params"]})


def test_checkpoint_structure_string_matches_jax_treedef():
    tree = {"b": (1.0, [2.0, None]), "a": {"y": 3.0, "x": (4.0,)}}
    leaves, treedef = jax.tree.flatten(tree)
    port_leaves, port_def = ckpt.tree_flatten(tree)
    assert port_leaves == leaves and port_def == str(treedef)
    assert ckpt.tree_unflatten(tree, port_leaves) == tree


# ------------------------------------------------------- MapReduce example

def _record_val_losses(module, model_store, sink):
    def finalfn(pairs):
        verdict = module.finalfn(pairs)
        sink.append(module.read_meta(model_store)["val_loss"])
        return verdict
    return {"finalfn": finalfn}


def test_mr_train_three_iterations_match_jax(tmp_path):
    """Both packages' six-function digits trainers, three loop
    iterations from the JAX example's initial checkpoint."""
    args = {"sizes": SIZES, "n_shards": 3, "bunch": 32, "max_steps": 3,
            "patience": 99, "seed": 5}
    jdir, pdir = tmp_path / "jax_model", tmp_path / "port_model"
    jstore, pstore = f"shared:{jdir}", f"shared:{pdir}"
    fns = ("taskfn", "mapfn", "partitionfn", "reducefn")

    jax_val = []
    jspec = JaxTaskSpec(**{f: "examples.digits.mr_train" for f in fns},
                        finalfn=_record_val_losses(jax_mr, jstore, jax_val),
                        init_args={**args, "model_store": jstore},
                        storage="mem:torch-digits-jax-shuffle")
    # the JAX init wrote the initial model; the port starts from a copy
    shutil.copytree(jdir, pdir)
    port_val = []
    pspec = TaskSpec(**{f: "lua_mapreduce_tpu_torch.examples.digits."
                        "mr_train" for f in fns},
                     finalfn=_record_val_losses(port_mr, pstore, port_val),
                     init_args={**args, "model_store": pstore,
                                "device": "cpu"},
                     storage="mem:torch-digits-shuffle")

    JaxExecutor(jspec, max_iterations=5).run()
    stats = LocalExecutor(pspec, max_iterations=5).run()

    assert len(stats.iterations) == 3 and len(port_val) == 3
    np.testing.assert_allclose(port_val, jax_val, rtol=RTOL, atol=ATOL)
    assert port_mr.read_meta(pstore)["step"] == 3
    like = port_mr._template()
    got = ckpt.load_pytree(SharedStore(str(pdir)), "model.ckpt", like,
                           check_dtypes=True)
    want = ckpt.load_pytree(SharedStore(str(jdir)), "model.ckpt", like,
                            check_dtypes=True)
    for part in ("params", "vel"):
        _close({k: v.numpy() for k, v in got[part].items()},
               {k: v.numpy() for k, v in want[part].items()})
    assert any(float(v.abs().max()) > 0 for v in got["vel"].values())


# ---------------------------------------------------------------- trainer

def test_trainer_five_steps_match_jax_single_device_mesh():
    npp = _jax_params(seed=11)
    x, y, _, _ = make_digits(seed=2, n_train=5 * 32, n_val=1, dim=SIZES[0])
    jtr = JaxTrainer(jax_mlp.nll_loss, npp, host_mesh(1), JaxConfig())
    ptr = DataParallelTrainer(mlp.nll_loss,
                              params_from_jax(npp, device="cpu"),
                              TrainConfig(), device="cpu")
    for i in range(5):
        xb, yb = x[i * 32:(i + 1) * 32], y[i * 32:(i + 1) * 32]
        assert abs(ptr.step(xb, yb) - jtr.step(xb, yb)) < ATOL
    _close(params_to_numpy(ptr.params),
           {k: np.asarray(v) for k, v in jtr.params.items()})


def test_trainer_epoch_and_fit_match_jax():
    npp = _jax_params(seed=12)
    x_tr, y_tr, x_va, y_va = make_digits(seed=4, n_train=256, n_val=64,
                                         dim=SIZES[0])
    cfg = dict(batch_size=32, max_epochs=2, patience=5)
    jtr = JaxTrainer(jax_mlp.nll_loss, npp, host_mesh(1), JaxConfig(**cfg))
    ptr = DataParallelTrainer(mlp.nll_loss,
                              params_from_jax(npp, device="cpu"),
                              TrainConfig(**cfg), device="cpu")
    jout = jtr.fit(x_tr, y_tr, x_va, y_va)
    store = MemStore()
    pout = ptr.fit(x_tr, y_tr, x_va, y_va, checkpoint_store=store)
    for jh, ph in zip(jout["history"], pout["history"]):
        assert ph["epoch"] == jh["epoch"]
        assert abs(ph["train_loss"] - jh["train_loss"]) < ATOL
        assert abs(ph["val_loss"] - jh["val_loss"]) < ATOL
    _close(params_to_numpy(ptr.params),
           {k: np.asarray(v) for k, v in jtr.params.items()})
    best = ckpt.load_pytree(store, "model.ckpt", ptr.params)
    assert set(best) == set(ptr.params)
    _, buf = ckpt.load_pytree(store, "model.ckpt.resume",
                              (ptr.params, ptr.momentum_buffers()))
    assert any(float(b.abs().max()) > 0 for b in buf.values())
    losses = ptr.run_steps(x_tr[:32], y_tr[:32], 3)
    assert tuple(losses.shape) == (3,) and bool(torch.isfinite(losses).all())


# --------------------------------------------------- no silent CPU fallback

def test_cuda_entry_points_raise_without_cuda(monkeypatch):
    """With no CUDA device, every entry point whose default is the card
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    npp = _jax_params()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mlp.init_mlp(0, SIZES)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax(npp)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DataParallelTrainer(mlp.nll_loss, params_from_jax(npp, "cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TaskSpec(**{f: "lua_mapreduce_tpu_torch.examples.digits.mr_train"
                    for f in ("taskfn", "mapfn", "partitionfn",
                              "reducefn", "finalfn")},
                 init_args={"sizes": SIZES,
                            "model_store": "mem:torch-nocuda"})
    with pytest.raises(ValueError, match="unsupported device"):
        mlp.init_mlp(0, SIZES, device="meta")
