"""The port's ZeRO-1 (``parallel/zero1.py`` and ``DataParallelTrainer(
zero1=True)``) against the replicated trainer and the JAX package's, on
the CPU.

Counterparts of ``tests/test_zero1.py``: the padding edge (a leaf whose
size does not divide n_dp, ``:89``), the rejections (``:114``) and the
trainer's ZeRO-1 run against its replicated run (``:148``, at
grad_accum 1 and 2), each in an n-rank gloo world (n = 2 and 4). The
chunk layout is the JAX module's (flatten, zero-pad to a multiple of
n_dp, split), and each rank's momentum state is ``ceil(numel / n_dp)``
elements a leaf. Tolerances are that file's: rtol 1e-5 / atol 1e-6
between ZeRO-1 and replicated, 1e-6 for the padding edge; against the
JAX trainer (another package, another summation order) 1e-5.
"""

import jax
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from lua_mapreduce_tpu.models.mlp import init_mlp, nll_loss as jax_nll
from lua_mapreduce_tpu.parallel import zero1 as jz1
from lua_mapreduce_tpu.parallel.mesh import host_mesh
from lua_mapreduce_tpu.train.harness import (DataParallelTrainer as
                                             JaxTrainer,
                                             TrainConfig as JaxConfig)
from lua_mapreduce_tpu.utils.jax_compat import shard_map
from lua_mapreduce_tpu_torch.models.mlp import nll_loss
from lua_mapreduce_tpu_torch.parallel import spawn
from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                   TrainConfig)


def _inputs(n):
    rng = np.random.RandomState(5)
    x = rng.rand(64, 32).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    params = {k: np.asarray(v) for k, v in
              init_mlp(jax.random.PRNGKey(6), (32, 16, 10)).items()}
    g = np.random.RandomState(n).randn(n, 10).astype(np.float32)
    return {"x": x, "y": y, "params": params, "g": g}


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def world(request):
    n = request.param
    d = _inputs(n)
    return n, d, spawn(ranks.zero1_cases, n, d, device="cpu",
                       timeout_s=240)


def test_padding_edge_leaf(world):
    """A 10-element leaf over n ranks pads without corrupting the update:
    the port's result equals the JAX body's (sgd(0.5), g = 1)."""
    n, _, out = world
    mesh = host_mesh(n)
    params = {"w": jax.numpy.arange(10, dtype=jax.numpy.float32)}
    opt = optax.sgd(0.5)
    st = jz1.init_state(opt, params, mesh, dp_axis="dp")

    def body(p, s, g):
        gc = jz1.scatter_mean_grads(g, "dp", n)
        pc = jax.tree.map(lambda x: jz1.chunk_of_rank(x, "dp", n), p)
        up, s = opt.update(gc, s, pc)
        pc = optax.apply_updates(pc, up)
        return jz1.gather_params(pc, p, "dp"), s

    st_specs = jz1.state_specs(st, "dp")
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), st_specs, P()),
                           out_specs=(P(), st_specs), check_vma=False))
    want, _ = fn(params, st, {"w": jax.numpy.ones(10, jax.numpy.float32)})
    for o in out:
        np.testing.assert_allclose(o["edge"], np.arange(10) - 0.5, rtol=1e-6)
        np.testing.assert_allclose(o["edge"], np.asarray(want["w"]),
                                   rtol=1e-6)
        assert o["edge_chunk_len"] == -(-10 // n)


def test_chunk_layout_and_scatter_mean(world):
    """chunk_of_rank takes the rank's block of the zero-padded flat leaf;
    scatter_mean_grads gives each rank its block of the mean gradient;
    gather_params inverts chunk_of_rank."""
    n, d, out = world
    c = -(-10 // n)
    full = np.pad(d["g"][0], (0, c * n - 10))
    mean = np.pad(d["g"].mean(0), (0, c * n - 10))
    for i, o in enumerate(out):
        np.testing.assert_array_equal(o["chunk"], full[i * c:(i + 1) * c])
        np.testing.assert_allclose(o["scatter_mean"], mean[i * c:(i + 1) * c],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(o["gathered"], d["g"][0])


@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "accum2"])
def test_trainer_zero1_matches_replicated(world, accum):
    """DataParallelTrainer(zero1=True) lands on the replicated trainer's
    losses and parameters after 4 steps (reduce-scatter + update +
    all-gather ≡ all-reduce + update), and on the JAX package's ZeRO-1
    trainer's; each rank holds 1/n of every momentum buffer, and the
    gathered buffers equal the replicated trainer's."""
    n, d, out = world
    jtr = JaxTrainer(jax_nll, d["params"], host_mesh(n),
                     JaxConfig(batch_size=64, zero1=True, grad_accum=accum))
    jl = [jtr.step(d["x"], d["y"]) for _ in range(4)]
    for o in out:
        zl, zp = o[f"trainer_z1_a{accum}"]
        rl, rp = o[f"trainer_z0_a{accum}"]
        np.testing.assert_allclose(zl, rl, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(zl, jl, rtol=1e-5, atol=1e-6)
        for k in rp:
            np.testing.assert_allclose(zp[k], rp[k], rtol=1e-5, atol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(zp[k], np.asarray(jtr.params[k]),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(zp[k], out[0][
                f"trainer_z1_a{accum}"][1][k])
        numels = {k: v.size for k, v in d["params"].items()}
        assert o[f"trainer_z1_a{accum}_momentum"] == {
            k: -(-v // n) for k, v in numels.items()}
        zb, rb = (o[f"trainer_z1_a{accum}_buffers"],
                  o[f"trainer_z0_a{accum}_buffers"])
        for k in rb:
            assert zb[k].shape == rb[k].shape
            np.testing.assert_allclose(zb[k], rb[k], rtol=1e-5, atol=1e-6)


def test_f32_masters_live_in_the_chunks(world):
    """F32Master(adam) under ZeRO-1 (test_precision.py:67's
    composition): each rank's masters are f32 and ceil(numel / n)
    elements — the dp-sharded master copy — and three updates of bf16
    parameters equal the replicated F32Master's bit for bit."""
    n, _, out = world
    for o in out:
        zp, zm = o["master_z1"]
        rp, rm = o["master_z0"]
        assert zm == [("torch.float32", -(-21 // n)),
                      ("torch.float32", -(-10 // n))]
        assert rm == [("torch.float32", 21), ("torch.float32", 10)]
        for k in rp:
            np.testing.assert_array_equal(zp[k], rp[k], err_msg=k)


def test_zero1_rejections(world):
    """ZeRO-1 needs a mesh; a batch that does not split over dp ×
    grad_accum raises in every rank, as in the JAX trainer."""
    n, d, out = world
    for o in out:
        assert "does not split over dp" in o["reject"]
        assert "grad_accum=2" in o["reject"]
    with pytest.raises(ValueError, match="grad_accum"):
        JaxTrainer(jax_nll, d["params"], host_mesh(n),
                   JaxConfig(zero1=True, grad_accum=2)).step(
            d["x"][:n * 2 + 2], d["y"][:n * 2 + 2])
    with pytest.raises(ValueError, match="mesh"):
        DataParallelTrainer(nll_loss, d["params"], TrainConfig(zero1=True),
                            device="cpu")
