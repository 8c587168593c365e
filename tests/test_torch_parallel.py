"""The port's data-parallel plane against the JAX package's, on the CPU.

The JAX side runs on ``host_mesh(n)`` (virtual CPU devices); the port's
side runs in an ``n``-rank gloo world started by ``parallel.mesh.
spawn`` (per-rank bodies in ``tests/torch_parallel_ranks.py``), one
world per ``n`` for all the cases, at n = 2 and 4, plus a (2, 2) mesh
for the axis groups. The cases are the counterparts of
``tests/test_tpu_engine.py``: keyed reduction (sum, mean, max, min, the
combiner), the bucketed all_to_all shuffle, every collective, the scan
harness and ``differentiable_keyed``'s gradients. Tolerances are that
file's (rtol 1e-6 for sums, 1e-5 for means and gradients); integer
histograms and max/min are exact. A launcher that meets a hung, dead or
raising rank must fail within its timeout.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from lua_mapreduce_tpu.parallel import (ArrayTaskSpec as JaxSpec,
                                        TpuExecutor as JaxExecutor,
                                        collectives as jc)
from lua_mapreduce_tpu.parallel.mesh import host_mesh, make_mesh as jax_mesh
from lua_mapreduce_tpu.parallel.tpu_engine import (differentiable_keyed as
                                                   jax_dk)
from lua_mapreduce_tpu.utils.jax_compat import shard_map
from lua_mapreduce_tpu_torch.parallel import ArrayTaskSpec, spawn
from lua_mapreduce_tpu_torch.parallel import mesh as port_mesh
from lua_mapreduce_tpu_torch.parallel.tpu_engine import differentiable_keyed

VOCAB, NUM_P = 64, 16


def _hash_word(w):
    h = 2166136261
    for b in w.encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h % VOCAB


def _ids():
    rng = np.random.RandomState(7)
    words = [f"w{i}" for i in range(200)]
    texts = [" ".join(rng.choice(words, size=50)) for _ in range(32)]
    ids = np.array([_hash_word(w) for t in texts for w in t.split()],
                   np.int32)
    return np.concatenate([ids, np.full((-len(ids)) % 8, -1, np.int32)])


def _inputs(n):
    rng = np.random.RandomState(0)
    return {"x": np.arange(n * 4 * 3, dtype=np.float32).reshape(n * 4, 3),
            "r": np.random.RandomState(0).randn(16, 5).astype(np.float32),
            "ids": _ids(), "vocab": VOCAB, "num_p": NUM_P,
            "rs": np.arange(n * 2 * n, dtype=np.float32).reshape(n, 2 * n),
            "a2a": np.arange(n * n * 2, dtype=np.float32).reshape(n * n, 2),
            "ring": np.arange(n, dtype=np.float32).reshape(n, 1),
            "w": rng.rand(4, 3).astype(np.float32),
            "dx": rng.rand(16, 4).astype(np.float32),
            "dy": rng.rand(16, 3).astype(np.float32)}


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def world(request):
    """(n, inputs, every rank's results, the JAX mesh of n devices)."""
    n = request.param
    d = _inputs(n)
    return n, d, spawn(ranks.engine_cases, n, d, device="cpu",
                       timeout_s=240), host_mesh(n)


def _replicated(out, key):
    """The value every rank returned for ``key`` (asserted equal)."""
    first = out[0][key]
    for o in out[1:]:
        if isinstance(first, dict):
            for k in first:
                np.testing.assert_array_equal(o[key][k], first[k],
                                              err_msg=f"{key}/{k}")
        else:
            np.testing.assert_array_equal(o[key], first, err_msg=key)
    return first


def _smap(fn, mesh, out_spec, **kw):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("dp"),),
                             out_specs=out_spec, **kw))


def test_world_has_every_rank(world):
    n, _, out, _ = world
    assert [o["rank"] for o in out] == list(range(n))
    assert all(o["host_mesh_shape"] == {"dp": n, "mp": 1} for o in out)


def test_keyed_sum_matches_global_and_jax(world):
    n, d, out, mesh = world
    got = _replicated(out, "keyed_sum")
    want = JaxExecutor(JaxSpec(mapfn=lambda s: {
        "s": jnp.sum(s, axis=0), "sq": jnp.sum(s ** 2, axis=0)}),
        mesh).run_keyed(d["x"])
    for k in ("s", "sq"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6)
    np.testing.assert_allclose(got["s"], d["x"].sum(0), rtol=1e-6)


@pytest.mark.parametrize("op", ["mean", "max", "min"])
def test_keyed_mean_max_min(world, op):
    n, d, out, mesh = world
    fn = {"mean": lambda s: jnp.mean(s, axis=0),
          "max": lambda s: jnp.max(s, axis=0),
          "min": lambda s: jnp.min(s, axis=0)}[op]
    want = np.asarray(JaxExecutor(JaxSpec(mapfn=fn, reduce_op=op),
                                  mesh).run_keyed(d["r"]))
    got = _replicated(out, f"keyed_{op}")
    if op == "mean":
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(got, d["r"].mean(0), rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_combiner_is_local_prereduction(world):
    n, _, out, mesh = world
    want = JaxExecutor(JaxSpec(mapfn=lambda s: s,
                               combinerfn=lambda t: jnp.sum(t, axis=0)),
                       mesh).run_keyed(np.ones((n, 4), np.float32))
    np.testing.assert_allclose(_replicated(out, "combiner"),
                               np.asarray(want))
    np.testing.assert_allclose(_replicated(out, "combiner"), np.full(4, n))
    assert _replicated(out, "finalfn") == pytest.approx(
        2 * float(_inputs(n)["x"].sum()))


def test_bucketed_shuffle_matches_jax_and_golden(world):
    n, d, out, mesh = world
    per_p = VOCAB // NUM_P
    spec = JaxSpec(
        mapfn=lambda shard: jnp.zeros(VOCAB, jnp.int32).at[shard].add(
            jnp.where(shard >= 0, 1, 0)),
        partitionfn=lambda c: c.reshape(NUM_P, per_p), num_partitions=NUM_P)
    want = np.asarray(JaxExecutor(spec, mesh).run_bucketed(d["ids"]))
    got = np.concatenate([o["bucketed"] for o in out])   # rank p's partitions
    assert got.shape == (NUM_P, per_p) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    golden = np.bincount(d["ids"][d["ids"] >= 0], minlength=VOCAB)
    np.testing.assert_array_equal(got.reshape(-1), golden)


def test_bucketed_partition_divisibility_and_uneven_shards(world):
    n, _, out, mesh = world
    for o in out:
        assert "multiple" in o["divisibility"]
        assert "does not split" in o["uneven"]
    with pytest.raises(ValueError, match="multiple"):
        JaxExecutor(JaxSpec(mapfn=lambda s: s,
                            partitionfn=lambda x: x.reshape(3, -1),
                            num_partitions=3),
                    mesh).run_bucketed(np.zeros((n * 2, 6), np.float32))


def test_psum_pmean_and_all_gather_trees(world):
    n, d, out, mesh = world
    x = d["x"]
    want = _smap(lambda t: jc.psum_tree({"a": t}, "dp")["a"], mesh, P())(x)
    np.testing.assert_allclose(_replicated(out, "psum_tree"),
                               np.asarray(want), rtol=1e-6)
    want = _smap(lambda t: jc.pmean_tree([t], "dp")[0], mesh, P())(x)
    np.testing.assert_allclose(_replicated(out, "pmean_tree"),
                               np.asarray(want), rtol=1e-6)
    # all_gather's result is replicated, which shard_map cannot infer
    want = _smap(lambda t: jc.all_gather_tree({"g": t}, "dp")["g"], mesh,
                 P(), check_vma=False)(x)
    np.testing.assert_array_equal(_replicated(out, "all_gather"),
                                  np.asarray(want))
    np.testing.assert_array_equal(_replicated(out, "all_gather"), x)
    want = _smap(lambda t: jc.all_gather_tree(t, "dp", gather_dimension=1),
                 mesh, P(), check_vma=False)(x)
    np.testing.assert_array_equal(_replicated(out, "all_gather_dim1"),
                                  np.asarray(want))


def test_reduce_scatter(world):
    n, d, out, mesh = world
    rs = d["rs"]
    want = _smap(lambda t: jc.reduce_scatter_tree(t.reshape(-1), "dp"),
                 mesh, P("dp"))(rs)
    got = np.concatenate([o["reduce_scatter"] for o in out])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(got, rs.sum(0), rtol=1e-6)
    want = _smap(lambda t: jc.reduce_scatter_tree(t, "dp",
                                                  scatter_dimension=1),
                 mesh, P(None, "dp"))(rs)
    got = np.concatenate([o["reduce_scatter_dim1"] for o in out], axis=1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
    want = _smap(lambda t: jc.reduce_scatter_tree(t.reshape(n, 2), "dp",
                                                  tiled=False),
                 mesh, P("dp"))(rs)
    got = np.concatenate([o["reduce_scatter_untiled"] for o in out])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


def test_all_to_all_buckets(world):
    n, d, out, mesh = world
    want = _smap(lambda t: jc.all_to_all_buckets(t, "dp"), mesh,
                 P("dp"))(d["a2a"])
    got = np.concatenate([o["all_to_all"] for o in out])
    np.testing.assert_array_equal(got, np.asarray(want))


def test_ppermute_ring_rotates(world):
    n, d, out, mesh = world
    for shift, key in ((1, "ppermute"), (-1, "ppermute_back")):
        want = _smap(lambda t: jc.ppermute_ring(t, "dp", mesh_size=n,
                                                shift=shift),
                     mesh, P("dp"))(d["ring"])
        got = np.concatenate([o[key] for o in out]).reshape(-1)
        np.testing.assert_array_equal(got, np.asarray(want).reshape(-1))
        np.testing.assert_array_equal(got, np.roll(np.arange(n), shift))


def test_run_loop_scan_harness(world):
    n, d, out, mesh = world
    ex = JaxExecutor(JaxSpec(mapfn=lambda s: jnp.sum(s)), mesh)
    final, trace = ex.run_loop(jnp.float32(0), lambda s: (s + 1.0, s),
                               n_steps=5)
    for o in out:
        assert float(o["loop"][0]) == float(final) == 5.0
        np.testing.assert_array_equal(o["loop"][1], np.asarray(trace))
        total = d["x"].sum()
        np.testing.assert_allclose(o["loop_psum"][1], [total] * 3,
                                   rtol=1e-6)
        np.testing.assert_allclose(o["loop_psum"][0], 3 * total, rtol=1e-6)


@pytest.mark.parametrize("op", ["mean", "sum"])
def test_differentiable_keyed_grads_match_oracle(world, op):
    """Value and gradient through the map AND the cross-rank reduction
    equal the JAX primitive's and the single-device oracle's on every
    rank: no n-fold or partial gradient."""
    n, d, out, mesh = world
    w, x, y = (jnp.asarray(d[k]) for k in ("w", "dx", "dy"))

    def mapfn(params, shard):
        xs, ys = shard
        return {"sq": jnp.mean((xs @ params - ys) ** 2)}

    f = jax_dk(mapfn, mesh, axis="dp", reduce_op=op)
    jv, jg = jax.value_and_grad(lambda p: f(p, (x, y))["sq"])(w)
    scale = 1.0 if op == "mean" else float(n)
    ov, og = jax.value_and_grad(
        lambda p: scale * jnp.mean((x @ p - y) ** 2))(w)
    for o in out:
        val, grad = o[f"dk_{op}"]
        np.testing.assert_allclose(val, float(jv), rtol=1e-6)
        np.testing.assert_allclose(val, float(ov), rtol=1e-5)
        np.testing.assert_allclose(grad, np.asarray(jg), rtol=1e-5)
        np.testing.assert_allclose(grad, np.asarray(og), rtol=1e-5)


def test_differentiable_keyed_rejects_max_min():
    for op in ("max", "min"):
        with pytest.raises(ValueError, match="not differentiable"):
            differentiable_keyed(lambda p, s: s, None, "dp", op)
        with pytest.raises(ValueError, match="not differentiable"):
            jax_dk(lambda p, s: s, host_mesh(2), "dp", op)


def test_array_task_spec_checks_match_jax():
    for kwargs, match in (({"reduce_op": "prod"}, "associative"),
                          ({"partitionfn": lambda x: x}, "num_partitions")):
        with pytest.raises(ValueError, match=match):
            ArrayTaskSpec(mapfn=lambda s: s, **kwargs)
        with pytest.raises(ValueError, match=match):
            JaxSpec(mapfn=lambda s: s, **kwargs)
    assert ArrayTaskSpec(mapfn=len).reduce_op == JaxSpec(mapfn=len).reduce_op


def test_mesh_2x2_axis_groups_match_jax():
    """A (dp=2, mp=2) mesh in a world of 4: rank r sits at (r // 2,
    r % 2), as device r of the JAX mesh; a sum over each axis equals the
    JAX psum over that axis."""
    out = spawn(ranks.mesh_2x2_cases, 4, device="cpu", timeout_s=120)
    mesh = jax_mesh(dp=2, mp=2, devices=jax.devices("cpu")[:4])
    ids = np.arange(4, dtype=np.float32).reshape(4, 1)
    for axis in ("dp", "mp"):
        want = jax.jit(shard_map(
            lambda t: jax.lax.psum(t, axis), mesh=mesh,
            in_specs=(P(("dp", "mp")),), out_specs=P(("dp", "mp"))))(ids)
        got = np.concatenate([o[f"psum_{axis}"] for o in out])
        np.testing.assert_array_equal(got, np.asarray(want).reshape(-1))
    for o in out:
        r = o["rank"]
        assert o["index"] == (r // 2, r % 2)
        assert o["dp_ranks"] == [r % 2, r % 2 + 2]
        assert o["mp_ranks"] == [r - r % 2, r - r % 2 + 1]
        assert o["shape"] == {"dp": 2, "mp": 2}


@pytest.mark.parametrize("how", ["hang", "die", "raise"])
def test_spawn_fails_on_a_bad_rank_within_its_timeout(how):
    t0 = time.monotonic()
    err = TimeoutError if how == "hang" else RuntimeError
    with pytest.raises(err):
        spawn(ranks.misbehave, 2, how, device="cpu", timeout_s=8)
    assert time.monotonic() - t0 < 60


def test_spawn_returns_every_rank_result():
    assert spawn(ranks.misbehave, 1, "ok", device="cpu",
                 timeout_s=60) == ["finished"]


def test_spawn_defaults_to_cuda_and_never_to_the_cpu():
    """Like every entry point, spawn runs on the card unless the CPU is
    named: asked for more ranks than there are cards, it raises before
    starting any process instead of running a gloo world."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="CUDA|cards"):
        spawn(ranks.misbehave, n, "ok", timeout_s=8)


def test_make_mesh_starts_one_rank_world_only():
    """No world running: a one-rank mesh starts one (file:// store), a
    larger one raises naming the launchers; a CPU mesh on the world
    asks for gloo."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="spawn"):
        port_mesh.make_mesh(dp=2, device="cpu")
    with pytest.raises(RuntimeError, match="spawn"):
        port_mesh.host_mesh(4)
    try:
        m = port_mesh.make_mesh(device="cpu")
        assert dict(m.shape) == {"dp": 1, "mp": 1}
        assert m.axis_names == ("dp", "mp")
        assert port_mesh.mesh_axis_size(m, "dp") == 1
        assert dist.get_backend() == "gloo"
        assert port_mesh.make_mesh(dp=1, device="cpu") is m
        with pytest.raises(ValueError, match="!= 1 ranks"):
            port_mesh.make_mesh(dp=1, mp=2, device="cpu")
    finally:
        dist.destroy_process_group()
