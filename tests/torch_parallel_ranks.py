"""Per-rank bodies of the port's data-parallel tests.

Each function runs on every rank of a gloo world started by
``lua_mapreduce_tpu_torch.parallel.mesh.spawn`` (so it is a module-level
function, importable by name in the spawned processes) and returns
numpy arrays that the test, in the parent process, holds against the
JAX package and against the other ranks. This module imports torch,
numpy and the port only: the spawned processes never import JAX.
"""

import os
import time

import numpy as np
import torch

from lua_mapreduce_tpu_torch.parallel import (ArrayTaskSpec, TpuExecutor,
                                              differentiable_keyed, host_mesh,
                                              make_mesh)
from lua_mapreduce_tpu_torch.parallel import collectives as C


def _np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------ engine

def engine_cases(mesh, d):
    """Every TpuExecutor / collectives / differentiable_keyed case of
    tests/test_torch_parallel.py on this rank."""
    n = mesh.shape["dp"]
    me = mesh.axis_index("dp")
    out = {"rank": me, "n": n, "host_mesh_shape": dict(host_mesh(n).shape)}

    # keyed: sum of two keys, mean, max, min, and the local combiner
    ex = TpuExecutor(ArrayTaskSpec(
        mapfn=lambda s: {"s": s.sum(0), "sq": (s ** 2).sum(0)}), mesh)
    out["keyed_sum"] = {k: _np(v) for k, v in ex.run_keyed(d["x"]).items()}
    for op, fn in (("mean", lambda s: s.mean(0)),
                   ("max", lambda s: s.amax(0)),
                   ("min", lambda s: s.amin(0))):
        out[f"keyed_{op}"] = _np(TpuExecutor(
            ArrayTaskSpec(mapfn=fn, reduce_op=op), mesh).run_keyed(d["r"]))
    out["combiner"] = _np(TpuExecutor(ArrayTaskSpec(
        mapfn=lambda s: s, combinerfn=lambda t: t.sum(0)),
        mesh).run_keyed(np.ones((n, 4), np.float32)))
    fin = TpuExecutor(ArrayTaskSpec(mapfn=lambda s: s.sum(),
                                    finalfn=lambda t: float(t) * 2), mesh)
    out["finalfn"] = fin.run_keyed(d["x"])

    # bucketed: the hashed wordcount histogram
    vocab, num_p = d["vocab"], d["num_p"]

    def count(shard):
        hist = torch.zeros(vocab, dtype=torch.int32)
        return hist.index_add_(0, shard.clamp_min(0).long(),
                               (shard >= 0).to(torch.int32))

    ex = TpuExecutor(ArrayTaskSpec(
        mapfn=count,
        partitionfn=lambda c: c.reshape(num_p, vocab // num_p),
        num_partitions=num_p), mesh)
    out["bucketed"] = _np(ex.run_bucketed(d["ids"]))
    try:
        TpuExecutor(ArrayTaskSpec(mapfn=lambda s: s,
                                  partitionfn=lambda x: x.reshape(3, -1),
                                  num_partitions=3),
                    mesh).run_bucketed(np.zeros((n * 2, 6), np.float32))
        out["divisibility"] = None
    except ValueError as e:
        out["divisibility"] = str(e)
    try:
        ex.shard_inputs(np.zeros((n + 1, 2), np.float32))
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)

    # collectives on this rank's rows
    shard = ex.shard_inputs(d["x"])
    out["psum_tree"] = _np(C.psum_tree({"a": shard}, mesh, "dp")["a"])
    out["pmean_tree"] = _np(C.pmean_tree([shard], mesh, "dp")[0])
    row = ex.shard_inputs(d["rs"])                       # (1, 2n)
    out["reduce_scatter"] = _np(C.reduce_scatter_tree(
        row.reshape(-1), mesh, "dp"))
    out["reduce_scatter_dim1"] = _np(C.psum_scatter(row, mesh, "dp",
                                                    scatter_dimension=1))
    out["reduce_scatter_untiled"] = _np(C.psum_scatter(
        row.reshape(n, 2), mesh, "dp", tiled=False))
    out["all_gather"] = _np(C.all_gather_tree({"g": shard}, mesh,
                                              "dp")["g"])
    out["all_gather_dim1"] = _np(C.all_gather(shard, mesh, "dp",
                                              gather_dimension=1))
    out["all_to_all"] = _np(C.all_to_all_buckets(
        ex.shard_inputs(d["a2a"]), mesh, "dp"))
    out["ppermute"] = _np(C.ppermute_ring(ex.shard_inputs(d["ring"]), mesh,
                                          "dp", shift=1))
    out["ppermute_back"] = _np(C.ppermute_ring(ex.shard_inputs(d["ring"]),
                                               mesh, "dp", shift=-1))

    # run_loop: the scan harness
    final, trace = ex.run_loop(torch.tensor(0.0),
                               lambda s: (s + 1.0, s), n_steps=5)
    out["loop"] = (_np(final), _np(trace))
    loop_sum = TpuExecutor(ArrayTaskSpec(mapfn=lambda s: s.sum()), mesh)
    x_loc = loop_sum.shard_inputs(d["x"])

    def step(state):
        total = C.psum(x_loc.sum(), mesh, "dp")
        return state + total, total
    final, trace = loop_sum.run_loop(torch.zeros(()), step, n_steps=3)
    out["loop_psum"] = (_np(final), _np(trace))

    # differentiable_keyed: value and gradient, mean and sum
    for op in ("mean", "sum"):
        w = torch.from_numpy(d["w"]).requires_grad_(True)

        def mapfn(params, sh):
            xs, ys = sh
            return {"sq": ((xs @ params - ys) ** 2).mean()}

        f = differentiable_keyed(mapfn, mesh, axis="dp", reduce_op=op)
        loss = f(w, (d["dx"], d["dy"]))["sq"]
        (g,) = torch.autograd.grad(loss, [w])
        out[f"dk_{op}"] = (float(loss), _np(g))
    return out


def mesh_2x2_cases(mesh):
    """A (dp=2, mp=2) mesh in a world of 4: each axis's group and a sum
    over each axis of the rank's own id."""
    m = make_mesh(dp=2, mp=2, device="cpu")
    rank = torch.distributed.get_rank()
    v = torch.tensor([float(rank)])
    return {"rank": rank,
            "index": (m.axis_index("dp"), m.axis_index("mp")),
            "dp_ranks": torch.distributed.get_process_group_ranks(
                m.group("dp")),
            "mp_ranks": torch.distributed.get_process_group_ranks(
                m.group("mp")),
            "psum_dp": _np(C.psum(v, m, "dp")),
            "psum_mp": _np(C.psum(v, m, "mp")),
            "shape": dict(m.shape)}


def misbehave(mesh, how):
    """A rank that hangs, dies or raises (rank 1), while rank 0 waits in
    a collective for it."""
    if mesh.axis_index("dp") == 1:
        if how == "hang":
            time.sleep(600)
        elif how == "die":
            os._exit(3)
        else:
            raise RuntimeError("rank 1 raised on purpose")
    C.psum(torch.ones(1), mesh, "dp")
    return "finished"


# ------------------------------------------------------- k-means / ALS

def kmeans_als_cases(mesh, d):
    from lua_mapreduce_tpu_torch.models import als, kmeans
    km = kmeans.kmeans_fit(d["blobs"], d["c0"], n_iters=10, mesh=mesh)
    al = als.als_fit(d["r"], d["w"], d["v0"], n_iters=5, mesh=mesh)
    return {"km": tuple(_np(t) for t in km),
            "als": tuple(_np(t) for t in al)}


# -------------------------------------------------------------- ZeRO-1

def zero1_cases(mesh, d):
    from lua_mapreduce_tpu_torch.parallel import zero1 as z1
    n = mesh.shape["dp"]
    out = {}
    # the padding edge: a 10-element leaf over n ranks, SGD(0.5), g = 1
    params = {"w": torch.arange(10, dtype=torch.float32)}
    chunks, opt = z1.init_state(lambda ps: torch.optim.SGD(ps, lr=0.5),
                                params, mesh)
    z1.update_chunks(opt, params, {"w": torch.ones(10)}, chunks, mesh, "dp")
    out["edge"] = _np(params["w"])
    out["edge_chunk_len"] = chunks["w"].numel()
    # the layout helpers against the JAX module's arithmetic
    g = torch.from_numpy(d["g"][mesh.axis_index("dp")])   # this rank's grad
    out["scatter_mean"] = _np(z1.scatter_mean_grads({"g": g}, mesh,
                                                    "dp")["g"])
    full = torch.from_numpy(d["g"][0])
    out["chunk"] = _np(z1.chunk_of_rank(full, mesh, "dp"))
    out["gathered"] = _np(z1.gather_params(
        {"g": z1.chunk_of_rank(full, mesh, "dp")}, {"g": full}, mesh,
        "dp")["g"])
    # the trainer, replicated and ZeRO-1, at grad_accum 1 and 2
    from lua_mapreduce_tpu_torch.models.mlp import nll_loss
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)
    for accum in (1, 2):
        for z in (False, True):
            tr = DataParallelTrainer(
                nll_loss, d["params"],
                TrainConfig(batch_size=64, zero1=z, grad_accum=accum),
                mesh=mesh)
            losses = [tr.step(d["x"], d["y"]) for _ in range(4)]
            key = f"trainer_z{int(z)}_a{accum}"
            out[key] = (losses, {k: _np(v) for k, v in tr.params.items()})
            if z:
                out[f"{key}_momentum"] = {
                    k: tr.optimizer.state[c]["momentum_buffer"].numel()
                    for k, c in tr._chunks.items()}
            out[f"{key}_buffers"] = {
                k: _np(v) for k, v in tr.momentum_buffers().items()}
    # f32 masters under ZeRO-1: F32Master over this rank's bf16 chunks
    # keeps chunk-sized f32 masters; the same gradients on every rank
    # (their dp mean exact) give the replicated F32Master's parameters
    from lua_mapreduce_tpu_torch.train import optim
    from lua_mapreduce_tpu_torch.train.precision import with_f32_master
    for z in (False, True):
        rng = np.random.RandomState(9)
        params = {k: torch.from_numpy(rng.randn(*shape).astype(
            np.float32)).bfloat16() for k, shape in (("w", (7, 3)),
                                                    ("b", (10,)))}

        def mk(leaves):
            return with_f32_master(leaves, lambda ms: optim.adam(ms, 3e-3))
        if z:
            chunks, opt = z1.init_state(mk, params, mesh)
        else:
            opt = mk(params.values())
        for _ in range(3):
            g = {k: torch.from_numpy(rng.randn(*v.shape).astype(
                np.float32)).bfloat16() for k, v in params.items()}
            if z:
                z1.update_chunks(opt, params, g, chunks, mesh, "dp")
            else:
                for k, p in params.items():
                    p.grad = g[k]
                opt.step()
        out[f"master_z{int(z)}"] = (
            {k: _np(v.float()) for k, v in params.items()},
            [(str(m.dtype), m.numel()) for m in opt.masters])
    # the rejections: a batch that does not split over dp × grad_accum
    tr = DataParallelTrainer(nll_loss, d["params"],
                             TrainConfig(zero1=True, grad_accum=2), mesh=mesh)
    try:
        tr.step(d["x"][:n * 2 + 2], d["y"][:n * 2 + 2])
        out["reject"] = None
    except ValueError as e:
        out["reject"] = str(e)
    return out


# ------------------------------------------------------------ trainer

def dp_step_cases(mesh, d):
    """One DP step of the digits MLP, and a whole epoch, on this rank."""
    from lua_mapreduce_tpu_torch.models.mlp import nll_loss
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)
    tr = DataParallelTrainer(nll_loss, d["params"], TrainConfig(), mesh=mesh)
    loss = tr.step(d["x"], d["y"])
    out = {"loss": loss, "params": {k: _np(v) for k, v in tr.params.items()}}
    tr = DataParallelTrainer(nll_loss, d["params"],
                             TrainConfig(batch_size=32, grad_accum=2),
                             mesh=mesh)
    out["epoch_loss"] = tr.run_epoch(d["x"], d["y"],
                                     np.random.RandomState(5))
    out["epoch_params"] = {k: _np(v) for k, v in tr.params.items()}
    return out


def fit_resume_cases(mesh, d, root, zero1):
    """fit(conf=) with a mesh on shared stores under ``root``: 2 epochs,
    then a fresh trainer resumes to 3; and one 3-epoch run that never
    stopped. Rank 0 writes, every rank reads."""
    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.coord.persistent_table import (
        PersistentTable)
    from lua_mapreduce_tpu_torch.models.mlp import nll_loss
    from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)

    def fit(params, epochs, tag):
        tr = DataParallelTrainer(
            nll_loss, params, TrainConfig(max_epochs=epochs, patience=10,
                                          batch_size=32, zero1=zero1),
            mesh=mesh)
        out = tr.fit(*d["data"],
                     checkpoint_store=SharedStore(os.path.join(root, tag,
                                                               "ckpt")),
                     conf=PersistentTable("conf", FileJobStore(
                         os.path.join(root, tag, "coord"))))
        return tr, out

    fit(d["params"], 2, "stopped")
    resumed, out = fit(d["other"], 3, "stopped")
    whole, ref = fit(d["params"], 3, "whole")
    return {"epochs": [h["epoch"] for h in out["history"]],
            "resumed": {k: _np(v) for k, v in resumed.params.items()},
            "whole": {k: _np(v) for k, v in whole.params.items()},
            "val": [h["val_loss"] for h in out["history"]],
            "ref_val": [h["val_loss"] for h in ref["history"]][2:]}


# ------------------------------------------------------------ in-graph

def ingraph_sgd(mesh, args):
    """The six-function digits SGD (``examples/digits/mr_sgd.py``) under
    ``engine="ingraph"`` on this rank of the world: the collective tier
    deals the map jobs over the ranks and all-reduces the gradient sums;
    taskfn and finalfn run on every rank (the SPMD control plane)."""
    import re

    from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
    from lua_mapreduce_tpu_torch.examples.digits import mr_sgd
    mod = "lua_mapreduce_tpu_torch.examples.digits.mr_sgd"
    spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod, reducefn=mod,
                    finalfn=mod, init_args={**args, "device": "cpu"},
                    storage="mem:tig-dp")
    ex = LocalExecutor(spec, engine="ingraph", max_iterations=50)
    ex.run()
    engine = ex._ingraph.engine
    pat = re.compile(r"^result\.P(\d+)$")
    st = mr_sgd.read_state()
    return {"ranks": engine._ranks()[0], "mode": engine.mode,
            "traces": engine.traces,
            "folds": sorted(set(engine._plan.folds.values())),
            "params": {k: v.copy() for k, v in st["params"].items()},
            "val_loss": st["val_loss"],
            "bytes": {n: "".join(ex.result_store.lines(n))
                      for n in ex.result_store.list("result.P*")
                      if pat.match(n)}}


def compiled_tasks(mesh, root, cases):
    """Each ``name -> (module, engine)`` case under the port's
    LocalExecutor on this rank (the task modules live in ``root``): the
    published result bytes, the tier, the folds, the ranks the engine
    dealt its jobs over and the iteration's engine counters."""
    import re
    import sys

    from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
    sys.path.insert(0, root)
    pat = re.compile(r"^result\.P(\d+)$")
    out = {}
    for name, (mod, engine) in cases.items():
        spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod,
                        reducefn=mod, storage=f"mem:tcx-{name}")
        ex = LocalExecutor(spec, engine=engine, device="cpu")
        ex.run()
        eng = ex._ingraph.engine or ex._hybrid.map_engine
        out[name] = {
            "bytes": {n: "".join(ex.result_store.lines(n))
                      for n in ex.result_store.list("result.P*")
                      if pat.match(n)},
            "mode": eng.mode, "ranks": eng._ranks()[0],
            "folds": sorted(set(eng._plan.folds.values()))
            if hasattr(eng._plan, "folds") else None,
            "stats": ex.stats.iterations[-1].as_dict()}
    return out


# ------------------------------------------------------- MoE (ep mesh)

def moe_cases(mesh, d):
    """tests/test_torch_moe.py's expert-parallel cases: experts sharded
    over the world (the ``ep`` axis), each rank routing its own tile."""
    from lua_mapreduce_tpu_torch.parallel import moe
    n, me = mesh.shape["dp"], mesh.axis_index("dp")
    m = make_mesh(dp=n, mp=1, device="cpu", axis_names=("ep", "unused"))
    full = {k: torch.from_numpy(v) for k, v in d["params"].items()}
    mine = {k: (v.chunk(n)[me] if k.startswith(("moe_w", "moe_b")) else v)
            for k, v in full.items()}
    out = {}
    for name, x, kw in (("shard", d["x"], {}),
                        ("top2", d["x2"], {"top_k": 2}),
                        ("einsum", d["x"], {"impl": "einsum"})):
        xt = torch.from_numpy(x).chunk(n)[me]
        y, aux = moe.moe_ffn_shard(mine, xt, capacity=d["cap"], mesh=m,
                                   ep_axis="ep", **kw)
        out[name] = (_np(y), float(aux))
    # gradients through both all_to_alls of the mean over tiles of
    # Σ out² + 0.01·aux: each rank differentiates its tile's share (its
    # backward carries the peers' shares of its experts); the router's
    # gradient is then the sum over ep, an expert slice's is kept
    p = {k: v.clone().requires_grad_(True) for k, v in mine.items()}
    xt = torch.from_numpy(d["x"]).chunk(n)[me].requires_grad_(True)
    y, aux = moe.moe_ffn_shard(p, xt, capacity=d["cap"], mesh=m,
                               ep_axis="ep")
    loss = ((y ** 2).sum() + 0.01 * aux) / n
    g = torch.autograd.grad(loss, [xt] + list(p.values()))
    out["grad_x"] = _np(g[0])
    out["grad_p"] = {k: _np(C.psum(gg, m, "ep") if not
                             k.startswith(("moe_w", "moe_b")) else gg)
                     for k, gg in zip(p, g[1:])}
    # a small regression task trains and keeps several experts busy
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(128, d["x"].shape[1]).astype(np.float32))
    y_true = torch.sin(2 * x)
    p = {k: v.clone().requires_grad_(True) for k, v in
         moe.init_moe(1, x.shape[1], d["ff"], d["e"]).items()}
    p = {k: (v.detach().chunk(n)[me].clone().requires_grad_(True)
             if k.startswith(("moe_w", "moe_b")) else v)
         for k, v in p.items()}
    opt = torch.optim.Adam(list(p.values()), lr=1e-2, betas=(0.9, 0.999),
                           eps=1e-8)
    xt, yt = x.chunk(n)[me], y_true.chunk(n)[me]
    losses = []
    for _ in range(60):
        yo, aux = moe.moe_ffn_shard(p, xt, capacity=32, mesh=m,
                                    ep_axis="ep")
        # this rank's share of mean-over-ep(MSE) + 0.01·aux
        loss = (((yo - yt) ** 2).mean() + 0.01 * aux) / n
        gs = torch.autograd.grad(loss, list(p.values()))
        for (k, t), gg in zip(p.items(), gs):
            t.grad = gg if k.startswith(("moe_w", "moe_b")) \
                else C.psum(gg, m, "ep")
        opt.step()
        losses.append(float(C.psum(loss, m, "ep")))
    out["train_losses"] = losses
    out["train_router"] = _np(p["moe_router_W"])
    return out


# -------------------------------------- sequence-parallel LM, (dp, sp)

def _attention_cases(m, d):
    """ring / zigzag / Ulysses / banded ring over the mesh's sp axis:
    outputs and the gradients of Σ out·w with respect to q, k and v."""
    from lua_mapreduce_tpu_torch.parallel import ring_attention as ra
    q, k, v = (torch.from_numpy(x) for x in d["qkv"])
    w = torch.from_numpy(d["w"])
    out = {}
    fns = {f"{name}_{'causal' if c else 'full'}": (lambda c, f: (
        lambda a, b, e: f(a, b, e, c)))(c, f)
           for c in (False, True) for name, f in (
               ("ring", lambda a, b, e, c: ra.ring_attention(
                   a, b, e, m, causal=c)),
               ("zigzag", lambda a, b, e, c: ra.ring_attention(
                   a, b, e, m, causal=c, schedule="zigzag")),
               ("ulysses", lambda a, b, e, c: ra.ulysses_attention(
                   a, b, e, m, causal=c)))}
    for win in d["windows"]:
        fns[f"band_w{win}"] = (lambda ww: lambda a, b, e: ra.ring_attention(
            a, b, e, m, causal=True, window=ww))(win)
    for name, fn in fns.items():
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        o = fn(qq, kk, vv)
        g = torch.autograd.grad((o * w).sum(), (qq, kk, vv))
        out[name] = (_np(o), tuple(_np(x) for x in g))
    n = m.shape["sp"]
    qz, kz, vz = (ra.to_zigzag(x, n) for x in (q, k, v))
    out["zigzag_layout"] = _np(ra.from_zigzag(ra.ring_attention(
        qz, kz, vz, m, causal=True, schedule="zigzag", layout="zigzag"), n))
    out["bf16_ring"] = _np(ra.ring_attention(
        q.bfloat16(), k.bfloat16(), v.bfloat16(), m, causal=True).float())
    errs = {}
    for name, call in (
            ("indivisible", lambda: ra.ring_attention(q[:, :63], k[:, :63],
                                                      v[:, :63], m)),
            ("heads", lambda: ra.ulysses_attention(q[:, :, :3], k[:, :, :3],
                                                   v[:, :, :3], m)),
            ("zigzag_len", lambda: ra.ring_attention(
                q[:, :4 * n + 2], k[:, :4 * n + 2], v[:, :4 * n + 2], m,
                causal=True, schedule="zigzag")),
            ("schedule", lambda: ra.ring_attention(q, k, v, m,
                                                   schedule="stripy")),
            ("layout", lambda: ra.ring_attention(q, k, v, m, causal=True,
                                                 layout="zigzag"))):
        try:
            call()
            errs[name] = None
        except ValueError as e:
            errs[name] = str(e)
    out["errors"] = errs
    return out


def _lm_params(np_params, **kw):
    from lua_mapreduce_tpu_torch.convert import params_from_jax
    return {k: v.requires_grad_(True) for k, v in
            params_from_jax(np_params, device="cpu", **kw).items()}


def _lm_steps(cfg, m, np_params, tok, tgt, n_steps, lr=0.1, ep=False,
              schedule="contiguous", **kw):
    """``n_steps`` of make_train_step over ``m`` from the JAX package's
    parameters (this rank's expert slices with ``ep``): the losses and
    the params, expert stacks gathered back whole."""
    from lua_mapreduce_tpu_torch.convert import params_to_numpy
    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.train import optim
    p = _lm_params(np_params, **({"mesh": m} if ep else {}))
    step = tt.make_train_step(cfg, optim.sgd(p.values(), lr), mesh=m, **kw)
    td = tt.shard_batch(m, tok, tgt, schedule=schedule)
    losses = [float(step(p, *td)) for _ in range(n_steps)]
    return losses, params_to_numpy(p, **({"mesh": m} if ep else {}))


def _lm_cases(m, d):
    """make_sharded_apply, make_train_step (ring, zigzag, pre-permuted
    zigzag, Ulysses, grad_accum + remat, window, MoE over dp, ZeRO-1
    with f32 masters), prefill and greedy decode over the (dp, sp)
    mesh ``m``."""
    import dataclasses

    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.parallel import zero1 as z1
    from lua_mapreduce_tpu_torch.train import optim
    from lua_mapreduce_tpu_torch.train.precision import with_f32_master
    out = {}
    cfgs = {k: tt.TransformerConfig(**v) for k, v in d["cfgs"].items()}
    cfg, params = cfgs["tiny"], d["params"]["tiny"]
    tok, tgt = d["tok"], d["tgt"]
    # the sharded forward, dense (MHA and GQA) and MoE
    for name in ("tiny", "gqa", "modern"):
        p = _lm_params(d["params"][name])
        for attn in ("ring", "zigzag", "ulysses"):
            out[f"apply_{name}_{attn}"] = _np(tt.make_sharded_apply(
                cfgs[name], m, attn=attn)(p, d["apply_tok"]))
    pm = _lm_params(d["params"]["moe"], mesh=m)
    out["apply_moe"] = _np(tt.make_sharded_apply(cfgs["moe"], m)(
        pm, d["apply_tok_moe"]))
    # the train step under every schedule, 2 steps of SGD(0.1)
    for attn, kw in (("ring", {}), ("zigzag", {}), ("ulysses", {}),
                     ("zigzag_pre", {"zigzag_layout": True,
                                     "schedule": "zigzag"})):
        out[f"step_{attn}"] = _lm_steps(cfg, m, params, tok, tgt, 2,
                                        attn=attn.split("_")[0], **kw)
    # grad_accum with remat against the whole tile; remat alone
    rcfg = dataclasses.replace(cfg, remat=True)
    for accum in (1, 2):
        out[f"accum{accum}"] = _lm_steps(rcfg, m, params, tok, tgt, 1,
                                         grad_accum=accum)
    out["remat_plain"] = _lm_steps(cfg, m, params, tok, tgt, 1)
    # the banded ring in the step: first loss is the windowed oracle's
    out["window"] = _lm_steps(cfgs["window"], m, d["params"]["window"],
                              tok, tgt, 1)
    # MoE, experts over dp
    out["moe"] = _lm_steps(cfgs["moe"], m, d["params"]["moe"], tok, tgt, 2,
                           ep=True)
    # every param moves under Ulysses
    _, moved = _lm_steps(cfg, m, params, d["tok3"], d["tgt3"], 1,
                         attn="ulysses")
    out["moved"] = moved
    # ZeRO-1: f32 SGD with momentum, and bf16 params with f32 masters
    # (Adam), against the replicated step
    for tag, dtype, mk in (
            ("f32", torch.float32,
             lambda ps: optim.sgd(ps, 0.1, momentum=0.9)),
            ("bf16", torch.bfloat16,
             lambda ps: with_f32_master(ps, lambda ms: optim.adam(ms, 3e-3)))):
        zc = cfgs["zero1"]
        for z in (False, True):
            p = {k: v.detach().to(dtype).requires_grad_(True) for k, v in
                 _lm_params(d["params"]["zero1"]).items()}
            opt = z1.init_state(mk, p, m) if z else mk(p.values())
            step = tt.make_train_step(zc, opt, mesh=m, attn="ring", zero1=z)
            td = tt.shard_batch(m, d["tok_z"], d["tgt_z"])
            losses = [float(step(p, *td)) for _ in range(4)]
            r = {"losses": losses,
                 "params": {k: _np(v.float()) for k, v in p.items()}}
            if z and tag == "bf16":
                masters = opt[1].masters
                r["masters"] = [(str(mm.dtype), mm.numel()) for mm in masters]
            out[f"zero1_{tag}_{int(z)}"] = r
    # prefill over the mesh, and greedy decode through it
    pd = {k: v.detach() for k, v in _lm_params(params).items()}
    for attn in ("ring", "zigzag"):
        c, lg = tt.prefill(pd, d["prompt"], cfg=cfg, total=20, mesh=m,
                           attn=attn)
        out[f"prefill_{attn}"] = ({k: _np(v) for k, v in c.items()}, _np(lg))
    out["decode_mesh"] = _np(tt.greedy_decode(pd, d["prompt"], 4, cfg=cfg,
                                              use_prefill=True, mesh=m))
    pw = {k: v.detach() for k, v in _lm_params(d["params"]["window"]).items()}
    out["decode_window_mesh"] = _np(tt.greedy_decode(
        pw, d["prompt"], 5, cfg=cfgs["window"], use_prefill=True, mesh=m))
    errs = {}
    opt = optim.sgd(list(pd.values()), 0.1)
    for name, call in (
            ("attn", lambda: tt.make_train_step(cfg, opt, mesh=m,
                                                attn="rign")),
            ("apply_attn", lambda: tt.make_sharded_apply(cfg, m,
                                                         attn="flash")),
            ("layout", lambda: tt.make_train_step(cfg, opt, mesh=m,
                                                  zigzag_layout=True)),
            ("window", lambda: tt.make_train_step(cfgs["window"], opt,
                                                  mesh=m, attn="zigzag")),
            ("heads", lambda: tt.make_sharded_apply(
                dataclasses.replace(cfg, n_heads=1),
                m, attn="ulysses")),
            ("experts", lambda: tt.make_train_step(
                dataclasses.replace(cfgs["moe"], moe_experts=3), opt,
                mesh=m)),
            ("zero1_moe", lambda: tt.make_train_step(cfgs["moe"], opt,
                                                     mesh=m, zero1=True)),
            ("accum_moe", lambda: tt.make_train_step(cfgs["moe"], opt,
                                                     mesh=m, grad_accum=2)),
            ("moe_prefill", lambda: tt.prefill(
                pm, d["prompt"], cfg=cfgs["moe"], mesh=m)),
            ("max_seq", lambda: tt.make_sharded_apply(cfg, m)(
                pd, np.zeros((2, cfg.max_seq + 8), np.int32)))):
        try:
            call()
            errs[name] = None
        except ValueError as e:
            errs[name] = str(e)
    out["errors"] = errs
    return out


def sharded_lm_cases(mesh, d):
    """Every case of tests/test_torch_sharded_lm.py on this rank: the
    attention bodies over an sp mesh of the whole world, and with four
    ranks the LM over a dp 2 × sp 2 mesh."""
    n = mesh.shape["dp"]
    out = {"attn": _attention_cases(
        make_mesh(dp=1, mp=n, device="cpu", axis_names=("dp", "sp")), d)}
    if n == 4:
        out["lm"] = _lm_cases(
            make_mesh(dp=2, mp=2, device="cpu", axis_names=("dp", "sp")), d)
    return out


def train_lm_cases(mesh, d):
    """``train_lm.run`` in this world, from the carried JAX
    parameters, once per argv of ``d["runs"]``: each run's summary."""
    from lua_mapreduce_tpu_torch.convert import params_from_jax
    from lua_mapreduce_tpu_torch.examples.lm import train_lm

    def init_from_jax(seed, cfg, dtype=torch.float32, device=None):
        return params_from_jax(d["params"], device=device)
    train_lm.tt.init_transformer = init_from_jax
    return [train_lm.run(train_lm.build_parser().parse_args(argv))
            for argv in d["runs"]]


# --------------------------------------- tensor / pipeline parallel LM

def _tp_steps(cfg, m, np3, tok, tgt, n_steps, make_opt=None, **kw):
    """``n_steps`` of make_train_step_3d over ``m`` from the JAX
    package's 3-D dict (this rank's mp slices): the losses, and the
    canonical params and the last step's gradients, gathered back
    whole."""
    from lua_mapreduce_tpu_torch.convert import params_from_jax
    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.train import optim
    p = {k: v.requires_grad_(True) for k, v in params_from_jax(
        np3, mesh=m, mp_axis="mp").items()}
    make_opt = make_opt or (lambda ps: optim.sgd(ps, 0.1))
    step = tt.make_train_step_3d(cfg, m, make_opt(p.values()), **kw)
    td = tt.shard_batch(m, tok, tgt, schedule="zigzag" if kw.get(
        "zigzag_layout") else "contiguous")
    losses = [float(step(p, *td)) for _ in range(n_steps)]
    return losses, {k: _np(v) for k, v in
                    tt.unshard_params_3d(p, cfg, m).items()}, {
        k: _np(v) for k, v in tt.unshard_params_3d(
            {k: v.grad for k, v in p.items()}, cfg, m).items()}


def _pp_steps(cfg, m, np_pp, tok, tgt, n_steps, n_micro, make_opt=None):
    """``n_steps`` of make_train_step_pp over ``m`` from the JAX
    package's pipeline stack (this stage's layers): the losses and the
    canonical params, gathered back whole."""
    from lua_mapreduce_tpu_torch.convert import params_from_jax
    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.train import optim
    p = {k: v.requires_grad_(True) for k, v in params_from_jax(
        np_pp, mesh=m, pp_axis="pp").items()}
    make_opt = make_opt or (lambda ps: optim.sgd(ps, 0.1))
    step = tt.make_train_step_pp(cfg, m, make_opt(p.values()),
                                 n_micro=n_micro)
    losses = [float(step(p, tok, tgt)) for _ in range(n_steps)]
    return losses, {k: _np(v) for k, v in
                    tt.unstack_params_pp(p, cfg, m).items()}


def _errors(calls):
    """Each call's ValueError message (None when it returns)."""
    errs = {}
    for name, call in calls:
        try:
            call()
            errs[name] = None
        except ValueError as e:
            errs[name] = str(e)
    return errs


def multihost_cases(mesh, d):
    """The multihost helpers of tests/test_torch_multihost.py in this
    world of 8 ranks: one host (no LOCAL_WORLD_SIZE), then hosts of 2
    ranks — the hybrid (dp 4, mp 2) mesh of tests/test_multihost.py's
    four processes."""
    import torch.distributed as dist

    from lua_mapreduce_tpu_torch.models.mlp import nll_loss
    from lua_mapreduce_tpu_torch.parallel import multihost as mh
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)
    out = {}
    os.environ.pop("LOCAL_WORLD_SIZE", None)
    m = mh.make_multihost_mesh((4, 2), ("dp", "mp"), device="cpu")
    out["single_shape"] = dict(m.shape)
    out["single_mesh"] = m.device_mesh.mesh.tolist()
    out["single_batch"] = mh.process_local_batch(32)
    out["errors"] = _errors([("count", lambda: mh.make_multihost_mesh(
        (8, 2), ("dp", "mp"), device="cpu"))])
    m8 = mh.make_multihost_mesh((8,), ("dp",), device="cpu")
    tile = mh.global_batch_array(m8, ("dp",), d["x8"])
    out["tile"] = _np(tile)
    out["tile_gathered"] = _np(C.all_gather(tile, m8, "dp"))
    out["tile_sum"] = float(C.psum(tile.sum(), m8, "dp"))
    tr = DataParallelTrainer(nll_loss, d["mlp"], TrainConfig(batch_size=16),
                             mesh=mh.make_multihost_mesh(
                                 (8, 1), ("dp", "mp"), device="cpu"))
    out["dp_losses"] = _np(tr.run_steps(d["mlp_x"], d["mlp_y"], 3))

    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        m = mh.make_multihost_mesh((4, 2), ("dp", "mp"), device="cpu")
        out["hybrid_mesh"] = m.device_mesh.mesh.tolist()
        out["hybrid_index"] = (m.axis_index("dp"), m.axis_index("mp"))
        per, off = mh.process_local_batch(8)
        out["hybrid_batch"] = (per, off)
        gx = d["gx"]
        x = mh.global_batch_array(m, ("dp", "mp"), gx[off:off + per])
        out["hybrid_tile"] = _np(x)
        rows = torch.arange(2 * m.axis_index("dp"),
                            2 * m.axis_index("dp") + 2)[:, None].float()

        def poswsum(a):
            return float(C.psum(C.psum((a * rows).sum(), m, "mp"), m, "dp"))
        out["poswsum"] = poswsum(x)
        # a dp ring: every hop crosses a host
        out["poswsum_rolled"] = poswsum(C.ppermute_ring(x, m, "dp", 1))
        # the two-level reduction: mp inside a host, dp across hosts
        w = torch.from_numpy(d["w"])
        ws = w.narrow(0, 8 * m.axis_index("mp"), 8)
        y = C.psum(x @ ws, m, "mp")
        out["two_level"] = float(C.psum((y * y).sum() / 8.0, m, "dp"))
        out["hybrid_errors"] = _errors([
            ("dcn", lambda: mh.make_multihost_mesh((4, 2), ("dp", "mp"),
                                                   dcn_axis=1, device="cpu")),
            ("rows", lambda: mh.global_batch_array(m, ("mp", "dp"),
                                                   gx[off:off + per]))])
        out["world"] = dist.get_world_size()
    finally:
        os.environ.pop("LOCAL_WORLD_SIZE", None)
    return out


def tp_pp_cases(mesh, d):
    """Every case of tests/test_torch_tp_pp.py for a world of this
    size: 8 ranks — the 3-D step over (dp, sp, mp) = (2, 2, 2); 4
    ranks — the pipeline over pp = 4 and the 3-D step over (1, 2, 2);
    2 ranks — the pipeline over pp = 2."""
    import dataclasses

    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.parallel.multihost import make_multihost_mesh
    from lua_mapreduce_tpu_torch.train import optim
    n = mesh.shape["dp"]
    cfgs = {k: tt.TransformerConfig(**v) for k, v in d["cfgs"].items()}
    P = d["params"]
    out = {}

    def adam(ps):
        return optim.adam(ps, 3e-3)

    def sgd(ps):
        return optim.sgd(ps, 0.1)

    if n == 8:
        m = make_multihost_mesh((2, 2, 2), ("dp", "sp", "mp"), device="cpu")
        cfg = cfgs["tiny"]
        tok, tgt = d["tok"], d["tgt"]
        out["index"] = tuple(m.axis_index(a) for a in ("dp", "sp", "mp"))
        for attn in ("ring", "zigzag"):
            out[f"3d_{attn}"] = _tp_steps(cfg, m, P["tiny7_3d"], tok, tgt, 1,
                                          attn=attn)
        out["3d_zigzag_pre"] = _tp_steps(cfg, m, P["tiny7_3d"], tok, tgt, 1,
                                         attn="zigzag", zigzag_layout=True)
        for accum in (1, 2):
            out[f"3d_accum{accum}"] = _tp_steps(
                cfg, m, P["tiny12_3d"], d["tok_a"], d["tgt_a"], 1,
                grad_accum=accum)
        out["3d_modern"] = _tp_steps(cfgs["modern"], m, P["modern10_3d"],
                                     d["tok_m"], d["tgt_m"], 1)
        out["3d_learns"] = _tp_steps(cfg, m, P["tiny2_3d"], d["tok_l"],
                                     d["tgt_l"], 50, make_opt=adam)[0]
        # the 2-D entry points on the 3-D mesh: mp replicates them
        p2 = {k: v.requires_grad_(True) for k, v in
              _lm_params(P["tiny7"]).items()}
        step2 = tt.make_train_step(cfg, sgd(p2.values()), mesh=m)
        out["2d_on_3d"] = ([float(step2(p2, *tt.shard_batch(m, tok, tgt)))],
                           {k: _np(v) for k, v in p2.items()})
        out["apply_on_3d"] = _np(tt.make_sharded_apply(cfg, m)(
            {k: v.detach() for k, v in _lm_params(P["tiny7"]).items()}, tok))
        pq = {k: v.requires_grad_(True) for k, v in
              _lm_params(P["tiny7"]).items()}
        gqa = dataclasses.replace(cfgs["modern"], n_kv_heads=2)
        out["errors"] = _errors([
            ("heads", lambda: tt.make_train_step_3d(
                tt.TransformerConfig(vocab=32, d_model=32, n_heads=3,
                                     n_layers=1, d_ff=32, max_seq=64), m,
                sgd(pq.values()))),
            ("moe", lambda: tt.make_train_step_3d(cfgs["moe"], m,
                                                  sgd(pq.values()))),
            ("gqa", lambda: tt.make_train_step_3d(gqa, m, sgd(pq.values()))),
            ("gqa_shard", lambda: tt.shard_params_3d(
                _lm_params(P["modern10"]), m, gqa)),
            ("layout", lambda: tt.make_train_step_3d(cfg, m, sgd(pq.values()),
                                                     zigzag_layout=True)),
            ("ulysses", lambda: tt.make_train_step_3d(
                dataclasses.replace(cfg, n_heads=2), m, sgd(pq.values()),
                attn="ulysses"))])
    elif n == 4:
        pcfg = cfgs["pp"]
        mp = make_multihost_mesh((4,), ("pp",), device="cpu")
        out["pp4"] = _pp_steps(pcfg, mp, P["pp3_stack"], d["tok_p"],
                               d["tgt_p"], 1, n_micro=4)
        out["pp4_learns"] = _pp_steps(pcfg, mp, P["pp4_stack"], d["tok_pl"],
                                      d["tgt_pl"], 50, n_micro=4,
                                      make_opt=adam)[0]
        pq = {k: v.requires_grad_(True) for k, v in
              _lm_params(P["pp3_stack"]).items()}
        out["pp_errors"] = _errors([
            ("layers", lambda: tt.make_train_step_pp(
                dataclasses.replace(pcfg, n_layers=3), mp, sgd(pq.values()),
                n_micro=2)),
            ("moe", lambda: tt.make_train_step_pp(
                dataclasses.replace(cfgs["moe"], n_layers=4), mp,
                sgd(pq.values()), n_micro=2)),
            ("batch", lambda: tt.make_train_step_pp(
                pcfg, mp, sgd(pq.values()), n_micro=3)(
                    pq, d["tok_p"], d["tgt_p"]))])
        m = make_multihost_mesh((1, 2, 2), ("dp", "sp", "mp"), device="cpu")
        for attn in ("ring", "ulysses"):
            out[f"3d122_{attn}"] = _tp_steps(
                cfgs["modern"], m, P["modern10_3d"], d["tok_m"], d["tgt_m"],
                1, attn=attn)
    elif n == 2:
        mp = make_multihost_mesh((2,), ("pp",), device="cpu")
        for name, seed, tag in (("modern", 11, "tok_pm"),
                                ("window", 6, "tok_w")):
            key = f"{name}{seed}_pp"
            out[f"pp2_{name}"] = _pp_steps(
                cfgs[f"{name}_pp"], mp, P[key], d[tag],
                d[tag.replace("tok", "tgt")], 1, n_micro=2,
                make_opt=lambda ps: optim.sgd(ps, 0.05))
    return out
