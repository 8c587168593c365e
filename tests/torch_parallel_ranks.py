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
