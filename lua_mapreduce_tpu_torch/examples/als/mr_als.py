"""Iterative ALS matrix factorization as the six MapReduce functions,
with item factors persisted in a :class:`PersistentTable` across
iterations (BASELINE.json config 5: "ALS matrix-factorization
(persistent_table.lua state across MapReduce iters)").

Port of the JAX package's ``examples/als/mr_als.py``:

    init        — build the ratings matrix on the device; seed item
                  factors V into the persistent table
    taskfn      — read V from the table into the device tensor the map
                  jobs read; emit n_shards user-shard jobs
    mapfn       — pure tensor program: solve this shard's user factors
                  (batched ridge regression) against V; emit each item's
                  partial normal equations (A_i, b_i) and the shard's SSE
                  under the sentinel key n_items
    partitionfn — item id % NUM_REDUCERS (numeric keys)
    reducefn    — matrix/vector partial sums (assoc+commut flags)
    finalfn     — solve every item's (A_i + λI) v_i = b_i, commit V,
                  loop for a fixed number of rounds

**State on the device**, as in ``examples/kmeans/mr_kmeans.py``: at
MovieLens' shapes V is far over the 16 KB job-value cap, so it lives in
one device tensor that taskfn refreshes in place from the table each
round; a job value carries only the round it belongs to.

**In-graph eligible.** mapfn/reducefn are torch-only tensor programs,
partitionfn is integer math: the port's oracle verdicts them
``in-graph``. The products go through the port's matmul kernel
(``ops.matmul``); the JAX example's batched ``jnp.linalg.solve`` is a
Cholesky factorization and two triangular solves here
(``torch.linalg.solve`` checks for singular systems on the host, which
a captured program cannot do). The same module runs unchanged on the
store plane (``engine="store"``), its golden twin.

State-store scope: ``coord="mem"`` (the default) is ONLY valid on the
in-process LocalExecutor; other processes must share a directory
(``coord=<dir>``, a FileJobStore).
"""

import numpy as np
import torch

from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.coord.persistent_table import PersistentTable
from lua_mapreduce_tpu_torch.device import resolve_device

NUM_REDUCERS = 8
TABLE = "als_state"

_cfg = {}
_r = None           # ratings, on the device
_w = None           # the observation mask, on the device
_v = None           # the item factors the map jobs read, on the device
_pt_store = None


def _table(read_only=False) -> PersistentTable:
    return PersistentTable(TABLE, _pt_store, read_only=read_only)


def init(args):
    global _cfg, _r, _w, _v, _pt_store
    from lua_mapreduce_tpu_torch.train.data import make_ratings
    _cfg = {
        "n_users": int(args.get("n_users", 256)),
        "n_items": int(args.get("n_items", 64)),
        "rank": int(args.get("rank", 4)),
        "density": float(args.get("density", 0.3)),
        "reg": float(args.get("reg", 0.1)),
        "n_shards": int(args.get("n_shards", 4)),
        "max_iters": int(args.get("max_iters", 10)),
        "seed": int(args.get("seed", 0)),
        "coord": args.get("coord", "mem"),
        "device": resolve_device(args.get("device")),
    }
    r, w = make_ratings(seed=_cfg["seed"], n_users=_cfg["n_users"],
                        n_items=_cfg["n_items"], rank=_cfg["rank"],
                        density=_cfg["density"])
    dev = _cfg["device"]
    _r, _w = torch.from_numpy(r).to(dev), torch.from_numpy(w).to(dev)
    _v = torch.empty((_cfg["n_items"], _cfg["rank"]), device=dev)
    _pt_store = MemJobStore() if _cfg["coord"] == "mem" \
        else FileJobStore(_cfg["coord"])
    pt = _table()
    if "item_factors" not in pt:
        rng = np.random.RandomState(_cfg["seed"])
        v0 = 0.1 * rng.randn(_cfg["n_items"], _cfg["rank"])
        pt.set({"item_factors": v0.tolist(), "iter": 0, "finished": False,
                "rmse": None})
        pt.update()


def taskfn(emit):
    pt = _table(read_only=True)
    _v.copy_(torch.as_tensor(pt["item_factors"], dtype=torch.float32))
    for i in range(_cfg["n_shards"]):
        emit(i, {"iter": pt["iter"]})


def _shard_rows(shard):
    return (_r[int(shard)::_cfg["n_shards"]],
            _w[int(shard)::_cfg["n_shards"]])


def _outer_rows(v):
    """(n, k) → (n, k²): each row's outer product v vᵀ, flattened."""
    return torch.reshape(v[:, :, None] * v[:, None, :], (v.shape[0], -1))


def _ridge_solve(a, b):
    """Solve a_u x_u = b_u for a batch of SPD (k, k) systems (Cholesky
    and two triangular solves: no host round trip)."""
    lower = torch.linalg.cholesky_ex(a).L
    y = torch.linalg.solve_triangular(lower, b[..., None], upper=False)
    return torch.linalg.solve_triangular(torch.transpose(lower, -1, -2), y,
                                         upper=True)[..., 0]


def mapfn(key, value, emit):
    v = _v                                               # (n_items, k)
    r, w = _shard_rows(key)
    k = v.shape[1]
    eye = _cfg["reg"] * torch.eye(k, device=v.device)

    # user step: per-user ridge solve given V, batched over the shard:
    # A_u = Σ_i w_ui v_i v_iᵀ + λI, b_u = Σ_i w_ui r_ui v_i
    a = torch.reshape(ops.matmul(w, _outer_rows(v)), (-1, k, k)) + eye
    b = ops.matmul(w * r, v)
    u = _ridge_solve(a, b)                               # (n_u, k)

    # item-step partials: A_i = Σ_u w_ui u uᵀ, b_i = Σ_u w_ui r_ui u
    a_items = torch.reshape(
        ops.matmul(torch.transpose(w, 0, 1), _outer_rows(u)), (-1, k, k))
    b_items = ops.matmul(torch.transpose(w * r, 0, 1), u)
    for item in range(v.shape[0]):
        emit(item, {"a": a_items[item], "b": b_items[item]})

    # shard SSE under the sentinel key n_items (numeric key space)
    err = w * (ops.matmul(u, torch.transpose(v, 0, 1)) - r)
    emit(v.shape[0], {"a": torch.sum(err * err), "b": torch.sum(w)})


def partitionfn(key):
    return int(key) % NUM_REDUCERS


def reducefn(key, values):
    a = torch.as_tensor(values[0]["a"])
    b = torch.as_tensor(values[0]["b"])
    for i in range(1, len(values)):
        a = a + torch.as_tensor(values[i]["a"])
        b = b + torch.as_tensor(values[i]["b"])
    return {"a": a, "b": b}


reducefn.associative_reducer = True
reducefn.commutative_reducer = True


def finalfn(pairs):
    pt = _table()
    v = np.asarray(pt["item_factors"], np.float32)
    n_items, k = v.shape
    eye = _cfg["reg"] * np.eye(k)
    sq = cnt = 0.0
    for key, vs in pairs:
        val = vs[0]
        if int(key) == n_items:
            sq, cnt = float(np.asarray(val["a"])), float(np.asarray(val["b"]))
        else:
            a = np.asarray(val["a"], np.float64)
            b = np.asarray(val["b"], np.float64)
            v[int(key)] = np.linalg.solve(a + eye, b)
    # SSE is measured against the PRE-update V (the mapfn's read), i.e.
    # the RMSE of round i's user step — one round behind models/als.py's
    # history, which scores the updated V
    rmse = float(np.sqrt(sq / max(cnt, 1.0)))
    it = pt["iter"] + 1
    finished = it >= _cfg["max_iters"]
    pt.set({"item_factors": v.tolist(), "iter": it, "finished": finished,
            "rmse": rmse})
    pt.update()
    return False if finished else "loop"


def read_state(coord="mem", pt_store=None):
    store = pt_store or (_pt_store if coord == "mem"
                         else FileJobStore(coord))
    return PersistentTable(TABLE, store, read_only=True).as_dict()
