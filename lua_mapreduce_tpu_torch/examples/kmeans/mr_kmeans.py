"""Iterative k-means as the six MapReduce functions, with cross-iteration
state in a :class:`PersistentTable` (BASELINE.json config 5: "iterative
k-means … persistent_table.lua state across MapReduce iters").

Port of the JAX package's ``examples/kmeans/mr_kmeans.py``:

    init        — build the data on the device; seed centroids into the
                  persistent table (the conf-table role, common.lua:57-77)
    taskfn      — read the centroids from the table into the device
                  tensor the map jobs read; emit n_shards jobs
    mapfn       — pure tensor program: assign this shard's points to the
                  centroids; emit per-cluster partial (sum, count) + the
                  SSE under the sentinel key k
    partitionfn — cluster id % NUM_REDUCERS (numeric keys)
    reducefn    — elementwise partial sums (assoc+commut+idempotent flags
                  → combiner + merge fast path, SURVEY.md §2.5)
    finalfn     — recompute centroids, commit to the table, loop until
                  the max centroid shift < tol (the "loop" protocol,
                  server.lua:387-403)

**State on the device.** The JAX example threads the centroids through
the job values. At SIFT1M's shape (k = 1024 × 128) they are ~1.5 MB of
JSON, far over the 16 KB job-value cap (MAX_TASKFN_VALUE_SIZE), so here
they live in one device tensor that taskfn refreshes in place from the
table each iteration; a job value carries only the iteration it belongs
to. A captured program reads that tensor by address, so it is updated in
place, never rebound.

**In-graph eligible.** mapfn/reducefn are torch-only tensor programs
(products through the port's matmul kernel, ``ops.matmul``), partitionfn
is integer math — the port's oracle verdicts them ``in-graph``, as the
JAX oracle does the JAX example's, so under ``engine="auto"`` the whole
map→shuffle→reduce runs as one captured program (engine/ingraph.py),
re-run each "loop" iteration without a rebuild. Every shard emits every
cluster key exactly once (empty clusters as zero partials): uniform
emission is what the collective tier needs. The same module runs
unchanged on the store plane (``engine="store"``), its golden twin.

State-store scope: ``coord="mem"`` (the default) backs the persistent
table with an in-process store and is ONLY valid on the in-process
LocalExecutor; other processes must share a directory (``coord=<dir>``,
a FileJobStore).
"""

import numpy as np
import torch

from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.coord.persistent_table import PersistentTable
from lua_mapreduce_tpu_torch.device import resolve_device

NUM_REDUCERS = 8
TABLE = "kmeans_state"

_cfg = {}
_x = None           # the points, on the device
_c = None           # the centroids the map jobs read, on the device
_pt_store = None


def _table(read_only=False) -> PersistentTable:
    return PersistentTable(TABLE, _pt_store, read_only=read_only)


def init(args):
    global _cfg, _x, _c, _pt_store
    from lua_mapreduce_tpu_torch.train.data import make_blobs
    _cfg = {
        "k": int(args.get("k", 8)),
        "n": int(args.get("n", 2048)),
        "dim": int(args.get("dim", 16)),
        "n_shards": int(args.get("n_shards", 4)),
        "max_iters": int(args.get("max_iters", 20)),
        "tol": float(args.get("tol", 1e-4)),
        "seed": int(args.get("seed", 0)),
        "coord": args.get("coord", "mem"),
        "device": resolve_device(args.get("device")),
    }
    x, _, _ = make_blobs(seed=_cfg["seed"], n=_cfg["n"], k=_cfg["k"],
                         dim=_cfg["dim"])
    _x = torch.from_numpy(x).to(_cfg["device"])
    _c = torch.empty((_cfg["k"], _cfg["dim"]), device=_cfg["device"])
    _pt_store = MemJobStore() if _cfg["coord"] == "mem" \
        else FileJobStore(_cfg["coord"])
    pt = _table()
    if "centroids" not in pt:
        # deterministic seed: the first k points (matches the native
        # parity test, which starts kmeans_fit from the same rows)
        pt.set({"centroids": x[:_cfg["k"]].tolist(), "iter": 0,
                "finished": False, "sse": None})
        pt.update()


def taskfn(emit):
    pt = _table(read_only=True)
    _c.copy_(torch.as_tensor(pt["centroids"], dtype=torch.float32))
    for i in range(_cfg["n_shards"]):
        emit(i, {"iter": pt["iter"]})


def _shard_points(shard):
    return _x[int(shard)::_cfg["n_shards"]]


def _assign(x, c):
    """Squared distances of the points ``x`` to the centroids ``c`` and
    each point's nearest centroid."""
    d2 = (torch.sum(x * x, dim=1)[:, None]
          - 2.0 * ops.matmul(x, torch.transpose(c, 0, 1))
          + torch.sum(c * c, dim=1)[None, :])
    return d2, torch.argmin(d2, dim=1)


def mapfn(key, value, emit):
    c = _c
    x = _shard_points(key)
    d2, nearest = _assign(x, c)
    sel = nearest[:, None] == torch.arange(c.shape[0], device=x.device)[None]
    # per-cluster sums as one product with the one-hot assignment (the
    # JAX example's masked sum per cluster, in one kernel launch)
    sums = ops.matmul(torch.transpose(torch.where(sel, 1.0, 0.0), 0, 1), x)
    counts = torch.sum(sel, dim=0)
    # every cluster key is emitted by every shard (zero partials for
    # empty assignments): uniform emission structure is the collective
    # tier's contract, and finalfn's count>0 guard keeps the
    # empty-partition tolerance (SURVEY.md §6)
    for j in range(c.shape[0]):
        emit(j, {"sum": sums[j], "count": counts[j]})
    # the SSE rides under the sentinel key k (one past the last cluster
    # id) — numeric keys keep partitionfn pure integer math
    emit(c.shape[0], {"sum": torch.sum(torch.min(d2, dim=1).values),
                      "count": x.shape[0]})


def partitionfn(key):
    return int(key) % NUM_REDUCERS


def reducefn(key, values):
    s = torch.as_tensor(values[0]["sum"])
    c = torch.as_tensor(values[0]["count"])
    for i in range(1, len(values)):
        s = s + torch.as_tensor(values[i]["sum"])
        c = c + torch.as_tensor(values[i]["count"])
    return {"sum": s, "count": c}


reducefn.associative_reducer = True
reducefn.commutative_reducer = True
reducefn.idempotent_reducer = True


def finalfn(pairs):
    pt = _table()
    old = np.asarray(pt["centroids"], np.float32)
    new = old.copy()
    k = old.shape[0]
    sse = None
    for key, vs in pairs:
        v = vs[0]
        if int(key) == k:
            sse = float(np.asarray(v["sum"]))
        elif v["count"] > 0:
            # empty clusters (count 0 partials) keep their old centroid
            new[int(key)] = np.asarray(v["sum"], np.float64) / v["count"]
    shift = float(np.abs(new - old).max())
    it = pt["iter"] + 1
    finished = shift < _cfg["tol"] or it >= _cfg["max_iters"]
    pt.set({"centroids": new.tolist(), "iter": it, "finished": finished,
            "sse": sse, "shift": shift})
    pt.update()
    return False if finished else "loop"


def read_state(coord="mem", pt_store=None):
    """Final state for callers/tests (pass the FileJobStore path used as
    ``coord``, or reuse the in-process store when coord was "mem")."""
    store = pt_store or (_pt_store if coord == "mem"
                         else FileJobStore(coord))
    return PersistentTable(TABLE, store, read_only=True).as_dict()
