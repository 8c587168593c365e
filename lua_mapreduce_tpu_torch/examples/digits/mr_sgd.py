"""Digits-MLP data-parallel SGD packaged as the six MapReduce functions
— the in-graph-eligible variant of ``examples/digits/mr_train.py``.

Port of the JAX package's ``examples/digits/mr_sgd.py``. Where
mr_train.py keeps the model in a checkpoint file that every mapfn
re-reads (host IO → store-plane verdict), this packaging keeps the
parameters on the device, where the map jobs read them: taskfn threads
each shard's deterministic minibatch indices through the job values,
mapfn is a pure tensor program — manual forward + backward for the
2-layer tanh MLP, no autograd (a transformed-function call is outside
the static oracle's surface; the hand-written VJP is the same math) —
and reducefn is the elementwise gradient sum. Under ``engine="auto"``
the whole per-step map→shuffle→reduce runs as one captured program
(engine/ingraph.py), re-run each "loop" iteration without a rebuild;
``engine="store"`` runs the identical module interpreted — its golden
twin.

The products go through the port's matmul kernel (``ops.matmul``, five
a job) and the log-softmax (the JAX example's ``z - lse``) through its
row-softmax kernel (``ops.log_softmax``).

Numeric key space: grad keys 0..3 = (w1, b1, w2, b2), key 4 = the
training-loss accumulator; partitionfn is integer math.

State: the optimizer lives in module-level host state (numpy, updated
by finalfn with the JAX example's arithmetic), mirrored into device
tensors that finalfn updates in place — a captured program reads them
by address. The JAX example threads the parameters through the job
values instead; at the flagship width (256-128-10, 34,186 floats) they
are far over the 16 KB job-value cap. The example is LocalExecutor /
single-process: a multi-process store-plane fleet would re-init per
worker and never see finalfn's updates.
"""

import numpy as np
import torch

from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.device import resolve_device

NUM_REDUCERS = 5
W1, B1, W2, B2, LOSS = 0, 1, 2, 3, 4     # the numeric grad key space

_cfg = {}
_data = None        # (x_train, y_train, x_val, y_val) on the host
_dx = None          # x_train, on the device
_dy = None          # y_train, on the device
_dev = {}           # the parameters the map jobs read, on the device
_state = {}


def init(args):
    global _cfg, _data, _dx, _dy, _dev, _state
    from lua_mapreduce_tpu_torch.train.data import make_digits
    _cfg = {
        "dim": int(args.get("dim", 16)),
        "hidden": int(args.get("hidden", 8)),
        "classes": 10,
        "n_shards": int(args.get("n_shards", 4)),
        "bunch": int(args.get("bunch", 128)),      # init.lua:127-141
        "lr": float(args.get("lr", 0.05)),
        "momentum": float(args.get("momentum", 0.9)),
        "max_steps": int(args.get("max_steps", 20)),
        "seed": int(args.get("seed", 0)),
        "device": resolve_device(args.get("device")),
    }
    _data = make_digits(seed=_cfg["seed"], dim=_cfg["dim"])
    dev = _cfg["device"]
    _dx = torch.from_numpy(_data[0]).to(dev)
    _dy = torch.from_numpy(_data[1]).to(dev)
    rng = np.random.RandomState(_cfg["seed"])
    scale = 1.0 / np.sqrt(_cfg["dim"])
    # init RESETS the run: every TaskSpec construction starts the same
    # deterministic trajectory, which is what lets two executor legs
    # golden-diff
    _state = {
        "params": {
            "w1": (scale * rng.randn(_cfg["dim"], _cfg["hidden"])
                   ).astype(np.float32),
            "b1": np.zeros(_cfg["hidden"], np.float32),
            "w2": (scale * rng.randn(_cfg["hidden"], _cfg["classes"])
                   ).astype(np.float32),
            "b2": np.zeros(_cfg["classes"], np.float32),
        },
        "vel": None,
        "step": 0,
        "finished": False,
        "tr_loss": None,
        "val_loss": None,
    }
    _state["vel"] = {k: np.zeros_like(v)
                     for k, v in _state["params"].items()}
    _dev = {k: torch.from_numpy(v).to(dev)
            for k, v in _state["params"].items()}


def taskfn(emit):
    # this step's deterministic minibatch indices ride every job value
    # (same shapes every step, so the compiled plane never rebuilds)
    x_train = _data[0]
    for i in range(_cfg["n_shards"]):
        rng = np.random.RandomState(
            1000 + 7919 * _state["step"] + i)      # mr_train's schedule
        idx = rng.randint(0, len(x_train), _cfg["bunch"])
        emit(i, {"idx": idx.tolist()})


def mapfn(key, value, emit):
    w1, b1, w2, b2 = _dev["w1"], _dev["b1"], _dev["w2"], _dev["b2"]
    idx = torch.as_tensor(value["idx"], device=_dx.device)
    x = torch.index_select(_dx, 0, idx)
    y = torch.index_select(_dy, 0, idx)

    # forward: 2-layer tanh MLP + softmax cross-entropy (mean over the
    # bunch) — then the hand-written backward pass
    h = torch.tanh(ops.matmul(x, w1) + b1)
    logp = ops.log_softmax(ops.matmul(h, w2) + b2)
    onehot = torch.where(
        y[:, None] == torch.arange(b2.shape[0], device=x.device)[None, :],
        1.0, 0.0)
    loss = -torch.mean(torch.sum(onehot * logp, dim=1))

    dlogits = (torch.exp(logp) - onehot) / x.shape[0]
    gw2 = ops.matmul(torch.transpose(h, 0, 1), dlogits)
    gb2 = torch.sum(dlogits, dim=0)
    dh = ops.matmul(dlogits, torch.transpose(w2, 0, 1))
    dpre = dh * (1.0 - h * h)
    gw1 = ops.matmul(torch.transpose(x, 0, 1), dpre)
    gb1 = torch.sum(dpre, dim=0)

    emit(0, {"g": gw1, "count": 1})
    emit(1, {"g": gb1, "count": 1})
    emit(2, {"g": gw2, "count": 1})
    emit(3, {"g": gb2, "count": 1})
    emit(4, {"g": loss, "count": 1})


def partitionfn(key):
    return int(key) % NUM_REDUCERS


def reducefn(key, values):
    g = torch.as_tensor(values[0]["g"])
    c = torch.as_tensor(values[0]["count"])
    for i in range(1, len(values)):
        g = g + torch.as_tensor(values[i]["g"])
        c = c + torch.as_tensor(values[i]["count"])
    return {"g": g, "count": c}


reducefn.associative_reducer = True
reducefn.commutative_reducer = True


def _val_loss(params):
    x, y = _data[2], _data[3]
    h = np.tanh(x @ params["w1"] + params["b1"])
    logits = h @ params["w2"] + params["b2"]
    z = logits - logits.max(axis=1, keepdims=True)
    lse = np.log(np.exp(z).sum(axis=1, keepdims=True))
    return float(-np.mean((z - lse)[np.arange(len(y)), y]))


def finalfn(pairs):
    names = {W1: "w1", B1: "b1", W2: "w2", B2: "b2"}
    params, vel = _state["params"], _state["vel"]
    tr_loss = None
    grads = {}
    for key, vs in pairs:
        v = vs[0]
        if int(key) == LOSS:
            tr_loss = float(np.asarray(v["g"])) / v["count"]
        else:
            grads[names[int(key)]] = (np.asarray(v["g"], np.float32)
                                      / v["count"])
    for name, p in params.items():
        step = (_cfg["momentum"] * vel[name]
                - _cfg["lr"] * grads[name]).astype(np.float32)
        vel[name] = step
        params[name] = p + step
        _dev[name].copy_(torch.from_numpy(params[name]))
    _state["step"] += 1
    _state["tr_loss"] = tr_loss
    _state["val_loss"] = _val_loss(params)
    _state["finished"] = _state["step"] >= _cfg["max_steps"]
    return False if _state["finished"] else "loop"


def read_state():
    """Final host state for tests/benches: params, step, losses."""
    return _state


def images_seen() -> int:
    """Training images consumed so far: shards x bunch per completed
    step."""
    return _state["step"] * _cfg["n_shards"] * _cfg["bunch"]
