"""Digits-MLP data-parallel SGD, packaged as the six MapReduce functions.

Port of ``examples/digits/mr_train.py`` (which mirrors
examples/APRIL-ANN/common.lua function by function) onto the port's
store, checkpoint format and model:

    init        — build/restore model, checkpoint to storage (57-77)
    taskfn      — emit n_shards map jobs over the same dataset
    mapfn       — load model, grad on a random bunch, emit
                  (param_name, {grad, count}) + ("TR_LOSS", …) (85-104)
    partitionfn — byte-sum hash of param name % 10 (106-109)
    reducefn    — elementwise grad sum + count/loss accumulation (112-137)
    finalfn     — 1/sqrt(count) smoothing (163-166), SGD+momentum+weight
                  decay step (175-185), validation loss + early stopping,
                  re-checkpoint, return "loop" or finish (144-202)

The model's forward and backward run on ``init_args["device"]``
(default ``"cuda"``; ``"cpu"`` must be asked for), through the port's
kernels on a card. The bunch indices come from the same
``np.random.RandomState`` seeds as the JAX example, and the checkpoint
format is shared, so a run started from the JAX example's initial
``model.ckpt`` (in a ``shared:`` store) follows the JAX run step for
step.
"""

import json

import numpy as np
import torch

from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.models.mlp import init_mlp, nll_loss
from lua_mapreduce_tpu_torch.store.router import get_storage_from
from lua_mapreduce_tpu_torch.train import checkpoint as ckpt
from lua_mapreduce_tpu_torch.train.data import make_digits

NUM_REDUCERS = 10       # common.lua:106-109
MODEL_FILE = "model.ckpt"
META_FILE = "model.meta"

_cfg = {}
_data = None


def init(args):
    global _cfg, _data
    _cfg = {
        "sizes": tuple(args.get("sizes", (256, 128, 10))),
        "model_store": args.get("model_store", "mem:digits-model"),
        "n_shards": int(args.get("n_shards", 4)),
        "bunch": int(args.get("bunch", 128)),
        "lr": float(args.get("lr", 0.05)),
        "momentum": float(args.get("momentum", 0.9)),
        "weight_decay": float(args.get("weight_decay", 1e-5)),
        "max_steps": int(args.get("max_steps", 40)),
        "patience": int(args.get("patience", 5)),
        "seed": int(args.get("seed", 0)),
        "image": args.get("image"),
        "device": resolve_device(args.get("device")),
    }
    if _cfg["image"]:
        from lua_mapreduce_tpu_torch.train.data import load_digits_image
        arrays = load_digits_image(_cfg["image"])
        if arrays[0].shape[1] != _cfg["sizes"][0]:
            raise ValueError(
                f"digits sheet patterns are {arrays[0].shape[1]}-dim but "
                f"the model expects {_cfg['sizes'][0]} inputs")
    else:
        arrays = make_digits(seed=_cfg["seed"], dim=_cfg["sizes"][0])
    # the dataset lives on the device once; map jobs index into it
    dev = _cfg["device"]
    _data = tuple(torch.from_numpy(a).to(dev) for a in arrays)
    store = get_storage_from(_cfg["model_store"])
    if not store.exists(MODEL_FILE):
        params = init_mlp(_cfg["seed"], _cfg["sizes"], device="cpu")
        _save_state(store, params,
                    {k: torch.zeros_like(v) for k, v in params.items()})
        _write_meta(store, {"step": 0, "best_val": None, "best_step": 0,
                            "finished": False})


# -- state helpers ----------------------------------------------------------

def _template():
    params = {}
    for i, (a, b) in enumerate(zip(_cfg["sizes"][:-1], _cfg["sizes"][1:])):
        params[f"W{i}"] = torch.zeros((a, b))
        params[f"b{i}"] = torch.zeros((b,))
    return {"params": params, "vel": dict(params)}


def _save_state(store, params, vel):
    ckpt.save_pytree(store, MODEL_FILE, {"params": params, "vel": vel})


def _load_state(store):
    """The stored params and velocity, on the configured device."""
    state = ckpt.load_pytree(store, MODEL_FILE, _template())
    dev = _cfg["device"]
    return {part: {k: v.to(dev) for k, v in leaves.items()}
            for part, leaves in state.items()}


def _write_meta(store, meta):
    b = store.builder()
    b.write(json.dumps(meta))
    b.build(META_FILE)


def read_meta(store_spec: str):
    store = get_storage_from(store_spec)
    return json.loads("".join(store.lines(META_FILE)))


# -- the six functions ------------------------------------------------------

def taskfn(emit):
    for i in range(_cfg["n_shards"]):
        emit(i, i)


def mapfn(key, shard, emit):
    store = get_storage_from(_cfg["model_store"])
    params = _load_state(store)["params"]
    meta = json.loads("".join(store.lines(META_FILE)))
    x_train, y_train, _, _ = _data
    rng = np.random.RandomState(1000 + 7919 * meta["step"] + int(shard))
    idx = torch.from_numpy(rng.randint(0, len(x_train), _cfg["bunch"]))
    idx = idx.to(x_train.device)
    names = sorted(params)
    for name in names:
        params[name].requires_grad_(True)
    loss = nll_loss(params, x_train[idx], y_train[idx])
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    for name, g in zip(names, grads):
        emit(name, {"grad": g.cpu().tolist(), "count": 1})
    emit("TR_LOSS", {"loss": float(loss.detach()), "count": 1})


def partitionfn(key):
    return sum(str(key).encode()) % NUM_REDUCERS


def reducefn(key, values):
    if key == "TR_LOSS":
        return {"loss": sum(v["loss"] for v in values),
                "count": sum(v["count"] for v in values)}
    acc = np.asarray(values[0]["grad"], dtype=np.float32)
    count = values[0]["count"]
    for v in values[1:]:
        acc = acc + np.asarray(v["grad"], dtype=np.float32)
        count += v["count"]
    return {"grad": acc.tolist(), "count": count}


def finalfn(pairs):
    store = get_storage_from(_cfg["model_store"])
    state = _load_state(store)
    meta = json.loads("".join(store.lines(META_FILE)))
    params, vel = state["params"], state["vel"]
    dev = _cfg["device"]

    grads = {}
    tr_loss = None
    for key, vs in pairs:
        v = vs[0]
        if key == "TR_LOSS":
            tr_loss = v["loss"] / v["count"]
        else:
            grads[key] = (np.asarray(v["grad"], np.float32) /
                          np.sqrt(v["count"]))        # common.lua:163-166

    new_params, new_vel = {}, {}
    for name, p in params.items():
        # the smoothed grad is float64 (np.sqrt of an int count); the
        # step stays in the parameters' dtype, as in the JAX example
        g = torch.from_numpy(grads[name]).to(dev, p.dtype) + \
            _cfg["weight_decay"] * p
        v = _cfg["momentum"] * vel[name] - _cfg["lr"] * g
        new_vel[name] = v
        new_params[name] = p + v

    step = meta["step"] + 1
    _, _, x_val, y_val = _data
    with torch.no_grad():
        val_loss = float(nll_loss(new_params, x_val, y_val))
    best_val, best_step = meta["best_val"], meta["best_step"]
    if best_val is None or val_loss < best_val:
        best_val, best_step = val_loss, step
    finished = (step >= _cfg["max_steps"] or
                step - best_step >= _cfg["patience"])

    _save_state(store, new_params, new_vel)
    _write_meta(store, {"step": step, "best_val": best_val,
                        "best_step": best_step, "finished": finished,
                        "val_loss": val_loss, "tr_loss": tr_loss})
    return False if finished else "loop"
