"""The digits mapfn, wrapped to keep what each map body saw and emitted
(a test-side task module for ``tests/test_torch_recovery_dryrun.py``).

A pool's workers load it by name (its directory on their PYTHONPATH).
Each map body writes, under ``init_args["dump_dir"]``, the checkpoint
and meta it read and the JSON bytes of every pair it emitted, so that a
failing run's map bodies can be recomputed in a fresh process and their
bytes compared (:func:`recompute`). The program itself is untouched:
taskfn, partitionfn, reducefn and finalfn stay the digits module's, and
so does its ``init``.
"""

import json
import os
import sys

from lua_mapreduce_tpu_torch.examples.digits import mr_train
from lua_mapreduce_tpu_torch.store.router import get_storage_from

_dump = {"dir": None, "n": 0}


def init(args):
    _dump["dir"] = args.get("dump_dir")


def _read(store, name):
    return store.read_range(name, 0, store.size(name))


def emitted_bytes(pairs):
    return json.dumps(pairs, sort_keys=True).encode()


def mapfn(key, shard, emit):
    store = get_storage_from(mr_train._cfg["model_store"])
    ckpt, meta = _read(store, mr_train.MODEL_FILE), _read(store,
                                                          mr_train.META_FILE)
    pairs = []

    def keep(k, v):
        pairs.append([k, v])
        emit(k, v)
    mr_train.mapfn(key, shard, keep)
    if _dump["dir"]:
        step = json.loads(meta)["step"]
        _dump["n"] += 1
        stem = os.path.join(_dump["dir"], f"s{step:03d}-k{key}-"
                            f"{os.getpid()}-{_dump['n']}")
        with open(stem + ".ckpt", "wb") as f:
            f.write(ckpt)
        with open(stem + ".meta", "wb") as f:
            f.write(meta)
        with open(stem + ".out", "wb") as f:
            f.write(emitted_bytes(pairs))


def recompute(init_args, stem, scratch):
    """Recompute the map body kept at ``stem`` (its checkpoint, meta and
    key) from the digits module in this process; returns its emitted
    bytes."""
    os.makedirs(scratch, exist_ok=True)
    store = get_storage_from(f"shared:{scratch}")
    for ext, name in ((".ckpt", mr_train.MODEL_FILE),
                      (".meta", mr_train.META_FILE)):
        with store.builder() as b:
            b.write_bytes(open(stem + ext, "rb").read())
            b.build(name)
    mr_train.init({**init_args, "model_store": f"shared:{scratch}"})
    key = int(os.path.basename(stem).split("-")[1][1:])
    pairs = []
    mr_train.mapfn(key, key, lambda k, v: pairs.append([k, v]))
    return emitted_bytes(pairs)


if __name__ == "__main__":
    # python digits_dump_task.py INIT_ARGS_JSON SCRATCH STEM...: print
    # each kept map body whose recomputed bytes differ from its kept ones
    args, scratch = json.loads(sys.argv[1]), sys.argv[2]
    for i, stem in enumerate(sys.argv[3:]):
        got = recompute(args, stem, os.path.join(scratch, str(i)))
        if got != open(stem + ".out", "rb").read():
            print(stem)
