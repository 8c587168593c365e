"""Digits-sheet end to end: both training paths of the port to a
validation-ACCURACY target.

The port's counterpart of ``benchmarks/digits_e2e.py`` (the APRIL-ANN
capability with accuracy, reference examples/APRIL-ANN/init.lua:80-123
and common.lua:144-202). It trains the digits MLP on the checked-in
digits sheet (``tests/fixtures/digits_sheet.png``, 1600x160: the
reference's 16x16 patterns, 800 train / 200 validation, through
``train/data.load_digits_image``) along two paths:

- the **harness path**: ``train/harness.DataParallelTrainer``, 300
  ``run_steps(..., 1)`` calls on random batches of 512 (on a card, every
  step a replay of the captured step);
- the **MapReduce path**: ``examples/digits/mr_train``'s six functions
  looping under the ``LocalExecutor`` (up to 60 steps, patience 10).

Both must reach the accuracy target and agree within 0.05. The printed
JSON stands beside the JAX package's result in
``benchmarks/results/digits_e2e.json`` (the CPU run: 1.0 / 1.0 against
0.95).

    python -m lua_mapreduce_tpu_torch.examples.digits.e2e [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SHEET = os.path.join(REPO, "tests", "fixtures", "digits_sheet.png")
JAX_RESULT = os.path.join(REPO, "benchmarks", "results", "digits_e2e.json")


def harness_path(device, sheet: str = SHEET, steps: int = 300,
                 batch: int = 512) -> dict:
    """DataParallelTrainer on the sheet → final validation accuracy."""
    from lua_mapreduce_tpu_torch.models.mlp import (accuracy, init_mlp,
                                                    nll_loss)
    from lua_mapreduce_tpu_torch.train.data import load_digits_image
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)

    x_tr, y_tr, x_va, y_va = load_digits_image(sheet)
    tr = DataParallelTrainer(nll_loss, init_mlp(0, device=device),
                             TrainConfig(batch_size=batch,
                                         learning_rate=0.05, momentum=0.9),
                             device=device)
    rng = np.random.RandomState(0)
    for _ in range(steps):
        idx = rng.randint(0, len(x_tr), batch)
        tr.run_steps(x_tr[idx], y_tr[idx], 1)
    with torch.no_grad():
        acc = float(accuracy(tr.params, torch.from_numpy(x_va).to(device),
                             torch.from_numpy(y_va).to(device)))
    return {"val_accuracy": round(acc, 4), "steps": steps, "batch": batch,
            "captures": tr.traces}


def mapreduce_path(device, sheet: str = SHEET, max_steps: int = 60,
                   model_store: str = "mem:torch-digits-e2e") -> dict:
    """mr_train's six functions under the LocalExecutor until early
    stopping or ``max_steps``, then the accuracy of the checkpointed
    params."""
    from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
    from lua_mapreduce_tpu_torch.examples.digits import mr_train
    from lua_mapreduce_tpu_torch.models.mlp import accuracy
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    from lua_mapreduce_tpu_torch.train.data import load_digits_image

    store = get_storage_from(model_store)
    for f in (mr_train.MODEL_FILE, mr_train.META_FILE):
        if store.exists(f):
            store.remove(f)
    mod = "lua_mapreduce_tpu_torch.examples.digits.mr_train"
    spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod, reducefn=mod,
                    finalfn=mod,
                    init_args={"image": sheet, "model_store": model_store,
                               "max_steps": max_steps, "patience": 10,
                               "device": str(device)},
                    storage="mem:torch-digits-e2e-spill")
    LocalExecutor(spec).run()
    meta = mr_train.read_meta(model_store)
    params = mr_train._load_state(store)["params"]
    _, _, x_va, y_va = load_digits_image(sheet)
    with torch.no_grad():
        acc = float(accuracy(params, torch.from_numpy(x_va).to(device),
                             torch.from_numpy(y_va).to(device)))
    return {"val_accuracy": round(acc, 4), "steps": meta["step"],
            "val_loss": round(meta["val_loss"], 4)}


def run(device=None, harness_steps: int = 300, mr_steps: int = 60,
        target: float = 0.95) -> dict:
    """Both paths on ``device`` (default ``"cuda"``), beside the JAX
    package's CPU result."""
    from lua_mapreduce_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    harness = harness_path(dev, steps=harness_steps)
    mr = mapreduce_path(dev, max_steps=mr_steps)
    with open(JAX_RESULT) as f:
        jax_ref = json.load(f)
    return {
        "sheet": os.path.relpath(SHEET, REPO),
        "split": "800 train / 200 val (init.lua:80-123 contract)",
        "device": str(dev),
        "target_accuracy": target,
        "harness_path": harness,
        "mapreduce_path": mr,
        "agree_within": round(abs(harness["val_accuracy"]
                                  - mr["val_accuracy"]), 4),
        "both_reach_target": (harness["val_accuracy"] >= target
                              and mr["val_accuracy"] >= target),
        "jax_package": {
            "harness_path": jax_ref["tpu_native_path"]["val_accuracy"],
            "mapreduce_path": jax_ref["mapreduce_path"]["val_accuracy"],
            "platform": jax_ref["platform"]},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    print(json.dumps(out, indent=1))
    return 0 if out["both_reach_target"] else 1


if __name__ == "__main__":
    sys.exit(main())
