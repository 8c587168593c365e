#!/usr/bin/env python3
"""Repeat the speculation race of ``chip_smoke.py``'s phase 26(a) and
count the runs whose files differ from a LocalExecutor's.

    python3 chip_spec_race.py [--runs N] [--device cuda|cpu] ROOT [ROOT]

One run is the digits DP-SGD task of phase 21 (6 iterations) through a
``Server(FileJobStore(engine="native"), speculation=3.0)`` and two
``execute_worker`` processes, with one map job of iteration 2 claimed
and abandoned right after its insert, so that a clone must win it. The
detector clones other stragglers as well, reduce jobs among them. A
run is right when its ``result.P*`` files, ``model.ckpt`` and
``model.meta`` are byte-equal to the LocalExecutor's on the same task.

Each ROOT is a checkout of the port; its runs go through its own code
in a child process. With two roots they run in the order A, B, B, A,
``N`` runs a turn. To compare a change with its parent, unpack the
parent into a directory that ``.gitignore`` lists:

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python3 chip_spec_race.py build/parent .

Prints one line per turn and one per root, and writes them to
``chiprun_out/chip_spec_race.json`` under the directory this script lies
in. Exits non-zero when a child fails, or when ``--device cuda`` is asked
for and CUDA is unavailable; a run that differs does not change the exit
code.
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r'''
import json, os, shutil, subprocess, sys, time
base, runs, device = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.core.constants import MAP_NS
from lua_mapreduce_tpu_torch.engine import LocalExecutor, Server, TaskSpec
from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
from lua_mapreduce_tpu_torch.store.router import get_storage_from

DIGITS = "lua_mapreduce_tpu_torch.examples.digits.mr_train"
ARGS = {"sizes": [256, 128, 10], "n_shards": 4, "bunch": 128,
        "max_steps": 6, "patience": 10000, "seed": 0, "device": device}


def spec(root):
    return TaskSpec(taskfn=DIGITS, mapfn=DIGITS, partitionfn=DIGITS,
                    reducefn=DIGITS, finalfn=DIGITS,
                    init_args={**ARGS, "model_store": f"shared:{root}/model"},
                    storage=f"shared:{root}/spill")


def files(root):
    out = {}
    for sub in ("spill", "model"):
        st = get_storage_from(f"shared:{root}/{sub}")
        for n in st.list("*"):
            if (n.startswith("result.P") and n.count(".") == 1) or \
                    n in ("model.ckpt", "model.meta"):
                out[f"{sub}/{n}"] = st.read_range(n, 0, st.size(n))
    return out


shutil.rmtree(base, ignore_errors=True)
os.makedirs(base)
LocalExecutor(spec(os.path.join(base, "local"))).run()
want = files(os.path.join(base, "local"))
out = []
for r in range(runs):
    root, coord = os.path.join(base, f"r{r}"), os.path.join(base, f"c{r}")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lua_mapreduce_tpu_torch.cli.execute_worker",
         coord, "--name", f"w{i}", "--max-iter", "4000", "--max-sleep",
         "0.05", "--report", os.path.join(base, f"w{r}.{i}.json")],
        stdout=subprocess.DEVNULL) for i in range(2)]
    raw = FileJobStore(coord, engine="native")
    insert, doomed = raw.insert_jobs, []

    def insert_jobs(ns, docs, raw=raw, insert=insert, doomed=doomed):
        ids = insert(ns, docs)
        it = int((raw.get_task() or {}).get("iteration", 0))
        if ns == MAP_NS and it == 2 and not doomed:
            doomed += raw.claim_batch(MAP_NS, "doomed", 1)
        return ids
    raw.insert_jobs = insert_jobs
    c0 = COUNTERS.snapshot()
    t0 = time.perf_counter()
    try:
        Server(raw, poll_interval=0.02, speculation=3.0).configure(
            spec(root)).loop()
    finally:
        codes = [p.wait(120) for p in procs]
    wall = time.perf_counter() - t0
    got = files(root)
    counters = COUNTERS.delta(c0, COUNTERS.snapshot())
    for i in range(2):
        with open(os.path.join(base, f"w{r}.{i}.json")) as f:
            for k, v in json.load(f)["counters"].items():
                counters[k] = counters.get(k, 0) + v
    out.append({"differ": sorted(n for n in set(want) | set(got)
                                 if want.get(n) != got.get(n)),
                "seconds": wall, "workers_exit": codes,
                "doomed": bool(doomed),
                "spec": {k: v for k, v in counters.items()
                         if k.startswith("spec_")}})
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(coord, ignore_errors=True)
print(json.dumps(out))
'''


def turn(root, runs, device, slot):
    """``runs`` runs through the checkout at ``root``, in a child."""
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=root)
    base = os.path.join(root, "build", f"spec-race-{slot}")
    p = subprocess.run([sys.executable, "-c", CHILD, base, str(runs),
                        device], cwd=root, env=env, stdout=subprocess.PIPE,
                       text=True)
    if p.returncode != 0:
        raise SystemExit(f"{root}: child exited {p.returncode}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="one or two checkouts")
    ap.add_argument("--runs", type=int, default=5, help="runs a turn")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if len(args.roots) > 2:
        ap.error("one or two checkouts")
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("CUDA is not available")
    order = (args.roots if len(args.roots) == 1
             else [args.roots[0], args.roots[1], args.roots[1],
                   args.roots[0]])
    turns, totals = [], {}
    for slot, root in enumerate(order):
        runs = turn(root, args.runs, args.device, slot)
        bad = sum(1 for r in runs if r["differ"])
        turns.append({"root": root, "runs": runs})
        t = totals.setdefault(root, {"runs": 0, "differ": 0})
        t["runs"] += len(runs)
        t["differ"] += bad
        print(f"[spec-race] turn {slot} {root}: {bad} of {len(runs)} runs "
              f"differ; {[r['differ'] for r in runs if r['differ']]}; "
              f"seconds {[round(r['seconds'], 2) for r in runs]}; "
              f"spec {[r['spec'] for r in runs]}", flush=True)
    for root, t in totals.items():
        print(f"[spec-race] {root}: {t['differ']} of {t['runs']} runs "
              "differ from the LocalExecutor", flush=True)
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "chip_spec_race.json"), "w") as f:
        json.dump({"device": args.device, "turns": turns,
                   "totals": totals}, f, indent=1)


if __name__ == "__main__":
    main()
