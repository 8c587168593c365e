"""The digits pool of ``chip_smoke.py`` phase 24(a) as a CPU test: the
digits task through ``Server(FileJobStore, pipeline=True,
premerge_min_runs=2, segment_format="v2")`` and two traced
``execute_worker`` processes on ``object:`` spill, every process under
phase 24's seeded fault plan, with replication 1 and 2, and phase
25(a)'s: replication 2 with one placement tag dark for the first
seconds of the run. Each iteration's result files, and at the end the
checkpoint, are byte-equal to a barrier v1 LocalExecutor run's. On a mismatch the message names
the first differing iteration, the directory under ``tmp_path`` that
keeps the run's files and spans (``python -m
lua_mapreduce_tpu_torch.trace object:DIR/spill`` reads them) and the one
that keeps each iteration's result files of both runs.

Both runs take their mapfn from ``tests/digits_dump_task.py``, which
keeps each map body's checkpoint, meta and emitted bytes under the
test's tmp directory. On a mismatch the message also names the pool's
map bodies whose bytes differ from the LocalExecutor's body of the same
step and key, and those whose bytes a fresh process, recomputing them
from the checkpoint and meta they read, does not reproduce."""

import json
import os
import re
import subprocess
import sys

import pytest

from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.engine import LocalExecutor, Server, TaskSpec
from lua_mapreduce_tpu_torch.engine import local as local_mod
from lua_mapreduce_tpu_torch.engine import server as server_mod
from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
from lua_mapreduce_tpu_torch.store.router import get_storage_from
from lua_mapreduce_tpu_torch.trace import Tracer, install_tracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
DIGITS = "lua_mapreduce_tpu_torch.examples.digits.mr_train"
DUMP = "digits_dump_task"
ITERS = 6
# chip_smoke.py's DP_FAULT_PLAN: data-plane and coord-RPC faults,
# max_per_key 2 < the retry budget of 3
PLAN = ("seed=24;transient=0.04;torn=0.08;error_after_write=0.12;"
        "rpc_transient=0.03;max_per_key=2")
_RESULT = re.compile(r"^result\.P\d+$")


def _init_args(root):
    return {"sizes": [256, 128, 10], "n_shards": 4, "bunch": 128,
            "max_steps": ITERS, "patience": 10_000, "seed": 0,
            "device": "cpu", "model_store": f"shared:{root}/model"}


def _spec(root, spill):
    """The digits task, its map bodies kept under ``root``/maps."""
    os.makedirs(f"{root}/maps", exist_ok=True)
    return TaskSpec(taskfn=DIGITS, mapfn=DUMP, partitionfn=DIGITS,
                    reducefn=DIGITS, finalfn=DIGITS,
                    init_args={**_init_args(root),
                               "dump_dir": f"{root}/maps"},
                    storage=f"{spill}:{root}/spill")


def _map_bodies(root):
    """The kept map bodies under ``root``/maps: {(step, key): [stem]}."""
    bodies = {}
    for name in sorted(os.listdir(f"{root}/maps")):
        if name.endswith(".out"):
            step, key = name.split("-")[:2]
            bodies.setdefault((step, key), []).append(
                os.path.join(f"{root}/maps", name[:-4]))
    return bodies


def _map_diffs(local_root, pool_root, scratch):
    """The pool's kept map bodies whose emitted bytes differ from the
    LocalExecutor's of the same step and key, and those a fresh process
    does not reproduce from the checkpoint and meta they read."""
    local, pool = _map_bodies(local_root), _map_bodies(pool_root)
    want = {k: open(v[0] + ".out", "rb").read() for k, v in local.items()}
    stems = [s for v in pool.values() for s in v]
    unlike = [s for (k, v) in pool.items() for s in v
              if open(s + ".out", "rb").read() != want.get(k)]
    fresh = subprocess.run(
        [sys.executable, os.path.join(TESTS, f"{DUMP}.py"),
         json.dumps(_init_args(pool_root)), str(scratch), *stems],
        cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep + TESTS))
    return unlike, fresh.stdout.split() or fresh.stderr[-2000:]


def _files(store, names):
    return {n: store.read_range(n, 0, store.size(n)) for n in names}


def _snapshots(monkeypatch, module, into):
    """Record each iteration's result files as finalfn reads them."""
    real = module.iter_results

    def iter_results(result_store, ns):
        into.append(_files(result_store, [
            n for n in result_store.list(f"{ns}.P*") if _RESULT.match(n)]))
        return real(result_store, ns)
    monkeypatch.setattr(module, "iter_results", iter_results)


def _keep_iterations(into, want_its, got_its):
    """Write each iteration's result files of the LocalExecutor (``want``)
    and of the pool (``got``) under ``into``/{want,got}/iter<N>/, for a
    failing run to be read after the test; returns ``into``."""
    for side, its in (("want", want_its), ("got", got_its)):
        for i, files in enumerate(its, 1):
            d = into / side / f"iter{i}"
            d.mkdir(parents=True, exist_ok=True)
            for name, data in files.items():
                (d / name).write_bytes(data)
    return into


def _checkpoint(root):
    return _files(get_storage_from(f"shared:{root}/model"),
                  ["model.ckpt", "model.meta"])


def _dark_tag():
    """The smallest placement tag no model-store file and no partition
    result sits on (``chip_smoke.py``'s ``dark_tag``)."""
    from lua_mapreduce_tpu_torch.engine.placement import NUM_TAGS, tag_of
    from lua_mapreduce_tpu_torch.examples.digits.mr_train import \
        NUM_REDUCERS
    used = {tag_of(n) for n in ["model.ckpt", "model.meta"]
            + [f"result.P{p}" for p in range(NUM_REDUCERS)]}
    return min(t for t in range(NUM_TAGS) if t not in used)


def _pool_equals_barrier_local(tmp_path, monkeypatch, replication, plan):
    """The pool under ``plan`` against the barrier v1 LocalExecutor,
    iteration by iteration; returns the workers' reports and the
    number of spills the server's sweeps could not remove."""
    want_its = []
    _snapshots(monkeypatch, local_mod, want_its)
    LocalExecutor(_spec(tmp_path / "local", "shared"),
                  max_iterations=ITERS + 1).run()
    want_ckpt = _checkpoint(tmp_path / "local")

    root, coord = tmp_path / "pool", str(tmp_path / "coord")
    env = dict(os.environ, LMR_FAULT_PLAN=plan,
               PYTHONPATH=REPO + os.pathsep + TESTS + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    reports = [str(tmp_path / f"w{i}.json") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lua_mapreduce_tpu_torch.cli.execute_worker",
         coord, "--name", f"dry-w{i}", "--max-iter", "4000",
         "--max-sleep", "0.05", "--trace", "--report", path],
        cwd=REPO, env=env) for i, path in enumerate(reports)]
    got_its = []
    _snapshots(monkeypatch, server_mod, got_its)
    c0 = COUNTERS.snapshot()
    monkeypatch.setenv("LMR_FAULT_PLAN", plan)
    install_tracer(Tracer())
    try:
        stats = Server(FileJobStore(coord), poll_interval=0.02,
                       pipeline=True, premerge_min_runs=2,
                       segment_format="v2", replication=replication
                       ).configure(_spec(root, "object")).loop()
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        install_tracer(None)
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0]
    assert len(stats.iterations) == ITERS == len(want_its)
    differ = [i + 1 for i, (a, b) in enumerate(zip(want_its, got_its))
              if a != b]
    kept, unlike, unrepeated = None, None, None
    if differ or _checkpoint(root) != want_ckpt:
        kept = _keep_iterations(tmp_path / "iterations", want_its, got_its)
        unlike, unrepeated = _map_diffs(tmp_path / "local", root,
                                        tmp_path / "fresh")
    assert not differ and _checkpoint(root) == want_ckpt, (
        f"replication {replication}: result files first differ in "
        f"iteration {differ[0] if differ else None} of {differ} (checkpoint"
        f" equal: {_checkpoint(root) == want_ckpt}); the run's files and "
        f"spans are kept under {root}, each iteration's result files of "
        f"both runs under {kept}; the pool's map bodies unlike the "
        f"LocalExecutor's: {unlike}; those a fresh process does not "
        f"reproduce from their own inputs: {unrepeated}")
    unremoved = COUNTERS.delta(c0, COUNTERS.snapshot()).get(
        "unremoved_spills", 0)
    return [json.load(open(r)) for r in reports], unremoved


@pytest.mark.parametrize("replication", [1, 2])
def test_pipelined_pool_under_faults_equals_barrier_local(
        tmp_path, monkeypatch, replication):
    reports, _ = _pool_equals_barrier_local(tmp_path, monkeypatch,
                                            replication, PLAN)
    assert sum(sum(r["faults_fired"].values()) for r in reports) > 0


def test_pipelined_pool_under_a_passing_blackout_equals_barrier_local(
        tmp_path, monkeypatch):
    """``chip_smoke.py`` phase 25(a) on the CPU: replication 2 and the
    fault plan plus one placement tag dark for the first seconds of
    each process's run, so that copies on it outlive sweeps across
    iteration boundaries and come back later. Every iteration stays
    byte-equal to the barrier run."""
    plan = f"{PLAN};blackout_tag={_dark_tag()};blackout_s=10"
    reports, unremoved = _pool_equals_barrier_local(
        tmp_path, monkeypatch, 2, plan)
    assert sum(r["faults_fired"].get("blackout", 0) for r in reports) > 0
    print(f"spills the sweeps could not remove: {unremoved}")
