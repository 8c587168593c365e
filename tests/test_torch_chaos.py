"""The port's chaos suite ≡ the JAX package's ``tests/test_chaos.py``
smoke legs, local and distributed matrices and RPC-fault leg (its
lines 222-292): the word count under seeded FaultPlans on the port's
``mem``, ``shared`` and ``object`` stores, barrier and pipelined, both
executors — byte-identical to the fault-free twin, zero repetition
bumps, the plan fired. The helpers the other chaos files share
(``tests/test_torch_chaos_{replication,push,sigkill,coded}.py``) live
here: the word count as an importable module, its storage specs, the
result-byte oracle, the seeded plan mix, the LocalExecutor and
distributed-pool legs (the port has no speculative leases, so the pool
leg takes no ``speculation``/``straggler``) and the SIGKILLed-pusher
leg."""

import threading
from typing import Dict

import pytest

from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.core.constants import Status
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.local import LocalExecutor, iter_results
from lua_mapreduce_tpu_torch.engine.server import Server
from lua_mapreduce_tpu_torch.engine.worker import MAP_NS, PRE_NS, RED_NS, Worker
from lua_mapreduce_tpu_torch.faults import FaultPlan, install_fault_plan
from lua_mapreduce_tpu_torch.store.router import get_storage_from

CORPUS = {
    f"doc{i}": " ".join(f"w{(i * 7 + j) % 23}" for j in range(40))
    for i in range(8)
}
GOLDEN: Dict[str, int] = {}
for _text in CORPUS.values():
    for _w in _text.split():
        GOLDEN[_w] = GOLDEN.get(_w, 0) + 1

_MOD = "tests._torch_chaos_wc"


def _install_module():
    """The wordcount program as an importable module (the distributed
    engine round-trips specs through module paths)."""
    import sys
    import types

    mod = sys.modules.get(_MOD)
    if mod is None:
        mod = types.ModuleType(_MOD)

        def taskfn(emit):
            for k, v in sorted(CORPUS.items()):
                emit(k, v)

        def mapfn(key, value, emit):
            for w in value.split():
                emit(w, 1)

        mod.taskfn = taskfn
        mod.mapfn = mapfn
        mod.partitionfn = lambda key: sum(key.encode()) % 4
        mod.reducefn = lambda key, values: sum(values)
        sys.modules[_MOD] = mod
    return mod


def _storage(tmp_path, backend, tag):
    return {"mem": f"mem:{tag}",
            "shared": f"shared:{tmp_path}/shared-{tag}",
            "object": f"object:{tmp_path}/object-{tag}"}[backend]


def _result_bytes(storage_spec, ns="result", only_results=False):
    """The result namespace's exact bytes, partition by partition — the
    byte-compare oracle. ``only_results`` narrows to the final
    ``<ns>.P<d>`` files: replica-kill legs legitimately leave behind
    consumed runs whose copies sit on a destroyed target (their
    best-effort remove is swallowed, like any dead backend's)."""
    import re
    store = get_storage_from(storage_spec)
    keep = re.compile(rf"^{re.escape(ns)}\.P\d+$")
    out = {}
    for name in store.list(f"{ns}.P*"):
        if only_results and not keep.match(name):
            continue
        out[name] = "".join(store.lines(name))
    return out


def _plan(seed, heavy=False):
    """The acceptance-criteria mix: transient + latency +
    error-after-write (+ torn on heavy legs); latency_ms kept tiny so
    the suite stays fast. max_per_key=2 < the default retry budget of
    3, so every injected burst is absorbable — zero repetition bumps is
    therefore a hard assertion, not a hope."""
    return FaultPlan(seed, transient=0.08, latency=0.05,
                     error_after_write=0.3,
                     torn=0.2 if heavy else 0.0,
                     latency_ms=1.0, max_per_key=2)


def _run_local(tmp_path, backend, pipeline, tag, plan=None, replication=1,
               push=False, push_budget_mb=None, coding=None):
    _install_module()
    spec = TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, init_args={"device": "cpu"},
                    storage=_storage(tmp_path, backend, tag))
    install_fault_plan(plan)
    try:
        ex = LocalExecutor(spec, map_parallelism=3, pipeline=pipeline,
                           premerge_min_runs=2,
                           segment_format="v2" if pipeline else "v1",
                           replication=replication, coding=coding,
                           push=push, push_budget_mb=push_budget_mb)
        stats = ex.run()
    finally:
        install_fault_plan(None)
    got = {k: v[0] for k, v in ex.results()}
    assert got == GOLDEN
    return _result_bytes(spec.storage,
                         only_results=replication > 1 or push
                         or coding is not None), stats


def _run_distributed(tmp_path, backend, pipeline, tag, plan=None,
                     n_workers=2, replication=1, batch_k=2, push=False,
                     coding=None):
    _install_module()
    spec = TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, init_args={"device": "cpu"},
                    storage=_storage(tmp_path, backend, tag))
    store = MemJobStore()
    install_fault_plan(plan)
    try:
        server = Server(store, poll_interval=0.01, pipeline=pipeline,
                        premerge_min_runs=2, batch_k=batch_k,
                        segment_format="v2" if pipeline else "v1",
                        replication=replication, coding=coding,
                        push=push).configure(spec)
        workers = [Worker(store).configure(max_iter=800, max_sleep=0.02)
                   for _ in range(n_workers)]
        threads = [threading.Thread(target=w.execute, daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        stats = server.loop()
        for t in threads:
            t.join(timeout=30)
    finally:
        install_fault_plan(None)

    # the release-not-broken contract: NO repetition bump from any
    # injected transient fault, in any namespace
    for ns in (MAP_NS, PRE_NS, RED_NS):
        for d in store.jobs(ns):
            assert d["repetitions"] == 0, \
                (f"injected transient faults bumped repetitions: "
                 f"{ns} job {d['_id']} -> {d['repetitions']}")
        counts = store.counts(ns)
        assert counts[Status.FAILED] == 0
    got = {k: v[0]
           for k, v in iter_results(get_storage_from(spec.storage),
                                    "result")}
    assert got == GOLDEN
    return _result_bytes(spec.storage,
                         only_results=replication > 1
                         or push or coding is not None), stats


def _sigkill_pusher_leg(tmp_path, modname, coding=None):
    """SIGKILL a pushing mapper mid-frame (a real subprocess worker,
    slowed by the plan so it is verifiably mid-push when killed); the
    stale requeue hands its job to a healthy worker (exactly one
    repetition charged, on that job only). The victim's partial inbox
    (frames with no manifest) stays invisible and is swept; output is
    byte-identical to the fault-free staged twin.

    With ``coding`` set the same storm runs on the erasure-coded push
    plane (DESIGN §27): the kill lands mid-STRIPE, and the manifest
    gate — member manifests published strictly after every block — is
    what keeps the victim's partial stripe invisible."""
    import os
    import signal
    import subprocess
    import sys
    import time

    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore

    clean, _ = _run_local(tmp_path, "mem", False, f"kill-{modname}-c")

    _install_module()
    # the distributed fleet round-trips user modules by import path:
    # install the same wordcount as a real module file the subprocess
    # can import
    moddir = tmp_path / "mods"
    moddir.mkdir()
    (moddir / f"{modname}.py").write_text(
        "CORPUS = " + repr(CORPUS) + "\n"
        "def taskfn(emit):\n"
        "    for k, v in sorted(CORPUS.items()): emit(k, v)\n"
        "def mapfn(key, value, emit):\n"
        "    for w in value.split(): emit(w, 1)\n"
        "def partitionfn(key):\n"
        "    return sum(key.encode()) % 4\n"
        "def reducefn(key, values):\n"
        "    return sum(values)\n")
    coord = tmp_path / "kill-coord"
    spill = tmp_path / "kill-spill"
    import sys as _sys
    _sys.path.insert(0, str(moddir))
    try:
        spec = TaskSpec(taskfn=modname, mapfn=modname,
                        partitionfn=modname, reducefn=modname,
                        init_args={"device": "cpu"},
                        storage=f"shared:{spill}")
        plan = FaultPlan(229, slow_worker="victim-*", slow_ms=250.0,
                         slow_s=3600.0)
        env = dict(os.environ,
                   PYTHONPATH=f"{moddir}:{os.environ.get('PYTHONPATH', '')}",
                   LMR_FAULT_PLAN=plan.to_spec(),
                   JAX_PLATFORMS="cpu")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

        def spawn(name):
            code = (
                "import sys\n"
                f"sys.path.insert(0, {repo!r})\n"
                f"sys.path.insert(0, {str(moddir)!r})\n"
                "from lua_mapreduce_tpu_torch import FileJobStore, Worker\n"
                f"w = Worker(FileJobStore({str(coord)!r}), name={name!r})\n"
                "w.configure(max_iter=100000, max_sleep=0.05,\n"
                "            max_tasks=1, heartbeat_s=0.25)\n"
                "w.execute()\n")
            return subprocess.Popen([sys.executable, "-c", code], env=env)

        victim = spawn("victim-0")
        store = FileJobStore(str(coord))
        server = Server(store, poll_interval=0.05, push=True,
                        stale_timeout_s=2.0, batch_k=1,
                        coding=coding).configure(spec)
        final = {}
        st = threading.Thread(
            target=lambda: final.setdefault("stats", server.loop()),
            daemon=True)
        st.start()
        # head start: the victim must HOLD a lease before the healthy
        # fleet exists, or the un-slowed workers drain the tiny job set
        # before the slowed victim ever claims
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                if any(d["status"] == Status.RUNNING
                       and d.get("worker") == "victim-0"
                       for d in store.jobs(MAP_NS)):
                    break
            except Exception:
                pass
            time.sleep(0.05)
        else:
            raise AssertionError("victim never claimed a lease")
        # plain mode: the healthy fleet races the slowed victim from the
        # start. Coded mode: the victim's first physical artifact is a
        # stripe BLOCK near the end of its job body, so a pre-spawned
        # fleet would drain the job set before the mid-stripe window
        # ever opens — spawn the fleet AFTER the kill instead
        healthy = [] if coding is not None \
            else [spawn(f"healthy-{i}") for i in range(2)]

        # kill the victim the moment it is verifiably MID-PUSH: a
        # frame of one of its claimed jobs landed, more output pending
        from lua_mapreduce_tpu_torch.engine.placement import parse_block
        deadline = time.time() + 90
        killed = False
        while time.time() < deadline and not killed:
            frags = []
            if spill.exists():
                frags = [f for f in os.listdir(spill)
                         if (parse_block(f) if coding is not None
                             else ".INBOX-" in f)]
            if frags:
                try:
                    # the victim must HOLD a live lease right now — the
                    # claim log alone also lists already-committed
                    # claims, and killing after its last commit would
                    # prove nothing
                    running = [d for d in store.jobs(MAP_NS)
                               if d["status"] == Status.RUNNING
                               and d.get("worker") == "victim-0"]
                except Exception:
                    running = []
                # ... and be verifiably MID-FRAME: a frame of one of
                # ITS running jobs already landed, its manifest/commit
                # have not (it is still RUNNING). Coded artifacts spell
                # the map key two ways: individually striped frames
                # embed the .INBOX- fragment name in each block, group
                # stripes embed the key in the .CODE. group base.
                from lua_mapreduce_tpu_torch.engine.job import map_key_str
                keys = {map_key_str(d["_id"]) for d in running}
                mid_frame = any(f".INBOX-{k}-" in f or f".CODE.{k}" in f
                                for k in keys for f in frags)
                if mid_frame:
                    victim.send_signal(signal.SIGKILL)
                    killed = True
                    victim_jobs = {d["_id"] for d in running}
                    break
            time.sleep(0.05)
        assert killed, "victim never got mid-push before the deadline"
        if not healthy:
            healthy = [spawn(f"healthy-{i}") for i in range(2)]

        st.join(timeout=120)
        assert not st.is_alive(), \
            "server wedged after the pusher was SIGKILLed"
        for p in healthy:
            try:
                p.wait(timeout=30)
            except Exception:
                p.kill()
        victim.wait(timeout=10)
        stats = final["stats"]
    finally:
        _sys.path.remove(str(moddir))

    got = {}
    from lua_mapreduce_tpu_torch.engine.local import iter_results as _ir
    for k, v in _ir(get_storage_from(spec.storage), "result"):
        got[k] = v[0]
    assert got == GOLDEN
    assert _result_bytes(spec.storage, only_results=True) == clean
    # the stale requeue covered the dead victim's job: one repetition
    # charged there, none anywhere else, nothing FAILED
    for d in store.jobs(MAP_NS):
        want = 1 if d["_id"] in victim_jobs else 0
        assert d["repetitions"] == want, \
            f"map job {d['_id']}: {d['repetitions']} repetitions"
        assert d["status"] == Status.WRITTEN
    it = stats.iterations[-1]
    assert it.map.failed == 0 and it.reduce.failed == 0

    if coding is not None:
        # the manifest gate, structurally: every stripe block left on
        # disk either belongs to a COMPLETE stripe (its logical name is
        # visible and fully readable through the coded view) or its
        # manifest never landed — in which case the logical name must
        # be invisible. A readable-but-partial stripe would be a torn
        # read waiting to happen; the gate makes that state
        # unrepresentable.
        from lua_mapreduce_tpu_torch.engine.placement import base_name, parse_block
        from lua_mapreduce_tpu_torch.faults.replicate import reading_view
        raw = get_storage_from(spec.storage)
        view = reading_view(raw, coding)
        blocks = [f for f in os.listdir(spill) if parse_block(f)]
        assert blocks, "coded sigkill leg never published a stripe block"
        for f in blocks:
            base = base_name(f)
            if view.exists(base):
                assert view.size(base) >= 0  # complete => readable
    return stats




# --- smoke legs: the test.sh chaos gate (one seeded plan per backend) -------

@pytest.mark.parametrize("backend", ["mem", "shared", "object"])
def test_chaos_smoke_backend(tmp_path, backend):
    clean, _ = _run_local(tmp_path, backend, False, f"smoke-{backend}-c")
    plan = _plan(seed=100 + len(backend))
    chaotic, stats = _run_local(tmp_path, backend, False,
                                f"smoke-{backend}-f", plan=plan)
    assert chaotic == clean, "fault leg output differs from fault-free"
    assert plan.total_fired() > 0, "plan injected nothing — seed too weak"
    assert stats.iterations[-1].store_faults > 0


# --- the full matrix ---------------------------------------------------------

@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["barrier", "pipelined"])
@pytest.mark.parametrize("backend", ["mem", "shared", "object"])
def test_chaos_local_matrix(tmp_path, backend, pipeline):
    tag = f"loc-{backend}-{int(pipeline)}"
    clean, _ = _run_local(tmp_path, backend, pipeline, tag + "-c")
    plan = _plan(seed=7)
    chaotic, _ = _run_local(tmp_path, backend, pipeline, tag + "-f",
                            plan=plan)
    assert chaotic == clean
    assert plan.total_fired() > 0


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["barrier", "pipelined"])
@pytest.mark.parametrize("backend", ["mem", "shared", "object"])
def test_chaos_distributed_matrix(tmp_path, backend, pipeline):
    tag = f"dist-{backend}-{int(pipeline)}"
    clean, _ = _run_distributed(tmp_path, backend, pipeline, tag + "-c")
    plan = _plan(seed=13, heavy=True)
    chaotic, stats = _run_distributed(tmp_path, backend, pipeline,
                                      tag + "-f", plan=plan)
    assert chaotic == clean
    assert plan.total_fired() > 0
    it = stats.iterations[-1]
    assert it.map.failed == 0 and it.reduce.failed == 0


def test_chaos_rpc_faults_on_coord_plane(tmp_path):
    """Transient faults injected on the JOBSTORE RPCs (claims, commits,
    heartbeats) — the control-plane half of the tentpole — are absorbed
    with identical results and zero repetition bumps."""
    tag = "rpc-leg"
    clean, _ = _run_distributed(tmp_path, "mem", False, tag + "-c")
    plan = FaultPlan(17, rpc_transient=0.1, max_per_key=2)
    chaotic, _ = _run_distributed(tmp_path, "mem", False, tag + "-f",
                                  plan=plan)
    assert chaotic == clean
    assert plan.fired.get("rpc_transient", 0) > 0
