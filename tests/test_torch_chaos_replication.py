"""The replica-aware shuffle under chaos, on the port ≡ the JAX
package's ``tests/test_chaos.py:276-575`` without its speculation legs:
r-1 of r copies destroyed (failover reads, zero re-runs) on both
executors over {mem, shared, object} × {barrier, pipelined}, one
placement tag blacked out, and total loss (every copy gone: the
scavenger requeues the producing map, also with a single dual-phase
worker)."""

import threading

import pytest

from test_torch_chaos import (CORPUS, GOLDEN, _MOD, _install_module,
                                _result_bytes, _run_distributed,
                                _run_local, _storage)
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.core.constants import Status
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.local import iter_results
from lua_mapreduce_tpu_torch.engine.server import Server
from lua_mapreduce_tpu_torch.engine.worker import RED_NS, Worker
from lua_mapreduce_tpu_torch.faults import FaultPlan
from lua_mapreduce_tpu_torch.store.router import get_storage_from


# --- replica-aware shuffle legs (DESIGN §20) ---------------------------------
#
# The replication acceptance gate: a FaultPlan destroys r-1 replicas of
# every partition's shuffle data mid-run (permanent read faults on the
# PRIMARY copies — placement routes each file's r copies onto distinct
# targets, and the primary names are exactly what the [0-9] character
# classes match; replica copies are ~k.tag~-prefixed and stay lit).
# Output must be byte-identical to the fault-free twin with ZERO
# map-job repetition bumps and ZERO map re-runs: pure failover reads.

def _kill_primaries_plan(seed):
    """Every read of every primary run/spill copy fails permanently —
    'r-1 of r replicas destroyed' for r=2 (the char classes never match
    a ~-prefixed replica copy, nor a list() pattern argument)."""
    return FaultPlan(seed, permanent=1.0,
                     pattern="result.P[0-9]*.M*|result.P[0-9]*.SPILL-*",
                     max_per_key=100_000, latency_ms=0)


def test_replication_smoke_failover(tmp_path):
    """The test.sh replication chaos gate: one fast leg — primaries
    destroyed, replicas serve, zero re-runs, byte-identical output."""
    clean, _ = _run_local(tmp_path, "mem", False, "rep-smoke-c")
    plan = _kill_primaries_plan(61)
    chaotic, stats = _run_local(tmp_path, "mem", False, "rep-smoke-f",
                                plan=plan, replication=2)
    assert chaotic == clean
    assert plan.total_fired() > 0
    it = stats.iterations[-1]
    assert it.failover_reads > 0
    assert it.map_reruns_avoided > 0
    assert it.map_reruns == 0


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["barrier", "pipelined"])
@pytest.mark.parametrize("backend", ["mem", "shared", "object"])
def test_replication_chaos_distributed_matrix(tmp_path, backend, pipeline):
    """The full acceptance matrix, on the distributed engine: r-1
    replica kill across {mem,shared,object} × {barrier,pipelined} —
    byte-identical to the fault-free twin, zero repetition bumps
    (asserted per job inside _run_distributed), zero map re-runs."""
    tag = f"rep-{backend}-{int(pipeline)}"
    clean, _ = _run_distributed(tmp_path, backend, pipeline, tag + "-c")
    plan = _kill_primaries_plan(67)
    chaotic, stats = _run_distributed(tmp_path, backend, pipeline,
                                      tag + "-f", plan=plan, replication=2)
    assert chaotic == clean, "failover leg output differs from fault-free"
    assert plan.total_fired() > 0
    it = stats.iterations[-1]
    assert it.failover_reads > 0, "plan never forced a failover read"
    assert it.map_reruns_avoided > 0
    assert it.map_reruns == 0, "replication failed to absorb the kills"


def test_replication_chaos_blackout(tmp_path):
    """The blackout kind end-to-end: ONE placement tag dark for the
    whole run (every data-plane op on it fails transient, uncapped) —
    the whole-failure-domain shape. r=2 puts every file's second copy
    on a different tag, so the run completes with identical bytes and
    zero re-runs."""
    from lua_mapreduce_tpu_torch.engine.placement import replica_pattern

    clean, _ = _run_local(tmp_path, "mem", True, "rep-bo-c")
    # scope the blackout to the shuffle plane — primaries AND the
    # replica copies routed onto the dark tag; result-file housekeeping
    # (which no replica protects) stays lit, as in a real deployment
    # where results land on a separate durable target
    shuffle = ["result.P[0-9]*.M*", "result.P[0-9]*.SPILL-*"]
    plan = FaultPlan(71, blackout_tag=3, blackout_s=3600.0,
                     pattern="|".join(shuffle
                                      + [replica_pattern(p)
                                         for p in shuffle]),
                     latency_ms=0)
    chaotic, stats = _run_local(tmp_path, "mem", True, "rep-bo-f",
                                plan=plan, replication=2)
    assert chaotic == clean
    assert plan.fired.get("blackout", 0) > 0, "the dark tag was never hit"
    it = stats.iterations[-1]
    assert it.map_reruns == 0


def test_replication_total_loss_falls_back_to_map_rerun(tmp_path):
    """The LAST rung of the ladder: every copy of one partition's runs
    destroyed (not just r-1) — the scavenger requeues the producing map
    jobs during the reduce phase, the pool regenerates the data, and
    the task still finishes byte-identical; map_reruns counts the
    last-resort re-runs and the errors stream tags them
    spill-lost-requeue."""
    import time

    from lua_mapreduce_tpu_torch.engine.placement import replica_names

    clean, _ = _run_distributed(tmp_path, "mem", False, "rep-loss-c")

    _install_module()
    spec = TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, init_args={"device": "cpu"},
                    storage=_storage(tmp_path, "mem", "rep-loss-f"))
    store = MemJobStore()
    server = Server(store, poll_interval=0.01, premerge_min_runs=2,
                    batch_k=2, replication=2).configure(spec)
    # map-only worker first: the reduce phase is reached with NO reduce
    # consumer, so the destruction below races nothing
    mapper = Worker(store).configure(max_iter=4000, max_sleep=0.02,
                                     phases=("map",))
    final = {}
    st = threading.Thread(
        target=lambda: final.setdefault("stats", server.loop()),
        daemon=True)
    mt = threading.Thread(target=mapper.execute, daemon=True)
    st.start()
    mt.start()

    raw = get_storage_from(spec.storage)
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            if store.counts(RED_NS)[Status.WAITING] > 0:
                break
        except Exception:
            pass
        time.sleep(0.01)
    else:
        raise AssertionError("never reached the reduce phase")

    victims = raw.list("result.P0.M*")
    assert victims, "partition 0 produced no runs"
    for name in victims:
        for copy in replica_names(name, 2):
            try:
                raw.remove(copy)
            except Exception:
                pass

    reducer = Worker(store).configure(max_iter=4000, max_sleep=0.05)
    rt = threading.Thread(target=reducer.execute, daemon=True)
    rt.start()
    st.join(timeout=60)
    assert not st.is_alive(), "server wedged after total replica loss"
    mt.join(timeout=10)
    rt.join(timeout=10)

    got = {k: v[0] for k, v in iter_results(raw, "result")}
    assert got == GOLDEN
    assert _result_bytes(spec.storage, only_results=True) == clean
    it = final["stats"].iterations[-1]
    assert it.map_reruns >= len(victims), \
        "total loss must requeue every destroyed producer"
    kinds = {e.get("classification") for e in server.errors}
    assert "spill-lost-requeue" in kinds


def test_replication_total_loss_single_dual_phase_worker(tmp_path):
    """Regression: with ONE dual-phase worker, the reduce-phase claim
    must not shadow the requeued producer — the worker probes MAP_NS
    BEFORE reclaiming its own released lost-data reduce job, or the
    map re-run starves forever and the task fails. A map-only worker
    bounded to exactly the map job count exits at the barrier, so the
    destruction races nothing and the late dual-phase worker is the
    ONLY claimant for both the recovery map and the retrying reduce."""
    import time

    from lua_mapreduce_tpu_torch.engine.placement import replica_names

    clean, _ = _run_distributed(tmp_path, "mem", False, "rep-1w-c")

    _install_module()
    spec = TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, init_args={"device": "cpu"},
                    storage=_storage(tmp_path, "mem", "rep-1w-f"))
    store = MemJobStore()
    server = Server(store, poll_interval=0.01, premerge_min_runs=2,
                    batch_k=2, replication=2).configure(spec)
    mapper = Worker(store).configure(max_iter=4000, max_sleep=0.02,
                                     phases=("map",),
                                     max_jobs=len(CORPUS))
    final = {}
    st = threading.Thread(
        target=lambda: final.setdefault("stats", server.loop()),
        daemon=True)
    mt = threading.Thread(target=mapper.execute, daemon=True)
    st.start()
    mt.start()
    mt.join(timeout=60)
    assert not mt.is_alive(), "bounded mapper never exited"

    raw = get_storage_from(spec.storage)
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            if store.counts(RED_NS)[Status.WAITING] > 0:
                break
        except Exception:
            pass
        time.sleep(0.01)
    else:
        raise AssertionError("never reached the reduce phase")

    victims = raw.list("result.P0.M*")
    assert victims, "partition 0 produced no runs"
    for name in victims:
        for copy in replica_names(name, 2):
            try:
                raw.remove(copy)
            except Exception:
                pass

    solo = Worker(store).configure(max_iter=4000, max_sleep=0.05)
    wt = threading.Thread(target=solo.execute, daemon=True)
    wt.start()
    st.join(timeout=60)
    assert not st.is_alive(), \
        "server wedged: the solo worker starved its own producer re-run"
    wt.join(timeout=10)

    got = {k: v[0] for k, v in iter_results(raw, "result")}
    assert got == GOLDEN
    assert _result_bytes(spec.storage, only_results=True) == clean
    it = final["stats"].iterations[-1]
    assert it.map_reruns >= len(victims)
