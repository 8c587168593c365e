"""Speculative duplicate leases in the port against the JAX package
(tests/test_speculation.py's fourteen tests that need no protocol model
of their own).

1. Store conformance: every duplicate-lease scenario (speculate /
   claim_spec / cancel_spec, first-commit-wins both ways, shadow
   heartbeats, unlease, the placement-tag preference, a dead clone, a
   dead original) runs on the port's MemJobStore and FileJobStore
   (python and native index) and on the JAX package's same three
   stores: every answer and every resulting job state is equal across
   the six.
2. The JAX package's protocol model replays its both-commit race on the
   port's real stores, both directions.
3. Engine level on the port: the Server's straggler detector (cap,
   idempotence, retraction of an abandoned shadow lease), the worker's
   fleet-EWMA fold and seeding, a clone losing its race or failing its
   body (nothing charged), and an in-process pool finishing a task whose
   original died with its lease — result bytes equal to the JAX
   package's LocalExecutor on the same task.
"""

import threading
import time

import pytest

from lua_mapreduce_tpu.coord.filestore import FileJobStore as JaxFileStore
from lua_mapreduce_tpu.coord.jobstore import MemJobStore as JaxMemStore
from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore, make_job
from lua_mapreduce_tpu_torch.core.constants import Status

NS = "map_jobs"
TIMES = {"started": 1.0, "finished": 2.0, "written": 3.0, "cpu": 0.1,
         "real": 2.0}


def _stores(tmp_path):
    """The port's three stores, then the JAX package's."""
    return {"port-mem": MemJobStore(),
            "port-file-py": FileJobStore(str(tmp_path / "p-py"),
                                         engine="python"),
            "port-file-native": FileJobStore(str(tmp_path / "p-nat"),
                                             engine="native"),
            "jax-mem": JaxMemStore(),
            "jax-file-py": JaxFileStore(str(tmp_path / "j-py"),
                                        engine="python"),
            "jax-file-native": JaxFileStore(str(tmp_path / "j-nat"),
                                            engine="native")}


def _seed(store, n=3):
    return store.insert_jobs(NS, [{"key": f"k{i}", "value": i,
                                   "creation_time": 0.0} for i in range(n)])


def _state(store, jid):
    d = store.get_job(NS, jid)
    return (int(d["status"]), d["repetitions"], int(d.get("spec_state") or 0))


def _same_everywhere(tmp_path, scenario):
    """Run ``scenario(store) -> observations`` on all six stores; the
    observations must be equal. Returns them."""
    got = {name: scenario(store)
           for name, store in _stores(tmp_path).items()}
    first = got["port-mem"]
    for name, obs in got.items():
        assert obs == first, (name, obs, first)
    return first


# --- store conformance -------------------------------------------------------

def test_speculate_lifecycle_all_stores(tmp_path):
    """speculate CAS: only RUNNING, only once; claim_spec: never the
    job's own claimant, one shadow at most; cancel_spec: holder-CASed."""
    def scenario(store):
        _seed(store)
        obs = [store.speculate(NS, 0)]             # WAITING: refused
        jid = store.claim_batch(NS, "orig", 1)[0]["_id"]
        obs += [store.speculate(NS, jid), store.speculate(NS, jid),
                store.claim_spec(NS, "orig")]
        clone = store.claim_spec(NS, "shadow")
        obs += [clone["_id"], clone.get("speculative"),
                clone["repetitions"], clone["worker"],
                store.claim_spec(NS, "third"),
                store.cancel_spec(NS, jid, "third"),
                store.cancel_spec(NS, jid, "shadow"),
                store.cancel_spec(NS, jid, "shadow"), _state(store, jid)]
        return obs
    obs = _same_everywhere(tmp_path, scenario)
    assert obs == [False, True, False, None, 0, True, 0, "orig", None,
                   False, True, False, (int(Status.RUNNING), 0, 0)]


@pytest.mark.parametrize("winner", ["clone", "original"])
def test_first_commit_wins_both_directions(tmp_path, winner):
    """Whoever commits first retires the job; the loser's commit fails
    the status CAS and changes nothing — never a double commit, never a
    repetition bump."""
    def scenario(store):
        _seed(store)
        jid = store.claim_batch(NS, "orig", 1)[0]["_id"]
        store.speculate(NS, jid)
        store.claim_spec(NS, "shadow")
        first, second = (("shadow", "orig") if winner == "clone"
                         else ("orig", "shadow"))
        return [store.commit_batch(NS, first, [(jid, TIMES)]),
                store.commit_batch(NS, second, [(jid, TIMES)]),
                store.set_job_status(NS, jid, Status.FINISHED,
                                     expect=(Status.RUNNING,),
                                     expect_worker=second),
                _state(store, jid)[:2]]
    obs = _same_everywhere(tmp_path, scenario)
    assert obs == [[0], [], False, (int(Status.WRITTEN), 0)]


def test_shadow_heartbeat_ownership(tmp_path):
    """Both lease holders beat the shared record, anyone else misses;
    the beat turns False (revoked) once the job left the leased
    states."""
    def scenario(store):
        _seed(store)
        jid = store.claim_batch(NS, "orig", 1)[0]["_id"]
        store.speculate(NS, jid)
        store.claim_spec(NS, "shadow")
        obs = [store.heartbeat(NS, jid, "orig"),
               store.heartbeat(NS, jid, "shadow"),
               store.heartbeat(NS, jid, "other"),
               store.heartbeat_batch(NS, [jid], "shadow")]
        store.commit_batch(NS, "orig", [(jid, TIMES)])
        return obs + [store.heartbeat(NS, jid, "shadow")]
    assert _same_everywhere(tmp_path, scenario) == [True, True, False, 1,
                                                    False]


def test_unlease_dissolves_shadow(tmp_path):
    """Release and stale requeue clear the shadow lease, and a stale
    clone can never commit the re-claimed job."""
    def scenario(store):
        _seed(store)
        jid = store.claim_batch(NS, "orig", 1)[0]["_id"]
        store.speculate(NS, jid)
        store.claim_spec(NS, "shadow")
        obs = [store.release_batch(NS, "orig", [jid]), _state(store, jid),
               store.claim_batch(NS, "third", 1)[0]["_id"],
               store.commit_batch(NS, "shadow", [(jid, TIMES)]),
               _state(store, jid)]
        store.speculate(NS, jid)
        store.claim_spec(NS, "shadow2")
        time.sleep(0.05)
        obs += [store.requeue_stale(NS, 0.01) >= 1, _state(store, jid),
                store.commit_batch(NS, "shadow2", [(jid, TIMES)])]
        return obs
    obs = _same_everywhere(tmp_path, scenario)
    assert obs == [1, (int(Status.WAITING), 0, 0), 0, [],
                   (int(Status.RUNNING), 0, 0), True,
                   (int(Status.BROKEN), 1, 0), []]


def test_claim_spec_prefers_other_placement_tag(tmp_path):
    """Among open shadow leases, claimants prefer stragglers on another
    placement tag than their own; lowest id first within each class."""
    from lua_mapreduce_tpu_torch.coord.filestore import worker_hash
    from lua_mapreduce_tpu_torch.coord.idx_py import worker_tag
    names = [f"w{i}" for i in range(64)]
    tag_of = {n: worker_tag(worker_hash(n)) for n in names}
    a = names[0]
    same = next(n for n in names[1:] if tag_of[n] == tag_of[a])
    other = next(n for n in names[1:] if tag_of[n] != tag_of[a])

    def scenario(store):
        _seed(store)
        j0 = store.claim_batch(NS, same, 1)[0]["_id"]
        j1 = store.claim_batch(NS, other, 1)[0]["_id"]
        store.speculate(NS, j0)
        store.speculate(NS, j1)
        return [store.claim_spec(NS, a)["_id"],
                store.claim_spec(NS, a)["_id"]]
    assert _same_everywhere(tmp_path, scenario) == [1, 0]


# --- death regressions -------------------------------------------------------

def test_dead_clone_original_commits_zero_reps(tmp_path):
    """The clone dies after claim_spec (never issues another op): the
    original commits normally, repetitions stay zero."""
    def scenario(store):
        _seed(store)
        jid = store.claim_batch(NS, "orig", 1)[0]["_id"]
        store.speculate(NS, jid)
        obs = [store.claim_spec(NS, "doomed-clone")["_id"],
               store.commit_batch(NS, "orig", [(jid, TIMES)])]
        return obs + [_state(store, jid)[:2]]
    assert _same_everywhere(tmp_path, scenario) == [
        0, [0], (int(Status.WRITTEN), 0)]


def test_dead_original_clone_protects_and_commits(tmp_path):
    """The original goes silent after its claim: the clone's heartbeats
    keep the shared record live (no stale requeue, no charge) until the
    clone commits; the same silence with no clone IS requeued with a
    charge."""
    def scenario(store):
        _seed(store, n=2)
        jid = store.claim_batch(NS, "dead-orig", 1)[0]["_id"]
        store.speculate(NS, jid)
        store.claim_spec(NS, "live-clone")
        ctl = store.claim_batch(NS, "dead-too", 1)[0]["_id"]  # no clone
        time.sleep(0.08)
        return [store.heartbeat(NS, jid, "live-clone"),
                store.requeue_stale(NS, 0.05), _state(store, ctl)[:2],
                _state(store, jid)[:2],
                store.commit_batch(NS, "live-clone", [(jid, TIMES)]),
                _state(store, jid)[:2]]
    assert _same_everywhere(tmp_path, scenario) == [
        True, 1, (int(Status.BROKEN), 1), (int(Status.RUNNING), 0), [0],
        (int(Status.WRITTEN), 0)]


# --- the JAX package's protocol model on the port's stores ------------------

@pytest.mark.parametrize("clone_first", [True, False],
                         ids=["clone-wins", "original-wins"])
def test_both_commit_race_replays_on_real_stores(tmp_path, clone_first):
    """The hand-written both-commit race of the JAX package's protocol
    model (worker 0 claims, the detector opens speculation, worker 1
    takes the shadow lease, both execute, both commit in either order)
    replays on the port's stores to the model's final state."""
    from lua_mapreduce_tpu.analysis import protocol as proto
    cfg = proto.ModelConfig(n_workers=2, n_jobs=1, batch_k=1,
                            allow_spec=True)
    head = [("claim", 0, (0,)), ("speculate", 0), ("claim_spec", 1, 0),
            ("exec", 0, 0), ("spec_exec", 1, 0)]
    if clone_first:
        tail = [("commit_a", 1, 0, True), ("commit_b", 1, 0, True),
                ("commit_a", 0, 0, False)]
        final_spec = proto._SP_TAKEN0 + 1
    else:
        tail = [("commit_a", 0, 0, True), ("commit_b", 0, 0, True),
                ("commit_a", 1, 0, False), ("spec_cancel", 1, 0, True)]
        final_spec = proto._SP_NONE
    final = (((int(Status.WRITTEN), 0, 1, 0, proto._D_INTACT,
               final_spec),), None, None, None)
    for store in (MemJobStore(), FileJobStore(str(tmp_path / "fs-py"),
                                              engine="python"),
                  FileJobStore(str(tmp_path / "fs-nat"), engine="native")):
        rep = proto.replay_trace(store, head + tail, cfg, final_state=final,
                                 ns=f"race{int(clone_first)}")
        assert rep["ok"], rep


# --- engine level ------------------------------------------------------------

_MOD = "tests._torch_spec_wc"


def _wc_module():
    import sys
    import types
    mod = sys.modules.get(_MOD)
    if mod is None:
        mod = types.ModuleType(_MOD)
        mod.taskfn = lambda emit: [emit(f"d{i}", f"w{i % 3} w{(i + 1) % 3}")
                                   for i in range(6)]

        def mapfn(key, value, emit):
            for w in value.split():
                emit(w, 1)
        mod.mapfn = mapfn
        mod.partitionfn = lambda key: sum(key.encode()) % 2
        mod.reducefn = lambda key, values: sum(values)
        sys.modules[_MOD] = mod
    return mod


def _spec(storage):
    from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
    _wc_module()
    return TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, init_args={"device": "cpu"},
                    storage=storage)


def test_detector_launches_and_respects_cap():
    """The detector gives RUNNING jobs older than factor × the task
    doc's fleet EWMA a shadow lease, oldest first, at most
    speculation_cap live clones per namespace; passes are idempotent; a
    cold fleet (no EWMA) speculates nothing."""
    from lua_mapreduce_tpu_torch.engine.server import Server
    store = MemJobStore()
    server = Server(store, speculation=2.0, speculation_cap=2)
    store.put_task({"_id": "unique", "status": "MAP"})
    _seed(store, n=4)
    store.claim_batch(NS, "w1", 3)
    time.sleep(0.05)
    server._speculate_stragglers(NS)        # cold: no EWMA on the doc
    assert all(not d.get("spec_state") for d in store.jobs(NS))
    server._spec_scan_at.clear()            # the throttle is not under test
    store.update_task({f"dur_ewma:{NS}": 0.01})
    server._speculate_stragglers(NS)
    opened = [d for d in store.jobs(NS) if d.get("spec_state")]
    assert len(opened) == 2                 # capped below the 3 overdue
    server._spec_scan_at.clear()
    server._speculate_stragglers(NS)
    assert len([d for d in store.jobs(NS) if d.get("spec_state")]) == 2
    clone = store.claim_spec(NS, "shadow")
    assert clone["_id"] in {d["_id"] for d in opened}
    store.commit_batch(NS, "shadow", [(clone["_id"], TIMES)])
    server._spec_scan_at.clear()
    server._speculate_stragglers(NS)        # the win freed one slot
    live = [d for d in store.jobs(NS)
            if d["status"] == Status.RUNNING and d.get("spec_state")]
    assert len(live) == 2


def test_detector_retracts_abandoned_shadow_lease():
    """A clone that dies holding a TAKEN shadow lease must not pin the
    cap: past the threshold the detector retracts it and the straggler
    can be cloned again."""
    from lua_mapreduce_tpu_torch.engine.server import Server
    store = MemJobStore()
    server = Server(store, speculation=2.0, speculation_cap=1)
    store.put_task({"_id": "unique", "status": "MAP",
                    f"dur_ewma:{NS}": 0.01})
    _seed(store, n=2)
    store.claim_batch(NS, "w1", 2)
    time.sleep(0.03)
    server._speculate_stragglers(NS)
    victim = next(d for d in store.jobs(NS) if d.get("spec_state"))
    assert store.claim_spec(NS, "doomed-clone")["_id"] == victim["_id"]
    server._spec_scan_at.clear()
    server._speculate_stragglers(NS)        # first sighting of TAKEN
    time.sleep(0.03)                        # > threshold (2 x 0.01)
    server._spec_scan_at.clear()
    server._speculate_stragglers(NS)        # retraction pass
    doc = store.get_job(NS, victim["_id"])
    assert doc["status"] == Status.RUNNING and doc["repetitions"] == 0
    assert doc.get("spec_worker") != "doomed-clone"
    server._spec_scan_at.clear()
    server._speculate_stragglers(NS)
    clone = store.claim_spec(NS, "fresh-clone")
    assert clone is not None


def test_worker_ewma_persisted_and_seeded():
    """The per-namespace duration EWMA lands on the task doc at lease
    end, and a FRESH worker seeds its lease sizing from it."""
    from lua_mapreduce_tpu_torch.engine.server import Server
    from lua_mapreduce_tpu_torch.engine.worker import Worker
    store = MemJobStore()
    server = Server(store, poll_interval=0.01).configure(
        _spec("mem:torch-spec-ewma"))
    w = Worker(store, name="w-ewma").configure(max_iter=200, max_sleep=0.02)
    t = threading.Thread(target=w.execute, daemon=True)
    t.start()
    server.loop()
    t.join(timeout=30)
    task = store.get_task()
    assert task and task.get(f"dur_ewma:{NS}", 0) > 0
    store.update_task({"status": "MAP"})
    fresh = Worker(store, name="w-fresh")
    assert fresh._dur_ewma == {}
    fresh.poll_once()
    assert fresh._dur_ewma.get(NS) == pytest.approx(task[f"dur_ewma:{NS}"])
    # the seed's first own overshoot folds at a quarter weight
    seed = fresh._dur_ewma[NS]
    fresh._note_duration(NS, seed + 1.0)
    assert fresh._dur_ewma[NS] == pytest.approx(seed + 0.3 / 4)


def test_clone_loses_race_cancels_cleanly():
    """Worker.run_one on a clone whose original already committed: the
    race is lost, the shadow lease dissolves, spec_cancelled counts, and
    the job is untouched."""
    from lua_mapreduce_tpu_torch.engine.local import collect_task_jobs
    from lua_mapreduce_tpu_torch.engine.worker import Worker
    from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
    store = MemJobStore()
    spec = _spec("mem:torch-spec-loser")
    store.insert_jobs(NS, [make_job(k, v) for k, v in
                           collect_task_jobs(spec)])
    jid = store.claim_batch(NS, "orig", 1)[0]["_id"]
    store.speculate(NS, jid)
    w = Worker(store, name="clone-w")
    clone = store.claim_spec(NS, w.name)
    assert store.commit_batch(NS, "orig", [(jid, TIMES)]) == [jid]
    before = COUNTERS.snapshot()
    assert w.run_one(spec, NS, clone) is False
    delta = COUNTERS.delta(before, COUNTERS.snapshot())
    assert delta.get("spec_cancelled") == 1
    assert delta.get("spec_wins", 0) == 0
    doc = store.get_job(NS, jid)
    assert doc["status"] == Status.WRITTEN and doc["repetitions"] == 0
    assert not doc.get("spec_state")


def test_clone_body_failure_charges_nothing():
    """A clone whose body raises marks nothing BROKEN and bumps no
    repetition: the original still owns the lease."""
    import sys
    import types

    from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
    from lua_mapreduce_tpu_torch.engine.worker import Worker
    mod = types.ModuleType("tests._torch_spec_boom")
    mod.taskfn = lambda emit: emit("k", "v")

    def mapfn(key, value, emit):
        raise RuntimeError("clone-side user explosion")
    mod.mapfn = mapfn
    mod.partitionfn = lambda key: 0
    mod.reducefn = lambda key, values: values
    sys.modules[mod.__name__] = mod
    try:
        spec = TaskSpec(taskfn=mod.__name__, mapfn=mod.__name__,
                        partitionfn=mod.__name__, reducefn=mod.__name__,
                        init_args={"device": "cpu"},
                        storage="mem:torch-spec-boom")
        store = MemJobStore()
        store.insert_jobs(NS, [make_job("k", "v")])
        jid = store.claim_batch(NS, "orig", 1)[0]["_id"]
        store.speculate(NS, jid)
        w = Worker(store, name="boom-clone")
        assert w.run_one(spec, NS, store.claim_spec(NS, w.name)) is False
        doc = store.get_job(NS, jid)
        assert doc["status"] == Status.RUNNING and doc["repetitions"] == 0
        assert not doc.get("spec_state")
    finally:
        del sys.modules[mod.__name__]


def test_end_to_end_speculation_with_dead_original(tmp_path):
    """A worker claims a map job and dies with the lease held; with
    speculation on, a healthy worker clones the orphan and the task
    completes with ZERO repetition bumps (no stale requeue), its result
    files byte-equal to the JAX package's LocalExecutor on the same
    task."""
    from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
    from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxLocal
    from lua_mapreduce_tpu_torch.engine.server import Server
    from lua_mapreduce_tpu_torch.engine.worker import Worker
    from lua_mapreduce_tpu_torch.store.router import get_storage_from

    storage = f"shared:{tmp_path}/port"
    spec = _spec(storage)
    store = FileJobStore(str(tmp_path / "coord"))
    server = Server(store, poll_interval=0.01, speculation=3.0,
                    stale_timeout_s=600.0).configure(spec)
    final = {}
    st = threading.Thread(
        target=lambda: final.setdefault("stats", server.loop()), daemon=True)
    st.start()
    deadline = time.time() + 30
    while (store.get_task() or {}).get("status") != "MAP":
        assert time.time() < deadline, "map phase never opened"
        time.sleep(0.005)
    while not store.claim_batch(NS, "doomed", 1):      # dies holding it
        assert time.time() < deadline, "nothing claimable"
        time.sleep(0.005)
    workers = [Worker(store, name=f"h{i}").configure(max_iter=800,
                                                     max_sleep=0.02)
               for i in range(2)]
    threads = [threading.Thread(target=w.execute, daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    st.join(timeout=60)
    assert not st.is_alive(), "server wedged on the dead original"
    for t in threads:
        t.join(timeout=10)
    for d in store.jobs(NS):
        assert d["repetitions"] == 0, d
    assert final["stats"].iterations[-1].spec_wins >= 1
    JaxLocal(JaxSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                     reducefn=_MOD, storage=f"shared:{tmp_path}/jax")).run()
    port, jax = (get_storage_from(f"shared:{tmp_path}/{s}")
                 for s in ("port", "jax"))
    names = [n for n in port.list("result.P*") if n.count(".") == 1]
    assert names and names == [n for n in jax.list("result.P*")
                               if n.count(".") == 1]
    for n in names:
        assert port.read_range(n, 0, 1 << 20) == jax.read_range(n, 0, 1 << 20)


@pytest.mark.parametrize("ns", ["map_jobs", "pre_jobs", "red_jobs"])
def test_losing_duplicate_publishes_and_sweeps_nothing(tmp_path, ns):
    """A straggler whose clone committed first may still be inside its
    body when the server opens the next loop iteration, whose runs,
    spills and results reuse this iteration's names. Past its lost lease
    the body publishes nothing and sweeps nothing: every file in the
    store keeps its name and bytes."""
    from lua_mapreduce_tpu_torch.core.constants import MAP_NS, PRE_NS, RED_NS
    from lua_mapreduce_tpu_torch.engine.worker import Worker
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    assert ns in (MAP_NS, PRE_NS, RED_NS)
    storage = f"shared:{tmp_path}/spill"
    spec = _spec(storage)
    data = get_storage_from(storage)
    rns = spec.result_ns
    runs = [f"{rns}.P0.M00000000", f"{rns}.P0.M00000001"]
    for i, name in enumerate(runs):
        b = data.builder()
        b.write(f'["w{i}", [1]]\n')
        b.build(name)
    value = {MAP_NS: "w0 w1 w2",
             PRE_NS: {"part": 0, "seq": 0, "files": runs,
                      "spill": f"{rns}.P0.SPILL-00000-00001"},
             RED_NS: {"part": 0, "files": runs,
                      "result": f"{rns}.P0"}}[ns]
    store = MemJobStore()
    store.insert_jobs(ns, [make_job("d0", value)])
    job = store.claim_batch(ns, "straggler", 1)[0]
    assert store.speculate(ns, job["_id"])
    assert store.claim_spec(ns, "clone")["_id"] == job["_id"]
    assert store.commit_batch(ns, "clone", [(job["_id"], TIMES)]) == \
        [job["_id"]]

    def files():
        return {n: data.read_range(n, 0, data.size(n))
                for n in data.list("*")}
    before = files()
    w = Worker(store, name="straggler")
    w._speculation = 3.0                    # the task doc's factor
    Worker._BODIES[ns](w, spec, job)
    assert files() == before
