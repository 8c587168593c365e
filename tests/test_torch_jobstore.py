"""The port's job store against the JAX package's: the claim / status
machine, BROKEN retry and scavenge, stale requeue, heartbeats, the
ownership CAS, the batch lease (claim, commit, release, heartbeat),
preferred/steal, the errors stream and task doc, concurrent claims and
the payload-batch cache — the non-native tests of tests/test_jobstore.py
on ``MemJobStore`` and the ``FileJobStore`` (``engine="python"``, and
``"auto"``, the native index where it builds) — and the shared on-disk
format: jobs inserted by one package's ``FileJobStore`` are claimed and
committed by the other's, and their statuses read back equal."""

import threading
import time

import pytest

from lua_mapreduce_tpu.coord.filestore import FileJobStore as JaxFileStore
from lua_mapreduce_tpu.coord.jobstore import make_job as jax_make_job
from lua_mapreduce_tpu.core.constants import Status as JaxStatus
from lua_mapreduce_tpu_torch.coord import idx_py
from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.idx import open_index
from lua_mapreduce_tpu_torch.coord.idx_py import PyJobIndex
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore, make_job
from lua_mapreduce_tpu_torch.core.constants import Status

def _stores(tmp_path):
    return [MemJobStore(),
            FileJobStore(str(tmp_path / "fs-py"), engine="python"),
            FileJobStore(str(tmp_path / "fs-auto"))]


@pytest.mark.parametrize("idx", [0, 1, 2], ids=["mem", "file-py", "file-auto"])
def test_claim_and_status_machine(tmp_path, idx):
    store = _stores(tmp_path)[idx]
    ids = store.insert_jobs("map_jobs", [make_job(i, f"v{i}") for i in range(3)])
    assert ids == [0, 1, 2]

    j = store.claim("map_jobs", "w1")
    assert j is not None and j["_id"] == 0 and j["key"] == 0
    assert j["value"] == "v0"
    assert store.get_job("map_jobs", 0)["status"] == Status.RUNNING

    # double-claim cannot hand out the same job
    j2 = store.claim("map_jobs", "w2")
    assert j2["_id"] == 1

    # CAS transitions honor expectations
    assert store.set_job_status("map_jobs", 0, Status.FINISHED,
                                expect=(Status.RUNNING,))
    assert not store.set_job_status("map_jobs", 0, Status.WRITTEN,
                                    expect=(Status.RUNNING,))
    assert store.set_job_status("map_jobs", 0, Status.WRITTEN,
                                expect=(Status.FINISHED,))

    counts = store.counts("map_jobs")
    assert counts[Status.WRITTEN] == 1
    assert counts[Status.RUNNING] == 1
    assert counts[Status.WAITING] == 1


@pytest.mark.parametrize("idx", [0, 1], ids=["mem", "file-py"])
def test_broken_retry_and_scavenge(tmp_path, idx):
    store = _stores(tmp_path)[idx]
    store.insert_jobs("map_jobs", [make_job(0, "x")])
    for expected_reps in (1, 2, 3):
        j = store.claim("map_jobs", "w")
        assert j is not None
        store.set_job_status("map_jobs", 0, Status.BROKEN)
        assert store.get_job("map_jobs", 0)["repetitions"] == expected_reps
    # BROKEN is re-claimable until the scavenger fails it (3 retries)
    assert store.scavenge("map_jobs", 3) == 1
    assert store.get_job("map_jobs", 0)["status"] == Status.FAILED
    assert store.claim("map_jobs", "w") is None


@pytest.mark.parametrize("idx", [0, 1], ids=["mem", "file-py"])
def test_requeue_stale_running(tmp_path, idx):
    store = _stores(tmp_path)[idx]
    store.insert_jobs("ns", [make_job(0, "x")])
    store.claim("ns", "dead-worker")
    assert store.requeue_stale("ns", older_than_s=3600) == 0  # too young
    assert store.requeue_stale("ns", older_than_s=0.0) == 1
    j = store.get_job("ns", 0)
    assert j["status"] == Status.BROKEN and j["repetitions"] == 1
    assert store.claim("ns", "live-worker")["_id"] == 0


@pytest.mark.parametrize("idx", [0, 1], ids=["mem", "file-py"])
def test_requeue_stale_covers_finished(tmp_path, idx):
    """Regression: a worker killed between FINISHED and WRITTEN must not
    wedge the barrier — FINISHED is requeueable too."""
    store = _stores(tmp_path)[idx]
    store.insert_jobs("ns", [make_job(0, "x")])
    store.claim("ns", "w")
    store.set_job_status("ns", 0, Status.FINISHED, expect=(Status.RUNNING,))
    assert store.requeue_stale("ns", older_than_s=0.0) == 1
    assert store.get_job("ns", 0)["status"] == Status.BROKEN


@pytest.mark.parametrize("idx", [0, 1, 2], ids=["mem", "file-py", "file-auto"])
def test_heartbeat_keeps_long_job_alive(tmp_path, idx):
    """Staleness measures SILENCE, not elapsed time: a RUNNING job whose
    worker heartbeats is spared by requeue_stale however old its claim
    is, while a silent sibling is requeued (VERDICT r3 item 8)."""
    store = _stores(tmp_path)[idx]
    store.insert_jobs("ns", [make_job(0, "slow"), make_job(1, "dead")])
    store.claim("ns", "live-worker")        # job 0
    store.claim("ns", "dead-worker")        # job 1
    time.sleep(0.3)
    assert store.heartbeat("ns", 0, "live-worker")
    # cutoff 0.2s ago: both claims are 0.3s old, but job 0 beat just now
    assert store.requeue_stale("ns", older_than_s=0.2) == 1
    assert store.get_job("ns", 0)["status"] == Status.RUNNING
    assert store.get_job("ns", 1)["status"] == Status.BROKEN
    # once the beats stop, job 0 goes stale like anything else
    time.sleep(0.3)
    assert store.requeue_stale("ns", older_than_s=0.2) == 1
    assert store.get_job("ns", 0)["status"] == Status.BROKEN


@pytest.mark.parametrize("idx", [0, 1, 2], ids=["mem", "file-py", "file-auto"])
def test_heartbeat_ownership_and_state(tmp_path, idx):
    """Heartbeats are ownership-CASed like every other transition: a
    stale claimant cannot keep a re-claimed job alive, and only
    RUNNING|FINISHED jobs (the requeueable states) accept beats."""
    store = _stores(tmp_path)[idx]
    store.insert_jobs("ns", [make_job(0, "x"), make_job(1, "y")])
    store.claim("ns", "w1")                       # job 0
    assert not store.heartbeat("ns", 0, "w2")     # non-owner misses
    assert not store.heartbeat("ns", 1, "w1")     # WAITING: no beat
    assert not store.heartbeat("ns", 99, "w1")    # out of bounds
    # FINISHED still beats (covers the FINISHED→WRITTEN kill gap)
    store.set_job_status("ns", 0, Status.FINISHED, expect=(Status.RUNNING,))
    assert store.heartbeat("ns", 0, "w1")
    store.set_job_status("ns", 0, Status.WRITTEN, expect=(Status.FINISHED,))
    assert not store.heartbeat("ns", 0, "w1")     # WRITTEN: done


@pytest.mark.parametrize("idx", [0, 1, 2], ids=["mem", "file-py", "file-auto"])
def test_ownership_cas_blocks_stale_claimant(tmp_path, idx):
    """Regression: a worker whose claim was requeued and re-claimed by
    another worker must not be able to flip the job's status."""
    store = _stores(tmp_path)[idx]
    store.insert_jobs("ns", [make_job(0, "x")])
    store.claim("ns", "worker-A")
    store.requeue_stale("ns", older_than_s=0.0)     # A judged dead
    store.claim("ns", "worker-B")                   # B re-claims

    # A's late transitions miss (both finish and mark-broken paths)
    assert not store.set_job_status("ns", 0, Status.FINISHED,
                                    expect=(Status.RUNNING,),
                                    expect_worker="worker-A")
    assert not store.set_job_status("ns", 0, Status.BROKEN,
                                    expect_worker="worker-A")
    reps_before = store.get_job("ns", 0)["repetitions"]

    # B's transitions land
    assert store.set_job_status("ns", 0, Status.FINISHED,
                                expect=(Status.RUNNING,),
                                expect_worker="worker-B")
    assert store.get_job("ns", 0)["repetitions"] == reps_before


TIMES = {"started": 1.0, "finished": 2.0, "written": 3.0, "cpu": 0.5,
         "real": 2.0}


@pytest.mark.parametrize("idx", [0, 1, 2], ids=["mem", "file-py", "file-auto"])
def test_claim_batch_conformance(tmp_path, idx):
    """Batch-lease claim semantics, identical across every store: up to
    k jobs in one pass, claim order, preferred-first, steal=False
    restriction, exactly-once handout, empty result when drained."""
    store = _stores(tmp_path)[idx]
    store.insert_jobs("ns", [make_job(i, {"v": i}) for i in range(6)])

    batch = store.claim_batch("ns", "w1", k=3)
    assert [d["_id"] for d in batch] == [0, 1, 2]
    assert all(d["status"] == Status.RUNNING and d["worker"] == "w1"
               and d["value"] == {"v": d["_id"]} for d in batch)

    # preferred ids come first; steal fills the remainder
    batch = store.claim_batch("ns", "w2", k=2, preferred_ids=[5])
    assert [d["_id"] for d in batch] == [5, 3]
    # steal=False restricts to preferred (all taken -> nothing)
    assert store.claim_batch("ns", "w2", k=2, preferred_ids=[5],
                             steal=False) == []
    # k larger than what's left: partial batch, then empty
    assert [d["_id"] for d in store.claim_batch("ns", "w3", k=10)] == [4]
    assert store.claim_batch("ns", "w3", k=10) == []


@pytest.mark.parametrize("idx", [0, 1, 2], ids=["mem", "file-py", "file-auto"])
def test_commit_batch_conformance(tmp_path, idx):
    """Batch commit: RUNNING→WRITTEN with times, CASed per entry on
    ownership — a claim lost mid-lease is skipped without disturbing the
    new claimant, and the rest of the batch lands."""
    store = _stores(tmp_path)[idx]
    store.insert_jobs("ns", [make_job(i, i) for i in range(4)])
    jids = [d["_id"] for d in store.claim_batch("ns", "w1", k=3)]
    assert jids == [0, 1, 2]

    # job 1's claim is stale-requeued and re-claimed by another worker
    store.set_job_status("ns", 1, Status.BROKEN)
    assert store.claim("ns", "thief")["_id"] == 1

    # job 2 is mid-flight in the v1 crash window (FINISHED, not yet
    # WRITTEN): commit_batch must retire RUNNING and FINISHED alike —
    # identical across every store — instead of leaving it for the
    # stale requeue to re-execute completed work
    assert store.set_job_status("ns", 2, Status.FINISHED,
                                expect=(Status.RUNNING,),
                                expect_worker="w1")
    done = store.commit_batch("ns", "w1", [(j, TIMES) for j in jids])
    assert done == [0, 2]
    for jid in (0, 2):
        doc = store.get_job("ns", jid)
        assert doc["status"] == Status.WRITTEN
        assert doc["times"] == TIMES
    assert store.get_job("ns", 1)["status"] == Status.RUNNING
    # the thief's own commit still lands
    assert store.commit_batch("ns", "thief", [(1, TIMES)]) == [1]
    counts = store.counts("ns")
    assert counts[Status.WRITTEN] == 3 and counts[Status.WAITING] == 1


@pytest.mark.parametrize("idx", [0, 1, 2], ids=["mem", "file-py", "file-auto"])
def test_release_batch_returns_unstarted_jobs(tmp_path, idx):
    """A batch aborted partway releases its unstarted tail: RUNNING →
    WAITING on ownership, repetitions untouched (the jobs never ran, so
    they must not creep toward the scavenger's FAILED threshold)."""
    store = _stores(tmp_path)[idx]
    store.insert_jobs("ns", [make_job(i, i) for i in range(3)])
    store.claim_batch("ns", "w1", k=3)
    assert store.release_batch("ns", "other", [1, 2]) == 0   # non-owner
    assert store.release_batch("ns", "w1", [1, 2]) == 2
    for jid in (1, 2):
        doc = store.get_job("ns", jid)
        assert doc["status"] == Status.WAITING
        assert doc["repetitions"] == 0
    # released jobs are immediately re-claimable
    assert store.claim("ns", "w2")["_id"] == 1


@pytest.mark.parametrize("idx", [0, 1, 2], ids=["mem", "file-py", "file-auto"])
def test_heartbeat_batch_beats_whole_lease(tmp_path, idx):
    """One beat refreshes every leased job this worker still owns; jobs
    already committed or re-claimed simply miss."""
    store = _stores(tmp_path)[idx]
    store.insert_jobs("ns", [make_job(i, i) for i in range(4)])
    jids = [d["_id"] for d in store.claim_batch("ns", "w1", k=3)]
    store.commit_batch("ns", "w1", [(0, TIMES)])      # retired early
    assert store.heartbeat_batch("ns", jids, "w1") == 2
    assert store.heartbeat_batch("ns", jids, "other") == 0
    time.sleep(0.25)
    assert store.heartbeat_batch("ns", [1], "w1") == 1
    # job 1 beat just now survives the requeue; job 2's last signal is
    # the claim itself — each lease member is judged INDEPENDENTLY
    assert store.requeue_stale("ns", older_than_s=0.2) == 1
    assert store.get_job("ns", 1)["status"] == Status.RUNNING
    assert store.get_job("ns", 2)["status"] == Status.BROKEN


def test_cas_on_dropped_namespace_is_false(tmp_path):
    """Regression: straggler CAS after drop_ns returns False (both store
    kinds), never raises."""
    for store in _stores(tmp_path)[:2]:
        store.insert_jobs("ns", [make_job(0, "x")])
        store.claim("ns", "w")
        store.drop_ns("ns")
        assert store.set_job_status("ns", 0, Status.FINISHED,
                                    expect=(Status.RUNNING,)) is False
        store.set_job_times("ns", 0, {"started": 0, "finished": 0,
                                      "written": 0, "cpu": 0, "real": 0})


@pytest.mark.parametrize("idx", [0, 1], ids=["mem", "file-py"])
def test_preferred_and_steal(tmp_path, idx):
    store = _stores(tmp_path)[idx]
    store.insert_jobs("ns", [make_job(i, i) for i in range(4)])
    j = store.claim("ns", "w", preferred_ids=[2])
    assert j["_id"] == 2
    # preferred taken, no steal → nothing
    assert store.claim("ns", "w", preferred_ids=[2], steal=False) is None
    # steal allowed → first free
    assert store.claim("ns", "w", preferred_ids=[2], steal=True)["_id"] == 0


def test_errors_stream_and_task_doc(tmp_path):
    for store in _stores(tmp_path)[:2]:
        store.put_task({"_id": "unique", "status": "WAIT", "iteration": 1})
        store.update_task({"status": "MAP"})
        assert store.get_task()["status"] == "MAP"

        store.insert_error("w1", "boom")
        store.insert_error("w2", "bang")
        errs = store.drain_errors()
        assert [e["worker"] for e in errs] == ["w1", "w2"]
        assert store.drain_errors() == []

        store.delete_task()
        assert store.get_task() is None


def test_concurrent_claims_are_exclusive(tmp_path):
    """N threads hammering claim() must hand out each job exactly once."""
    store = FileJobStore(str(tmp_path / "conc"))
    n_jobs, n_workers = 40, 8
    store.insert_jobs("ns", [make_job(i, i) for i in range(n_jobs)])
    claimed = []
    lock = threading.Lock()

    def grab(wid):
        while True:
            j = store.claim("ns", f"w{wid}")
            if j is None:
                return
            with lock:
                claimed.append(j["_id"])

    threads = [threading.Thread(target=grab, args=(i,)) for i in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(claimed) == list(range(n_jobs))  # no dup, no loss


def test_batched_inserts_reference_fanin_scale(tmp_path):
    """Reference fan-in scale (README.md:59: ~2,000 map jobs / 1,970 run
    files -> 10 reduces): inserting 2,000 jobs must write O(batches)
    control-plane files, not one payload file per job (cnn.lua:80-111
    batched-insert analog), and claims must read the right payloads back
    across a fresh store instance (another process's view)."""
    import os
    import time

    store = FileJobStore(str(tmp_path))
    n = 2000
    t0 = time.perf_counter()
    ids = store.insert_jobs("map_jobs", [make_job(f"k{i}", {"split": i})
                                         for i in range(n)])
    insert_dt = time.perf_counter() - t0
    assert ids == list(range(n))

    ns_dir = os.path.join(str(tmp_path), "map_jobs.d")
    batch_files = [f for f in os.listdir(ns_dir) if f.startswith("b")]
    assert len(batch_files) == 1, batch_files  # 2,000 < MAX_PENDING_INSERTS
    assert insert_dt < 5.0, f"2,000-job insert took {insert_dt:.2f}s"

    # another process's store: payloads resolve through the manifest
    store2 = FileJobStore(str(tmp_path))
    t0 = time.perf_counter()
    seen = set()
    for _ in range(n):
        doc = store2.claim("map_jobs", "w1")
        assert doc is not None
        assert doc["value"] == {"split": doc["_id"]}
        seen.add(doc["_id"])
    claim_dt = time.perf_counter() - t0
    assert seen == set(range(n))
    assert store2.claim("map_jobs", "w1") is None
    # claims stay cheap: amortized well under a millisecond of payload
    # overhead each (the index CAS dominates)
    assert claim_dt < 30.0, f"2,000 claims took {claim_dt:.2f}s"


def test_batch_cache_not_stale_across_loop_reinsert(tmp_path):
    """The "loop" protocol drops and re-inserts a namespace each
    iteration; a long-lived worker-side store instance must see the NEW
    payloads, not its cached previous-iteration batch."""
    server_store = FileJobStore(str(tmp_path))
    worker_store = FileJobStore(str(tmp_path))

    server_store.insert_jobs("map_jobs", [make_job("a", {"it": 1})])
    doc = worker_store.claim("map_jobs", "w")
    assert doc["value"] == {"it": 1}

    server_store.drop_ns("map_jobs")
    server_store.insert_jobs("map_jobs", [make_job("a", {"it": 2})])
    doc = worker_store.claim("map_jobs", "w")
    assert doc["value"] == {"it": 2}, "stale payload from dropped iteration"


def test_multi_batch_chunking(tmp_path, monkeypatch):
    """Inserts above MAX_PENDING_INSERTS split into multiple manifests
    (flush threshold, cnn.lua:80-96)."""
    import os

    from lua_mapreduce_tpu_torch.coord import filestore
    monkeypatch.setattr(filestore, "MAX_PENDING_INSERTS", 64)
    store = FileJobStore(str(tmp_path))
    store.insert_jobs("map_jobs", [make_job(i, i) for i in range(200)])
    ns_dir = os.path.join(str(tmp_path), "map_jobs.d")
    batches = sorted(f for f in os.listdir(ns_dir) if f.startswith("b"))
    assert len(batches) == 4       # 64+64+64+8
    fresh = FileJobStore(str(tmp_path))
    assert fresh.get_job("map_jobs", 170)["value"] == 170
    assert fresh.get_job("map_jobs", 0)["value"] == 0


def test_payload_cache_isolated_from_caller_mutation(tmp_path):
    """A claimant mutating job['value'] in place must not poison the
    process-wide payload cache — the retry path depends on re-reading the
    original payload (code-review r2 finding)."""
    store = FileJobStore(str(tmp_path))
    store.insert_jobs("map_jobs", [make_job("k", {"split": 7, "xs": [1]})])
    doc = store.claim("map_jobs", "w1")
    doc["value"].pop("split")
    doc["value"]["xs"].append(2)
    again = store.get_job("map_jobs", 0)
    assert again["value"] == {"split": 7, "xs": [1]}


def test_crash_orphaned_manifest_is_superseded(tmp_path):
    """A manifest written by a crashed insert (no idx.insert committed)
    must not shadow a later insert's payloads, and duplicate bases must
    not break payload resolution (code-review r2 finding)."""
    import json
    import os

    store = FileJobStore(str(tmp_path))
    ns_dir = os.path.join(str(tmp_path), "map_jobs.d")
    os.makedirs(ns_dir, exist_ok=True)
    # simulate: crash landed b0_3.json but never inserted index records
    with open(os.path.join(ns_dir, "b0_3.json"), "w") as f:
        json.dump([{"key": "stale", "value": i} for i in range(3)], f)

    store.insert_jobs("map_jobs", [make_job("fresh", {"n": i})
                                   for i in range(2)])
    fresh = FileJobStore(str(tmp_path))
    got = fresh.claim("map_jobs", "w")
    assert got["key"] == "fresh"
    assert got["value"] in ({"n": 0}, {"n": 1})
    names = sorted(f for f in os.listdir(ns_dir) if f.startswith("b"))
    assert names == ["b0_2.json"], names


def test_mem_store_claim_timestamps_decided_before_lock():
    """Lease stamps come from one clock read per batch (hoisted above
    the lock — lint rule LMR004): every job of one claim_batch carries
    the identical started_time."""
    store = MemJobStore()
    store.insert_jobs("map_jobs", [make_job(i, i) for i in range(4)])
    docs = store.claim_batch("map_jobs", "w1", k=4)
    assert len(docs) == 4
    assert len({d["started_time"] for d in docs}) == 1


# ---------------------------------------------------------------------------
# the port's own surface: engines, trimmed operations, the shared format
# ---------------------------------------------------------------------------

def test_index_engines(tmp_path, monkeypatch):
    """"auto" resolves to the native index where it builds (g++ here),
    as the JAX package's auto does, and to the Python index under
    LMR_DISABLE_NATIVE=1, where "native" raises; the layout constants
    are the JAX package's JSIX0003."""
    from lua_mapreduce_tpu.coord import idx_py as jax_idx_py
    from lua_mapreduce_tpu_torch.coord.idx import NativeJobIndex
    from lua_mapreduce_tpu_torch.faults.errors import NativeEngineError
    assert type(open_index(str(tmp_path / "a.idx"), "auto")) \
        is NativeJobIndex
    assert type(open_index(str(tmp_path / "p.idx"), "python")) is PyJobIndex
    assert type(open_index(str(tmp_path / "n.idx"), "native")) \
        is NativeJobIndex
    FileJobStore(str(tmp_path / "fs"), engine="native")
    monkeypatch.setenv("LMR_DISABLE_NATIVE", "1")
    assert type(open_index(str(tmp_path / "a.idx"), "auto")) is PyJobIndex
    with pytest.raises(NativeEngineError, match="LMR_DISABLE_NATIVE"):
        open_index(str(tmp_path / "n.idx"), "native")
    with pytest.raises(NativeEngineError):
        FileJobStore(str(tmp_path / "fs2"), engine="native")
    with pytest.raises(ValueError):
        open_index(str(tmp_path / "x.idx"), "fast")
    assert (idx_py.MAGIC, idx_py.HEADER_SIZE, idx_py.RECORD_SIZE) == \
        (jax_idx_py.MAGIC, jax_idx_py.HEADER_SIZE, jax_idx_py.RECORD_SIZE)
    assert [int(s) for s in Status] == [int(s) for s in JaxStatus]


@pytest.mark.parametrize("idx", [0, 1], ids=["mem", "file-py"])
def test_speculation_is_not_ported(tmp_path, idx):
    """Duplicate leases are ported now: the calls that raised run the
    speculation lifecycle (tests/test_torch_speculation.py has the
    rest)."""
    store = _stores(tmp_path)[idx]
    store.insert_jobs("ns", [make_job(0, "x")])
    store.claim("ns", "w")
    assert store.speculate("ns", 0)
    assert store.claim_spec("ns", "w2")["_id"] == 0
    assert store.cancel_spec("ns", 0, "w2")
    assert not store.cancel_spec("ns", 0, "w2")


def _statuses(store, ns):
    return [(int(d["status"]), d["repetitions"], d["worker"])
            for d in store.jobs(ns)]


@pytest.mark.parametrize("inserter", ["port", "jax"])
def test_each_package_claims_and_commits_the_others_jobs(tmp_path,
                                                         inserter):
    """One directory, two packages: jobs inserted by one package's
    FileJobStore are claimed, committed, broken and released by the
    other's, and both read back the same statuses, repetitions, workers,
    payloads and times — the on-disk format is shared."""
    root = str(tmp_path / "coord")
    port, jax = FileJobStore(root, engine="python"), \
        JaxFileStore(root, engine="python")
    ins, other = (port, jax) if inserter == "port" else (jax, port)
    mk = make_job if inserter == "port" else jax_make_job
    ins.insert_jobs("map_jobs", [mk(i, {"split": i}) for i in range(5)])
    ins.put_task({"_id": "unique", "status": "MAP", "iteration": 1})
    assert other.get_task()["status"] == "MAP"

    got = other.claim_batch("map_jobs", "w-other", k=3)
    assert [d["_id"] for d in got] == [0, 1, 2]
    assert [d["value"] for d in got] == [{"split": i} for i in range(3)]
    times = {"started": 1.0, "finished": 2.0, "written": 3.0, "cpu": 0.5,
             "real": 2.0}
    assert other.commit_batch("map_jobs", "w-other",
                              [(0, times), (1, times)]) == [0, 1]
    assert other.set_job_status("map_jobs", 2, Status.BROKEN,
                                expect=(Status.RUNNING,),
                                expect_worker="w-other")
    # the inserter's side claims the BROKEN job and one fresh job, and
    # releases one of them unstarted
    back = ins.claim_batch("map_jobs", "w-ins", k=2)
    assert [d["_id"] for d in back] == [2, 3]
    assert back[0]["repetitions"] == 1
    assert ins.release_batch("map_jobs", "w-ins", [3]) == 1
    assert _statuses(port, "map_jobs") == _statuses(jax, "map_jobs") == [
        (int(Status.WRITTEN), 0, "w-other"), (int(Status.WRITTEN), 0,
                                              "w-other"),
        (int(Status.RUNNING), 1, "w-ins"), (int(Status.WAITING), 0, "w-ins"),
        (int(Status.WAITING), 0, None)]
    assert port.get_job("map_jobs", 0)["times"] == \
        jax.get_job("map_jobs", 0)["times"] == times
    assert {int(k): v for k, v in port.counts("map_jobs").items()} == \
        {int(k): v for k, v in jax.counts("map_jobs").items()}
    # a stale requeue by either side is seen by both
    assert other.requeue_stale("map_jobs", older_than_s=0.0) == 1
    assert port.get_job("map_jobs", 2)["status"] == Status.BROKEN
    assert jax.get_job("map_jobs", 2)["repetitions"] == 2
    other.insert_error("w-other", "boom", info={"job_id": 2})
    assert [e["msg"] for e in ins.drain_errors()] == ["boom"]
