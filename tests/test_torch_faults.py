"""The port's fault plane (``faults/``) ≡ the JAX package's: the error
taxonomy, ``RetryPolicy``'s decorrelated-jitter delays on the same
seeded rng, ``FaultPlan`` decisions over a grid of (op, name,
occurrence), deterministic injection, build readback-verify, the
worker's release-not-broken discrimination, and the counters folded
into ``IterationStats``. Counterparts of ``tests/test_faults.py``; its
replica, blackout and scavenger tests have theirs in
``tests/test_torch_replicate.py``."""

import errno
import random
import time

import pytest

from lua_mapreduce_tpu.faults import errors as jax_errors
from lua_mapreduce_tpu.faults.plan import FaultPlan as JaxPlan
from lua_mapreduce_tpu.faults.retry import RetryPolicy as JaxPolicy
from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.jobstore import (JobStore, MemJobStore,
                                                    make_job)
from lua_mapreduce_tpu_torch.core.constants import (MAX_JOB_RETRIES,
                                                    Status, TaskStatus)
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.worker import Worker
from lua_mapreduce_tpu_torch.faults import (COUNTERS, FaultPlan,
                                            FaultyJobStore, FaultyStore,
                                            InjectedFault,
                                            PermanentStoreError,
                                            RetryingJobStore, RetryingStore,
                                            RetryPolicy, TransientStoreError,
                                            install_fault_plan, unwrap)
from lua_mapreduce_tpu_torch.faults import errors
from lua_mapreduce_tpu_torch.faults.plan import RPC_OPS
from lua_mapreduce_tpu_torch.store.memfs import MemStore
from lua_mapreduce_tpu_torch.store.router import get_storage_from

CPU = {"device": "cpu"}


def _policy(retries=3):
    return RetryPolicy(retries=retries, base_ms=1, sleep=lambda s: None,
                       rng=random.Random(0))


# --- cross-package parity ----------------------------------------------------

class _Gcs503(Exception):
    code = 503


@pytest.mark.parametrize("exc", [
    TimeoutError(), ConnectionResetError(), OSError(errno.EIO, "eio"),
    OSError("no errno"), OSError(errno.ENOSPC, "full"),
    FileNotFoundError("x"), PermissionError("x"), KeyError("k"),
    ValueError("user"), RuntimeError("logic"), _Gcs503(),
    type("ServiceUnavailable", (Exception,), {})(),
], ids=lambda e: type(e).__name__)
def test_classification_table_equals_jax(exc):
    assert errors.classify_exception(exc) == \
        jax_errors.classify_exception(exc)
    assert errors.classify_job_fault(exc) == \
        jax_errors.classify_job_fault(exc)


def test_taxonomy_classes_match_jax():
    for name in ("StoreError", "TransientStoreError", "PermanentStoreError",
                 "InjectedFault", "InjectedPermanentFault", "NoTaskError",
                 "ConcurrentInsertError", "LostShuffleDataError"):
        port, jax = getattr(errors, name), getattr(jax_errors, name)
        assert port.transient == jax.transient, name
        assert [c.__name__ for c in port.__mro__] == \
            [c.__name__ for c in jax.__mro__], name
    lost = errors.LostShuffleDataError("m", files=["a"], op="reduce")
    assert lost.lost_files == ["a"] and lost.transient


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_retry_delays_equal_jax_on_the_same_rng(seed):
    port, jax = [], []
    for cls, out in ((RetryPolicy, port), (JaxPolicy, jax)):
        p = cls(retries=8, base_ms=20, cap_ms=400, sleep=out.append,
                rng=random.Random(seed))
        with pytest.raises(Exception):
            p.call(lambda: (_ for _ in ()).throw(TimeoutError("x")),
                   op="size", name="f")
    assert len(port) == 8 and port == jax


_GRID_OPS = ["read_range", "lines", "size", "exists", "remove", "list",
             "build", "claim_batch", "commit_batch", "update_task",
             "counts", "heartbeat_batch"]


@pytest.mark.parametrize("spec", [
    "seed=7;transient=0.3;latency=0.1;max_per_key=3",
    "seed=31;transient=0.05;error_after_write=0.2;torn=0.15;"
    "rpc_transient=0.1;latency_ms=1;max_per_key=2",
    "seed=5;permanent=0.2;pattern=r.P*.M*|r.P*.SPILL-*;max_per_key=100",
])
def test_fault_plan_decisions_equal_jax(spec):
    port = FaultPlan.from_spec(spec)
    jax = JaxPlan.from_spec(spec)
    assert port.to_spec() == jax.to_spec()
    names = ["r.P0.M00000001", "r.P3.SPILL-00000-00004", "r.P1",
             "map_jobs", "red_jobs", "_trace.w.000000"]
    for occ in range(12):
        for op in _GRID_OPS:
            for name in names:
                assert port.decide(op, name) == jax.decide(op, name), \
                    (op, name, occ)
    assert port.fired == jax.fired


def test_rpc_ops_name_only_existing_jobstore_methods():
    assert RPC_OPS <= {m for m in dir(JobStore) if not m.startswith("_")}
    store = MemJobStore()
    for op, args in (("speculate", ("map_jobs", 0)),
                     ("claim_spec", ("map_jobs", "w")),
                     ("cancel_spec", ("map_jobs", 0, "w"))):
        assert op not in RPC_OPS
        with pytest.raises(NotImplementedError, match="A6b"):
            getattr(store, op)(*args)


def test_blackout_plan_matches_jax():
    """The blackout kind is ported: the plan parses as JAX's does, a
    FaultyStore under it is no longer refused, and on a virtual clock
    its decisions equal JAX's — the dark tag's data-plane ops fail
    transient inside the window, uncapped, and nothing else does."""
    from lua_mapreduce_tpu.engine.placement import tag_of as jax_tag_of
    from lua_mapreduce_tpu_torch.engine.placement import (replica_name,
                                                          tag_of)
    spec = "seed=5;blackout_tag=3;blackout_s=0.25;blackout_from_s=0.1"
    plan = FaultPlan.from_spec(spec)
    assert plan.to_spec() == JaxPlan.from_spec(spec).to_spec()
    raw = MemStore()
    with raw.builder() as b:
        b.write("x\n")
        b.build("f")
    assert FaultyStore(raw, plan).exists("f")
    names = [f"ns.P{p}.M{m:08d}" for p in range(3) for m in range(12)]
    names += [replica_name(n, 1) for n in names]
    assert [tag_of(n) for n in names] == [jax_tag_of(n) for n in names]
    for t, op in ((0.0, "read_range"), (0.1, "lines"), (0.2, "size"),
                  (0.3, "exists"), (0.34, "remove"), (0.36, "build")):
        clock = [0.0]
        port = FaultPlan(7, blackout_tag=3, blackout_s=0.25,
                         blackout_from_s=0.1, clock=lambda: clock[0],
                         sleep=lambda s: None)
        jax = JaxPlan(7, blackout_tag=3, blackout_s=0.25,
                      blackout_from_s=0.1, clock=lambda: clock[0],
                      sleep=lambda s: None)
        for _ in range(3):          # uncapped inside the window
            got = [port.decide(op, n) for n in names]
            assert got == [jax.decide(op, n) for n in names]
            clock[0] = t
        assert port.fired == jax.fired
        assert (port.fired.get("blackout", 0) > 0) == \
            (op != "build" and 0.1 <= t < 0.35)


def test_blackout_env_plan_darkens_tag(monkeypatch):
    """An ``LMR_FAULT_PLAN`` blackout reaches every store the router
    builds: a file on the dark tag is unreadable through it (the retry
    budget exhausts on the uncapped transient), others read."""
    from lua_mapreduce_tpu_torch.engine.placement import tag_of
    names = [f"f{i}" for i in range(40)]
    dark = next(n for n in names if tag_of(n) == 2)
    lit = next(n for n in names if tag_of(n) != 2)
    monkeypatch.setenv("LMR_FAULT_PLAN", "seed=1;blackout_tag=2;"
                                         "blackout_s=3600")
    monkeypatch.setenv("LMR_RETRY_BASE_MS", "1")
    store = get_storage_from("mem:_tfault_blackout")
    raw = unwrap(store)
    for n in (dark, lit):
        with raw.builder() as b:
            b.write("x\n")
            b.build(n)
    assert store.size(lit) == 2
    with pytest.raises(TransientStoreError):
        store.size(dark)


# --- retry schedule on a virtual clock --------------------------------------

def test_backoff_is_decorrelated_jitter_and_capped():
    sleeps = []
    p = RetryPolicy(retries=6, base_ms=20, cap_ms=100,
                    sleep=sleeps.append, rng=random.Random(3))
    with pytest.raises(TransientStoreError):
        p.call(lambda: (_ for _ in ()).throw(TimeoutError("x")),
               op="size", name="f")
    assert len(sleeps) == 6
    assert all(0.02 <= s <= 0.1 for s in sleeps)
    assert sleeps != sorted(sleeps, reverse=True)


def test_retry_layer_never_retries_permanent_or_user_errors():
    calls = [0]

    def boom():
        calls[0] += 1
        raise FileNotFoundError("gone")

    with pytest.raises(FileNotFoundError):
        _policy().call(boom, op="lines", name="f")
    assert calls[0] == 1


def test_retry_settings_env_and_configure(monkeypatch):
    from lua_mapreduce_tpu_torch.faults.retry import (configure_retry,
                                                      retry_settings)
    monkeypatch.setenv("LMR_STORE_RETRIES", "5")
    monkeypatch.setenv("LMR_RETRY_BASE_MS", "7.5")
    assert retry_settings() == {"retries": 5, "base_ms": 7.5}
    configure_retry(2, 1.0)
    try:
        assert retry_settings() == {"retries": 2, "base_ms": 1.0}
    finally:
        configure_retry(None, None)
    monkeypatch.setenv("LMR_STORE_RETRIES", "x")
    with pytest.raises(ValueError, match="LMR_STORE_RETRIES"):
        retry_settings()


# --- deterministic injection through a routed store -------------------------

def test_env_plan_activates_and_deactivates(monkeypatch):
    monkeypatch.setenv("LMR_FAULT_PLAN",
                       "seed=11;transient=0.4;max_per_key=2")
    s1 = get_storage_from("mem:_tfault_env_t")
    assert isinstance(s1, RetryingStore)
    assert isinstance(s1._inner, FaultyStore)
    monkeypatch.delenv("LMR_FAULT_PLAN")
    s2 = get_storage_from("mem:_tfault_env_t")
    assert isinstance(s2, RetryingStore)
    assert not isinstance(s2._inner, FaultyStore)
    assert unwrap(s1) is unwrap(s2)


def test_injected_bursts_are_absorbed_end_to_end():
    plan = FaultPlan(21, transient=0.3, latency=0.1, latency_ms=0.0,
                     max_per_key=2, sleep=lambda s: None)
    install_fault_plan(plan)
    try:
        store = get_storage_from("mem:_tfault_burst_t")
        with store.builder() as b:
            b.write("x 1\n")
            b.build("runs.P0.M1")
        for _ in range(30):
            assert list(store.lines("runs.P0.M1")) == ["x 1\n"]
            assert store.exists("runs.P0.M1")
            assert store.list("runs.*") == ["runs.P0.M1"]
    finally:
        install_fault_plan(None)
    assert plan.total_fired() > 0


def test_error_after_write_never_duplicates_published_segment():
    raw = MemStore()
    plan = FaultPlan(31, error_after_write=1.0, max_per_key=1,
                     sleep=lambda s: None)
    store = RetryingStore(FaultyStore(raw, plan), _policy())
    with store.builder() as b:
        b.write("v1 line\n")
        b.build("seg")
    assert list(raw.lines("seg")) == ["v1 line\n"]
    assert plan.fired == {"error_after_write": 1}


def test_torn_write_detected_and_rebuilt_whole():
    plan = FaultPlan(32, torn=1.0, max_per_key=1, sleep=lambda s: None)
    raw = MemStore()
    store = RetryingStore(FaultyStore(raw, plan), _policy())
    with store.builder() as b:
        for i in range(50):
            b.write(f"record {i:04d}\n")
        b.build("spill")
    assert len(list(raw.lines("spill"))) == 50
    assert raw.size("spill") == 50 * len("record 0000\n")


def test_no_replay_retention_on_atomic_publish_backends(tmp_path):
    from lua_mapreduce_tpu_torch.store.objectfs import ObjectStore
    from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore
    policy = _policy()
    for raw in (MemStore(), SharedStore(str(tmp_path / "s")),
                ObjectStore(str(tmp_path / "o"))):
        b = RetryingStore(raw, policy).builder()
        b.write("x\n")
        assert b._chunks is None, type(raw).__name__
        b.close()
    b = RetryingStore(FaultyStore(MemStore(), FaultPlan(1)),
                      policy).builder()
    b.write("x\n")
    assert b._chunks == ["x\n"]
    b.close()


def test_replay_cap_surfaces_a_classified_transient(monkeypatch):
    """Past REPLAY_CAP_BYTES the builder keeps no replay bytes: a
    transient build failure then surfaces as a TransientStoreError the
    worker releases (no repetition charge)."""
    from lua_mapreduce_tpu_torch.faults import wrappers
    monkeypatch.setattr(wrappers, "REPLAY_CAP_BYTES", 16)
    plan = FaultPlan(3, torn=1.0, max_per_key=1, sleep=lambda s: None)
    store = RetryingStore(FaultyStore(MemStore(), plan), _policy())
    b = store.builder()
    b.write("x" * 64)
    with pytest.raises(TransientStoreError, match="replay cap"):
        b.build("big")


def test_jobstore_rpc_injection_and_retry():
    js = MemJobStore()
    js.insert_jobs("map_jobs", [make_job("k", 1)])
    plan = FaultPlan(6, rpc_transient=0.7, max_per_key=4,
                     sleep=lambda s: None)
    wrapped = RetryingJobStore(FaultyJobStore(js, plan), _policy())
    assert "claim_batch" not in RetryingJobStore.__dict__
    got = []
    for _ in range(8):
        try:
            got = wrapped.claim_batch("map_jobs", "w1", 1)
            break
        except InjectedFault:
            continue
    assert len(got) == 1
    assert wrapped.commit_batch("map_jobs", "w1",
                                [(got[0]["_id"], None)]) == [got[0]["_id"]]
    assert unwrap(wrapped) is js


# --- worker fault discrimination --------------------------------------------

def _spec(mapfn, tag):
    return TaskSpec(taskfn=lambda emit: emit("k", 1), mapfn=mapfn,
                    partitionfn=lambda key: 0,
                    reducefn=lambda key, values: sum(values),
                    storage=f"mem:{tag}", init_args=dict(CPU))


@pytest.mark.parametrize("exc,status,reps,classification", [
    (TransientStoreError("503 burst"), Status.WAITING, 0,
     "infra-transient"),
    (PermanentStoreError("bucket gone"), Status.BROKEN, 1,
     "infra-permanent"),
    (ValueError("user bug"), Status.BROKEN, 1, "user-code"),
    (TimeoutError("user timeout"), Status.BROKEN, 1, "user-code"),
], ids=["transient-releases", "permanent-breaks", "user-code-breaks",
        "raw-builtin-is-user-code"])
def test_worker_discriminates_infra_from_user_faults(exc, status, reps,
                                                     classification):
    store = MemJobStore()
    w = Worker(store, name="wdisc")
    w.heartbeat_s = 0

    def mapfn(key, value, emit):
        raise exc

    store.insert_jobs("map_jobs", [make_job("k", 1)])
    jobs = w.store.claim_batch("map_jobs", w.name, 1)
    with pytest.raises(type(exc)):
        w._execute_batch(_spec(mapfn, f"twdisc-{classification}"),
                         "map_jobs", jobs)
    d = store.get_job("map_jobs", 0)
    assert d["status"] == status and d["repetitions"] == reps
    (err,) = store.drain_errors()
    assert err["classification"] == classification
    assert err["exc_class"] == type(exc).__name__
    assert err["ns"] == "map_jobs" and err["job_id"] == 0


def test_release_budget_bounds_pinned_transient_faults():
    store = MemJobStore()
    store.insert_jobs("map_jobs", [make_job("k", 1)])
    w = Worker(store, name="wbudget")
    w.heartbeat_s = 0

    def mapfn(key, value, emit):
        raise TransientStoreError("pinned fault")

    spec = _spec(mapfn, "twbudget")
    for attempt in range(MAX_JOB_RETRIES + 1):
        jobs = w.store.claim_batch("map_jobs", "wbudget", 1)
        assert jobs
        with pytest.raises(TransientStoreError):
            w._execute_batch(spec, "map_jobs", jobs)
        d = store.get_job("map_jobs", 0)
        if attempt < MAX_JOB_RETRIES:
            assert d["status"] == Status.WAITING and d["repetitions"] == 0
        else:
            assert d["status"] == Status.BROKEN and d["repetitions"] == 1


def test_worker_poll_loop_survives_coord_brownout(monkeypatch):
    store = MemJobStore()
    store.insert_jobs("map_jobs", [make_job("k", 1)])
    w = Worker(store, name="wpoll")
    w.heartbeat_s = 0
    monkeypatch.setattr(time, "sleep", lambda s: None)
    n = {"n": 0}
    real_poll = w.poll_once

    def flaky_poll():
        n["n"] += 1
        if n["n"] <= 5:
            raise TransientStoreError("claim brownout")
        return real_poll()

    monkeypatch.setattr(w, "poll_once", flaky_poll)
    w.configure(max_iter=3, max_sleep=0.01)
    w.execute()
    assert n["n"] > 5
    monkeypatch.setattr(
        w, "poll_once",
        lambda: (_ for _ in ()).throw(TransientStoreError("dead store")))
    with pytest.raises(TransientStoreError):
        w.execute()


def test_release_preserves_batch_commit_prefix():
    store = MemJobStore()
    store.insert_jobs("map_jobs", [make_job(f"k{i}", i) for i in range(3)])
    w = Worker(store, name="wbatch")
    w.heartbeat_s = 0
    jobs = w.store.claim_batch("map_jobs", "wbatch", 3)
    calls = [0]

    def mapfn(key, value, emit):
        calls[0] += 1
        if calls[0] == 2:
            raise TransientStoreError("mid-lease blip")
        emit("n", value)

    with pytest.raises(TransientStoreError):
        w._execute_batch(_spec(mapfn, "twbatch"), "map_jobs", jobs)
    assert [store.get_job("map_jobs", i)["status"] for i in range(3)] == \
        [Status.WRITTEN, Status.WAITING, Status.WAITING]


def test_release_budget_resets_per_task_iteration():
    store = MemJobStore()
    w = Worker(store, name="wgen")
    spec = TaskSpec(taskfn="examples.wordcount.taskfn",
                    mapfn="examples.wordcount.mapfn",
                    partitionfn="examples.wordcount.partitionfn",
                    reducefn="examples.wordcount.reducefn",
                    storage="mem:twgen", init_args=dict(CPU))
    store.put_task({"_id": "unique", "status": TaskStatus.MAP.value,
                    "iteration": 1, "spec": spec.describe(),
                    "pipeline": True, "batch_k": 1,
                    "segment_format": "v2"})
    assert w.poll_once() == "idle"
    w._infra_released[("map_jobs", 0)] = 3
    assert w.poll_once() == "idle"
    assert w._infra_released == {("map_jobs", 0): 3}
    store.update_task({"iteration": 2})
    assert w.poll_once() == "idle"
    assert w._infra_released == {}


# --- errors stream, ranged-read degradation, counters ------------------------

def test_filestore_errors_carry_classification_fields(tmp_path):
    fs = FileJobStore(str(tmp_path / "coord"))
    fs.insert_error("w1", "Traceback ...",
                    info={"exc_class": "TimeoutError",
                          "classification": "infra-transient",
                          "ns": "map_jobs", "job_id": 7})
    (err,) = fs.drain_errors()
    assert err["classification"] == "infra-transient"
    assert err["job_id"] == 7 and err["worker"] == "w1"


class _RangedFlakyStore:
    def __init__(self, inner):
        self._inner = inner
        self.ranged_attempts = 0

    def read_range(self, name, offset, length):
        if offset > 0:
            self.ranged_attempts += 1
            raise TransientStoreError(f"ranged read {offset}+{length}")
        return self._inner.read_range(name, offset, length)

    def classify(self, exc):
        return self._inner.classify(exc)

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


def test_segment_reader_degrades_to_whole_file_read():
    from lua_mapreduce_tpu_torch.core.segment import (record_stream,
                                                      writer_for)
    raw = MemStore()
    recs = [(f"k{i:03d}", [i]) for i in range(200)]
    with writer_for(raw, "v2") as wtr:
        for k, v in recs:
            wtr.add(k, v)
        wtr.build("seg")
    before = COUNTERS.snapshot().get("degraded_reads", 0)
    flaky = _RangedFlakyStore(raw)
    assert list(record_stream(flaky, "seg")) == recs
    assert flaky.ranged_attempts == 1
    assert COUNTERS.snapshot().get("degraded_reads", 0) == before + 1


class _MidStreamFlakyStore:
    def __init__(self, inner, records):
        self._inner = inner
        self.records = records
        self.opens = 0

    def lines(self, name):
        self.opens += 1
        if self.opens == 1:
            raise TransientStoreError("dropped at open")
        for i, rec in enumerate(self.records):
            if self.opens == 2 and i == 2:
                raise TransientStoreError("dropped mid-stream")
            yield rec

    def classify(self, exc):
        return self._inner.classify(exc)

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


def test_retrying_lines_mid_stream_fault_propagates():
    flaky = _MidStreamFlakyStore(MemStore(), [f"r{i}\n" for i in range(5)])
    it = iter(RetryingStore(flaky, _policy()).lines("f"))
    assert next(it) == "r0\n" and flaky.opens == 2
    assert next(it) == "r1\n"
    with pytest.raises(TransientStoreError, match="mid-stream"):
        next(it)
    assert flaky.opens == 2


def test_stats_fold_fault_counters_and_chaos_golden(tmp_path):
    """A LocalExecutor wordcount under a plan of every data-plane kind:
    the result bytes equal the JAX package's fault-free run, the plan
    fired, and the counters reached IterationStats."""
    import glob
    import os
    from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
    from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxExecutor
    from lua_mapreduce_tpu.store.router import get_storage_from as jax_store
    from lua_mapreduce_tpu_torch.engine.local import LocalExecutor
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(repo, "lua_mapreduce_tpu",
                                          "core", "*.py")))[:6]
    fns = dict(taskfn="examples.wordcount.taskfn",
               mapfn="examples.wordcount.mapfn",
               partitionfn="examples.wordcount.partitionfn",
               reducefn="examples.wordcount.reducefn",
               combinerfn="examples.wordcount.reducefn")
    JaxExecutor(JaxSpec(init_args={"files": files},
                        storage=f"shared:{tmp_path}/jax", **fns)).run()
    js = jax_store(f"shared:{tmp_path}/jax")
    want = {n: "".join(js.lines(n)) for n in js.list("result.P*")}
    plan = FaultPlan(31, transient=0.06, latency=0.04,
                     error_after_write=0.25, torn=0.15, latency_ms=1,
                     max_per_key=2)
    install_fault_plan(plan)
    try:
        ex = LocalExecutor(TaskSpec(init_args={"files": files},
                                    storage=f"object:{tmp_path}/port",
                                    **fns),
                           pipeline=True, premerge_min_runs=2,
                           segment_format="v2", engine="store")
        stats = ex.run()
    finally:
        install_fault_plan(None)
    out = get_storage_from(f"object:{tmp_path}/port")
    assert {n: "".join(out.lines(n)) for n in out.list("result.P*")} == want
    assert plan.total_fired() > 0
    it = stats.iterations[-1]
    assert it.store_faults >= plan.total_fired() > 0
    assert {"store_retries", "store_faults", "infra_releases",
            "degraded_reads"} <= set(it.as_dict())
