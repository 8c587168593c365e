"""The port's replica-aware and erasure-coded data plane ≡ the JAX
package's. Counterparts of ``tests/test_faults.py:559-721`` (failover
view's mid-stream contract, the worker's lost-data release, the
scavenger's repair / requeue / pre-merge republish, a blackout absorbed
by replication), then the cross-package checks: placement addresses,
GF(256) parity blocks, stripes, manifests and replica copies byte-equal
to the JAX package's, each package reading and repairing the other's
replicated and coded files, and the result files of both LocalExecutors
equal under replication 2 and coding 4+2 on every backend."""

import random

import pytest

from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore, make_job
from lua_mapreduce_tpu_torch.core.constants import Status
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.worker import Worker
from lua_mapreduce_tpu_torch.faults import (COUNTERS, FaultPlan, FaultyStore,
                                            RetryPolicy,
                                            TransientStoreError)
from lua_mapreduce_tpu_torch.store.memfs import MemStore
from lua_mapreduce_tpu_torch.store.router import get_storage_from


def _policy(retries=3):
    return RetryPolicy(retries=retries, base_ms=1, sleep=lambda s: None,
                       rng=random.Random(0))


def _spec(mapfn, tag):
    return TaskSpec(taskfn=lambda emit: emit("k", 1), mapfn=mapfn,
                    partitionfn=lambda key: 0,
                    reducefn=lambda key, values: sum(values),
                    init_args={"device": "cpu"}, storage=f"mem:{tag}")


class _MidStreamFlakyStore:
    """lines() raises a transient fault BEFORE the first record on the
    first open, then — once reopened — dies again after yielding two
    records: the connection-drop-mid-scan shape. Tracks opens so the
    no-silent-reopen contract is assertable."""

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


def test_replicated_lines_mid_stream_fault_propagates():
    """The failover view keeps the same mid-stream contract: replica
    failover happens at open/first-record only — once records flowed, a
    fault propagates rather than restarting the stream on another copy
    (which would duplicate consumed records)."""
    from lua_mapreduce_tpu_torch.faults.replicate import ReplicatedStore

    flaky = _MidStreamFlakyStore(MemStore(), [f"r{i}\n" for i in range(5)])
    store = ReplicatedStore(flaky, 2)
    it = iter(store.lines("f"))
    assert next(it) == "r0\n"             # first-record fault failed over
    with pytest.raises(TransientStoreError, match="mid-stream"):
        for _ in it:
            pass
    assert flaky.opens == 2               # no third-copy stream restart


# --- replica-aware shuffle (DESIGN §20) -------------------------------------

def test_worker_releases_reduce_on_total_replica_loss():
    """Every copy of a reduce input gone: the job is RELEASED (WAITING,
    zero repetition charge — the loss is not the job's fault) and the
    errors-stream entry names the lost files, the hook the server's
    scavenger repairs or requeues on."""
    from lua_mapreduce_tpu_torch.faults.errors import LostShuffleDataError

    store = MemJobStore()
    w = Worker(store, name="wloss")
    w.heartbeat_s = 0
    w.configure(replication=2)
    spec = _spec(lambda key, value, emit: emit("k", 1), "wloss")
    files = ["result.P0.M00000000", "result.P0.M00000001"]
    store.insert_jobs("red_jobs", [make_job(0, {
        "part": 0, "files": files, "result": "result.P0", "mappers": []})])
    jobs = w.store.claim_batch("red_jobs", "wloss", 1)
    assert jobs
    with pytest.raises(LostShuffleDataError):
        w._execute_batch(spec, "red_jobs", jobs)
    d = store.get_job("red_jobs", 0)
    assert d["status"] == Status.WAITING and d["repetitions"] == 0
    (err,) = store.drain_errors()
    assert err["classification"] == "infra-transient"
    assert err["lost_files"] == files


@pytest.mark.parametrize("kind", ["mem", "file"])
def test_worker_error_record_reaches_the_server_with_lost_files(tmp_path,
                                                                kind):
    """A reduce that finds no copy of its inputs releases the job; its
    error record crosses the job store (the FileJobStore's errors log
    between processes, or the in-process MemJobStore) with
    ``lost_files`` unchanged, and the server's recovery requeues the
    producing map from it."""
    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.engine.server import Server
    from lua_mapreduce_tpu_torch.faults.errors import LostShuffleDataError

    store = (MemJobStore() if kind == "mem"
             else FileJobStore(str(tmp_path / "coord")))
    w = Worker(store, name="wlost")
    w.heartbeat_s = 0
    w.configure(replication=2)
    spec = _spec(lambda key, value, emit: emit("k", 1), f"wlost-{kind}")
    files = ["result.P0.M00000001"]
    store.insert_jobs("map_jobs", [make_job(i, i) for i in range(2)])
    for jid in range(2):
        assert store.set_job_status("map_jobs", jid, Status.RUNNING)
        assert store.set_job_status("map_jobs", jid, Status.WRITTEN)
    store.insert_jobs("red_jobs", [make_job(0, {
        "part": 0, "files": files, "result": "result.P0", "mappers": []})])
    with pytest.raises(LostShuffleDataError):
        w._execute_batch(spec, "red_jobs",
                         w.store.claim_batch("red_jobs", "wlost", 1))
    srv = Server(store, replication=2, poll_interval=0.0)
    srv.spec = spec
    srv._data_store = get_storage_from(spec.storage)
    srv._housekeep("red_jobs")
    (err,) = srv.errors
    assert err["lost_files"] == files and err["worker"] == "wlost"
    assert store.get_job("map_jobs", 1)["status"] == Status.WAITING
    assert store.get_job("map_jobs", 0)["status"] == Status.WRITTEN


def _recovery_server(tag, replication=2, n_maps=2):
    """A Server wired for scavenge-path unit tests: spec + data store
    bound (what loop() does), map jobs inserted and WRITTEN."""
    from lua_mapreduce_tpu_torch.engine.server import Server

    store = MemJobStore()
    spec = _spec(lambda key, value, emit: emit("k", 1), tag)
    srv = Server(store, replication=replication)
    srv.spec = spec               # what configure()+loop() bind, without
    srv._data_store = None        # requiring module-path functions
    srv._data_store = get_storage_from(spec.storage)
    store.insert_jobs("map_jobs", [make_job(i, i) for i in range(n_maps)])
    for jid in range(n_maps):
        assert store.set_job_status("map_jobs", jid, Status.RUNNING)
        assert store.set_job_status("map_jobs", jid, Status.WRITTEN)
    return srv, store


def _publish(store, name, replication, payload="x\t[1]\n"):
    from lua_mapreduce_tpu_torch.faults.replicate import spill_writer

    with spill_writer(store, "v1", replication) as wtr:
        wtr.add("x", [1])
        wtr.build(name)


def test_scavenger_repairs_under_replicated_file():
    """Rung 3 of the failover ladder: a lost copy with a survivor is
    REBUILT by the scavenger (counted replica_repairs) — no job state
    touched, no map re-run."""
    from lua_mapreduce_tpu_torch.engine.placement import replica_name

    srv, store = _recovery_server("scav-repair")
    raw = srv._data_store
    name = "result.P0.M00000000"
    _publish(raw, name, 2)
    golden = raw.read_range(name, 0, raw.size(name))
    raw.remove(name)                      # primary lost, replica survives
    before = COUNTERS.snapshot().get("replica_repairs", 0)
    srv._recover_lost([name])
    assert raw.read_range(name, 0, 99) == golden[:99]   # primary rebuilt
    assert raw.exists(replica_name(name, 1))
    assert COUNTERS.snapshot()["replica_repairs"] == before + 1
    d = store.get_job("map_jobs", 0)
    assert d["status"] == Status.WRITTEN  # producer untouched


def test_scavenger_requeues_producer_on_total_loss():
    """Rung 4 (last resort): every copy gone — the producing map job is
    CAS-requeued WRITTEN→WAITING with no repetition charge, counted
    map_reruns, and the errors stream distinguishes the requeue as
    spill-lost-requeue (the recovery diagnostics)."""
    srv, store = _recovery_server("scav-requeue")
    name = "result.P0.M00000001"          # produced by map job 1
    before = COUNTERS.snapshot().get("map_reruns", 0)
    srv._recover_lost([name])             # no copy was ever published
    assert store.get_job("map_jobs", 1)["status"] == Status.WAITING
    assert store.get_job("map_jobs", 1)["repetitions"] == 0
    assert store.get_job("map_jobs", 0)["status"] == Status.WRITTEN
    assert COUNTERS.snapshot()["map_reruns"] == before + 1
    (err,) = store.drain_errors()
    assert err["classification"] == "spill-lost-requeue"
    assert err["job_id"] == 1


def test_scavenger_republishes_premerge_for_lost_spill():
    """A lost SPILL requeues every covering producer and, once they all
    re-land, republishes the pre-merge job so the retrying reduce finds
    its spill again — the pipelined half of the reconstruction path."""
    from lua_mapreduce_tpu_torch.engine.premerge import spill_name

    srv, store = _recovery_server("scav-spill")
    raw = srv._data_store
    spill = spill_name("result", 0, 0, 1)     # covers map keys 0..1
    srv._recover_lost([spill])                # all copies gone
    for jid in range(2):
        assert store.get_job("map_jobs", jid)["status"] == Status.WAITING
    assert srv._spill_repairs == {spill: (0, 0, 1)}

    # producers re-ran: runs are back, statuses WRITTEN again
    for jid in range(2):
        _publish(raw, f"result.P0.M{jid:08d}", 2)
        assert store.set_job_status("map_jobs", jid, Status.RUNNING)
        assert store.set_job_status("map_jobs", jid, Status.WRITTEN)
    srv._settle_spill_repairs()
    assert srv._spill_repairs == {}
    (job,) = store.jobs("pre_jobs")
    assert job["value"]["spill"] == spill
    assert job["value"]["files"] == ["result.P0.M00000000",
                                     "result.P0.M00000001"]


def test_blackout_dark_tag_absorbed_by_replication():
    """The blackout kind × the placement function: every op on ONE
    placement tag fails transient for the window — with r=2 the copies
    live on two different tags, so the failover view serves every read
    from the lit tag and the blackout is invisible to consumers."""
    from lua_mapreduce_tpu_torch.engine.placement import replica_name, tag_of
    from lua_mapreduce_tpu_torch.faults.replicate import ReplicatedStore

    raw = MemStore()
    name = "result.P0.M00000007"
    _publish(raw, name, 2)
    vt = [0.0]
    plan = FaultPlan(9, blackout_tag=tag_of(name), blackout_s=60.0,
                     clock=lambda: vt[0], sleep=lambda s: None,
                     latency_ms=0)
    view = ReplicatedStore(FaultyStore(raw, plan), 2)
    rec = list(raw.lines(name))
    # dark window: primary's tag fails every op, replica serves
    assert list(view.lines(name)) == rec
    assert view.exists(name) and view.size(name) == raw.size(name)
    assert plan.fired.get("blackout", 0) > 0
    vt[0] = 61.0                          # window over: tag back, and
    fired = plan.fired["blackout"]        # the plan goes quiet
    assert list(view.lines(name)) == rec
    assert plan.fired["blackout"] == fired
    assert tag_of(replica_name(name, 1)) != tag_of(name)


# --- cross-package checks ----------------------------------------------------

def _names(n=3000):
    rng = random.Random(16)
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            out.append(f"result.P{rng.randrange(64)}.M{i:08d}")
        elif kind == 1:
            out.append(f"result.P{rng.randrange(64)}.SPILL-"
                       f"{rng.randrange(99):05d}-{rng.randrange(99):05d}")
        elif kind == 2:
            out.append(f"wc.P{rng.randrange(8)}.INBOX-{i:08d}-"
                       f"{rng.randrange(9):05d}")
        else:
            out.append("".join(rng.choice("abcxyz./_-0123456789")
                               for _ in range(rng.randrange(1, 24))))
    return out


def test_placement_addresses_equal_jax():
    """Every placement question — primary tag, replica and stripe-block
    names, tag routing, base names — answers the same in both packages
    for a few thousand names."""
    from lua_mapreduce_tpu.engine import placement as jp
    from lua_mapreduce_tpu.faults import coded as jc
    from lua_mapreduce_tpu_torch.engine import placement as pp
    from lua_mapreduce_tpu_torch.faults import coded as pc

    for name in _names():
        assert pp.primary_tag(name) == jp.primary_tag(name)
        for r in (1, 2, 3, 8):
            assert pp.replica_names(name, r) == jp.replica_names(name, r)
        for phys in pp.replica_names(name, 3) + pc.block_names(
                name, pc.Coding(4, 2)) + pc.manifest_copies(
                name, pc.Coding(4, 2)):
            assert pp.tag_of(phys) == jp.tag_of(phys)
            assert pp.base_name(phys) == jp.base_name(phys) == name
            assert pp.parse_replica(phys) == jp.parse_replica(phys)
            assert pp.parse_block(phys) == jp.parse_block(phys)
        assert pc.block_names(name, pc.Coding(4, 2)) == \
            jc.block_names(name, jc.Coding(4, 2))
        assert pc.manifest_copies(name, pc.Coding(3, 1)) == \
            jc.manifest_copies(name, jc.Coding(3, 1))
    for pat in ("result.P[0-9]*.M*", "result.PUSH.M*"):
        assert pp.replica_pattern(pat) == jp.replica_pattern(pat)
        assert pc.stripe_patterns(pat) == jc.stripe_patterns(pat)


@pytest.mark.parametrize("python_path", [False, True],
                         ids=["numpy", "python"])
def test_rs_parity_and_reconstruct_equal_jax(monkeypatch, python_path):
    """GF(256) Reed-Solomon: the parity blocks of the same data blocks
    are equal to the JAX package's, and each package rebuilds any k of
    k+m blocks into the same data, on its numpy and pure-Python
    paths."""
    from lua_mapreduce_tpu.faults import coded as jc
    from lua_mapreduce_tpu_torch.faults import coded as pc

    monkeypatch.setattr(pc, "_FORCE_PYTHON", python_path)
    monkeypatch.setattr(jc, "_FORCE_PYTHON", python_path)
    rng = random.Random(27)
    for k, m, blen in ((2, 1, 1), (4, 1, 257), (4, 2, 1000), (5, 3, 64),
                       (3, 2, 4096)):
        data = [bytes(rng.randrange(256) for _ in range(blen))
                for _ in range(k)]
        parity = pc.rs_parity(data, m)
        assert parity == jc.rs_parity(data, m)
        blocks = data + parity
        for _ in range(6):
            keep = sorted(rng.sample(range(k + m), k))
            have = {i: blocks[i] for i in keep}
            want = [i for i in range(k + m) if i not in keep]
            got = pc.rs_reconstruct(have, want, k)
            assert got == jc.rs_reconstruct(have, want, k)
            assert [got[i] for i in want] == [blocks[i] for i in want]


def _spill(pkg, store, fmt, red, name):
    """One run file through a package's spill_writer."""
    if pkg == "jax":
        from lua_mapreduce_tpu.faults.coded import check_redundancy
        from lua_mapreduce_tpu.faults.replicate import spill_writer
    else:
        from lua_mapreduce_tpu_torch.faults.coded import check_redundancy
        from lua_mapreduce_tpu_torch.faults.replicate import spill_writer
    w = spill_writer(store, fmt, check_redundancy(red))
    try:
        for i in range(700):
            w.add(f"key{i:05d}", [i, i * 3 % 17, "v" * (i % 9)])
        w.build(name)
    finally:
        w.close()


_RED = [2, 3, "4+1", "4+2"]


@pytest.mark.parametrize("fmt", ["v1", "v2"])
@pytest.mark.parametrize("red", _RED)
def test_spill_copies_stripes_manifests_byte_equal_jax(fmt, red):
    """The same run through both packages' spill writers publishes the
    same physical files: replica copies, stripe blocks and manifest
    copies, byte for byte."""
    from lua_mapreduce_tpu.store.memfs import MemStore as JaxMem

    jax_store, port_store = JaxMem(), MemStore()
    _spill("jax", jax_store, fmt, red, "result.P3.M00000012")
    _spill("port", port_store, fmt, red, "result.P3.M00000012")
    want = {n: jax_store.read_range(n, 0, jax_store.size(n))
            for n in jax_store.list("*")}
    got = {n: port_store.read_range(n, 0, port_store.size(n))
           for n in port_store.list("*")}
    assert len(want) >= 2 and got == want


@pytest.mark.parametrize("red", _RED)
def test_each_package_reads_and_repairs_the_others_files(tmp_path, red):
    """Replicated and coded files one package published on ``shared:``
    read through the other's view — also with the primary copy (or
    block 0 of the stripe) gone — and the other's ``repair`` restores
    the lost copy byte-equal."""
    from lua_mapreduce_tpu.core.merge import merge_iterator as jax_merge
    from lua_mapreduce_tpu.faults.coded import check_redundancy as jax_red
    from lua_mapreduce_tpu.faults.replicate import reading_view as jax_view
    from lua_mapreduce_tpu.faults.replicate import repair as jax_repair
    from lua_mapreduce_tpu.store.router import get_storage_from as jax_get
    from lua_mapreduce_tpu_torch.core.merge import merge_iterator
    from lua_mapreduce_tpu_torch.faults.coded import check_redundancy
    from lua_mapreduce_tpu_torch.faults.replicate import (reading_view,
                                                          repair)
    readers = {"jax": (jax_get, jax_view, jax_merge, jax_red, jax_repair),
               "port": (get_storage_from, reading_view, merge_iterator,
                        check_redundancy, repair)}
    name = "result.P3.M00000012"
    want = [(f"key{i:05d}", [i, i * 3 % 17, "v" * (i % 9)])
            for i in range(700)]
    for writer, reader in (("jax", "port"), ("port", "jax")):
        root = f"shared:{tmp_path}/{writer}"
        get, view_of, merge, red_of, fix = readers[reader]
        _spill(writer, readers[writer][0](root), "v2", red, name)
        raw = get(root)
        view = view_of(raw, red_of(red))
        assert list(merge(view, [name])) == want
        before = {n: raw.read_range(n, 0, raw.size(n))
                  for n in raw.list("*")}
        lost = name if isinstance(red, int) else "^0." + next(
            n for n in before if n.startswith("^0."))[3:]
        raw.remove(lost)
        assert list(merge(view_of(raw, red_of(red)), [name])) == want
        assert fix(raw, name, red) == "repaired"
        assert {n: raw.read_range(n, 0, raw.size(n))
                for n in raw.list("*")} == before


@pytest.mark.parametrize("red", [2, "4+2"], ids=["r2", "coding4+2"])
@pytest.mark.parametrize("backend", ["mem", "shared", "object"])
def test_result_bytes_equal_jax_under_redundancy(tmp_path, backend, red):
    """Both LocalExecutors publish the same result files for the same
    word count under replication 2 and under coding 4+2, on every
    backend (barrier v1 and pipelined v2)."""
    import re

    from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
    from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxExecutor
    from lua_mapreduce_tpu.store.router import get_storage_from as jax_get
    from lua_mapreduce_tpu_torch.engine.local import LocalExecutor

    fns = dict(taskfn="examples.wordcount.taskfn",
               mapfn="examples.wordcount.mapfn",
               partitionfn="examples.wordcount.partitionfn",
               reducefn="examples.wordcount.reducefn",
               combinerfn="examples.wordcount.reducefn")
    import glob
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(repo, "examples", "wordcount",
                                          "*.py")))
    kw = {"replication": 2} if red == 2 else {"coding": red}
    keep = re.compile(r"^result\.P\d+$")

    def spec_str(side, pipe):
        return {"mem": f"mem:trep-{side}-{pipe}-{red}",
                "shared": f"shared:{tmp_path}/{side}-{pipe}",
                "object": f"object:{tmp_path}/{side}-{pipe}"}[backend]

    for pipeline in (False, True):
        mode = dict(pipeline=pipeline, premerge_min_runs=2,
                    segment_format="v2" if pipeline else "v1",
                    map_parallelism=3, **kw)
        JaxExecutor(JaxSpec(init_args={"files": files},
                            storage=spec_str("jax", pipeline), **fns),
                    **mode).run()
        LocalExecutor(TaskSpec(init_args={"files": files, "device": "cpu"},
                               storage=spec_str("port", pipeline), **fns),
                      engine="store", **mode).run()
        st_j = jax_get(spec_str("jax", pipeline))
        st_p = get_storage_from(spec_str("port", pipeline))
        want = {n: st_j.read_range(n, 0, st_j.size(n))
                for n in st_j.list("result.P*") if keep.match(n)}
        got = {n: st_p.read_range(n, 0, st_p.size(n))
               for n in st_p.list("result.P*") if keep.match(n)}
        assert want and got == want
