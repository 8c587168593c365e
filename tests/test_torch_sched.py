"""The port's lmr-sched plane (``lua_mapreduce_tpu_torch/sched/waiter.py``
and ``tenancy.py``): counterparts of the tier-1 cases of
tests/test_sched.py — watch/notify conformance on every backend, the
off switch and routing, end-to-end wakeups of an idle worker and of the
server's barrier, notify-off byte identity, admission quotas, tenant
isolation, weighted fair share, the flood-vs-barrier starvation leg, the
dispatch span, the idle-poll knob and its CLI flag — plus a SIGKILL
churn leg with notify on (heavy).

The starvation leg here is deterministic: the pool members' polls are
driven in turn from the test and dispatch latency is counted in polls,
so the fair-versus-FIFO comparison does not depend on the machine's
load. Parity with the JAX package (``lua_mapreduce_tpu/sched``): a
notify of either package on one directory wakes the other's waiter, and
the same seeded claim/charge sequence gives the same stride order.
The three protocol-model cases of tests/test_sched.py wait for the port
of ``analysis/protocol.py``.
"""

import os
import signal
import subprocess
import sys
import threading
import time
import types
from collections import Counter

import numpy as np
import pytest

from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore, make_job
from lua_mapreduce_tpu_torch.core.constants import Status, TaskStatus
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.server import Server
from lua_mapreduce_tpu_torch.engine.worker import (Worker,
                                                   resolve_idle_poll_s)
from lua_mapreduce_tpu_torch.sched import (AdmissionError, FairScheduler,
                                           FairWorker, Tenant, TenantView,
                                           channel_for, dispatch_latencies,
                                           notify, tenant_ns)
from lua_mapreduce_tpu_torch.sched.waiter import (DirChannel, LocalChannel,
                                                  NullChannel, StoreChannel)
from lua_mapreduce_tpu_torch.store.router import get_storage_from

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCHED_MOD = "benchmarks.sched_task"

BACKENDS = ("mem", "shared", "object", "fake-gcs")


def _make_channel(kind, tmp_path):
    """One wakeup channel per backend kind; returns (channel, cleanup)."""
    if kind == "mem":
        return channel_for(MemJobStore()), lambda: None
    if kind == "shared":
        return channel_for(FileJobStore(str(tmp_path / "coord"))), \
            lambda: None
    from lua_mapreduce_tpu_torch.store.objectfs import ObjectStore
    if kind == "object":
        return channel_for(ObjectStore(str(tmp_path / "obj"))), \
            lambda: None
    from lua_mapreduce_tpu_torch.store.fake_gcs import (install_fake_gcs,
                                                        uninstall_fake_gcs)
    prev = install_fake_gcs()
    return channel_for(ObjectStore("gs://sched-test/pfx")), \
        lambda: uninstall_fake_gcs(prev)


# --------------------------------------------------------------------------
# notify conformance across backends
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", BACKENDS)
def test_notify_conformance_wakeup_fires(kind, tmp_path):
    """A blocked waiter returns True promptly when the producer
    notifies, on every backend's channel."""
    ch, cleanup = _make_channel(kind, tmp_path)
    try:
        w = ch.waiter()
        got = []
        t = threading.Thread(target=lambda: got.append(w.wait(10.0)))
        t.start()
        time.sleep(0.05)
        t0 = time.perf_counter()
        ch.notify()
        t.join(timeout=10.0)
        took = time.perf_counter() - t0
        assert got == [True]
        assert took < 2.0, f"{kind}: wakeup took {took:.3f}s"
    finally:
        cleanup()


@pytest.mark.parametrize("kind", BACKENDS)
def test_notify_conformance_lost_notification_times_out(kind, tmp_path):
    """No notification: the wait times out (False) after about the
    requested interval — the poll fallback, never a hang."""
    ch, cleanup = _make_channel(kind, tmp_path)
    try:
        w = ch.waiter()
        t0 = time.perf_counter()
        assert w.wait(0.15) is False
        assert time.perf_counter() - t0 >= 0.1
    finally:
        cleanup()


@pytest.mark.parametrize("kind", BACKENDS)
def test_notify_conformance_stale_wakeup_is_noop(kind, tmp_path):
    """A notification is consumed exactly once; pre-history absorbed at
    waiter creation never wakes; a notify fired between waits is
    delivered by the next wait."""
    ch, cleanup = _make_channel(kind, tmp_path)
    try:
        ch.notify()                      # pre-history
        w = ch.waiter()
        assert w.wait(0.05) is False     # absorbed as the baseline
        ch.notify()                      # raced between waits
        assert w.wait(2.0) is True       # delivered by the NEXT wait
        assert w.wait(0.05) is False     # consumed exactly once
    finally:
        cleanup()


def test_notify_off_switch_routes_null(monkeypatch):
    monkeypatch.setenv("LMR_SCHED_NOTIFY", "0")
    ch = channel_for(MemJobStore())
    assert isinstance(ch, NullChannel)
    slept = []
    w = ch.waiter(sleep=slept.append)
    assert w.wait(0.05) is False and slept == [0.05]
    assert not w.can_notify


def test_channel_routing_by_backend(tmp_path):
    from lua_mapreduce_tpu_torch.faults.wrappers import wrap_jobstore
    from lua_mapreduce_tpu_torch.store.objectfs import ObjectStore
    from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore
    assert isinstance(channel_for(MemJobStore()), LocalChannel)
    fch = channel_for(FileJobStore(str(tmp_path / "c")), "done")
    assert isinstance(fch, DirChannel)
    assert fch.path == str(tmp_path / "c" / "_sched.done.wake")
    sch = channel_for(SharedStore(str(tmp_path / "s")))
    assert sch.path == str(tmp_path / "s" / "._sched.jobs.wake")
    och = channel_for(ObjectStore(str(tmp_path / "o")), "leader")
    assert isinstance(och, StoreChannel)
    assert och._name == "_sched.leader.wake"
    # wrapper stacks unwrap to the shared concrete store: one bus
    js = MemJobStore()
    assert channel_for(wrap_jobstore(js)) is channel_for(js)
    assert channel_for(TenantView(js, Tenant("t"))) is channel_for(js)
    with pytest.raises(ValueError, match="bogus"):
        channel_for(js, "bogus")


# --------------------------------------------------------------------------
# end-to-end: inserts wake an idle worker in far less than the poll cap
# --------------------------------------------------------------------------


def _put_map_task(view_or_store):
    desc = TaskSpec(taskfn=SCHED_MOD, mapfn=SCHED_MOD,
                    partitionfn=SCHED_MOD, reducefn=SCHED_MOD,
                    init_args={"device": "cpu"},
                    storage="mem:sched_test").describe()
    view_or_store.put_task({"_id": "unique",
                            "status": TaskStatus.MAP.value,
                            "iteration": 1, "spec": desc, "batch_k": 1})


@pytest.mark.parametrize("coord", ("mem", "shared"))
def test_insert_wakes_idle_worker(coord, tmp_path):
    """With a 5 s poll cap, dispatch rides the wakeup channel: the claim
    lands within a small fraction of the cap."""
    store = MemJobStore() if coord == "mem" \
        else FileJobStore(str(tmp_path / "coord"))
    _put_map_task(store)
    w = Worker(store, name="wake-test").configure(
        max_iter=10 ** 6, max_sleep=5.0, heartbeat_s=None)
    t = threading.Thread(target=w.execute, daemon=True)
    t.start()
    time.sleep(0.4)                      # the worker backs off into a wait
    store.insert_jobs("map_jobs", [make_job("k", 0)])
    notify(store, "jobs")
    deadline = time.perf_counter() + 2.0
    while time.perf_counter() < deadline:
        if store.counts("map_jobs")[Status.WRITTEN]:
            break
        time.sleep(0.005)
    doc = store.get_job("map_jobs", 0)
    assert doc["status"] == Status.WRITTEN, \
        f"job not dispatched within 2s (cap was 5s): {doc['status']}"
    lat = doc["started_time"] - doc["creation_time"]
    assert lat < 1.5, f"dispatch latency {lat:.3f}s — wakeup did not fire"
    store.update_task({"status": TaskStatus.FINISHED.value})
    notify(store, "jobs")
    t.join(timeout=10.0)


def _module(name, **fns):
    mod = types.ModuleType(name)
    for k, v in fns.items():
        setattr(mod, k, v)
    sys.modules[name] = mod
    return mod


def _mod_spec(name, storage):
    return TaskSpec(taskfn=name, mapfn=name, partitionfn=name,
                    reducefn=name, finalfn=name,
                    init_args={"device": "cpu"}, storage=storage)


def test_server_barrier_wakes_on_commit():
    """The server's "done" channel: a worker's commit wakes the barrier
    poll long before its interval: two phases finish in a fraction of
    the 2 s poll interval."""
    _module("_tsched_barrier_mod",
            taskfn=lambda emit: [emit(str(i), i) for i in range(3)],
            mapfn=lambda key, value, emit: emit("n", value),
            partitionfn=lambda key: 0,
            reducefn=lambda key, values: sum(values),
            finalfn=lambda pairs: None)
    try:
        store = MemJobStore()
        server = Server(store, poll_interval=2.0).configure(
            _mod_spec("_tsched_barrier_mod", "mem:_tsched_barrier"))
        w = Worker(store).configure(max_iter=10 ** 6, max_sleep=2.0,
                                    heartbeat_s=None)
        t = threading.Thread(target=w.execute, daemon=True)
        t.start()
        t0 = time.perf_counter()
        server.loop()
        wall = time.perf_counter() - t0
        t.join(timeout=10.0)
        # two phases × 2 s interval would cost ≥ 4 s on pure polling
        assert wall < 3.0, f"barrier wall {wall:.2f}s — commit wakeups " \
                           "did not reach the server"
    finally:
        del sys.modules["_tsched_barrier_mod"]


def test_notify_off_output_identical(monkeypatch):
    """The notify-off path gives the same result bytes as the notify-on
    path (rung 3 of the ladder: the polling engine verbatim)."""
    def mapfn(key, values, emit):
        for v in values:
            emit(f"w{v % 3}", v)
    _module("_tsched_equiv_mod",
            taskfn=lambda emit: [emit(str(i), list(range(i + 1)))
                                 for i in range(4)],
            mapfn=mapfn,
            partitionfn=lambda key: int(key[1:]) % 2,
            reducefn=lambda key, values: sum(values),
            finalfn=lambda pairs: None)

    def run(tag, notify_on):
        monkeypatch.setenv("LMR_SCHED_NOTIFY", "1" if notify_on else "0")
        store = MemJobStore()
        server = Server(store, poll_interval=0.01).configure(
            _mod_spec("_tsched_equiv_mod", f"mem:_tsched_equiv_{tag}"))
        w = Worker(store).configure(max_iter=800, max_sleep=0.02)
        assert w._waiter().can_notify is notify_on
        t = threading.Thread(target=w.execute, daemon=True)
        t.start()
        server.loop()
        t.join(timeout=10.0)
        st = get_storage_from(f"mem:_tsched_equiv_{tag}")
        return {n: "".join(st.lines(n)) for n in st.list("result.P*")}

    try:
        on = run("on", True)
        off = run("off", False)
        assert on and on == off
    finally:
        del sys.modules["_tsched_equiv_mod"]


# --------------------------------------------------------------------------
# multi-tenancy: admission, weighted share, starvation regression
# --------------------------------------------------------------------------


def test_admission_quota_refuses_flood():
    from lua_mapreduce_tpu_torch.faults.errors import classify_exception
    store = MemJobStore()
    v = TenantView(store, Tenant("q", max_pending=5))
    v.insert_jobs("map_jobs", [make_job(f"k{i}", i) for i in range(5)])
    with pytest.raises(AdmissionError):
        v.insert_jobs("map_jobs", [make_job("k5", 5)])
    assert v.admission == {"admitted": 5, "rejected": 1}
    # a PERMANENT store fault: the retry layer must not back off on a
    # full queue
    assert classify_exception(AdmissionError("full")) is False


def test_tenant_namespaces_and_task_docs_are_isolated():
    store = MemJobStore()
    a, b = TenantView(store, Tenant("a")), TenantView(store, Tenant("b"))
    _put_map_task(a)
    assert b.get_task() is None
    a.insert_jobs("map_jobs", [make_job("k", 1)])
    assert b.counts("map_jobs")[Status.WAITING] == 0
    assert store.counts(tenant_ns("a", "map_jobs"))[Status.WAITING] == 1
    # the errors stream is shared but tenant-tagged
    a.insert_error("w", "boom", info={"ns": "map_jobs"})
    (err,) = store.drain_errors()
    assert err["tenant"] == "a"


def test_weighted_fair_share_converges():
    """Two backlogged tenants, one FairWorker: committed work converges
    to the 2:1 weight ratio (stride scheduling)."""
    store = MemJobStore()
    tenants = [Tenant("heavy", weight=2.0), Tenant("light", weight=1.0)]
    views = {t.name: TenantView(store, t) for t in tenants}
    for v in views.values():
        _put_map_task(v)
        v.insert_jobs("map_jobs",
                      [make_job(f"k{i}", i) for i in range(40)])
    fw = FairWorker(store, tenants, max_iter=5, heartbeat_s=None)
    for _ in range(36):
        assert fw.poll_once() == "executed"
    snap = fw.scheduler.snapshot()
    ratio = snap["heavy"]["charged"] / max(1, snap["light"]["charged"])
    assert 1.4 <= ratio <= 2.8, snap


def _starvation_leg(fair, flood_jobs=150, barrier_jobs=8, members=3):
    """One leg of the flood-vs-barrier case, with the pool members'
    polls driven in turn from here: a barrier job's dispatch latency is
    the number of polls between the inserts and its commit. Returns
    (barrier latencies, flood latencies, polls when the barrier was
    done, polls when everything was)."""
    store = MemJobStore()
    tenants = [Tenant("flood"), Tenant("barrier")] if fair \
        else [Tenant("flood")]
    views = {t.name: TenantView(store, t) for t in tenants}
    for v in views.values():
        _put_map_task(v)
    views["flood"].insert_jobs(
        "map_jobs", [make_job(f"f{i}", i) for i in range(flood_jobs)])
    bview = views["barrier"] if fair else views["flood"]
    first_barrier = 0 if fair else flood_jobs
    bview.insert_jobs(
        "map_jobs", [make_job(f"b{i}", i) for i in range(barrier_jobs)])
    sched = FairScheduler(tenants)
    pool = [FairWorker(store, tenants, scheduler=sched, name=f"fw{i}",
                       max_iter=10, heartbeat_s=None)
            for i in range(members)]
    written = {}                       # (tenant view name, jid) -> poll
    polls = 0
    total = flood_jobs + barrier_jobs
    while len(written) < total:
        for fw in pool:
            fw.poll_once()
            polls += 1
            for name, v in views.items():
                for d in v.jobs("map_jobs"):
                    key = (name, d["_id"])
                    if d["status"] == Status.WRITTEN and key not in written:
                        written[key] = polls
        assert polls < 10 * total, "the pool stopped making progress"
    b_name = "barrier" if fair else "flood"
    barrier = [p for (n, j), p in written.items()
               if n == b_name and j >= first_barrier]
    flood = [p for (n, j), p in written.items()
             if n == "flood" and (fair or j < flood_jobs)]
    assert len(barrier) == barrier_jobs
    # the store-side latencies exist for every claimed job
    assert len(dispatch_latencies(store, b_name)) >= barrier_jobs
    return barrier, flood, max(barrier), polls


def test_starvation_regression_flood_vs_barrier():
    """The acceptance leg: a flood tenant's tiny-job backlog cannot
    starve the barrier tenant. Fair two-tenant scheduling beats the FIFO
    (no-tenancy) baseline on the barrier's dispatch p99 by a wide
    margin, stays under the flood's own p99, and the barrier finishes
    long before the flood drains."""
    fair_b, fair_f, fair_done, fair_total = _starvation_leg(fair=True)
    fifo_b, _, _, _ = _starvation_leg(fair=False)
    p99 = lambda xs: float(np.percentile(xs, 99))   # noqa: E731
    assert p99(fair_b) < 0.6 * p99(fifo_b), (fair_b, fifo_b)
    assert p99(fair_b) <= p99(fair_f), (fair_b, fair_f)
    assert fair_done < 0.25 * fair_total, (fair_done, fair_total)


# --------------------------------------------------------------------------
# dispatch span (lmr-trace integration)
# --------------------------------------------------------------------------


def test_dispatch_span_reports_in_histograms():
    from lua_mapreduce_tpu_torch.trace.collect import TraceCollection
    from lua_mapreduce_tpu_torch.trace.span import Tracer
    from lua_mapreduce_tpu_torch.trace.wrappers import TracingJobStore

    tr = Tracer()
    tr.set_actor("w")
    store = TracingJobStore(MemJobStore(), tr)
    store.insert_jobs("map_jobs", [make_job("k", 1)])
    time.sleep(0.02)
    got = store.claim_batch("map_jobs", "w", 1)
    assert len(got) == 1
    col = TraceCollection(tr.drain())
    d = col.dispatch_stats()
    assert d is not None and d["count"] == 1
    assert d["p50_ms"] >= 15.0           # covers the insert→claim gap
    assert "dispatch" in col.op_stats()


# --------------------------------------------------------------------------
# idle-poll knob plumbing
# --------------------------------------------------------------------------


def test_idle_poll_resolution(monkeypatch):
    monkeypatch.delenv("LMR_IDLE_POLL_MS", raising=False)
    assert resolve_idle_poll_s(None, 20.0) == 20.0
    assert resolve_idle_poll_s(500, 20.0) == 0.5
    assert resolve_idle_poll_s(500, 0.2) == 0.2     # max_sleep still caps
    monkeypatch.setenv("LMR_IDLE_POLL_MS", "250")
    assert resolve_idle_poll_s(None, 20.0) == 0.25
    with pytest.raises(ValueError):
        resolve_idle_poll_s(-1, 20.0)
    with pytest.raises(ValueError):
        Worker(MemJobStore()).configure(idle_poll_ms=0)


def test_cli_expose_idle_poll_ms():
    from lua_mapreduce_tpu_torch.cli.execute_server import \
        build_parser as server_parser
    from lua_mapreduce_tpu_torch.cli.execute_worker import \
        build_parser as worker_parser
    wa = worker_parser().parse_args(["/tmp/x", "--idle-poll-ms", "250"])
    assert wa.idle_poll_ms == 250
    sa = server_parser().parse_args(
        ["/tmp/x", "a", "b", "c", "d", "--idle-poll-ms", "250"])
    assert sa.idle_poll_ms == 250


# --------------------------------------------------------------------------
# parity with the JAX package
# --------------------------------------------------------------------------


def _jax_and_port_stores(kind, root):
    """The same directory as a store of each package."""
    import lua_mapreduce_tpu.coord.filestore as jfs
    import lua_mapreduce_tpu.store.objectfs as jobj
    import lua_mapreduce_tpu.store.sharedfs as jsh
    from lua_mapreduce_tpu_torch.store.objectfs import ObjectStore
    from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore
    if kind == "file":
        return jfs.FileJobStore(root), FileJobStore(root)
    if kind == "shared":
        return jsh.SharedStore(root), SharedStore(root)
    return jobj.ObjectStore(root), ObjectStore(root)


@pytest.mark.parametrize("producer", ("jax", "port"))
@pytest.mark.parametrize("kind", ("file", "shared", "object"))
def test_cross_package_notify_wakes_the_other_packages_waiter(kind,
                                                              producer,
                                                              tmp_path):
    """One wake file or object, two packages: a notify of either wakes a
    waiter of the other, once."""
    from lua_mapreduce_tpu.sched import waiter as jax_waiter
    from lua_mapreduce_tpu_torch.sched import waiter as port_waiter
    os.makedirs(tmp_path / "d", exist_ok=True)
    jstore, pstore = _jax_and_port_stores(kind, str(tmp_path / "d"))
    if producer == "jax":
        prod, cons = (jax_waiter, jstore), (port_waiter, pstore)
    else:
        prod, cons = (port_waiter, pstore), (jax_waiter, jstore)
    for topic in ("jobs", "done", "leader"):
        w = cons[0].channel_for(cons[1], topic).waiter()
        assert w.wait(0.02) is False
        prod[0].notify(prod[1], topic)
        assert w.wait(5.0) is True, (kind, producer, topic)
        assert w.wait(0.02) is False


def test_fair_scheduler_order_matches_the_jax_package():
    """The same seeded claim/charge sequence through both packages'
    FairScheduler gives the same order() at every step."""
    from lua_mapreduce_tpu.sched import tenancy as jt
    from lua_mapreduce_tpu_torch.sched import tenancy as pt
    rng = np.random.default_rng(18)
    names = [f"t{i}" for i in range(5)]
    weights = [float(w) for w in rng.choice([0.5, 1.0, 2.0, 3.0], 5)]
    js = jt.FairScheduler([jt.Tenant(n, weight=w)
                           for n, w in zip(names, weights)])
    ps = pt.FairScheduler([pt.Tenant(n, weight=w)
                           for n, w in zip(names, weights)])
    for _ in range(300):
        order = ps.order()
        assert order == js.order()
        # the first tenant claims, charged for a seeded batch; now and
        # then another tenant commits out of turn
        who = order[0] if rng.random() < 0.8 else str(rng.choice(names))
        jobs = int(rng.integers(0, 4))
        ps.charge(who, jobs)
        js.charge(who, jobs)
    assert ps.snapshot() == js.snapshot()


# --------------------------------------------------------------------------
# SIGKILL churn with notify on (heavy)
# --------------------------------------------------------------------------


def _env():
    ambient = os.environ.get("PYTHONPATH", "")
    path = REPO + os.pathsep + ambient if ambient else REPO
    return dict(os.environ, PYTHONPATH=path, LMR_SCHED_NOTIFY="1",
                LMR_IDLE_POLL_MS="200")


@pytest.mark.heavy
def test_sigkill_churn_with_notify_on(tmp_path):
    """The churn contract survives the event-driven plane: a worker is
    SIGKILLed mid-map with notify on; the stale requeue (whose notify
    wakes the healthy fleet) recovers its job, nothing FAILED, output
    equal to the golden count."""
    from examples.wordcount_big import corpus
    from lua_mapreduce_tpu_torch.engine.local import iter_results

    coord = str(tmp_path / "coord")
    spill = str(tmp_path / "spill")
    corpus_dir = str(tmp_path / "corpus")
    corpus.build(corpus_dir, n_splits=4)
    golden = Counter()
    for i in range(4):
        with open(corpus.split_path(corpus_dir, i)) as f:
            golden.update(f.read().split())

    stall = (
        "import examples.wordcount_big.bigtask as bt\n"
        "import time\n"
        "def stall(k, v, emit):\n"
        "    print('CLAIMED', flush=True)\n"
        "    time.sleep(3600)\n"
        "bt.mapfn = stall\n"
        "import lua_mapreduce_tpu_torch.core.native_wcmap as nw\n"
        "nw.native_available = lambda: False\n")
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "{extra}"
        "from lua_mapreduce_tpu_torch import FileJobStore, Worker\n"
        f"w = Worker(FileJobStore({coord!r})).configure(\n"
        "    max_iter=2000, max_sleep=0.5)\n"
        "w.execute()\n")
    victim = subprocess.Popen(
        [sys.executable, "-c", code.format(extra=stall)], env=_env(),
        stdout=subprocess.PIPE, text=True)
    healthy = []
    try:
        spec = TaskSpec(taskfn="examples.wordcount_big.bigtask",
                        mapfn="examples.wordcount_big.bigtask",
                        partitionfn="examples.wordcount_big.bigtask",
                        reducefn="examples.wordcount_big.bigtask",
                        init_args={"corpus_dir": corpus_dir,
                                   "n_splits": 4, "device": "cpu"},
                        storage=f"shared:{spill}")
        server = Server(FileJobStore(coord), poll_interval=0.05,
                        stale_timeout_s=2.0, strict=True).configure(spec)
        done = threading.Event()
        stats_box = {}

        def run_server():
            stats_box["stats"] = server.loop()
            done.set()

        st = threading.Thread(target=run_server, daemon=True)
        st.start()
        assert "CLAIMED" in victim.stdout.readline()
        victim.send_signal(signal.SIGKILL)
        victim.wait()
        healthy = [subprocess.Popen(
            [sys.executable, "-c", code.format(extra="")], env=_env())
            for _ in range(2)]
        assert done.wait(timeout=120.0), "task did not complete"
        it = stats_box["stats"].iterations[-1]
        assert it.map.failed == 0 and it.reduce.failed == 0
        store = get_storage_from(f"shared:{spill}")
        got = Counter({k: v[0] for k, v in iter_results(store, "result")})
        assert got == golden
    finally:
        victim.kill()
        for p in healthy:
            p.kill()
