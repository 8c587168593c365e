"""The port's HA coordinator (``lua_mapreduce_tpu_torch/sched/lease.py``
and the Server's election loop): counterparts of tests/test_ha.py — the
epoch-fenced leader lease on a virtual clock, the FencedJobStore
rejection and its errors-stream evidence, a clean HA lifecycle, a hot
standby that watches the leader finish, in-process takeovers that
restore the threaded loop state (on ``shared:`` and on fake GCS), the
trace timeline surviving a takeover and the purge rules of a fresh
start after one; its SIGKILL/SIGSTOP chaos tier is ``heavy`` here too.

Parity with the JAX package: a JAX ``LeaderLease`` and a port one
contend on one FileJobStore directory (one wins, the epoch fences
across the packages, and either reads the other's ``_state.<N>``), and
a port HA takeover mid-run on the word count and on
``examples.loopsum`` gives result files byte-equal to the JAX package's
uninterrupted run.

Every chaos leg compares against a fault-free golden and asserts zero
repetition charges: workers are leader-agnostic, so a coordinator death
never costs a job re-execution.
"""

import os
import signal
import subprocess
import sys
import threading
import time
from collections import Counter

import pytest

from lua_mapreduce_tpu_torch import (FileJobStore, MemJobStore, Server,
                                     TaskSpec, Worker)
from lua_mapreduce_tpu_torch.core.constants import TaskStatus
from lua_mapreduce_tpu_torch.engine.local import iter_results
from lua_mapreduce_tpu_torch.faults.errors import StaleLeaderError
from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
from lua_mapreduce_tpu_torch.sched.lease import (STATE_NS, FencedJobStore,
                                           LeaderLease)
from lua_mapreduce_tpu_torch.store.router import get_storage_from

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WC = "examples.wordcount_big.bigtask"
LS = "examples.loopsum"
N_SPLITS = 6


# -- process / spec helpers (the churn-suite choreography idiom) ------------

def _env():
    ambient = os.environ.get("PYTHONPATH", "")
    path = REPO + os.pathsep + ambient if ambient else REPO
    return dict(os.environ, PYTHONPATH=path)


def _worker_code(coord, configure="max_iter=2000, max_sleep=0.05"):
    return (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from lua_mapreduce_tpu_torch import FileJobStore, Worker\n"
        f"w = Worker(FileJobStore({coord!r})).configure({configure})\n"
        "w.execute()\n")


def _wc_spec_line(corpus_dir, storage):
    return (f"spec = TaskSpec(taskfn={WC!r}, mapfn={WC!r}, "
            f"partitionfn={WC!r}, reducefn={WC!r}, "
            f"init_args={{'corpus_dir': {corpus_dir!r}, "
            f"'n_splits': {N_SPLITS}, 'build': False, 'device': 'cpu'}}, "
            f"storage={storage!r})\n")


def _ls_spec_line(n_iters, storage):
    return (f"spec = TaskSpec(taskfn={LS!r}, mapfn={LS!r}, "
            f"partitionfn={LS!r}, reducefn={LS!r}, combinerfn={LS!r}, "
            f"finalfn={LS!r}, init_args={{'n_iters': {n_iters}, "
            f"'device': 'cpu'}}, "
            f"storage={storage!r})\n")


def _server_code(coord, spec_line, patch="", server_args=""):
    """A ``python -c`` coordinator: optional Server method patches
    (stall markers for deterministic kill windows) + configure + loop."""
    return (
        "import sys, os, signal, time, threading\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from lua_mapreduce_tpu_torch import FileJobStore, Server, TaskSpec, "
        "Worker\n"
        "from lua_mapreduce_tpu_torch.engine.server import Server as _S\n"
        + patch + spec_line +
        f"store = FileJobStore({coord!r})\n"
        f"server = Server(store, poll_interval=0.05{server_args})"
        ".configure(spec)\n"
        "server.loop()\n"
        "from lua_mapreduce_tpu_torch.faults.retry import COUNTERS\n"
        "print('FENCED', COUNTERS.snapshot().get('fenced_writes', 0), "
        "flush=True)\n")


def _stall_wait_patch(phase):
    """Stall (forever) on entering the named barrier phase, once. The
    renewal daemon keeps the lease alive through the stall, so the hot
    standby stays standing by until the SIGKILL actually lands."""
    return (
        "_orig_wait = _S._wait_phase\n"
        "def _stall(self, ns, total, phase, progress):\n"
        f"    if phase == {phase!r} and not getattr(self, '_st', False):\n"
        "        self._st = True\n"
        "        print('STALLED', flush=True)\n"
        "        time.sleep(3600)\n"
        "    return _orig_wait(self, ns, total, phase, progress)\n"
        "_S._wait_phase = _stall\n")


_STALL_PREMERGE_PATCH = (
    "def _stall(self, store, n_map, progress):\n"
    "    print('STALLED', flush=True)\n"
    "    time.sleep(3600)\n"
    "_S._pipelined_map_phase = _stall\n")

_STALL_SAVE_PATCH = (
    "_orig_save = _S._save_loop_state\n"
    "def _stall(self, iteration):\n"
    "    if iteration == 3:\n"
    "        print('STALLED', flush=True)\n"
    "        time.sleep(3600)\n"
    "    return _orig_save(self, iteration)\n"
    "_S._save_loop_state = _stall\n")

# the flip-window kill: checkpoint WRITTEN, doc flip NOT — the exact
# crash the keep-{N-1,N} checkpoint sweep exists for
_KILL_IN_FLIP_WINDOW_PATCH = (
    "_orig_save = _S._save_loop_state\n"
    "def _boom(self, iteration):\n"
    "    _orig_save(self, iteration)\n"
    "    if iteration == 6:\n"
    "        print('SAVED6', flush=True)\n"
    "        os.kill(os.getpid(), signal.SIGKILL)\n"
    "_S._save_loop_state = _boom\n")

# mark the zombie window, then keep polling: the SIGSTOP lands inside
# the sleep, the post-SIGCONT continuation walks straight into the
# fenced housekeeping ops
_ZOMBIE_WINDOW_PATCH = (
    "_orig_wait = _S._wait_phase\n"
    "def _zwait(self, ns, total, phase, progress):\n"
    "    if phase == 'map' and not getattr(self, '_zm', False):\n"
    "        self._zm = True\n"
    "        print('ZWINDOW', flush=True)\n"
    "        time.sleep(3.0)\n"
    "    return _orig_wait(self, ns, total, phase, progress)\n"
    "_S._wait_phase = _zwait\n")


def _build_corpus(tmp_path):
    from examples.wordcount_big import corpus
    corpus_dir = str(tmp_path / "corpus")
    corpus.build(corpus_dir, n_splits=N_SPLITS)
    golden = Counter()
    for i in range(N_SPLITS):
        with open(corpus.split_path(corpus_dir, i)) as f:
            golden.update(f.read().split())
    return corpus_dir, dict(golden)


def _wc_spec(corpus_dir, storage):
    return TaskSpec(taskfn=WC, mapfn=WC, partitionfn=WC, reducefn=WC,
                    init_args={"corpus_dir": corpus_dir,
                               "n_splits": N_SPLITS, "build": False,
                               "device": "cpu"},
                    storage=storage)


def _ls_spec(n_iters, storage):
    return TaskSpec(taskfn=LS, mapfn=LS, partitionfn=LS, reducefn=LS,
                    combinerfn=LS, finalfn=LS,
                    init_args={"n_iters": n_iters, "device": "cpu"},
                    storage=storage)


def _results(storage):
    return {k: vs[0]
            for k, vs in iter_results(get_storage_from(storage), "result")}


def _worker_thread(store, **cfg):
    cfg.setdefault("max_iter", 5000)
    cfg.setdefault("max_sleep", 0.05)
    w = Worker(store).configure(**cfg)
    t = threading.Thread(target=w.execute, daemon=True)
    t.start()
    return t


def _server_thread(store, result, key="stats", spec=None, **kw):
    kw.setdefault("poll_interval", 0.05)

    def run():
        server = Server(store, **kw)
        if spec is not None:
            server.configure(spec)
        result[key + "_server"] = server
        try:
            result[key] = server.loop()
        except BaseException as exc:
            result[key + "_error"] = exc
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _assert_no_repetitions(store):
    for ns in ("map_jobs", "red_jobs"):
        reps = [d["repetitions"] for d in store.jobs(ns)]
        assert all(r == 0 for r in reps), (ns, reps)


def _kill_all(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=10)
        except Exception:
            pass


# -- smoke tier (the test.sh `-k smoke` gate) -------------------------------

def test_smoke_lease_election_epoch_fencing_virtual_clock():
    """The lease ladder on an injectable clock: acquire → refuse live →
    renew → expiry takeover (epoch bump, took_over) → the fenced loser
    can neither renew nor validate → clean release hands over WITHOUT
    a takeover verdict, still bumping the epoch."""
    store = MemJobStore()
    now = [100.0]
    a = LeaderLease(store, holder="A", ttl_s=10.0, clock=lambda: now[0])
    b = LeaderLease(store, holder="B", ttl_s=10.0, clock=lambda: now[0])

    assert a.try_acquire() and a.epoch == 1 and not a.took_over
    assert not b.try_acquire(), "live lease must refuse a second leader"
    now[0] += 5.0
    assert a.renew() and a.validate()

    now[0] += 10.1                      # strictly past A's deadline
    assert b.try_acquire() and b.epoch == 2
    assert b.took_over, "expiry acquire must carry the takeover verdict"
    assert not a.renew(), "the ousted leader's renew must CAS-fail"
    assert not a.validate(), "a fenced lease must never validate"

    c = LeaderLease(store, holder="C", ttl_s=10.0, clock=lambda: now[0])
    b.release()
    doc = store.pt_get("leader")
    assert doc["holder"] == "" and b.epoch == 0
    assert c.try_acquire() and c.epoch == 3
    assert not c.took_over, "a released lease is a handover, not a takeover"


def test_smoke_fenced_store_rejects_and_lands_on_errors_stream():
    """Satellite: a FencedJobStore mutation under a stale epoch raises
    the PERMANENT StaleLeaderError carrying the fencing evidence, bumps
    fenced_writes, and lands the rejection on the job store's errors
    stream with top-level epoch/holder diagnosis keys."""
    store = MemJobStore()
    now = [0.0]
    a = LeaderLease(store, holder="A", ttl_s=5.0, clock=lambda: now[0])
    assert a.try_acquire()
    fenced = FencedJobStore(store, a)
    fenced.put_task({"_id": "unique", "status": "WAIT"})   # live: passes
    assert store.get_task() is not None

    now[0] += 6.0
    b = LeaderLease(store, holder="B", ttl_s=5.0, clock=lambda: now[0])
    assert b.try_acquire() and b.epoch == 2

    before = COUNTERS.snapshot()
    with pytest.raises(StaleLeaderError) as ei:
        fenced.update_task({"poison": True})
    err = ei.value
    assert err.transient is False, "fenced writes must never be retried"
    assert err.op == "update_task"
    assert err.epoch == 1 and err.current_epoch == 2 and err.holder == "B"
    delta = COUNTERS.delta(before, COUNTERS.snapshot())
    assert delta.get("fenced_writes", 0) >= 1
    assert store.get_task().get("poison") is None, \
        "the rejected mutation must not have landed"

    errs = store.drain_errors()
    assert any(e.get("classification") == "fenced-write"
               and e.get("op") == "update_task"
               and e.get("epoch") == 1 and e.get("current_epoch") == 2
               and e.get("current_holder") == "B" for e in errs), errs

    # reads stay unfenced: a zombie may diagnose, never mutate
    assert fenced.get_task() is not None


def test_smoke_ha_server_clean_lifecycle(tmp_path):
    """Server(ha=True) with no contention: elect at epoch 1, run the
    loop task fenced end-to-end, release on completion (holder cleared,
    epoch retained in the doc for the next election's bump)."""
    import examples.loopsum as loopsum
    store = MemJobStore()
    storage = f"shared:{tmp_path}/spill"
    spec = _ls_spec(3, storage)
    server = Server(store, poll_interval=0.01, ha=True,
                    lease_ttl_s=5.0).configure(spec)
    wt = _worker_thread(store, max_sleep=0.01)
    stats = server.loop()
    wt.join(timeout=30)
    assert not wt.is_alive()

    assert [it.iteration for it in stats.iterations] == [1, 2, 3]
    acc, result = loopsum.expected(3)
    assert loopsum.ACC == acc
    assert _results(storage) == result
    doc = store.pt_get("leader")
    assert doc["holder"] == "" and doc["epoch"] == 1


def test_smoke_hot_standby_returns_after_leader_finishes(tmp_path):
    """A standby that never gets to lead: it wakes on the leader topic,
    watches the task go active then FINISHED under the leader, and
    returns its own empty stats — results live in result storage."""
    import examples.loopsum as loopsum
    store = MemJobStore()
    storage = f"shared:{tmp_path}/spill"
    spec = _ls_spec(2, storage)
    res = {}
    lead = _server_thread(store, res, key="lead", spec=spec,
                          poll_interval=0.01, ha=True, lease_ttl_s=5.0)
    # no workers yet: the map barrier holds the task ACTIVE while the
    # standby proves it is hot (standby_wakeups observed)
    deadline = time.time() + 10
    while time.time() < deadline:
        task = store.get_task()
        if task is not None and task.get("status") != "FINISHED":
            break
        time.sleep(0.005)
    else:
        pytest.fail("leader never opened the task")

    before = COUNTERS.snapshot()
    standby = _server_thread(store, res, key="sb", poll_interval=0.01,
                             ha=True, lease_ttl_s=5.0)
    deadline = time.time() + 10
    while time.time() < deadline:
        if COUNTERS.delta(before, COUNTERS.snapshot()).get(
                "standby_wakeups", 0) >= 1:
            break
        time.sleep(0.005)
    else:
        pytest.fail("standby never woke on the leader topic")

    wt = _worker_thread(store, max_sleep=0.01)
    lead.join(timeout=60)
    standby.join(timeout=60)
    wt.join(timeout=30)
    assert not lead.is_alive() and not standby.is_alive()
    assert "sb_error" not in res, res.get("sb_error")
    assert res["sb"].iterations == [], "a pure standby led no iterations"
    assert res["sb_server"].finished_value is None
    _, result = loopsum.expected(2)
    assert _results(storage) == result


def test_smoke_takeover_mid_loop_restores_threaded_state(tmp_path,
                                                         monkeypatch):
    """In-process takeover: the leader crashes in finalfn mid-loop
    (lease left to EXPIRE — the SIGKILL-equivalent path), module state
    is reset to init values (simulating the standby being a different
    process), and the takeover must restore the checkpointed threaded
    state — the order-sensitive fold only matches expected() if
    restore_state really fed iteration N exactly what N-1 produced."""
    import examples.loopsum as loopsum
    store = MemJobStore()
    storage = f"shared:{tmp_path}/spill"
    spec = _ls_spec(4, storage)
    monkeypatch.setattr(loopsum, "CRASH_AT", 2)

    res = {}
    wt = _worker_thread(store, max_sleep=0.01)
    lead = _server_thread(store, res, key="lead", spec=spec,
                          poll_interval=0.01, ha=True, lease_ttl_s=0.5)
    lead.join(timeout=30)
    assert not lead.is_alive(), "leader should have crashed at CRASH_AT"
    assert isinstance(res.get("lead_error"), RuntimeError)

    # the standby is "another process": it starts from init-time state
    loopsum.ACC = 0
    loopsum.ITER = 0
    before = COUNTERS.snapshot()
    standby = Server(store, poll_interval=0.01, ha=True, lease_ttl_s=0.5)
    stats = standby.loop()
    wt.join(timeout=30)

    assert COUNTERS.delta(before, COUNTERS.snapshot()).get(
        "leader_takeovers", 0) >= 1
    assert stats.iterations[0].iteration == 3, \
        "takeover must resume at the doc's iteration, not restart"
    acc, result = loopsum.expected(4)
    assert loopsum.ACC == acc, "threaded state diverged across takeover"
    assert _results(storage) == result
    _assert_no_repetitions(store)
    doc = store.pt_get("leader")
    assert doc["epoch"] == 2 and doc["holder"] == ""


# -- satellite: a takeover is a resume — the trace timeline survives --------

def test_takeover_preserves_both_tenures_trace_spans(tmp_path, monkeypatch):
    """Both leaders' spans land in ONE collection: the epoch-1
    leader.acquire, the epoch-2 leader.takeover, and phase spans from
    iterations on both sides of the crash."""
    import examples.loopsum as loopsum
    from lua_mapreduce_tpu_torch.trace.collect import TraceCollection
    from lua_mapreduce_tpu_torch.trace.span import Tracer, install_tracer

    store = MemJobStore()
    storage = f"shared:{tmp_path}/spill"
    spec = _ls_spec(4, storage)
    monkeypatch.setattr(loopsum, "CRASH_AT", 2)
    install_tracer(Tracer())
    try:
        res = {}
        wt = _worker_thread(store, max_sleep=0.01)
        lead = _server_thread(store, res, key="lead", spec=spec,
                              poll_interval=0.01, ha=True, lease_ttl_s=0.5)
        lead.join(timeout=30)
        assert not lead.is_alive() and "lead_error" in res
        standby = Server(store, poll_interval=0.01, ha=True,
                         lease_ttl_s=0.5)
        standby.loop()
        wt.join(timeout=30)
    finally:
        install_tracer(None)

    col = TraceCollection.from_store(unwrap(get_storage_from(storage)))
    by_name = {}
    for s in col.spans:
        by_name.setdefault(s["name"], []).append(s)
    assert "leader.acquire" in by_name, sorted(by_name)
    assert "leader.takeover" in by_name, \
        "the first tenure's spans were purged by the takeover"
    assert any(s.get("attrs", {}).get("epoch") == 1
               for s in by_name["leader.acquire"])
    assert any(s.get("attrs", {}).get("epoch") == 2
               for s in by_name["leader.takeover"])
    its = {s.get("it") for s in col.spans}
    assert 1 in its and 4 in its, \
        f"one continuous timeline must span both tenures, got {sorted(its)}"


def test_fresh_start_after_takeover_keeps_trace_purges_state(tmp_path):
    """The purge gating edge: a takeover landing where the doc is
    already FINISHED drops state and starts the task FRESH — but it is
    still a takeover, so `_trace.*` survives while the stale
    `_state.*` checkpoints (a CORRECTNESS purge) do not. A plain
    non-takeover fresh start purges both."""
    storage = f"shared:{tmp_path}/spill"
    spec = _ls_spec(1, storage)
    raw = unwrap(get_storage_from(storage))

    def seed():
        with raw.builder() as b:
            b.write_bytes(b"previous tenure's timeline")
            b.build("_trace.zombie.0")
        with raw.builder() as b:
            b.write_bytes(b"stale checkpoint")
            b.build(f"{STATE_NS}.3")

    # takeover leg: dead leader's expired lease + FINISHED doc
    store = MemJobStore()
    seed()
    store.put_task({"_id": "unique", "status": TaskStatus.FINISHED.value,
                    "iteration": 1, "spec": spec.describe()})
    dead = LeaderLease(store, holder="dead", ttl_s=0.2)
    assert dead.try_acquire()
    time.sleep(0.45)                       # let the lease expire
    server = Server(store, poll_interval=0.01, ha=True,
                    lease_ttl_s=5.0).configure(spec)
    wt = _worker_thread(store, max_sleep=0.01)
    server.loop()
    wt.join(timeout=30)
    assert server._took_over is False      # reset after the clean return
    assert raw.exists("_trace.zombie.0"), \
        "takeover fresh-start must NOT purge the dead leader's spans"
    assert not raw.exists(f"{STATE_NS}.3"), \
        "stale loop-state must be purged even on the takeover edge"

    # control: an ordinary fresh start purges the foreign timeline
    store2 = MemJobStore()
    seed()
    server2 = Server(store2, poll_interval=0.01).configure(
        _ls_spec(1, storage))
    wt2 = _worker_thread(store2, max_sleep=0.01)
    server2.loop()
    wt2.join(timeout=30)
    assert not raw.exists("_trace.zombie.0")
    assert not raw.exists(f"{STATE_NS}.3")


# -- fake-GCS loop-checkpoint takeover (in-process, two backends) -----------

def test_loop_checkpoint_takeover_on_fake_gcs(tmp_path, monkeypatch):
    """The mid-loop takeover with the checkpoint riding OBJECT storage
    (fake google.cloud.storage): the CRC frame round-trips through the
    blob API and the takeover resumes the threaded fold exactly."""
    import examples.loopsum as loopsum
    from lua_mapreduce_tpu_torch.store.fake_gcs import (install_fake_gcs,
                                                  uninstall_fake_gcs)
    prev = install_fake_gcs()
    try:
        store = MemJobStore()
        storage = "object:gs://ha-bkt/spill"
        spec = _ls_spec(8, storage)
        monkeypatch.setattr(loopsum, "CRASH_AT", 4)

        res = {}
        wt = _worker_thread(store, max_sleep=0.01)
        lead = _server_thread(store, res, key="lead", spec=spec,
                              poll_interval=0.01, ha=True, lease_ttl_s=0.5)
        lead.join(timeout=60)
        assert not lead.is_alive() and "lead_error" in res

        loopsum.ACC = 0                   # "fresh process" standby
        loopsum.ITER = 0
        before = COUNTERS.snapshot()
        standby = Server(store, poll_interval=0.01, ha=True,
                         lease_ttl_s=0.5)
        stats = standby.loop()
        wt.join(timeout=30)

        assert COUNTERS.delta(before, COUNTERS.snapshot()).get(
            "leader_takeovers", 0) >= 1
        assert stats.iterations[0].iteration == 5
        acc, result = loopsum.expected(8)
        assert loopsum.ACC == acc
        assert _results(storage) == result
        _assert_no_repetitions(store)
    finally:
        uninstall_fake_gcs(prev)


# -- heavy tier: OS-level chaos ---------------------------------------------

_PASSIVE_LEGS = {
    "mid-map": ("wc", _stall_wait_patch("map"), ""),
    "mid-premerge": ("wc", _STALL_PREMERGE_PATCH,
                     ", pipeline=True, premerge_min_runs=2"),
    "reduce-barrier": ("wc", _stall_wait_patch("reduce"), ""),
    "between-iterations": ("ls", _STALL_SAVE_PATCH, ""),
}


@pytest.mark.heavy
@pytest.mark.parametrize("leg", sorted(_PASSIVE_LEGS),
                         ids=sorted(_PASSIVE_LEGS))
def test_sigkill_server_passive_restart_resumes(tmp_path, leg):
    """Satellite: the single-server restart matrix. A (non-HA) server
    is SIGKILLed at a deterministic phase marker; a NEW server pointed
    at the same job store resumes from the task doc — no spec
    reconfiguration, workers never restarted — and the result equals
    the fault-free golden with zero repetition charges."""
    kind, patch, server_args = _PASSIVE_LEGS[leg]
    import examples.loopsum as loopsum
    coord = str(tmp_path / "coord")
    storage = f"object:{tmp_path}/obj"
    store = FileJobStore(coord)
    if kind == "wc":
        corpus_dir, golden = _build_corpus(tmp_path)
        spec_line = _wc_spec_line(corpus_dir, storage)
    else:
        spec_line = _ls_spec_line(6, storage)
        golden = None

    env = _env()
    procs = []
    try:
        for _ in range(3):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _worker_code(coord)], env=env,
                stdout=subprocess.DEVNULL))
        victim = subprocess.Popen(
            [sys.executable, "-c",
             _server_code(coord, spec_line, patch, server_args)],
            env=env, stdout=subprocess.PIPE, text=True)
        procs.append(victim)
        assert victim.stdout.readline().strip() == "STALLED", \
            "server never reached the stall marker"
        victim.kill()
        victim.wait(timeout=10)

        kw = {"poll_interval": 0.05}
        if "pipeline" in server_args:
            kw.update(pipeline=True, premerge_min_runs=2)
        resumed = Server(store, **kw)       # spec comes from the task doc
        stats = resumed.loop()
    finally:
        _kill_all(procs)

    it = stats.iterations[-1]
    assert it.map.failed == 0 and it.reduce.failed == 0
    _assert_no_repetitions(store)
    if kind == "wc":
        assert stats.iterations[0].iteration == 1
        assert _results(storage) == golden
    else:
        # stall sat before _save_loop_state(3): the doc still reads
        # iteration 2, and _state.2 (published at the previous flip)
        # feeds the re-run of finalfn over iteration 2's stored results
        assert stats.iterations[0].iteration == 2
        acc, result = loopsum.expected(6)
        assert loopsum.ACC == acc
        assert _results(storage) == result


_HA_LEGS = {
    "mid-map": ("wc", _stall_wait_patch("map"), ""),
    "mid-premerge": ("wc", _STALL_PREMERGE_PATCH,
                     ", pipeline=True, premerge_min_runs=2"),
    "reduce-barrier": ("wc", _stall_wait_patch("reduce"), ""),
    "between-iterations": ("ls", _STALL_SAVE_PATCH, ""),
}


@pytest.mark.heavy
@pytest.mark.parametrize("leg", sorted(_HA_LEGS), ids=sorted(_HA_LEGS))
def test_sigkill_leader_hot_standby_takes_over(tmp_path, leg):
    """The tentpole acceptance: SIGKILL the LEADER at a phase marker
    while a hot standby stands by in this process. The standby must
    take over mid-phase via the resume matrix and finish to the
    fault-free golden with ZERO repetition charges — workers are
    leader-agnostic and their in-flight claims survive."""
    kind, patch, server_args = _HA_LEGS[leg]
    import examples.loopsum as loopsum
    coord = str(tmp_path / "coord")
    storage = f"object:{tmp_path}/obj"
    store = FileJobStore(coord)
    if kind == "wc":
        corpus_dir, golden = _build_corpus(tmp_path)
        spec_line = _wc_spec_line(corpus_dir, storage)
    else:
        spec_line = _ls_spec_line(8, storage)
        golden = None

    env = _env()
    procs = []
    res = {}
    try:
        for _ in range(3):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _worker_code(coord)], env=env,
                stdout=subprocess.DEVNULL))
        leader = subprocess.Popen(
            [sys.executable, "-c",
             _server_code(coord, spec_line, patch,
                          ", ha=True, lease_ttl_s=1.5" + server_args)],
            env=env, stdout=subprocess.PIPE, text=True)
        procs.append(leader)
        assert leader.stdout.readline().strip() == "STALLED"

        before = COUNTERS.snapshot()
        kw = {"ha": True, "lease_ttl_s": 1.5}
        if "pipeline" in server_args:
            kw.update(pipeline=True, premerge_min_runs=2)
        standby = _server_thread(store, res, key="sb", **kw)
        # prove hotness: the standby is probing before the leader dies
        deadline = time.time() + 10
        while time.time() < deadline:
            if COUNTERS.delta(before, COUNTERS.snapshot()).get(
                    "standby_wakeups", 0) >= 1:
                break
            time.sleep(0.01)
        else:
            pytest.fail("standby never entered the standby loop")

        leader.kill()
        leader.wait(timeout=10)
        standby.join(timeout=120)
        assert not standby.is_alive(), "standby never finished the task"
        assert "sb_error" not in res, res.get("sb_error")
    finally:
        _kill_all(procs)

    stats = res["sb"]
    assert COUNTERS.delta(before, COUNTERS.snapshot()).get(
        "leader_takeovers", 0) >= 1
    it = stats.iterations[-1]
    assert it.map.failed == 0 and it.reduce.failed == 0
    _assert_no_repetitions(store)
    doc = store.pt_get("leader")
    assert doc["epoch"] == 2 and doc["holder"] == ""
    if kind == "wc":
        assert _results(storage) == golden
    else:
        acc, result = loopsum.expected(8)
        assert loopsum.ACC == acc, \
            "threaded state diverged across the takeover"
        assert _results(storage) == result


@pytest.mark.heavy
def test_sigstop_zombie_leader_is_fenced_on_revival(tmp_path):
    """The zombie leg: SIGSTOP the leader past its TTL (GC-pause /
    partition stand-in), let the hot standby take over and finish,
    then SIGCONT. The revived zombie's next server-side mutation must
    be fenced (fenced_writes > 0, exit through the abdication path
    with code 0), the rejection must land on the errors stream with
    the epoch evidence, and the output must equal the golden."""
    coord = str(tmp_path / "coord")
    storage = f"object:{tmp_path}/obj"
    store = FileJobStore(coord)
    corpus_dir, golden = _build_corpus(tmp_path)
    spec_line = _wc_spec_line(corpus_dir, storage)

    env = _env()
    procs = []
    res = {}
    try:
        for _ in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _worker_code(coord)], env=env,
                stdout=subprocess.DEVNULL))
        zombie = subprocess.Popen(
            [sys.executable, "-c",
             _server_code(coord, spec_line, _ZOMBIE_WINDOW_PATCH,
                          ", ha=True, lease_ttl_s=1.0")],
            env=env, stdout=subprocess.PIPE, text=True)
        procs.append(zombie)

        assert zombie.stdout.readline().strip() == "ZWINDOW"
        # the zombie is inside its marker window with the renewal
        # daemon still beating: start the standby now (it can only
        # stand by — the lease is live) and prove it is hot before
        # freezing the leader
        before = COUNTERS.snapshot()
        standby = _server_thread(store, res, key="sb", ha=True,
                                 lease_ttl_s=1.0)
        deadline = time.time() + 10
        while time.time() < deadline:
            if COUNTERS.delta(before, COUNTERS.snapshot()).get(
                    "standby_wakeups", 0) >= 1:
                break
            time.sleep(0.01)
        else:
            pytest.fail("standby never entered the standby loop")
        os.kill(zombie.pid, signal.SIGSTOP)    # freeze renewals too

        standby.join(timeout=120)
        assert not standby.is_alive() and "sb_error" not in res, \
            res.get("sb_error")
        assert COUNTERS.delta(before, COUNTERS.snapshot()).get(
            "leader_takeovers", 0) >= 1

        os.kill(zombie.pid, signal.SIGCONT)
        out, _ = zombie.communicate(timeout=60)
        assert zombie.returncode == 0, \
            "the fenced zombie must abdicate cleanly, not crash"
        fenced_line = [ln for ln in out.splitlines()
                       if ln.startswith("FENCED")]
        assert fenced_line, out
        assert int(fenced_line[0].split()[1]) > 0, \
            "the zombie's guarded writes were not fenced"
    finally:
        _kill_all(procs)

    # the rejection's post-mortem evidence on the errors stream
    errs = list(res["sb_server"].errors) + list(store.drain_errors())
    fenced_errs = [e for e in errs
                   if e.get("classification") == "fenced-write"]
    assert fenced_errs, errs
    assert any(e.get("epoch") == 1 and e.get("current_epoch") == 2
               for e in fenced_errs), fenced_errs

    assert _results(storage) == golden
    _assert_no_repetitions(store)


@pytest.mark.heavy
def test_sigkill_inside_checkpoint_flip_window_filestore(tmp_path):
    """The exact window the keep-{N-1,N} checkpoint sweep exists for:
    the leader SIGKILLs itself right after publishing _state.6 but
    BEFORE the doc flips to iteration 6. The takeover resumes at the
    doc's iteration 5, must find _state.5 still present (the sweep may
    not have collected it), and the threaded fold converges to the
    10-iteration golden."""
    import examples.loopsum as loopsum
    coord = str(tmp_path / "coord")
    storage = f"shared:{tmp_path}/spill"
    store = FileJobStore(coord)
    spec_line = _ls_spec_line(10, storage)

    # the victim runs its own worker threads: SIGKILL lands between
    # phases (inside _save_loop_state), so no claim is in flight and
    # the takeover's zero-repetitions assertion is exact
    code = (
        "import sys, os, signal, threading, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from lua_mapreduce_tpu_torch import FileJobStore, Server, TaskSpec, "
        "Worker\n"
        "from lua_mapreduce_tpu_torch.engine.server import Server as _S\n"
        + _KILL_IN_FLIP_WINDOW_PATCH + spec_line +
        f"store = FileJobStore({coord!r})\n"
        "for i in range(2):\n"
        "    w = Worker(store).configure(max_iter=5000, max_sleep=0.05)\n"
        "    threading.Thread(target=w.execute, daemon=True).start()\n"
        "server = Server(store, poll_interval=0.05, ha=True, "
        "lease_ttl_s=1.0).configure(spec)\n"
        "server.loop()\n")
    env = _env()
    victim = subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, text=True)
    try:
        assert victim.stdout.readline().strip() == "SAVED6"
        victim.wait(timeout=10)             # SIGKILLed itself

        raw = unwrap(get_storage_from(storage))
        assert raw.exists(f"{STATE_NS}.6")
        assert raw.exists(f"{STATE_NS}.5"), \
            "the sweep collected the checkpoint the flip-window resume needs"

        before = COUNTERS.snapshot()
        takeover = Server(store, poll_interval=0.05, ha=True,
                          lease_ttl_s=1.0)
        wts = [_worker_thread(store) for _ in range(2)]
        stats = takeover.loop()
        for t in wts:
            t.join(timeout=30)
    finally:
        if victim.poll() is None:
            victim.kill()
        victim.wait(timeout=10)

    assert COUNTERS.delta(before, COUNTERS.snapshot()).get(
        "leader_takeovers", 0) >= 1
    assert stats.iterations[0].iteration == 5, \
        "the takeover must resume at the doc's (pre-flip) iteration"
    acc, result = loopsum.expected(10)
    assert loopsum.ACC == acc
    assert _results(storage) == result
    _assert_no_repetitions(store)
    raw = unwrap(get_storage_from(storage))
    assert len(raw.list(f"{STATE_NS}.*")) <= 2, \
        "the checkpoint sweep stopped collecting"
    doc = store.pt_get("leader")
    assert doc["epoch"] == 2 and doc["holder"] == ""


# -- parity with the JAX package ---------------------------------------------

def test_cross_package_lease_contention_fences_and_shares_state(tmp_path):
    """A JAX LeaderLease and a port LeaderLease on one FileJobStore
    directory, one virtual clock: the first wins, the other is refused
    while the lease is live, takes over past the TTL with the epoch
    bumped, and the ousted holder of the other package is fenced. The
    ``_state.<N>`` frame either package's server writes decodes in the
    other."""
    import lua_mapreduce_tpu.coord.filestore as jfs
    import lua_mapreduce_tpu.faults.errors as jerr
    import lua_mapreduce_tpu.sched.lease as jlease
    from lua_mapreduce_tpu_torch.sched.lease import (frame_state,
                                                     unframe_state)
    coord = str(tmp_path / "coord")
    jstore, pstore = jfs.FileJobStore(coord), FileJobStore(coord)
    now = [1000.0]
    clock = lambda: now[0]    # noqa: E731 — one clock for both packages
    jax_lease = jlease.LeaderLease(jstore, holder="jax", ttl_s=5.0,
                                   clock=clock)
    port_lease = LeaderLease(pstore, holder="port", ttl_s=5.0, clock=clock)

    assert jax_lease.try_acquire() and jax_lease.epoch == 1
    assert not port_lease.try_acquire(), "a live JAX lease refuses the port"
    assert pstore.pt_get("leader")["holder"] == "jax"
    now[0] += 2.0
    assert jax_lease.renew()
    now[0] += 5.5
    assert port_lease.try_acquire() and port_lease.epoch == 2
    assert port_lease.took_over
    # the ousted JAX holder is fenced by the port's epoch
    assert not jax_lease.renew() and not jax_lease.validate()
    with pytest.raises(jerr.StaleLeaderError) as ei:
        jlease.FencedJobStore(jstore, jax_lease).put_task({"x": 1})
    assert ei.value.current_epoch == 2 and ei.value.holder == "port"
    # the port's guarded writes pass and the JAX package reads them
    FencedJobStore(pstore, port_lease).put_task(
        {"_id": "unique", "status": "WAIT", "iteration": 3})
    assert jstore.get_task()["iteration"] == 3
    # and back: the JAX package takes over the port's expired lease
    now[0] += 6.0
    jax2 = jlease.LeaderLease(jstore, holder="jax2", ttl_s=5.0, clock=clock)
    assert jax2.try_acquire() and jax2.epoch == 3
    with pytest.raises(StaleLeaderError):
        FencedJobStore(pstore, port_lease).update_task({"x": 2})
    jax2.release()
    assert pstore.pt_get("leader") == {**jstore.pt_get("leader")}
    assert pstore.pt_get("leader")["holder"] == ""

    state = {"acc": 812, "iter": 3, "xs": [0.5, 2.0]}
    assert jlease.unframe_state(frame_state(state)) == state
    assert unframe_state(jlease.frame_state(state)) == state
    assert frame_state(state) == jlease.frame_state(state)


def _result_bytes(storage):
    st = unwrap(get_storage_from(storage))
    return {n: st.read_range(n, 0, st.size(n))
            for n in st.list("result.P*")}


def _jax_uninterrupted(spec_kw, storage):
    """The JAX package's run of the same task on its own store (a
    Server and two worker threads): its result file bytes."""
    import lua_mapreduce_tpu as jmr
    store = jmr.MemJobStore()
    spec = jmr.TaskSpec(storage=storage, **spec_kw)
    server = jmr.Server(store, poll_interval=0.01).configure(spec)
    ts = []
    for _ in range(2):
        w = jmr.Worker(store).configure(max_iter=5000, max_sleep=0.01)
        ts.append(threading.Thread(target=w.execute, daemon=True))
        ts[-1].start()
    server.loop()
    for t in ts:
        t.join(timeout=30)
    from lua_mapreduce_tpu.store.router import get_storage_from as jget
    st = jget(storage)
    return {n: st.read_range(n, 0, st.size(n))
            for n in st.list("result.P*")}


@pytest.mark.parametrize("task", ["wordcount", "loopsum"])
def test_port_takeover_matches_jax_uninterrupted_run(task, tmp_path,
                                                     monkeypatch):
    """A port HA leader crashes mid-run (its lease left to expire, as
    after a SIGKILL) — in the reduce barrier of the word count, in
    finalfn of loopsum's iteration 2 — and a port standby takes over:
    the result files are byte-equal to the JAX package's uninterrupted
    run of the same task."""
    import examples.loopsum as loopsum
    from lua_mapreduce_tpu_torch.engine.server import Server as PortServer
    if task == "wordcount":
        corpus_dir, _ = _build_corpus(tmp_path)
        kw = dict(taskfn=WC, mapfn=WC, partitionfn=WC, reducefn=WC,
                  init_args={"corpus_dir": corpus_dir,
                             "n_splits": N_SPLITS, "build": False})
        orig = PortServer._wait_phase

        def crash_once(self, ns, total, phase, progress):
            if phase == "reduce" and not getattr(crash_once, "done", 0):
                crash_once.done = 1
                raise RuntimeError("injected leader crash in the reduce")
            return orig(self, ns, total, phase, progress)
        monkeypatch.setattr(PortServer, "_wait_phase", crash_once)
    else:
        kw = dict(taskfn=LS, mapfn=LS, partitionfn=LS, reducefn=LS,
                  combinerfn=LS, finalfn=LS, init_args={"n_iters": 4})
    want = _jax_uninterrupted(kw, f"shared:{tmp_path}/jax")
    loopsum.ACC, loopsum.ITER = 0, 0
    if task == "loopsum":
        monkeypatch.setattr(loopsum, "CRASH_AT", 2)

    store = MemJobStore()
    storage = f"shared:{tmp_path}/port"
    spec = TaskSpec(storage=storage, **{
        **kw, "init_args": {**kw["init_args"], "device": "cpu"}})
    res = {}
    wt = _worker_thread(store, max_sleep=0.01)
    lead = _server_thread(store, res, key="lead", spec=spec,
                          poll_interval=0.01, ha=True, lease_ttl_s=0.5)
    lead.join(timeout=60)
    assert not lead.is_alive() and isinstance(res.get("lead_error"),
                                              RuntimeError)
    loopsum.ACC, loopsum.ITER = 0, 0        # the standby's "fresh process"
    before = COUNTERS.snapshot()
    standby = Server(store, poll_interval=0.01, ha=True, lease_ttl_s=0.5)
    standby.loop()
    wt.join(timeout=30)
    assert COUNTERS.delta(before, COUNTERS.snapshot()).get(
        "leader_takeovers", 0) >= 1
    got = _result_bytes(storage)
    assert want and got == want
    _assert_no_repetitions(store)
    assert store.pt_get("leader")["epoch"] == 2
