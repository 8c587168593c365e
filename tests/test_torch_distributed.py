"""The port's distributed engine: Server + elastic Workers on the CPU.

Counterparts of tests/test_distributed.py (all but the ``object:``
store test, ROADMAP A6b): in-process thread pools over ``MemJobStore``,
multi-process pools of ``execute_worker``-style subprocesses over a
``FileJobStore``, injected worker failures, the resume matrix, the
heartbeat, a SIGKILLed worker. Beside them: the port's Server pool
against the JAX package's (word count, byte for byte, over the golden
matrix's four configurations × ``mem:`` / ``shared:``), the digits
trainer on a pool against both LocalExecutors, the loop-state
checkpoint, the trimmed options, and the device rule (a worker runs on
the card unless its task asks for the CPU).
"""

import glob
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from examples.wordcount.instrumented import read_count
from examples.wordcount.naive import naive_wordcount
from lua_mapreduce_tpu_torch import (FileJobStore, LocalExecutor,
                                     MemJobStore, PhaseFailed, Server,
                                     TaskSpec, Worker)
from lua_mapreduce_tpu_torch.core.constants import (MAP_NS, RED_NS, Status,
                                                    TaskStatus)
from lua_mapreduce_tpu_torch.store.router import get_storage_from

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(glob.glob(os.path.join(REPO, "examples", "wordcount",
                                       "*.py")))
CPU = {"device": "cpu"}


def _subprocess_env():
    ambient = os.environ.get("PYTHONPATH", "")
    path = REPO + os.pathsep + ambient if ambient else REPO
    return dict(os.environ, PYTHONPATH=path)


def _spec(storage, init_args=None, **fns):
    return TaskSpec(
        taskfn="examples.wordcount.taskfn",
        mapfn=fns.get("mapfn", "examples.wordcount.mapfn"),
        partitionfn="examples.wordcount.partitionfn",
        reducefn="examples.wordcount.reducefn",
        combinerfn=fns.get("combinerfn", "examples.wordcount.reducefn"),
        finalfn="examples.wordcount.finalfn",
        init_args={"files": CORPUS, **CPU, **(init_args or {})},
        storage=storage,
    )


def _run_pool(store, spec, n_workers=3, worker_kw=None, **server_kw):
    server = Server(store, poll_interval=0.02, **server_kw).configure(spec)
    workers = [Worker(store).configure(max_iter=400, max_sleep=0.05,
                                       **(worker_kw or {}))
               for _ in range(n_workers)]
    threads = [threading.Thread(target=w.execute, daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    stats = server.loop()
    for t in threads:
        t.join(timeout=30)
    return server, workers, stats


def _elastic_pool(store, stop):
    """Workers die after MAX_WORKER_RETRIES consecutive errors — keep
    replacing them, elastically."""
    while not stop.is_set():
        w = Worker(store).configure(max_iter=50, max_sleep=0.05)
        try:
            w.execute()
        except RuntimeError:
            continue


def test_inprocess_pool_matches_naive():
    import examples.wordcount.finalfn as finalfn
    store = MemJobStore()
    server, workers, stats = _run_pool(store, _spec("mem:tdist-basic"))
    assert dict(finalfn.counts) == naive_wordcount(CORPUS)
    it = stats.iterations[-1]
    assert it.map.count == len(CORPUS)
    assert it.map.failed == 0 and it.reduce.failed == 0
    assert sum(w.jobs_executed for w in workers) == \
        it.map.count + it.reduce.count
    assert all(w.device == torch.device("cpu") for w in workers)


def test_worker_failures_are_retried(tmp_path):
    """Injected mapfn failures mark jobs BROKEN; workers re-claim and
    finish; the run still produces the golden result."""
    import examples.wordcount.finalfn as finalfn
    count_file = str(tmp_path / "mapcalls")
    spec = _spec("mem:tdist-flaky", {"count_file": count_file,
                                     "fail_times": 2},
                 mapfn="examples.wordcount.instrumented", combinerfn=None)
    _, _, stats = _run_pool(MemJobStore(), spec)
    assert dict(finalfn.counts) == naive_wordcount(CORPUS)
    assert stats.iterations[-1].map.failed == 0
    assert read_count(count_file) == len(CORPUS) + 2


def test_failed_jobs_surface_in_stats(tmp_path):
    """A job that fails MAX_JOB_RETRIES times goes FAILED and the phase
    completes anyway (server.lua:192-205 scavenger semantics)."""
    spec = _spec("mem:tdist-allfail",
                 {"files": CORPUS[:1], "count_file": str(tmp_path / "c"),
                  "fail_times": 10_000},
                 mapfn="examples.wordcount.instrumented", combinerfn=None)
    store = MemJobStore()
    server = Server(store, poll_interval=0.02).configure(spec)
    stop = threading.Event()
    threading.Thread(target=_elastic_pool, args=(store, stop),
                     daemon=True).start()
    stats = server.loop()
    stop.set()
    assert stats.iterations[-1].map.failed == 1
    assert store.counts(MAP_NS)[Status.FAILED] == 1
    assert server.errors and \
        server.errors[-1]["classification"] == "user-code"


def test_strict_mode_raises_instead_of_partial_final(tmp_path):
    """strict=True: a map shard that keeps failing aborts with
    PhaseFailed BEFORE finalfn consumes the partial result."""
    import examples.wordcount.finalfn as finalfn
    spec = _spec("mem:tdist-strict",
                 {"count_file": str(tmp_path / "c"), "fail_times": 10_000},
                 mapfn="examples.wordcount.instrumented", combinerfn=None)
    store = MemJobStore()
    server = Server(store, poll_interval=0.02, strict=True).configure(spec)
    finalfn.counts.clear()
    stop = threading.Event()
    threading.Thread(target=_elastic_pool, args=(store, stop),
                     daemon=True).start()
    with pytest.raises(PhaseFailed) as exc:
        server.loop()
    stop.set()
    assert exc.value.phase == "map" and exc.value.failed >= 1
    assert exc.value.errors
    assert dict(finalfn.counts) == {}


def test_batched_pool_amortizes_control_rounds():
    """A server-deployed batch_k: the result matches the naive oracle and
    the pool's claim rounds come out under one claim per job."""
    import examples.wordcount.finalfn as finalfn
    store = MemJobStore()
    _, _, stats = _run_pool(store, _spec("mem:tdist-batched"), n_workers=2,
                            worker_kw={"batch_lease_s": 60.0}, batch_k=8)
    assert dict(finalfn.counts) == naive_wordcount(CORPUS)
    it = stats.iterations[-1]
    assert it.map.failed == 0 and it.reduce.failed == 0
    n_jobs = it.map.count + it.reduce.count
    assert 0 < it.claim_rounds < n_jobs, (it.claim_rounds, n_jobs)
    assert it.commit_rounds < 2 * n_jobs


def test_loop_strict_kwarg_overrides_constructor():
    store = MemJobStore()
    server = Server(store, poll_interval=0.02).configure(
        _spec("mem:tdist-strict-kwarg"))
    assert server.strict is False
    for _ in range(2):
        threading.Thread(target=Worker(store).configure(
            max_iter=400, max_sleep=0.05).execute, daemon=True).start()
    server.loop(strict=True)     # healthy run: strict changes nothing
    assert server.strict is True


_WORKER = ("from lua_mapreduce_tpu_torch import FileJobStore, Worker\n"
           "store = FileJobStore({root!r}, engine={engine!r})\n"
           "Worker(store).configure(max_iter=300, max_sleep=0.05)"
           ".execute()\n")


@pytest.mark.parametrize("engine", ["python", "auto"])
def test_multiprocess_pool(tmp_path, engine):
    """A multi-process elastic pool of port worker processes over a
    FileJobStore and shared-dir storage, the task on the CPU."""
    import examples.wordcount.finalfn as finalfn
    root, spill = str(tmp_path / "coord"), str(tmp_path / "spill")
    store = FileJobStore(root, engine=engine)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER.format(root=root, engine=engine)],
        env=_subprocess_env()) for _ in range(2)]
    try:
        stats = Server(store, poll_interval=0.05).configure(
            _spec(f"shared:{spill}")).loop()
    finally:
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0]
    assert dict(finalfn.counts) == naive_wordcount(CORPUS)
    it = stats.iterations[-1]
    assert it.map.count == len(CORPUS)
    assert it.map.failed == 0 and it.reduce.failed == 0
    # the reduce jobs name the processes that produced their runs
    producers = {d["worker"] for d in store.jobs(MAP_NS)}
    for doc in store.jobs(RED_NS):
        assert doc["value"]["mappers"]
        assert set(doc["value"]["mappers"]) <= producers


def test_missing_run_file_fails_loudly_naming_producer():
    """A reduce whose run file vanished raises naming the producer, not
    silently reducing fewer runs (pull-integrity, fs.lua:148-157)."""
    store = MemJobStore()
    server = Server(store, poll_interval=0.02).configure(
        _spec("mem:tdist-missing-run"))
    w = Worker(store, name="mapper-1").configure(
        max_iter=200, max_sleep=0.02, phases=("map",))
    t = threading.Thread(target=server.loop, daemon=True)
    t.start()
    while store.get_task() is None or \
            store.get_task().get("status") != TaskStatus.REDUCE.value:
        w.poll_once()
        time.sleep(0.01)
        if not t.is_alive():
            break
    data = get_storage_from("mem:tdist-missing-run")
    runs = data.list("result.P*.M*")
    assert runs
    data.remove(runs[0])

    victim = Worker(store, name="red-1").configure(
        max_iter=50, max_sleep=0.02, phases=("reduce",))
    with pytest.raises(RuntimeError, match=r"not visible in storage "
                       r"\(producers: \['mapper-1'\]\)"):
        while True:
            assert victim.poll_once() != "finished"
            time.sleep(0.005)
    # drain: the poisoned job to FAILED, the healthy reduces done, so the
    # background server loop completes (non-strict: proceeds)
    try:
        Worker(store, name="red-2").configure(
            max_iter=50, max_sleep=0.02, phases=("reduce",)).execute()
    except RuntimeError:
        pass
    Worker(store, name="red-3").configure(
        max_iter=50, max_sleep=0.02, phases=("reduce",)).execute()
    t.join(timeout=30)
    assert not t.is_alive(), "server loop did not complete after drain"
    assert store.counts(RED_NS)[Status.FAILED] == 1


def test_server_resume_after_reduce_phase_restart(tmp_path):
    """Resume matrix (server.lua:470-492): a server restarted while the
    task doc says REDUCE skips the map phase entirely, with the spec
    restored from the task document."""
    count_file = str(tmp_path / "mapcalls")
    spec = _spec("mem:tdist-resume", {"count_file": count_file},
                 mapfn="examples.wordcount.instrumented", combinerfn=None)
    store = MemJobStore()
    _run_pool(store, spec)
    maps_after_first = read_count(count_file)
    assert maps_after_first == len(CORPUS)

    store.update_task({"status": TaskStatus.REDUCE.value})
    server2 = Server(store, poll_interval=0.02)      # no configure()
    w = Worker(store).configure(max_iter=400, max_sleep=0.05)
    t = threading.Thread(target=w.execute, daemon=True)
    t.start()
    stats2 = server2.loop()
    t.join(timeout=30)
    assert server2.spec is not None and len(stats2.iterations) == 1
    assert stats2.iterations[0].map.count == 0
    assert read_count(count_file) == maps_after_first   # no map re-ran


def test_server_resume_mid_map_keeps_written_jobs(tmp_path):
    """Resume matrix WAIT/MAP (server.lua:487-491): a server restarted
    mid-map keeps WRITTEN map jobs — every map runs exactly once across
    the crash — and the result still golden-diffs."""
    import examples.wordcount.finalfn as finalfn
    count_file = str(tmp_path / "mapcalls")
    spec = _spec("mem:tdist-resume-map", {"count_file": count_file},
                 mapfn="examples.wordcount.instrumented", combinerfn=None)
    store = MemJobStore()

    class _Crash(Exception):
        pass

    server1 = Server(store, poll_interval=0.02).configure(spec)

    def crash_at_half(phase, frac):
        if phase == "map" and frac >= 0.5:
            raise _Crash()

    crashed = threading.Event()

    def run1():
        try:
            server1.loop(progress=crash_at_half)
        except _Crash:
            crashed.set()

    t = threading.Thread(target=run1, daemon=True)
    t.start()
    w = Worker(store, name="early").configure(max_iter=200, max_sleep=0.02)
    while not crashed.is_set():
        w.poll_once()
        time.sleep(0.005)
        if not t.is_alive() and not crashed.is_set():
            raise AssertionError("server finished before the crash point")
    t.join(timeout=10)
    assert read_count(count_file) >= len(CORPUS) // 2

    _run_pool(store, spec, n_workers=2)
    assert dict(finalfn.counts) == naive_wordcount(CORPUS)
    assert read_count(count_file) == len(CORPUS)


def test_long_job_heartbeat_prevents_wasteful_requeue(monkeypatch):
    """A job running 3× the stale timeout completes WITHOUT a requeue
    while its worker heartbeats; with heartbeats off the same job IS
    requeued (the control that proves the test bites)."""
    import examples.wordcount.finalfn as finalfn
    import examples.wordcount.mapfn as mapmod

    files = CORPUS[:2]
    orig_mapfn = mapmod.mapfn

    def run(heartbeat_s):
        slow_used = []

        def slow(k, v, emit):
            if not slow_used:                 # exactly one long map job
                slow_used.append(1)
                time.sleep(1.5)
            return orig_mapfn(k, v, emit)

        monkeypatch.setattr(mapmod, "mapfn", slow)
        store = MemJobStore()
        requeues = []
        orig_rq = store.requeue_stale

        def counting_rq(ns, older_than_s):
            n = orig_rq(ns, older_than_s)
            if n:
                requeues.append(n)
            return n

        monkeypatch.setattr(store, "requeue_stale", counting_rq)
        _, _, stats = _run_pool(
            store, _spec("mem:tdist-hb", {"files": files}), n_workers=1,
            worker_kw={"heartbeat_s": heartbeat_s}, stale_timeout_s=0.5)
        assert dict(finalfn.counts) == naive_wordcount(files)
        it = stats.iterations[-1]
        assert it.map.count == len(files) and it.map.failed == 0
        return sum(requeues)

    assert run(heartbeat_s=0.1) == 0      # beating: never requeued
    assert run(heartbeat_s=None) >= 1     # silent: stale-requeued


def test_server_rejects_unreachable_storage(tmp_path):
    """Bare 'mem' (private per process) and mem:tag over a multi-process
    FileJobStore would silently produce empty results."""
    with pytest.raises(ValueError, match="bare 'mem'"):
        Server(MemJobStore()).configure(_spec("mem"))
    with pytest.raises(ValueError, match="multi-process"):
        Server(FileJobStore(str(tmp_path / "c"))).configure(_spec("mem:t"))


def test_worker_config_rejects_unknown_keys():
    w = Worker(MemJobStore())
    with pytest.raises(KeyError, match="unknown worker config"):
        w.configure(bogus=1)


def test_sigkilled_worker_job_is_requeued(tmp_path):
    """SIGKILL a worker process mid-map (no handler runs, its RUNNING job
    just goes silent): the stale requeue hands the job to the surviving
    worker and the run still golden-diffs."""
    import examples.wordcount.finalfn as finalfn
    root, spill = str(tmp_path / "coord"), str(tmp_path / "spill")
    store = FileJobStore(root)
    victim_code = (
        "import sys, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import examples.wordcount.mapfn as m\n"
        "def stall(k, v, emit):\n"
        "    print('CLAIMED', flush=True)\n"
        "    time.sleep(3600)\n"
        "m.mapfn = stall\n"
        "from lua_mapreduce_tpu_torch import FileJobStore, Worker\n"
        f"w = Worker(FileJobStore({root!r})).configure(\n"
        "    max_iter=400, max_sleep=0.05)\n"
        "w.execute()\n")
    victim = subprocess.Popen([sys.executable, "-c", victim_code],
                              env=_subprocess_env(), stdout=subprocess.PIPE,
                              text=True)
    server = Server(store, poll_interval=0.05,
                    stale_timeout_s=1.0).configure(_spec(f"shared:{spill}"))
    killed = {}
    healthy = Worker(store).configure(max_iter=800, max_sleep=0.05,
                                      heartbeat_s=0.25)
    ht = threading.Thread(target=healthy.execute, daemon=True)
    once = threading.Lock()

    def start_healthy():
        if once.acquire(blocking=False):
            victim.kill()
            ht.start()

    def chaos():
        killed["claimed"] = victim.stdout.readline().strip()
        time.sleep(0.2)
        victim.kill()                        # SIGKILL: no cleanup runs
        start_healthy()

    threading.Thread(target=chaos, daemon=True).start()
    watchdog = threading.Timer(30, start_healthy)
    watchdog.daemon = True
    watchdog.start()
    stats = server.loop()
    ht.join(timeout=30)
    victim.wait(timeout=10)
    watchdog.cancel()
    assert killed.get("claimed") == "CLAIMED", "victim never claimed a job"
    assert dict(finalfn.counts) == naive_wordcount(CORPUS)
    it = stats.iterations[-1]
    assert it.map.failed == 0 and it.reduce.failed == 0


# ---------------------------------------------------------------------------
# the port's pool against the JAX package's
# ---------------------------------------------------------------------------

# the golden matrix of tests/test_wordcount_golden.py:23-52 on a fixed
# slice of the JAX package's sources (as tests/test_torch_engine.py)
GOLDEN_CORPUS = sorted(glob.glob(os.path.join(REPO, "lua_mapreduce_tpu",
                                              "core", "*.py")))[:12]
WC = "examples.wordcount."
CONFIGS = {
    "combiner": dict(taskfn=WC + "taskfn", mapfn=WC + "mapfn",
                     partitionfn=WC + "partitionfn",
                     reducefn=WC + "reducefn", combinerfn=WC + "reducefn",
                     finalfn=WC + "finalfn"),
    "no_combiner": dict(taskfn=WC + "taskfn", mapfn=WC + "mapfn",
                        partitionfn=WC + "partitionfn",
                        reducefn=WC + "reducefn", finalfn=WC + "finalfn"),
    "general_reducer": dict(taskfn=WC + "taskfn", mapfn=WC + "mapfn",
                            partitionfn=WC + "partitionfn",
                            reducefn=WC + "reducefn2",
                            finalfn=WC + "finalfn"),
    "single_module": {f: WC + "single" for f in (
        "taskfn", "mapfn", "partitionfn", "reducefn", "combinerfn",
        "finalfn")},
}


def _result_files(store):
    pat = re.compile(r"^result\.P\d+$")
    return {n: "".join(store.lines(n)) for n in store.list("result.P*")
            if pat.match(n)}


def _thread_pool(server, worker_cls, store, n=2):
    threads = [threading.Thread(target=worker_cls(store).configure(
        max_iter=400, max_sleep=0.05).execute, daemon=True)
        for _ in range(n)]
    for t in threads:
        t.start()
    stats = server.loop()
    for t in threads:
        t.join(timeout=30)
    return stats


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("backend", ["mem", "shared"])
def test_wordcount_pool_byte_identical_to_jax_pool(tmp_path, config,
                                                   backend):
    """Word count through each package's Server and two Worker threads:
    the port's result files equal the JAX package's byte for byte."""
    from lua_mapreduce_tpu.coord.jobstore import MemJobStore as JaxMem
    from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
    from lua_mapreduce_tpu.engine.server import Server as JaxServer
    from lua_mapreduce_tpu.engine.worker import Worker as JaxWorker
    from lua_mapreduce_tpu.store.router import get_storage_from as jax_get
    tag = f"tdist-wc-{config}-{backend}"
    if backend == "mem":
        jax_st, port_st = f"mem:{tag}-jax", f"mem:{tag}"
    else:
        jax_st, port_st = f"shared:{tmp_path}/jax", f"shared:{tmp_path}/port"
    store = JaxMem()
    _thread_pool(JaxServer(store, poll_interval=0.02).configure(
        JaxSpec(init_args={"files": GOLDEN_CORPUS}, storage=jax_st,
                **CONFIGS[config])), JaxWorker, store)
    want = _result_files(jax_get(jax_st))

    store = MemJobStore()
    stats = _thread_pool(Server(store, poll_interval=0.02).configure(
        TaskSpec(init_args={"files": GOLDEN_CORPUS, **CPU}, storage=port_st,
                 **CONFIGS[config])), Worker, store)
    got = _result_files(get_storage_from(port_st))
    assert want and got == want
    it = stats.iterations[-1]
    assert it.map.count == len(GOLDEN_CORPUS)
    assert it.reduce.count == len(got)
    assert get_storage_from(port_st).list("result.P*.M*") == []


def test_digits_pool_matches_both_local_executors(tmp_path):
    """mr_train at 32-16-10, 2 shards × 16, 3 iterations on a port
    Server with two Worker threads, on the CPU: parameters equal the
    port LocalExecutor's bit for bit, and the JAX LocalExecutor's (same
    initial checkpoint) within rtol 1e-5, atol 1e-6."""
    import shutil

    import examples.digits.mr_train as jax_mr  # noqa: F401
    from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
    from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxExecutor
    from lua_mapreduce_tpu_torch.examples.digits import mr_train
    from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore
    from lua_mapreduce_tpu_torch.train import checkpoint as ckpt
    args = {"sizes": [32, 16, 10], "n_shards": 2, "bunch": 16,
            "max_steps": 3, "patience": 99, "seed": 4}
    fns = ("taskfn", "mapfn", "partitionfn", "reducefn", "finalfn")
    jdir = tmp_path / "jax"
    JaxExecutor(JaxSpec(**{f: "examples.digits.mr_train" for f in fns},
                        init_args={**args, "model_store": f"shared:{jdir}"},
                        storage="mem:tdist-digits-jax"),
                max_iterations=5).run()

    def port_spec(name):
        d = tmp_path / name
        # every run starts from the JAX example's initial checkpoint
        return TaskSpec(**{f: "lua_mapreduce_tpu_torch.examples.digits."
                           "mr_train" for f in fns},
                        init_args={**args, **CPU,
                                   "model_store": f"shared:{d}/model"},
                        storage=f"shared:{d}/spill")

    for name in ("local", "pool"):
        os.makedirs(tmp_path / name / "model")
    # the JAX run's model dir now holds its LAST checkpoint; rebuild the
    # initial one from the JAX example's init alone
    init_dir = tmp_path / "jax-init"
    JaxSpec(**{f: "examples.digits.mr_train" for f in fns},
            init_args={**args, "model_store": f"shared:{init_dir}"},
            storage="mem:tdist-digits-jax-init")
    for name in ("local", "pool"):
        for f in ("model.ckpt", "model.meta"):
            shutil.copy(init_dir / f, tmp_path / name / "model" / f)

    LocalExecutor(port_spec("local"), max_iterations=5).run()
    _, workers, stats = _run_pool(MemJobStore(), port_spec("pool"),
                                  n_workers=2)
    assert len(stats.iterations) == 3
    assert sum(w.jobs_executed for w in workers) > 0

    like = mr_train._template()

    def state(d):
        st = ckpt.load_pytree(SharedStore(str(d)), "model.ckpt", like,
                              check_dtypes=True)
        return {f"{part}/{k}": v.numpy() for part in ("params", "vel")
                for k, v in st[part].items()}

    pool, local = state(tmp_path / "pool" / "model"), \
        state(tmp_path / "local" / "model")
    jax = state(jdir)
    for k in local:
        assert np.array_equal(pool[k], local[k]), k
        np.testing.assert_allclose(pool[k], jax[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert (tmp_path / "pool" / "model" / "model.ckpt").read_bytes() == \
        (tmp_path / "local" / "model" / "model.ckpt").read_bytes()


# ---------------------------------------------------------------------------
# the loop-state checkpoint, the trimmed options, the device rule
# ---------------------------------------------------------------------------

LS = "examples.loopsum"


def _loopsum_results(storage):
    from lua_mapreduce_tpu_torch.core.serialize import load_record
    store = get_storage_from(storage)
    out = {}
    for name in _result_files(store):
        for line in store.lines(name):
            if line.strip():
                k, v = load_record(line.strip())
                out[k] = v[0]
    return out


def test_resumed_loop_task_restores_its_threaded_state(tmp_path,
                                                       monkeypatch):
    """A loop task whose server dies in finalfn mid-loop; a new Server
    (its module state reset to init, as a new process's would be)
    resumes from the task document, restores ``_state.<N>`` through the
    module's restore_state hook, and ends at ``loopsum.expected``'s
    value — the order-sensitive fold matches only if iteration N ran
    against exactly the state N-1 produced."""
    import examples.loopsum as loopsum
    storage = f"shared:{tmp_path}/spill"
    spec = TaskSpec(**{f: LS for f in ("taskfn", "mapfn", "partitionfn",
                                       "reducefn", "combinerfn",
                                       "finalfn")},
                    init_args={"n_iters": 4, **CPU}, storage=storage)
    store = MemJobStore()
    monkeypatch.setattr(loopsum, "CRASH_AT", 2)
    w = Worker(store).configure(max_iter=2000, max_sleep=0.01)
    wt = threading.Thread(target=w.execute, daemon=True)
    wt.start()
    with pytest.raises(RuntimeError, match="injected coordinator crash"):
        Server(store, poll_interval=0.01).configure(spec).loop()
    assert store.get_task()["iteration"] == 3
    assert get_storage_from(storage).exists("_state.3")

    loopsum.ACC = loopsum.ITER = 0
    server = Server(store, poll_interval=0.01)
    stats = server.loop()
    wt.join(timeout=30)
    assert stats.iterations[0].iteration == 3
    acc, result = loopsum.expected(4)
    assert loopsum.ACC == acc
    assert _loopsum_results(storage) == result
    # the checkpoints of both sides of the last flip are kept; older
    # ones were swept
    assert server.finished_value is None
    assert get_storage_from(storage).list("_state.*") == ["_state.3",
                                                          "_state.4"]


def test_loop_state_frame_round_trips_and_refuses_damage():
    from lua_mapreduce_tpu.sched.lease import frame_state as jax_frame
    from lua_mapreduce_tpu_torch.engine.server import (frame_state,
                                                       unframe_state)
    state = {"acc": 12345, "iter": 3, "xs": [1.5, 2.0]}
    data = frame_state(state)
    assert data == jax_frame(state)
    assert unframe_state(data) == state
    for bad in (data[:-1], data[:8], b"XXXXX" + data[5:],
                data[:20] + bytes([data[20] ^ 1]) + data[21:]):
        with pytest.raises(ValueError):
            unframe_state(bad)


@pytest.mark.parametrize("option,value", [
    ("pipeline", True), ("push", True), ("replication", 2),
    ("coding", "4+1"), ("segment_format", "v2"), ("premerge_min_runs", 2),
    ("speculation", 2.0)])
def test_ported_server_options_are_taken(option, value):
    if option == "coding":
        # the server's unified redundancy value is the Coding
        assert str(Server(MemJobStore(), coding=value).replication) == value
    else:
        assert getattr(Server(MemJobStore(), **{option: value}),
                       option) == value


@pytest.mark.parametrize("option,value", [
    ("autotune", True), ("ha", True), ("lease_ttl_s", 5.0)])
def test_trimmed_server_options_raise(option, value):
    with pytest.raises(NotImplementedError, match="A6b"):
        Server(MemJobStore(), **{option: value})
    with pytest.raises(TypeError, match="bogus"):
        Server(MemJobStore(), bogus=1)


def test_server_accepts_trimmed_options_at_their_off_value():
    Server(MemJobStore(), pipeline=False, push=False, replication=1,
           coding=None, speculation=0.0, autotune=False, ha=False,
           segment_format="v1", premerge_min_runs=4, premerge_max_runs=8,
           speculation_cap=2, lease_ttl_s=None, autotune_config=None)


@pytest.mark.parametrize("option,value", [
    ("segment_format", "v2"), ("replication", 2), ("coding", "4+1"),
    ("push", True), ("push_budget_mb", 8.0)])
def test_ported_worker_options_are_taken(option, value):
    """The worker takes the value, and refuses an unknown format or a
    bad redundancy value at configure time."""
    w = Worker(MemJobStore())
    assert getattr(w.configure(**{option: value}), option) == value
    if option == "segment_format":
        with pytest.raises(ValueError, match="v3"):
            w.configure(segment_format="v3")
    if option in ("replication", "coding"):
        with pytest.raises(ValueError):
            w.configure(**{option: "0+2"})
    w.configure(**{option: None})


@pytest.mark.parametrize("option,value", [("idle_poll_ms", 50.0)])
def test_trimmed_worker_options_raise(option, value):
    w = Worker(MemJobStore())
    with pytest.raises(NotImplementedError, match="A6b"):
        w.configure(**{option: value})
    w.configure(**{option: None})


def _task_doc_store(key, value):
    store = MemJobStore()
    store.put_task({"_id": "unique", "status": TaskStatus.MAP.value,
                    "iteration": 1, key: value,
                    "spec": _spec("mem:tdist-doc").describe()})
    return store


@pytest.mark.parametrize("key,value", [
    ("pipeline", True), ("push", True), ("segment_format", "v2"),
    ("replication", 2), ("coding", "4+1"), ("speculation", 1.5)])
def test_worker_runs_a_task_doc_deploying_a_ported_plane(key, value):
    """A task document from a JAX-package server that deploys a plane
    the port runs: the port worker takes it (nothing to claim yet:
    idle)."""
    assert Worker(_task_doc_store(key, value)).poll_once() == "idle"


@pytest.mark.parametrize("key,value", [("autotune", True)])
def test_worker_refuses_a_task_doc_deploying_a_trimmed_plane(key, value):
    """A task document from a JAX-package server that deploys a plane
    the port does not run: the port worker raises instead of running a
    different task."""
    with pytest.raises(NotImplementedError, match="A6b"):
        Worker(_task_doc_store(key, value)).poll_once()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the rule is about a machine with no card")
def test_worker_without_card_raises_unless_task_asks_for_cpu():
    """A worker runs its task on the card: with no card, a task that
    does not ask for the CPU raises when the worker loads it, the worker
    gives up after MAX_WORKER_RETRIES, and no job is claimed."""
    spec = _spec("mem:tdist-nocard")
    desc = spec.describe()
    desc["init_args"] = {k: v for k, v in desc["init_args"].items()
                         if k != "device"}
    store = MemJobStore()
    store.put_task({"_id": "unique", "status": TaskStatus.MAP.value,
                    "iteration": 1, "spec": desc})
    store.insert_jobs(MAP_NS, [{"key": 1, "value": CORPUS[0]}])
    w = Worker(store).configure(max_iter=5, max_sleep=0.01)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        w.execute()
    assert store.counts(MAP_NS)[Status.WAITING] == 1
    # the same task asking for the CPU runs
    desc["init_args"]["device"] = "cpu"
    store.update_task({"spec": desc})
    assert Worker(store).poll_once() == "executed"
