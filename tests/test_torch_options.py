"""Options of the JAX package's entry points the port runs: each of the
options and flags that earlier slices refused (autotune, the HA leader
lease, the idle-poll cap) runs once here, on the CPU, and gives the same
words as a naive count; the options ported before them (speculation,
the native index and duplicate leases) run too. No trim guard is left:
no module of the port raises NotImplementedError naming a ROADMAP item."""

import glob
import os
import pathlib
import threading

import pytest

from examples.wordcount.naive import naive_wordcount
from lua_mapreduce_tpu_torch.cli import execute_server, execute_worker
from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.core.constants import TaskStatus
from lua_mapreduce_tpu_torch.core.serialize import load_record
from lua_mapreduce_tpu_torch.engine import (LocalExecutor, Server, TaskSpec,
                                            Worker)
from lua_mapreduce_tpu_torch.faults.retry import (configure_retry,
                                                  retry_settings)
from lua_mapreduce_tpu_torch.sched.controller import AutotuneConfig
from lua_mapreduce_tpu_torch.store.router import get_storage_from

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(glob.glob(os.path.join(REPO, "examples", "wordcount",
                                       "[a-z]*.py")))
_WC = dict(taskfn="examples.wordcount.taskfn",
           mapfn="examples.wordcount.mapfn",
           partitionfn="examples.wordcount.partitionfn",
           reducefn="examples.wordcount.reducefn")


def _spec(storage, files=CORPUS):
    return TaskSpec(init_args={"files": list(files), "device": "cpu"},
                    storage=storage, **_WC)


def _counts(storage):
    st = get_storage_from(storage)
    out = {}
    for name in st.list("result.P*"):
        for line in st.lines(name):
            if line.strip():
                k, v = load_record(line.strip())
                out[k] = v[0]
    return out


def _pool(store, spec, worker_kw=None, **server_kw):
    server = Server(store, poll_interval=0.02, **server_kw).configure(spec)
    workers = [Worker(store).configure(max_iter=400, max_sleep=0.05,
                                       **(worker_kw or {}))
               for _ in range(2)]
    threads = [threading.Thread(target=w.execute, daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    server.loop()
    for t in threads:
        t.join(timeout=30)
    return server, workers


@pytest.fixture
def restore_retry():
    before = retry_settings()
    yield
    configure_retry(int(before["retries"]), before["base_ms"])


@pytest.mark.parametrize("option,value", [
    ("autotune", True),
    ("autotune_config", AutotuneConfig(cooldown_s=0.05)),
    ("ha", True),
    ("lease_ttl_s", 5.0)])
def test_server_formerly_trimmed_options_run(option, value, restore_retry):
    """Replaces the refusal cases: each Server option runs a pool (the
    config with autotune on, the TTL with the lease on) and gives the
    naive count."""
    kw = {option: value}
    if option == "autotune_config":
        kw["autotune"] = True
    if option == "lease_ttl_s":
        kw["ha"] = True
    storage = f"mem:opts-server-{option}"
    store = MemJobStore()
    server, _ = _pool(store, _spec(storage), **kw)
    attr = "_autotune_config" if option == "autotune_config" else option
    assert getattr(server, attr) == value
    assert _counts(storage) == naive_wordcount(CORPUS)
    if server.ha:
        lease = store.pt_get("leader")
        assert lease["epoch"] == 1 and lease["holder"] == ""
        assert server._lease.ttl_s == (value if option == "lease_ttl_s"
                                       else 10.0)
    else:
        assert store.get_task()["autotune"] is True


def test_executor_autotune_runs(restore_retry):
    """Replaces the executor refusal: ``LocalExecutor(autotune=True)``
    runs and counts like the naive count."""
    ex = LocalExecutor(_spec("mem:opts-ex-autotune"), autotune=True)
    ex.run()
    assert ex.autotune is True
    assert _counts("mem:opts-ex-autotune") == naive_wordcount(CORPUS)


def test_worker_idle_poll_ms_runs():
    """Replaces the worker refusal: ``configure(idle_poll_ms=50)`` caps
    the idle wait at 50 ms, and the worker runs a task under it."""
    store = MemJobStore()
    _, workers = _pool(store, _spec("mem:opts-idle"),
                       worker_kw={"idle_poll_ms": 50})
    assert all(w._idle_cap() == 0.05 for w in workers)
    assert sum(w.jobs_executed for w in workers) > 0
    assert _counts("mem:opts-idle") == naive_wordcount(CORPUS)


def test_task_doc_deploying_autotune_is_run(restore_retry):
    """Replaces the refused-doc case: a task document with the autotune
    marker (a JAX-package server's, say) is taken, and the worker
    follows its controller-owned retry base and push budget."""
    doc = {"_id": "unique", "status": TaskStatus.MAP.value, "iteration": 1,
           "autotune": True, "retry_base_ms": 40.0, "push_budget_mb": 12.0,
           "spec": _spec("mem:opts-doc").describe()}
    store = MemJobStore()
    store.put_task(doc)
    w = Worker(store)
    assert w.poll_once() == "idle"
    assert retry_settings()["base_ms"] == 40.0
    assert w._task_push_budget == 12.0
    assert w._push_pool().budget == 12 * 1024 * 1024


_SERVER_FLAGS = [("--idle-poll-ms", "50"), ("--autotune",),
                 ("--autotune-max-workers", "3", "--autotune"), ("--ha",),
                 ("--lease-ttl-s", "3", "--ha")]


@pytest.mark.parametrize("argv", _SERVER_FLAGS,
                         ids=[a[0] for a in _SERVER_FLAGS])
def test_every_formerly_trimmed_server_flag_runs(argv, restore_retry):
    """Each server flag parses and runs a word count with two inline
    workers (the elastic pool under --autotune)."""
    import examples.wordcount.finalfn as finalfn
    files = CORPUS[:4]
    assert execute_server.main([
        "mem", "examples/wordcount/taskfn.py", "examples/wordcount/mapfn",
        "examples.wordcount.partitionfn", "examples.wordcount.reducefn",
        "--finalfn", "examples.wordcount.finalfn", "--inline-workers", "2",
        "--poll", "0.02", "--storage", f"mem:opts-cli{argv[0]}",
        "--init-arg", f"files={os.pathsep.join(files)}",
        "--init-arg", "device=cpu", "--quiet", *argv]) == 0
    assert dict(finalfn.counts) == naive_wordcount(files)


_WORKER_FLAGS = [("--idle-poll-ms", "50"), ("--autotune-fleet", "2"),
                 ("--autotune-max-workers", "3", "--autotune-fleet", "1")]


@pytest.mark.parametrize("argv", _WORKER_FLAGS,
                         ids=[a[0] for a in _WORKER_FLAGS])
def test_every_formerly_trimmed_worker_flag_runs(argv, tmp_path):
    """Each worker flag parses and runs: ``execute_worker`` in this
    process serves a Server's task on a FileJobStore to the end (the
    elastic pool under --autotune-fleet, following the autotuned
    document's fleet target)."""
    import json
    coord = str(tmp_path / "coord")
    files = CORPUS[:4]
    storage = f"shared:{tmp_path / 'spill'}"
    server = Server(FileJobStore(coord), poll_interval=0.02,
                    autotune=True).configure(_spec(storage, files))
    t = threading.Thread(target=server.loop, daemon=True)
    t.start()
    report = tmp_path / "report.json"
    assert execute_worker.main([coord, "--max-iter", "40", "--max-sleep",
                                "0.05", "--report", str(report),
                                *argv]) == 0
    t.join(timeout=60)
    assert not t.is_alive()
    assert _counts(storage) == naive_wordcount(files)
    rep = json.loads(pathlib.Path(report).read_text())
    assert rep["jobs"] > 0 and rep["members"] >= 1


def test_no_trim_guard_is_left():
    """Replaces the check of the trimmed sets: no module of the port
    raises NotImplementedError naming a ROADMAP item any more."""
    root = pathlib.Path(REPO, "lua_mapreduce_tpu_torch")
    hits = [str(p) for p in root.rglob("*.py")
            if "ROADMAP A6" in p.read_text()]
    assert hits == []
    assert not hasattr(execute_server, "TRIMMED")
    assert not hasattr(execute_worker, "TRIMMED")


@pytest.mark.parametrize("option,value", [("speculation", 2.0),
                                          ("speculation_cap", 3)])
def test_server_speculation_options_run(option, value):
    """The speculation options are taken, and a factor below 1 is
    refused."""
    assert getattr(Server(MemJobStore(), **{option: value}),
                   option) == value
    with pytest.raises(ValueError, match="factor"):
        Server(MemJobStore(), speculation=0.5)


def test_task_doc_deploying_speculation_is_run():
    """A task document that deploys speculation is taken and a worker
    follows its factor (nothing to claim: idle)."""
    doc = {"_id": "unique", "status": TaskStatus.MAP.value,
           "speculation": 1.5, "iteration": 1,
           "spec": _spec("mem:trim-spec").describe()}
    store = MemJobStore()
    store.put_task(doc)
    w = Worker(store)
    assert w.poll_once() == "idle"
    assert w._speculation == 1.5


def test_native_index_and_duplicate_leases_run(tmp_path):
    """The native engine opens (g++ builds it here) and every
    duplicate-lease call runs."""
    from lua_mapreduce_tpu_torch.coord.idx import NativeJobIndex, open_index
    assert isinstance(open_index(str(tmp_path / "idx"), engine="native"),
                      NativeJobIndex)
    store = MemJobStore()
    store.insert_jobs("map_jobs", [{"key": 0, "value": "x"}])
    store.claim("map_jobs", "w")
    assert store.speculate("map_jobs", 0)
    assert store.claim_spec("map_jobs", "w2")["_id"] == 0
    assert store.cancel_spec("map_jobs", 0, "w2")
