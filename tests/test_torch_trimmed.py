"""The guard on what the port still does not run (ROADMAP A6b.5-6):
autotune, the HA leader lease and the idle-poll waiter. Each entry
point refuses each such option with NotImplementedError naming A6b,
accepts it at its "off" value, and a task document deploying autotune
is refused. The options ported since (replication, coding, push; the
native index and speculation) are no longer among them, and run."""

import pytest

from lua_mapreduce_tpu_torch.cli import execute_server, execute_worker
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.core.constants import TaskStatus
from lua_mapreduce_tpu_torch.engine import (LocalExecutor, Server, TaskSpec,
                                            Worker)
from lua_mapreduce_tpu_torch.engine.worker import check_task_doc

_WC = dict(taskfn="examples.wordcount.taskfn",
           mapfn="examples.wordcount.mapfn",
           partitionfn="examples.wordcount.partitionfn",
           reducefn="examples.wordcount.reducefn")


def _spec(tag):
    return TaskSpec(init_args={"files": [], "device": "cpu"},
                    storage=f"mem:{tag}", **_WC)


@pytest.mark.parametrize("option,value,off", [
    ("autotune", True, False), ("autotune_config", object(), None),
    ("ha", True, False), ("lease_ttl_s", 5.0, None)])
def test_server_still_trimmed_options_raise(option, value, off):
    with pytest.raises(NotImplementedError, match=f"{option}.*A6b"):
        Server(MemJobStore(), **{option: value})
    Server(MemJobStore(), **{option: off})


def test_executor_and_worker_still_trimmed_options_raise():
    with pytest.raises(NotImplementedError, match="autotune.*A6b"):
        LocalExecutor(_spec("trim-ex"), autotune=True)
    LocalExecutor(_spec("trim-ex"), autotune=False)
    w = Worker(MemJobStore())
    with pytest.raises(NotImplementedError, match="idle_poll_ms.*A6b"):
        w.configure(idle_poll_ms=50.0)
    w.configure(idle_poll_ms=None)


@pytest.mark.parametrize("key,value", [("autotune", True)])
def test_task_doc_deploying_a_still_trimmed_plane_is_refused(key, value):
    doc = {"_id": "unique", "status": TaskStatus.MAP.value, key: value}
    with pytest.raises(NotImplementedError, match="A6b"):
        check_task_doc(doc)
    check_task_doc({**doc, "replication": 2, "coding": "4+2",
                    "push": True, key: None})


def test_ported_options_left_the_trimmed_sets():
    from lua_mapreduce_tpu_torch.engine import local, server, worker
    ported = {"replication", "coding", "push", "push_budget_mb",
              "speculation", "speculation_cap"}
    for offs in (local._OFF_VALUES, server._OFF_VALUES,
                 worker._OFF_VALUES):
        assert not ported & set(offs)
    for trimmed in (execute_server.TRIMMED, execute_worker.TRIMMED):
        flags = {f for f, *_ in trimmed}
        assert not flags & {"--replication", "--coding", "--push",
                            "--push-budget-mb", "--speculation-factor",
                            "--speculation-cap"}


@pytest.mark.parametrize("module", [execute_server, execute_worker],
                         ids=["server", "worker"])
def test_every_still_trimmed_flag_raises_naming_a6b(module, tmp_path):
    head = (["mem", "a", "b", "c", "d"] if module is execute_server
            else [str(tmp_path)])
    for flag, kw, *_ in module.TRIMMED:
        value = ([] if kw.get("action") == "store_true"
                 else ["3"] if kw.get("type") is int else ["2.5"])
        with pytest.raises(NotImplementedError, match=f"{flag}.*A6b"):
            module.main(head + [flag, *value])


@pytest.mark.parametrize("option,value", [("speculation", 2.0),
                                          ("speculation_cap", 3)])
def test_server_speculation_options_run(option, value):
    """Replaces the speculation cases of the still-trimmed test: the
    options are taken now, and a factor below 1 is refused."""
    assert getattr(Server(MemJobStore(), **{option: value}),
                   option) == value
    with pytest.raises(ValueError, match="factor"):
        Server(MemJobStore(), speculation=0.5)


def test_task_doc_deploying_speculation_is_run():
    """Replaces the speculation case of the refused-doc test: a task
    document that deploys speculation passes the check and a worker
    takes its factor (nothing to claim: idle)."""
    doc = {"_id": "unique", "status": TaskStatus.MAP.value,
           "speculation": 1.5, "iteration": 1,
           "spec": _spec("trim-spec").describe()}
    check_task_doc(doc)
    store = MemJobStore()
    store.put_task(doc)
    w = Worker(store)
    assert w.poll_once() == "idle"
    assert w._speculation == 1.5


def test_native_index_and_duplicate_leases_run(tmp_path):
    """Replaces the native-index and duplicate-lease raise test: the
    native engine opens (g++ builds it here) and every duplicate-lease
    call runs."""
    from lua_mapreduce_tpu_torch.coord.idx import NativeJobIndex, open_index
    assert isinstance(open_index(str(tmp_path / "idx"), engine="native"),
                      NativeJobIndex)
    store = MemJobStore()
    store.insert_jobs("map_jobs", [{"key": 0, "value": "x"}])
    store.claim("map_jobs", "w")
    assert store.speculate("map_jobs", 0)
    assert store.claim_spec("map_jobs", "w2")["_id"] == 0
    assert store.cancel_spec("map_jobs", 0, "w2")
