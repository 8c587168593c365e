"""The guard on what the port still does not run (ROADMAP A6b.3-6):
speculation, autotune, the HA leader lease, the idle-poll waiter and
the native index. Each entry point refuses each such option with
NotImplementedError naming A6b, accepts it at its "off" value, and a
task document deploying speculation or autotune is refused; the
options this slice ported (replication, coding, push) are no longer
among them."""

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
    ("speculation", 2.0, 0), ("speculation_cap", 3, 2),
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


@pytest.mark.parametrize("key,value", [("speculation", 1.5),
                                       ("autotune", True)])
def test_task_doc_deploying_a_still_trimmed_plane_is_refused(key, value):
    doc = {"_id": "unique", "status": TaskStatus.MAP.value, key: value}
    with pytest.raises(NotImplementedError, match="A6b"):
        check_task_doc(doc)
    check_task_doc({**doc, "replication": 2, "coding": "4+2",
                    "push": True, key: None})


def test_ported_options_left_the_trimmed_sets():
    from lua_mapreduce_tpu_torch.engine import local, server, worker
    ported = {"replication", "coding", "push", "push_budget_mb"}
    for offs in (local._OFF_VALUES, server._OFF_VALUES,
                 worker._OFF_VALUES):
        assert not ported & set(offs)
    for trimmed in (execute_server.TRIMMED, execute_worker.TRIMMED):
        flags = {f for f, *_ in trimmed}
        assert not flags & {"--replication", "--coding", "--push",
                            "--push-budget-mb"}


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


def test_native_index_and_duplicate_leases_still_raise(tmp_path):
    from lua_mapreduce_tpu_torch.coord.idx import open_index
    with pytest.raises(NotImplementedError, match="A6b"):
        open_index(str(tmp_path / "idx"), engine="native")
    store = MemJobStore()
    for op, args in (("speculate", ("map_jobs", 0)),
                     ("claim_spec", ("map_jobs", "w")),
                     ("cancel_spec", ("map_jobs", 0, "w"))):
        with pytest.raises(NotImplementedError, match="A6b"):
            getattr(store, op)(*args)
