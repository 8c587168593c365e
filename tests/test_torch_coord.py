"""The port's persistent table and the persistent-document half of its
job stores (``lua_mapreduce_tpu_torch/coord/``): the JAX suite's seven
``tests/test_persistent_table.py`` cases run against the port's
``MemJobStore`` and ``FileJobStore``; the file store's documents read
back in a new process and in the JAX package's ``FileJobStore`` (the
same on-disk format); no job-store method beyond the persistent
documents exists in the port."""

import subprocess
import sys
import threading

import pytest

from lua_mapreduce_tpu.coord.filestore import FileJobStore as JaxFileStore
from lua_mapreduce_tpu.coord.persistent_table import (
    PersistentTable as JaxTable)
from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.jobstore import JobStore, MemJobStore
from lua_mapreduce_tpu_torch.coord.persistent_table import (ConflictError,
                                                            PersistentTable)

STORES = ["mem", "file"]


def _store(tmp_path, kind):
    return MemJobStore() if kind == "mem" else FileJobStore(
        str(tmp_path / "pt"))


@pytest.mark.parametrize("kind", STORES)
def test_two_clients_roundtrip(tmp_path, kind):
    store = _store(tmp_path, kind)
    a = PersistentTable("conf", store)
    a["model"] = "m.ckpt"
    a["epoch"] = 3
    a.update()

    b = PersistentTable("conf", store)
    assert b["model"] == "m.ckpt" and b["epoch"] == 3

    b["epoch"] = 4
    b.update()
    a.update()          # clean → refresh pulls b's commit
    assert a["epoch"] == 4


@pytest.mark.parametrize("kind", STORES)
def test_optimistic_conflict_detected(tmp_path, kind):
    store = _store(tmp_path, kind)
    a = PersistentTable("c", store)
    b = PersistentTable("c", store)
    a["x"] = 1
    a.update()
    b["x"] = 2          # b still holds the pre-commit timestamp
    with pytest.raises(ConflictError):
        b.update()
    b.refresh()
    b.update()          # after refresh the commit goes through
    assert PersistentTable("c", store)["x"] == 2


@pytest.mark.parametrize("kind", STORES)
def test_lock_mutual_exclusion(tmp_path, kind):
    store = _store(tmp_path, kind)
    t1 = PersistentTable("locked", store)
    order = []

    def contender():
        t2 = PersistentTable("locked", store)
        t2.lock(poll=0.01)
        order.append("t2")
        t2.unlock()

    t1.lock()
    order.append("t1")
    th = threading.Thread(target=contender)
    th.start()
    th.join(timeout=0.2)
    assert th.is_alive()        # blocked on t1's lock
    t1.unlock()
    th.join(timeout=5)
    assert order == ["t1", "t2"]


@pytest.mark.parametrize("kind", STORES)
def test_reserved_keys_and_read_only(tmp_path, kind):
    store = _store(tmp_path, kind)
    t = PersistentTable("r", store)
    with pytest.raises(KeyError):
        t["timestamp"] = 1
    with pytest.raises(KeyError):
        t["_hidden"] = 1
    t["ok"] = 1
    t.update()

    ro = PersistentTable("r", store, read_only=True)
    assert ro["ok"] == 1
    with pytest.raises(PermissionError):
        ro["ok"] = 2
    with pytest.raises(PermissionError):
        ro.drop()


@pytest.mark.parametrize("kind", STORES)
def test_conflict_retry_preserves_other_writers_keys(tmp_path, kind):
    """After ConflictError → refresh() → update(), keys this table never
    touched keep the OTHER writer's committed values."""
    store = _store(tmp_path, kind)
    t1 = PersistentTable("m", store)
    t1.set({"a": 1, "b": 1})
    t1.update()

    t2 = PersistentTable("m", store)
    t1["a"] = 5                 # t1 dirty on 'a' only
    t2["b"] = 2
    t2.update()                 # t2 commits b=2 first
    with pytest.raises(ConflictError):
        t1.update()
    t1.refresh()
    t1.update()
    final = PersistentTable("m", store)
    assert final["a"] == 5 and final["b"] == 2   # b=2 not reverted


@pytest.mark.parametrize("kind", STORES)
def test_commit_under_lock_keeps_lock(tmp_path, kind):
    """update() inside a lock() section does not release the lock."""
    store = _store(tmp_path, kind)
    a = PersistentTable("held", store)
    a.lock()
    a["x"] = 1
    a.update()          # must preserve the locked flag
    b = PersistentTable("held", store)
    with pytest.raises(TimeoutError):
        b.lock(poll=0.01, timeout=0.1)
    a.unlock()
    b.lock(poll=0.01, timeout=1.0)
    b.unlock()


@pytest.mark.parametrize("kind", STORES)
def test_drop(tmp_path, kind):
    store = _store(tmp_path, kind)
    t = PersistentTable("d", store)
    t["k"] = "v"
    t.update()
    t.drop()
    assert "k" not in PersistentTable("d", store)


def test_lock_takes_an_injected_waiter():
    waits = []

    class Waiter:
        def wait(self, seconds):
            waits.append(seconds)
            b.unlock()

    store = MemJobStore()
    a, b = PersistentTable("w", store), PersistentTable("w", store)
    b.lock()
    a.lock(poll=0.5, waiter=Waiter())
    assert waits == [0.5]
    a.unlock()


def test_file_store_document_survives_a_new_process(tmp_path):
    """A restart is a new process: a table committed by one process is
    read, and its commit stamp honoured, by the next."""
    root = str(tmp_path / "pt")
    t = PersistentTable("conf", FileJobStore(root))
    t.set({"epoch": 3, "best_val": 0.25})
    t.update()
    code = (
        "import sys\n"
        "from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore\n"
        "from lua_mapreduce_tpu_torch.coord.persistent_table import "
        "PersistentTable\n"
        "t = PersistentTable('conf', FileJobStore(sys.argv[1]))\n"
        "assert t['epoch'] == 3 and t['best_val'] == 0.25\n"
        "t['epoch'] = 4\n"
        "t.update()\n")
    subprocess.run([sys.executable, "-c", code, root], check=True,
                   timeout=120)
    with pytest.raises(ConflictError):
        t["epoch"] = 9
        t.update()
    t.refresh()
    assert t["epoch"] == 9          # the dirty key is kept, others pulled
    assert PersistentTable("conf", FileJobStore(root))["epoch"] == 4


def test_file_store_shares_the_jax_package_format(tmp_path):
    """The port's FileJobStore and the JAX package's read and CAS each
    other's persistent documents in one directory."""
    root = str(tmp_path / "shared")
    mine = PersistentTable("conf", FileJobStore(root))
    mine.set({"epoch": 2, "best_epoch": 1})
    mine.update()
    theirs = JaxTable("conf", JaxFileStore(root))
    assert theirs.as_dict() == {"epoch": 2, "best_epoch": 1}
    theirs["epoch"] = 3
    theirs.update()
    mine.update()
    assert mine["epoch"] == 3


def test_the_store_is_only_its_persistent_half():
    """The job store's abstract surface is the JAX package's — the
    persistent half (PR 9), the claim half (PR 12) and the speculative
    duplicate leases (PR 17). (The name is kept from when the port had
    only the persistent half.)"""
    from lua_mapreduce_tpu.coord.jobstore import JobStore as JaxJobStore
    assert JobStore.__abstractmethods__ == JaxJobStore.__abstractmethods__
    assert {"pt_get", "pt_cas", "pt_delete"} <= JobStore.__abstractmethods__
    for name in ("insert_jobs", "claim", "get_task", "insert_error",
                 "drain_errors"):
        assert callable(getattr(MemJobStore(), name))
        assert callable(getattr(FileJobStore, name))
    # speculative duplicate leases run now: no job, no lease
    assert MemJobStore().speculate("map_jobs", 0) is False
    assert MemJobStore().claim_spec("map_jobs", "w") is None
