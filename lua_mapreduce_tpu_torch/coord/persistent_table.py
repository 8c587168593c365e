"""Distributed persistent key/value table.

Port of ``lua_mapreduce_tpu/coord/persistent_table.py`` (pure Python;
its lock's default wait is a plain sleep). Analog of reference
mapreduce/persistent_table.lua: a named singleton document shared by
every process of a task, used for cross-process and cross-iteration
state (the APRIL-ANN example keeps its model-checkpoint filename and
convergence flag in one, common.lua:57-77). Concurrency control is the
reference's, minus its races:

- optimistic writes: each commit CASes on the document's ``timestamp`` and
  bumps it (persistent_table.lua:41-74's query-match + ``$inc``)
- an advisory spin lock built from the same CAS (the findAndModify spin
  lock of persistent_table.lua:113-161)
- reserved keys are rejected (persistent_table.lua:95-110)
- ``read_only`` mode forbids mutation (persistent_table.lua:176-251)
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, Optional

from lua_mapreduce_tpu_torch.coord.jobstore import JobStore

_RESERVED = ("timestamp", "locked", "_id")


class ConflictError(RuntimeError):
    """Another writer committed since this table last refreshed."""


class PersistentTable:
    """Dict-like proxy over a persistent document in a JobStore.

    Local reads/writes hit a cache; ``update()`` commits dirty state with an
    optimistic CAS (raising :class:`ConflictError` on a lost race) or, when
    clean, refreshes from the store. ``lock()``/``unlock()`` give advisory
    mutual exclusion for read-modify-write sections.
    """

    def __init__(self, name: str, store: JobStore, read_only: bool = False):
        self._name = name
        self._store = store
        self._read_only = read_only
        self._ts: Optional[int] = None
        self._data: Dict[str, Any] = {}
        self._dirty_keys: set = set()   # locally modified, uncommitted keys
        self._locked = False   # the advisory-lock flag as of last refresh
        self.refresh()

    # -- core protocol -----------------------------------------------------

    def refresh(self) -> None:
        """Pull the latest committed document. Locally-dirty keys keep
        their local values; every other key takes the committed value — so
        the ConflictError → refresh() → update() retry never reverts
        another writer's commit to a key this table did not touch."""
        doc = self._store.pt_get(self._name)
        if doc is None:
            self._ts = None
            self._data = {k: v for k, v in self._data.items()
                          if k in self._dirty_keys}
            return
        committed = {k: v for k, v in doc.items() if k not in _RESERVED}
        for k in self._dirty_keys:
            if k in self._data:
                committed[k] = self._data[k]
        self._ts = doc["timestamp"]
        self._locked = bool(doc.get("locked", False))
        self._data = committed

    def update(self) -> None:
        """Commit dirty state (CAS on timestamp), or refresh when clean
        (the dual role of persistent_table.lua's ``:update``)."""
        if not self._dirty_keys:
            self.refresh()
            return
        self._assert_writable()
        new_ts = (self._ts or 0) + 1
        doc = dict(self._data)
        doc["timestamp"] = new_ts
        if self._locked:
            # committing inside a lock() section must not release the lock
            doc["locked"] = True
        if not self._store.pt_cas(self._name, self._ts, doc):
            raise ConflictError(
                f"persistent table {self._name!r}: concurrent commit beat "
                f"timestamp {self._ts}; refresh() and retry")
        self._ts = new_ts
        self._dirty_keys.clear()

    def set(self, mapping: Dict[str, Any]) -> None:
        """Bulk local assignment (commit with update())."""
        for k, v in mapping.items():
            self[k] = v

    def drop(self) -> None:
        self._assert_writable()
        self._store.pt_delete(self._name)
        self._ts, self._data = None, {}
        self._dirty_keys.clear()

    # -- advisory lock (persistent_table.lua:113-161) ----------------------

    def lock(self, poll: float = 0.1, timeout: Optional[float] = None,
             waiter=None) -> None:
        self._assert_writable()
        # contention waits sleep ``poll`` seconds, or ride an injected
        # waiter (anything with ``wait(seconds)``)
        wait = time.sleep if waiter is None else waiter.wait
        deadline = None if timeout is None else time.time() + timeout
        while True:
            doc = self._store.pt_get(self._name)
            ts = doc["timestamp"] if doc else None
            locked = bool(doc.get("locked")) if doc else False
            if not locked:
                new = dict(doc or {})
                new["locked"] = True
                new["timestamp"] = (ts or 0) + 1
                if self._store.pt_cas(self._name, ts, new):
                    self._ts = new["timestamp"]
                    self._locked = True
                    return
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(f"lock({self._name!r}) timed out")
            wait(poll)

    def unlock(self) -> None:
        self._assert_writable()
        while True:
            doc = self._store.pt_get(self._name)
            if doc is None or not doc.get("locked"):
                self._locked = False
                return
            new = dict(doc)
            new["locked"] = False
            new["timestamp"] = doc["timestamp"] + 1
            if self._store.pt_cas(self._name, doc["timestamp"], new):
                self._ts = new["timestamp"]
                self._locked = False
                return

    # -- dict protocol -----------------------------------------------------

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    def __setitem__(self, key: str, value: Any) -> None:
        self._assert_writable()
        if key in _RESERVED or key.startswith("_"):
            raise KeyError(f"reserved key {key!r} "
                           "(reference persistent_table.lua:95-110)")
        self._data[key] = value
        self._dirty_keys.add(key)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._data)

    @property
    def dirty(self) -> bool:
        return bool(self._dirty_keys)

    @property
    def read_only(self) -> bool:
        return self._read_only

    def _assert_writable(self) -> None:
        if self._read_only:
            raise PermissionError(
                f"persistent table {self._name!r} is read-only")


def utest() -> None:
    """Self-test (reference persistent_table.lua:256-264: two clients
    round-tripping one document, optimistic conflict, lock)."""
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore

    store = MemJobStore()
    a = PersistentTable("_pt_utest", store)
    a["model"] = "m.ckpt"
    a.update()
    b = PersistentTable("_pt_utest", store)
    assert b["model"] == "m.ckpt"
    b["model"] = "m2.ckpt"
    b.update()
    a["model"] = "retried-write"           # a still holds the old stamp
    try:
        a.update()
    except ConflictError:
        pass
    else:
        raise AssertionError("stale write must raise ConflictError")
    a.refresh()                            # new stamp; pending write kept
    a.update()
    assert PersistentTable("_pt_utest", store)["model"] == "retried-write"

    ro = PersistentTable("_pt_utest", store, read_only=True)
    try:
        ro["model"] = "x"
    except PermissionError:
        pass
    else:
        raise AssertionError("read_only must reject writes")

    a.lock()
    a.unlock()
    a.drop()
