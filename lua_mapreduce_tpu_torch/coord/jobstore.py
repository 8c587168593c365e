"""Job store — the persistent-document half of the coordination backend.

Port of ``lua_mapreduce_tpu/coord/jobstore.py``, trimmed to what
``persistent_table`` needs: the three persistent-document operations of
the ``JobStore`` interface and the in-memory engine's implementation of
them. The job queues, the task singleton and the errors stream are not
in the port; a store here has no such methods.
"""

from __future__ import annotations

import abc
import threading
from typing import Dict, Optional


class JobStore(abc.ABC):
    """Coordination-plane interface: persistent documents with an
    optimistic timestamp (persistent_table.lua:41-74)."""

    @abc.abstractmethod
    def pt_get(self, name: str) -> Optional[dict]: ...

    @abc.abstractmethod
    def pt_cas(self, name: str, expected_ts: Optional[int], doc: dict) -> bool:
        """Write ``doc`` iff the stored timestamp equals ``expected_ts``
        (None = must not exist). The optimistic-concurrency primitive of
        persistent_table.lua:41-74."""

    @abc.abstractmethod
    def pt_delete(self, name: str) -> None: ...


class MemJobStore(JobStore):
    """In-process store: one lock, plain dicts."""

    def __init__(self):
        self._lock = threading.RLock()
        self._pt: Dict[str, dict] = {}

    def pt_get(self, name):
        with self._lock:
            doc = self._pt.get(name)
            return dict(doc) if doc is not None else None

    def pt_cas(self, name, expected_ts, doc):
        with self._lock:
            cur = self._pt.get(name)
            cur_ts = cur.get("timestamp") if cur is not None else None
            if cur_ts != expected_ts:
                return False
            self._pt[name] = dict(doc)
            return True

    def pt_delete(self, name):
        with self._lock:
            self._pt.pop(name, None)
