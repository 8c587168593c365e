"""Process-global event counters.

Trimmed copy of the JAX package's ``faults/retry.py``: only the
:class:`FaultCounters` registry (:data:`COUNTERS`) that the executors
fold into ``IterationStats`` once per iteration (``utils/stats.py``
``COUNTER_FOLD``). The retry policy and its backoff are not ported.
"""

from __future__ import annotations

import threading
from typing import Dict


class FaultCounters:
    """Process-global event accounting.

    In-process pools share the module singleton (:data:`COUNTERS`), so
    an executor's IterationStats fold sees the whole pool's events.
    Increments happen only on counted events (a compiled leg ran, a leg
    degraded), so the lock is uncontended in the hot path.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {}

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._c[key] = self._c.get(key, 0) + n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)

    @staticmethod
    def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
        return {k: after.get(k, 0) - before.get(k, 0)
                for k in set(before) | set(after)}


COUNTERS = FaultCounters()
