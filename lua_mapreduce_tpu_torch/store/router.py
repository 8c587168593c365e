"""Storage spec parsing and backend routing.

Copy of the JAX package's ``store/router.py`` (reference
utils.lua:273-285, fs.lua:185-208): ``mem``, ``shared`` and ``object``
backends, each passed through the fault/trace/retry wiring
(faults/wrappers.wrap_store). The ``mem:tag`` registry belongs to this
package: a port ``mem:`` store and a JAX-package ``mem:`` store of the
same tag are different stores; hand-offs between the packages go
through ``shared:`` or ``object:``.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

from lua_mapreduce_tpu_torch.store.base import Store
from lua_mapreduce_tpu_torch.store.memfs import MemStore
from lua_mapreduce_tpu_torch.store.objectfs import ObjectStore
from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore

_ALIASES = {
    "gridfs": "mem",
    "mem": "mem",
    "shared": "shared",
    "sharedfs": "shared",
    "sshfs": "object",
    "object": "object",
    "gcs": "object",
}

# process-wide mem stores by tag so the executor, its map threads and
# the user functions share one
_mem_stores: dict = {}
# wrapped mem:tag instances, memoized per fault/retry/trace wiring
# generation: callers rely on `get_storage_from("mem:t") is
# get_storage_from("mem:t")`
_mem_wrapped: dict = {}
_mem_lock = threading.Lock()


def parse_storage(spec: str) -> Tuple[str, Optional[str]]:
    """Parse "backend[:path]" → (backend, path) (utils.lua:273-285)."""
    backend, sep, path = spec.partition(":")
    backend = _ALIASES.get(backend)
    if backend is None:
        raise ValueError(f"unknown storage backend in spec {spec!r}; "
                         f"use one of {sorted(set(_ALIASES))}")
    if backend != "mem" and not sep:
        raise ValueError(f"storage {spec!r} needs a path: 'backend:path'")
    return backend, (path if sep else None)


def get_storage_from(spec: str) -> Store:
    """Build the Store for a "backend[:path]" spec string.

    Bare ``mem`` returns a fresh private store; ``mem:tag`` returns the
    process-wide store for that tag. Every store passes through
    ``wrap_store``: fault injection when a FaultPlan is active, op spans
    when a tracer is active, the retry layer when the retry budget is
    above 0 (the default).
    """
    from lua_mapreduce_tpu_torch.faults.wrappers import (wiring_token,
                                                         wrap_store)
    backend, path = parse_storage(spec)
    if backend == "mem":
        if path is None:
            return wrap_store(MemStore())
        token = wiring_token()
        with _mem_lock:
            cached = _mem_wrapped.get(path)
            if cached is not None and cached[0] == token:
                return cached[1]
            raw = _mem_stores.get(path)
            if raw is None:
                raw = _mem_stores[path] = MemStore()
            wrapped = wrap_store(raw)
            _mem_wrapped[path] = (token, wrapped)
            return wrapped
    if backend == "shared":
        return wrap_store(SharedStore(path))
    return wrap_store(ObjectStore(path))
