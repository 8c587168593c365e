"""Storage spec parsing and backend routing.

Copy of the JAX package's ``store/router.py`` (reference
utils.lua:273-285, fs.lua:185-208) for the ``mem`` and ``shared``
backends. ``object:`` parses (so a spec is never misread) but raises: the
object store is a later slice. The ``mem:tag`` registry belongs to this
package: a port ``mem:`` store and a JAX-package ``mem:`` store of the
same tag are different stores; hand-offs between the packages go
through ``shared:``.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

from lua_mapreduce_tpu_torch.store.base import Store
from lua_mapreduce_tpu_torch.store.memfs import MemStore
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
_mem_lock = threading.Lock()


def parse_storage(spec: str) -> Tuple[str, Optional[str]]:
    """Parse "backend[:path]" → (backend, path) (utils.lua:273-285)."""
    backend, sep, path = spec.partition(":")
    backend = _ALIASES.get(backend)
    if backend is None:
        raise ValueError(f"unknown storage backend in spec {spec!r}; "
                         f"use one of {sorted(set(_ALIASES))}")
    if backend == "object":
        raise ValueError(f"storage {spec!r}: the object store is not "
                         "ported yet; use 'mem:tag' or 'shared:path'")
    if backend != "mem" and not sep:
        raise ValueError(f"storage {spec!r} needs a path: 'backend:path'")
    return backend, (path if sep else None)


def get_storage_from(spec: str) -> Store:
    """Build the Store for a "backend[:path]" spec string.

    Bare ``mem`` returns a fresh private store; ``mem:tag`` returns the
    process-wide store for that tag.
    """
    backend, path = parse_storage(spec)
    if backend == "mem":
        if path is None:
            return MemStore()
        with _mem_lock:
            store = _mem_stores.get(path)
            if store is None:
                store = _mem_stores[path] = MemStore()
            return store
    return SharedStore(path)

