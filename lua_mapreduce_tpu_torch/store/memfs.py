"""In-memory (host DRAM) storage backend.

Copy of the JAX package's ``store/memfs.py`` for text files. Thread-safe
so the executor's map thread pool can share one store.
"""

from __future__ import annotations

import io
import threading
from typing import Dict, Iterator, List

from lua_mapreduce_tpu_torch.store.base import FileBuilder, Store


class _MemBuilder(FileBuilder):
    def __init__(self, store: "MemStore"):
        self._store = store
        self._chunks: List[str] = []

    def write(self, data: str) -> None:
        self._chunks.append(data)

    def build(self, name: str) -> None:
        data = "".join(self._chunks)
        with self._store._lock:
            self._store._files[name] = data


class MemStore(Store):
    """Dict-of-files store; ``build`` swaps content in atomically."""

    def __init__(self):
        self._files: Dict[str, str] = {}
        self._lock = threading.Lock()

    def builder(self) -> FileBuilder:
        return _MemBuilder(self)

    def lines(self, name: str) -> Iterator[str]:
        with self._lock:
            data = self._files[name]
        return iter(io.StringIO(data))

    def list(self, pattern: str) -> List[str]:
        with self._lock:
            names = list(self._files)
        return self._match(names, pattern)

    def exists(self, name: str) -> bool:
        with self._lock:
            return name in self._files

    def remove(self, name: str) -> None:
        with self._lock:
            self._files.pop(name, None)
