"""In-memory (host DRAM) storage backend.

Copy of the JAX package's ``store/memfs.py``. Thread-safe so the
executor's map thread pool can share one store. A file built from text
is kept as ``str``; one that received raw bytes is kept as ``bytes``
(text chunks UTF-8 encoded), and the byte surface reads either.
"""

from __future__ import annotations

import io
import threading
from typing import Dict, Iterator, List, Union

from lua_mapreduce_tpu_torch.store.base import FileBuilder, Store


class _MemBuilder(FileBuilder):
    def __init__(self, store: "MemStore"):
        self._store = store
        self._chunks: List[Union[str, bytes]] = []

    def write(self, data: str) -> None:
        self._chunks.append(data)

    def write_bytes(self, data: bytes) -> None:
        self._chunks.append(bytes(data))

    def build(self, name: str) -> None:
        if any(isinstance(c, bytes) for c in self._chunks):
            data = b"".join(c if isinstance(c, bytes) else c.encode("utf-8")
                            for c in self._chunks)
        else:
            data = "".join(self._chunks)
        with self._store._lock:
            self._store._files[name] = data


class MemStore(Store):
    """Dict-of-files store; ``build`` swaps content in atomically."""

    publish_ambiguous = False

    def __init__(self):
        self._files: Dict[str, Union[str, bytes]] = {}
        self._lock = threading.Lock()

    def builder(self) -> FileBuilder:
        return _MemBuilder(self)

    def lines(self, name: str) -> Iterator[str]:
        with self._lock:
            data = self._files[name]
        if isinstance(data, bytes):
            data = data.decode("utf-8")
        return iter(io.StringIO(data))

    def read_range(self, name: str, offset: int, length: int) -> bytes:
        return self._bytes(name)[offset:offset + length]

    def size(self, name: str) -> int:
        return len(self._bytes(name))

    def _bytes(self, name: str) -> bytes:
        with self._lock:
            data = self._files[name]
        return data if isinstance(data, bytes) else data.encode("utf-8")

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
