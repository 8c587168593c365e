"""Shared POSIX-directory storage backend.

Copy of the JAX package's ``store/sharedfs.py`` (reference fs.lua:42-77,
119-137) with a synchronous builder: text accumulates in memory and is
written to a tempfile at ``build``, then flushed, fsynced and atomically
``os.replace``d into place (the fs.lua:80-115 discipline). The JAX
package's asynchronous ~1MB writer thread is a throughput measure for
GB-scale spills; the published bytes are the same either way.

File names may contain ``/``; they are flattened with the same escape
as the JAX package, so both packages read each other's directories.
"""

from __future__ import annotations

import glob as _glob
import os
import tempfile
from typing import Iterator, List, Union

from lua_mapreduce_tpu_torch.store.base import FileBuilder, Store

READ_BUFFER = 1 << 20
FLUSH_BYTES = 1 << 20


def _encode(name: str) -> str:
    return name.replace("%", "%25").replace("/", "%2F")


def _decode(fname: str) -> str:
    return fname.replace("%2F", "/").replace("%25", "%")


class _DirBuilder(FileBuilder):
    def __init__(self, store: "SharedStore"):
        self._store = store
        self._chunks: List[Union[str, bytes]] = []

    def write(self, data: str) -> None:
        self._chunks.append(data)

    def write_bytes(self, data: bytes) -> None:
        self._chunks.append(bytes(data))

    def build(self, name: str) -> None:
        fd, tmp = tempfile.mkstemp(dir=self._store.path, prefix=".tmp.")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(b"".join(c if isinstance(c, bytes)
                                 else c.encode("utf-8")
                                 for c in self._chunks))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self._store.path, _encode(name)))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._chunks = []


class SharedStore(Store):
    # tempfile + fsync + atomic os.replace: a failed build did not publish
    publish_ambiguous = False

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def builder(self) -> FileBuilder:
        return _DirBuilder(self)

    def lines(self, name: str) -> Iterator[str]:
        with open(os.path.join(self.path, _encode(name)),
                  buffering=READ_BUFFER) as f:
            yield from f

    def list(self, pattern: str) -> List[str]:
        names = []
        for p in _glob.glob(os.path.join(self.path, "*")):
            base = os.path.basename(p)
            if base.startswith(".tmp."):
                continue
            names.append(_decode(base))
        return self._match(names, pattern)

    def read_range(self, name: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.path, _encode(name)), "rb") as f:
            f.seek(offset)
            return f.read(length)

    def size(self, name: str) -> int:
        return os.path.getsize(os.path.join(self.path, _encode(name)))

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.path, _encode(name)))

    def remove(self, name: str) -> None:
        try:
            os.remove(os.path.join(self.path, _encode(name)))
        except FileNotFoundError:
            pass
