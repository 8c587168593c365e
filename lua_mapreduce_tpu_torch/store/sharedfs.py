"""Shared POSIX-directory storage backend.

Copy of the JAX package's ``store/sharedfs.py`` (reference fs.lua:42-77,
119-137). A builder writes into a tempfile as it goes: writes batch in
memory and, past ~1 MB, a writer thread the builder starts on demand
appends each batch to the file while the producer keeps working (a
file smaller than one batch is written inline at ``build``). ``build``
drains the thread, then flushes, fsyncs and atomically ``os.replace``s
the tempfile into place (the fs.lua:80-115 discipline); ``close`` on an
unbuilt builder stops its thread, closes its fd and removes the
tempfile. So a GB-scale spill (the push shuffle's tails) never sits
whole in memory.

File names may contain ``/``; they are flattened with the same escape
as the JAX package, so both packages read each other's directories.
``local_path`` names a file's POSIX path for the native C++ paths
(core/native_{merge,wcmap}.py). A native reader only ever opens names
that ``build`` published whole (writer drained, fsynced, then renamed),
and a native writer publishes with its own rename.
"""

from __future__ import annotations

import glob as _glob
import logging
import os
import queue
import tempfile
import threading
from typing import Iterator, List, Optional, Union

from lua_mapreduce_tpu_torch.store.base import (FileBuilder, Store,
                                                encode_chunks)

_log = logging.getLogger(__name__)

READ_BUFFER = 1 << 20
FLUSH_BYTES = 1 << 20


def _encode(name: str) -> str:
    return name.replace("%", "%25").replace("/", "%2F")


def _decode(fname: str) -> str:
    return fname.replace("%2F", "/").replace("%25", "%")


class _DirBuilder(FileBuilder):
    """Tempfile builder with batched, asynchronous flushing.

    Writes accumulate in memory and are handed to a lazily-started
    writer thread in ~1MB chunks, so the producer's CPU (the k-way merge
    fold, a map job's sort+dump) overlaps the file IO instead of
    alternating with it. ``build`` drains the writer, surfaces any
    deferred write error, then keeps the fs.lua:80-115 durability
    discipline: flush → fsync → atomic rename. Small files (< one flush
    batch) never pay the thread: their single chunk is written inline.

    A builder abandoned before ``build`` (the producing job raised) must
    be released with :meth:`close` — explicitly, via the context-manager
    form, or (backstop only) by GC — so the writer thread, the fd, and
    the ``.tmp.`` file never outlive the failure on a long-lived elastic
    worker.
    """

    def __init__(self, store: "SharedStore"):
        self._store = store
        fd, self._tmp = tempfile.mkstemp(dir=store.path, prefix=".tmp.")
        self._f = os.fdopen(fd, "wb")
        self._chunks: List[Union[str, bytes]] = []
        self._size = 0
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._err_box: List[BaseException] = []
        self._built = False

    def write(self, data: str) -> None:
        self._chunks.append(data)
        self._size += len(data)
        if self._size >= FLUSH_BYTES:
            self._flush_async()

    def write_bytes(self, data: bytes) -> None:
        self._chunks.append(bytes(data))
        self._size += len(data)
        if self._size >= FLUSH_BYTES:
            self._flush_async()

    def _flush_async(self) -> None:
        if self._err_box:
            raise self._err_box[0]
        chunk = encode_chunks(self._chunks)
        self._chunks, self._size = [], 0
        if self._thread is None:
            # bounded queue: a slow disk backpressures the producer at
            # ~4MB in flight instead of buffering the whole file. The
            # thread closes over (q, f, err_box) — NOT the builder — so
            # an abandoned builder stays collectable and close()/__del__
            # can shut the thread down instead of leaking it blocked in
            # get()
            self._q = queue.Queue(maxsize=4)
            self._thread = threading.Thread(
                target=_writer_loop, args=(self._q, self._f, self._err_box),
                daemon=True)
            self._thread.start()
        self._q.put(chunk)

    def build(self, name: str) -> None:
        if self._thread is not None:
            if self._chunks:
                self._q.put(encode_chunks(self._chunks))
                self._chunks, self._size = [], 0
            self._q.put(None)
            self._thread.join()
            self._thread = None
        elif self._chunks:
            self._f.write(encode_chunks(self._chunks))
            self._chunks, self._size = [], 0
        if self._err_box:
            raise self._err_box[0]
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        os.replace(self._tmp, os.path.join(self._store.path, _encode(name)))
        self._built = True

    def close(self) -> None:
        """Release an unbuilt builder: stop the writer thread, close the
        fd, drop the ``.tmp.`` file. Idempotent; no-op after ``build``.
        The deterministic form of what ``__del__`` could only do at GC
        time — job runners call it on their failure paths."""
        if self._thread is not None and self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=5.0)
        self._thread = None
        if not self._f.closed:
            self._f.close()
        if not self._built:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass

    def __del__(self):
        """GC backstop for builders nobody closed — a long-lived elastic
        worker retrying failing jobs must not accumulate stuck
        threads/fds/orphan tempfiles even if a caller forgot close()."""
        try:
            self.close()
        except Exception:
            pass


def _writer_loop(q: "queue.Queue", f, err_box: List[BaseException]) -> None:
    """Background chunk writer. Keeps consuming after a write error so
    the bounded queue never deadlocks the producer; the first error is
    parked in ``err_box`` and surfaced by the builder — and logged here
    with its real context, because a producer that never reaches
    ``build`` (it raised for its own reasons) would otherwise drop the
    write failure silently."""
    while True:
        chunk = q.get()
        if chunk is None:
            return
        if not err_box:
            try:
                f.write(chunk)
            except BaseException as e:
                _log.warning("sharedfs async writer: deferred write "
                             "error (surfaced at build): %r", e)
                err_box.append(e)


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

    def local_path(self, name: str) -> str:
        """POSIX path of ``name``: native code (the C++ shuffle merge and
        word-count map) reads and publishes runs directly."""
        return os.path.join(self.path, _encode(name))

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.path, _encode(name)))

    def remove(self, name: str) -> None:
        try:
            os.remove(os.path.join(self.path, _encode(name)))
        except FileNotFoundError:
            pass
