"""Object-store storage backend, with local emulation.

Copy of the JAX package's ``store/objectfs.py`` (the reference's
``sshfs`` pull-from-producer backend, fs.lua:143-160, as an object
store). Real GCS is gated behind ``google.cloud.storage`` being
importable — in this repo that is only the fake of
``store/fake_gcs.py`` — otherwise a bucket is emulated as a local
directory with strict object semantics: whole-object PUT (no append,
no rename visible to readers) and GET. ``read_range`` is a ranged GET
and ``size`` comes from object metadata, the access pattern of v2
segments (core/segment.py).

URI forms accepted: ``object:/abs/dir``, ``object:relative/dir``,
``object:gs://bucket/prefix``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterator, List, Union

from lua_mapreduce_tpu_torch.store.base import FileBuilder, Store, encode_chunks
from lua_mapreduce_tpu_torch.store.sharedfs import (FLUSH_BYTES, READ_BUFFER,
                                              _decode, _encode)


class _ObjectBuilder(FileBuilder):
    """Buffer locally, publish with a single whole-object PUT.

    Writes batch in memory and hit the staging tempfile in ~1MB chunks
    (the line-at-a-time ``f.write`` per record was a syscall per record),
    keeping the object contract untouched: readers only ever see the
    single atomic PUT in ``build``. The staging file is binary so text
    records and raw segment frames share one path.
    """

    def __init__(self, store: "ObjectStore"):
        self._store = store
        fd, self._tmp = tempfile.mkstemp(prefix="objfs.")
        self._f = os.fdopen(fd, "wb")
        self._chunks: List[Union[str, bytes]] = []
        self._size = 0
        self._built = False

    def write(self, data: str) -> None:
        self._chunks.append(data)
        self._size += len(data)
        if self._size >= FLUSH_BYTES:
            self._drain()

    def write_bytes(self, data: bytes) -> None:
        self._chunks.append(data)
        self._size += len(data)
        if self._size >= FLUSH_BYTES:
            self._drain()

    def _drain(self) -> None:
        if self._chunks:
            self._f.write(encode_chunks(self._chunks))
            self._chunks, self._size = [], 0

    def build(self, name: str) -> None:
        self._drain()
        self._f.close()
        with open(self._tmp, "rb") as f:
            self._store._put(name, f.read())
        os.remove(self._tmp)
        self._built = True

    def close(self) -> None:
        """Release an unbuilt builder: close the fd, drop the staging
        file. Idempotent; no-op after ``build``."""
        if not self._f.closed:
            self._f.close()
        if not self._built:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass

    def __del__(self):
        """GC backstop for builders nobody closed."""
        try:
            self.close()
        except Exception:
            pass


class ObjectStore(Store):
    def __init__(self, uri: str):
        if uri.startswith("gs://"):
            try:
                from google.cloud import storage as gcs  # type: ignore
            except ImportError as e:  # pragma: no cover - gated capability
                raise RuntimeError(
                    "object:gs:// storage needs google-cloud-storage; use a "
                    "local path (object:/dir) on machines without it") from e
            bucket, _, prefix = uri[5:].partition("/")
            self._gcs = gcs.Client().bucket(bucket)  # pragma: no cover
            self._prefix = prefix
            self._dir = None
        else:
            self._gcs = None
            self._dir = uri
            os.makedirs(uri, exist_ok=True)
            # local emulation publishes via atomic os.replace; only the
            # real-GCS network PUT can error after landing (class
            # default True stands for the gs:// branch)
            self.publish_ambiguous = False

    # -- object primitives (PUT/GET/ranged GET/LIST/DELETE — no rename or
    # append) ---------------------------------------------------------------

    def _put(self, name: str, data: bytes) -> None:
        if self._gcs is not None:
            self._gcs.blob(self._key(name)).upload_from_string(data)
            return
        # local emulation still publishes atomically so concurrent readers
        # in the same emulated "bucket" never see a partial object
        fd, tmp = tempfile.mkstemp(dir=self._dir, prefix=".put.")
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(self._dir, _encode(name)))

    def _get(self, name: str) -> bytes:
        if self._gcs is not None:
            return self._gcs.blob(self._key(name)).download_as_bytes()
        with open(os.path.join(self._dir, _encode(name)), "rb") as f:
            return f.read()

    def _key(self, name: str) -> str:
        return f"{self._prefix}/{name}" if self._prefix else name

    # -- Store API ---------------------------------------------------------

    def builder(self) -> FileBuilder:
        return _ObjectBuilder(self)

    def lines(self, name: str) -> Iterator[str]:
        if self._gcs is None:
            # local emulation: stream with a large buffer instead of
            # materializing the whole object — PUTs are atomic replaces,
            # so a reader only ever opens complete objects, and a k-way
            # merge over N runs stops holding N whole partitions in RAM
            with open(os.path.join(self._dir, _encode(name)),
                      buffering=READ_BUFFER) as f:
                yield from f
            return
        data = self._get(name).decode()          # real GCS: whole-object GET
        for line in data.splitlines(keepends=True):
            yield line

    def read_range(self, name: str, offset: int, length: int) -> bytes:
        if length <= 0:
            return b""
        if self._gcs is not None:
            # ranged GET; GCS's end is INCLUSIVE. Past-EOF starts raise
            # RequestRangeNotSatisfiable — normalize to the POSIX
            # short-read contract the segment reader expects
            try:
                return self._gcs.blob(self._key(name)).download_as_bytes(
                    start=offset, end=offset + length - 1)
            except Exception:
                if offset >= self.size(name):
                    return b""
                raise
        with open(os.path.join(self._dir, _encode(name)), "rb") as f:
            f.seek(offset)
            return f.read(length)

    def size(self, name: str) -> int:
        if self._gcs is not None:
            blob = self._gcs.get_blob(self._key(name))
            if blob is None:
                raise FileNotFoundError(name)
            return int(blob.size)
        return os.path.getsize(os.path.join(self._dir, _encode(name)))

    def list(self, pattern: str) -> List[str]:
        if self._gcs is not None:
            # prefix must include the separator: a bare "inter" would
            # also match sibling "inter2/..." blobs and mangle their names
            pfx = f"{self._prefix}/" if self._prefix else ""
            names = [b.name[len(pfx):]
                     for b in self._gcs.list_blobs(prefix=pfx or None)]
        else:
            names = [_decode(f) for f in os.listdir(self._dir)
                     if not f.startswith(".put.")]
        return self._match(names, pattern)

    def exists(self, name: str) -> bool:
        if self._gcs is not None:
            return self._gcs.blob(self._key(name)).exists()
        return os.path.exists(os.path.join(self._dir, _encode(name)))

    def classify(self, exc: BaseException):
        """Object-store error shapes on top of the central taxonomy:
        google-api-core exceptions carry a numeric ``code`` (503/429/5xx
        → transient; 404 NotFound → permanent) and requests transport
        errors match by class name — both handled WITHOUT importing the
        optional SDKs (faults/errors.py), plus NotFound-by-name here."""
        if type(exc).__name__ in ("NotFound", "Forbidden"):
            return False
        code = getattr(exc, "code", None)
        if isinstance(code, int) and code in (403, 404, 410):
            return False
        return super().classify(exc)

    def remove(self, name: str) -> None:
        if self._gcs is not None:
            # delete-if-exists: the engine removes names that may be
            # absent (stale-run cleanup), and GCS raises NotFound there
            try:
                self._gcs.blob(self._key(name)).delete()
            except Exception:
                if self.exists(name):   # a real failure, not absence
                    raise
            return
        try:
            os.remove(os.path.join(self._dir, _encode(name)))
        except FileNotFoundError:
            pass
