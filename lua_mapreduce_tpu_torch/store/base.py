"""Storage backend interface.

Copy of the JAX package's ``store/base.py`` (reference fs.lua:185-208,
255-257): a :class:`Store` hands out atomic ``builder()``s and streaming
``lines()``, plus list/remove/exists, and the byte surface the Server's
loop-state checkpoint needs (``FileBuilder.write_bytes``,
``Store.read_range`` and ``Store.size``) that v2 segments read
through. ``publish_ambiguous`` and ``classify`` are the retry layer's
hooks (faults/wrappers.py).
"""

from __future__ import annotations

import abc
import fnmatch
from typing import Iterator, List, Sequence, Union


def encode_chunks(chunks: Sequence[Union[str, bytes]]) -> bytes:
    """Flatten a mixed str/bytes chunk list to bytes, encoding runs of
    text in one pass."""
    out: List[bytes] = []
    strs: List[str] = []
    for c in chunks:
        if isinstance(c, str):
            strs.append(c)
        else:
            if strs:
                out.append("".join(strs).encode("utf-8"))
                strs = []
            out.append(c)
    if strs:
        out.append("".join(strs).encode("utf-8"))
    return b"".join(out)


class FileBuilder(abc.ABC):
    """Accumulate text, then atomically publish it as a named file.

    Mirrors reference fs.lua:80-115 (tmpfile + atomic rename): readers
    never observe partial files.
    """

    @abc.abstractmethod
    def write(self, data: str) -> None:
        """Append ``data`` (caller supplies newlines)."""

    @abc.abstractmethod
    def build(self, name: str) -> None:
        """Atomically publish the accumulated content as ``name``."""

    def write_bytes(self, data: bytes) -> None:
        """Append raw bytes (segment frames, a CRC-framed checkpoint).
        Default TEXT SHIM: latin-1 maps every byte to the same-ordinal
        code point, so a store that keeps written strings verbatim
        round-trips through ``Store.read_range``'s matching shim."""
        self.write(data.decode("latin-1"))

    def close(self) -> None:
        """Release resources of an UNBUILT builder (failed producer).
        Idempotent; a no-op after ``build``."""

    def __enter__(self) -> "FileBuilder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Store(abc.ABC):
    """A named-file store with streaming line reads and glob listing."""

    # True when a FAILED ``build`` may nonetheless have published (a
    # network PUT that errored after the object landed) or published
    # torn: the retry layer then keeps the written chunks for readback-
    # verify and rebuild. Backends whose publish is a local atomic
    # tempfile+rename set it False.
    publish_ambiguous = True

    @abc.abstractmethod
    def builder(self) -> FileBuilder:
        ...

    @abc.abstractmethod
    def lines(self, name: str) -> Iterator[str]:
        """Stream the lines of ``name`` (never loads the whole file on
        file-backed stores)."""

    @abc.abstractmethod
    def list(self, pattern: str) -> List[str]:
        """Names matching a shell glob, sorted."""

    @abc.abstractmethod
    def exists(self, name: str) -> bool:
        ...

    @abc.abstractmethod
    def remove(self, name: str) -> None:
        """Delete ``name`` if present (idempotent)."""

    def read_range(self, name: str, offset: int, length: int) -> bytes:
        """``length`` bytes of ``name`` from ``offset`` (short at EOF).
        Default TEXT SHIM: the whole file through ``lines``, sliced —
        for verbatim-string stores; the bundled backends override it."""
        return self._shim_bytes(name)[offset:offset + length]

    def size(self, name: str) -> int:
        """Total byte size of ``name`` (default: the text shim)."""
        return len(self._shim_bytes(name))

    def _shim_bytes(self, name: str) -> bytes:
        data = "".join(self.lines(name))
        try:
            return data.encode("latin-1")   # inverse of the write shim
        except UnicodeEncodeError:
            # code points past 255 mean genuine text, never shim bytes
            return data.encode("utf-8")

    def classify(self, exc: BaseException):
        """Transient (True) / permanent (False) / not a storage fault
        (None) for an exception this backend's ops raised: the central
        table (faults/errors.classify_exception), refined by backends
        that know their own error shapes (objectfs)."""
        from lua_mapreduce_tpu_torch.faults.errors import \
            classify_exception
        return classify_exception(exc)

    @staticmethod
    def _match(names, pattern: str) -> List[str]:
        return sorted(n for n in names if fnmatch.fnmatchcase(n, pattern))
