"""Storage backend interface.

Copy of the JAX package's ``store/base.py`` (reference fs.lua:185-208,
255-257) without the raw-bytes surface the v2 segments need: a
:class:`Store` hands out atomic ``builder()``s and streaming ``lines()``,
plus list/remove/exists.
"""

from __future__ import annotations

import abc
import fnmatch
from typing import Iterator, List


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

    def close(self) -> None:
        """Release resources of an UNBUILT builder (failed producer).
        Idempotent; a no-op after ``build``."""

    def __enter__(self) -> "FileBuilder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Store(abc.ABC):
    """A named-file store with streaming line reads and glob listing."""

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

    @staticmethod
    def _match(names, pattern: str) -> List[str]:
        return sorted(n for n in names if fnmatch.fnmatchcase(n, pattern))
