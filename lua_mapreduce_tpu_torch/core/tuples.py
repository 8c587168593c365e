"""Interned (hash-consed) immutable tuples.

Analog of reference mapreduce/tuple.lua: immutable tuples, interned so that
structurally-equal tuples are the *same object* (pointer equality), usable as
emit keys/values. The reference builds this from scratch in Lua (weak bucket
table of 2^18 entries, Jenkins one-at-a-time hash, proxy metatables —
tuple.lua:77-81, 121-140, 167-215). In Python, ``tuple`` is already immutable
and hashable, so the new capability here is *interning* plus recursive
construction (tuple.lua:230-247) and stats introspection (tuple.lua:332-343).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable


class Tuple(tuple):
    """An interned immutable tuple. Use :func:`intern` to construct."""

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "Tuple" + super().__repr__()


# CPython tuples (and their subclasses) cannot carry weak references, so the
# reference's weak-bucket design (tuple.lua:77-81) maps to a *bounded* strong
# table: up to 2^18 entries (the reference's bucket count); on overflow the
# table is dropped and re-fills. Eviction only costs identity (a later intern
# of an equal tuple makes a fresh object) — equality and hashing are value
# based either way.
_MAX_ENTRIES = 2 ** 18
_lock = threading.Lock()
_table: Dict[tuple, Tuple] = {}


def intern(value: Iterable[Any]) -> Tuple:
    """Return the canonical interned Tuple for ``value``.

    Nested lists/tuples are interned recursively (reference tuple.lua:230-247).
    Structurally equal inputs return the identical object::

        intern([1, [2, 3]]) is intern((1, (2, 3)))  # True
    """
    items = tuple(
        intern(v) if isinstance(v, (list, tuple)) else v for v in value
    )
    with _lock:
        cached = _table.get(items)
        if cached is not None:
            return cached
        if len(_table) >= _MAX_ENTRIES:
            _table.clear()
        t = Tuple(items)
        _table[items] = t
        return t


def stats() -> dict:
    """Live intern-table statistics (reference tuple.lua:332-343)."""
    with _lock:
        return {"size": len(_table)}


def utest() -> None:
    """Self-test (reference tuple.lua:309-328)."""
    a = intern((1, 2, 3))
    b = intern([1, 2, 3])
    assert a is b
    assert a == (1, 2, 3)
    c = intern((1, (2, 3)))
    d = intern([1, [2, 3]])
    assert c is d
    assert c[1] is intern((2, 3))
    assert hash(a) == hash(b)
    assert {a: "x"}[b] == "x"
    # immutability: tuples reject item assignment by construction
    try:
        a[0] = 99  # type: ignore[index]
    except TypeError:
        pass
    else:  # pragma: no cover
        raise AssertionError("Tuple must be immutable")
    assert stats()["size"] >= 2
