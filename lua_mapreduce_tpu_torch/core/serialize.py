"""Record serialization and canonical key ordering.

Analog of reference mapreduce/utils.lua:100-128: the reference writes
Lua-loadable lines ``return key,{v1,v2,...}\\n`` (utils.lua:107-120) and reads
them back with ``load(line)()`` (utils.lua:222-224). Executing data as code is
a Lua idiom, not a Python one — records here are single-line JSON arrays
``[key, [values...]]``, which are safe to load, language-neutral, and
streamable line-by-line through any storage backend.

Also provides the canonical sort order for heterogeneous keys
(utils.lua:123-128 sorts mixed-type keys by type then value) used by the map
output sort and the k-way merge.
"""

from __future__ import annotations

import functools
import json
import re
from math import isfinite
from typing import Any, Iterable, List, Tuple as PyTuple

from lua_mapreduce_tpu_torch.core import tuples

# chars a JSON string can't carry raw (ensure_ascii=False keeps unicode raw)
_NEEDS_ESCAPE = re.compile(r'[\\"\x00-\x1f]')


def dump_record(key: Any, values: Iterable[Any]) -> str:
    """One record as a single JSON line (no trailing newline).

    Fast path: escape-free str key + int/escape-free-str values formats
    the line directly — json.dumps per record was the top cost of a
    wordcount map job (~1/3 of its wall time). Byte-identical to the
    json.dumps output for the covered shapes (type checks are exact, so
    bool — a JSON-incompatible repr — never slips through as int).
    """
    # fast path requires a re-iterable container: a half-consumed generator
    # could not fall back to json.dumps without losing values
    if (type(key) is str and isinstance(values, (list, tuple))
            and not _NEEDS_ESCAPE.search(key)):
        parts = []
        for v in values:
            tv = type(v)
            if tv is int:
                parts.append(str(v))
            elif tv is str and not _NEEDS_ESCAPE.search(v):
                parts.append(f'"{v}"')
            elif tv is float and isfinite(v):
                # json.dumps emits float.__repr__ for finite floats, so
                # repr() is byte-identical; inf/nan fall back to the slow
                # path (json spells them Infinity/NaN, repr does not)
                parts.append(repr(v))
            else:
                break
        else:
            return f'["{key}",[{",".join(parts)}]]'
    return json.dumps([_plain(key), [_plain(v) for v in values]],
                      separators=(",", ":"), ensure_ascii=False)


def dump_key(key: Any) -> str:
    """Serialized JSON of a record KEY alone — byte-identical to the key
    portion of :func:`dump_record`'s output. Segment footers index frames
    by their first key in this form (core/segment.py)."""
    return json.dumps(_plain(key), separators=(",", ":"),
                      ensure_ascii=False)


def load_record(line: str) -> PyTuple[Any, List[Any]]:
    """Inverse of :func:`dump_record`. List-shaped keys come back interned."""
    key, values = json.loads(line)
    if isinstance(key, list):
        key = tuples.intern(key)
    return key, values


def _plain(v: Any) -> Any:
    """Strip Tuple subclass so json serializes it as an array."""
    if isinstance(v, tuple):
        return [_plain(x) for x in v]
    return v


def _needs_plain(v: Any) -> bool:
    """Does ``v`` contain anything :func:`to_plain` would convert?
    The identity probe that keeps the hot store-plane emit path
    allocation-free: plain scalars and containers of them answer False
    without any rebuilding."""
    if v is None or type(v) in (bool, int, float, str):
        return False
    if isinstance(v, dict):
        return any(_needs_plain(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return any(_needs_plain(x) for x in v)
    return True


def to_plain(v: Any) -> Any:
    """Normalize an emitted value to the plain-Python record surface.

    IDENTITY — the original object, no copies — for everything the
    engine historically carried: None/bool/int/float/str and containers
    of them (emit is the engine's hottest loop; a deep rebuild per
    record would tax every store-plane map job). Array-likes (numpy
    ndarrays/scalars, torch tensors on any device — anything exposing
    ``tolist``) convert to nested Python lists / scalars, which is
    byte-identical to the user having called ``.tolist()`` before
    emitting; containers holding them are rebuilt (tuples as lists).
    The store plane applies it at emit, at combiner output, and at
    reduce output (engine/job.py), so a task emitting tensors
    serializes to the same record bytes as one emitting plain lists —
    and as the JAX package's emitting arrays of the same values.
    """
    if not _needs_plain(v):
        return v
    if isinstance(v, dict):
        return {k: to_plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [to_plain(x) for x in v]
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        return to_plain(tolist())
    return v


def serialized_size(value: Any) -> int:
    """Byte size of a value's serialized form — used for the taskfn value cap
    (reference server.lua:263-267, MAX_TASKFN_VALUE_SIZE)."""
    return len(json.dumps(_plain(value), separators=(",", ":")).encode())


# --- canonical ordering for heterogeneous keys -----------------------------

_TYPE_RANK = {bool: 0, int: 1, float: 1, str: 2, tuple: 3, type(None): 4}


def type_rank(v: Any) -> int:
    for t, r in _TYPE_RANK.items():
        if isinstance(v, t):
            return r
    return 5


def key_lt(a: Any, b: Any) -> bool:
    """Total order over mixed-type keys: by type rank, then value.

    Mirrors the reference's mixed-type key sort (utils.lua:123-128) which
    compares ``tostring`` forms across types; here types are ranked and
    values compared natively within a rank (tuples: elementwise recursive,
    matching tuple.lua:183-201 lexicographic __lt).
    """
    ra, rb = type_rank(a), type_rank(b)
    if ra != rb:
        return ra < rb
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            if key_lt(x, y):
                return True
            if key_lt(y, x):
                return False
        return len(a) < len(b)
    if a is None:
        return False
    return a < b


def sorted_keys(keys: Iterable[Any]) -> List[Any]:
    """Sort heterogeneous keys canonically (reference utils.lua:123-128).

    Fast path: each key maps to a canonical sortable form — scalars to
    (rank, value), tuples RECURSIVELY to (rank, tuple-of-forms) — whose
    native tuple comparison is exactly key_lt's order (rank decides
    cross-type, value decides within-rank, elementwise-then-length for
    tuples; bool-vs-int inside tuples stays rank-separated, where a
    naive (rank, key) form would compare True==1 numerically). This is
    ~40x cheaper than a cmp_to_key comparator, which was 80% of a
    wordcount map job's wall time. Unrankable key types (rank 5, never
    produced by the record format) fall back to the exact comparator.
    """
    keys = list(keys)
    if all(type(k) is str for k in keys):
        return sorted(keys)    # single-rank: native order == key_lt order
    try:
        return sorted(keys, key=_canon_key)
    except TypeError:
        return sorted(keys, key=functools.cmp_to_key(
            lambda a, b: -1 if key_lt(a, b) else (1 if key_lt(b, a) else 0)))


def _canon_key(k: Any):
    r = type_rank(k)
    if isinstance(k, tuple):
        return (r, tuple(_canon_key(e) for e in k))
    if k is None:
        return (r, 0)       # all Nones equal; never compare None itself
    if r == 5:
        raise TypeError(f"unrankable key type {type(k).__name__}")
    return (r, k)


def assert_serializable(value: Any, path: str = "value") -> None:
    """Validate a value is record-serializable (reference utils.lua:313-333
    ``assert_check`` enforces JSON-compatible emit values)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return
    if isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            assert_serializable(v, f"{path}[{i}]")
        return
    if isinstance(value, dict):
        for k, v in value.items():
            if not isinstance(k, str):
                raise TypeError(f"{path}: dict keys must be str, got {type(k)}")
            assert_serializable(v, f"{path}.{k}")
        return
    raise TypeError(f"{path}: unserializable type {type(value).__name__}")
