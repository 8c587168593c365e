"""Streaming k-way merge of sorted run files.

Copy of the JAX package's ``core/merge.py`` (reference
mapreduce/utils.lua:206-271 ``merge_iterator``), v1 text runs only: the
framed-segment str-key fast path and the native C++ merge are later
slices. Given a storage backend and a list of sorted run files (one per
mapper, all for the same partition), heap-merge them and yield
``(key, values)`` with the value lists of equal keys concatenated across
files in run-file order — never more than one record per file in memory.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Sequence, Tuple

from lua_mapreduce_tpu_torch.core.heap import Heap
from lua_mapreduce_tpu_torch.core.segment import _text_records
from lua_mapreduce_tpu_torch.core.serialize import key_lt


def merge_iterator(store, filenames: Sequence[str]
                   ) -> Iterator[Tuple[Any, List[Any]]]:
    """Yield merged (key, values) pairs across sorted v1 run files.

    ``store`` is any object with ``lines(name) -> Iterator[str]``.
    Mirrors utils.lua:206-271: one parsed record per file at the heap
    (218-230); value lists sharing the minimum key are concatenated
    (232-247).
    """
    return _merge_generic([_text_records(store, name) for name in filenames])


def _merge_generic(iters: List[Iterator[Tuple[Any, List[Any]]]]
                   ) -> Iterator[Tuple[Any, List[Any]]]:
    """The heterogeneous-key merge: a key_lt-ordered heap (mixed type
    ranks, tuples, bignums — the full canonical order)."""
    heap: Heap = Heap(lt=lambda a, b: key_lt(a[0], b[0]))
    for idx, it in enumerate(iters):
        rec = next(it, None)
        if rec is not None:
            heap.push((rec[0], rec[1], idx))

    while not heap.empty():
        key, values, idx = heap.pop()
        # drain every file whose head shares this key; concatenate in
        # RUN-FILE ORDER (not heap pop order) so reduce inputs are
        # deterministic and byte-identical to the JAX package's merge
        drained = [(idx, values)]
        while not heap.empty() and not key_lt(key, heap.top()[0]):
            _, more, jdx = heap.pop()
            drained.append((jdx, more))
        merged: List[Any] = []
        for jdx, more in sorted(drained):
            merged.extend(more)
            nxt = next(iters[jdx], None)
            if nxt is not None:
                heap.push((nxt[0], nxt[1], jdx))
        yield key, merged
