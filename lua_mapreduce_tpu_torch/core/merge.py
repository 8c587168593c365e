"""Streaming k-way merge of sorted run files.

Copy of the JAX package's ``core/merge.py`` (the torch package imports
nothing of the JAX package).

Analog of reference mapreduce/utils.lua:206-271 ``merge_iterator``: given a
storage backend and a list of sorted run files (one per mapper, all for the
same partition), heap-merge them and yield ``(key, values)`` with the value
lists of equal keys concatenated across files — without materializing more
than one record per file in memory (the reference streams GridFS chunks the
same way, utils.lua:133-200).
"""

from __future__ import annotations

from typing import Any, Iterator, List, Sequence, Tuple

from lua_mapreduce_tpu_torch.core.heap import Heap
from lua_mapreduce_tpu_torch.core.serialize import key_lt


def merge_iterator(store, filenames: Sequence[str]) -> Iterator[Tuple[Any, List[Any]]]:
    """Yield merged (key, values) pairs across sorted run files.

    ``store`` is any object with ``lines(name) -> Iterator[str]`` (the fs
    layer, SURVEY.md §1 L1). Mirrors utils.lua:206-271: ``take_next`` parses
    one record per file (218-230); ``merge_min_keys`` concatenates the value
    lists sharing the minimum key (232-247).

    Run files are read through ``segment.record_stream``, so every input
    may independently be v1 text or a v2 framed segment (DESIGN §17) —
    the merge is the mixed-fleet compatibility point. When EVERY input is
    a segment whose footer promises all-str keys, the merge switches to
    native-comparison heapq (:func:`_merge_str_keyed`) — within the str
    rank, ``key_lt`` IS plain ``<``, so the order (and the equal-key
    run-order concatenation) is byte-identical, at C compare speed
    instead of a Python lambda per heap hop. v1 text cannot make that
    promise without a full scan, which is exactly why the format carries
    it.
    """
    from lua_mapreduce_tpu_torch.core.segment import _text_records, open_segment

    iters = []
    all_str = bool(filenames)
    for name in filenames:
        rdr = open_segment(store, name)
        if rdr is None:
            # already sniffed: go straight to the text reader (a second
            # record_stream sniff would re-read shim-backed stores)
            all_str = False
            iters.append(_text_records(store, name))
        else:
            all_str = all_str and rdr.str_keys
            iters.append(rdr.iter_records())
    if all_str:
        return _merge_str_keyed(iters)
    return _merge_generic(iters)


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
        # deterministic and identical to the native C++ merge's output
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


def _merge_str_keyed(iters: List[Iterator[Tuple[Any, List[Any]]]]
                     ) -> Iterator[Tuple[Any, List[Any]]]:
    """All-str-key merge on ``heapq`` with native tuple comparison.

    ``(key, idx)`` ordering reproduces the generic path exactly: within
    the str rank key_lt is ``<``, and equal keys pop in ascending run
    index — the same run-file-order concatenation ``sorted(drained)``
    produces. ``idx`` is unique per heap entry, so the values list is
    never compared.
    """
    import heapq

    heap: List[Any] = []
    for idx, it in enumerate(iters):
        rec = next(it, None)
        if rec is not None:
            heap.append((rec[0], idx, rec[1]))
    heapq.heapify(heap)
    push, pop = heapq.heappush, heapq.heappop
    while heap:
        key, idx, merged = pop(heap)
        drained = [idx]
        # drain CURRENT heads sharing the key (exactly the generic
        # drain set), then refill — a same-key successor within one run
        # must surface as its own group, as in the generic path. Equal
        # keys pop in ascending run index, so extending in pop order IS
        # the run-file-order concatenation; the values list is freshly
        # parsed per record, so in-place extend aliases nothing.
        while heap and heap[0][0] == key:
            _, jdx, more = pop(heap)
            merged.extend(more)
            drained.append(jdx)
        for jdx in drained:
            nxt = next(iters[jdx], None)
            if nxt is not None:
                push(heap, (nxt[0], jdx, nxt[1]))
        yield key, merged


def utest() -> None:
    """Self-test: merge three sorted runs with overlapping keys."""
    from lua_mapreduce_tpu_torch.core.serialize import dump_record

    class _MemStore:
        def __init__(self, files):
            self.files = files

        def lines(self, name):
            return iter(self.files[name])

    store = _MemStore({
        "a": [dump_record("apple", [1]), dump_record("cat", [1, 1])],
        "b": [dump_record("apple", [2]), dump_record("bee", [5])],
        "c": [dump_record("cat", [3])],
    })
    out = list(merge_iterator(store, ["a", "b", "c"]))
    assert out == [("apple", [1, 2]), ("bee", [5]), ("cat", [1, 1, 3])], out
