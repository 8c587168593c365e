"""Binary min-heap with a custom comparator.

Analog of reference mapreduce/heap.lua:29-93 — used by the k-way merge
iterator. Python's ``heapq`` does not take a comparator, and the merge needs
one (heterogeneous record keys), so this is a small explicit implementation
with the same API: push / pop / top / empty / size.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional


class Heap:
    """Binary min-heap ordered by ``lt`` (defaults to ``<``)."""

    def __init__(self, lt: Optional[Callable[[Any, Any], bool]] = None):
        self._lt = lt if lt is not None else (lambda a, b: a < b)
        self._data: List[Any] = []

    def size(self) -> int:
        return len(self._data)

    def empty(self) -> bool:
        return not self._data

    def top(self) -> Any:
        """Smallest element without removing it (reference heap.lua:29-31)."""
        if not self._data:
            raise IndexError("top of empty heap")
        return self._data[0]

    def push(self, value: Any) -> None:
        """Insert and sift up (reference heap.lua:55-70)."""
        data, lt = self._data, self._lt
        data.append(value)
        i = len(data) - 1
        while i > 0:
            parent = (i - 1) // 2
            if lt(data[i], data[parent]):
                data[i], data[parent] = data[parent], data[i]
                i = parent
            else:
                break

    def pop(self) -> Any:
        """Remove and return the smallest element (reference heap.lua:33-53)."""
        data, lt = self._data, self._lt
        if not data:
            raise IndexError("pop from empty heap")
        top = data[0]
        last = data.pop()
        n = len(data)
        if n:
            data[0] = last
            i = 0
            while True:
                left, right = 2 * i + 1, 2 * i + 2
                smallest = i
                if left < n and lt(data[left], data[smallest]):
                    smallest = left
                if right < n and lt(data[right], data[smallest]):
                    smallest = right
                if smallest == i:
                    break
                data[i], data[smallest] = data[smallest], data[i]
                i = smallest
        return top
