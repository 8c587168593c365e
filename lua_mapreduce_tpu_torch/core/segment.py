"""Spill record writer and reader — the v1 text half of the JAX
package's ``core/segment.py``.

v1 writes one JSON record per line (reference utils.lua:107-120), which
is what the port's barrier engine spills and what every partition result
file holds. The framed binary ``JSEG0001`` format (v2) is a later slice:
asking for it raises rather than silently writing v1.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Tuple

from lua_mapreduce_tpu_torch.core.serialize import dump_record, load_record

class TextWriter:
    """v1 record writer: one JSON line per record through a plain
    builder — byte-identical to the JAX package's spill format."""

    def __init__(self, builder):
        self._b = builder

    def add(self, key: Any, values: Any) -> None:
        self._b.write(dump_record(key, values) + "\n")

    def build(self, name: str) -> None:
        self._b.build(name)

    def close(self) -> None:
        self._b.close()

    def __enter__(self) -> "TextWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def writer_for(store) -> TextWriter:
    """Spill writer over a fresh builder of ``store``."""
    return TextWriter(store.builder())


def _text_records(store, name: str) -> Iterator[Tuple[Any, List[Any]]]:
    for line in store.lines(name):
        line = line.strip()
        if line:
            yield load_record(line)
