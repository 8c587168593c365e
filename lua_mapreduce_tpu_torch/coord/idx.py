"""Job-index engine selection.

Port of ``lua_mapreduce_tpu/coord/idx.py``. The JAX package picks
between a native C++ index (``coord/native/jobstore.cpp``, loaded with
ctypes) and the pure-Python one; both write the same files. The port has
only the Python engine so far:

- ``"python"`` opens :class:`~.idx_py.PyJobIndex`;
- ``"auto"`` resolves to ``"python"`` — what the JAX package's
  ``"auto"`` does wherever its native build is missing;
- ``"native"`` raises: the C++ index is not ported (ROADMAP A6b).
"""

from __future__ import annotations

from lua_mapreduce_tpu_torch.coord.idx_py import PyJobIndex

ENGINES = ("auto", "native", "python")


def open_index(path: str, engine: str = "auto") -> PyJobIndex:
    """Open the job index at ``path`` with ``engine``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown index engine {engine!r}; use one of "
                         f"{ENGINES}")
    if engine == "native":
        raise NotImplementedError(
            "index engine 'native' (the C++ job index) is not ported to "
            "the torch package yet (ROADMAP A6b); use 'python' or 'auto'")
    return PyJobIndex(path)
