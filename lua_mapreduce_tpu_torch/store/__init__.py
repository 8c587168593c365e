"""Intermediate storage ("fs") layer: ``mem`` (host DRAM) and ``shared``
(a POSIX directory). Copies of the JAX package's backends of the same
names; ``object`` is a later slice."""

from lua_mapreduce_tpu_torch.store.base import FileBuilder, Store
from lua_mapreduce_tpu_torch.store.router import get_storage_from

__all__ = ["Store", "FileBuilder", "get_storage_from"]
