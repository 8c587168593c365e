"""Intermediate storage ("fs") layer: ``mem`` (host DRAM), ``shared`` (a
POSIX directory) and ``object`` (an object store, emulated as a local
directory or — through ``google.cloud.storage`` — a ``gs://`` bucket).
Copies of the JAX package's backends of the same names."""

from lua_mapreduce_tpu_torch.store.base import FileBuilder, Store
from lua_mapreduce_tpu_torch.store.router import get_storage_from, router

__all__ = ["Store", "FileBuilder", "get_storage_from", "router"]
