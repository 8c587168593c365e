"""Coordination plane: the job store (job queues with the claim CAS, the
task singleton, the errors stream, persistent documents) in memory
(``jobstore.MemJobStore``) and over a shared directory
(``filestore.FileJobStore`` on the job index: the native C++ engine,
``idx.py`` over ``native/jobstore.cpp``, or ``idx_py``), speculative
duplicate leases on both stores, and ``persistent_table`` on top of
it."""

from lua_mapreduce_tpu_torch.coord.jobstore import JobStore, MemJobStore
from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.persistent_table import PersistentTable

__all__ = ["JobStore", "MemJobStore", "FileJobStore", "PersistentTable"]
