"""Coordination plane: the job store (job queues with the claim CAS, the
task singleton, the errors stream, persistent documents) in memory
(``jobstore.MemJobStore``) and over a shared directory
(``filestore.FileJobStore`` on the ``idx_py`` job index), and
``persistent_table`` on top of it."""
