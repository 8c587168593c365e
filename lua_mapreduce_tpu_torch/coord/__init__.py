"""Coordination plane, trimmed to what ``DataParallelTrainer.fit(conf=)``
needs: the persistent-table half of the job store (``jobstore``,
``filestore``) and ``persistent_table`` itself."""
