"""Fault-plane accounting: the process-global counter registry
(``retry.COUNTERS``), trimmed from the JAX package's ``faults/``."""
