"""Parallel layer of the port: the single-device attention oracle and
the ring body on one shard (the multi-shard ring, zigzag and Ulysses
are the sequence-parallel slice)."""
