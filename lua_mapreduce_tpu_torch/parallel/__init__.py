"""Parallel layer of the port (the attention oracle in this slice; the
ring itself is a later slice)."""
