"""Core data model: interned tuples, heap, serialization, k-way merge.

Copies of the JAX package's pure-Python ``core/`` modules, trimmed to
the host data path, with the native C++ shuffle merge and word-count
map under ``core/native/`` (built by ``native_build.py``).
"""
