"""Core data model: interned tuples, heap, serialization, k-way merge.

Copies of the JAX package's pure-Python ``core/`` modules, trimmed to
the v1 text spill path (no framed segments, no native merge).
"""
