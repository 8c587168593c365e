"""Shared AST helper of the static checks.

Copy of ``_chain`` from the JAX package's ``analysis/rules.py``; the
rule registry is not ported.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple


def _chain(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """Dotted-name parts of a Name/Attribute expr ('a.b.c' → (a, b, c))."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None
