"""The finding record of the static checks.

Copy of ``Finding`` from the JAX package's ``analysis/lint.py``; the
lint engine and its rule registry are not ported.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str
    severity: str            # "error" | "warning"
    path: str                # package-relative posix path
    line: int
    col: int
    message: str

    def key(self) -> tuple:
        return (self.path, self.line, self.rule)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)
