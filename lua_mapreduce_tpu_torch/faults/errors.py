"""Store/coord error taxonomy — what the Worker and the job stores consult.

Trimmed copy of the JAX package's ``faults/errors.py``: the classified
fault classes, the central :func:`classify_exception` table (behind
``JobStore.classify``) and the job-level discrimination the Worker uses
— a classified transient store fault releases its job with no
repetition charge, anything else (user code included) marks it BROKEN.

The JAX package's retry wrappers (``faults/wrappers.py``
``wrap_jobstore``) and fault injection (``FaultPlan``) are not ported
(ROADMAP A6b): the port's Server and Worker call their store directly.
"""

from __future__ import annotations

import errno
from typing import Optional

# errnos a POSIX/NFS/FUSE mount produces under transient pressure
_TRANSIENT_ERRNOS = frozenset(e for e in (
    errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY, errno.ETIMEDOUT,
    errno.ESTALE, errno.ENETDOWN, errno.ENETUNREACH, errno.ECONNRESET,
    errno.ECONNABORTED, errno.ECONNREFUSED, errno.EHOSTDOWN,
    errno.EHOSTUNREACH, errno.ENOBUFS, errno.ENOMEM, errno.EMFILE,
    errno.ENFILE, errno.EDEADLK,
) if e is not None)

# errnos that will not change on retry (caller bug or real absence)
_PERMANENT_ERRNOS = frozenset(e for e in (
    errno.ENOENT, errno.EACCES, errno.EPERM, errno.EISDIR, errno.ENOTDIR,
    errno.ENAMETOOLONG, errno.EROFS, errno.ENOSPC, errno.EDQUOT,
    errno.EBADF, errno.EINVAL,
) if e is not None)


class StoreError(Exception):
    """A classified storage/coordination-plane fault. ``transient`` is
    the class-level verdict: True means a retry may succeed."""

    transient: bool = False

    def __init__(self, msg: str, *, op: Optional[str] = None,
                 name: Optional[str] = None, attempts: int = 1):
        super().__init__(msg)
        self.op = op
        self.name = name
        self.attempts = attempts


class TransientStoreError(StoreError):
    """Retry may help (EIO, timeouts, lock contention). A job body that
    raises one is released back to WAITING with no repetition charge."""

    transient = True


class PermanentStoreError(StoreError):
    """Retry cannot help: treated like any deterministic failure."""

    transient = False


class NoTaskError(PermanentStoreError, RuntimeError):
    """update_task on a store with no task document — a protocol misuse."""


class ConcurrentInsertError(PermanentStoreError, RuntimeError):
    """Two inserters raced a namespace (a namespace has exactly ONE
    inserter — the server)."""


def classify_exception(exc: BaseException) -> Optional[bool]:
    """The central classification table: True (transient), False
    (permanent), or None (not a storage fault: user code, logic bugs)."""
    if isinstance(exc, StoreError):
        return exc.transient
    if isinstance(exc, (TimeoutError, ConnectionError, InterruptedError)):
        return True
    if isinstance(exc, (FileNotFoundError, PermissionError, IsADirectoryError,
                        NotADirectoryError)):
        return False
    if isinstance(exc, OSError):
        if exc.errno in _TRANSIENT_ERRNOS:
            return True
        if exc.errno in _PERMANENT_ERRNOS:
            return False
        return True
    # memfs lines() on a missing name — the in-memory FileNotFoundError
    if isinstance(exc, KeyError):
        return False
    return None


def is_transient_job_fault(exc: BaseException) -> bool:
    """The Worker's release-not-broken predicate for whole job bodies.
    Only :class:`StoreError` subclasses provably crossed the store
    boundary; a user mapfn raising TimeoutError is user code and must
    burn a repetition, or it would be released and re-run forever."""
    return isinstance(exc, StoreError) and exc.transient


def classify_job_fault(exc: BaseException) -> str:
    """Errors-stream label for a failed job: 'infra-transient' /
    'infra-permanent' for classified StoreErrors, 'user-code' for
    everything else."""
    if isinstance(exc, StoreError):
        return "infra-transient" if exc.transient else "infra-permanent"
    return "user-code"
