"""Store/coord error taxonomy — transient vs permanent classification.

Copy of the JAX package's ``faults/errors.py`` (the torch package imports
nothing of the JAX package).

The reference treats every failure inside a job as a user-code failure:
worker.lua's xpcall marks the job BROKEN, repetitions climb, and three
storage hiccups push a perfectly good job to permanent FAILED
(server.lua:192-205). TensorFlow (arXiv:1605.08695 §4.2) and
Exoshuffle-CloudSort (arXiv:2301.03734) both separate *infrastructure*
faults — the 503 from an object store, the EIO from a flaky NFS mount,
a connection reset — from *deterministic* faults in user code, because
the right response differs: transient infra faults are retried (op
level) or released (job level, no repetition charge); deterministic
faults must burn a repetition so the scavenger can eventually give up.

This module is the shared vocabulary for that distinction:

- :class:`StoreError` — base of all *classified* storage/coordination
  faults, carrying ``transient`` (True = retry may help).
- :class:`TransientStoreError` / :class:`PermanentStoreError` — the two
  leaves everything raisable maps onto.
- :func:`classify_exception` — the central table mapping RAW exceptions
  (OSError errnos, timeouts, connection resets, GCS-shaped API errors)
  onto the taxonomy: True (transient), False (permanent), or None (not
  a storage fault at all — user code, logic errors).

Backends refine the table via ``Store.classify`` / ``JobStore.classify``
hooks (objectfs adds GCS error shapes); the retry layer
(faults/retry.py) consults the hook, and the worker's fault
discrimination (engine/worker.py) consults
:func:`is_transient_job_fault` on whatever finally propagates.
"""

from __future__ import annotations

import errno
from typing import Optional

# errnos a POSIX/NFS/FUSE mount produces under transient pressure: retry
# is the documented remedy for every one of these
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

# HTTP statuses a cloud object store returns for retryable conditions
# (GCS/S3 retry guidance: 408 request timeout, 429 rate limit, 5xx)
_TRANSIENT_HTTP = frozenset({408, 429, 500, 502, 503, 504})

# exception CLASS NAMES of third-party SDKs (google-cloud-storage,
# requests, urllib3) that mean "try again" — matched by name so the
# taxonomy never imports optional dependencies
_TRANSIENT_CLASS_NAMES = frozenset({
    "ServiceUnavailable", "TooManyRequests", "InternalServerError",
    "BadGateway", "GatewayTimeout", "DeadlineExceeded", "RetryError",
    "TransportError", "ChunkedEncodingError", "ReadTimeout",
    "ConnectTimeout", "ReadTimeoutError", "ProtocolError",
})


class StoreError(Exception):
    """A classified storage/coordination-plane fault.

    ``transient`` is the class-level verdict: True means a retry (same
    op, brief backoff) may succeed; False means it deterministically
    will not. Instances raised by the retry layer chain the original
    exception (``raise ... from exc``) and carry ``op``/``name`` —
    which store operation on which file/namespace — plus ``attempts``.
    """

    transient: bool = False

    def __init__(self, msg: str, *, op: Optional[str] = None,
                 name: Optional[str] = None, attempts: int = 1):
        super().__init__(msg)
        self.op = op
        self.name = name
        self.attempts = attempts


class TransientStoreError(StoreError):
    """Retry may help: 503s, timeouts, EIO, connection resets, flock
    contention. The retry layer absorbs bounded bursts of these; when a
    burst outlives the budget, the WORKER releases the job back to
    WAITING with no repetition charge (engine/worker.py)."""

    transient = True


class PermanentStoreError(StoreError):
    """Retry cannot help: the object is gone, the path is wrong, the
    credential is denied. Treated like any deterministic failure — the
    job goes BROKEN, repetitions climb, the scavenger can give up and
    the degradation ladders (premerge poison, strict-mode abort) fire."""

    transient = False


class InjectedFault(TransientStoreError):
    """A fault raised by FaultPlan injection (faults/plan.py) — its own
    type so test assertions can tell injected faults from real ones."""


class InjectedPermanentFault(PermanentStoreError):
    """Deterministic-injection flavor of a permanent fault."""


class NativeIndexError(TransientStoreError, OSError):
    """A job-index engine op reported failure without an errno (the
    native jsx_* calls return -1 on any IO/lock trouble). Transient —
    flock contention and IO pressure are the realistic causes, and the
    retry budget bounds the cost of being wrong. Subclasses OSError so
    callers catching that keep catching it."""


class NoTaskError(PermanentStoreError, RuntimeError):
    """update_task on a store with no task document — a protocol misuse,
    never retryable. Subclasses RuntimeError so pre-taxonomy callers
    (``except RuntimeError``) keep working."""


class ConcurrentInsertError(PermanentStoreError, RuntimeError):
    """Two inserters raced a namespace (a namespace has exactly ONE
    inserter — the server). Deterministic protocol violation."""


class NativeEngineError(PermanentStoreError, RuntimeError):
    """The native index engine is unusable by construction — ABI drift
    from idx_py, a library without the ABI export, or an explicitly
    requested native engine that does not build. Retrying cannot
    rebuild a library, so the retry layer fails fast. (Distinct from
    :class:`NativeIndexError`, the TRANSIENT per-op failure of a
    healthy engine.)"""


class LostShuffleDataError(TransientStoreError):
    """Every replica of a shuffle file is unreadable (DESIGN §20).

    Raised by the JAX package's replicated read view
    (faults/replicate.py, a later slice here) when the failover ladder
    runs out of copies. Transient by classification —
    the worker RELEASES the consuming job (no repetition charge) while
    the server's scavenger repairs the file from a survivor or, with
    all ``r`` copies gone, requeues the producing map job (the
    last-resort re-run). ``lost_files`` names the logical files so the
    scavenger acts on structure, not on traceback parsing."""

    def __init__(self, msg: str, *, files=(), **kw):
        super().__init__(msg, **kw)
        self.lost_files = list(files)


def classify_exception(exc: BaseException) -> Optional[bool]:
    """The central classification table.

    Returns True (transient — retry may help), False (permanent — it
    will not), or None (not a storage fault: user code, data errors,
    logic bugs — the retry layer must propagate these untouched).
    """
    if isinstance(exc, StoreError):
        return exc.transient
    # stdlib networking/timeout shapes are transient by construction
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
        # an OSError with no recognizable errno (the native index engine
        # raises bare OSError on a failed jsx op; fcntl can surface
        # unmapped codes): IO-shaped, cause unknown — retry is cheap and
        # the budget is bounded, so err toward transient
        return True
    # KeyError from memfs lines()/read_range() on a missing name — the
    # in-memory analog of FileNotFoundError
    if isinstance(exc, KeyError):
        return False
    # cloud-SDK shapes, matched without importing the SDKs: a numeric
    # ``code`` (google-api-core) or ``status_code`` (requests) in the
    # retryable set, or a well-known transient class name
    code = getattr(exc, "code", None)
    if not isinstance(code, int):
        code = getattr(exc, "status_code", None)
    if isinstance(code, int) and code in _TRANSIENT_HTTP:
        return True
    if type(exc).__name__ in _TRANSIENT_CLASS_NAMES:
        return True
    return None


def is_transient_job_fault(exc: BaseException) -> bool:
    """The worker's release-not-broken predicate for whole JOB BODIES.

    Provenance matters here: a job body runs user code too, and a user
    mapfn raising TimeoutError must not be laundered into an
    infrastructure fault (it would be released and re-executed forever).
    Only :class:`StoreError` subclasses provably crossed the store/coord
    boundary — the retry layer wraps every exhausted transient burst in
    one — so only they qualify. Raw builtins escaping a job body are
    treated as user code (exactly the pre-taxonomy behavior; with the
    retry layer stripped via retries=0, discrimination degrades to that
    old behavior rather than misfiring)."""
    return isinstance(exc, StoreError) and exc.transient


def classify_job_fault(exc: BaseException) -> str:
    """Errors-stream label for a failed JOB: 'infra-transient' /
    'infra-permanent' for classified StoreErrors (provenance known),
    'user-code' for everything else — see
    :func:`is_transient_job_fault` for why raw builtins land in
    user-code."""
    if isinstance(exc, StoreError):
        return "infra-transient" if exc.transient else "infra-permanent"
    return "user-code"
