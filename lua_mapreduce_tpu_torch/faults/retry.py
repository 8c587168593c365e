"""RetryPolicy — capped decorrelated-jitter backoff for store/coord ops.

Copy of the JAX package's ``faults/retry.py`` (the torch package imports
nothing of the JAX package).

The schedule is AWS-style decorrelated jitter (each delay drawn uniform
from [base, 3 * previous], capped), which spreads a thundering herd of
workers re-hitting a recovering store better than fixed exponential
steps. ``clock``/``sleep``/``rng`` are injectable so the whole fault
suite runs on a VIRTUAL clock — no wall-clock reads sneak into locked
regions (the LMR004 contract), and tests of 10-retry bursts finish in
microseconds.

Every retry event lands in the process-global :class:`FaultCounters`
(one instance, shared like JobStore's round counters) so the server can
fold per-iteration deltas into IterationStats.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Dict, Optional

from lua_mapreduce_tpu_torch.faults.errors import (TransientStoreError,
                                             classify_exception)

_log = logging.getLogger(__name__)

DEFAULT_RETRIES = 3          # extra attempts after the first
DEFAULT_BASE_MS = 25.0       # first backoff draw's lower bound
DEFAULT_CAP_MS = 2000.0      # no single sleep beyond this


class FaultCounters:
    """Process-global fault/retry/degradation accounting.

    In-process pools share the module singleton (:data:`COUNTERS`), so a
    server's IterationStats fold sees the whole pool's retry traffic —
    the same visibility contract as JobStore.round_counts. Increments
    happen only on fault events (never on the hot fault-free path), so
    the lock is uncontended in healthy runs.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._c: Dict[str, int] = {}

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._c[key] = self._c.get(key, 0) + n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)

    @staticmethod
    def delta(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
        return {k: after.get(k, 0) - before.get(k, 0)
                for k in set(before) | set(after)}


COUNTERS = FaultCounters()

# counter keys (shared vocabulary between retry layer, wrappers, stats):
#   retries            — sleeps taken before a retry attempt
#   retry_exhausted    — transient bursts that outlived the budget
#   faults_injected    — FaultPlan decisions that fired
#   infra_releases     — jobs released WAITING on transient infra faults
#   degraded_reads     — ranged-read fallbacks to a whole-file read
#   build_verified     — ambiguous builds resolved by readback-verify


class RetryPolicy:
    """Bounded transient-fault retry with decorrelated-jitter backoff.

    ``retries`` is the number of RE-attempts after the first try (0
    disables retrying entirely — the wrapper layer then strips to a
    passthrough). ``classify`` defaults to the central taxonomy; store
    wrappers pass the backend's own ``classify`` hook.
    """

    def __init__(self, retries: int = DEFAULT_RETRIES,
                 base_ms: float = DEFAULT_BASE_MS,
                 cap_ms: float = DEFAULT_CAP_MS,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 rng: Optional[random.Random] = None,
                 counters: FaultCounters = COUNTERS):
        self.retries = max(0, int(retries))
        self.base_s = max(0.0, float(base_ms)) / 1000.0
        self.cap_s = max(self.base_s, float(cap_ms) / 1000.0)
        self._sleep = sleep
        self._clock = clock
        self._rng = rng or random.Random()
        self.counters = counters

    def backoff_s(self, prev_s: float) -> float:
        """Next decorrelated-jitter delay: uniform in [base, 3*prev],
        capped. ``prev_s`` <= 0 means first retry (draw near base)."""
        hi = max(self.base_s, 3.0 * prev_s)
        return min(self.cap_s, self._rng.uniform(self.base_s, hi))

    def call(self, fn: Callable, *, op: str = "?", name: str = "?",
             classify: Callable = classify_exception,
             before_retry: Optional[Callable[[BaseException], bool]] = None):
        """Run ``fn()`` retrying transient faults up to the budget.

        - transient (classify → True): sleep a jittered backoff, retry;
          on exhaustion raise :class:`TransientStoreError` chaining the
          last fault (op/name/attempts recorded).
        - permanent (False) or unclassified (None): propagate RAW,
          immediately — wrapping would hide the type callers catch.

        ``before_retry(exc)``, when given, runs before each sleep; if it
        returns True the op is considered RESOLVED (the build-ambiguity
        readback-verify hook) and ``call`` returns None without
        retrying.
        """
        delay = 0.0
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except Exception as exc:
                if classify(exc) is not True:
                    raise
                if before_retry is not None and before_retry(exc):
                    return None
                if attempt >= self.retries:
                    self.counters.bump("retry_exhausted")
                    raise TransientStoreError(
                        f"{op}({name!r}) still failing after "
                        f"{attempt + 1} attempt(s): "
                        f"{type(exc).__name__}: {exc}",
                        op=op, name=name, attempts=attempt + 1) from exc
                delay = self.backoff_s(delay)
                self.counters.bump("retries")
                _log.warning("store %s(%r): transient %s: %s — retry "
                             "%d/%d in %.0fms", op, name,
                             type(exc).__name__, exc, attempt + 1,
                             self.retries, delay * 1000.0)
                self._sleep(delay)


# -- process-global default policy (CLI knobs / env) ------------------------
#
# Engines build their store/jobstore wrappers through configure_retry()'s
# values; subprocess pools (multiprocess churn tests, CLI fleets) inherit
# them via LMR_STORE_RETRIES / LMR_RETRY_BASE_MS. A config *generation*
# token lets caches (router's wrapped mem:tag stores) invalidate when a
# test or CLI flips the knobs mid-process.

_config_lock = threading.Lock()
_config = {"retries": None, "base_ms": None, "generation": 0}


def configure_retry(retries: Optional[int] = None,
                    base_ms: Optional[float] = None) -> None:
    """Set the process-wide retry defaults (None = back to env/default).
    The CLI's ``--store-retries`` / ``--retry-base-ms`` land here."""
    with _config_lock:
        _config["retries"] = retries
        _config["base_ms"] = base_ms
        _config["generation"] += 1


def retry_settings() -> Dict[str, float]:
    """Effective (retries, base_ms): configure_retry() wins, then the
    LMR_STORE_RETRIES / LMR_RETRY_BASE_MS environment, then defaults.
    A SET-but-malformed env value is rejected loudly (the FaultPlan
    spec-parsing rule: a typo must not silently run with defaults)."""
    import os

    def _env(var, convert, default):
        raw = os.environ.get(var)
        if raw is None or raw == "":
            return default
        try:
            return convert(raw)
        except ValueError:
            raise ValueError(f"bad {var}={raw!r}: expected "
                             f"{convert.__name__}") from None

    with _config_lock:
        retries, base_ms = _config["retries"], _config["base_ms"]
    if retries is None:
        retries = _env("LMR_STORE_RETRIES", int, DEFAULT_RETRIES)
    if base_ms is None:
        base_ms = _env("LMR_RETRY_BASE_MS", float, DEFAULT_BASE_MS)
    return {"retries": retries, "base_ms": base_ms}


def config_generation() -> int:
    with _config_lock:
        return _config["generation"]


def default_policy() -> RetryPolicy:
    s = retry_settings()
    return RetryPolicy(retries=int(s["retries"]), base_ms=s["base_ms"])


def utest() -> None:
    """Self-test: virtual-clock schedule, classification routing, the
    readback-verify hook, counters."""
    sleeps = []
    counters = FaultCounters()
    policy = RetryPolicy(retries=3, base_ms=10, cap_ms=50,
                         sleep=sleeps.append, clock=lambda: 0.0,
                         rng=random.Random(7), counters=counters)

    # transient burst shorter than the budget: absorbed
    calls = [0]

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise TimeoutError("blip")
        return "ok"

    assert policy.call(flaky, op="read_range", name="f") == "ok"
    assert calls[0] == 3 and len(sleeps) == 2
    assert all(0.01 <= s <= 0.05 for s in sleeps)
    assert counters.snapshot()["retries"] == 2

    # exhaustion wraps in TransientStoreError, chains the cause
    def always():
        raise ConnectionResetError("down")

    try:
        policy.call(always, op="lines", name="g")
    except TransientStoreError as e:
        assert e.attempts == 4 and e.op == "lines"
        assert isinstance(e.__cause__, ConnectionResetError)
    else:
        raise AssertionError("exhausted burst must raise")
    assert counters.snapshot()["retry_exhausted"] == 1

    # permanent and unclassified propagate raw, no sleeps
    n0 = len(sleeps)
    for exc in (FileNotFoundError("x"), ValueError("user")):
        def bad(exc=exc):
            raise exc
        try:
            policy.call(bad, op="size", name="h")
        except type(exc):
            pass
        else:
            raise AssertionError("must propagate raw")
    assert len(sleeps) == n0

    # before_retry resolving the ambiguity short-circuits the retry
    def ambiguous():
        raise TimeoutError("did it land?")

    assert policy.call(ambiguous, op="build", name="s",
                       before_retry=lambda e: True) is None
    assert len(sleeps) == n0

    # decorrelated jitter grows from base toward the cap
    p = RetryPolicy(base_ms=10, cap_ms=80, rng=random.Random(0))
    d = 0.0
    for _ in range(50):
        d = p.backoff_s(d)
        assert 0.01 <= d <= 0.08
    assert retry_settings()["retries"] >= 0
    configure_retry(7, 5.0)
    try:
        assert retry_settings() == {"retries": 7, "base_ms": 5.0}
    finally:
        configure_retry(None, None)
