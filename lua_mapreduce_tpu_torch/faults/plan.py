"""FaultPlan — deterministic, seeded fault schedules for chaos testing.

Copy of the JAX package's ``faults/plan.py`` (the torch package imports
nothing of the JAX package).

None of the robustness machinery is testable against luck: the chaos
suite needs to PROVOKE a 503 on exactly the third ranged read of one
spill file, on every run, on every machine. A :class:`FaultPlan` is that
schedule: the decision for an operation depends only on
``(seed, op, name, occurrence_index)`` — hashed, never drawn from a
shared RNG stream — so concurrent workers interleaving their ops cannot
perturb each other's schedules, and a re-executed job (whose occurrence
indices advance past the faulted ones) makes progress instead of
re-faulting forever.

Fault kinds (the failure modes the store/coord planes must survive):

- ``transient``          — raise :class:`InjectedFault` (retryable)
- ``permanent``          — raise :class:`InjectedPermanentFault`
- ``latency``            — sleep ``latency_ms`` before the op
- ``torn``               — build publishes a truncated file, then raises
                           transient (readback-verify must detect the
                           short object and rebuild)
- ``error_after_write``  — build lands COMPLETELY, then raises transient
                           (readback-verify must accept it and never
                           publish a duplicate)
- ``rpc_transient``      — transient faults on jobstore RPCs (claim /
                           commit / heartbeat / counts ...)
- ``blackout``           — every data-plane op on ONE placement tag
                           (engine/placement.py) fails transient for a
                           clock window: the whole-failure-domain shape
                           ("all replicas on one backend died") the
                           replicated shuffle must absorb (DESIGN §20).
                           Coded-stripe blocks and manifest copies
                           (faults/coded.py, DESIGN §27) route by the
                           tag embedded in their physical names — a
                           dark domain costs each stripe at most the
                           one block it placed there, exactly the shape
                           inline decode-from-survivors absorbs
- ``slow``               — every data-plane op by workers matching
                           ``slow_worker`` sleeps ``slow_ms`` for a
                           clock window: the DEGRADED-MACHINE shape
                           (thermal throttle, sick disk, noisy
                           neighbor) the speculative-execution layer
                           must absorb (DESIGN §21). A latency
                           multiplier in effect: an op that cost ε now
                           costs ε + slow_ms, every time, only for the
                           named worker — deterministic stragglers on
                           demand

``max_per_key`` bounds the faults charged to one ``(op, name)`` stream,
guaranteeing liveness under any retry budget (the blackout and slow
kinds are bounded by their WINDOW instead — a dark failure domain fails
every op and a sick machine slows every op, not a budgeted few). Plans
serialize to a compact ``k=v;k=v`` spec so subprocess fleets inherit
one through the ``LMR_FAULT_PLAN`` environment variable (parsed by the
router at store-wrap time). The ``slow`` kind needs to know WHICH
worker is executing: the worker runtime declares itself via
:func:`set_current_worker` (a thread-local — worker threads in one
process, one worker per process in subprocess fleets, both just work).
"""

from __future__ import annotations

import fnmatch
import hashlib
import threading
import time
from typing import Dict, Optional

_KINDS = ("transient", "permanent", "latency", "torn", "error_after_write",
          "rpc_transient")

# jobstore RPC op names (rate 'rpc_transient' applies; 'pattern' does not).
# put_task/delete_task/drop_ns are idempotent on replay (overwrite /
# tolerate-missing) — the server's inter-phase housekeeping must not
# abort a whole task over one store blip any more than scavenge may.
# speculate/cancel_spec are CASed idempotent (a replayed attempt reports
# False); claim_spec shares claim_batch's non-replayable exclusion from
# the retry layer (faults/wrappers.py).
RPC_OPS = frozenset({
    "get_task", "put_task", "update_task", "delete_task", "drop_ns",
    "claim_batch", "commit_batch", "release_batch", "heartbeat",
    "heartbeat_batch", "set_job_status", "set_job_times", "counts",
    "scavenge", "requeue_stale", "insert_error", "drain_errors",
    "speculate", "claim_spec", "cancel_spec",
})

# build-only kinds never apply to read ops and vice versa
_BUILD_KINDS = ("torn", "error_after_write")

# ops a BLACKOUT darkens: the per-file data plane. ``build`` is excluded
# (the injected-build shapes torn/error_after_write model publish
# failure precisely; a pre-op transient on build is indistinguishable
# from error_after_write=never — the kind-orthogonality rule below),
# and ``list`` addresses a pattern, not a file on a tag.
_BLACKOUT_OPS = frozenset({"lines", "read_range", "size", "exists",
                           "remove"})

# ops a SLOW worker pays its latency tax on: the whole data plane a job
# body touches — reads AND publishes AND listings (a sick machine is
# slow at everything; unlike blackout, no tag routing is involved, so
# list's pattern argument is as taxable as any name)
_SLOW_OPS = frozenset({"lines", "read_range", "size", "exists", "remove",
                       "build", "list"})

# which worker is executing on THIS thread — the slow kind's routing
# input. Worker.execute declares its name here (thread-local: in-process
# pools run one worker per thread; subprocess fleets one per process);
# server/executor threads never declare and are never slowed.
_current_worker = threading.local()


def set_current_worker(name: Optional[str]) -> None:
    """Declare (or with None, clear) the worker identity executing on
    this thread — consumed by the ``slow`` fault kind's per-worker
    schedule."""
    _current_worker.name = name


def current_worker() -> Optional[str]:
    return getattr(_current_worker, "name", None)


class FaultPlan:
    """Seeded deterministic fault schedule over store/coord operations."""

    def __init__(self, seed: int = 0, *,
                 transient: float = 0.0, permanent: float = 0.0,
                 latency: float = 0.0, torn: float = 0.0,
                 error_after_write: float = 0.0, rpc_transient: float = 0.0,
                 latency_ms: float = 2.0, pattern: str = "*",
                 max_per_key: int = 2,
                 blackout_tag: Optional[int] = None,
                 blackout_s: float = 0.0, blackout_from_s: float = 0.0,
                 slow_worker: Optional[str] = None, slow_ms: float = 0.0,
                 slow_s: float = 0.0, slow_from_s: float = 0.0,
                 sleep=time.sleep, clock=time.monotonic):
        self.seed = int(seed)
        self.rates: Dict[str, float] = {
            "transient": transient, "permanent": permanent,
            "latency": latency, "torn": torn,
            "error_after_write": error_after_write,
            "rpc_transient": rpc_transient,
        }
        self.latency_ms = float(latency_ms)
        self.pattern = pattern
        self.max_per_key = int(max_per_key)
        # blackout: placement tag ``blackout_tag`` is dark for the
        # window [blackout_from_s, blackout_from_s + blackout_s) on the
        # plan's clock, zeroed at the FIRST decide() call — injectable
        # clock keeps chaos suites deterministic and virtual-time fast
        self.blackout_tag = (None if blackout_tag is None
                             else int(blackout_tag))
        self.blackout_s = float(blackout_s)
        self.blackout_from_s = float(blackout_from_s)
        # slow: workers matching the ``slow_worker`` glob pay slow_ms of
        # latency on every data-plane op inside the window
        # [slow_from_s, slow_from_s + slow_s) — the deterministic
        # straggler (DESIGN §21). Shares the blackout clock zero.
        self.slow_worker = slow_worker or None
        self.slow_ms = float(slow_ms)
        self.slow_s = float(slow_s)
        self.slow_from_s = float(slow_from_s)
        self._clock = clock
        self._t0: Optional[float] = None
        self._sleep = sleep
        self._lock = threading.Lock()
        self._occ: Dict[tuple, int] = {}      # (op, name) -> occurrences
        self._charged: Dict[tuple, int] = {}  # (op, name) -> faults fired
        self.fired: Dict[str, int] = {}       # kind -> count (telemetry)

    # -- decision ----------------------------------------------------------

    def _uniform(self, op: str, name: str, k: int) -> float:
        h = hashlib.blake2b(f"{self.seed}:{op}:{name}:{k}".encode(),
                            digest_size=8).digest()
        return int.from_bytes(h, "little") / 2.0 ** 64

    def decide(self, op: str, name: str) -> Optional[str]:
        """The fault kind for THIS occurrence of ``(op, name)``, or None.

        Deterministic in (seed, op, name, occurrence index); the index
        advances per call under a lock, so each logical op stream sees
        its own reproducible schedule regardless of thread interleaving
        across different keys.
        """
        key = (op, name)
        is_rpc = op in RPC_OPS
        # one lock hold for check + decide + charge: a split
        # check-then-act would let two threads racing the same stream
        # both pass the cap check and overshoot max_per_key — the
        # liveness guarantee the chaos suites' zero-repetition
        # assertions lean on (cap < retry budget must stay true)
        with self._lock:
            k = self._occ[key] = self._occ.get(key, 0) + 1
            if not is_rpc and not self._matches(name):
                return None
            # blackout before the per-key cap: a dark failure domain
            # fails EVERY matched op on its tag for the window — never
            # rate-drawn, never charged to the cap (the window is the
            # liveness bound). It shares the pattern gate with every
            # other kind: the name family being darkened is the plan
            # author's scope knob.
            if self.blackout_tag is not None and op in _BLACKOUT_OPS:
                if self._t0 is None:
                    self._t0 = self._clock()
                t = self._clock() - self._t0
                if (self.blackout_from_s <= t
                        < self.blackout_from_s + self.blackout_s):
                    from lua_mapreduce_tpu_torch.engine.placement import \
                        tag_of
                    if tag_of(name) == self.blackout_tag:
                        self.fired["blackout"] = \
                            self.fired.get("blackout", 0) + 1
                        return "transient"
            # slow, like blackout, before the per-key cap: a sick
            # machine is slow at EVERY op for its window, never a
            # budgeted few — and never charged to the cap (latency is
            # not a fault the retry layer absorbs; liveness is the
            # window). Routed by the executing WORKER, not the name:
            # the thread-local identity the worker runtime declares.
            if self.slow_worker is not None and op in _SLOW_OPS:
                me = current_worker()
                if me is not None and fnmatch.fnmatchcase(
                        me, self.slow_worker):
                    if self._t0 is None:
                        self._t0 = self._clock()
                    t = self._clock() - self._t0
                    if (self.slow_from_s <= t
                            < self.slow_from_s + self.slow_s):
                        self.fired["slow"] = self.fired.get("slow", 0) + 1
                        return "slow"
            if self._charged.get(key, 0) >= self.max_per_key:
                return None
            u = self._uniform(op, name, k)
            acc = 0.0
            for kind in _KINDS:
                if is_rpc != (kind == "rpc_transient"):
                    continue
                if kind in _BUILD_KINDS and op != "build":
                    continue
                if not is_rpc and kind not in _BUILD_KINDS and op == "build":
                    # builds only tear / error-after-write / lag — a
                    # plain pre-op transient on build is
                    # indistinguishable from error_after_write=never,
                    # so keep the kinds orthogonal
                    if kind != "latency":
                        continue
                acc += self.rates[kind]
                if u < acc:
                    self._charged[key] = self._charged.get(key, 0) + 1
                    self.fired[kind] = self.fired.get(kind, 0) + 1
                    return kind
        return None

    def _matches(self, name: str) -> bool:
        """``pattern`` is ``|``-alternated globs — chaos schedules
        addressing several name families (raw runs AND spills, say)
        need one plan, not one per family."""
        return any(fnmatch.fnmatchcase(name, p)
                   for p in self.pattern.split("|"))

    def apply_latency(self) -> None:
        if self.latency_ms > 0:
            self._sleep(self.latency_ms / 1000.0)

    def apply_slow(self) -> None:
        """The slow kind's per-op latency tax (separate knob from
        latency_ms — a plan can mix background jitter with one
        deterministic straggler)."""
        if self.slow_ms > 0:
            self._sleep(self.slow_ms / 1000.0)

    def total_fired(self) -> int:
        with self._lock:
            return sum(self.fired.values())

    # -- spec round-trip (subprocess inheritance) --------------------------

    def to_spec(self) -> str:
        parts = [f"seed={self.seed}"]
        parts += [f"{k}={v:g}" for k, v in self.rates.items() if v > 0]
        if self.latency_ms != 2.0:
            parts.append(f"latency_ms={self.latency_ms:g}")
        if self.pattern != "*":
            parts.append(f"pattern={self.pattern}")
        if self.max_per_key != 2:
            parts.append(f"max_per_key={self.max_per_key}")
        if self.blackout_tag is not None:
            parts.append(f"blackout_tag={self.blackout_tag}")
            parts.append(f"blackout_s={self.blackout_s:g}")
            if self.blackout_from_s:
                parts.append(f"blackout_from_s={self.blackout_from_s:g}")
        if self.slow_worker is not None:
            parts.append(f"slow_worker={self.slow_worker}")
            parts.append(f"slow_ms={self.slow_ms:g}")
            parts.append(f"slow_s={self.slow_s:g}")
            if self.slow_from_s:
                parts.append(f"slow_from_s={self.slow_from_s:g}")
        return ";".join(parts)

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        """Parse ``seed=7;transient=0.05;latency=0.02;pattern=*.SPILL-*``.
        Unknown keys are rejected loudly — a typo in a chaos-test spec
        must not silently run fault-free."""
        kw: Dict[str, object] = {}
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            k, sep, v = part.partition("=")
            if not sep:
                raise ValueError(f"bad fault-plan entry {part!r}")
            k = k.strip()
            if k in ("pattern", "slow_worker"):
                kw[k] = v.strip()
            elif k in ("seed", "max_per_key", "blackout_tag"):
                kw[k] = int(v)
            elif k in _KINDS or k in ("latency_ms", "blackout_s",
                                      "blackout_from_s", "slow_ms",
                                      "slow_s", "slow_from_s"):
                kw[k] = float(v)
            else:
                raise ValueError(f"unknown fault-plan key {k!r}")
        seed = int(kw.pop("seed", 0))
        return cls(seed, **kw)  # type: ignore[arg-type]
