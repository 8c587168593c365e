"""Self-tuning feedback controller (lmr-autotune).

Port of ``lua_mapreduce_tpu/sched/controller.py`` (DESIGN §29).

Every performance knob this codebase grew — batch-lease size (§16),
push-buffer budget (§24), the straggler factor (§21), the retry
backoff base (§19), the fleet size itself — shipped as a hand-set
default plus an env var. This module closes the loop: a small
deterministic controller rides the Server's housekeeping cadence (and
the LocalExecutor's per-iteration mirror), consumes the same live
signal streams the operator would read (FaultCounters deltas,
round-count deltas, the task doc's fleet duration EWMA, queue depths),
and adapts the knobs it owns through the EXISTING task-doc negotiation
— the controller writes the doc, the fleet follows the doc, exactly
like a human retuning a deployment mid-run, only every tick.

Design rules (the stability argument, DESIGN §29):

- **Hysteresis bands.** Every knob has a raise threshold and a lower
  threshold separated by a wide dead band; a metric wandering inside
  the band changes nothing. Thresholds are on RATIOS (claim overhead
  over body time, wasted seconds over useful seconds), so they need no
  per-deployment calibration.
- **Per-knob cooldowns.** After a change, a knob is frozen for
  ``cooldown_s`` — at the housekeeping cadence one decision's effect
  (a doc write the fleet follows on its next poll) must be observable
  before the next decision, or the controller chases its own wake.
- **Flip lockout.** A knob may keep moving in one direction, but once
  it has REVERSED direction it may not reverse again until
  ``flip_reset_s`` of quiet — this is what makes "no knob changes
  direction more than once across a chaos window" a structural
  guarantee instead of a tuning accident.
- **Explainable decisions.** Every applied change emits an
  ``autotune.<knob>`` trace span carrying the evidence: the observed
  metric, the threshold that tripped, and old→new. Suppressed changes
  (cooldown / flip lockout) are counted (``autotune_vetoes``), so the
  stats stream shows restraint as well as action.
- **Semantics-neutral.** The controller only touches perf knobs whose
  every legal value is byte-identical on output (batch_k, push budget,
  speculation factor, retry base, fleet size); it never touches the
  crash-consistency knobs (pipeline/push/replication/coding/engine).

The elastic half writes a ``fleet_target`` onto the task doc and calls
an optional owner-provided hook; ``FleetSupervisor`` (below) is the
hook for thread/subprocess fleets — it grows the pool toward the
target and retires surplus members GRACEFULLY (a retiring worker stops
claiming after its current lease commits, so no lease is ever lost to
a scale-down; analysis/protocol.py enumerates exactly this edge).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence


def resolve_autotune(arg) -> bool:
    """The autotune knob's shared resolution order: explicit argument,
    else ``LMR_AUTOTUNE`` env, else off."""
    if arg is None:
        import os
        raw = (os.environ.get("LMR_AUTOTUNE") or "").strip().lower()
        return raw in ("1", "true", "yes", "on")
    return bool(arg)


# The knobs the controller owns once autotune is on, and how each is
# applied. This registry is what the docs' knob table, the LMR018 lint
# rule, and the worker-side doc-follow gate all reference — ONE list,
# so "controller-owned" cannot drift between the layers.
#   batch_k        — task doc (workers already follow doc batch_k)
#   push_budget_mb — task doc (workers follow it under the autotune
#                    marker; re-budgets live BufferPools in place)
#   speculation    — task doc (workers already follow doc speculation)
#   retry_base_ms  — configure_retry() locally + task doc (workers
#                    apply it under the autotune marker)
#   fleet          — fleet_target on the task doc + the owner's hook
CONTROLLER_KNOBS = ("batch_k", "push_budget_mb", "speculation",
                    "retry_base_ms", "fleet")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One applied knob change and its evidence — the span payload."""
    knob: str
    metric: str
    observed: float
    threshold: float
    old: float
    new: float

    @property
    def direction(self) -> int:
        return 1 if self.new > self.old else -1


@dataclasses.dataclass
class Observation:
    """One control window's signals, gathered by the owner (Server
    housekeeping pass / LocalExecutor iteration end). Counter fields
    are DELTAS over the window; ``None`` means the signal is not
    available in this owner (its knobs simply hold)."""
    t: float
    body_ewma_s: Optional[float] = None   # fleet job-body duration EWMA
    rpc_p99_s: Optional[float] = None     # coord round-trip p99 (claim
    #                                       overhead proxy, same store)
    jobs_done: int = 0
    claim_rounds: int = 0
    push_frames: int = 0
    push_evictions: int = 0
    spec_launched: int = 0
    spec_wins: int = 0
    spec_wasted_s: float = 0.0
    store_retries: int = 0
    waiting: int = 0                      # claimable backlog (jobs)
    running: int = 0
    fleet: Optional[int] = None           # current worker count


@dataclasses.dataclass
class AutotuneConfig:
    """Bands, cooldowns, and bounds. Defaults are deliberately
    conservative (wide dead bands, halving/doubling steps); tests and
    benches override cooldowns to match their compressed clocks."""
    cooldown_s: float = 2.0
    flip_reset_s: float = 60.0
    # batch_k: claim round-trip p99 over body EWMA. Above the raise
    # band the control plane dominates tiny jobs → double k; below the
    # lower band jobs are long enough that wide leases only hurt
    # stealability → halve back toward 1. The [0.1, 1.0] dead band is
    # 10x wide.
    batch_ratio_hi: float = 1.0
    batch_ratio_lo: float = 0.1
    batch_k_max: int = 64
    # push budget: evictions per window. Any sustained eviction burst
    # grows the pool ×1.5; ``shrink_after`` consecutive eviction-free
    # windows decay it ×0.75 back toward the configured floor.
    evict_burst: int = 4
    shrink_after: int = 5
    push_budget_max_mb: float = 512.0
    # speculation factor: wasted duplicate seconds over useful job
    # seconds. Above the band the detector clones too eagerly → raise
    # the factor (clone later); a near-zero waste WITH wins → lower it
    # toward ``speculation_min`` (cloning earlier is paying off).
    waste_frac_hi: float = 0.5
    waste_frac_lo: float = 0.05
    speculation_min: float = 1.5
    speculation_max: float = 6.0
    # retry backoff base: transient faults per second. A dense fault
    # burst doubles the base (back off harder, stop hammering a
    # browning-out store); ``shrink_after`` quiet windows halve it
    # back toward the configured floor.
    fault_rate_hi: float = 2.0
    retry_base_max_ms: float = 400.0
    # elastic fleet: target draining the claimable backlog within
    # ``drain_target_s``. Scale up only when the projected drain time
    # exceeds 1.5x the target (hysteresis); retire to baseline after
    # ``shrink_after`` consecutive empty-queue windows.
    drain_target_s: float = 10.0
    fleet_max: int = 8


class _Knob:
    """Per-knob change gate: cooldown + flip lockout + change log."""

    def __init__(self, name: str, value: float, cooldown_s: float,
                 flip_reset_s: float):
        self.name = name
        self.value = value
        self.cooldown_s = cooldown_s
        self.flip_reset_s = flip_reset_s
        self.changed_at: Optional[float] = None
        self.last_dir = 0
        self.flipped = False          # reversed direction once already

    def gate(self, now: float, direction: int) -> Optional[str]:
        """None = the change may proceed; else the veto reason."""
        if self.changed_at is not None:
            if now - self.changed_at < self.cooldown_s:
                return "cooldown"
            if now - self.changed_at >= self.flip_reset_s:
                # a long quiet period re-arms the flip budget: the
                # regime that caused the reversal is long gone
                self.flipped = False
        if self.last_dir and direction != self.last_dir:
            if self.flipped:
                return "flip-lockout"
        return None

    def commit(self, now: float, new: float, direction: int) -> None:
        if self.last_dir and direction != self.last_dir:
            self.flipped = True
        self.last_dir = direction
        self.changed_at = now
        self.value = new


class AutotuneController:
    """The decision core. Owns per-knob state and the evidence plumbing
    (spans + counters); the OWNER gathers the :class:`Observation` and
    applies the returned :class:`Decision` list through its own
    mechanisms (task-doc writes, ``configure_retry``, pool resize,
    fleet hook). Knobs whose initial value is ``None`` are disabled —
    an owner with no push pool never tunes the push budget."""

    def __init__(self, *, batch_k: Optional[int] = None,
                 push_budget_mb: Optional[float] = None,
                 speculation: Optional[float] = None,
                 retry_base_ms: Optional[float] = None,
                 fleet: Optional[int] = None,
                 fleet_max: Optional[int] = None,
                 config: Optional[AutotuneConfig] = None,
                 clock: Callable[[], float] = time.time):
        self.cfg = config or AutotuneConfig()
        self.clock = clock
        cd, fr = self.cfg.cooldown_s, self.cfg.flip_reset_s
        self._knobs: Dict[str, _Knob] = {}
        if batch_k is not None:
            self._knobs["batch_k"] = _Knob("batch_k", int(batch_k), cd, fr)
        if push_budget_mb is not None:
            self._push_floor = float(push_budget_mb)
            self._knobs["push_budget_mb"] = _Knob(
                "push_budget_mb", float(push_budget_mb), cd, fr)
        if speculation is not None and speculation > 0:
            self._knobs["speculation"] = _Knob(
                "speculation", float(speculation), cd, fr)
        if retry_base_ms is not None:
            self._retry_floor = float(retry_base_ms)
            self._knobs["retry_base_ms"] = _Knob(
                "retry_base_ms", float(retry_base_ms), cd, fr)
        if fleet is not None:
            self._fleet_floor = int(fleet)
            if fleet_max is not None:
                self.cfg = dataclasses.replace(self.cfg,
                                               fleet_max=int(fleet_max))
            self._knobs["fleet"] = _Knob("fleet", int(fleet), cd, fr)
        self._rpc_samples: deque = deque(maxlen=128)
        self._quiet_evict = 0
        self._quiet_fault = 0
        self._quiet_queue = 0
        self.decisions: List[Decision] = []    # full history, evidence

    # -- signal helpers -----------------------------------------------------

    def note_rpc(self, seconds: float) -> None:
        """Feed one coordination round-trip latency sample (the owner
        times its own store RPCs — same store, same path as claims, so
        the rolling p99 is an honest claim-overhead proxy without
        requiring tracing to be on)."""
        if seconds >= 0:
            self._rpc_samples.append(seconds)

    def rpc_p99(self) -> Optional[float]:
        if not self._rpc_samples:
            return None
        from lua_mapreduce_tpu_torch.trace.collect import percentile
        return percentile(list(self._rpc_samples), 99.0)

    def value(self, knob: str) -> Optional[float]:
        k = self._knobs.get(knob)
        return None if k is None else k.value

    # -- the tick -----------------------------------------------------------

    def tick(self, obs: Observation) -> List[Decision]:
        """Evaluate every owned knob against this window's evidence;
        returns the APPLIED decisions (already committed to knob state,
        already traced and counted — the owner's job is the mechanical
        apply)."""
        out: List[Decision] = []
        for fn in (self._tick_batch_k, self._tick_push_budget,
                   self._tick_speculation, self._tick_retry_base,
                   self._tick_fleet):
            d = fn(obs)
            if d is not None:
                out.append(d)
        if out:
            self.decisions.extend(out)
            self._emit(out)
        return out

    def _propose(self, knob: str, new: float, metric: str,
                 observed: float, threshold: float) -> Optional[Decision]:
        k = self._knobs[knob]
        if new == k.value:
            return None
        direction = 1 if new > k.value else -1
        veto = k.gate(self.clock(), direction)
        if veto is not None:
            from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
            COUNTERS.bump("autotune_vetoes")
            return None
        d = Decision(knob=knob, metric=metric, observed=observed,
                     threshold=threshold, old=k.value, new=new)
        k.commit(self.clock(), new, direction)
        return d

    def _tick_batch_k(self, obs: Observation) -> Optional[Decision]:
        k = self._knobs.get("batch_k")
        p99, body = obs.rpc_p99_s, obs.body_ewma_s
        if k is None or not p99 or not body or body <= 0:
            return None
        ratio = p99 / body
        cur = int(k.value)
        if ratio > self.cfg.batch_ratio_hi and cur < self.cfg.batch_k_max:
            return self._propose(
                "batch_k", min(self.cfg.batch_k_max, cur * 2),
                "claim_p99_over_body_ewma", ratio, self.cfg.batch_ratio_hi)
        if ratio < self.cfg.batch_ratio_lo and cur > 1:
            return self._propose(
                "batch_k", max(1, cur // 2),
                "claim_p99_over_body_ewma", ratio, self.cfg.batch_ratio_lo)
        return None

    def _tick_push_budget(self, obs: Observation) -> Optional[Decision]:
        k = self._knobs.get("push_budget_mb")
        if k is None:
            return None
        if obs.push_evictions >= self.cfg.evict_burst:
            self._quiet_evict = 0
            if k.value < self.cfg.push_budget_max_mb:
                return self._propose(
                    "push_budget_mb",
                    min(self.cfg.push_budget_max_mb,
                        round(k.value * 1.5, 3)),
                    "evictions_per_window", float(obs.push_evictions),
                    float(self.cfg.evict_burst))
            return None
        if obs.push_evictions == 0 and obs.push_frames > 0:
            self._quiet_evict += 1
            if self._quiet_evict >= self.cfg.shrink_after \
                    and k.value > self._push_floor:
                self._quiet_evict = 0
                return self._propose(
                    "push_budget_mb",
                    max(self._push_floor, round(k.value * 0.75, 3)),
                    "eviction_free_windows", float(self.cfg.shrink_after),
                    float(self.cfg.shrink_after))
        return None

    def _tick_speculation(self, obs: Observation) -> Optional[Decision]:
        k = self._knobs.get("speculation")
        if k is None or obs.spec_launched <= 0:
            return None
        body = obs.body_ewma_s or 0.0
        useful = max(obs.jobs_done, 1) * max(body, 1e-9)
        frac = obs.spec_wasted_s / (useful + obs.spec_wasted_s) \
            if obs.spec_wasted_s > 0 else 0.0
        if frac > self.cfg.waste_frac_hi \
                and k.value < self.cfg.speculation_max:
            return self._propose(
                "speculation",
                min(self.cfg.speculation_max, round(k.value * 1.25, 3)),
                "wasted_work_fraction", frac, self.cfg.waste_frac_hi)
        if frac < self.cfg.waste_frac_lo and obs.spec_wins > 0 \
                and k.value > self.cfg.speculation_min:
            return self._propose(
                "speculation",
                max(self.cfg.speculation_min, round(k.value * 0.8, 3)),
                "wasted_work_fraction", frac, self.cfg.waste_frac_lo)
        return None

    def _tick_retry_base(self, obs: Observation) -> Optional[Decision]:
        k = self._knobs.get("retry_base_ms")
        if k is None:
            return None
        window = max(self.cfg.cooldown_s, 1e-3)
        rate = obs.store_retries / window
        if rate > self.cfg.fault_rate_hi:
            self._quiet_fault = 0
            if k.value < self.cfg.retry_base_max_ms:
                return self._propose(
                    "retry_base_ms",
                    min(self.cfg.retry_base_max_ms, round(k.value * 2, 3)),
                    "transient_faults_per_s", rate, self.cfg.fault_rate_hi)
            return None
        if obs.store_retries == 0:
            self._quiet_fault += 1
            if self._quiet_fault >= self.cfg.shrink_after \
                    and k.value > self._retry_floor:
                self._quiet_fault = 0
                return self._propose(
                    "retry_base_ms",
                    max(self._retry_floor, round(k.value / 2, 3)),
                    "fault_free_windows", float(self.cfg.shrink_after),
                    float(self.cfg.shrink_after))
        return None

    def _tick_fleet(self, obs: Observation) -> Optional[Decision]:
        k = self._knobs.get("fleet")
        if k is None:
            return None
        fleet = obs.fleet if obs.fleet is not None else int(k.value)
        body = obs.body_ewma_s
        if obs.waiting > 0 and body and body > 0 and fleet > 0:
            self._quiet_queue = 0
            drain_s = obs.waiting * body / fleet
            if drain_s > 1.5 * self.cfg.drain_target_s:
                desired = min(
                    self.cfg.fleet_max,
                    max(fleet + 1,
                        math.ceil(obs.waiting * body
                                  / self.cfg.drain_target_s)))
                if desired > k.value:
                    return self._propose(
                        "fleet", desired, "backlog_drain_s", drain_s,
                        1.5 * self.cfg.drain_target_s)
            return None
        if obs.waiting == 0:
            self._quiet_queue += 1
            if self._quiet_queue >= self.cfg.shrink_after \
                    and k.value > self._fleet_floor:
                self._quiet_queue = 0
                return self._propose(
                    "fleet", self._fleet_floor, "empty_queue_windows",
                    float(self.cfg.shrink_after),
                    float(self.cfg.shrink_after))
        return None

    # -- evidence -----------------------------------------------------------

    def _emit(self, decisions: Sequence[Decision]) -> None:
        """Every applied decision is explainable after the fact: an
        ``autotune.<knob>`` span carrying the metric, the threshold
        that tripped, and old→new; plus the fold-able counters."""
        from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
        from lua_mapreduce_tpu_torch.trace.span import active_tracer
        tracer = active_tracer()
        for d in decisions:
            COUNTERS.bump("autotune_decisions")
            if d.knob == "fleet":
                COUNTERS.bump("autotune_scale_events")
            if tracer is not None:
                now = tracer.clock()
                tracer.add(f"autotune.{d.knob}", now, now,
                           metric=d.metric,
                           observed=round(float(d.observed), 6),
                           threshold=round(float(d.threshold), 6),
                           old=d.old, new=d.new,
                           direction=d.direction)


class FleetSupervisor:
    """The elastic hook for thread/subprocess fleets: keep ``spawn``-ed
    members matched to the controller's target, never above ``cap``.

    Scale-up spawns; scale-down retires GRACEFULLY: ``retire(member)``
    must make the member stop claiming new leases and exit after its
    in-flight lease commits (the thread fleet sets ``max_jobs`` to the
    jobs already executed — Worker's bounded-lifetime check fires after
    the current poll completes, so no lease is abandoned; subprocess
    fleets simply stop respawning bounded-lifetime members). The
    no-lease-lost-across-retire property is the ``retire`` edge the
    protocol checker enumerates (analysis/protocol.py, elastic=True)."""

    def __init__(self, spawn: Callable[[int], object],
                 retire: Callable[[object], None],
                 baseline: int, cap: int):
        if baseline < 1 or cap < baseline:
            raise ValueError("need 1 <= baseline <= cap")
        self.spawn = spawn
        self.retire = retire
        self.baseline = baseline
        self.cap = cap
        self.members: List[object] = []
        self._seq = 0
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        with self._lock:
            return len(self.members)

    def ensure_baseline(self) -> int:
        return self.resize(self.baseline)

    def resize(self, target: int) -> int:
        """Grow/shrink toward ``target`` (clamped to [baseline, cap]);
        returns the new size. Shrinks retire the NEWEST members first —
        the baseline crew keeps its warm caches and its affinity map.

        ``spawn``/``retire`` are caller-injected and may block (mint a
        thread, fork a process, RPC a scheduler) or re-enter this
        supervisor — so both run OUTSIDE the lock: each growth step
        reserves its seq under the lock, spawns unlocked, then appends
        under the lock. Concurrent resizers interleave safely: the
        re-check per iteration keeps the fleet at the LAST target, and
        a member is either in ``members`` or still owned by its
        spawning frame — never both, never neither."""
        target = max(self.baseline, min(self.cap, int(target)))
        while True:
            with self._lock:
                if len(self.members) >= target:
                    break
                seq = self._seq
                self._seq += 1
            m = self.spawn(seq)
            with self._lock:
                self.members.append(m)
        surplus = []
        with self._lock:
            while len(self.members) > target:
                surplus.append(self.members.pop())
        for m in surplus:
            self.retire(m)
        return self.size


def tenant_fleet_cap(tenants, baseline: int, hard_max: int) -> int:
    """The admission-quota bound on elastic growth: with per-tenant
    ``max_pending`` quotas (sched/tenancy.py) the claimable backlog can
    never exceed the quota sum, so workers beyond baseline + that sum
    could not all find work — the cap keeps a tenant flood from scaling
    the fleet past what admission control will ever feed it."""
    if not tenants:
        return hard_max
    quota = sum(int(t.max_pending) for t in tenants)
    return max(baseline, min(hard_max, baseline + quota))


def utest() -> None:
    """Self-test: band/cooldown/flip behavior on a virtual clock."""
    now = [0.0]
    cfg = AutotuneConfig(cooldown_s=1.0, flip_reset_s=100.0,
                         shrink_after=2)
    c = AutotuneController(batch_k=1, push_budget_mb=8.0, speculation=2.0,
                           retry_base_ms=25.0, fleet=2, fleet_max=6,
                           config=cfg, clock=lambda: now[0])

    def obs(**kw):
        kw.setdefault("t", now[0])
        return Observation(**kw)

    # claim overhead dominates tiny jobs: batch_k doubles...
    c.note_rpc(0.05)
    d = c.tick(obs(body_ewma_s=0.01, rpc_p99_s=0.05, jobs_done=10))
    assert [x.knob for x in d] == ["batch_k"] and c.value("batch_k") == 2
    # ...but not again inside the cooldown
    now[0] += 0.5
    assert c.tick(obs(body_ewma_s=0.01, rpc_p99_s=0.05)) == []
    now[0] += 1.0
    assert c.value("batch_k") == 2
    d = c.tick(obs(body_ewma_s=0.01, rpc_p99_s=0.05))
    assert c.value("batch_k") == 4
    # dead band: nothing moves
    now[0] += 2.0
    assert c.tick(obs(body_ewma_s=0.1, rpc_p99_s=0.05)) == []
    # reversal (long jobs): allowed once...
    now[0] += 2.0
    d = c.tick(obs(body_ewma_s=10.0, rpc_p99_s=0.05))
    assert c.value("batch_k") == 2
    # ...a second reversal (up again) is flip-locked
    now[0] += 2.0
    assert c.tick(obs(body_ewma_s=0.01, rpc_p99_s=0.05)) == []
    # same direction still fine
    now[0] += 2.0
    c.tick(obs(body_ewma_s=10.0, rpc_p99_s=0.05))
    assert c.value("batch_k") == 1

    # push budget grows on an eviction burst, decays after quiet windows
    now[0] += 10.0
    d = c.tick(obs(push_evictions=8, push_frames=8))
    assert c.value("push_budget_mb") == 12.0
    now[0] += 2.0
    c.tick(obs(push_frames=4))
    now[0] += 2.0
    c.tick(obs(push_frames=4))
    assert c.value("push_budget_mb") == 9.0       # one flip, allowed
    # speculation: heavy waste raises the factor
    now[0] += 2.0
    d = c.tick(obs(body_ewma_s=0.1, jobs_done=4, spec_launched=4,
                   spec_wasted_s=5.0))
    assert c.value("speculation") == 2.5
    # retry base doubles under a fault storm
    now[0] += 2.0
    d = c.tick(obs(store_retries=50))
    assert c.value("retry_base_ms") == 50.0
    # fleet scales up under backlog, retires to baseline when drained
    now[0] += 2.0
    d = c.tick(obs(body_ewma_s=5.0, waiting=20, running=2, fleet=2))
    assert c.value("fleet") == 6                   # capped at fleet_max
    now[0] += 2.0
    c.tick(obs(waiting=0, fleet=6))
    now[0] += 2.0
    c.tick(obs(waiting=0, fleet=6))
    assert c.value("fleet") == 2

    # the supervisor: graceful resize with newest-first retirement
    spawned, retired = [], []
    sup = FleetSupervisor(lambda i: f"w{i}", retired.append,
                          baseline=2, cap=4)
    sup.ensure_baseline()
    assert sup.size == 2
    sup.resize(10)
    assert sup.size == 4 and not retired
    sup.resize(1)                                  # clamped to baseline
    assert sup.size == 2 and retired == ["w3", "w2"]

    # tenant quota cap
    class _T:
        def __init__(self, mp):
            self.max_pending = mp
    assert tenant_fleet_cap([_T(2), _T(3)], baseline=2, hard_max=32) == 7
    assert tenant_fleet_cap([], baseline=2, hard_max=32) == 32
    assert tenant_fleet_cap([_T(100)], baseline=2, hard_max=8) == 8

    assert resolve_autotune(True) and not resolve_autotune(False)
    print("sched/controller utest ok")
