"""Exhaustive small-scope model checker for the lease protocol.

The JobStore claim/commit/release/heartbeat/requeue/scavenge machine is
the one part of the system whose correctness cannot be established by
running it: the dangerous behaviors are interleavings, and the SIGKILL
churn suites only sample them.  This module extracts that protocol into
an explicit transition system and enumerates EVERY interleaving of a
small configuration (2-3 workers × 2-4 jobs), checking safety
invariants in each reached state:

- **legal transitions** — every per-job status edge is one the protocol
  defines (WAITING→RUNNING, RUNNING→{FINISHED,BROKEN,WAITING},
  FINISHED→{WRITTEN,BROKEN}, BROKEN→{RUNNING,FAILED,BROKEN}; WRITTEN
  and FAILED are terminal);
- **repetitions monotone** — a retry counter never decreases;
- **no double commit** — at most one successful commit per job, ever;
- **commit ownership** — a commit lands only for the worker that holds
  the job's CURRENT claim (the CAS the protocol relies on);
- **no lost or stuck job** — in every quiescent state with a live
  worker, every job is WRITTEN or FAILED (in particular: never parked
  FINISHED+unclaimed, the kill-between-FINISHED-and-WRITTEN gap).

Time is a deterministic VIRTUAL CLOCK: every lease carries an age that
a global ``tick`` transition advances; at ``stale_age`` the lease is
eligible for the scavenger's requeue, and a heartbeat resets it.  This
makes "the worker went silent" an explicit, enumerable event instead of
a sleep in a stress test.

The model mirrors the shipped protocol operation-for-operation:
``claim_batch`` (one atomic pass, lowest ids first, exactly like both
index engines), the default two-step per-job commit
(RUNNING→FINISHED→WRITTEN CASed on ownership, engine/jobstore.py
``commit_batch``), the failure path (commit done prefix, release the
unstarted tail without a repetition bump, mark the failing job BROKEN),
batched heartbeats (live only while job bodies run — the worker's beat
thread stops before the success-path commit but covers the
failure-path one, mirroring Worker._execute_batch), stale requeue
(RUNNING|FINISHED), scavenge (BROKEN with reps ≥ max_retries → FAILED),
and worker death at ANY step.

On a violation the checker returns the shortest trace (BFS), and
:func:`replay_trace` replays it against a real ``MemJobStore`` /
``FileJobStore``: a trace from the correct model reproduces
step-for-step and lands in the same final state; a trace from a seeded
bug model DIVERGES at the exact store operation whose CAS closes the
race — which is the confirmation that the real protocol is guarded
where the model says it must be.

**Replica-aware recovery (DESIGN §20).** With
``ModelConfig(data_loss_budget=N)`` each job record carries the state
of its published output's replica set (intact / under-replicated /
every-copy-lost; environment loss events are budget-bounded so the
space stays finite), and the scavenger gains the reconstruct-vs-requeue
edge: ``repair`` heals an under-replicated output WITHOUT touching job
state, and ``rerun_requeue`` CASes a WRITTEN producer whose output is
wholly lost back to WAITING — the one legal WRITTEN→WAITING edge, it
must charge NO repetition (the loss is not the job's fault) and it
opens a new commit generation (the re-run's commit is not a double
commit). Two new invariants ride the existing set: the no-stranded-data
rule (quiescent with a live worker ⇒ no WRITTEN job whose output is
wholly lost — the reduce phase would wedge on it) and the
zero-charge rule on the requeue edge itself.

**Speculative execution (DESIGN §21).** With
``ModelConfig(allow_spec=True)`` each job record carries its
duplicate-lease state (none / OPEN / taken-by-worker-w) and the system
gains the speculation edges, op-for-op with the shipped protocol: the
detector's ``speculate`` (RUNNING ∧ no-speculation → OPEN — a pure
marker, no status or repetition change), an idle worker's
``claim_spec`` (OPEN → taken, never the job's own claimant, lowest id
first — the same scan order as both index engines), the clone's body +
two-step commit racing the original's (ownership satisfied by EITHER
the claimant or the shadow holder; the status CAS arbitrates
first-commit-wins, so the loser's commit fails and degrades to
``spec_cancel`` — a pure shadow-lease dissolution), the clone's
revocation/failure edge (``spec_cancel`` from any clone stage), and
shadow-lease dissolution on every unlease transition (release,
requeue, mark-broken — a re-claimed job must never be committable by a
stale clone). The full invariant set rides along unchanged; the ones
speculation exists to threaten — no-double-commit and
reps-monotone — are checked on every interleaving of original vs
clone commit, death at any step included.

**Elastic join/leave (DESIGN §29).** With ``ModelConfig(elastic=True)``
the pool itself becomes part of the state: the last worker starts
ABSENT (not yet spawned — the controller's scale-up capacity) and may
``join`` at any step, and any IDLE worker may ``retire`` (the
controller's scale-down) into a terminal GONE mode. Both edges must be
state-transparent on every job, and retire carries the
no-lease-abandoned invariant: a worker may leave only while it owns no
RUNNING/FINISHED lease — exactly the graceful-retire contract
``FleetSupervisor`` implements by bounding a member's lifetime so it
exits AFTER its current lease commits. The seeded bug
(``elastic_retire_holds_lease``) lets a mid-lease worker retire — the
scale-down that strands its leased jobs until the scavenger requeues
them with an undeserved repetition charge — and the checker re-finds
it as a direct invariant hit on the retire step.

Seedable bugs (``ModelConfig(bug=...)``):

- ``"commit_skips_owner_cas"`` — commit checks status but not
  ownership: the historical commit-racing-scavenger-requeue race (a
  stale worker retires a job the scavenger already handed to someone
  else);
- ``"requeue_ignores_finished"`` — the scavenger skips FINISHED
  leases: a worker killed between its FINISHED and WRITTEN transitions
  wedges the barrier forever;
- ``"scavenge_skips_lost_data"`` — the scavenger repairs
  under-replicated outputs but never requeues wholly-lost ones: the
  reduce phase waits forever on data nobody will regenerate
  (requires ``data_loss_budget > 0``);
- ``"lost_requeue_skips_written_cas"`` — the lost-data requeue fires
  without the expect=(WRITTEN,) status CAS: it can yank a job another
  worker is mid-commit on (the real ``Server._requeue_maps`` carries
  exactly that CAS; requires ``data_loss_budget > 0``);
- ``"spec_commit_skips_winner_cas"`` — the loser's commit skips the
  winner's status CAS: a clone (or original) that lost the
  first-commit-wins race lands its commit anyway — the double-commit /
  illegal-WRITTEN-edge shape the one-transition arbitration exists to
  prevent (requires ``allow_spec=True``);
- ``"lost_wakeup_no_fallback"`` — a sleeping worker wakes ONLY on
  notification, with no timeout fallback: one lost notification
  (the budget-bounded ``lose_notify`` environment event) parks the
  worker forever and claimable jobs strand — the hang the Waiter's
  degradation ladder exists to prevent (requires
  ``allow_notify=True``);
- ``"coded_decode_lost_stripe"`` — the scavenger's repair rung decodes
  stripes with fewer than k surviving blocks: data is conjured from
  nothing, masking a loss the producer must regenerate (requires
  ``coded=True`` and ``data_loss_budget ≥ 1``);
- ``"coded_requeue_skips_decode"`` — the scavenger treats ANY block
  loss as total loss (never tries the decode rung) AND trusts its own
  stale classification, firing the producer requeue without the
  expect=(WRITTEN,) status CAS: it yanks jobs mid-commit exactly like
  the replica-plane CAS bug, but now on stripes that were perfectly
  decodable (requires ``coded=True`` and ``data_loss_budget ≥ 1``);
- ``"double_leader"`` — a standby's acquire overwrites a LIVE lease
  without the version CAS, reusing the stored epoch: two coordinators
  hold overlapping validity windows and both pass the fence — the
  split-brain shape the CAS + epoch bump exist to prevent (requires
  ``ha=True``);
- ``"zombie_leader_write"`` — a deposed leader's mutation skips the
  fencing guard: the stale write lands after a takeover bumped the
  epoch — the corruption ``FencedJobStore`` turns into a permanent
  ``StaleLeaderError`` (requires ``ha=True``).

**Watch/notify wakeups (DESIGN §23).** With
``ModelConfig(allow_notify=True)`` each worker may go to SLEEP when its
poll finds nothing claimable (arming the Waiter), and the state carries
one pending-wakeup bit per worker: every claimable-work producer —
release, stale requeue, mark-broken, the detector's speculate, the
lost-data requeue — broadcasts the bits (the real channels are a bus),
a sleeping worker consumes its bit via ``notify_wake``, ``timeout_wake``
is always enabled (the poll fallback), and the budget-bounded
``lose_notify`` adversary clears a pending bit — the lost-notification
event. Three properties ride the existing invariant set: sleep/wake
edges are state-transparent on every job (a stale or duplicate wakeup
is a no-op by construction), the full lifecycle invariants survive
every sleep/wake interleaving, and in the correct model no quiescent
state strands a claimable job on a sleeping worker — delete the
timeout fallback (the seeded bug) and exactly that hang is re-found.

**Erasure-coded recovery (DESIGN §27).** With ``ModelConfig(coded=True)``
the data plane models a k+m stripe instead of r whole copies: the
budget-bounded ``lose_parity`` event degrades a published output ONE
BLOCK at a time (intact → decodable-but-under-width → below-k lost —
it takes m+1 events to kill a stripe where ``lose_replica`` killed a
copy outright), while ``lose_all`` keeps the blackout/dead-backend
shape. The scavenger's ladder is unchanged in form — ``repair`` now
means decode-from-survivors + re-encode back to full stripe width
(job state untouched), ``rerun_requeue`` stays the last rung — but
gains the DECODE-CONSERVATION invariant: no repair step may take a
job's output from below-k-survivors to readable. Decode is linear
algebra, not necromancy; only a producer re-run regenerates a stripe
that lost more than m blocks, and a scavenger that claims otherwise is
silently serving garbage. Two seeded bugs live on exactly these edges
(``coded_decode_lost_stripe``, ``coded_requeue_skips_decode``); the
second one's shortest trace replays against BOTH real stores and
diverges at the WRITTEN expectation of the requeue CAS.

**Leader lease / fencing (DESIGN §31).** With ``ModelConfig(ha=True)``
the coordinator itself joins the state: two contending coordinators
over one CAS lease document ``(epoch, holder, age)`` plus each
coordinator's BELIEVED epoch (0 = standby). The lease has its own
virtual clock (``lease_tick`` — a leader may die while every job still
WAITS, so lease expiry cannot ride the job tick), and the edges are
op-for-op the shipped ``sched/lease.py``: a standby's ``acquire``
(version CAS, legal only on a free/released or EXPIRED lease; the
epoch bumps on every transfer so validity windows never overlap), the
leader's ``renew`` (CAS resets the clock; failure = fenced back to
standby, permanently — ``StaleLeaderError`` is never retried),
``lead_release`` (clean handback), and ``lead_write`` — a guarded
server-side mutation that lands iff the believed epoch IS the lease
epoch (past the local deadline the landing rides the inline renewal
CAS, exactly ``FencedJobStore._check`` → ``validate`` → ``renew``).
All HA edges are environment (coordinator churn is never job
progress) and state-transparent on every job — who leads is invisible
to the claim protocol, because workers are leader-agnostic. Two
invariants pin the design down: at most one coordinator may ever
believe it holds the CURRENT epoch (no double leader), and no write
may land from a coordinator whose believed epoch is stale (no zombie
write). The seeded bugs (``double_leader``, ``zombie_leader_write``)
break exactly those, and their shortest traces replay against the
real ``LeaderLease`` + ``FencedJobStore`` over a real store, diverging
at the acquire CAS / the fencing guard respectively.

Copy of the JAX package's ``analysis/protocol.py``: the same model, the
same successor order and so the same state counts and the same first
violation trace; :func:`replay_trace` runs a trace against this
package's job stores (``MemJobStore``, ``FileJobStore`` on either index
engine) and its ``LeaderLease`` / ``FencedJobStore``.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, List, Optional, Sequence, Tuple

from lua_mapreduce_tpu_torch.core.constants import Status

_WAIT = int(Status.WAITING)
_RUN = int(Status.RUNNING)
_BRK = int(Status.BROKEN)
_FIN = int(Status.FINISHED)
_WRI = int(Status.WRITTEN)
_FAI = int(Status.FAILED)

_ALLOWED_EDGES = {
    _WAIT: {_RUN},
    _RUN: {_FIN, _BRK, _WAIT},
    _FIN: {_WRI, _BRK},
    _BRK: {_RUN, _FAI, _BRK},
    _WRI: set(),
    _FAI: set(),
}

KNOWN_BUGS = ("commit_skips_owner_cas", "requeue_ignores_finished",
              "scavenge_skips_lost_data", "lost_requeue_skips_written_cas",
              "spec_commit_skips_winner_cas", "lost_wakeup_no_fallback",
              "coded_decode_lost_stripe", "coded_requeue_skips_decode",
              "elastic_retire_holds_lease", "zombie_leader_write",
              "double_leader")

# bugs living on the replica-recovery edge need loss events to surface
LOSS_BUGS = ("scavenge_skips_lost_data", "lost_requeue_skips_written_cas")

# bugs living on the erasure-coded decode ladder need the coded data
# plane (block-at-a-time loss) plus a loss budget to be reachable
CODED_BUGS = ("coded_decode_lost_stripe", "coded_requeue_skips_decode")

# bugs living on the duplicate-lease edge need speculation enabled
SPEC_BUGS = ("spec_commit_skips_winner_cas",)

# bugs living on the watch/notify edge need the wakeup layer enabled
# (and a loss budget — a never-lost notification always wakes)
NOTIFY_BUGS = ("lost_wakeup_no_fallback",)

# bugs living on the elastic join/leave edge need the elastic pool
ELASTIC_BUGS = ("elastic_retire_holds_lease",)

# bugs living on the leader-lease/fencing edge need the HA layer
HA_BUGS = ("zombie_leader_write", "double_leader")

# elastic join/leave must be state-transparent on every job: scaling
# the pool may never change a status, an owner, or a retry budget —
# the semantics-neutrality rule of DESIGN §29
_ELASTIC_PURE_OPS = frozenset({"join", "retire"})

# notify/wait edges must be state-transparent on every job: going to
# sleep, waking (by notification or timeout), and losing a wakeup may
# never change a status or a retry budget — the stale-wakeup-is-a-no-op
# rule of DESIGN §23
_WAIT_PURE_OPS = frozenset({"sleep", "notify_wake", "timeout_wake",
                            "lose_notify"})

# job spec-lease state: none / OPEN / taken-by-worker-w (w = value - 10)
_SP_NONE = 0
_SP_OPEN = 1
_SP_TAKEN0 = 10     # taken by worker w encodes as _SP_TAKEN0 + w

# labels that must be state-transparent on the job (no status or
# repetition change) — the zero-charge rule of the speculation edges
_SPEC_PURE_OPS = frozenset({"speculate", "claim_spec", "spec_cancel"})

# replica-set state of a job's published output.  Under coded=True the
# same ladder reads as stripe survivorship: INTACT = full k+m width,
# UNDER = ≥k survivors (readable via decode, repairable by re-encode),
# LOST = below k survivors (only a producer re-run regenerates it)
_D_LOST = 0      # every copy gone — only a producer re-run regenerates
_D_UNDER = 1     # readable, but below full r-way redundancy
_D_INTACT = 2    # full redundancy

# environment events: enumerable, but never count as protocol progress
# (join/retire are the controller's capacity choices — WHEN capacity
# arrives or leaves is the environment's pick, like death). The HA
# coordinator-plane edges are environment too: who leads (and when a
# zombie probes a write) never constitutes JOB progress, so a state
# whose only options are coordinator churn is still quiescent for the
# lost-job invariants.
_ENV_OPS = frozenset({"die", "lose_replica", "lose_all", "lose_parity",
                      "lose_notify", "join", "retire", "lease_tick",
                      "acquire", "renew", "lead_release", "lead_write"})

# HA small-scope bounds: two contending coordinators, epochs saturate
# (three acquisitions are enough to exhibit election, succession, AND
# expiry takeover; an unbounded epoch would make the space infinite)
_N_COORDS = 2
_EPOCH_CAP = 3


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    n_workers: int = 2
    n_jobs: int = 3
    batch_k: int = 2
    max_retries: int = 2
    stale_age: int = 1
    allow_death: bool = True
    allow_fail: bool = False
    data_loss_budget: int = 0
    coded: bool = False
    allow_spec: bool = False
    allow_notify: bool = False
    notify_loss_budget: int = 1
    elastic: bool = False
    ha: bool = False
    bug: Optional[str] = None

    def __post_init__(self):
        if not (1 <= self.n_workers <= 3 and 1 <= self.n_jobs <= 4):
            raise ValueError("small-scope checker: ≤3 workers, ≤4 jobs")
        if not (1 <= self.batch_k <= self.n_jobs):
            raise ValueError(
                f"batch_k={self.batch_k} must be in [1, n_jobs]: a k<1 "
                "worker never claims, which quiesces with every job "
                "WAITING and would read as a fake lost-job violation")
        if self.max_retries < 1 or self.stale_age < 1:
            raise ValueError("max_retries and stale_age must be ≥ 1")
        if not (0 <= self.data_loss_budget <= 3):
            raise ValueError("data_loss_budget must be in [0, 3] "
                             "(small-scope: each loss event multiplies "
                             "the space)")
        if self.bug is not None and self.bug not in KNOWN_BUGS:
            raise ValueError(f"unknown bug {self.bug!r}; known: "
                             f"{KNOWN_BUGS}")
        if self.bug in LOSS_BUGS and self.data_loss_budget < 1:
            raise ValueError(f"bug {self.bug!r} lives on the "
                             "replica-recovery edge: it needs "
                             "data_loss_budget ≥ 1 to be reachable")
        if self.coded and self.data_loss_budget < 1:
            raise ValueError("coded=True without a data_loss_budget is "
                             "inert: lose_parity is the only edge the "
                             "coded plane adds, and it is budget-gated")
        if self.bug in CODED_BUGS and (
                not self.coded or self.data_loss_budget < 1):
            raise ValueError(f"bug {self.bug!r} lives on the "
                             "erasure-coded decode ladder: it needs "
                             "coded=True and data_loss_budget ≥ 1 to "
                             "be reachable")
        if self.bug in SPEC_BUGS and not self.allow_spec:
            raise ValueError(f"bug {self.bug!r} lives on the "
                             "duplicate-lease edge: it needs "
                             "allow_spec=True to be reachable")
        if not (0 <= self.notify_loss_budget <= 3):
            raise ValueError("notify_loss_budget must be in [0, 3]")
        if self.bug in NOTIFY_BUGS and (
                not self.allow_notify or self.notify_loss_budget < 1):
            raise ValueError(f"bug {self.bug!r} lives on the watch/notify "
                             "edge: it needs allow_notify=True and "
                             "notify_loss_budget ≥ 1 to be reachable")
        if self.elastic and self.n_workers < 2:
            raise ValueError("elastic=True needs ≥ 2 workers: the last "
                             "worker starts ABSENT (scale-up capacity), "
                             "so a 1-worker pool would have nobody to "
                             "run jobs before the join")
        if self.bug in ELASTIC_BUGS and not self.elastic:
            raise ValueError(f"bug {self.bug!r} lives on the elastic "
                             "join/leave edge: it needs elastic=True "
                             "to be reachable")
        if self.bug in HA_BUGS and not self.ha:
            raise ValueError(f"bug {self.bug!r} lives on the leader-"
                             "lease/fencing edge: it needs ha=True to "
                             "be reachable")
        if self.allow_spec and self.n_workers < 2:
            raise ValueError("allow_spec needs ≥ 2 workers: a shadow "
                             "lease is never taken by the job's own "
                             "claimant, so a 1-worker box has no "
                             "reachable speculation edge")


# Job record: (status, reps, owner, age, data, spec).  owner is 0
# (none) or worker-index+1; age counts virtual ticks since the last
# liveness signal and saturates at stale_age; data is the replica-set
# state of the job's published output (_D_INTACT until a budgeted loss
# event, restored by repair or by the re-run's commit); spec is the
# duplicate-lease state (_SP_NONE | _SP_OPEN | _SP_TAKEN0 + w).  State:
# (jobs, workers, commits, loss_budget, wakes, notify_budget) — wakes
# is one pending-wakeup bit per worker (set broadcast-style by every
# claimable-work producer: release, requeue, mark-broken, speculate,
# lost-data requeue; consumed by notify_wake; cleared by the
# budget-bounded lose_notify environment event), notify_budget bounds
# the lost-notification events.  Worker modes:
#   ("I",)                                       idle (polling)
#   ("S",)                                       asleep awaiting wakeup
#   ("D",)                                       dead
#   ("A",)                                       absent (elastic: not yet
#                                                joined — scale-up slot)
#   ("G",)                                       gone (elastic: retired)
#   ("R", leased, pos, done)                     executing job bodies
#   ("C", leased, entries, i, phase, tail, brk)  committing entry i
#   ("L", leased, tail, brk)                     releasing unstarted tail
#   ("K", leased, brk)                           marking the failed job
#   ("SR", j)                                    executing a clone body
#   ("SC", j, phase)                             clone committing (2-step)
# brk is the failing job id (failure path) or -1 (clean commit).

_IDLE = ("I",)
_DEAD = ("D",)
_ABSENT = ("A",)
_GONE = ("G",)


@dataclasses.dataclass
class Violation:
    message: str
    trace: List[tuple]
    state: tuple


@dataclasses.dataclass
class CheckResult:
    config: ModelConfig
    states: int
    transitions: int
    quiescent: int
    wall_s: float
    violation: Optional[Violation]

    @property
    def ok(self) -> bool:
        return self.violation is None


class LeaseModel:
    """The transition system: enumerate and apply protocol steps."""

    def __init__(self, config: ModelConfig):
        self.cfg = config
        self._rep_cap = config.max_retries + 1   # saturate: finite space

    def initial(self) -> tuple:
        jobs = tuple((_WAIT, 0, 0, 0, _D_INTACT, _SP_NONE)
                     for _ in range(self.cfg.n_jobs))
        workers = tuple(_IDLE for _ in range(self.cfg.n_workers))
        if self.cfg.elastic:
            # the last worker is the controller's scale-up capacity:
            # absent until a budget-free "join" brings it into the pool
            workers = workers[:-1] + (_ABSENT,)
        commits = (0,) * self.cfg.n_jobs
        # the leader-lease plane (DESIGN §31): (epoch, holder, age,
        # believed_0, believed_1) — holder is 0 (free/released) or
        # coordinator-index+1; age counts lease_ticks since the last
        # renewal; believed_c is the epoch coordinator c thinks it
        # holds (0 = standby). A constant zero tuple when ha is off.
        lease = (0, 0, 0) + (0,) * _N_COORDS
        return (jobs, workers, commits, self.cfg.data_loss_budget,
                (0,) * self.cfg.n_workers,
                self.cfg.notify_loss_budget if self.cfg.allow_notify else 0,
                lease)

    # -- per-transition effects (each is ONE atomic store op or one
    # worker-local step, which is exactly the interleaving granularity
    # the locks give the real system) -----------------------------------

    def _sat(self, reps: int) -> int:
        return min(reps, self._rep_cap)

    def transitions(self, state: tuple) -> List[Tuple[tuple, tuple]]:
        """[(label, next_state), ...] — every enabled step."""
        jobs, workers, commits, budget, wakes, nbudget, ha_st = state
        out: List[Tuple[tuple, tuple]] = []
        cfg = self.cfg

        def repl_job(j, rec):
            return tuple(rec if i == j else r for i, r in enumerate(jobs))

        def repl_w(w, mode, njobs=None, ncommits=None, nwakes=None):
            nw = tuple(mode if i == w else m for i, m in enumerate(workers))
            return ((jobs if njobs is None else njobs), nw,
                    (commits if ncommits is None else ncommits), budget,
                    (wakes if nwakes is None else nwakes), nbudget)

        def woken(produced) -> tuple:
            """Wake bits after a claimable-work producer: the notify
            bus is a broadcast, so every worker's pending bit sets —
            exactly what release/requeue/broken/speculate do through
            the real channels (DESIGN §23)."""
            if cfg.allow_notify and produced:
                return (1,) * len(workers)
            return wakes

        for w, mode in enumerate(workers):
            kind = mode[0]
            if kind in ("D", "G"):
                continue
            if kind == "A":
                # elastic scale-up: the absent worker joins the pool —
                # a pure capacity event, no job is touched
                out.append((("join", w), repl_w(w, _IDLE)))
                continue
            if cfg.allow_death:
                out.append((("die", w), repl_w(w, _DEAD)))
            if cfg.elastic and kind == "I":
                # elastic scale-down: an IDLE worker retires — the
                # graceful-exit contract (it owns no lease here by
                # construction; the step invariant verifies exactly
                # that, and the seeded bug below violates it)
                out.append((("retire", w), repl_w(w, _GONE)))
            if (cfg.bug == "elastic_retire_holds_lease"
                    and kind in ("R", "C")):
                # the seeded bug: the supervisor retires a member
                # MID-LEASE (kills the thread instead of bounding its
                # lifetime) — its leased jobs strand until the stale
                # requeue charges them a repetition they never earned
                out.append((("retire", w), repl_w(w, _GONE)))
            if kind == "S":
                # asleep in Waiter.wait. A pending notification wakes
                # it (consuming this worker's bit — the cursor);
                # TIMEOUT always wakes it too, pending bit or not —
                # the degradation-ladder fallback that turns a lost
                # notification into a plain poll instead of a hang.
                # The seeded bug deletes exactly that edge.
                if wakes[w]:
                    nw = tuple(0 if i == w else b
                               for i, b in enumerate(wakes))
                    out.append((("notify_wake", w),
                                repl_w(w, _IDLE, nwakes=nw)))
                if cfg.bug != "lost_wakeup_no_fallback":
                    out.append((("timeout_wake", w), repl_w(w, _IDLE)))
                continue
            if kind == "I":
                claimable = [j for j, rec in enumerate(jobs)
                             if rec[0] in (_WAIT, _BRK)]
                take = tuple(claimable[:cfg.batch_k])
                if take:
                    nj = list(jobs)
                    for j in take:
                        s, r, _, _, d, _ = nj[j]
                        # fresh claim resets any carried shadow lease,
                        # mirroring both index engines
                        nj[j] = (_RUN, r, w + 1, 0, d, _SP_NONE)
                    out.append((("claim", w, take),
                                repl_w(w, ("R", take, 0, ()),
                                       tuple(nj))))
                elif cfg.allow_spec:
                    # only a worker with NOTHING claimable probes for a
                    # shadow lease (Worker.poll_once's gating); lowest
                    # open id first — the engines' scan order inside a
                    # preference class (the model has no placement
                    # tags, so traces replay exactly on the 2-worker
                    # boxes the gate pins). Never the worker's own job.
                    open_ids = [j for j, rec in enumerate(jobs)
                                if rec[0] == _RUN and rec[5] == _SP_OPEN
                                and rec[2] != w + 1]
                    for j in open_ids[:1]:
                        s, r, o, a, d, _ = jobs[j]
                        nj = repl_job(j, (s, r, o, a, d, _SP_TAKEN0 + w))
                        out.append((("claim_spec", w, j),
                                    repl_w(w, ("SR", j), nj)))
                if cfg.allow_notify and not take:
                    # polled, found nothing claimable: arm the Waiter.
                    # The pending bit is NOT cleared — a notification
                    # that raced the poll-then-arm window is consumed
                    # by the next wait immediately (the per-waiter
                    # cursor rule, sched/waiter.py)
                    out.append((("sleep", w), repl_w(w, ("S",))))
            elif kind == "R":
                _, leased, pos, done = mode
                j = leased[pos]
                out.append((("exec", w, j),
                            repl_w(w, self._norm(
                                ("R", leased, pos + 1, done + (j,))))))
                if cfg.allow_fail:
                    out.append((("exec_fail", w, j),
                                repl_w(w, self._norm(
                                    ("C", leased, done, 0, 0,
                                     leased[pos + 1:], j)))))
            elif kind == "C":
                _, leased, entries, i, phase, tail, brk = mode
                j = entries[i]
                s, r, o, a, d, sp = jobs[j]
                owner_ok = (o == w + 1) or \
                    (cfg.bug == "commit_skips_owner_cas")
                if phase == 0:
                    ok = (s == _RUN) and owner_ok
                    nj = repl_job(j, (_FIN, r, o, a, d, sp)) if ok else jobs
                    nmode = ("C", leased, entries, i, 1, tail, brk) if ok \
                        else ("C", leased, entries, i + 1, 0, tail, brk)
                    out.append((("commit_a", w, j, ok),
                                repl_w(w, self._norm(nmode), nj)))
                else:
                    ok = (s == _FIN) and owner_ok
                    # a landed commit means the (re-)run's output was
                    # published whole at full redundancy
                    nj = repl_job(j, (_WRI, r, o, a, _D_INTACT, sp)) \
                        if ok else jobs
                    nc = tuple(min(c + 1, 2) if ok and i2 == j else c
                               for i2, c in enumerate(commits))
                    nmode = ("C", leased, entries, i + 1, 0, tail, brk)
                    out.append((("commit_b", w, j, ok),
                                repl_w(w, self._norm(nmode), nj, nc)))
            elif kind == "L":
                _, leased, tail, brk = mode
                nj = list(jobs)
                released = []
                for t in tail:
                    s, r, o, a, d, _ = nj[t]
                    if s == _RUN and o == w + 1:
                        # no repetition bump; release dissolves any
                        # shadow lease (the index engines' unlease rule)
                        nj[t] = (_WAIT, r, o, 0, d, _SP_NONE)
                        released.append(t)
                out.append((("release", w, tail, tuple(released)),
                            repl_w(w, self._norm(("K", leased, brk)),
                                   tuple(nj), nwakes=woken(released))))
            elif kind == "K":
                _, leased, brk = mode
                s, r, o, a, d, sp = jobs[brk]
                # ownership AND still-RUNNING: a job the scavenger
                # already requeued (BROKEN) or failed (FAILED) must not
                # be touched — Worker._mark_broken carries the matching
                # expect=(RUNNING,) CAS
                ok = (o == w + 1) and s == _RUN
                nj = repl_job(brk, (_BRK, self._sat(r + 1), o, 0, d,
                                    _SP_NONE)) if ok else jobs
                out.append((("mark_broken", w, brk, ok),
                            repl_w(w, _IDLE, nj, nwakes=woken(ok))))
            elif kind == "SR":
                j = mode[1]
                out.append((("spec_exec", w, j),
                            repl_w(w, ("SC", j, 0))))
                # the clone's revocation probe / body failure: dissolve
                # the shadow lease (iff still held), touch nothing else
                # — Worker.run_one's cancel path
                sp = jobs[j][5]
                held = sp == _SP_TAKEN0 + w
                nj = repl_job(j, jobs[j][:5] + (_SP_NONE,)) if held \
                    else jobs
                out.append((("spec_cancel", w, j, held),
                            repl_w(w, _IDLE, nj)))
            elif kind == "SC":
                _, j, phase = mode
                s, r, o, a, d, sp = jobs[j]
                # clone ownership = holding the shadow lease; the bug
                # variant ALSO skips the winner's status CAS — the race
                # the one-transition arbitration exists to prevent
                spec_ok = sp == _SP_TAKEN0 + w
                skip_status = cfg.bug == "spec_commit_skips_winner_cas"
                if phase == 0:
                    ok = spec_ok and (s == _RUN or skip_status)
                    if ok:
                        nj = repl_job(j, (_FIN, r, o, a, d, sp))
                        out.append((("commit_a", w, j, True),
                                    repl_w(w, ("SC", j, 1), nj)))
                    else:
                        # lost the race (or the lease): the cancel is
                        # the NEXT step (SP_X), mirroring run_one's
                        # failed-commit-then-cancel_spec order
                        out.append((("commit_a", w, j, False),
                                    repl_w(w, ("SP_X", j))))
                else:
                    ok = spec_ok and (s == _FIN or skip_status)
                    if ok:
                        nj = repl_job(j, (_WRI, r, o, a, _D_INTACT, sp))
                        nc = tuple(min(c + 1, 2) if i2 == j else c
                                   for i2, c in enumerate(commits))
                        out.append((("commit_b", w, j, True),
                                    repl_w(w, _IDLE, nj, nc)))
                    else:
                        out.append((("commit_b", w, j, False),
                                    repl_w(w, ("SP_X", j))))
            elif kind == "SP_X":
                # a clone whose commit failed dissolves its shadow lease
                # (iff still held) and goes idle — Worker._spec_lost
                j = mode[1]
                held = jobs[j][5] == _SP_TAKEN0 + w
                nj = repl_job(j, jobs[j][:5] + (_SP_NONE,)) if held \
                    else jobs
                out.append((("spec_cancel", w, j, held),
                            repl_w(w, _IDLE, nj)))
            # heartbeats: alive while job bodies run (R / SR) and on the
            # failure path (the except runs inside the _beating scope);
            # the clean commit happens after the beat thread stopped
            beating = (kind == "R") or (
                kind == "C" and (brk_of(mode) >= 0 or tail_of(mode))) \
                or kind in ("L", "K")
            if beating:
                leased = mode[1]
                beaten = tuple(t for t in leased
                               if jobs[t][0] in (_RUN, _FIN)
                               and jobs[t][2] == w + 1)
                if any(jobs[t][3] > 0 for t in beaten):
                    nj = list(jobs)
                    for t in beaten:
                        s, r, o, _, d, sp = nj[t]
                        nj[t] = (s, r, o, 0, d, sp)
                    out.append((("beat", w, beaten),
                                (tuple(nj), workers, commits, budget,
                                 wakes, nbudget)))
            elif kind == "SR":
                # the clone's beat thread: ownership through the shadow
                # lease — this is what keeps a job whose ORIGINAL died
                # from being stale-requeued (and repetition-charged)
                # while a live clone still races it
                j = mode[1]
                if (jobs[j][0] in (_RUN, _FIN)
                        and jobs[j][5] == _SP_TAKEN0 + w
                        and jobs[j][3] > 0):
                    nj = repl_job(j, jobs[j][:3] + (0,) + jobs[j][4:])
                    out.append((("beat", w, (j,)),
                                (nj, workers, commits, budget,
                                 wakes, nbudget)))

        # -- global (server/scavenger/clock) steps -----------------------
        if cfg.allow_spec:
            # the straggler detector's edge: any RUNNING job with no
            # speculation may be marked OPEN (the model abstracts the
            # EWMA-age threshold away — WHICH job straggles is the
            # environment's choice, so every choice is enumerated; the
            # CAS shape is what the checker verifies). A pure marker:
            # status, reps, owner, age all untouched.
            for j, rec in enumerate(jobs):
                if rec[0] == _RUN and rec[5] == _SP_NONE:
                    # opening a shadow lease wakes the idle fleet (the
                    # detector's notify in Server._speculate_stragglers)
                    out.append((("speculate", j),
                                (repl_job(j, rec[:5] + (_SP_OPEN,)),
                                 workers, commits, budget,
                                 woken(True), nbudget)))
        aged = [j for j, rec in enumerate(jobs)
                if rec[0] in (_RUN, _FIN) and rec[3] < self.cfg.stale_age]
        if aged:
            nj = list(jobs)
            for j in aged:
                s, r, o, a, d, sp = nj[j]
                nj[j] = (s, r, o, a + 1, d, sp)
            out.append((("tick",), (tuple(nj), workers, commits, budget,
                                    wakes, nbudget)))

        requeue_from = (_RUN,) if self.cfg.bug == "requeue_ignores_finished" \
            else (_RUN, _FIN)
        stale = tuple(j for j, rec in enumerate(jobs)
                      if rec[0] in requeue_from
                      and rec[3] >= self.cfg.stale_age)
        if stale:
            nj = list(jobs)
            for j in stale:
                s, r, o, a, d, sp = nj[j]
                # requeue dissolves any shadow lease (unlease rule)
                nj[j] = (_BRK, self._sat(r + 1), o, 0, d, _SP_NONE)
            out.append((("requeue", stale),
                        (tuple(nj), workers, commits, budget,
                         woken(True), nbudget)))

        failed = tuple(j for j, rec in enumerate(jobs)
                       if rec[0] == _BRK and rec[1] >= self.cfg.max_retries)
        if failed:
            nj = list(jobs)
            for j in failed:
                s, r, o, a, d, sp = nj[j]
                nj[j] = (_FAI, r, o, a, d, sp)
            out.append((("scavenge", failed),
                        (tuple(nj), workers, commits, budget,
                         wakes, nbudget)))

        # -- replica-aware data plane (DESIGN §20) -----------------------
        # environment loss events, budget-bounded: a published output
        # loses one replica, or every copy at once (the blackout /
        # dead-backend shape). Only WRITTEN jobs hold published output.
        if budget > 0:
            for j, (s, r, o, a, d, sp) in enumerate(jobs):
                if s != _WRI:
                    continue
                if cfg.coded:
                    # k+m stripe: blocks die ONE at a time. A first
                    # loss leaves the stripe decodable (UNDER — still
                    # ≥ k survivors); another drops it below k (LOST).
                    # Killing a stripe costs two budget charges where
                    # lose_replica's whole-copy semantics cost one —
                    # the durability the coding buys, made enumerable.
                    if d != _D_LOST:
                        out.append((
                            ("lose_parity", j),
                            (repl_job(j, (s, r, o, a, d - 1, sp)),
                             workers, commits, budget - 1, wakes,
                             nbudget)))
                elif d == _D_INTACT:
                    out.append((
                        ("lose_replica", j),
                        (repl_job(j, (s, r, o, a, _D_UNDER, sp)), workers,
                         commits, budget - 1, wakes, nbudget)))
                if d != _D_LOST:
                    out.append((
                        ("lose_all", j),
                        (repl_job(j, (s, r, o, a, _D_LOST, sp)), workers,
                         commits, budget - 1, wakes, nbudget)))
        # scavenger pass, reconstruct rung: every under-replicated
        # output is healed from a survivor — job state UNTOUCHED (the
        # whole point of the trade). Under coded=True the same rung is
        # decode-from-survivors + re-encode to full width; the seeded
        # bug also "repairs" below-k stripes — data from nothing, which
        # the decode-conservation step invariant catches
        repair_from = (_D_UNDER, _D_LOST) \
            if cfg.bug == "coded_decode_lost_stripe" else (_D_UNDER,)
        under = tuple(j for j, rec in enumerate(jobs)
                      if rec[0] == _WRI and rec[4] in repair_from)
        if under:
            nj = list(jobs)
            for j in under:
                s, r, o, a, _, sp = nj[j]
                nj[j] = (s, r, o, a, _D_INTACT, sp)
            out.append((("repair", under),
                        (tuple(nj), workers, commits, budget,
                         wakes, nbudget)))
        # scavenger pass, requeue rung (last resort): producers of
        # wholly-lost output go back to WAITING via a status CAS on
        # WRITTEN, with NO repetition charge, opening a fresh commit
        # generation. The seeded bugs delete the rung entirely or drop
        # the WRITTEN expectation from the CAS.
        if self.cfg.bug != "scavenge_skips_lost_data":
            if self.cfg.bug == "lost_requeue_skips_written_cas":
                lost = tuple(j for j, rec in enumerate(jobs)
                             if rec[4] == _D_LOST
                             and rec[0] in (_WRI, _FIN, _RUN))
            elif self.cfg.bug == "coded_requeue_skips_decode":
                # the decode-blind scavenger: ANY block loss reads as
                # total loss (the decode rung is never tried), and its
                # stale classification is trusted — no WRITTEN CAS
                lost = tuple(j for j, rec in enumerate(jobs)
                             if rec[4] in (_D_UNDER, _D_LOST)
                             and rec[0] in (_WRI, _FIN, _RUN))
            else:
                lost = tuple(j for j, rec in enumerate(jobs)
                             if rec[0] == _WRI and rec[4] == _D_LOST)
            if lost:
                nj = list(jobs)
                nc = list(commits)
                for j in lost:
                    _, r, _, _, d, _ = nj[j]
                    # the WAITING transition dissolves any (historical)
                    # shadow lease, like every unlease edge
                    nj[j] = (_WAIT, r, 0, 0, d, _SP_NONE)
                    nc[j] = 0
                out.append((("rerun_requeue", lost),
                            (tuple(nj), workers, tuple(nc), budget,
                             woken(True), nbudget)))

        # -- watch/notify adversary (DESIGN §23) -------------------------
        # a pending wakeup evaporates (dropped wake write, crashed
        # producer, cleared generation): budget-bounded so the space
        # stays finite. The timeout fallback is what must absorb it.
        if nbudget > 0:
            for w, bit in enumerate(wakes):
                if bit:
                    nw = tuple(0 if i == w else b
                               for i, b in enumerate(wakes))
                    out.append((("lose_notify", w),
                                (jobs, workers, commits, budget,
                                 nw, nbudget - 1)))

        # every job/worker/data-plane edge above leaves the lease plane
        # untouched: thread it through verbatim
        out = [(lbl, st + (ha_st,) if len(st) == 6 else st)
               for lbl, st in out]

        # -- leader-lease plane (DESIGN §31) ------------------------------
        # Two contending coordinators over one CAS lease document. All
        # edges are PURE on jobs/workers by construction — who leads is
        # invisible to the claim protocol (workers are leader-agnostic).
        if cfg.ha:
            ep, hold, age = ha_st[0], ha_st[1], ha_st[2]
            coords = ha_st[3:]

            def ha_next(nep=ep, nhold=hold, nage=age, coord=None):
                nc = list(coords)
                if coord is not None:
                    nc[coord[0]] = coord[1]
                return (jobs, workers, commits, budget, wakes, nbudget,
                        (nep, nhold, nage) + tuple(nc))

            # the lease's own virtual clock, separate from the job
            # clock: a leader may die while every job still WAITS, and
            # its lease must still be able to expire
            if hold != 0 and age < cfg.stale_age:
                out.append((("lease_tick",), ha_next(nage=age + 1)))
            for c in range(_N_COORDS):
                bel = coords[c]
                if bel == 0:
                    # standby election probe: the CAS acquire — legal on
                    # a free/released lease or an EXPIRED one (takeover,
                    # epoch bump past the dead leader). The seeded
                    # double_leader bug overwrites a LIVE lease without
                    # the version CAS, reusing the stored epoch — the
                    # two-live-holders shape the invariant catches.
                    expired = hold != 0 and age >= cfg.stale_age
                    can = hold == 0 or expired
                    buggy_live = (cfg.bug == "double_leader"
                                  and hold != 0 and not expired)
                    if (can and ep < _EPOCH_CAP) or buggy_live:
                        nep = ep if buggy_live else ep + 1
                        out.append((("acquire", c, expired),
                                    ha_next(nep=nep, nhold=c + 1, nage=0,
                                            coord=(c, nep))))
                else:
                    if bel == ep and hold == c + 1:
                        # the live leader: renewal resets the clock;
                        # release hands the lease back cleanly
                        if age > 0:
                            out.append((("renew", c, True),
                                        ha_next(nage=0)))
                        out.append((("lead_release", c),
                                    ha_next(nhold=0, nage=0,
                                            coord=(c, 0))))
                    else:
                        # the lease moved under this coordinator: its
                        # renewal CAS fails and it is fenced back to
                        # standby (never retried — StaleLeaderError is
                        # permanent by classification)
                        out.append((("renew", c, False),
                                    ha_next(coord=(c, 0))))
                    # a server-side mutation through the fencing guard.
                    # Correct model: lands iff the believed epoch IS the
                    # lease epoch; past the local deadline the landing
                    # rides the inline renewal CAS, which resets the
                    # clock (FencedJobStore._check → validate → renew).
                    # The seeded zombie_leader_write bug skips the guard
                    # — the stale write lands, which is the step
                    # violation.
                    landed = (bel == ep
                              or cfg.bug == "zombie_leader_write")
                    if landed:
                        nage = 0 if (bel == ep and age >= cfg.stale_age) \
                            else age
                        out.append((("lead_write", c, True),
                                    ha_next(nage=nage)))
                    else:
                        out.append((("lead_write", c, False),
                                    ha_next(coord=(c, 0))))
        return out

    @staticmethod
    def _norm(mode: tuple) -> tuple:
        """Collapse empty stages so every mode has a pending action."""
        while True:
            kind = mode[0]
            if kind == "R" and mode[2] >= len(mode[1]):
                mode = ("C", mode[1], mode[3], 0, 0, (), -1)
            elif kind == "C" and mode[3] >= len(mode[2]):
                _, leased, _, _, _, tail, brk = mode
                mode = ("L", leased, tail, brk) if tail else \
                    (("K", leased, brk) if brk >= 0 else _IDLE)
            elif kind == "L" and not mode[2]:
                mode = ("K", mode[1], mode[3])
            elif kind == "K" and mode[2] < 0:
                mode = _IDLE
            else:
                return mode

    # -- invariants -----------------------------------------------------

    def step_violation(self, old: tuple, new: tuple,
                       label: tuple) -> Optional[str]:
        ojobs, ocommits = old[0], old[2]
        njobs, ncommits = new[0], new[2]
        if label[0] == "acquire":
            # the fencing invariant (DESIGN §31): validity windows of
            # successive epochs never overlap, so at most ONE
            # coordinator may ever believe it holds the lease's CURRENT
            # epoch — the version CAS + epoch bump guarantee it
            nha = new[6]
            live = [c for c, b in enumerate(nha[3:])
                    if b > 0 and b == nha[0]]
            if len(live) >= 2:
                return (f"double leader: coordinators {live} both hold "
                        f"live epoch {nha[0]} after {label} — the "
                        "acquire skipped the version CAS / expiry "
                        "check, so two validity windows overlap and "
                        "both leaders' writes pass the fence "
                        "(DESIGN §31)")
        if label[0] == "lead_write" and label[2]:
            oha = old[6]
            c = label[1]
            if oha[3 + c] != oha[0]:
                return (f"stale-epoch write landed: coordinator {c} "
                        f"wrote with epoch {oha[3 + c]} while the lease "
                        f"is at epoch {oha[0]} — a zombie leader "
                        "mutated job state after losing a takeover "
                        "(the fencing guard must reject it with "
                        "StaleLeaderError; DESIGN §31)")
        if label[0] == "retire":
            # the no-lease-abandoned rule (DESIGN §29): a retiring
            # worker must own no live lease — FleetSupervisor's
            # graceful exit bounds the member's lifetime so it leaves
            # only AFTER its current lease settles
            w = label[1]
            held = [j for j, rec in enumerate(ojobs)
                    if rec[0] in (_RUN, _FIN)
                    and (rec[2] == w + 1 or rec[5] == _SP_TAKEN0 + w)]
            if held:
                return (f"retired worker {w} abandoned leases on jobs "
                        f"{held} — an elastic scale-down must wait for "
                        "the in-flight lease to settle (the stale "
                        "requeue would charge those jobs a repetition "
                        "they never earned; DESIGN §29)")
        for j, ((os_, or_, oo, _, od, osp), (ns_, nr, no, _, nd, nsp)) in \
                enumerate(zip(ojobs, njobs)):
            if nr < or_:
                return (f"repetitions of job {j} decreased {or_}→{nr} "
                        f"on {label}")
            if label[0] == "repair" and od == _D_LOST and nd != _D_LOST:
                # decode-conservation (DESIGN §27): repair reconstructs
                # from ≥ k survivors; a stripe below k has no decode —
                # a scavenger that "heals" it is fabricating bytes and
                # masking a loss only a producer re-run can cover
                return (f"repair resurrected job {j}'s output from "
                        f"below-k survivors on {label} — decode cannot "
                        "reconstruct a stripe with fewer than k blocks; "
                        "only a producer re-run regenerates it")
            if label[0] in _WAIT_PURE_OPS and (os_, or_, oo, osp) != \
                    (ns_, nr, no, nsp):
                # sleep/wake/lost-notify must be invisible to every job:
                # a wakeup carries no payload, so a stale or duplicate
                # one is a no-op by construction (DESIGN §23)
                return (f"notify edge {label} touched job {j} state — "
                        "sleep/wake transitions must be pure")
            if label[0] in _ELASTIC_PURE_OPS and (os_, or_, oo, osp) != \
                    (ns_, nr, no, nsp):
                # join/retire are pure capacity events: scaling the
                # pool may never touch a job (DESIGN §29)
                return (f"elastic edge {label} touched job {j} state — "
                        "join/retire must be pure pool-membership "
                        "transitions")
            if label[0] in _SPEC_PURE_OPS and (ns_ != os_ or nr != or_):
                # the zero-charge rule of the speculation edges: marking,
                # taking, or dissolving a shadow lease must be invisible
                # to the job's status and retry budget (DESIGN §21)
                return (f"speculation edge {label} touched job {j} state "
                        f"({Status(os_).name},{or_})→"
                        f"({Status(ns_).name},{nr}) — speculate/claim/"
                        "cancel must be pure lease-markers")
            if ns_ != os_ and ns_ not in _ALLOWED_EDGES[os_]:
                # the ONE legal WRITTEN→WAITING edge: the scavenger's
                # lost-data requeue — and it must charge no repetition
                # (the loss is not the job's fault; DESIGN §20)
                if (label[0] == "rerun_requeue" and os_ == _WRI
                        and ns_ == _WAIT):
                    if nr != or_:
                        return (f"lost-data requeue charged a repetition "
                                f"to job {j} ({or_}→{nr}) — storage loss "
                                "must never march a job toward FAILED")
                    continue
                return (f"illegal status edge job {j}: "
                        f"{Status(os_).name}→{Status(ns_).name} on {label}")
        if label[0] == "commit_b" and label[3]:
            w, j = label[1], label[2]
            if ncommits[j] > 1:
                return (f"double commit: job {j} committed twice "
                        f"(worker {w} landed a second commit — the "
                        "first-commit-wins CAS failed to arbitrate)")
            if ojobs[j][2] != w + 1 and ojobs[j][5] != _SP_TAKEN0 + w:
                return (f"commit without ownership: worker {w} committed "
                        f"job {j} currently claimed by worker "
                        f"{ojobs[j][2] - 1} with no shadow lease — the "
                        "scavenger requeued and re-claimed it mid-commit")
        return None

    def quiescent_violation(self, state: tuple) -> Optional[str]:
        jobs, workers = state[0], state[1]
        if all(m[0] in ("D", "G", "A") for m in workers):
            # a fully dead pool may strand work; so may a pool whose
            # every member retired or never joined (the elastic analog
            # — the real supervisor's baseline floor prevents it, but
            # the model enumerates the environment's worst case)
            return None
        bad = {j: Status(s).name
               for j, (s, _, _, _, _, _) in enumerate(jobs)
               if s not in (_WRI, _FAI)}
        if bad:
            msg = (f"lost/stuck jobs at quiescence with a live worker: "
                   f"{bad} (every job must end WRITTEN or FAILED; a "
                   "FINISHED entry here is the stuck-FINISHED+unclaimed "
                   "gap)")
            asleep = [w for w, m in enumerate(workers) if m[0] == "S"]
            if asleep:
                msg += (f"; workers {asleep} are asleep awaiting a "
                        "wakeup that will never arrive — the lost-wakeup"
                        " hang the Waiter's timeout fallback exists to "
                        "prevent (DESIGN §23)")
            return msg
        stranded = [j for j, (s, _, _, _, d, _) in enumerate(jobs)
                    if s == _WRI and d == _D_LOST]
        if stranded:
            return (f"stranded lost shuffle data at quiescence with a "
                    f"live worker: jobs {stranded} are WRITTEN but every "
                    "replica of their output is gone and nobody will "
                    "regenerate it — the reduce phase wedges (the "
                    "scavenger must requeue the producer, DESIGN §20)")
        return None


def brk_of(mode: tuple) -> int:
    return mode[6] if mode[0] == "C" else -1


def tail_of(mode: tuple) -> tuple:
    return mode[5] if mode[0] == "C" else ()


def check_protocol(config: ModelConfig = ModelConfig(),
                   max_states: int = 5_000_000) -> CheckResult:
    """Exhaustively enumerate every reachable interleaving (BFS, so a
    violation trace is shortest-possible) and check all invariants."""
    model = LeaseModel(config)
    t0 = _time.perf_counter()
    init = model.initial()
    visited = {init}
    parents: Dict[tuple, Tuple[Optional[tuple], Optional[tuple]]] = {
        init: (None, None)}
    frontier = [init]
    n_trans = 0
    n_quiescent = 0

    def trace_to(state, extra=None):
        labels = []
        cur = state
        while True:
            prev, label = parents[cur]
            if prev is None:
                break
            labels.append(label)
            cur = prev
        labels.reverse()
        if extra is not None:
            labels.append(extra)
        return labels

    while frontier:
        next_frontier = []
        for state in frontier:
            trans = model.transitions(state)
            # quiescence means no PROGRESS is possible; worker death
            # and data-loss events are environment events, not progress
            # — a state whose only enabled steps are "somebody could
            # still die / more data could be lost" is already stuck,
            # and must pass the lost-job + stranded-data invariants
            if all(label[0] in _ENV_OPS for label, _ in trans):
                n_quiescent += 1
                msg = model.quiescent_violation(state)
                if msg:
                    return CheckResult(config, len(visited), n_trans,
                                       n_quiescent,
                                       _time.perf_counter() - t0,
                                       Violation(msg, trace_to(state),
                                                 state))
                if all(label[0] == "die" for label, _ in trans):
                    continue     # only deaths left: nothing new to learn
                # loss events still pending: a lost output must wake the
                # scavenger back up — keep exploring those branches
            for label, new in trans:
                n_trans += 1
                msg = model.step_violation(state, new, label)
                if msg:
                    return CheckResult(config, len(visited), n_trans,
                                       n_quiescent,
                                       _time.perf_counter() - t0,
                                       Violation(msg,
                                                 trace_to(state, label),
                                                 new))
                if new not in visited:
                    if len(visited) >= max_states:
                        raise RuntimeError(
                            f"state space exceeds {max_states} states — "
                            "shrink the configuration")
                    visited.add(new)
                    parents[new] = (state, label)
                    next_frontier.append(new)
        frontier = next_frontier
    return CheckResult(config, len(visited), n_trans, n_quiescent,
                       _time.perf_counter() - t0, None)


# -- trace replay against the real stores -----------------------------------

_DUMMY_TIMES = {"started": 1.0, "finished": 2.0, "written": 3.0,
                "cpu": 0.5, "real": 2.0}


def replay_trace(store, trace: Sequence[tuple], config: ModelConfig,
                 final_state: Optional[tuple] = None,
                 ns: str = "model_jobs") -> dict:
    """Run a model trace's store operations against a REAL JobStore.

    Virtual-clock steps (``tick``) have no store analog; the staleness
    they produce is applied surgically at the ``requeue`` step via the
    same status CAS ``requeue_stale`` performs (RUNNING|FINISHED →
    BROKEN, +1 repetition), on exactly the jobs the model requeued.

    Returns ``{"ok": True, ...}`` when every operation's outcome matches
    the model (and, when ``final_state`` is given, the store's final
    per-job status/reps match it), else ``{"ok": False, "step": k,
    "label": ..., "reason": ...}`` naming the first divergent step —
    for a seeded-bug trace that divergence IS the real store's CAS
    refusing the racy operation.
    """
    from lua_mapreduce_tpu_torch.coord.jobstore import make_job

    store.insert_jobs(ns, [make_job(f"k{j}", j)
                           for j in range(config.n_jobs)])
    wname = [f"mw{w}" for w in range(config.n_workers)]

    def diverged(i, label, reason):
        return {"ok": False, "step": i, "label": label, "reason": reason}

    # the leader-lease plane replays against the REAL pt_cas lease +
    # FencedJobStore (DESIGN §31). The virtual lease clock advances
    # 1.25 per lease_tick against ttl = stale_age, so "age ≥ stale_age"
    # in the model is strictly past the real deadline (the real expiry
    # compare is strict) while "age < stale_age" stays strictly inside.
    ha_now = [0.0]
    ha_leases: Dict[int, object] = {}

    def ha_lease(c: int):
        if c not in ha_leases:
            from lua_mapreduce_tpu_torch.sched.lease import LeaderLease
            ha_leases[c] = LeaderLease(store, holder=f"mc{c}",
                                       ttl_s=float(config.stale_age),
                                       clock=lambda: ha_now[0])
        return ha_leases[c]

    for i, label in enumerate(trace):
        op = label[0]
        if op == "lease_tick":
            ha_now[0] += 1.25
            continue
        if op == "acquire":
            _, c, took = label
            if not ha_lease(c).try_acquire():
                return diverged(
                    i, label,
                    f"acquire CAS refused coordinator {c} — the real "
                    "lease's version CAS + expiry check block the "
                    "takeover the buggy model allowed")
            if ha_lease(c).took_over != took:
                return diverged(i, label,
                                f"took_over={ha_lease(c).took_over}, "
                                f"model said {took}")
            continue
        if op == "renew":
            _, c, ok = label
            got = ha_lease(c).renew()
            if got != ok:
                return diverged(i, label,
                                f"renew CAS returned {got}, model "
                                f"said {ok}")
            continue
        if op == "lead_release":
            ha_lease(label[1]).release()
            continue
        if op == "lead_write":
            _, c, landed = label
            from lua_mapreduce_tpu_torch.faults.errors import StaleLeaderError
            from lua_mapreduce_tpu_torch.sched.lease import FencedJobStore
            fenced = FencedJobStore(store, ha_lease(c))
            try:
                # a harmless guarded mutation: the fencing check is
                # what's under test, not the op's payload
                fenced.requeue_stale(ns, 1e9)
                got = True
            except StaleLeaderError:
                got = False
            if got != landed:
                return diverged(
                    i, label,
                    f"fenced write: real guard "
                    + ("rejected the write the buggy model landed — "
                       "StaleLeaderError fences the zombie" if landed
                       else f"landed a write the model fenced"))
            continue
        if op in ("exec", "exec_fail", "spec_exec", "die", "tick",
                  "lose_replica", "lose_all", "lose_parity", "repair",
                  "sleep", "notify_wake", "timeout_wake", "lose_notify",
                  "join", "retire"):
            # loss events / replica repair live on the data plane, and
            # sleep/wake edges live in the Waiter layer (sched/waiter.py)
            # — neither has a jobstore op to replay; the store-visible
            # consequences (what was claimed, requeued, committed)
            # replay through the surrounding protocol ops
            continue
        if op == "speculate":
            (_, j) = label
            if not store.speculate(ns, j):
                return diverged(i, label,
                                f"speculate CAS refused job {j}")
        elif op == "claim_spec":
            _, w, j = label
            doc = store.claim_spec(ns, wname[w])
            got = doc["_id"] if doc else None
            if got != j:
                return diverged(i, label,
                                f"claim_spec took {got}, model took {j}")
        elif op == "spec_cancel":
            _, w, j, held = label
            got = store.cancel_spec(ns, j, wname[w])
            if got != held:
                return diverged(i, label,
                                f"cancel_spec returned {got}, model "
                                f"said {held}")
        elif op == "claim":
            _, w, take = label
            docs = store.claim_batch(ns, wname[w], k=config.batch_k)
            got = tuple(d["_id"] for d in docs)
            if got != tuple(take):
                return diverged(i, label,
                                f"claimed {got}, model claimed {take}")
        elif op == "commit_a":
            _, w, j, ok = label
            got = store.set_job_status(ns, j, Status.FINISHED,
                                       expect=(Status.RUNNING,),
                                       expect_worker=wname[w])
            if got != ok:
                return diverged(
                    i, label,
                    f"FINISHED CAS returned {got}, model said {ok}"
                    + ("" if ok else " — the store is weaker than the "
                       "protocol allows")
                    + (" — the real store's status+ownership CAS refuses "
                       "the commit the buggy model allowed" if not got
                       else ""))
            if got:
                store.set_job_times(ns, j, _DUMMY_TIMES)
        elif op == "commit_b":
            _, w, j, ok = label
            got = store.set_job_status(ns, j, Status.WRITTEN,
                                       expect=(Status.FINISHED,),
                                       expect_worker=wname[w])
            if got != ok:
                return diverged(
                    i, label,
                    f"WRITTEN CAS returned {got}, model said {ok}"
                    + (" — the real store's ownership CAS refuses the "
                       "commit the buggy model allowed" if not got else ""))
        elif op == "release":
            _, w, tail, released = label
            n = store.release_batch(ns, wname[w], list(tail))
            if n != len(released):
                return diverged(i, label,
                                f"released {n}, model released "
                                f"{len(released)}")
        elif op == "mark_broken":
            _, w, j, ok = label
            got = store.set_job_status(ns, j, Status.BROKEN,
                                       expect=(Status.RUNNING,),
                                       expect_worker=wname[w])
            if got != ok:
                return diverged(i, label,
                                f"BROKEN CAS returned {got}, model "
                                f"said {ok}")
        elif op == "beat":
            _, w, beaten = label
            n = store.heartbeat_batch(ns, list(beaten), wname[w])
            if n != len(beaten):
                return diverged(i, label,
                                f"{n} beats landed, model landed "
                                f"{len(beaten)}")
        elif op == "requeue":
            (_, stale) = label
            for j in stale:
                if not store.set_job_status(
                        ns, j, Status.BROKEN,
                        expect=(Status.RUNNING, Status.FINISHED)):
                    return diverged(i, label,
                                    f"requeue CAS refused job {j}")
        elif op == "scavenge":
            (_, failed) = label
            n = store.scavenge(ns, config.max_retries)
            if n != len(failed):
                return diverged(i, label,
                                f"scavenged {n}, model scavenged "
                                f"{len(failed)}")
        elif op == "rerun_requeue":
            # the reconstruct-vs-requeue edge's last rung: exactly the
            # WRITTEN→WAITING CAS Server._requeue_maps performs per
            # producer of a wholly-lost file — the real store refuses it
            # for any job not currently WRITTEN, which is where a
            # skips-the-CAS bug trace diverges
            (_, lost) = label
            for j in lost:
                if not store.set_job_status(ns, j, Status.WAITING,
                                            expect=(Status.WRITTEN,)):
                    return diverged(
                        i, label,
                        f"lost-data requeue CAS refused job {j} — the "
                        "real store's WRITTEN expectation blocks the "
                        "requeue the buggy model allowed")
        else:
            return diverged(i, label, f"unknown trace op {op!r}")

    result = {"ok": True, "steps": len(trace)}
    if final_state is not None:
        jobs = final_state[0]
        cap = config.max_retries + 1
        for j, (s, r, _, _, _, _) in enumerate(jobs):
            doc = store.get_job(ns, j)
            if int(doc["status"]) != s or min(int(doc["repetitions"]),
                                              cap) != r:
                return {"ok": False, "step": len(trace),
                        "label": ("final",),
                        "reason": f"job {j} ended "
                                  f"({Status(int(doc['status'])).name}, "
                                  f"{doc['repetitions']}), model ended "
                                  f"({Status(s).name}, {r})"}
    return result


def utest() -> None:
    """Self-test: a 1×2 exhaustive pass holds every invariant (with and
    without the replica-recovery edge); every seeded bug is re-found; a
    violation trace replayed against the real MemJobStore diverges
    exactly at the guarding CAS."""
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore

    small = ModelConfig(n_workers=1, n_jobs=2, batch_k=2)
    res = check_protocol(small)
    assert res.ok and res.states > 10 and res.quiescent > 0

    bug = check_protocol(dataclasses.replace(
        small, n_workers=2, bug="commit_skips_owner_cas"))
    assert not bug.ok and "ownership" in bug.violation.message
    rep = replay_trace(MemJobStore(), bug.violation.trace,
                       bug.config)
    assert not rep["ok"] and rep["label"][0].startswith("commit")

    stuck = check_protocol(dataclasses.replace(
        small, n_workers=2, bug="requeue_ignores_finished"))
    assert not stuck.ok and "FINISHED" in stuck.violation.message

    # replica-recovery edge (DESIGN §20): loss events + repair +
    # lost-data requeue keep the full invariant set, including the
    # zero-repetition-charge and no-stranded-data rules
    lossy = dataclasses.replace(small, data_loss_budget=2)
    res2 = check_protocol(lossy)
    assert res2.ok and res2.states > res.states

    strand = check_protocol(dataclasses.replace(
        lossy, bug="scavenge_skips_lost_data"))
    assert not strand.ok and "stranded" in strand.violation.message

    yank = check_protocol(dataclasses.replace(
        lossy, n_workers=2, bug="lost_requeue_skips_written_cas"))
    assert not yank.ok and "illegal status edge" in yank.violation.message
    rep2 = replay_trace(MemJobStore(), yank.violation.trace, yank.config)
    assert not rep2["ok"]
    assert rep2["label"][0] in ("rerun_requeue", "commit_a", "commit_b",
                                "claim")

    # speculation edges (DESIGN §21): the duplicate-lease lifecycle
    # holds every invariant exhaustively, and the loser-commit-skips-
    # winner-CAS race is re-found and diverges on the real store's CAS
    spec = dataclasses.replace(small, n_workers=2, allow_spec=True)
    res3 = check_protocol(spec)
    assert res3.ok and res3.states > res.states

    race = check_protocol(dataclasses.replace(
        spec, bug="spec_commit_skips_winner_cas"))
    assert not race.ok, "seeded spec race not found"
    assert ("double commit" in race.violation.message
            or "illegal status edge" in race.violation.message)
    rep3 = replay_trace(MemJobStore(), race.violation.trace, race.config)
    assert not rep3["ok"]
    assert rep3["label"][0].startswith(("commit", "claim_spec",
                                        "spec_cancel"))

    # watch/notify edges (DESIGN §23): sleep/wake/lost-notification
    # interleavings keep the whole invariant set, and deleting the
    # timeout fallback re-finds the lost-wakeup hang, replayable: the
    # store ops of the hang trace reproduce and land jobs exactly where
    # the model stranded them
    waked = dataclasses.replace(small, n_workers=2, allow_notify=True)
    res4 = check_protocol(waked)
    assert res4.ok and res4.states > res.states

    hang = check_protocol(dataclasses.replace(
        waked, bug="lost_wakeup_no_fallback"))
    assert not hang.ok, "seeded lost-wakeup hang not found"
    assert "asleep" in hang.violation.message
    rep4 = replay_trace(MemJobStore(), hang.violation.trace, hang.config,
                        final_state=hang.violation.state)
    assert rep4["ok"], rep4    # the wedge reproduces on the real store

    # erasure-coded recovery (DESIGN §27): block-at-a-time loss +
    # decode-repair keep the full invariant set exhaustively; the
    # conjured-decode and decode-blind-requeue bugs are re-found, and
    # the requeue bug's trace diverges at the WRITTEN CAS on BOTH real
    # stores (the survivor-set-decode-vs-requeue edge)
    import tempfile
    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore

    coded = dataclasses.replace(small, data_loss_budget=2, coded=True)
    res5 = check_protocol(coded)
    assert res5.ok and res5.states > res.states

    conj = check_protocol(dataclasses.replace(
        coded, bug="coded_decode_lost_stripe"))
    assert not conj.ok, "seeded conjured-decode bug not found"
    assert "below-k" in conj.violation.message

    blind = check_protocol(dataclasses.replace(
        coded, n_workers=2, bug="coded_requeue_skips_decode"))
    assert not blind.ok, "seeded decode-blind requeue not found"
    assert "illegal status edge" in blind.violation.message
    with tempfile.TemporaryDirectory() as td:
        for st in (MemJobStore(), FileJobStore(td)):
            rep5 = replay_trace(st, blind.violation.trace, blind.config)
            assert not rep5["ok"], (type(st).__name__, rep5)
            assert rep5["label"][0] in ("rerun_requeue", "commit_a",
                                        "commit_b", "claim"), rep5

    # elastic join/leave (DESIGN §29): the pool-membership edges hold
    # every invariant exhaustively (join/retire purity, graceful exit),
    # and retiring a mid-lease member is re-found as the abandoned-
    # lease violation; the correct-model trace replays on the real
    # store (join/retire have no store op — exactly the point: scaling
    # is invisible to the lease protocol)
    elastic = dataclasses.replace(small, n_workers=2, elastic=True)
    res6 = check_protocol(elastic)
    assert res6.ok and res6.states > res.states

    abandon = check_protocol(dataclasses.replace(
        elastic, bug="elastic_retire_holds_lease"))
    assert not abandon.ok, "seeded mid-lease retire not found"
    assert "abandoned leases" in abandon.violation.message
    rep6 = replay_trace(MemJobStore(), abandon.violation.trace[:-1],
                        abandon.config)
    assert rep6["ok"], rep6   # every store op up to the bad retire lands

    # leader lease / fencing (DESIGN §31): coordinator churn holds the
    # whole invariant set exhaustively (HA edges are job-transparent —
    # who leads is invisible to the claim protocol); the split-brain
    # and zombie-write bugs are re-found as direct invariant hits, and
    # their traces replayed against the REAL LeaderLease/FencedJobStore
    # over a real store diverge at exactly the guarding CAS / fence
    ha_cfg = dataclasses.replace(small, ha=True)
    res7 = check_protocol(ha_cfg)
    assert res7.ok and res7.states > res.states

    dbl = check_protocol(dataclasses.replace(ha_cfg, bug="double_leader"))
    assert not dbl.ok, "seeded double-leader bug not found"
    assert "double leader" in dbl.violation.message
    rep7 = replay_trace(MemJobStore(), dbl.violation.trace, dbl.config)
    assert not rep7["ok"] and rep7["label"][0] == "acquire", rep7

    zomb = check_protocol(dataclasses.replace(
        ha_cfg, bug="zombie_leader_write"))
    assert not zomb.ok, "seeded zombie-write bug not found"
    assert "stale-epoch write landed" in zomb.violation.message
    rep8 = replay_trace(MemJobStore(), zomb.violation.trace, zomb.config)
    assert not rep8["ok"] and rep8["label"][0] == "lead_write", rep8
