"""lmr-ha: epoch-fenced leader lease + hot-standby election.

Port of ``lua_mapreduce_tpu/sched/lease.py`` (DESIGN §31). The lease
document and the ``_state.<N>`` frames are the JAX package's, so a
coordinator of either package fences, and resumes from, the other.

The coordinator was the last single point of failure: workers, shuffle
bytes, and mid-stripe spills all survive SIGKILL (DESIGN §19-§21, §27),
but the server's resume matrix only helps if a human restarts the
process. This module makes coordinator death a *scheduling event*:

- :class:`LeaderLease` — a CAS-acquired lease on the job store's
  persistent table carrying a monotonic **epoch** (the fencing token).
  The lease document is ``{"timestamp": version, "epoch": E, "holder":
  name, "deadline": T}``; every write bumps ``version`` through
  ``pt_cas`` (compare-and-swap on the stored version), so two
  coordinators can never both believe the same write landed. Renewal
  runs on an injectable clock from a stop-event-driven daemon thread
  (the worker-heartbeat idiom); a failed renewal CAS means the lease
  moved under us — the holder is **fenced** and must abdicate, never
  retry.
- :class:`FencedJobStore` — wraps the server's (already retry-wrapped)
  job store and guards every server-side mutation (put_task /
  update_task / insert_jobs / requeue / scavenge / speculate / drop_ns
  / autotune deployments, all of which ride ``update_task``) with the
  lease validity check: the fast path is one clock comparison; past the
  local deadline the holder re-validates with ONE inline renewal CAS,
  and a holder whose lease moved gets a classified permanent
  :class:`StaleLeaderError` — so a zombie coordinator returning from a
  GC pause, SIGSTOP, or partition (the ``slow``/blackout FaultPlan
  kinds simulate all three) can never corrupt job state. Each rejection
  is counted (``fenced_writes``), traced (``leader.fenced``), and
  landed on the errors stream with the epoch/holder evidence for
  post-mortem diagnosis.
- standbys watch the **"leader"** topic of the existing notify bus
  (sched/waiter.py), so takeover is event-driven: a clean release wakes
  the standbys immediately, and a SIGKILLed leader's silence degrades
  to the TTL-bounded timeout probe — takeover latency is bounded by
  ``ttl + probe`` either way, which is what the ha bench's
  ``< 2 × TTL`` acceptance bar measures.

The fencing argument (DESIGN §31 spells it out in full): mutations are
safe while ``clock() < deadline`` — the takeover path cannot acquire
before the deadline, so validity windows of successive epochs never
overlap (up to clock skew, which the TTL margin absorbs). Past its
deadline a holder must win a renewal CAS before mutating; losing that
CAS is proof of a takeover, and the permanent classification makes the
retry layer fail fast instead of backing off into a later corruption.

Loop-state framing: :func:`frame_state` / :func:`unframe_state` are the
CRC-framed encoding of the ``_state.<iteration>`` checkpoint the server
publishes before every FINISHED→WAIT flip, closing the last resume hole
(the "loop" protocol's threaded state used to live purely in server
memory).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
import zlib
from typing import Any, Callable, Optional

from lua_mapreduce_tpu_torch.faults.errors import StaleLeaderError

# the lease's persistent-table document name (pt_* plane: one per coord
# store root, like the task document)
LEASE_NAME = "leader"

# the loop-state checkpoint prefix: `_state.<iteration>` sits outside
# every engine namespace (like `_trace.`), so purges of either can never
# touch result bytes
STATE_NS = "_state"

_STATE_MAGIC = b"LMRS1"

DEFAULT_TTL_S = 10.0

_holder_seq = [0]
_holder_lock = threading.Lock()


def default_holder() -> str:
    """A fleet-unique holder name: host.pid.seq — seq disambiguates
    multiple Server instances inside one process (the test fleets)."""
    with _holder_lock:
        _holder_seq[0] += 1
        seq = _holder_seq[0]
    return f"{socket.gethostname()}.{os.getpid()}.{seq}"


def resolve_lease_ttl(arg) -> float:
    """Lease TTL resolution order: explicit argument, else
    ``LMR_LEASE_TTL_S`` env, else :data:`DEFAULT_TTL_S`. Sub-100ms TTLs
    would renew faster than a loaded store round-trips and are
    rejected."""
    if arg is None:
        arg = os.environ.get("LMR_LEASE_TTL_S") or DEFAULT_TTL_S
    ttl = float(arg)
    if ttl < 0.1:
        raise ValueError(f"lease TTL {ttl}s is below the 0.1s floor — "
                         "renewal could not outrun a loaded store")
    return ttl


def frame_state(obj: Any) -> bytes:
    """CRC-framed encoding of a JSON-serializable loop state: magic +
    8-byte big-endian length + payload + crc32(payload). The frame is
    self-validating so a torn write (crashed leader mid-publish) reads
    as corrupt, never as silently-wrong state."""
    from lua_mapreduce_tpu_torch.core.serialize import to_plain
    payload = json.dumps(to_plain(obj), sort_keys=True,
                         separators=(",", ":")).encode("utf-8")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return (_STATE_MAGIC + len(payload).to_bytes(8, "big") + payload
            + crc.to_bytes(4, "big"))


def unframe_state(data: bytes) -> Any:
    """Decode + CRC-verify a :func:`frame_state` frame; raises
    ``ValueError`` on any truncation, magic mismatch, or checksum
    failure (the caller treats corrupt state as absent)."""
    if len(data) < len(_STATE_MAGIC) + 12 \
            or not data.startswith(_STATE_MAGIC):
        raise ValueError("loop-state frame: bad magic/truncated header")
    off = len(_STATE_MAGIC)
    n = int.from_bytes(data[off:off + 8], "big")
    payload = data[off + 8:off + 8 + n]
    if len(payload) != n:
        raise ValueError("loop-state frame: truncated payload")
    crc = int.from_bytes(data[off + 8 + n:off + 12 + n], "big")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise ValueError("loop-state frame: CRC mismatch")
    return json.loads(payload.decode("utf-8"))


class LeaderLease:
    """One coordinator's handle on the fleet's leader lease.

    ``store`` is a JobStore (wrapped or raw — pt ops delegate through
    the proxy stack); ``clock`` must be a wall clock shared by every
    contender (cross-process deadline comparisons), injectable for
    virtual-time tests. All CAS traffic manages its own ``timestamp``
    version field: ``pt_cas`` compares-and-swaps on the stored version
    and writes the new document verbatim (it never auto-bumps).
    """

    def __init__(self, store, holder: Optional[str] = None,
                 ttl_s: Optional[float] = None,
                 clock: Callable[[], float] = time.time,
                 name: str = LEASE_NAME):
        self.store = store
        self.holder = holder or default_holder()
        self.ttl_s = resolve_lease_ttl(ttl_s)
        self.clock = clock
        self.name = name
        self.epoch = 0              # 0 = never held
        self.took_over = False      # last acquire bumped past a dead leader
        self._version = 0           # the doc version this holder last wrote
        self._deadline = 0.0        # local copy of the renewed deadline
        self._fenced = False
        self._lock = threading.Lock()
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # -- acquisition / renewal ---------------------------------------------

    def _doc(self, version: int, epoch: int, deadline: float) -> dict:
        return {"timestamp": version, "epoch": epoch,
                "holder": self.holder, "deadline": deadline}

    def peek(self) -> Optional[dict]:
        """The stored lease document (None before the first election)."""
        return self.store.pt_get(self.name)

    def try_acquire(self) -> bool:
        """ONE election round: CAS-acquire a free/expired/released lease.
        Returns True with ``epoch``/``took_over`` set on a win; False
        when a live holder keeps the lease. Winning always bumps the
        epoch past the previous holder's — the fencing invariant."""
        now = self.clock()
        cur = self.store.pt_get(self.name)
        with self._lock:
            if cur is None:
                doc = self._doc(1, 1, now + self.ttl_s)
                if not self.store.pt_cas(self.name, None, doc):
                    return False
                self.epoch, self._version = 1, 1
                self.took_over = False
            else:
                released = not cur.get("holder")
                expired = now > float(cur.get("deadline") or 0.0)
                if not released and not expired:
                    return False
                version = int(cur.get("timestamp") or 0)
                epoch = int(cur.get("epoch") or 0) + 1
                doc = self._doc(version + 1, epoch, now + self.ttl_s)
                if not self.store.pt_cas(self.name, version, doc):
                    return False        # lost the election CAS
                self.epoch, self._version = epoch, version + 1
                # a takeover is an acquire over an EXPIRED lease a dead
                # leader never released; clean succession is not one
                self.took_over = expired and not released
            self._deadline = now + self.ttl_s
            self._fenced = False
        self._notify()
        return True

    def renew(self) -> bool:
        """Extend the deadline one TTL via the version CAS. A failed
        CAS means the lease moved under us (takeover) — the holder is
        FENCED from here on; renewal is never retried."""
        with self._lock:
            if self._fenced or self.epoch == 0:
                return False
            now = self.clock()
            doc = self._doc(self._version + 1, self.epoch,
                            now + self.ttl_s)
            try:
                ok = self.store.pt_cas(self.name, self._version, doc)
            except Exception:
                # a store blip mid-renew: the lease may or may not have
                # moved — keep the OLD local deadline (never extend on
                # uncertainty); the next renewal or the fencing check's
                # inline CAS settles it
                return not self._expired_locked(now)
            if not ok:
                self._fenced = True
                return False
            self._version += 1
            self._deadline = now + self.ttl_s
            return True

    def release(self) -> None:
        """Clean abdication: clear the holder and expire the deadline
        (epoch stays — successors still bump past it), then wake the
        standbys. Best-effort: a lost release degrades to the TTL."""
        with self._lock:
            if self._fenced or self.epoch == 0:
                return
            doc = self._doc(self._version + 1, self.epoch, 0.0)
            doc["holder"] = ""
            try:
                self.store.pt_cas(self.name, self._version, doc)
            except Exception:
                pass
            self.epoch = 0
            self._fenced = False
        self._notify()

    # -- validity (the fencing check) ---------------------------------------

    def _expired_locked(self, now: float) -> bool:
        return now >= self._deadline

    def validate(self) -> bool:
        """The per-mutation fencing check. Fast path: one clock
        comparison against the locally-renewed deadline (mutations are
        safe strictly inside the validity window — takeover cannot
        happen before it ends). Past the deadline: ONE inline renewal
        CAS decides — win it and the window reopens; lose it and the
        holder is fenced for good."""
        with self._lock:
            if self._fenced or self.epoch == 0:
                return False
            if not self._expired_locked(self.clock()):
                return True
        return self.renew()

    @property
    def fenced(self) -> bool:
        return self._fenced

    # -- renewal thread ------------------------------------------------------

    def start_renewal(self) -> None:
        """Daemon renewal at ttl/3 cadence (the worker-heartbeat idiom:
        a stop Event both paces and interrupts the wait). Stops itself
        the moment a renewal is fenced."""
        if self._thread is not None and self._thread.is_alive():
            return
        stop = threading.Event()

        def loop():
            while not stop.wait(self.ttl_s / 3.0):
                if not self.renew():
                    return

        self._stop = stop
        self._thread = threading.Thread(
            target=loop, daemon=True, name=f"lease-renew-{self.holder}")
        self._thread.start()

    def stop_renewal(self, release: bool = False) -> None:
        """Stop renewing; with ``release`` also abdicate cleanly.
        ``release=False`` is the simulated-crash path tests use — the
        lease is left to expire exactly as a SIGKILL would leave it."""
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if release:
            self.release()

    # -- standby side --------------------------------------------------------

    def standby_waiter(self):
        """A cursor on the store's "leader" topic: wakes on acquire /
        release notifications; a lost one times out into the probe."""
        from lua_mapreduce_tpu_torch.sched.waiter import channel_for
        return channel_for(self.store, "leader").waiter()

    def _notify(self) -> None:
        from lua_mapreduce_tpu_torch.sched.waiter import notify
        notify(self.store, "leader")


# the server-side mutation surface the fencing guard covers; reads
# (get_task / jobs / counts / drain_errors / pt_get) and the errors
# stream (workers write it leaderlessly) stay unguarded
FENCED_OPS = ("put_task", "update_task", "delete_task", "insert_jobs",
              "drop_ns", "scavenge", "requeue_stale", "speculate",
              "cancel_spec", "set_job_status")


class FencedJobStore:
    """Epoch-fencing guard over the server's job-store stack.

    Follows the wrapper convention (faults/wrappers.py): ``_inner`` +
    ``__getattr__`` delegation so ``unwrap()`` and non-mutating ops
    pass through untouched. Stacks OUTERMOST — above the retry layer —
    so a fenced rejection fails fast instead of burning the retry
    budget (StaleLeaderError is permanent, so even a mis-stacked guard
    would not be retried)."""

    def __init__(self, inner, lease: LeaderLease):
        self._inner = inner
        self._lease = lease

    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    def _check(self, op: str):
        if self._lease.validate():
            return
        lease = self._lease
        cur = None
        try:
            cur = lease.peek()
        except Exception:
            pass
        cur_epoch = int(cur.get("epoch") or 0) if cur else None
        cur_holder = cur.get("holder") if cur else None
        from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
        COUNTERS.bump("fenced_writes")
        msg = (f"fenced write rejected: {op} by {lease.holder!r} with "
               f"stale epoch {lease.epoch} (current epoch {cur_epoch}, "
               f"holder {cur_holder!r}) — zombie leader abdicates")
        # post-mortem diagnosis (DESIGN §31): the rejection lands on
        # the errors stream with the epoch evidence, through the RAW
        # store — the zombie's diagnostic write must not itself be
        # fenced, retried, or traced
        try:
            from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
            unwrap(self._inner).insert_error(
                lease.holder, msg,
                info={"classification": "fenced-write", "op": op,
                      "epoch": lease.epoch, "current_epoch": cur_epoch,
                      "current_holder": cur_holder})
        except Exception:
            pass
        from lua_mapreduce_tpu_torch.trace.span import active_tracer
        tracer = active_tracer()
        if tracer is not None:
            with tracer.span("leader.fenced", op=op, epoch=lease.epoch,
                             current_epoch=cur_epoch):
                pass
        raise StaleLeaderError(msg, op=op, epoch=lease.epoch,
                               current_epoch=cur_epoch, holder=cur_holder)

    # -- the guarded mutation surface ---------------------------------------

    def put_task(self, doc):
        self._check("put_task")
        return self._inner.put_task(doc)

    def update_task(self, fields):
        self._check("update_task")
        return self._inner.update_task(fields)

    def delete_task(self):
        self._check("delete_task")
        return self._inner.delete_task()

    def insert_jobs(self, ns, docs):
        self._check("insert_jobs")
        return self._inner.insert_jobs(ns, docs)

    def drop_ns(self, ns):
        self._check("drop_ns")
        return self._inner.drop_ns(ns)

    def scavenge(self, ns, max_retries=None):
        self._check("scavenge")
        if max_retries is None:
            return self._inner.scavenge(ns)
        return self._inner.scavenge(ns, max_retries)

    def requeue_stale(self, ns, older_than_s):
        self._check("requeue_stale")
        return self._inner.requeue_stale(ns, older_than_s)

    def speculate(self, ns, job_id):
        self._check("speculate")
        return self._inner.speculate(ns, job_id)

    def cancel_spec(self, ns, job_id, worker):
        self._check("cancel_spec")
        return self._inner.cancel_spec(ns, job_id, worker)

    def set_job_status(self, ns, job_id, status, expect=None,
                       expect_worker=None):
        self._check("set_job_status")
        return self._inner.set_job_status(ns, job_id, status, expect=expect,
                                          expect_worker=expect_worker)


def utest() -> None:
    """Self-test: election CAS, epoch monotonicity, expiry takeover,
    renewal fencing, the FencedJobStore guard + errors-stream evidence,
    clean-release succession, and the CRC state framing."""
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore

    now = [1000.0]
    clock = lambda: now[0]   # noqa: E731 — shared virtual clock

    store = MemJobStore()
    a = LeaderLease(store, holder="A", ttl_s=10.0, clock=clock)
    b = LeaderLease(store, holder="B", ttl_s=10.0, clock=clock)

    # first election: A wins epoch 1; B loses while A is live
    assert a.try_acquire() and a.epoch == 1 and not a.took_over
    assert not b.try_acquire()
    # renewal extends the deadline through the version CAS
    now[0] += 5.0
    assert a.renew() and a.validate()

    # A goes silent past the TTL: B's acquire is a TAKEOVER, epoch 2
    now[0] += 20.0
    assert b.try_acquire() and b.epoch == 2 and b.took_over
    # the zombie's renewal CAS fails → fenced, and stays fenced
    assert not a.renew() and a.fenced and not a.validate()

    # the fencing guard: B's writes pass, A's raise StaleLeaderError
    fb = FencedJobStore(store, b)
    fa = FencedJobStore(store, a)
    fb.put_task({"_id": "unique", "status": "WAIT", "iteration": 1})
    try:
        fa.update_task({"status": "MAP"})
    except StaleLeaderError as e:
        assert e.epoch == 1 and e.current_epoch == 2
        assert e.transient is False
    else:
        raise AssertionError("zombie write must be fenced")
    # the rejection landed on the errors stream with the evidence
    errs = store.drain_errors()
    assert any(e.get("classification") == "fenced-write"
               and e.get("current_epoch") == 2
               and e.get("epoch") == 1 for e in errs), errs
    # reads delegate unguarded even for the zombie
    assert fa.get_task()["status"] == "WAIT"

    # clean release: successor bumps the epoch but it is NOT a takeover
    b.release()
    c = LeaderLease(store, holder="C", ttl_s=10.0, clock=clock)
    assert c.try_acquire() and c.epoch == 3 and not c.took_over

    # validate() past the local deadline re-validates via ONE inline
    # renewal CAS (the window reopens when nobody took over)
    now[0] += 15.0
    assert c.validate() and not c.fenced

    # CRC framing round-trip + corruption detection
    state = {"centroids": [[1.0, 2.0], [3.0, 4.0]], "iter": 7}
    buf = frame_state(state)
    assert unframe_state(buf) == state
    for bad in (buf[:-1], b"XXXX" + buf[4:],
                buf[:-2] + bytes([buf[-2] ^ 1, buf[-1]])):
        try:
            unframe_state(bad)
        except ValueError:
            pass
        else:
            raise AssertionError("corrupt frame must not decode")

    # TTL resolution: env fallback + the floor
    assert resolve_lease_ttl(2.5) == 2.5
    try:
        resolve_lease_ttl(0.01)
    except ValueError:
        pass
    else:
        raise AssertionError("sub-floor TTL must be rejected")
