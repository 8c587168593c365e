"""Watch/notify wakeup primitives — the event half of lmr-sched.

Port of ``lua_mapreduce_tpu/sched/waiter.py`` (DESIGN §23). The wake
file and object names are the JAX package's byte for byte
(``_sched.<topic>.wake`` in a FileJobStore root, ``._sched.<topic>.wake``
in a SharedStore directory, the ``_sched.<topic>.wake`` object), so a
producer of either package wakes a waiter of the other on one directory.

The control plane this replaces is pure polling: an idle worker sleeps a
fixed interval and re-scans the claim surface, so dispatch latency is
bounded below by the poll period and a large idle fleet burns claim
scans discovering nothing. This module gives every backend a cheap
wakeup channel instead:

- **memfs / in-process pools** — a condition-variable event bus keyed by
  the shared job-store instance: ``notify`` is one predicate bump plus a
  broadcast, wakeups are sub-millisecond.
- **sharedfs / FileJobStore** — a directory-mtime CURSOR: ``notify``
  appends one byte to a per-topic wake file; waiters probe that single
  inode's ``(size, mtime_ns)`` signature on a short ramping interval.
  One ``stat`` is orders of magnitude cheaper than a claim scan (flock +
  record read + payload-cache resolution), which is what makes
  millisecond-class dispatch affordable across processes and NFS hosts.
- **objectfs / fake-GCS** — a GENERATION-STAMPED conditional read: the
  producer PUTs a tiny ``_sched.<topic>.wake`` object carrying a fresh
  generation token; waiters re-read it and wake when the token moved
  past their cursor. Maps 1:1 onto the object contract (no append, no
  rename) and onto a real bucket's metadata reads.

Degradation ladder (the contract every engine caller relies on):

1. notification arrives → the waiter returns True within one probe
   interval (in-process: immediately);
2. notification LOST (crashed producer, dropped wake write, cleared
   generation) → the wait times out and the caller falls back to
   exactly today's poll — degraded latency, never a hang. The protocol
   model checker enumerates this edge exhaustively
   (``ModelConfig(allow_notify=True)``, analysis/protocol.py);
3. notify disabled (``LMR_SCHED_NOTIFY=0``) → :class:`NullChannel`
   everywhere: waits are plain sleeps, behavior byte-identical to the
   pre-sched engine.

A STALE or duplicate wakeup is always a no-op by construction: the
woken caller re-polls the claim surface, finds nothing, and goes back
to waiting — wakeups carry no payload, so there is nothing to get
wrong. Clocks and sleeps are injectable throughout (the faults/retry.py
convention); lint rule LMR011 keeps every engine/coord wait on this
module instead of bare ``time.sleep``.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Callable, Dict, Optional

# probe ramp for the polling-cursor waiters: start fine (milliseconds —
# the dispatch-latency budget), back off geometrically to a cap so a
# long timeout costs tens of probes, not thousands
PROBE_MIN_S = 0.002
PROBE_MAX_S = 0.05
PROBE_GROWTH = 1.6

_FALSEY = ("", "0", "off", "false", "no")


def notify_enabled() -> bool:
    """The fleet-wide off switch: ``LMR_SCHED_NOTIFY=0`` (or any falsey
    value) degrades every channel to :class:`NullChannel` — waits become
    plain sleeps and the engine is byte-identical to the pre-sched
    polling plane. Unset/truthy = on (the default)."""
    val = os.environ.get("LMR_SCHED_NOTIFY")
    if val is None:
        return True
    return val.strip().lower() not in _FALSEY


class Waiter:
    """One consumer's view of a wakeup channel.

    ``wait(timeout_s)`` blocks until a notification lands (True) or the
    timeout elapses (False — the poll-fallback signal). The cursor is
    per-waiter: a notification that fired BETWEEN two waits is consumed
    by the next ``wait`` immediately, so the poll-then-arm race window
    (checked the claim surface, found nothing, notification fired
    before the wait was armed) can never lose a wakeup.

    ``can_notify`` is False only for :class:`NullWaiter` — engine
    callers gate their jittered-backoff behavior on it so the notify-off
    path keeps the exact legacy sleep schedule.
    """

    can_notify = True

    def wait(self, timeout_s: float) -> bool:
        raise NotImplementedError

    def close(self) -> None:
        """Release waiter resources. Idempotent; default: nothing."""


class NullWaiter(Waiter):
    """Pure-sleep fallback (notify off / unknown store). This is THE
    one sanctioned sleep site for engine/coord wait paths (LMR011):
    the sleep function is injectable for virtual-clock tests."""

    can_notify = False

    def __init__(self, sleep: Callable[[float], None] = time.sleep):
        self._sleep = sleep

    def wait(self, timeout_s: float) -> bool:
        if timeout_s > 0:
            self._sleep(timeout_s)
        return False


class _CondWaiter(Waiter):
    """In-process waiter over a shared (condition, generation) pair."""

    def __init__(self, channel: "LocalChannel"):
        self._channel = channel
        with channel._cond:
            self._seen = channel._gen

    def wait(self, timeout_s: float) -> bool:
        ch = self._channel
        with ch._cond:
            if ch._gen != self._seen:
                self._seen = ch._gen       # pending notify: consume now
                return True
            ch._cond.wait(timeout=max(0.0, timeout_s))
            woken = ch._gen != self._seen
            self._seen = ch._gen
            return woken


class _CursorWaiter(Waiter):
    """Shared ramping-probe loop for the file/object cursor waiters:
    subclasses supply ``_signature()`` — a cheap token that changes on
    every notify (stat signature, generation stamp). A probe that
    errors reads as "unchanged": storage weather degrades to the poll
    fallback, never to a raised wait."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        self._clock = clock
        self._sleep = sleep
        self._seen = self._probe()

    def _signature(self):
        raise NotImplementedError

    def _probe(self):
        try:
            return self._signature()
        except Exception:
            return None

    def wait(self, timeout_s: float) -> bool:
        deadline = self._clock() + max(0.0, timeout_s)
        probe = PROBE_MIN_S
        while True:
            sig = self._probe()
            if sig != self._seen:
                self._seen = sig
                return True
            remaining = deadline - self._clock()
            if remaining <= 0:
                return False
            self._sleep(min(probe, remaining))
            probe = min(probe * PROBE_GROWTH, PROBE_MAX_S)


class _FileCursorWaiter(_CursorWaiter):
    """Dirmtime cursor over one wake file (sharedfs / FileJobStore)."""

    def __init__(self, path: str, **kw):
        self._path = path
        super().__init__(**kw)

    def _signature(self):
        try:
            st = os.stat(self._path)
        except OSError:
            return None
        return (st.st_size, st.st_mtime_ns)


class _StoreCursorWaiter(_CursorWaiter):
    """Generation-stamped conditional read over an object store."""

    def __init__(self, channel: "StoreChannel", **kw):
        self._channel = channel
        super().__init__(**kw)

    def _signature(self):
        return self._channel._read_generation()


# --------------------------------------------------------------------------
# channels (the producer side; waiters are minted from them)
# --------------------------------------------------------------------------


class Channel:
    """A named wakeup topic: ``notify`` on the producer side, ``waiter``
    mints a consumer cursor. ``notify`` is best-effort by contract — a
    failed notification is a LOST one, and the waiter's timeout fallback
    absorbs it (degradation rung 2)."""

    can_notify = True

    def notify(self) -> None:
        raise NotImplementedError

    def waiter(self, clock: Callable[[], float] = time.monotonic,
               sleep: Callable[[float], None] = time.sleep) -> Waiter:
        raise NotImplementedError


class NullChannel(Channel):
    """Notify disabled: producers no-op, waiters plain-sleep."""

    can_notify = False

    def notify(self) -> None:
        pass

    def waiter(self, clock=time.monotonic, sleep=time.sleep) -> Waiter:
        return NullWaiter(sleep)


class LocalChannel(Channel):
    """In-process event bus: one condition + generation counter shared
    by every waiter minted from this channel."""

    def __init__(self):
        self._cond = threading.Condition()
        self._gen = 0

    def notify(self) -> None:
        with self._cond:
            self._gen += 1
            self._cond.notify_all()

    def waiter(self, clock=time.monotonic, sleep=time.sleep) -> Waiter:
        return _CondWaiter(self)


class DirChannel(Channel):
    """Wake file in a shared directory. ``notify`` appends ONE byte
    (O_APPEND writes this small are atomic), so the file's
    ``(size, mtime_ns)`` signature strictly advances — the cursor the
    waiters watch. Notifications are low-rate (phase flips, inserts,
    lease retirements), so growth is bytes per task, not per poll."""

    def __init__(self, path: str):
        self.path = path

    def notify(self) -> None:
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            fd = os.open(self.path,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o666)
            try:
                os.write(fd, b".")
            finally:
                os.close(fd)
        except OSError:
            pass        # lost notification: the timeout fallback covers it

    def waiter(self, clock=time.monotonic, sleep=time.sleep) -> Waiter:
        return _FileCursorWaiter(self.path, clock=clock, sleep=sleep)


class StoreChannel(Channel):
    """Generation-stamped wake object through any :class:`Store`
    (objectfs local emulation, real/fake GCS, memfs). ``notify`` PUTs a
    fresh monotonic generation token; waiters conditionally re-read it.
    IO goes through the UNWRAPPED innermost store (the trace-flush
    rule): wakeup traffic must not consume FaultPlan occurrences, pay
    retry backoff, or trace itself."""

    def __init__(self, store, name: str):
        from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
        self._store = unwrap(store)
        self._name = name
        self._lock = threading.Lock()
        self._counter = 0

    def notify(self) -> None:
        with self._lock:
            self._counter += 1
            token = f"{time.time_ns()}.{os.getpid()}.{self._counter}"
        try:
            with self._store.builder() as b:
                b.write(token)
                b.build(self._name)
        except Exception:
            pass        # lost notification: the timeout fallback covers it

    def _read_generation(self) -> Optional[str]:
        try:
            if not self._store.exists(self._name):
                return None
            return self._store.read_range(self._name, 0, 64).decode(
                "latin-1")
        except Exception:
            return None

    def waiter(self, clock=time.monotonic, sleep=time.sleep) -> Waiter:
        return _StoreCursorWaiter(self, clock=clock, sleep=sleep)


# --------------------------------------------------------------------------
# routing: store/jobstore instance -> channel, per topic
# --------------------------------------------------------------------------

# topics keep producer/consumer traffic separated so commit-completion
# notifies (the server's barrier wakeup) never wake the idle-worker
# fleet into pointless claim scans, and vice versa:
#   "jobs" — claimable work appeared (inserts, releases, requeues,
#            broken marks, speculation opens, task phase flips);
#            workers wait on it
#   "done" — lease retirements landed (commits); the server's barrier
#            poll waits on it
#   "leader" — the leader lease moved (acquire / renew-expiry window /
#            release / takeover); HA standby coordinators wait on it so
#            takeover is event-driven, not polled (DESIGN §31). A lost
#            notification degrades to the standby's TTL-bounded timeout
#            probe, same ladder as every other topic.
TOPICS = ("jobs", "done", "leader")

WAKE_PREFIX = "_sched"          # object names: _sched.<topic>.wake

# in-process channels keyed by the concrete store instance (weak: a
# dropped store must not pin its bus), then by topic
_local_channels: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_local_lock = threading.Lock()
_NULL = NullChannel()


def _local_channel(store, topic: str) -> LocalChannel:
    with _local_lock:
        by_topic: Optional[Dict[str, LocalChannel]] = \
            _local_channels.get(store)
        if by_topic is None:
            by_topic = {}
            _local_channels[store] = by_topic
        ch = by_topic.get(topic)
        if ch is None:
            ch = by_topic[topic] = LocalChannel()
        return ch


def channel_for(store, topic: str = "jobs") -> Channel:
    """The wakeup channel of a job store (or data store), routed by
    backend:

    - ``MemJobStore`` / ``MemStore`` → the in-process event bus;
    - ``FileJobStore`` → a dirmtime cursor in its coord root;
    - ``SharedStore`` → a dirmtime cursor in its directory;
    - ``ObjectStore`` (local or gs://) → a generation-stamped wake
      object;
    - anything else, or ``LMR_SCHED_NOTIFY`` off → :class:`NullChannel`.

    Wrapper stacks (retry/tracing/injection, tenant views) are unwrapped
    first, so every participant sharing one concrete store shares one
    bus."""
    if topic not in TOPICS:
        raise ValueError(f"unknown sched topic {topic!r}; use {TOPICS}")
    if not notify_enabled():
        return _NULL
    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
    from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
    from lua_mapreduce_tpu_torch.store.memfs import MemStore
    from lua_mapreduce_tpu_torch.store.objectfs import ObjectStore
    from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore
    raw = unwrap(store)
    if isinstance(raw, (MemJobStore, MemStore)):
        return _local_channel(raw, topic)
    if isinstance(raw, FileJobStore):
        return DirChannel(os.path.join(raw.root,
                                       f"{WAKE_PREFIX}.{topic}.wake"))
    if isinstance(raw, SharedStore):
        return DirChannel(os.path.join(raw.path,
                                       f".{WAKE_PREFIX}.{topic}.wake"))
    if isinstance(raw, ObjectStore):
        return StoreChannel(raw, f"{WAKE_PREFIX}.{topic}.wake")
    return _NULL


def notify(store, topic: str = "jobs") -> None:
    """Fire-and-forget producer hook: bump ``store``'s channel for
    ``topic``. Never raises — a lost notification degrades to the
    consumer's poll fallback by design."""
    try:
        channel_for(store, topic).notify()
    except Exception:
        pass


def jittered_wait(waiter: Waiter, sleep_s: float, cap_s: float, rng,
                  floor_s: float = 0.1):
    """ONE idle-backoff step, shared by every engine idle loop (Worker
    and FairWorker must not drift apart on the jitter/growth schedule
    DESIGN §23 documents): wait up to ``sleep_s`` — jittered by
    rng.uniform(0.6, 1.0) when the waiter is notify-capable and the
    interval exceeds the floor, so an idle fleet's fallback polls
    de-synchronize; the notify-off path keeps the exact legacy
    schedule. Returns ``(woken, next_sleep_s)``: a wakeup resets the
    backoff to the floor (re-poll promptly), a timeout grows it 1.5x
    toward ``cap_s``."""
    timeout = sleep_s
    if waiter.can_notify and timeout > floor_s:
        timeout *= rng.uniform(0.6, 1.0)
    woken = waiter.wait(timeout)
    return woken, (floor_s if woken else min(sleep_s * 1.5, cap_s))


def utest() -> None:
    """Self-test: cursor semantics (pending notify consumed, lost
    notify times out, stale wake absorbed) on the local and dir
    channels, plus routing and the off switch."""
    import tempfile

    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore

    # local bus: notify between waits is consumed by the NEXT wait
    ch = LocalChannel()
    w = ch.waiter()
    ch.notify()
    assert w.wait(0.0) is True          # pending: no block needed
    assert w.wait(0.0) is False         # consumed: nothing new
    # cross-thread wake
    got = []
    t = threading.Thread(target=lambda: got.append(w.wait(5.0)))
    t.start()
    time.sleep(0.02)
    ch.notify()
    t.join(timeout=5.0)
    assert got == [True]

    # dir channel: signature cursor over the wake file
    with tempfile.TemporaryDirectory() as d:
        dch = DirChannel(os.path.join(d, "t.wake"))
        dw = dch.waiter()
        assert dw.wait(0.01) is False   # no notify: timeout fallback
        dch.notify()
        assert dw.wait(1.0) is True
        assert dw.wait(0.01) is False   # stale wake consumed exactly once
        # a waiter created AFTER existing notifies absorbs them as its
        # baseline (pre-history is not a wakeup)
        dch.notify()
        fresh = dch.waiter()
        assert fresh.wait(0.01) is False

    # routing + off switch
    js = MemJobStore()
    a, b = channel_for(js, "jobs"), channel_for(js, "jobs")
    assert a is b and isinstance(a, LocalChannel)
    assert channel_for(js, "done") is not a
    prev = os.environ.get("LMR_SCHED_NOTIFY")
    os.environ["LMR_SCHED_NOTIFY"] = "0"
    try:
        assert isinstance(channel_for(js, "jobs"), NullChannel)
        assert not channel_for(js, "jobs").can_notify
    finally:
        if prev is None:
            os.environ.pop("LMR_SCHED_NOTIFY", None)
        else:
            os.environ["LMR_SCHED_NOTIFY"] = prev
    try:
        channel_for(js, "bogus")
    except ValueError:
        pass
    else:
        raise AssertionError("unknown topic must be rejected")
