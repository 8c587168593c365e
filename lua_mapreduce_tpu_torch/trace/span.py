"""Span layer — lmr-trace's core (DESIGN §22).

Copy of the JAX package's ``trace/span.py`` (the torch package imports
nothing of the JAX package).

The observability gap this closes: utils/stats.py folds per-job
lifecycle timestamps into phase aggregates (the reference's model),
which says how long a phase took but never WHY — claim latency vs job
body vs spill publish vs commit is invisible, and every counter added
since PR 5 (store_retries, failover_reads, spec_wins ...) is an opaque
total with no timeline behind it. A :class:`Span` is one named interval
with causal context: the op or job it covers, the worker that ran it,
the namespace/job/attempt it belongs to, and its parent span — the
Dapper shape, sized for this engine.

Design constraints, in order:

- **Determinism.** Span ids derive from ``(worker, ns, job, attempt,
  name, occurrence)`` — no RNG, no wall-clock in the id — so a chaos
  test can COMPUTE the id a failure should have produced and assert
  the errors-stream link resolves (tests/test_trace.py). The clock is
  injectable (the faults/retry.py convention) so virtual-clock tests
  replay exact timelines; lint rule LMR010 keeps every timing read in
  this package on it.
- **Zero data-plane changes.** Spans buffer in-process and flush as
  ordinary store files under the ``_trace.`` name prefix (the
  errors-stream pattern: append-only telemetry, drained by whoever
  collects). Flushes write through the UNWRAPPED innermost store —
  below retry, injection, and the tracing wrappers themselves — so
  telemetry can neither perturb a FaultPlan's schedules nor trace its
  own writes.
- **Invisible when off.** ``active_tracer()`` is None unless a tracer
  is installed (``--trace``) or ``LMR_TRACE`` is set; every engine hook
  is a None-check, and the wrapper layers are simply not stacked —
  tracing-off runs are byte-identical to the unwired seed (the golden
  matrix twin test).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import re
import threading
import time
from typing import Callable, Dict, List, Optional

TRACE_NS = "_trace"            # store-name prefix every flush publishes under

_SAFE_ACTOR = re.compile(r"[^A-Za-z0-9_.\-]")


def span_id(worker, ns, job_id, attempt, name: str, occ: int = 0) -> str:
    """Deterministic 16-hex-char span id. Pure function of the span's
    causal coordinates — chaos tests recompute it to assert an error
    entry links to the span that was live when the fault fired."""
    key = f"{worker}|{ns}|{job_id}|{attempt}|{name}|{occ}"
    return hashlib.blake2b(key.encode("utf-8"), digest_size=8).hexdigest()


class Tracer:
    """Buffered span recorder on an injectable clock.

    One instance serves a whole process (the FaultCounters visibility
    contract): worker threads, the server loop, and the local executor
    all record into one buffer, each under its own thread-local actor
    name. ``flush`` publishes the buffer as one ``_trace.<actor>.<seq>``
    JSON-lines file through a store.
    """

    FLUSH_THRESHOLD = 512       # spans buffered before a soft flush fires

    def __init__(self, clock: Callable[[], float] = time.time,
                 annotate: bool = False):
        self._clock = clock
        self.annotate = annotate     # bridge span names into the torch
        #                              profile (utils/profiling)
        self._lock = threading.Lock()
        self._buf: List[dict] = []
        self._occ: Dict[tuple, int] = {}
        self._flush_seq: Dict[str, int] = {}
        self._tls = threading.local()
        self._iteration = 0     # stamped onto every span ("it"): job
        #                         ids restart per iteration, so the
        #                         collector needs it to keep chains
        #                         from conflating across iterations

    # -- actor / context ----------------------------------------------------

    def set_actor(self, name: Optional[str]) -> None:
        """Declare the calling thread's identity (worker name, "server",
        "local"); span ``worker`` fields default to it."""
        self._tls.actor = name

    def actor(self) -> str:
        return getattr(self._tls, "actor", None) or "proc"

    def set_iteration(self, iteration: int) -> None:
        """Declare the task iteration subsequent spans belong to (the
        engines call this per iteration / per task-doc poll). Plain
        int store — GIL-atomic, and a one-poll skew on a racing thread
        only mislabels spans at the boundary of an already-rolled-over
        namespace."""
        self._iteration = int(iteration)

    def current(self) -> Optional[dict]:
        """The innermost open span on this thread (parent for new ones)."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def clock(self) -> float:
        return self._clock()

    # -- recording ----------------------------------------------------------

    def _mint(self, name: str, worker, ns, job_id, attempt) -> str:
        key = (worker, ns, job_id, attempt, name)
        with self._lock:
            occ = self._occ.get(key, 0)
            self._occ[key] = occ + 1
        return span_id(worker, ns, job_id, attempt, name, occ)

    def _record(self, span: dict) -> None:
        with self._lock:
            self._buf.append(span)

    def _inherit(self, ns, job_id, attempt, parent):
        """Fill unset context from the thread's current open span — the
        ONE inheritance rule (``add`` and ``span`` share it, so a new
        context field cannot drift between op spans and body spans)."""
        cur = self.current()
        if cur is not None:
            if ns is None:
                ns = cur.get("ns")
            if job_id is None:
                job_id = cur.get("job")
            if attempt is None:
                attempt = cur.get("attempt")
            if parent is None:
                parent = cur.get("sid")
        return ns, job_id, attempt, parent

    def add(self, name: str, t0: float, t1: float, *, ns=None, job_id=None,
            attempt=None, parent: Optional[str] = None, worker=None,
            **attrs) -> dict:
        """Record one closed span with explicit times. Context not given
        explicitly is inherited from the thread's current open span."""
        ns, job_id, attempt, parent = self._inherit(ns, job_id, attempt,
                                                    parent)
        worker = worker if worker is not None else self.actor()
        span = {"sid": self._mint(name, worker, ns, job_id, attempt),
                "parent": parent, "name": name, "worker": worker,
                "ns": ns, "job": job_id, "attempt": attempt,
                "it": self._iteration, "t0": t0, "t1": t1}
        if attrs:
            span["attrs"] = attrs
        self._record(span)
        return span

    def op(self, name: str, t0: float, **attrs) -> dict:
        """Record an op span that started at ``t0`` and ends NOW —
        the wrapper layers' one-liner."""
        return self.add(name, t0, self._clock(), **attrs)

    @contextlib.contextmanager
    def span(self, name: str, *, ns=None, job_id=None, attempt=None,
             worker=None, **attrs):
        """Open a span around a ``with`` body. The yielded dict already
        carries its deterministic ``sid`` (error paths link to it before
        the span closes); ``t1`` is stamped on exit, and a body that
        raises gets an ``error`` attr instead of losing the span."""
        ns, job_id, attempt, parent = self._inherit(ns, job_id, attempt,
                                                    None)
        worker = worker if worker is not None else self.actor()
        span = {"sid": self._mint(name, worker, ns, job_id, attempt),
                "parent": parent, "name": name,
                "worker": worker, "ns": ns, "job": job_id,
                "attempt": attempt, "it": self._iteration,
                "t0": self._clock(), "t1": None}
        if attrs:
            span["attrs"] = dict(attrs)
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        stack.append(span)
        ann = None
        if self.annotate:
            # host↔device correlation: the same span name shows up as a
            # record_function row of the torch profile
            # (utils/profiling.annotate), beside the kernels it ran.
            # Enter/exit are guarded: a torn-down profiler session must
            # neither sink the job body (a non-StoreError here would be
            # charged as user code) nor leak the pushed stack entry.
            from lua_mapreduce_tpu_torch.utils.profiling import (
                capturing, maybe_annotate)
            # no profiler range opens inside a CUDA-graph capture: the
            # compiled engines' spans wrap their replays, never a capture
            if not capturing():
                try:
                    ann = maybe_annotate(name)
                    ann.__enter__()
                except Exception:
                    ann = None  # best-effort bridge: drop, never sink
        try:
            yield span
        except BaseException as exc:
            span.setdefault("attrs", {})["error"] = type(exc).__name__
            raise
        finally:
            stack.pop()
            span["t1"] = self._clock()
            self._record(span)
            if ann is not None:
                try:
                    ann.__exit__(None, None, None)
                except Exception:
                    pass        # span already recorded; bridge only

    # -- flush --------------------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return len(self._buf)

    def drain(self) -> List[dict]:
        """Take the buffer without touching a store (tests, collectors
        running in-process)."""
        with self._lock:
            out, self._buf = self._buf, []
            return out

    def flush(self, store, force: bool = True) -> Optional[str]:
        """Publish buffered spans through ``store`` as one JSON-lines
        file ``_trace.<actor>.<seq>``. ``force=False`` is the engines'
        soft cadence: nothing happens below FLUSH_THRESHOLD spans.

        Writes go through the UNWRAPPED innermost store: telemetry must
        not consume FaultPlan occurrences (tracing-on chaos twins stay
        schedule-identical to tracing-off), must not pay retry sleeps,
        and must not trace itself through a TracingStore."""
        with self._lock:
            if not self._buf or (not force
                                 and len(self._buf) < self.FLUSH_THRESHOLD):
                return None
            spans, self._buf = self._buf, []
        from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
        raw = unwrap(store)
        actor = _SAFE_ACTOR.sub("_", self.actor())
        with self._lock:
            seq = self._flush_seq.get(actor, 0)
        name = f"{TRACE_NS}.{actor}.{seq:06d}"
        try:
            # collision probe: a RESTARTED process (resumed server,
            # respawned worker under a fixed --name) starts its counter
            # at 0 again, and builds are atomic OVERWRITING publishes —
            # skipping past existing files keeps the pre-crash
            # timeline instead of silently destroying it
            while raw.exists(name):
                seq += 1
                name = f"{TRACE_NS}.{actor}.{seq:06d}"
            with raw.builder() as b:
                for s in spans:
                    b.write(json.dumps(s, separators=(",", ":"),
                                       default=str) + "\n")
                b.build(name)
        except Exception:
            with self._lock:    # keep the spans; the caller may retry
                self._buf[:0] = spans
            raise
        with self._lock:
            self._flush_seq[actor] = seq + 1
        return name


# --------------------------------------------------------------------------
# process-global install (the faults/wrappers install_fault_plan pattern)
# --------------------------------------------------------------------------

_lock = threading.Lock()
_installed: Optional[Tracer] = None
_generation = 0
_env_tracer: Optional[Tracer] = None

_FALSEY = ("", "0", "off", "false", "no")


def install_tracer(tracer: Optional[Tracer]) -> None:
    """Install (or clear, with None) the process-wide tracer. New store
    and jobstore wrappers built by the router/engines pick it up."""
    global _installed, _generation
    with _lock:
        _installed = tracer
        _generation += 1


def active_tracer() -> Optional[Tracer]:
    """The installed tracer, else one created from ``LMR_TRACE`` (the
    subprocess-fleet channel), else None. The env tracer is memoized —
    one process, one tracer — and deactivates when the variable is
    unset, mirroring the FaultPlan env plumbing."""
    global _env_tracer
    with _lock:
        if _installed is not None:
            return _installed
    import os
    val = (os.environ.get("LMR_TRACE") or "").strip().lower()
    if val in _FALSEY:
        return None
    with _lock:
        if _env_tracer is None:
            _env_tracer = Tracer()
        return _env_tracer


def trace_generation() -> tuple:
    """Wiring-token component: changes whenever the tracing wrapper
    configuration would change (router mem:tag memoization)."""
    import os
    with _lock:
        gen = _generation
    return (gen, os.environ.get("LMR_TRACE") or "")


def utest() -> None:
    """Self-test: deterministic ids, context inheritance, error attrs,
    flush/read round-trip, install plumbing."""
    from lua_mapreduce_tpu_torch.store.memfs import MemStore

    clock_now = [100.0]
    tr = Tracer(clock=lambda: clock_now[0])
    tr.set_actor("w1")
    with tr.span("map.body", ns="map_jobs", job_id=3, attempt=0) as sp:
        clock_now[0] = 101.0
        tr.op("store.build", 100.5, file="result.P0.M3")
    assert sp["t0"] == 100.0 and sp["t1"] == 101.0
    assert sp["sid"] == span_id("w1", "map_jobs", 3, 0, "map.body", 0)
    spans = {s["name"]: s for s in tr.drain()}
    child = spans["store.build"]
    assert child["parent"] == sp["sid"]          # causal link
    assert child["ns"] == "map_jobs" and child["job"] == 3   # inherited
    assert child["attrs"]["file"] == "result.P0.M3"

    # same coordinates twice -> distinct ids via the occurrence counter
    with tr.span("map.body", ns="map_jobs", job_id=3, attempt=0) as sp2:
        pass
    assert sp2["sid"] == span_id("w1", "map_jobs", 3, 0, "map.body", 1)
    assert sp2["sid"] != sp["sid"]

    # a raising body still records its span, tagged with the error
    try:
        with tr.span("reduce.body", ns="red_jobs", job_id=0, attempt=1):
            raise ValueError("boom")
    except ValueError:
        pass
    drained = tr.drain()
    assert drained[-1]["attrs"]["error"] == "ValueError"
    assert drained[-1]["t1"] == clock_now[0]

    # flush/read round-trip through a real store
    store = MemStore()
    tr.op("coord.claim_batch", 99.0, ns="map_jobs")
    name = tr.flush(store)
    assert name and name.startswith(TRACE_NS + ".w1.")
    got = [json.loads(ln) for ln in store.lines(name)]
    assert got[0]["name"] == "coord.claim_batch"
    assert tr.flush(store) is None               # buffer empty
    tr.op("x", 0.0)
    assert tr.flush(store, force=False) is None  # below threshold
    assert tr.pending() == 1

    # restart-collision probe: a FRESH tracer under the same actor
    # (resumed server, respawned worker) must not overwrite the
    # pre-crash flush file — builds are atomic overwriting publishes
    tr_restarted = Tracer(clock=lambda: 200.0)
    tr_restarted.set_actor("w1")
    tr_restarted.op("coord.get_task", 199.0)
    name2 = tr_restarted.flush(store)
    assert name2 != name
    kept = [json.loads(ln) for ln in store.lines(name)]
    assert kept[0]["name"] == "coord.claim_batch"   # survived intact

    # iteration stamping: job ids restart per iteration, so spans
    # carry which iteration they belong to
    tr.set_iteration(3)
    tr.op("y", 1.0)
    assert tr.drain()[-1]["it"] == 3

    # install / active / generation plumbing
    t0 = trace_generation()
    install_tracer(tr)
    try:
        assert active_tracer() is tr
        assert trace_generation() != t0
    finally:
        install_tracer(None)
    import os
    assert (os.environ.get("LMR_TRACE") or active_tracer() is None)
