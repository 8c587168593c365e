"""Runtime lock-order sanitizer.

Copy of the JAX package's ``utils/lockcheck.py``, watching this
package's locks against this package's static model. Call
:func:`install` before any of the package's locks exist — before the
package is imported, which means loading this file by path (the package
``__init__`` creates module-level locks) — and read :func:`report` /
:func:`verify` from that same module object.

The static pass (analysis/lockset.py) claims it knows the package's
whole locking plane: every Lock/RLock creation site and every
acquisition order two locks can nest in.  This watchdog makes that
claim falsifiable at runtime — the same static<->dynamic replay
discipline the protocol checker applies to its seeded races, pointed
at the lock plane:

- ``install()`` replaces ``threading.Lock``/``threading.RLock`` with
  site-keyed recording proxies.  Only locks created *inside the
  package* are wrapped (the creation frame decides); stdlib internals —
  Condition's hidden RLock, Event, Queue, ThreadPoolExecutor — get the
  raw factory back, so the overhead rides only on the handful of locks
  the static model actually covers.
- Each proxy keeps a thread-local held stack.  Acquiring B while
  holding A records the directed edge ``site(A) -> site(B)`` (distinct
  sites only: two instances of one creation site are one static label,
  so their mutual order is instance-ambiguous by construction — the
  static model skips those self-edges for exactly the same reason).
- ``verify(static_model)`` replays the observations against
  ``lockset.static_lock_model()``: an observed lock at a site the
  model does not know, an observed order edge the model does not
  contain, or any order between two statically-cyclic labels is a
  violation.

The clock is injectable (``install(clock=...)``): hold-duration
bookkeeping (``max_hold_s`` per site in ``report()``) must be
replay-deterministic under test like every other timing in this
package (LMR010's discipline).

Overhead discipline: the proxy adds one dict-free method hop per
acquire/release.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_real_lock = threading.Lock
_real_rlock = threading.RLock

_installed = False
_clock: Callable[[], float] = time.monotonic

# recorder state, guarded by a RAW lock (never a proxy: the recorder
# must not observe itself)
_state_lock = _real_lock()
_sites: Set[str] = set()
_edges: Set[Tuple[str, str]] = set()
_acquisitions = 0
_site_acquisitions: Dict[str, int] = {}
_max_hold: Dict[str, float] = {}

_tls = threading.local()           # .held: list of site keys, stack order


def _held_stack() -> List[str]:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


def _creation_site() -> Optional[str]:
    """``rel:line`` of the frame creating the lock when it is package
    code; None otherwise.  A creator frame inside threading.py means a
    stdlib internal (Condition's hidden RLock, Event's lock, ...) —
    those are synthesized in the static model and stay raw here."""
    f = sys._getframe(2)
    if f is None or f.f_code.co_filename.endswith("threading.py"):
        return None
    if not {"Lock", "RLock"} & set(f.f_code.co_names):
        # the frame never names a lock factory: C code it called made
        # the lock (numpy's RandomState takes one), which is not the
        # package's and which the static model rightly does not hold
        return None
    fn = os.path.abspath(f.f_code.co_filename)
    if not fn.startswith(_PKG_DIR + os.sep):
        return None
    rel = os.path.relpath(fn, _PKG_DIR).replace(os.sep, "/")
    return f"{rel}:{f.f_lineno}"


class _LockProxy:
    """A recording wrapper around one real lock. Not a subclass — the
    real types are C builtins — but covers the full with/acquire/
    release surface the package uses (LMR001 bans bare acquire outside
    try/finally, so the surface is small and audited)."""

    __slots__ = ("_lock", "site", "_t0")

    def __init__(self, lock, site: str):
        self._lock = lock
        self.site = site
        self._t0 = 0.0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._record_acquire()
        return got

    def release(self) -> None:
        self._record_release()
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def _record_acquire(self) -> None:
        global _acquisitions
        st = _held_stack()
        t = _clock()
        with _state_lock:
            _acquisitions += 1
            _site_acquisitions[self.site] = \
                _site_acquisitions.get(self.site, 0) + 1
            for held in st:
                if held != self.site:
                    _edges.add((held, self.site))
        if not st or st[-1] != self.site:
            self._t0 = t
        st.append(self.site)

    def _record_release(self) -> None:
        st = _held_stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == self.site:
                del st[i]
                break
        if self.site not in st:
            hold = _clock() - self._t0
            with _state_lock:
                if hold > _max_hold.get(self.site, 0.0):
                    _max_hold[self.site] = hold


def _make_factory(real):
    def factory(*a, **kw):
        site = _creation_site()
        lock = real(*a, **kw)
        if site is None:
            return lock                  # stdlib / test-harness lock
        with _state_lock:
            _sites.add(site)
        return _LockProxy(lock, site)
    return factory


def install(clock: Callable[[], float] = time.monotonic) -> None:
    """Patch the Lock/RLock factories and start recording. Idempotent."""
    global _installed, _clock
    if _installed:
        return
    _clock = clock
    threading.Lock = _make_factory(_real_lock)
    threading.RLock = _make_factory(_real_rlock)
    _installed = True


def uninstall() -> None:
    """Restore the real factories (observations are kept for report/
    verify; call reset() to drop them)."""
    global _installed
    threading.Lock = _real_lock
    threading.RLock = _real_rlock
    _installed = False


def reset() -> None:
    global _acquisitions
    with _state_lock:
        _sites.clear()
        _edges.clear()
        _max_hold.clear()
        _site_acquisitions.clear()
        _acquisitions = 0


def report() -> dict:
    """Everything observed so far: creation sites, distinct-site
    acquisition-order edges, acquisition count (in all and per site),
    per-site max hold."""
    with _state_lock:
        return {"sites": sorted(_sites),
                "edges": sorted(_edges),
                "acquisitions": _acquisitions,
                "site_acquisitions": dict(sorted(
                    _site_acquisitions.items())),
                "max_hold_s": dict(sorted(_max_hold.items()))}


def verify(static_model: dict) -> List[str]:
    """Replay observations against ``lockset.static_lock_model()``.
    Returns violation strings (empty = the static model held): a lock
    the model never discovered, an acquisition order it never derived,
    or an observed order between statically-cyclic labels."""
    rep = report()
    locks: Dict[str, str] = static_model.get("locks", {})
    edges = {tuple(e) for e in static_model.get("edges", [])}
    cyclic = set(static_model.get("cyclic", []))
    viol: Set[str] = set()
    for site in rep["sites"]:
        if site not in locks:
            viol.add(f"lock created at unmodeled site {site} — the "
                     f"static pass never discovered it")
    for a, b in rep["edges"]:
        la, lb = locks.get(a), locks.get(b)
        if la is None or lb is None:
            continue                     # already reported above
        if la == lb:
            continue                     # instance-ambiguous self-pair
        if (la, lb) not in edges:
            viol.add(f"unmodeled acquisition order {la} -> {lb} "
                     f"(observed {a} -> {b}) — the static order graph "
                     f"missed this nesting")
        if la in cyclic and lb in cyclic:
            viol.add(f"observed an order between statically-cyclic "
                     f"locks {la} -> {lb} — the deadlock the static "
                     f"pass flagged is reachable")
    return sorted(viol)


def control(static_model: dict) -> Optional[dict]:
    """The negative control of a run: the first observed order between
    two distinct modelled labels, and what :func:`verify` says against
    the model with that one edge taken out (it must name the edge).
    None when the run observed no such order."""
    locks: Dict[str, str] = static_model.get("locks", {})
    for a, b in report()["edges"]:
        la, lb = locks.get(a), locks.get(b)
        if la is None or lb is None or la == lb:
            continue
        cut = dict(static_model, edges=[e for e in static_model["edges"]
                                        if list(e) != [la, lb]])
        return {"edge": [la, lb], "violations": verify(cut)}
    return None


def main(argv: Optional[List[str]] = None) -> int:
    """``python lua_mapreduce_tpu_torch/utils/lockcheck.py REPORT
    MODULE:FUNC [ARG ...]``: install the sanitizer, then import MODULE
    and call ``FUNC([ARG ...])`` under it, then check what was observed
    against the package's static model and write REPORT (JSON): FUNC's
    return value (``result``), :func:`report`, :func:`verify`'s
    violations, the negative :func:`control`, the model's size and the
    seconds of the run and of the model. Run by path, so the sanitizer
    is in place before the package's first lock exists; the exit code
    is 0 unless FUNC raised."""
    import importlib
    import json

    argv = sys.argv[1:] if argv is None else argv
    out_path, target, args = argv[0], argv[1], argv[2:]
    install()
    t0 = time.perf_counter()
    mod_name, _, fn_name = target.partition(":")
    result = getattr(importlib.import_module(mod_name), fn_name)(args)
    run_s = time.perf_counter() - t0
    uninstall()           # stop recording before the analyzer runs
    from lua_mapreduce_tpu_torch.analysis.lockset import static_lock_model
    t1 = time.perf_counter()
    model = static_lock_model()
    out = {"result": result, "report": report(),
           "violations": verify(model), "control": control(model),
           "model": {"sites": len(model["locks"]),
                     "edges": len(model["edges"]),
                     "cyclic": model["cyclic"],
                     "labels": model["locks"]},
           "run_s": run_s, "model_s": time.perf_counter() - t1}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1, default=str)
    return 0


def utest() -> None:
    """Self-test: package-site locks are wrapped and recorded, stdlib
    creations are not, edges replay against a model, and verify flags
    both an unknown site and an unknown order."""
    assert threading.Lock is _real_lock or not _installed
    now = [0.0]
    install(clock=lambda: now[0])
    try:
        reset()
        a = threading.Lock()
        b = threading.RLock()
        assert isinstance(a, _LockProxy) and isinstance(b, _LockProxy)
        assert a.site.startswith("utils/lockcheck.py:"), a.site
        # Condition's internal RLock is created inside threading.py:
        # raw, invisible, zero overhead
        cond = threading.Condition()
        assert not isinstance(cond._lock, _LockProxy)
        with a:
            now[0] += 0.25
            with b:
                pass
        rep = report()
        assert rep["acquisitions"] == 2
        assert rep["edges"] == [(a.site, b.site)], rep
        assert rep["max_hold_s"][a.site] >= 0.25
        model = {"locks": {a.site: "A", b.site: "B"},
                 "edges": [["A", "B"]], "cyclic": []}
        assert verify(model) == [], verify(model)
        # reversed nesting: an order the model does not contain
        with b:
            with a:
                pass
        bad = verify(model)
        assert any("unmodeled acquisition order B -> A" in v
                   for v in bad), bad
        # a lock at a site the model never saw
        reset()
        c = threading.Lock()
        with c:
            pass
        bad = verify(model)
        assert any("unmodeled site" in v for v in bad), bad
        # statically-cyclic labels observed in any order = violation
        model2 = {"locks": {a.site: "A", b.site: "B"},
                  "edges": [["A", "B"], ["B", "A"]],
                  "cyclic": ["A", "B"]}
        reset()
        with a:
            with b:
                pass
        bad = verify(model2)
        assert any("statically-cyclic" in v for v in bad), bad
        reset()
    finally:
        uninstall()
    assert threading.Lock is _real_lock
    # the real package model is self-consistent: every modeled site
    # parses and no label is cyclic (the package ships deadlock-free)
    from lua_mapreduce_tpu_torch.analysis.lockset import static_lock_model
    model = static_lock_model()
    assert model["locks"] and not model["cyclic"]
    print("lockcheck utest ok")


if __name__ == "__main__":
    # run by path: this file is the module the package would import, so
    # later imports of it get this object; the repo root replaces this
    # file's directory on the import path
    sys.modules["lua_mapreduce_tpu_torch.utils.lockcheck"] = \
        sys.modules[__name__]
    sys.path[0] = os.path.dirname(_PKG_DIR)
    sys.exit(main())
