"""Job-index engine selection: native C++ via ctypes, or pure Python.

Port of ``lua_mapreduce_tpu/coord/idx.py``. The native library (the
port's copy of ``native/jobstore.cpp``) is compiled on first use with
the host ``g++`` into ``build/native/`` (core/native_build.py); if
compilation or loading fails the pure-Python engine (idx_py.py) takes
over — both speak the same on-disk format, also the JAX package's, so
the choice is per-process, not per-cluster.

One deliberate exception to the silent fallback: a native library that
LOADS but whose on-disk layout disagrees with idx_py.py (or that lacks
the ``jsx_abi`` self-description export — only possible for a
hand-placed binary, since the build cache is keyed on a source hash)
RAISES instead of falling back. Both engines write the same index
files, so an ABI drift is corruption, not a degraded mode; delete the
cached .so to rebuild, or set LMR_DISABLE_NATIVE=1 to force Python.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Sequence, Tuple

from lua_mapreduce_tpu_torch.core.constants import MAX_JOB_RETRIES, Status
from lua_mapreduce_tpu_torch.core.native_build import (library_path,
                                                       load_native)
from lua_mapreduce_tpu_torch.coord.idx_py import PyJobIndex

ENGINES = ("auto", "native", "python")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "jobstore.cpp")


def _abi_check(lib: ctypes.CDLL) -> None:
    """Refuse a native engine whose on-disk layout drifted from
    idx_py.py — both engines write the SAME index files, so a mismatch
    would silently corrupt live coordination state. Native builds
    without the export (a stale cached .so from before the guard) are
    rejected the same way: unverifiable is as bad as wrong."""
    from lua_mapreduce_tpu_torch.coord import idx_py
    from lua_mapreduce_tpu_torch.faults.errors import NativeEngineError

    try:
        lib.jsx_abi.restype = ctypes.c_int32
        lib.jsx_abi.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int32)]
    except AttributeError:
        raise NativeEngineError(
            f"native job index {library_path(_SRC)} predates the ABI "
            "guard — rebuild it (delete the cached .so) or set "
            "LMR_DISABLE_NATIVE=1")
    magic = ctypes.create_string_buffer(8)
    sizes = (ctypes.c_int64 * 2)()
    statuses = (ctypes.c_int32 * 6)()
    lib.jsx_abi(magic, sizes, statuses)
    native = (magic.raw, sizes[0], sizes[1], list(statuses))
    python = (idx_py.MAGIC, idx_py.HEADER_SIZE, idx_py.RECORD_SIZE,
              [int(s) for s in Status])
    if native != python:
        raise NativeEngineError(
            "native job index ABI drifted from coord/idx_py.py: native "
            f"{native} vs python {python} — the engines share index "
            "files byte-for-byte and must agree exactly")


def _load() -> Optional[ctypes.CDLL]:
    lib = load_native(_SRC)
    if lib is None or getattr(lib, "_jsx_configured", False):
        return lib
    _abi_check(lib)
    lib._jsx_configured = True
    lib.jsx_insert.restype = ctypes.c_int64
    lib.jsx_insert.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.jsx_count.restype = ctypes.c_int64
    lib.jsx_count.argtypes = [ctypes.c_char_p]
    lib.jsx_claim.restype = ctypes.c_int64
    lib.jsx_claim.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_int64),
                              ctypes.c_int64, ctypes.c_int32]
    lib.jsx_claim_batch.restype = ctypes.c_int64
    lib.jsx_claim_batch.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_int64, ctypes.c_int32,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.c_int64]
    lib.jsx_cas_status_batch.restype = ctypes.c_int64
    lib.jsx_cas_status_batch.argtypes = [ctypes.c_char_p,
                                         ctypes.POINTER(ctypes.c_int64),
                                         ctypes.c_int64, ctypes.c_int32,
                                         ctypes.c_uint32, ctypes.c_int64,
                                         ctypes.POINTER(ctypes.c_int32)]
    lib.jsx_commit_batch.restype = ctypes.c_int64
    lib.jsx_commit_batch.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int64),
                                     ctypes.c_int64, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_double),
                                     ctypes.POINTER(ctypes.c_int32)]
    lib.jsx_set_times.restype = ctypes.c_int
    lib.jsx_set_times.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_double)]
    lib.jsx_heartbeat_batch.restype = ctypes.c_int64
    lib.jsx_heartbeat_batch.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int64),
                                        ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_double]
    lib.jsx_cas_status.restype = ctypes.c_int
    lib.jsx_cas_status.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.c_int32, ctypes.c_uint32,
                                   ctypes.c_int64]
    lib.jsx_get.restype = ctypes.c_int
    lib.jsx_get.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                            ctypes.POINTER(ctypes.c_int32),
                            ctypes.POINTER(ctypes.c_int32),
                            ctypes.POINTER(ctypes.c_int64),
                            ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_int32),
                            ctypes.POINTER(ctypes.c_int64)]
    lib.jsx_speculate.restype = ctypes.c_int
    lib.jsx_speculate.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.jsx_claim_spec.restype = ctypes.c_int64
    lib.jsx_claim_spec.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int32)]
    lib.jsx_cancel_spec.restype = ctypes.c_int
    lib.jsx_cancel_spec.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int64]
    lib.jsx_counts.restype = ctypes.c_int64
    lib.jsx_counts.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_int64)]
    lib.jsx_scavenge.restype = ctypes.c_int64
    lib.jsx_scavenge.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    lib.jsx_requeue_stale.restype = ctypes.c_int64
    lib.jsx_requeue_stale.argtypes = [ctypes.c_char_p, ctypes.c_double]
    lib.jsx_heartbeat.restype = ctypes.c_int
    lib.jsx_heartbeat.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_double]
    lib.jsx_snapshot.restype = ctypes.c_int64
    lib.jsx_snapshot.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.POINTER(ctypes.c_double),
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.c_int64]
    return lib


class NativeJobIndex:
    """ctypes facade over native/jobstore.cpp with PyJobIndex's API."""

    def __init__(self, path: str, lib: ctypes.CDLL):
        self.path = path
        self._p = path.encode()
        self._lib = lib

    def _fail(self, op: str):
        from lua_mapreduce_tpu_torch.faults.errors import NativeIndexError
        raise NativeIndexError(f"{op} failed on {self.path}")

    def insert(self, n: int) -> int:
        r = self._lib.jsx_insert(self._p, n)
        if r < 0:
            self._fail("jsx_insert")
        return r

    def count(self) -> int:
        r = self._lib.jsx_count(self._p)
        if r < 0:
            self._fail("jsx_count")
        return r

    def claim(self, worker: int, now: float,
              preferred: Optional[Sequence[int]] = None,
              steal: bool = True) -> int:
        # ``now`` is taken by the native side's own clock; the arg keeps the
        # engines' signatures identical.
        pref = preferred or ()
        arr = (ctypes.c_int64 * len(pref))(*pref)
        return self._lib.jsx_claim(self._p, worker, arr, len(pref),
                                   1 if steal else 0)

    def claim_batch(self, worker: int, now: float, k: int,
                    preferred: Optional[Sequence[int]] = None,
                    steal: bool = True) -> List[Tuple[int, int]]:
        if k <= 0:
            return []
        pref = preferred or ()
        arr = (ctypes.c_int64 * len(pref))(*pref)
        out_ids = (ctypes.c_int64 * k)()
        out_reps = (ctypes.c_int32 * k)()
        n = self._lib.jsx_claim_batch(self._p, worker, arr, len(pref),
                                      1 if steal else 0, out_ids, out_reps, k)
        if n < 0:
            self._fail("jsx_claim_batch")
        return [(out_ids[i], out_reps[i]) for i in range(n)]

    def cas_status_batch(self, ids: Sequence[int], to: Status,
                         expect_mask: int = 0,
                         expect_worker: int = 0) -> List[bool]:
        if not ids:
            return []
        arr = (ctypes.c_int64 * len(ids))(*ids)
        ok = (ctypes.c_int32 * len(ids))()
        n = self._lib.jsx_cas_status_batch(self._p, arr, len(ids), int(to),
                                           expect_mask, expect_worker, ok)
        if n < 0:
            self._fail("jsx_cas_status_batch")
        return [bool(ok[i]) for i in range(len(ids))]

    def commit_batch(self, entries: Sequence[tuple],
                     worker: int) -> List[bool]:
        if not entries:
            return []
        n = len(entries)
        ids = (ctypes.c_int64 * n)(*[jid for jid, _ in entries])
        flat = []
        for _, times in entries:
            flat.extend(times if times is not None else (0.0,) * 5)
        times_arr = (ctypes.c_double * (n * 5))(*flat)
        ok = (ctypes.c_int32 * n)()
        r = self._lib.jsx_commit_batch(self._p, ids, n, worker, times_arr,
                                       ok)
        if r < 0:
            self._fail("jsx_commit_batch")
        return [bool(ok[i]) for i in range(n)]

    def set_times(self, job_id: int, times: Sequence[float]) -> bool:
        arr = (ctypes.c_double * 5)(*times)
        r = self._lib.jsx_set_times(self._p, job_id, arr)
        if r < 0:
            self._fail("jsx_set_times")
        return bool(r)

    def heartbeat_batch(self, ids: Sequence[int], worker: int,
                        now: float) -> int:
        if not ids:
            return 0
        arr = (ctypes.c_int64 * len(ids))(*ids)
        n = self._lib.jsx_heartbeat_batch(self._p, arr, len(ids), worker, now)
        if n < 0:
            self._fail("jsx_heartbeat_batch")
        return n

    def cas_status(self, job_id: int, to: Status, expect_mask: int = 0,
                   expect_worker: int = 0) -> bool:
        r = self._lib.jsx_cas_status(self._p, job_id, int(to), expect_mask,
                                     expect_worker)
        if r < 0:
            self._fail("jsx_cas_status")
        return bool(r)

    def get(self, job_id: int) -> Optional[tuple]:
        status = ctypes.c_int32()
        reps = ctypes.c_int32()
        worker = ctypes.c_int64()
        started = ctypes.c_double()
        times = (ctypes.c_double * 5)()
        spec_state = ctypes.c_int32()
        spec_worker = ctypes.c_int64()
        r = self._lib.jsx_get(self._p, job_id, ctypes.byref(status),
                              ctypes.byref(reps), ctypes.byref(worker),
                              ctypes.byref(started), times,
                              ctypes.byref(spec_state),
                              ctypes.byref(spec_worker))
        if r < 0:
            self._fail("jsx_get")
        if r == 0:
            return None
        t = tuple(times)
        return (status.value, reps.value, worker.value, started.value,
                None if t == (0.0,) * 5 else t, spec_state.value,
                spec_worker.value)

    def speculate(self, job_id: int) -> bool:
        r = self._lib.jsx_speculate(self._p, job_id)
        if r < 0:
            self._fail("jsx_speculate")
        return bool(r)

    def claim_spec(self, worker: int) -> Optional[Tuple[int, int]]:
        reps = ctypes.c_int32()
        jid = self._lib.jsx_claim_spec(self._p, worker, ctypes.byref(reps))
        if jid <= -2:
            # -1 means "nothing open"; anything below is a real IO
            # failure and must surface classified, not as a silent
            # speculation blackout
            self._fail("jsx_claim_spec")
        return None if jid < 0 else (jid, reps.value)

    def cancel_spec(self, job_id: int, worker: int) -> bool:
        r = self._lib.jsx_cancel_spec(self._p, job_id, worker)
        if r < 0:
            self._fail("jsx_cancel_spec")
        return bool(r)

    def counts(self) -> Dict[Status, int]:
        out = (ctypes.c_int64 * 6)()
        r = self._lib.jsx_counts(self._p, out)
        if r < 0:
            self._fail("jsx_counts")
        return {Status(i): out[i] for i in range(6)}

    def scavenge(self, max_retries: int = MAX_JOB_RETRIES) -> int:
        r = self._lib.jsx_scavenge(self._p, max_retries)
        if r < 0:
            self._fail("jsx_scavenge")
        return r

    def requeue_stale(self, cutoff: float) -> int:
        r = self._lib.jsx_requeue_stale(self._p, cutoff)
        if r < 0:
            self._fail("jsx_requeue_stale")
        return r

    def heartbeat(self, job_id: int, worker: int, now: float) -> bool:
        r = self._lib.jsx_heartbeat(self._p, job_id, worker, now)
        if r < 0:
            self._fail("jsx_heartbeat")
        return bool(r)

    def snapshot(self):
        cap = self.count()
        if cap == 0:
            return []
        statuses = (ctypes.c_int32 * cap)()
        reps = (ctypes.c_int32 * cap)()
        workers = (ctypes.c_int64 * cap)()
        started = (ctypes.c_double * cap)()
        times = (ctypes.c_double * (cap * 5))()
        spec_states = (ctypes.c_int32 * cap)()
        spec_workers = (ctypes.c_int64 * cap)()
        n = self._lib.jsx_snapshot(self._p, statuses, reps, workers,
                                   started, times, spec_states,
                                   spec_workers, cap)
        if n < 0:
            self._fail("jsx_snapshot")
        out = []
        zero = (0.0,) * 5
        for i in range(n):
            t = tuple(times[i * 5:(i + 1) * 5])
            out.append((statuses[i], reps[i], workers[i], started[i],
                        None if t == zero else t, spec_states[i],
                        spec_workers[i]))
        return out


def open_index(path: str, engine: str = "auto"):
    """Open a job index at ``path``.

    engine: "auto" (native if it builds, else python), "native", "python".
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown index engine {engine!r}; use one of "
                         f"{ENGINES}")
    if engine in ("auto", "native"):
        lib = _load()
        if lib is not None:
            return NativeJobIndex(path, lib)
        if engine == "native":
            from lua_mapreduce_tpu_torch.faults.errors import \
                NativeEngineError
            cause = ("LMR_DISABLE_NATIVE=1 is set"
                     if os.environ.get("LMR_DISABLE_NATIVE") == "1"
                     else "g++ build failed")
            raise NativeEngineError(
                f"native job index unavailable ({cause})")
    return PyJobIndex(path)


def native_available() -> bool:
    return _load() is not None
