"""Pure-Python job-status index over a shared file.

Port of ``lua_mapreduce_tpu/coord/idx_py.py``. The claim protocol's data
structure: a compact binary table of per-job mutable state, mutated only
under an exclusive ``flock`` of the index file, which makes every
operation an atomic compare-and-swap across the processes and hosts
sharing the directory (closing the reference's claim races,
task.lua:300-308).

The on-disk format is the JAX package's, byte for byte, and the native
engine's (``native/jobstore.cpp``, ``idx.py``), so processes of either
package and either engine may share one index file:

    header:  8s magic "JSIX0003" | q record count
    record:  i status | i repetitions | q worker-hash | d started_time
             | d heartbeat | 5d job times (started, finished, written,
             cpu, real; all-zero = not recorded) | q spec-worker-hash
             | i spec_state | i reserved

The two speculation fields carry the duplicate lease: ``spec_state`` 0 =
none, 1 = OPEN (the straggler detector marked this RUNNING job
cloneable), 2 = TAKEN (``spec_worker`` holds the shadow lease). Every
transition that keeps a lease preserves them, those that end it clear
them, and a TAKEN shadow lease's holder counts as an owner, so the
first-commit-wins arbitration is one CAS under the same flock as every
other transition.
"""

from __future__ import annotations

import fcntl
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

from lua_mapreduce_tpu_torch.core.constants import MAX_JOB_RETRIES, Status

MAGIC = b"JSIX0003"
_HEADER = struct.Struct("<8sq")
_REC = struct.Struct("<iiqdddddddqii")
HEADER_SIZE = _HEADER.size       # 16
RECORD_SIZE = _REC.size          # 88
N_TIMES = 5                      # started, finished, written, cpu, real
_ZERO_TIMES = (0.0,) * N_TIMES

_I_SPECW = 10                    # spec-worker hash
_I_SPECS = 11                    # spec_state
SPEC_NONE = 0
SPEC_OPEN = 1                    # detector marked: shadow lease claimable
SPEC_TAKEN = 2                   # a spec-worker holds the shadow lease

# the numbers ARE the wire format shared with the JAX package: a drifted
# struct string must fail here, before any index file is touched
if HEADER_SIZE != 16 or RECORD_SIZE != 88:
    raise ImportError(f"JSIX0003 layout drifted: header {HEADER_SIZE}B, "
                      f"record {RECORD_SIZE}B (must be 16/88)")
if [int(s) for s in Status] != [0, 1, 2, 3, 4, 5]:
    raise ImportError("Status enum drifted from the JSIX0003 record "
                      "encoding (0..5)")

_CLAIM_MASK = (1 << Status.WAITING) | (1 << Status.BROKEN)
_LEASED = (Status.RUNNING, Status.FINISHED)


def worker_tag(worker_hash: int, num_tags: int = 8) -> int:
    """Placement tag of a worker, from its stable name hash: the
    speculative claim PREFERS shadowing a straggler on another tag (a
    degraded rack slows all its members). Unsigned arithmetic so Python
    and C++ (uint64 cast) agree on negative hashes."""
    return (worker_hash & 0xFFFFFFFFFFFFFFFF) % num_tags


class PyJobIndex:
    """One namespace's job index. All methods open/lock/operate/close so
    any number of processes can interleave safely."""

    def __init__(self, path: str):
        self.path = path

    # -- internals ---------------------------------------------------------

    def _open_locked(self, create: bool = False):
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        fd = os.open(self.path, flags, 0o666)
        fcntl.flock(fd, fcntl.LOCK_EX)
        return fd

    @staticmethod
    def _read_count(fd) -> int:
        os.lseek(fd, 0, os.SEEK_SET)
        head = os.read(fd, HEADER_SIZE)
        if len(head) < HEADER_SIZE:
            return 0
        magic, count = _HEADER.unpack(head)
        if magic != MAGIC:
            raise ValueError(f"bad index magic in {head!r}")
        return count

    @staticmethod
    def _write_count(fd, count: int) -> None:
        os.lseek(fd, 0, os.SEEK_SET)
        os.write(fd, _HEADER.pack(MAGIC, count))

    @staticmethod
    def _read_rec(fd, job_id: int) -> tuple:
        os.lseek(fd, HEADER_SIZE + job_id * RECORD_SIZE, os.SEEK_SET)
        return _REC.unpack(os.read(fd, RECORD_SIZE))

    @staticmethod
    def _write_rec(fd, job_id: int, status: int, reps: int, worker: int,
                   started: float, heartbeat: float = 0.0,
                   times: Sequence[float] = _ZERO_TIMES,
                   spec_worker: int = 0, spec_state: int = SPEC_NONE) -> None:
        os.lseek(fd, HEADER_SIZE + job_id * RECORD_SIZE, os.SEEK_SET)
        os.write(fd, _REC.pack(status, reps, worker, started, heartbeat,
                               *times, spec_worker, spec_state, 0))

    @staticmethod
    def _times_of(rec: tuple) -> Optional[Tuple[float, ...]]:
        times = rec[5:5 + N_TIMES]
        return None if times == _ZERO_TIMES else times

    @staticmethod
    def _owner_ok(rec: tuple, expect_worker: int) -> bool:
        """The claimant owns the record; so does a TAKEN shadow lease's
        holder: either may land the one commit, which the status CAS
        arbitrates (first commit wins)."""
        if rec[2] == expect_worker:
            return True
        return (rec[_I_SPECS] == SPEC_TAKEN
                and rec[_I_SPECW] == expect_worker)

    @classmethod
    def _read_all(cls, fd) -> List[tuple]:
        """Every record in ONE read: scan-shaped operations pay one IO
        round trip under the flock."""
        count = cls._read_count(fd)
        if count <= 0:
            return []
        os.lseek(fd, HEADER_SIZE, os.SEEK_SET)
        want = count * RECORD_SIZE
        buf = b""
        while len(buf) < want:
            chunk = os.read(fd, want - len(buf))
            if not chunk:
                break
            buf += chunk
        full = len(buf) - (len(buf) % RECORD_SIZE)
        return list(_REC.iter_unpack(buf[:full]))

    def _rewrite(self, fd, job_id: int, rec: tuple, status: int,
                 reps: int, heartbeat: float, times, keep_spec: bool
                 ) -> None:
        sw, ss = ((rec[_I_SPECW], rec[_I_SPECS]) if keep_spec
                  else (0, SPEC_NONE))
        self._write_rec(fd, job_id, status, reps, rec[2], rec[3],
                        heartbeat, times, sw, ss)

    # -- operations --------------------------------------------------------

    def insert(self, n: int) -> int:
        """Append ``n`` WAITING records; returns the first new id."""
        fd = self._open_locked(create=True)
        try:
            count = self._read_count(fd) if os.fstat(fd).st_size else 0
            for i in range(n):
                self._write_rec(fd, count + i, Status.WAITING, 0, 0, 0.0)
            self._write_count(fd, count + n)
            return count
        finally:
            os.close(fd)

    def count(self) -> int:
        if not os.path.exists(self.path):
            return 0
        fd = self._open_locked()
        try:
            return self._read_count(fd)
        finally:
            os.close(fd)

    def claim(self, worker: int, now: float,
              preferred: Optional[Sequence[int]] = None,
              steal: bool = True) -> int:
        """First WAITING|BROKEN → RUNNING. Returns the claimed id or -1."""
        got = self.claim_batch(worker, now, 1, preferred, steal)
        return got[0][0] if got else -1

    def claim_batch(self, worker: int, now: float, k: int,
                    preferred: Optional[Sequence[int]] = None,
                    steal: bool = True) -> List[Tuple[int, int]]:
        """Claim up to ``k`` WAITING|BROKEN records → RUNNING in ONE
        locked pass. Returns [(job_id, repetitions), ...] in claim order;
        preferred ids first, ``steal=False`` restricts to them."""
        if k <= 0 or not os.path.exists(self.path):
            return []
        fd = self._open_locked()
        try:
            recs = self._read_all(fd)
            count = len(recs)
            out: List[Tuple[int, int]] = []
            taken = set()

            def try_id(jid: int) -> None:
                status, reps = recs[jid][0], recs[jid][1]
                if (1 << status) & _CLAIM_MASK:
                    # fresh claim: fresh silence clock AND fresh times
                    self._write_rec(fd, jid, Status.RUNNING, reps, worker,
                                    now)
                    out.append((jid, reps))
                    taken.add(jid)

            for jid in (preferred or ()):
                if len(out) >= k:
                    break
                if 0 <= jid < count and jid not in taken:
                    try_id(jid)
            if steal:
                for jid in range(count):
                    if len(out) >= k:
                        break
                    if jid not in taken:
                        try_id(jid)
            return out
        finally:
            os.close(fd)

    def cas_status(self, job_id: int, to: Status, expect_mask: int = 0,
                   expect_worker: int = 0) -> bool:
        """Set status iff the current status is in ``expect_mask``
        (bitmask of ``1 << status``; 0 = unconditional) and, when
        ``expect_worker`` is nonzero, the record's owner matches. Moving
        to BROKEN bumps ``repetitions``. A missing index (namespace
        dropped under a straggler) is a False, not an error."""
        return self.cas_status_batch([job_id], to, expect_mask,
                                     expect_worker)[0]

    def cas_status_batch(self, ids: Sequence[int], to: Status,
                         expect_mask: int = 0,
                         expect_worker: int = 0) -> List[bool]:
        """:meth:`cas_status` over many records under ONE flock; per-id
        success flags in input order."""
        out = [False] * len(ids)
        if not ids or not os.path.exists(self.path):
            return out
        fd = self._open_locked()
        try:
            count = self._read_count(fd)
            for i, job_id in enumerate(ids):
                if not (0 <= job_id < count):
                    continue
                rec = self._read_rec(fd, job_id)
                status, reps = rec[0], rec[1]
                if expect_mask and not ((1 << status) & expect_mask):
                    continue
                if expect_worker and not self._owner_ok(rec, expect_worker):
                    continue
                if to == Status.BROKEN:
                    reps += 1
                # leaving the leased states ends any shadow lease
                self._rewrite(fd, job_id, rec, int(to), reps, rec[4],
                              rec[5:5 + N_TIMES],
                              keep_spec=to not in (Status.WAITING,
                                                   Status.BROKEN))
                out[i] = True
            return out
        finally:
            os.close(fd)

    def commit_batch(self, entries: Sequence[tuple],
                     worker: int) -> List[bool]:
        """Retire a batch in ONE flock cycle: for each ``(job_id,
        times5)`` entry, iff the record is RUNNING|FINISHED and
        ``worker`` owns it, write the times into the record and flip it
        WRITTEN. Per-entry success flags in input order."""
        out = [False] * len(entries)
        if not entries or not os.path.exists(self.path):
            return out
        commit_mask = (1 << Status.RUNNING) | (1 << Status.FINISHED)
        fd = self._open_locked()
        try:
            count = self._read_count(fd)
            for i, (job_id, times) in enumerate(entries):
                if not (0 <= job_id < count):
                    continue
                rec = self._read_rec(fd, job_id)
                if not ((1 << rec[0]) & commit_mask):
                    continue
                if worker and not self._owner_ok(rec, worker):
                    continue
                self._rewrite(fd, job_id, rec, Status.WRITTEN, rec[1],
                              rec[4], times or _ZERO_TIMES, keep_spec=True)
                out[i] = True
            return out
        finally:
            os.close(fd)

    def set_times(self, job_id: int, times: Sequence[float]) -> bool:
        """Record a job's times without touching its status."""
        if not os.path.exists(self.path):
            return False
        fd = self._open_locked()
        try:
            if not (0 <= job_id < self._read_count(fd)):
                return False
            rec = self._read_rec(fd, job_id)
            self._rewrite(fd, job_id, rec, rec[0], rec[1], rec[4], times,
                          keep_spec=True)
            return True
        finally:
            os.close(fd)

    def get(self, job_id: int) -> Optional[tuple]:
        """(status, reps, worker, started, times5 | None, spec_state,
        spec_worker) or None when missing/out of bounds."""
        if not os.path.exists(self.path):
            return None
        fd = self._open_locked()
        try:
            if not (0 <= job_id < self._read_count(fd)):
                return None
            rec = self._read_rec(fd, job_id)
            return (rec[0], rec[1], rec[2], rec[3], self._times_of(rec),
                    rec[_I_SPECS], rec[_I_SPECW])
        finally:
            os.close(fd)

    def counts(self) -> Dict[Status, int]:
        out = {s: 0 for s in Status}
        if not os.path.exists(self.path):
            return out
        fd = self._open_locked()
        try:
            for status, *_ in self._read_all(fd):
                out[Status(status)] += 1
            return out
        finally:
            os.close(fd)

    def scavenge(self, max_retries: int = MAX_JOB_RETRIES) -> int:
        if not os.path.exists(self.path):
            return 0
        fd = self._open_locked()
        try:
            n = 0
            for jid, rec in enumerate(self._read_all(fd)):
                if rec[0] == Status.BROKEN and rec[1] >= max_retries:
                    self._rewrite(fd, jid, rec, Status.FAILED, rec[1],
                                  rec[4], rec[5:5 + N_TIMES], keep_spec=True)
                    n += 1
            return n
        finally:
            os.close(fd)

    def requeue_stale(self, cutoff: float) -> int:
        """RUNNING|FINISHED records whose last liveness signal (claim time
        or heartbeat) predates ``cutoff`` → BROKEN (+1 repetition).
        FINISHED is included so a worker killed between its FINISHED and
        WRITTEN transitions cannot wedge the barrier."""
        if not os.path.exists(self.path):
            return 0
        fd = self._open_locked()
        try:
            n = 0
            for jid, rec in enumerate(self._read_all(fd)):
                status, reps, _, st, hb = rec[:5]
                if status in _LEASED and max(st, hb) < cutoff:
                    self._rewrite(fd, jid, rec, Status.BROKEN, reps + 1, hb,
                                  rec[5:5 + N_TIMES], keep_spec=False)
                    n += 1
            return n
        finally:
            os.close(fd)

    def heartbeat(self, job_id: int, worker: int, now: float) -> bool:
        """Refresh a RUNNING|FINISHED record's liveness timestamp iff
        ``worker`` still owns it (0 skips the ownership check)."""
        return self.heartbeat_batch([job_id], worker, now) == 1

    def heartbeat_batch(self, ids: Sequence[int], worker: int,
                        now: float) -> int:
        """:meth:`heartbeat` over many records under ONE flock. Returns
        how many beats landed."""
        if not ids or not os.path.exists(self.path):
            return 0
        fd = self._open_locked()
        try:
            count = self._read_count(fd)
            n = 0
            for job_id in ids:
                if not (0 <= job_id < count):
                    continue
                rec = self._read_rec(fd, job_id)
                if rec[0] not in _LEASED:
                    continue
                if worker and not self._owner_ok(rec, worker):
                    continue
                self._rewrite(fd, job_id, rec, rec[0], rec[1], now,
                              rec[5:5 + N_TIMES], keep_spec=True)
                n += 1
            return n
        finally:
            os.close(fd)

    # -- duplicate leases (speculative execution) --------------------------

    def _spec_rewrite(self, fd, job_id: int, rec: tuple, spec_worker: int,
                      spec_state: int) -> None:
        self._write_rec(fd, job_id, rec[0], rec[1], rec[2], rec[3], rec[4],
                        rec[5:5 + N_TIMES], spec_worker, spec_state)

    def speculate(self, job_id: int) -> bool:
        """Mark a RUNNING record speculation-OPEN, CASed on (RUNNING, no
        speculation yet): repeated detector passes are idempotent and a
        job carries at most one shadow lease."""
        if not os.path.exists(self.path):
            return False
        fd = self._open_locked()
        try:
            if not (0 <= job_id < self._read_count(fd)):
                return False
            rec = self._read_rec(fd, job_id)
            if rec[0] != Status.RUNNING or rec[_I_SPECS] != SPEC_NONE:
                return False
            self._spec_rewrite(fd, job_id, rec, 0, SPEC_OPEN)
            return True
        finally:
            os.close(fd)

    def claim_spec(self, worker: int) -> Optional[Tuple[int, int]]:
        """Take ONE speculation-open shadow lease → (job_id, reps), or
        None. A worker never shadows its own job; records whose claimant
        sits on another placement tag than the claimer come first, lowest
        id first within each class (both engines agree on who wins)."""
        if not os.path.exists(self.path):
            return None
        fd = self._open_locked()
        try:
            recs = self._read_all(fd)
            my_tag = worker_tag(worker)
            candidates = [jid for jid, rec in enumerate(recs)
                          if rec[0] == Status.RUNNING
                          and rec[_I_SPECS] == SPEC_OPEN
                          and rec[2] != worker]
            ordered = ([j for j in candidates
                        if worker_tag(recs[j][2]) != my_tag]
                       + [j for j in candidates
                          if worker_tag(recs[j][2]) == my_tag])
            if not ordered:
                return None
            jid = ordered[0]
            self._spec_rewrite(fd, jid, recs[jid], worker, SPEC_TAKEN)
            return jid, recs[jid][1]
        finally:
            os.close(fd)

    def cancel_spec(self, job_id: int, worker: int) -> bool:
        """Dissolve a shadow lease ``worker`` holds (CASed on TAKEN and the
        holder); ``worker == 0`` clears any OPEN or TAKEN speculation (the
        detector's retraction). Status and repetitions are never
        touched: the original claimant still owns the lease."""
        if not os.path.exists(self.path):
            return False
        fd = self._open_locked()
        try:
            if not (0 <= job_id < self._read_count(fd)):
                return False
            rec = self._read_rec(fd, job_id)
            if worker:
                if rec[_I_SPECS] != SPEC_TAKEN or rec[_I_SPECW] != worker:
                    return False
            elif rec[_I_SPECS] == SPEC_NONE:
                return False
            self._spec_rewrite(fd, job_id, rec, 0, SPEC_NONE)
            return True
        finally:
            os.close(fd)

    def snapshot(self) -> List[tuple]:
        """All records (status, reps, worker, started, times5 | None,
        spec_state, spec_worker) in one locked pass."""
        if not os.path.exists(self.path):
            return []
        fd = self._open_locked()
        try:
            return [rec[:4] + (self._times_of(rec), rec[_I_SPECS],
                               rec[_I_SPECW])
                    for rec in self._read_all(fd)]
        finally:
            os.close(fd)
