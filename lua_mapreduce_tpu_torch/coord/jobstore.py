"""Job store — the coordination backend interface and in-memory engine.

Port of ``lua_mapreduce_tpu/coord/jobstore.py``. The reference
coordinates through MongoDB collections (SURVEY.md §2.6): ``map_jobs`` /
``red_jobs`` job queues claimed by atomically flipping a status field
(task.lua:258-343), a ``task`` singleton document as the orchestrator
checkpoint (task.lua:96-116), an ``errors`` collection (cnn.lua:62-78)
and ``persistent_table`` documents with optimistic timestamps
(persistent_table.lua:41-74). This module defines the same capabilities
as an explicit interface whose claim protocol is an atomic
compare-and-swap, plus speculative duplicate leases (``speculate``,
``claim_spec``, ``cancel_spec``): a straggler's RUNNING job may get ONE
shadow lease, and the first of the two holders to commit wins.
"""

from __future__ import annotations

import abc
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from lua_mapreduce_tpu_torch.core.constants import MAX_JOB_RETRIES, Status

CLAIMABLE = (Status.WAITING, Status.BROKEN)


def make_job(key: Any, value: Any) -> dict:
    """Immutable part of a job document (reference utils.lua:87-98
    ``make_job`` schema; mutable claim state lives in the store index)."""
    return {"key": key, "value": value, "creation_time": time.time()}


class JobStore(abc.ABC):
    """Coordination-plane interface (control plane only — bulk data goes
    through the storage layer, never through the job store)."""

    # -- control-plane round-trip accounting -------------------------------
    #
    # Each claim/commit lock-or-IO cycle through THIS instance bumps a
    # counter: "claim" for claim()/claim_batch() passes, "commit" for
    # status/times writes. In-process pools share one instance, so the
    # server's IterationStats fold sees the whole pool's control traffic;
    # in multi-process pools each process counts its own.

    _rounds_lock = threading.Lock()

    def _bump(self, op: str, n: int = 1) -> None:
        with JobStore._rounds_lock:
            r = getattr(self, "rounds", None)
            if r is None:
                r = self.rounds = {"claim": 0, "commit": 0}
            r[op] = r.get(op, 0) + n

    def round_counts(self) -> Dict[str, int]:
        """Snapshot of {"claim": ..., "commit": ...} round trips so far."""
        with JobStore._rounds_lock:
            return dict(getattr(self, "rounds", None) or
                        {"claim": 0, "commit": 0})

    # -- task singleton (orchestrator checkpoint, task.lua:96-116) ---------

    @abc.abstractmethod
    def put_task(self, doc: dict) -> None: ...

    @abc.abstractmethod
    def get_task(self) -> Optional[dict]: ...

    @abc.abstractmethod
    def update_task(self, fields: dict) -> None: ...

    @abc.abstractmethod
    def delete_task(self) -> None: ...

    # -- job queues (map_jobs / red_jobs analogs) --------------------------

    @abc.abstractmethod
    def insert_jobs(self, ns: str, docs: Sequence[dict]) -> List[int]:
        """Append job docs with status WAITING; returns their ids."""

    @abc.abstractmethod
    def claim(self, ns: str, worker: str,
              preferred_ids: Optional[Sequence[int]] = None,
              steal: bool = True) -> Optional[dict]:
        """Atomically claim one WAITING|BROKEN job → RUNNING for ``worker``
        (a single CAS in place of the reference's update-then-readback,
        task.lua:294-309). ``preferred_ids`` are tried first (the
        map-affinity cache, task.lua:249-292); ``steal=False`` restricts
        the claim to them. Returns the full job doc (with ``_id``,
        ``status``, ``repetitions``) or None."""

    def claim_batch(self, ns: str, worker: str, k: int = 1,
                    preferred_ids: Optional[Sequence[int]] = None,
                    steal: bool = True) -> List[dict]:
        """Atomically claim up to ``k`` WAITING|BROKEN jobs → RUNNING for
        ``worker`` — the batch lease. Per-job semantics equal
        :meth:`claim`'s, and every leased job gets its own liveness
        clock, so :meth:`requeue_stale` judges each batch member alone.
        This default serves stores without a native batch path: k single
        claims. Returns the claimed docs in claim order."""
        out = []
        for _ in range(max(1, k)):
            doc = self.claim(ns, worker, preferred_ids, steal)
            if doc is None:
                break
            out.append(doc)
        return out

    def commit_batch(self, ns: str, worker: str,
                     entries: Sequence[tuple]) -> List[int]:
        """Retire a batch: for each ``(job_id, times)`` entry,
        RUNNING|FINISHED → WRITTEN CASed on ``worker``'s ownership, with
        the job times recorded. Entries whose claim was lost are skipped.
        Returns the job ids whose commit landed."""
        done = []
        for job_id, times in entries:
            if not self.set_job_status(ns, job_id, Status.FINISHED,
                                       expect=(Status.RUNNING,),
                                       expect_worker=worker):
                continue
            if times is not None:
                self.set_job_times(ns, job_id, times)
            self.set_job_status(ns, job_id, Status.WRITTEN,
                                expect=(Status.FINISHED,),
                                expect_worker=worker)
            done.append(job_id)
        return done

    def release_batch(self, ns: str, worker: str,
                      job_ids: Sequence[int]) -> int:
        """Return leased-but-unstarted jobs to the pool: RUNNING→WAITING
        CASed on ownership, WITHOUT bumping repetitions (they never ran).
        Returns how many were released."""
        n = 0
        for job_id in job_ids:
            if self.set_job_status(ns, job_id, Status.WAITING,
                                   expect=(Status.RUNNING,),
                                   expect_worker=worker):
                n += 1
        return n

    def heartbeat_batch(self, ns: str, job_ids: Sequence[int],
                        worker: str) -> int:
        """:meth:`heartbeat` for every leased job of a batch. Returns how
        many beats landed."""
        n = 0
        for job_id in job_ids:
            if self.heartbeat(ns, job_id, worker):
                n += 1
        return n

    @abc.abstractmethod
    def set_job_status(self, ns: str, job_id: int, status: Status,
                       expect: Optional[Sequence[Status]] = None,
                       expect_worker: Optional[str] = None) -> bool:
        """CAS a job's status; bumps ``repetitions`` when moving to BROKEN
        (job.lua:322-342). False if ``expect`` (statuses) or
        ``expect_worker`` (claim ownership) does not match — a worker
        whose claim was requeued and re-claimed must not clobber the new
        claimant's state."""

    @abc.abstractmethod
    def get_job(self, ns: str, job_id: int) -> Optional[dict]: ...

    @abc.abstractmethod
    def jobs(self, ns: str) -> List[dict]: ...

    def job_workers(self, ns: str) -> Dict[int, str]:
        """job id → claiming worker name, for jobs a worker has touched
        (the producer lookup of server.lua:286-289)."""
        out = {}
        for doc in self.jobs(ns):
            if isinstance(doc.get("worker"), str):
                out[int(doc["_id"])] = doc["worker"]
        return out

    @abc.abstractmethod
    def set_job_times(self, ns: str, job_id: int, times: dict) -> None:
        """Record per-job timing for stats (job.lua:117-152)."""

    @abc.abstractmethod
    def counts(self, ns: str) -> Dict[Status, int]:
        """Per-status counts — the server's barrier poll
        (server.lua:186-234)."""

    @abc.abstractmethod
    def scavenge(self, ns: str, max_retries: int = MAX_JOB_RETRIES) -> int:
        """BROKEN jobs with repetitions ≥ max_retries → FAILED
        (server.lua:192-205). Returns how many were failed."""

    @abc.abstractmethod
    def requeue_stale(self, ns: str, older_than_s: float) -> int:
        """RUNNING or FINISHED jobs SILENT for more than ``older_than_s``
        → BROKEN (re-claimable). Silence is measured from the job's last
        liveness signal — its claim or its worker's last
        :meth:`heartbeat` — so a long job whose worker keeps beating is
        never requeued mid-run. Returns the count."""

    def heartbeat(self, ns: str, job_id: int, worker: str) -> bool:
        """Refresh the liveness timestamp of a RUNNING|FINISHED job this
        worker owns — or holds the SHADOW lease of (:meth:`speculate`).
        False when the claim is lost, the job is in another state, or the
        store does not track liveness (this default). It doubles as the
        worker's lease-revocation probe: a False on a lease the worker
        believed live means the other duplicate committed first."""
        return False

    # -- duplicate leases (speculative execution) --------------------------

    def speculate(self, ns: str, job_id: int) -> bool:
        """Mark a RUNNING job speculation-OPEN so one other worker may
        clone its lease via :meth:`claim_spec` — the straggler
        detector's op, CASed on (RUNNING, no speculation yet). The
        original keeps its lease; the one RUNNING|FINISHED → WRITTEN
        transition arbitrates first-commit-wins, and the loser's commit
        is a zero-repetition no-op. Stores without speculation keep this
        default: the detector never launches clones."""
        return False

    def claim_spec(self, ns: str, worker: str) -> Optional[dict]:
        """Take ONE speculation-open shadow lease for ``worker``: the
        cloned job doc (``speculative=True``, ``worker`` = the ORIGINAL
        claimant) or None. A worker never shadows its own job;
        stragglers whose claimant sits on another placement tag (hashed
        from the worker name) come first, lowest id first within each
        class, on every store."""
        return None

    def cancel_spec(self, ns: str, job_id: int, worker: Optional[str]
                    ) -> bool:
        """Dissolve a shadow lease ``worker`` holds — the loser's and the
        failed clone's path; the job's status and repetitions are never
        touched. ``worker=None`` clears any speculation (the detector's
        retraction)."""
        return False

    @abc.abstractmethod
    def drop_ns(self, ns: str) -> None: ...

    # -- fault classification ----------------------------------------------

    def classify(self, exc: BaseException):
        """Transient/permanent verdict for exceptions this store's
        operations can raise (faults/errors.classify_exception)."""
        from lua_mapreduce_tpu_torch.faults.errors import classify_exception
        return classify_exception(exc)

    # -- errors stream (cnn.lua:62-78) -------------------------------------

    @abc.abstractmethod
    def insert_error(self, worker: str, msg: str,
                     info: Optional[dict] = None) -> None:
        """Append to the errors stream. ``info`` carries structured
        post-mortem fields (``exc_class``, ``classification``, job
        context), merged into the entry next to the traceback ``msg``."""

    @abc.abstractmethod
    def drain_errors(self) -> List[dict]: ...

    # -- persistent documents (persistent_table backing) -------------------

    @abc.abstractmethod
    def pt_get(self, name: str) -> Optional[dict]: ...

    @abc.abstractmethod
    def pt_cas(self, name: str, expected_ts: Optional[int], doc: dict) -> bool:
        """Write ``doc`` iff the stored timestamp equals ``expected_ts``
        (None = must not exist). The optimistic-concurrency primitive of
        persistent_table.lua:41-74."""

    @abc.abstractmethod
    def pt_delete(self, name: str) -> None: ...


class MemJobStore(JobStore):
    """In-process store: one lock, plain dicts. The engine for
    single-process elastic pools (server + worker threads)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._task: Optional[dict] = None
        self._jobs: Dict[str, List[dict]] = {}
        self._errors: List[dict] = []
        self._pt: Dict[str, dict] = {}

    # -- task --------------------------------------------------------------

    def put_task(self, doc: dict) -> None:
        with self._lock:
            self._task = dict(doc)

    def get_task(self) -> Optional[dict]:
        with self._lock:
            return dict(self._task) if self._task is not None else None

    def update_task(self, fields: dict) -> None:
        with self._lock:
            if self._task is None:
                from lua_mapreduce_tpu_torch.faults.errors import NoTaskError
                raise NoTaskError("no task document")
            self._task.update(fields)

    def delete_task(self) -> None:
        with self._lock:
            self._task = None

    # -- jobs --------------------------------------------------------------

    def insert_jobs(self, ns: str, docs: Sequence[dict]) -> List[int]:
        with self._lock:
            queue = self._jobs.setdefault(ns, [])
            base = len(queue)
            ids = []
            for i, doc in enumerate(docs):
                d = dict(doc)
                d.update(_id=base + i, status=Status.WAITING, repetitions=0,
                         worker=None, started_time=None, hb_time=None,
                         times=None, spec_state=0, spec_worker=None)
                queue.append(d)
                ids.append(base + i)
            return ids

    def claim(self, ns, worker, preferred_ids=None, steal=True):
        got = self.claim_batch(ns, worker, 1, preferred_ids, steal)
        return got[0] if got else None

    def claim_batch(self, ns, worker, k=1, preferred_ids=None, steal=True):
        self._bump("claim")
        now = time.time()      # one stamp per lease, taken before the lock
        with self._lock:
            queue = self._jobs.get(ns, [])
            out = []

            def try_claim(d):
                if d["status"] in CLAIMABLE and len(out) < k:
                    d["status"] = Status.RUNNING
                    d["worker"] = worker
                    d["started_time"] = now
                    d["hb_time"] = None   # fresh claim, fresh silence clock
                    d["spec_state"] = 0   # no carried shadow lease
                    d["spec_worker"] = None
                    out.append(dict(d))

            for jid in (preferred_ids or ()):
                if 0 <= jid < len(queue):
                    try_claim(queue[jid])
            if steal:
                for d in queue:
                    if len(out) >= k:
                        break
                    try_claim(d)
            return out

    @staticmethod
    def _owner_ok(d: dict, worker: str) -> bool:
        """The claimant owns the job and, while a shadow lease is taken,
        so does the speculative worker — the status CAS arbitrates
        first-commit-wins."""
        return (d["worker"] == worker
                or (d.get("spec_state") == 2
                    and d.get("spec_worker") == worker))

    @staticmethod
    def _clear_spec_on_unlease(d: dict, status: Status) -> None:
        """Leaving the leased states dissolves any shadow lease: a
        re-claimed job must never be committable by a stale clone."""
        if status in (Status.WAITING, Status.BROKEN):
            d["spec_state"] = 0
            d["spec_worker"] = None

    def commit_batch(self, ns, worker, entries):
        self._bump("commit")
        with self._lock:
            queue = self._jobs.get(ns, [])
            done = []
            for job_id, times in entries:
                if not (0 <= job_id < len(queue)):
                    continue
                d = queue[job_id]
                # RUNNING|FINISHED, as the file index does: a job a crashed
                # commit left FINISHED retires instead of waiting for the
                # stale requeue to re-execute completed work
                # a speculative loser fails the status check here (the
                # winner already moved the job to WRITTEN)
                if (d["status"] not in (Status.RUNNING, Status.FINISHED)
                        or not self._owner_ok(d, worker)):
                    continue       # claim lost: the new claimant owns it
                if times is not None:
                    d["times"] = dict(times)
                d["status"] = Status.WRITTEN
                done.append(job_id)
            return done

    def heartbeat_batch(self, ns, job_ids, worker):
        now = time.time()
        with self._lock:
            queue = self._jobs.get(ns, [])
            n = 0
            for job_id in job_ids:
                if not (0 <= job_id < len(queue)):
                    continue
                d = queue[job_id]
                if d["status"] in (Status.RUNNING, Status.FINISHED) \
                        and self._owner_ok(d, worker):
                    d["hb_time"] = now
                    n += 1
            return n

    def set_job_status(self, ns, job_id, status, expect=None,
                       expect_worker=None):
        self._bump("commit")
        with self._lock:
            queue = self._jobs.get(ns, [])
            if not (0 <= job_id < len(queue)):
                return False
            d = queue[job_id]
            if expect is not None and d["status"] not in expect:
                return False
            if expect_worker is not None \
                    and not self._owner_ok(d, expect_worker):
                return False
            if status == Status.BROKEN:
                d["repetitions"] += 1
            d["status"] = status
            self._clear_spec_on_unlease(d, status)
            return True

    def get_job(self, ns, job_id):
        with self._lock:
            queue = self._jobs.get(ns, [])
            return dict(queue[job_id]) if 0 <= job_id < len(queue) else None

    def jobs(self, ns):
        with self._lock:
            return [dict(d) for d in self._jobs.get(ns, [])]

    def set_job_times(self, ns, job_id, times):
        self._bump("commit")
        with self._lock:
            queue = self._jobs.get(ns)
            if queue is not None and 0 <= job_id < len(queue):
                queue[job_id]["times"] = dict(times)
            # dropped namespace (straggler finishing late): ignore

    def counts(self, ns):
        with self._lock:
            out = {s: 0 for s in Status}
            for d in self._jobs.get(ns, []):
                out[d["status"]] += 1
            return out

    def scavenge(self, ns, max_retries=MAX_JOB_RETRIES):
        with self._lock:
            n = 0
            for d in self._jobs.get(ns, []):
                if d["status"] == Status.BROKEN \
                        and d["repetitions"] >= max_retries:
                    d["status"] = Status.FAILED
                    n += 1
            return n

    def requeue_stale(self, ns, older_than_s):
        cutoff = time.time() - older_than_s
        with self._lock:
            n = 0
            for d in self._jobs.get(ns, []):
                live = max(d["started_time"] or 0.0, d.get("hb_time") or 0.0)
                if (d["status"] in (Status.RUNNING, Status.FINISHED) and
                        d["started_time"] is not None and live < cutoff):
                    d["status"] = Status.BROKEN
                    d["repetitions"] += 1
                    # both holders went silent (a clone's beats count as
                    # liveness): the requeue dissolves the shadow lease
                    self._clear_spec_on_unlease(d, Status.BROKEN)
                    n += 1
            return n

    def heartbeat(self, ns, job_id, worker):
        now = time.time()
        with self._lock:
            queue = self._jobs.get(ns, [])
            if not (0 <= job_id < len(queue)):
                return False
            d = queue[job_id]
            if d["status"] not in (Status.RUNNING, Status.FINISHED) \
                    or not self._owner_ok(d, worker):
                return False
            d["hb_time"] = now
            return True

    # -- duplicate leases (speculative execution) --------------------------

    def speculate(self, ns, job_id):
        self._bump("commit")
        with self._lock:
            queue = self._jobs.get(ns, [])
            if not (0 <= job_id < len(queue)):
                return False
            d = queue[job_id]
            if d["status"] != Status.RUNNING or d.get("spec_state"):
                return False
            d["spec_state"] = 1
            d["spec_worker"] = None
            return True

    def claim_spec(self, ns, worker):
        from lua_mapreduce_tpu_torch.coord.filestore import worker_hash
        from lua_mapreduce_tpu_torch.coord.idx_py import worker_tag
        my_tag = worker_tag(worker_hash(worker))
        self._bump("claim")
        with self._lock:
            candidates = [d for d in self._jobs.get(ns, [])
                          if d["status"] == Status.RUNNING
                          and d.get("spec_state") == 1
                          and d["worker"] != worker]
            ordered = ([d for d in candidates
                        if worker_tag(worker_hash(d["worker"])) != my_tag]
                       + [d for d in candidates
                          if worker_tag(worker_hash(d["worker"])) == my_tag])
            if not ordered:
                return None
            d = ordered[0]
            d["spec_state"] = 2
            d["spec_worker"] = worker
            return dict(d, speculative=True)

    def cancel_spec(self, ns, job_id, worker):
        self._bump("commit")
        with self._lock:
            queue = self._jobs.get(ns, [])
            if not (0 <= job_id < len(queue)):
                return False
            d = queue[job_id]
            if worker is not None:
                if d.get("spec_state") != 2 or d.get("spec_worker") != worker:
                    return False
            elif not d.get("spec_state"):
                return False
            d["spec_state"] = 0
            d["spec_worker"] = None
            return True

    def drop_ns(self, ns):
        with self._lock:
            self._jobs.pop(ns, None)

    # -- errors ------------------------------------------------------------

    def insert_error(self, worker, msg, info=None):
        doc = {"worker": worker, "msg": msg, "time": time.time()}
        if info:
            doc.update(info)
        with self._lock:
            self._errors.append(doc)

    def drain_errors(self):
        with self._lock:
            out, self._errors = self._errors, []
            return out

    # -- persistent documents ----------------------------------------------

    def pt_get(self, name):
        with self._lock:
            doc = self._pt.get(name)
            return dict(doc) if doc is not None else None

    def pt_cas(self, name, expected_ts, doc):
        with self._lock:
            cur = self._pt.get(name)
            cur_ts = cur.get("timestamp") if cur is not None else None
            if cur_ts != expected_ts:
                return False
            self._pt[name] = dict(doc)
            return True

    def pt_delete(self, name):
        with self._lock:
            self._pt.pop(name, None)


def utest() -> None:
    """Self-test (reference task.lua:365-367 utest role): the claim /
    status machine on the in-memory store."""
    s = MemJobStore()
    ids = s.insert_jobs("map_jobs", [make_job(f"k{i}", i) for i in range(3)])
    assert ids == [0, 1, 2]
    doc = s.claim("map_jobs", "w1")
    assert doc is not None and doc["status"] == Status.RUNNING
    jid = doc["_id"]
    assert s.set_job_status("map_jobs", jid, Status.FINISHED,
                            expect=(Status.RUNNING,), expect_worker="w1")
    assert not s.set_job_status("map_jobs", jid, Status.WRITTEN,
                                expect=(Status.FINISHED,),
                                expect_worker="other")   # ownership CAS
    assert s.set_job_status("map_jobs", jid, Status.WRITTEN,
                            expect=(Status.FINISHED,), expect_worker="w1")
    c = s.counts("map_jobs")
    assert c[Status.WRITTEN] == 1 and c[Status.WAITING] == 2
    assert len(s.job_workers("map_jobs")) == 1

    # batch lease: claim the remaining two in one pass, commit in one pass
    batch = s.claim_batch("map_jobs", "w2", k=5)
    assert [d["_id"] for d in batch] == [1, 2]
    assert all(d["status"] == Status.RUNNING for d in batch)
    t = {"started": 0.0, "finished": 0.0, "written": 0.0, "cpu": 0.0,
         "real": 0.0}
    assert s.commit_batch("map_jobs", "w2",
                          [(1, t), (2, t)]) == [1, 2]
    assert s.counts("map_jobs")[Status.WRITTEN] == 3
    assert s.round_counts()["claim"] >= 2
