"""Shared-directory job store for multi-process pools.

Port of ``lua_mapreduce_tpu/coord/filestore.py``: a directory every
participant can reach. Mutable claim state lives in the binary job index
(``idx.py`` — the native C++ engine or ``idx_py.py``, both flock-CAS,
one format); immutable payloads, the task singleton, the
errors stream and persistent-table documents are JSON files written
atomically (a temporary file renamed over the target). The layout is the
JAX package's, so a port process and a JAX-package process can share
one directory — each claims and commits the jobs the other inserted.

Write discipline per namespace: only the server inserts jobs, and
payload batches land *before* their index records become claimable, so
a worker that wins a claim always finds its payload. Claims append
``jid\\tworker`` lines to the namespace's claim log (``workers.log``,
last entry per job wins). Everything multi-writer goes through a flock
or the index CAS.
"""

from __future__ import annotations

import copy
import fcntl
import hashlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from lua_mapreduce_tpu_torch.core.constants import (MAX_JOB_RETRIES,
                                                    MAX_PENDING_INSERTS,
                                                    Status)
from lua_mapreduce_tpu_torch.coord.idx import open_index
from lua_mapreduce_tpu_torch.coord.jobstore import JobStore


def worker_hash(worker: str) -> int:
    """Stable int64 id for a worker name (index records store integers)."""
    h = hashlib.blake2b(worker.encode(), digest_size=8).digest()
    return int.from_bytes(h, "little", signed=True)


# job-times field order in the index record
TIMES_KEYS = ("started", "finished", "written", "cpu", "real")


def _times5(times: Optional[dict]):
    if not times:
        return None
    return tuple(float(times.get(k) or 0.0) for k in TIMES_KEYS)


def _times_doc(t5) -> Optional[dict]:
    return dict(zip(TIMES_KEYS, t5)) if t5 is not None else None


def _atomic_write_json(path: str, doc) -> None:
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp.")
    with os.fdopen(fd, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def _read_text(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return None


class _FLock:
    def __init__(self, path: str):
        self._path = path

    def __enter__(self):
        self._fd = os.open(self._path, os.O_RDWR | os.O_CREAT, 0o666)
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        os.close(self._fd)


class FileJobStore(JobStore):
    """Job queues under ``root/<ns>.idx`` + ``root/<ns>.d/``, the task
    document ``root/task.json``, the errors stream
    ``root/errors.jsonl``, persistent documents under ``root/pt/``, their
    locks under ``root/locks/``. ``engine`` picks the job-index engine
    (``coord/idx.py``: "auto" = native if it builds, else python;
    "native" raises when the library is unavailable)."""

    def __init__(self, root: str, engine: str = "auto"):
        open_index(root, engine)       # raises for an unknown engine
        self.root = root
        self.engine = engine
        os.makedirs(os.path.join(root, "locks"), exist_ok=True)
        os.makedirs(os.path.join(root, "pt"), exist_ok=True)
        # per-namespace payload-batch cache: ns -> (generation, batches).
        # Batches are immutable once written; a new generation token
        # (written by insert_jobs) forces a rescan
        self._batches: Dict[str, tuple] = {}
        # parsed claim-log cache: ns -> ((size, mtime_ns), {jid: name})
        self._wlogs: Dict[str, tuple] = {}

    # -- paths -------------------------------------------------------------

    def _idx(self, ns: str):
        return open_index(os.path.join(self.root, f"{ns}.idx"), self.engine)

    def _ns_dir(self, ns: str) -> str:
        d = os.path.join(self.root, f"{ns}.d")
        os.makedirs(d, exist_ok=True)
        return d

    def _wlog(self, ns: str) -> str:
        return os.path.join(self._ns_dir(ns), "workers.log")

    def _read_wlog(self, ns: str) -> Dict[int, str]:
        """The parsed claim log, cached on (size, mtime). Callers treat
        the returned dict as read-only."""
        path = self._wlog(ns)
        try:
            st = os.stat(path)
            sig = (st.st_size, st.st_mtime_ns)
        except OSError:
            return {}
        cached = self._wlogs.get(ns)
        if cached is not None and cached[0] == sig:
            return cached[1]
        out: Dict[int, str] = {}
        try:
            with open(path) as f:
                for line in f:
                    jid, sep, name = line.rstrip("\n").partition("\t")
                    if sep and name:
                        try:
                            out[int(jid)] = name
                        except ValueError:
                            continue
        except OSError:
            return out
        self._wlogs[ns] = (sig, out)
        return out

    def _append_wlog(self, ns: str, jids, worker: str) -> None:
        """One O_APPEND write per lease (small appends are atomic)."""
        try:
            payload = "".join(f"{jid}\t{worker}\n" for jid in jids)
            fd = os.open(self._wlog(ns),
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o666)
            try:
                os.write(fd, payload.encode())
            finally:
                os.close(fd)
        except OSError:
            pass  # observability only

    def _lockfile(self, name: str) -> str:
        return os.path.join(self.root, "locks", f"{name}.lock")

    # -- task singleton ----------------------------------------------------

    def put_task(self, doc: dict) -> None:
        with _FLock(self._lockfile("task")):
            _atomic_write_json(os.path.join(self.root, "task.json"), doc)

    def get_task(self) -> Optional[dict]:
        return _read_json(os.path.join(self.root, "task.json"))

    def update_task(self, fields: dict) -> None:
        with _FLock(self._lockfile("task")):
            path = os.path.join(self.root, "task.json")
            doc = _read_json(path)
            if doc is None:
                from lua_mapreduce_tpu_torch.faults.errors import NoTaskError
                raise NoTaskError("no task document")
            doc.update(fields)
            _atomic_write_json(path, doc)

    def delete_task(self) -> None:
        with _FLock(self._lockfile("task")):
            try:
                os.remove(os.path.join(self.root, "task.json"))
            except FileNotFoundError:
                pass

    # -- jobs --------------------------------------------------------------

    def insert_jobs(self, ns: str, docs: Sequence[dict]) -> List[int]:
        """Insert a batch of job payloads, then make them claimable.

        Payloads go into ONE manifest file per MAX_PENDING_INSERTS jobs
        (the reference buffers inserts the same way, cnn.lua:80-111);
        manifests land before ``idx.insert`` flips the records claimable.
        """
        idx = self._idx(ns)
        base = idx.count()
        docs = list(docs)
        # clear manifests left by a crash between a previous manifest
        # write and its idx.insert: a duplicate-base survivor would
        # shadow this insert's payloads for readers
        d = self._ns_dir(ns)
        fresh = {os.path.basename(self._batch_path(
            ns, base + off, len(docs[off:off + MAX_PENDING_INSERTS])))
            for off in range(0, len(docs), MAX_PENDING_INSERTS)}
        for name in os.listdir(d):
            if (name.startswith("b") and name.endswith(".json")
                    and name not in fresh):
                try:
                    stale_base = int(name[1:-5].split("_")[0])
                except ValueError:
                    continue
                if stale_base >= base:
                    try:
                        os.remove(os.path.join(d, name))
                    except FileNotFoundError:
                        pass
        for off in range(0, len(docs), MAX_PENDING_INSERTS):
            chunk = docs[off:off + MAX_PENDING_INSERTS]
            _atomic_write_json(self._batch_path(ns, base + off, len(chunk)),
                               chunk)
        # new generation AFTER the manifests land, BEFORE the records
        # become claimable: a worker that wins a claim sees fresh payloads
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=".tmp.gen.")
        with os.fdopen(fd, "w") as f:
            f.write(f"{time.time_ns()}.{base}.{len(docs)}")
        os.replace(tmp, self._gen_path(ns))
        got = idx.insert(len(docs))
        if got != base:
            from lua_mapreduce_tpu_torch.faults.errors import \
                ConcurrentInsertError
            raise ConcurrentInsertError(
                f"concurrent insert into {ns!r}: expected base {base}, got "
                f"{got} — a namespace has exactly one inserter (the server)")
        return list(range(base, base + len(docs)))

    def _batch_path(self, ns: str, base: int, count: int) -> str:
        return os.path.join(self._ns_dir(ns), f"b{base}_{count}.json")

    def _gen_path(self, ns: str) -> str:
        return os.path.join(self.root, f"{ns}.gen")

    def _resolve_batches(self, ns: str) -> list:
        """The namespace's batch list [(base, docs), ...], cached against
        the generation token (read BEFORE the rescan, so a raced token
        only forces one extra rescan later). Duplicate bases resolve to
        the newest file."""
        stamp = _read_text(self._gen_path(ns))
        cached = self._batches.get(ns)
        if cached is not None and cached[0] == stamp:
            return cached[1]
        entries: Dict[int, tuple] = {}
        d = self._ns_dir(ns)
        for name in os.listdir(d):
            if name.startswith("b") and name.endswith(".json"):
                try:
                    b = int(name[1:-5].split("_")[0])
                except ValueError:
                    continue
                path = os.path.join(d, name)
                loaded = _read_json(path)
                if loaded is None:
                    continue
                try:
                    mtime = os.stat(path).st_mtime_ns
                except OSError:
                    mtime = 0
                prev = entries.get(b)
                if prev is None or mtime >= prev[0]:
                    entries[b] = (mtime, loaded)
        batches = sorted((b, docs) for b, (_, docs) in entries.items())
        self._batches[ns] = (stamp, batches)
        return batches

    @staticmethod
    def _lookup_payload(batches: list, jid: int) -> Optional[dict]:
        for base, docs in batches:
            if base <= jid < base + len(docs):
                return docs[jid - base]
        return None

    def _payload(self, batches: list, jid: int) -> dict:
        """One job's payload, DEEP-copied: the cache stays pristine when a
        caller (a mapfn mutating its value in place) edits the doc."""
        return copy.deepcopy(self._lookup_payload(batches, jid)) or {}

    def claim(self, ns, worker, preferred_ids=None, steal=True):
        got = self.claim_batch(ns, worker, 1, preferred_ids, steal)
        return got[0] if got else None

    def claim_batch(self, ns, worker, k=1, preferred_ids=None, steal=True):
        """Lease up to k jobs in ONE locked index pass plus ONE claim-log
        append; the docs are built from the claim's return and the
        payload cache."""
        self._bump("claim")
        now = time.time()
        claimed = self._idx(ns).claim_batch(worker_hash(worker), now, k,
                                            preferred_ids, steal)
        if not claimed:
            return []
        self._append_wlog(ns, [jid for jid, _ in claimed], worker)
        batches = self._resolve_batches(ns)
        docs = []
        for jid, reps in claimed:
            doc = self._payload(batches, jid)
            doc.update(_id=jid, status=Status.RUNNING, repetitions=reps,
                       worker=worker, started_time=now, times=None)
            docs.append(doc)
        return docs

    def commit_batch(self, ns, worker, entries):
        """Retire a batch in ONE flock cycle: status and job times land
        together in each index record, CASed on ownership per entry."""
        entries = [(jid, _times5(times)) for jid, times in entries]
        if not entries:
            return []
        self._bump("commit")
        ok = self._idx(ns).commit_batch(entries, worker_hash(worker))
        return [jid for (jid, _), o in zip(entries, ok) if o]

    def release_batch(self, ns, worker, job_ids):
        """RUNNING→WAITING for leased-but-unstarted jobs, one flock."""
        if not job_ids:
            return 0
        self._bump("commit")
        ok = self._idx(ns).cas_status_batch(list(job_ids), Status.WAITING,
                                            1 << int(Status.RUNNING),
                                            worker_hash(worker))
        return sum(ok)

    def heartbeat_batch(self, ns, job_ids, worker):
        if not job_ids:
            return 0
        return self._idx(ns).heartbeat_batch(list(job_ids),
                                             worker_hash(worker),
                                             time.time())

    def set_job_status(self, ns, job_id, status, expect=None,
                       expect_worker=None):
        self._bump("commit")
        mask = 0
        if expect is not None:
            for s in expect:
                mask |= 1 << int(s)
        whash = worker_hash(expect_worker) if expect_worker else 0
        return self._idx(ns).cas_status(job_id, status, mask, whash)

    def _doc(self, ns, jid, state, batches, wnames) -> dict:
        status, reps, whash, started, t5, spec_state, spec_whash = state
        doc = self._payload(batches, jid)
        doc.update(_id=jid, status=Status(status), repetitions=reps,
                   worker=wnames.get(jid, whash or None),
                   started_time=started or None, times=_times_doc(t5),
                   spec_state=spec_state, spec_worker=spec_whash or None)
        return doc

    def get_job(self, ns, job_id):
        state = self._idx(ns).get(job_id)
        if state is None:
            return None
        return self._doc(ns, job_id, state, self._resolve_batches(ns),
                         self._read_wlog(ns))

    def jobs(self, ns):
        """One locked index pass, one batch resolution and one claim-log
        read for the whole snapshot."""
        batches = self._resolve_batches(ns)
        wnames = self._read_wlog(ns)
        return [self._doc(ns, jid, state, batches, wnames)
                for jid, state in enumerate(self._idx(ns).snapshot())]

    def job_workers(self, ns):
        """id → worker from the claim log alone (one file read)."""
        return dict(self._read_wlog(ns))

    def set_job_times(self, ns, job_id, times):
        self._bump("commit")
        t5 = _times5(dict(times))
        if t5 is not None:
            # a dropped namespace (straggler finishing late) is a no-op
            self._idx(ns).set_times(job_id, t5)

    def counts(self, ns):
        return self._idx(ns).counts()

    def scavenge(self, ns, max_retries=MAX_JOB_RETRIES):
        return self._idx(ns).scavenge(max_retries)

    def requeue_stale(self, ns, older_than_s):
        return self._idx(ns).requeue_stale(time.time() - older_than_s)

    def heartbeat(self, ns, job_id, worker):
        return self._idx(ns).heartbeat(job_id, worker_hash(worker),
                                       time.time())

    # -- duplicate leases (speculative execution) --------------------------

    def speculate(self, ns, job_id):
        self._bump("commit")
        return bool(self._idx(ns).speculate(job_id))

    def claim_spec(self, ns, worker):
        self._bump("claim")
        got = self._idx(ns).claim_spec(worker_hash(worker))
        if got is None:
            return None
        jid, reps = got
        # the clone doc carries the ORIGINAL claimant as ``worker`` (the
        # claim log's last entry — claim_spec never appends to it, so
        # producer lookups keep naming the original)
        doc = self._payload(self._resolve_batches(ns), jid)
        doc.update(_id=jid, status=Status.RUNNING, repetitions=reps,
                   worker=self._read_wlog(ns).get(jid), times=None,
                   spec_state=2, spec_worker=worker, speculative=True)
        return doc

    def cancel_spec(self, ns, job_id, worker):
        self._bump("commit")
        return bool(self._idx(ns).cancel_spec(
            job_id, worker_hash(worker) if worker is not None else 0))

    def drop_ns(self, ns):
        self._batches.pop(ns, None)
        self._wlogs.pop(ns, None)
        for stale in (f"{ns}.idx", f"{ns}.gen"):
            try:
                os.remove(os.path.join(self.root, stale))
            except FileNotFoundError:
                pass
        d = os.path.join(self.root, f"{ns}.d")
        if os.path.isdir(d):
            for f in os.listdir(d):
                try:
                    os.remove(os.path.join(d, f))
                except FileNotFoundError:
                    pass
            os.rmdir(d)

    # -- errors ------------------------------------------------------------

    def insert_error(self, worker, msg, info=None):
        doc = {"worker": worker, "msg": msg, "time": time.time()}
        if info:
            doc.update(info)
        line = json.dumps(doc)
        with _FLock(self._lockfile("errors")):
            with open(os.path.join(self.root, "errors.jsonl"), "a") as f:
                f.write(line + "\n")

    def drain_errors(self):
        path = os.path.join(self.root, "errors.jsonl")
        with _FLock(self._lockfile("errors")):
            try:
                with open(path) as f:
                    lines = f.readlines()
                os.remove(path)
            except FileNotFoundError:
                return []
        return [json.loads(l) for l in lines if l.strip()]

    # -- persistent documents ----------------------------------------------

    def _pt_path(self, name: str) -> str:
        return os.path.join(self.root, "pt", f"{name}.json")

    def pt_get(self, name):
        return _read_json(self._pt_path(name))

    def pt_cas(self, name, expected_ts, doc):
        with _FLock(self._lockfile(f"pt_{name}")):
            cur = _read_json(self._pt_path(name))
            cur_ts = cur.get("timestamp") if cur is not None else None
            if cur_ts != expected_ts:
                return False
            _atomic_write_json(self._pt_path(name), doc)
            return True

    def pt_delete(self, name):
        with _FLock(self._lockfile(f"pt_{name}")):
            try:
                os.remove(self._pt_path(name))
            except FileNotFoundError:
                pass
