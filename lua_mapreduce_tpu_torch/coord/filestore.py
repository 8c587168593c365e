"""Shared-directory job store — its persistent-document half.

Port of ``lua_mapreduce_tpu/coord/filestore.py``, trimmed to what
``persistent_table`` needs: each document is a JSON file written
atomically (a temporary file renamed over it), and every
compare-and-swap holds an ``flock`` on the document's lock file, so
processes sharing the directory — a trainer and the trainer that
resumes it after a restart — see one history of commits.
"""

from __future__ import annotations

import fcntl
import json
import os
import tempfile

from lua_mapreduce_tpu_torch.coord.jobstore import JobStore


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
    """Persistent documents under ``root/pt/<name>.json``, their locks
    under ``root/locks/``."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "locks"), exist_ok=True)
        os.makedirs(os.path.join(root, "pt"), exist_ok=True)

    def _lockfile(self, name: str) -> str:
        return os.path.join(self.root, "locks", f"{name}.lock")

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
