"""Installable ``google.cloud.storage`` lookalike with fault injection.

Copy of the JAX package's ``store/fake_gcs.py``: an in-memory bucket
implementing exactly the blob surface ObjectStore's ``gs://`` branch
consumes — whole-object upload/download, RANGED download (inclusive
``end``, GCS's contract), metadata size, list/exists/delete — plus
failures scheduled per operation (503 ServiceUnavailable or timeouts),
so retry behaviour is testable with no network.

Usage::

    from lua_mapreduce_tpu_torch.store.fake_gcs import (install_fake_gcs,
                                                        uninstall_fake_gcs)
    mods = install_fake_gcs(faults={"download": [1, 3]})  # 1st+3rd fail 503
    try:
        store = ObjectStore("gs://bkt/prefix")   # talks to the fake
        ...
    finally:
        uninstall_fake_gcs(mods)

Fault schedules: ``faults`` maps an op name — ``upload``, ``download``
(whole AND ranged), ``size``, ``list``, ``exists``, ``delete`` — to
either an int N (the first N calls fail) or an iterable of 1-based call
indices. ``fault_kind`` picks the failure shape: ``"503"`` (an
exception with ``code = 503``) or ``"timeout"`` (a ``TimeoutError``
subclass). Both packages' fakes install into the same ``sys.modules``
entries: an ObjectStore talks to whichever tree is installed when it is
built.
"""

from __future__ import annotations

import sys
import threading
import types
from typing import Dict, Iterable, Optional, Union

_OPS = ("upload", "download", "size", "list", "exists", "delete")


class ServiceUnavailable(Exception):
    """google.api_core-shaped 503: classified transient via ``code``."""

    code = 503


class FakeGcsTimeout(TimeoutError):
    """Deadline-shaped failure: classified transient by the taxonomy."""


class FaultSchedule:
    """Deterministic per-op failure schedule with a thread-safe call
    counter — the injectable part of the harness."""

    def __init__(self, faults: Optional[Dict[str, Union[int,
                                                        Iterable[int]]]] = None,
                 fault_kind: str = "503"):
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self._sched: Dict[str, set] = {}
        self.kind = fault_kind
        self.fired: Dict[str, int] = {}
        for op, spec in (faults or {}).items():
            if op not in _OPS:
                raise ValueError(f"unknown fake-gcs op {op!r}; use {_OPS}")
            if isinstance(spec, int):
                self._sched[op] = set(range(1, spec + 1))
            else:
                self._sched[op] = {int(i) for i in spec}

    def check(self, op: str) -> None:
        with self._lock:
            k = self._calls[op] = self._calls.get(op, 0) + 1
            fire = k in self._sched.get(op, ())
            if fire:
                self.fired[op] = self.fired.get(op, 0) + 1
        if not fire:
            return
        if self.kind == "timeout":
            raise FakeGcsTimeout(f"injected timeout on {op} (call {k})")
        raise ServiceUnavailable(f"injected 503 on {op} (call {k})")


class _FakeBlob:
    def __init__(self, bucket: "_FakeBucket", name: str):
        self._bucket, self._name = bucket, name

    @property
    def _faults(self) -> FaultSchedule:
        return self._bucket._client.faults

    def upload_from_string(self, data):
        self._faults.check("upload")
        if isinstance(data, str):
            data = data.encode()
        self._bucket._objects[self._name] = bytes(data)

    def download_as_bytes(self, start=None, end=None):
        self._faults.check("download")
        data = self._bucket._objects[self._name]
        if start is None:
            return data
        if start >= len(data):
            raise ValueError("RequestRangeNotSatisfiable")  # GCS 416
        return data[start:(end + 1) if end is not None else None]

    @property
    def size(self):
        return len(self._bucket._objects[self._name])

    def exists(self):
        self._faults.check("exists")
        return self._name in self._bucket._objects

    def delete(self):
        self._faults.check("delete")
        del self._bucket._objects[self._name]


class _FakeBucket:
    def __init__(self, client: "FakeGcsClient"):
        self._client = client
        self._objects: Dict[str, bytes] = {}

    def blob(self, key: str) -> _FakeBlob:
        return _FakeBlob(self, key)

    def get_blob(self, key: str) -> Optional[_FakeBlob]:
        self._client.faults.check("size")
        return _FakeBlob(self, key) if key in self._objects else None

    def list_blobs(self, prefix=None):
        self._client.faults.check("list")
        names = sorted(self._objects)
        if prefix:
            names = [n for n in names if n.startswith(prefix)]
        return [types.SimpleNamespace(name=n) for n in names]


class FakeGcsClient:
    """``google.cloud.storage.Client`` stand-in. Buckets and the fault
    schedule are CLASS-level so every ObjectStore built while the fake
    is installed shares one world — exactly how one GCS project
    behaves."""

    _buckets: Dict[str, _FakeBucket] = {}
    faults: FaultSchedule = FaultSchedule()

    def bucket(self, name: str) -> _FakeBucket:
        b = FakeGcsClient._buckets.get(name)
        if b is None:
            b = FakeGcsClient._buckets[name] = _FakeBucket(self)
        else:
            b._client = self
        return b

    @classmethod
    def reset(cls, faults: Optional[dict] = None,
              fault_kind: str = "503") -> None:
        cls._buckets = {}
        cls.faults = FaultSchedule(faults, fault_kind)


def fake_module_tree() -> list:
    """The ``google.cloud.storage`` lookalike as ``(name, module)``
    entries for ``sys.modules`` — ONE canonical layout, shared by
    :func:`install_fake_gcs` and pytest fixtures (which register the
    same entries via ``monkeypatch.setitem`` for scoped teardown)."""
    storage_mod = types.ModuleType("google.cloud.storage")
    storage_mod.Client = FakeGcsClient
    cloud_mod = types.ModuleType("google.cloud")
    cloud_mod.storage = storage_mod
    google_mod = types.ModuleType("google")
    google_mod.cloud = cloud_mod
    return [("google", google_mod), ("google.cloud", cloud_mod),
            ("google.cloud.storage", storage_mod)]


def install_fake_gcs(faults: Optional[dict] = None,
                     fault_kind: str = "503") -> dict:
    """Insert the fake module tree into ``sys.modules`` (fresh world,
    with the given fault schedule). Returns the previous entries for
    :func:`uninstall_fake_gcs`. Prefer pytest's monkeypatch in tests —
    this pair exists for non-pytest user harnesses."""
    FakeGcsClient.reset(faults, fault_kind)
    prev = {}
    for name, mod in fake_module_tree():
        prev[name] = sys.modules.get(name)
        sys.modules[name] = mod
    return prev


def uninstall_fake_gcs(prev: dict) -> None:
    for name, mod in prev.items():
        if mod is None:
            sys.modules.pop(name, None)
        else:
            sys.modules[name] = mod


def utest() -> None:
    """Self-test: schedule arithmetic + the 503/timeout shapes."""
    from lua_mapreduce_tpu_torch.faults.errors import classify_exception

    s = FaultSchedule({"download": [1, 3]})
    try:
        s.check("download")
    except ServiceUnavailable as e:
        assert classify_exception(e) is True     # code=503 → transient
    else:
        raise AssertionError("1st download must fail")
    s.check("download")                           # 2nd passes
    try:
        s.check("download")
    except ServiceUnavailable:
        pass
    else:
        raise AssertionError("3rd download must fail")
    s.check("download")
    assert s.fired == {"download": 2}

    t = FaultSchedule({"upload": 1}, fault_kind="timeout")
    try:
        t.check("upload")
    except FakeGcsTimeout as e:
        assert classify_exception(e) is True
    t.check("upload")

    try:
        FaultSchedule({"bogus": 1})
    except ValueError:
        pass
    else:
        raise AssertionError("unknown op must be rejected")

    prev = install_fake_gcs(faults={"download": 1})
    try:
        from google.cloud import storage  # type: ignore
        assert storage.Client is FakeGcsClient
        bkt = storage.Client().bucket("b")
        bkt.blob("k").upload_from_string("v")
        try:
            bkt.blob("k").download_as_bytes()
        except ServiceUnavailable:
            pass
        else:
            raise AssertionError("first download must 503")
        assert bkt.blob("k").download_as_bytes() == b"v"
    finally:
        uninstall_fake_gcs(prev)
