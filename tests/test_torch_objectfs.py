"""The port's object store (``store/objectfs.py``) and its fake GCS
(``store/fake_gcs.py``) ≡ the JAX package's: the local-directory bucket
with whole-object PUT/GET, ``read_range`` and ``size``; the ``gs://``
branch over the port's own fake; the router's ``object:`` branch under
the retry wiring; and the two packages reading each other's buckets.
Both fakes install into ``sys.modules["google.cloud.storage"]``, so a
test driving both installs and uninstalls around each side.
Counterparts of the object-store cases of ``tests/test_store.py``."""

import os
import random
import sys
import types

import pytest

from lua_mapreduce_tpu_torch.store.fake_gcs import (FakeGcsClient,
                                                    FakeGcsTimeout,
                                                    ServiceUnavailable,
                                                    fake_module_tree,
                                                    install_fake_gcs,
                                                    uninstall_fake_gcs)
from lua_mapreduce_tpu_torch.store.objectfs import ObjectStore
from lua_mapreduce_tpu_torch.store.router import (get_storage_from,
                                                  parse_storage)


@pytest.fixture
def fake_gcs(monkeypatch):
    FakeGcsClient.reset()
    for name, mod in fake_module_tree():
        monkeypatch.setitem(sys.modules, name, mod)
    return FakeGcsClient


def test_object_spec_routes_through_the_retry_wiring(tmp_path):
    from lua_mapreduce_tpu_torch.faults import RetryingStore, unwrap
    assert parse_storage(f"object:{tmp_path}") == ("object", str(tmp_path))
    assert parse_storage(f"sshfs:{tmp_path}") == ("object", str(tmp_path))
    assert parse_storage(f"gcs:{tmp_path}") == ("object", str(tmp_path))
    with pytest.raises(ValueError, match="needs a path"):
        parse_storage("object")
    s = get_storage_from(f"object:{tmp_path}/o")
    assert isinstance(s, RetryingStore)
    assert isinstance(unwrap(s), ObjectStore)
    assert unwrap(s).publish_ambiguous is False


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_local_bucket_roundtrip_and_cross_read(tmp_path, writer):
    """Whole-object PUT/GET, ranged reads, size, list and remove on the
    local bucket; the other package reads what one wrote."""
    from lua_mapreduce_tpu.store.objectfs import ObjectStore as JaxObject
    d = str(tmp_path / "bkt")
    w = ObjectStore(d) if writer == "port" else JaxObject(d)
    r = JaxObject(d) if writer == "port" else ObjectStore(d)
    with w.builder() as b:
        b.write("line1\n")
        b.write_bytes(b"\x00\x01binary\n")
        b.build("runs.P0/M1")             # a '/' is flattened alike
    with w.builder() as b:
        b.write("abandoned\n")            # never built: nothing lands
    assert r.list("*") == ["runs.P0/M1"]
    assert r.size("runs.P0/M1") == 6 + 9
    assert r.read_range("runs.P0/M1", 6, 3) == b"\x00\x01b"
    assert r.read_range("runs.P0/M1", 100, 3) == b""
    assert r.exists("runs.P0/M1") and not r.exists("nope")
    assert not any(f.startswith(".put.") for f in os.listdir(d))
    r.remove("runs.P0/M1")
    r.remove("runs.P0/M1")                # idempotent
    assert w.list("*") == []


def test_gcs_branch_roundtrip(fake_gcs):
    store = ObjectStore("gs://testbkt/spill")
    b = store.builder()
    b.write("line1\n")
    b.write("line2\n")
    b.build("runs.P0.M1")
    assert store.exists("runs.P0.M1")
    assert list(store.lines("runs.P0.M1")) == ["line1\n", "line2\n"]
    assert "spill/runs.P0.M1" in fake_gcs._buckets["testbkt"]._objects
    assert store.list("runs.P0.*") == ["runs.P0.M1"]
    store.remove("runs.P0.M1")
    store.remove("runs.P0.M1")
    assert not store.exists("runs.P0.M1")
    assert store.list("*") == []


def test_gcs_sibling_prefixes_do_not_leak(fake_gcs):
    s1 = ObjectStore("gs://bkt/inter")
    s2 = ObjectStore("gs://bkt/inter2")
    b = s1.builder()
    b.write("one\n")
    b.build("a.P0.M0")
    b = s2.builder()
    b.write("two\n")
    b.build("a.P0.M1")
    assert s1.list("*") == ["a.P0.M0"]
    assert s2.list("*") == ["a.P0.M1"]
    assert list(s1.lines("a.P0.M0")) == ["one\n"]


def test_gcs_branch_end_to_end_wordcount(fake_gcs):
    from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
    from lua_mapreduce_tpu_torch.engine.local import LocalExecutor
    mod = types.ModuleType("tgcs_wc")
    corpus = {"d1": "a b a c", "d2": "b a"}
    mod.taskfn = lambda emit: [emit(k, v) for k, v in corpus.items()]

    def mapfn(key, value, emit):
        for w in value.split():
            emit(w, 1)
    mod.mapfn = mapfn
    mod.partitionfn = lambda key: sum(key.encode()) % 3
    mod.reducefn = lambda key, values: sum(values)
    sys.modules["tgcs_wc"] = mod
    spec = TaskSpec(taskfn="tgcs_wc", mapfn="tgcs_wc", partitionfn="tgcs_wc",
                    reducefn="tgcs_wc", storage="object:gs://wcbkt/inter")
    for kw in ({}, dict(pipeline=True, premerge_min_runs=2,
                        segment_format="v2")):
        ex = LocalExecutor(spec, engine="store", **kw)
        ex.run()
        assert {k: v[0] for k, v in ex.results()} == \
            {"a": 3, "b": 2, "c": 1}
    assert "wcbkt" in fake_gcs._buckets


def test_gcs_ranged_reads_and_segments(fake_gcs):
    from lua_mapreduce_tpu_torch.core.segment import (open_segment,
                                                      record_stream,
                                                      writer_for)
    store = ObjectStore("gs://segbkt/spill")
    b = store.builder()
    payload = bytes(range(256))
    b.write_bytes(payload)
    b.build("blob")
    assert store.size("blob") == 256
    assert store.read_range("blob", 10, 5) == payload[10:15]
    assert store.read_range("blob", 250, 100) == payload[250:]
    assert store.read_range("blob", 300, 10) == b""
    recs = [(f"k{i:03d}", [i, "x" * (i % 7)]) for i in range(300)]
    w = writer_for(store, "v2")
    for k, v in recs:
        w.add(k, v)
    w.build("runs.P0.M1")
    assert open_segment(store, "runs.P0.M1") is not None
    assert list(record_stream(store, "runs.P0.M1")) == recs


def test_gcs_injected_503_classified_and_retried(fake_gcs):
    from lua_mapreduce_tpu_torch.faults import RetryingStore, RetryPolicy
    FakeGcsClient.reset(faults={"download": [2, 3]})
    raw = ObjectStore("gs://fltbkt/x")
    with raw.builder() as b:
        b.write("payload\n")
        b.build("obj")
    assert raw.classify(ServiceUnavailable("x")) is True
    store = RetryingStore(raw, RetryPolicy(retries=3, base_ms=1,
                                           sleep=lambda s: None,
                                           rng=random.Random(0)))
    assert raw._get("obj") == b"payload\n"
    assert store.read_range("obj", 0, 7) == b"payload"
    assert FakeGcsClient.faults.fired == {"download": 2}


def test_gcs_injected_timeout_exhausts_to_transient_error(fake_gcs):
    from lua_mapreduce_tpu_torch.faults import (RetryingStore, RetryPolicy,
                                                TransientStoreError)
    FakeGcsClient.reset(faults={"download": 10}, fault_kind="timeout")
    raw = ObjectStore("gs://tobkt/x")
    with raw.builder() as b:
        b.write("v\n")
        b.build("obj")
    store = RetryingStore(raw, RetryPolicy(retries=2, base_ms=1,
                                           sleep=lambda s: None,
                                           rng=random.Random(0)))
    with pytest.raises(TransientStoreError) as ei:
        store.read_range("obj", 0, 2)
    assert ei.value.attempts == 3
    assert isinstance(ei.value.__cause__, FakeGcsTimeout)


def test_gcs_classify_not_found_is_permanent(fake_gcs):
    raw = ObjectStore("gs://nfbkt/x")
    nf = type("NotFound", (Exception,), {})()
    assert raw.classify(nf) is False
    gone = type("Gone", (Exception,), {"code": 410})()
    assert raw.classify(gone) is False
    assert raw.classify(ValueError("user")) is None


def test_gcs_missing_dependency_error_message(monkeypatch):
    import builtins
    for m in ("google", "google.cloud", "google.cloud.storage"):
        monkeypatch.delitem(sys.modules, m, raising=False)
    real_import = builtins.__import__

    def no_gcs(name, *a, **k):
        if name.startswith("google"):
            raise ImportError(name)
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_gcs)
    with pytest.raises(RuntimeError, match="google-cloud-storage"):
        ObjectStore("gs://nope/x")


def test_each_package_talks_only_to_the_installed_fake():
    """Install the JAX package's fake, write through the JAX store;
    uninstall, install the port's, write through the port's store: each
    store's bucket holds only its own object, and the port never
    imports the JAX fake."""
    from lua_mapreduce_tpu.store.fake_gcs import (
        FakeGcsClient as JaxClient, install_fake_gcs as jax_install,
        uninstall_fake_gcs as jax_uninstall)
    from lua_mapreduce_tpu.store.objectfs import ObjectStore as JaxObject
    before = sys.modules.get("google.cloud.storage")
    prev = jax_install()
    try:
        js = JaxObject("gs://both/x")
        with js.builder() as b:
            b.write("jax\n")
            b.build("o")
    finally:
        jax_uninstall(prev)
    prev = install_fake_gcs()
    try:
        ps = ObjectStore("gs://both/x")
        assert ps.list("*") == []         # a different world
        with ps.builder() as b:
            b.write("port\n")
            b.build("o")
        assert list(ps.lines("o")) == ["port\n"]
        assert sys.modules["google.cloud.storage"].Client is FakeGcsClient
    finally:
        uninstall_fake_gcs(prev)
    assert JaxClient._buckets["both"]._objects["x/o"] == b"jax\n"
    assert FakeGcsClient._buckets["both"]._objects["x/o"] == b"port\n"
    src = open(sys.modules[ObjectStore.__module__].__file__).read() + open(
        sys.modules[FakeGcsClient.__module__].__file__).read()
    assert "lua_mapreduce_tpu." not in src.replace(
        "lua_mapreduce_tpu_torch.", "")
    assert sys.modules.get("google.cloud.storage") is before


@pytest.mark.parametrize("faults,kind", [({"upload": [1]}, "503"),
                                         ({"download": 2}, "timeout"),
                                         ({"size": [1, 2]}, "503")])
def test_fault_schedule_matches_jax(faults, kind):
    """The two fakes' schedules fire on the same calls."""
    from lua_mapreduce_tpu.store.fake_gcs import FaultSchedule as JaxSched
    from lua_mapreduce_tpu_torch.store.fake_gcs import FaultSchedule
    port, jax = FaultSchedule(faults, kind), JaxSched(faults, kind)
    op = next(iter(faults))
    for _ in range(5):
        got = []
        for s in (port, jax):
            try:
                s.check(op)
                got.append(None)
            except Exception as e:
                got.append(type(e).__name__)
        assert got[0] == got[1]
    assert port.fired == jax.fired
