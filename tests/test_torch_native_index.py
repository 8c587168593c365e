"""The port's native C++ job index (coord/idx.py over its own copy of
jobstore.cpp) against the JAX package: an index file written by the
port's native engine is read the same by the JAX package's PyJobIndex
and NativeJobIndex, and the reverse; the engines mix on one file; the
duplicate-lease operations agree op for op across all four engines; the
ABI guard raises on a drifted layout or a library without the export,
never falling back. Mirrors tests/test_jobstore.py's native cases
(:256, :315, :488); runs wherever g++ builds."""

import ctypes
import subprocess

import pytest

from lua_mapreduce_tpu.coord import idx as jax_idx
from lua_mapreduce_tpu.coord.filestore import FileJobStore as JaxFileStore
from lua_mapreduce_tpu.coord.idx_py import PyJobIndex as JaxPyIndex
from lua_mapreduce_tpu_torch.coord import idx, idx_py
from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore, worker_hash
from lua_mapreduce_tpu_torch.coord.idx import NativeJobIndex, open_index
from lua_mapreduce_tpu_torch.coord.idx_py import PyJobIndex, worker_tag
from lua_mapreduce_tpu_torch.coord.jobstore import make_job
from lua_mapreduce_tpu_torch.core.constants import Status
from lua_mapreduce_tpu_torch.faults.errors import NativeEngineError

pytestmark = pytest.mark.skipif(
    not (idx.native_available() and jax_idx.native_available()),
    reason="native index did not build (no g++?)")

T5 = (1.0, 2.0, 3.0, 0.5, 2.0)


def _engines(path):
    """The four engines on one file: port native, port Python, JAX
    native, JAX Python."""
    return {"port-native": open_index(path, "native"),
            "port-python": PyJobIndex(path),
            "jax-native": jax_idx.open_index(path, "native"),
            "jax-python": JaxPyIndex(path)}


def _history(ix):
    """A run of every record-changing operation, speculation included."""
    ix.insert(6)
    assert [j for j, _ in ix.claim_batch(7, 10.0, 3)] == [0, 1, 2]
    assert ix.commit_batch([(0, T5)], worker=7) == [True]
    assert ix.cas_status(1, Status.BROKEN, 1 << Status.RUNNING, 7)
    assert ix.heartbeat_batch([2], 7, 12.5) == 1
    assert ix.speculate(2)
    assert ix.claim_spec(9) == (2, 0)
    assert ix.claim(8, 11.0) == 1                 # the BROKEN one again
    ix.set_times(3, T5)
    assert ix.scavenge(max_retries=5) == 0


@pytest.mark.parametrize("writer", ["port-native", "jax-native"])
def test_index_file_reads_the_same_on_every_engine(tmp_path, writer):
    """One package's native engine writes a history; every engine of
    both packages reads back the same records, counts and file bytes."""
    path = str(tmp_path / "w.idx")
    engines = _engines(path)
    _history(engines[writer])
    snaps = {name: e.snapshot() for name, e in engines.items()}
    assert len({repr(s) for s in snaps.values()}) == 1, snaps
    counts = {name: {int(k): v for k, v in e.counts().items()}
              for name, e in engines.items()}
    assert len({repr(c) for c in counts.values()}) == 1
    rec = snaps[writer][2]
    assert rec[0] == Status.RUNNING and rec[5] == idx_py.SPEC_TAKEN \
        and rec[6] == 9


def test_histories_write_identical_bytes(tmp_path):
    """The same history on each engine leaves byte-identical index files
    apart from the claim stamps, which the native engines take from
    their own clock: with those zeroed the files are equal."""
    import struct
    files = {}
    for name in ("port-native", "port-python", "jax-native", "jax-python"):
        path = str(tmp_path / f"{name}.idx")
        _history(_engines(path)[name])
        data = bytearray(open(path, "rb").read())
        for i in range((len(data) - 16) // 88):
            off = 16 + i * 88 + 16          # started_time
            data[off:off + 8] = struct.pack("<d", 0.0)
        files[name] = bytes(data)
    assert len(set(files.values())) == 1


def test_batch_interop_native_python(tmp_path):
    """Batch ops mix across the port's engines on one file: native
    claims a lease, Python commits half of it, native sees the result."""
    path = str(tmp_path / "interop-b.idx")
    nat = open_index(path, "native")
    py = PyJobIndex(path)
    nat.insert(4)
    assert [j for j, _ in nat.claim_batch(7, 1.0, 3)] == [0, 1, 2]
    assert py.commit_batch([(0, T5), (1, T5)], worker=7) == [True, True]
    got = nat.get(0)
    assert got[0] == Status.WRITTEN and got[4] == T5
    assert py.get(2)[0] == Status.RUNNING
    assert nat.heartbeat_batch([2], 7, 9.0) == 1
    assert py.cas_status_batch([2], Status.WAITING,
                               1 << Status.RUNNING, 7) == [True]


def test_native_python_interop(tmp_path):
    path = str(tmp_path / "interop.idx")
    nat = open_index(path, "native")
    py = PyJobIndex(path)
    assert type(nat) is NativeJobIndex
    nat.insert(4)
    assert py.count() == 4
    assert py.claim(worker=7, now=1.0) == 0
    assert nat.claim(worker=8, now=2.0) == 1
    assert py.get(0)[:3:2] == (Status.RUNNING, 7)
    assert nat.get(1)[:3:2] == (Status.RUNNING, 8)
    assert nat.cas_status(0, Status.BROKEN)
    assert py.get(0)[:2] == (Status.BROKEN, 1)
    assert py.claim(worker=9, now=3.0) == 0
    assert nat.get(0)[:3] == (Status.RUNNING, 1, 9)


def _spec_ops(ix, a, same, other):
    """Claim job 0 by a same-tag worker and job 1 by an other-tag
    worker (relative to ``a``), open both, and let ``a`` take shadow
    leases: the other-tag straggler first."""
    ha, hs, ho = (worker_hash(n) for n in (a, same, other))
    ix.insert(3)
    out = [ix.claim(hs, 1.0), ix.claim(ho, 1.0), ix.speculate(0),
           ix.speculate(0), ix.speculate(1), ix.claim_spec(ha),
           ix.claim_spec(ha), ix.claim_spec(ha), ix.claim_spec(hs),
           ix.heartbeat(1, ha, 5.0), ix.cancel_spec(1, hs),
           ix.cancel_spec(1, ha), ix.cancel_spec(0, 0),
           ix.cancel_spec(0, 0)]
    # the claim stamp is the native engines' own clock: left out
    return out, [r[:3] + r[4:] for r in ix.snapshot()]


def test_duplicate_leases_agree_on_every_engine(tmp_path):
    """speculate / claim_spec (with the placement-tag preference) /
    cancel_spec give the same answers and leave the same records on the
    four engines."""
    names = [f"w{i}" for i in range(64)]
    tag = {n: worker_tag(worker_hash(n)) for n in names}
    a = names[0]
    same = next(n for n in names[1:] if tag[n] == tag[a])
    other = next(n for n in names[1:] if tag[n] != tag[a])
    got = {}
    for name in ("port-native", "port-python", "jax-native", "jax-python"):
        got[name] = _spec_ops(_engines(str(tmp_path / f"{name}.idx"))[name],
                              a, same, other)
    assert len({repr(v) for v in got.values()}) == 1, got
    answers = got["port-native"][0]
    assert answers[5:8] == [(1, 0), (0, 0), None]   # the other tag first


def test_file_stores_share_a_directory_on_native_engines(tmp_path):
    """The port's FileJobStore(engine="native") and the JAX package's
    claim and commit each other's jobs; a shadow lease taken by one is
    seen and arbitrated by the other (first commit wins)."""
    root = str(tmp_path / "coord")
    port = FileJobStore(root, engine="native")
    jax = JaxFileStore(root, engine="native")
    port.insert_jobs("map_jobs", [make_job(i, {"i": i}) for i in range(3)])
    got = jax.claim_batch("map_jobs", "jax-w", 2)
    assert [d["_id"] for d in got] == [0, 1]
    assert port.speculate("map_jobs", 0)
    clone = port.claim_spec("map_jobs", "port-clone")
    assert clone["_id"] == 0 and clone["speculative"] is True
    assert clone["worker"] == "jax-w"
    times = {"started": 1.0, "finished": 2.0, "written": 3.0, "cpu": 0.5,
             "real": 2.0}
    assert port.commit_batch("map_jobs", "port-clone", [(0, times)]) == [0]
    assert jax.commit_batch("map_jobs", "jax-w",
                            [(0, times), (1, times)]) == [1]
    for store in (port, jax):
        docs = store.jobs("map_jobs")
        assert [int(d["status"]) for d in docs] == [
            int(Status.WRITTEN), int(Status.WRITTEN), int(Status.WAITING)]
        assert [d["repetitions"] for d in docs] == [0, 0, 0]


def test_abi_guard_accepts_the_build():
    lib = idx._load()
    magic = ctypes.create_string_buffer(8)
    sizes = (ctypes.c_int64 * 2)()
    statuses = (ctypes.c_int32 * 6)()
    assert lib.jsx_abi(magic, sizes, statuses) == 1
    assert magic.raw == idx_py.MAGIC
    assert (sizes[0], sizes[1]) == (idx_py.HEADER_SIZE, idx_py.RECORD_SIZE)
    assert list(statuses) == [int(s) for s in Status]


def test_abi_guard_raises_on_drift(monkeypatch):
    """A layout that disagrees with idx_py.py raises NativeEngineError —
    the engines share files byte for byte, so drift is corruption and
    never a silent fallback to Python."""
    lib = idx._load()
    monkeypatch.setattr(idx_py, "RECORD_SIZE", 96)
    with pytest.raises(NativeEngineError, match="ABI drifted"):
        idx._abi_check(lib)
    monkeypatch.setattr(idx_py, "RECORD_SIZE", 88)
    monkeypatch.setattr(idx_py, "MAGIC", b"JSIX0002")
    with pytest.raises(NativeEngineError, match="ABI drifted"):
        idx._abi_check(lib)


def test_abi_guard_raises_without_the_export(tmp_path):
    """A library that lacks jsx_abi (a hand-placed binary) is refused
    the same way: unverifiable is as bad as wrong."""
    src = tmp_path / "noabi.cpp"
    src.write_text('extern "C" int jsx_count(const char*) { return 0; }\n')
    so = str(tmp_path / "libnoabi.so")
    subprocess.run(["g++", "-shared", "-fPIC", "-o", so, str(src)],
                   check=True, capture_output=True)
    with pytest.raises(NativeEngineError, match="ABI guard"):
        idx._abi_check(ctypes.CDLL(so))
