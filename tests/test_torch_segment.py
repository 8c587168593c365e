"""The port's v2 framed segments (``core/segment.py``, JSEG0001) ≡ the JAX
package's: the same records through either writer give the same bytes
(raw and zlib frames), each package reads the other's files, corrupt
and truncated frames are refused, and the engines' v1 and v2 runs end in
the same result bytes. Counterparts of ``tests/test_segment.py``."""

import json
import os
import random
import sys
import threading
import types

import pytest
import torch

from lua_mapreduce_tpu.core.segment import (open_segment as jax_open,
                                            record_stream as jax_stream,
                                            writer_for as jax_writer_for)
from lua_mapreduce_tpu.store.sharedfs import SharedStore as JaxShared
from lua_mapreduce_tpu_torch.core import tuples
from lua_mapreduce_tpu_torch.core.merge import merge_iterator
from lua_mapreduce_tpu_torch.core.segment import (MAGIC, SegmentWriter,
                                                  check_format,
                                                  open_segment,
                                                  record_stream,
                                                  writer_for)
from lua_mapreduce_tpu_torch.core.serialize import (dump_key, dump_record,
                                                    key_lt, sorted_keys,
                                                    to_plain)
from lua_mapreduce_tpu_torch.store.base import FileBuilder, Store
from lua_mapreduce_tpu_torch.store.memfs import MemStore
from lua_mapreduce_tpu_torch.store.objectfs import ObjectStore
from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore

BACKENDS = ["mem", "shared", "object"]


def _backends(tmp_path):
    return {
        "mem": MemStore(),
        "shared": SharedStore(str(tmp_path / "shared")),
        "object": ObjectStore(str(tmp_path / "object")),
    }


def _records(seed=0, n=2000):
    rng = random.Random(seed)
    return [(f"key{i:05d}", [i, f"v{i}", [i, rng.random()]])
            for i in range(n)]


# ---------------------------------------------------------------------------
# format round-trip, and byte parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("codec", ["raw", "zlib"])
def test_segment_roundtrip(tmp_path, backend, codec):
    store = _backends(tmp_path)[backend]
    recs = _records()
    w = SegmentWriter(store.builder(), codec=codec, frame_bytes=4096)
    for k, v in recs:
        w.add(k, v)
    w.build("runs.P0.M1")
    r = open_segment(store, "runs.P0.M1")
    assert r is not None and r.records == len(recs)
    assert len(r.frames) > 1
    assert r.frames[0][3] == dump_key(recs[0][0])
    assert list(r.iter_records()) == recs
    assert list(record_stream(store, "runs.P0.M1")) == recs


@pytest.mark.parametrize("codec", ["raw", "zlib"])
@pytest.mark.parametrize("frame_bytes", [512, 1 << 18])
def test_segment_bytes_equal_jax_and_cross_read(tmp_path, codec,
                                                frame_bytes):
    """Same records, same codec and frame size: the port's file is the
    JAX package's byte for byte, and each package reads the other's."""
    from lua_mapreduce_tpu.core.segment import SegmentWriter as JaxWriter
    recs = _records(seed=3, n=1500)
    port, jax = SharedStore(str(tmp_path / "p")), JaxShared(
        str(tmp_path / "j"))
    for W, store in ((SegmentWriter, port), (JaxWriter, jax)):
        w = W(store.builder(), codec=codec, frame_bytes=frame_bytes)
        for k, v in recs:
            w.add(k, v)
        w.build("seg.P0.M00000001")
    a = open(os.path.join(tmp_path, "p", "seg.P0.M00000001"), "rb").read()
    b = open(os.path.join(tmp_path, "j", "seg.P0.M00000001"), "rb").read()
    assert a.startswith(MAGIC) and a == b
    # cross-read: the port reads the JAX file, the JAX package the port's
    port_view_of_jax = SharedStore(str(tmp_path / "j"))
    assert list(record_stream(port_view_of_jax, "seg.P0.M00000001")) == recs
    jax_view_of_port = JaxShared(str(tmp_path / "p"))
    assert list(jax_stream(jax_view_of_port, "seg.P0.M00000001")) == recs


def test_tensor_records_frame_like_jax_arrays(tmp_path):
    """A tensor emitted by a mapfn reaches the spill through to_plain:
    its f32 values print as the JAX package prints the same array, so
    the v2 frame bytes agree."""
    import numpy as np
    rng = np.random.default_rng(0)
    arrs = [rng.standard_normal(17).astype(np.float32) for _ in range(40)]
    port = SharedStore(str(tmp_path / "p"))
    jax = JaxShared(str(tmp_path / "j"))
    w = writer_for(port, "v2")
    for i, a in enumerate(arrs):
        w.add(f"k{i:03d}", [to_plain(torch.from_numpy(a))])
    w.build("t")
    wj = jax_writer_for(jax, "v2")
    for i, a in enumerate(arrs):
        wj.add(f"k{i:03d}", [a.tolist()])
    wj.build("t")
    assert open(os.path.join(tmp_path, "p", "t"), "rb").read() == \
        open(os.path.join(tmp_path, "j", "t"), "rb").read()


@pytest.mark.parametrize("backend", BACKENDS)
def test_raw_bytes_surface(tmp_path, backend):
    store = _backends(tmp_path)[backend]
    b = store.builder()
    payload = bytes(range(256)) * 5
    b.write_bytes(payload)
    b.build("blob")
    assert store.size("blob") == len(payload)
    assert store.read_range("blob", 0, 8) == payload[:8]
    assert store.read_range("blob", 300, 10) == payload[300:310]
    assert store.read_range("blob", len(payload) - 4, 100) == payload[-4:]


def test_text_shim_default_surface():
    """A Store subclass with only the text methods still serves v2
    segments through the base-class latin-1 shim."""

    class _ShimStore(Store):
        def __init__(self):
            self.files = {}

        def builder(self):
            outer = self

            class _B(FileBuilder):
                def __init__(self):
                    self.parts = []

                def write(self, data):
                    self.parts.append(data)

                def build(self, name):
                    outer.files[name] = "".join(self.parts)
            return _B()

        def lines(self, name):
            return iter(self.files[name].splitlines(keepends=True))

        def list(self, pattern):
            return self._match(self.files, pattern)

        def exists(self, name):
            return name in self.files

        def remove(self, name):
            self.files.pop(name, None)

    store = _ShimStore()
    recs = [(f"k{i}", [i]) for i in range(50)]
    w = writer_for(store, "v2")
    for k, v in recs:
        w.add(k, v)
    w.build("seg")
    assert list(record_stream(store, "seg")) == recs
    w = writer_for(store, "v1")
    w.add("a", [1])
    w.build("txt")
    assert open_segment(store, "txt") is None
    assert list(record_stream(store, "txt")) == [("a", [1])]


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_corrupt_frame_detected(tmp_path, reader):
    import zlib
    store = SharedStore(str(tmp_path))
    w = writer_for(store, "v2")
    for i in range(100):
        w.add(f"k{i}", [i])
    w.build("seg")
    path = os.path.join(tmp_path, "seg")
    raw = open(path, "rb").read()
    flip = 8 + 13 + 7                     # a payload byte of frame 0
    open(path, "wb").write(raw[:flip] + bytes([raw[flip] ^ 0xFF])
                           + raw[flip + 1:])
    opener = open_segment if reader == "port" else jax_open
    view = store if reader == "port" else JaxShared(str(tmp_path))
    with pytest.raises((ValueError, zlib.error)):
        list(opener(view, "seg").iter_records())


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_truncated_segment_detected(tmp_path, reader):
    store = SharedStore(str(tmp_path))
    w = writer_for(store, "v2")
    for i in range(100):
        w.add(f"k{i}", [i])
    w.build("seg")
    raw = open(os.path.join(tmp_path, "seg"), "rb").read()
    open(os.path.join(tmp_path, "trunc"), "wb").write(raw[:-9])
    opener = open_segment if reader == "port" else jax_open
    view = store if reader == "port" else JaxShared(str(tmp_path))
    with pytest.raises(ValueError):
        opener(view, "trunc")


def test_float_fast_path_byte_identity():
    rng = random.Random(0)
    cases = [[0.0, -0.0, 1.5, 3.141592653589793, 1e-300, -2.5e17]]
    for _ in range(200):
        cases.append([rng.choice([
            rng.random(), rng.uniform(-1e9, 1e9), float(rng.randint(0, 99)),
            rng.randint(-100, 100), f"s{rng.randint(0, 9)}"])
            for _ in range(rng.randint(0, 5))])
    cases += [[float("inf")], [float("-inf")], [float("nan")], [True], [None]]
    for values in cases:
        assert dump_record("k", values) == json.dumps(
            ["k", values], separators=(",", ":"), ensure_ascii=False)


def test_lz4_is_never_the_default_and_raises_here():
    """Codec 2 is gated on ``import lz4`` as the JAX package gates it;
    neither machine has lz4, so asking for it raises."""
    try:
        import lz4  # noqa: F401
        have = True
    except ImportError:
        have = False
    w = SegmentWriter(MemStore().builder(), codec="lz4")
    w.add("k", [1])
    if have:
        w.build("x")
    else:
        with pytest.raises(ValueError, match="lz4"):
            w.build("x")
    with pytest.raises(ValueError, match="v3"):
        check_format("v3")


# ---------------------------------------------------------------------------
# fuzz: v1 text ↔ v2 frames
# ---------------------------------------------------------------------------

def _random_key(rng, depth=0):
    choices = ["int", "float", "str", "bool", "none"]
    if depth < 2:
        choices.append("tuple")
    kind = rng.choice(choices)
    if kind == "int":
        return rng.randint(-10**12, 10**12)
    if kind == "float":
        return rng.uniform(-1e6, 1e6)
    if kind == "str":
        return "".join(rng.choice('abc XYZ0"\\\n\té漢')
                       for _ in range(rng.randint(0, 8)))
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "none":
        return None
    return tuples.intern(tuple(_random_key(rng, depth + 1)
                               for _ in range(rng.randint(0, 3))))


def _random_value(rng, depth=0):
    kind = rng.choice(["int", "float", "str", "bool", "none"] +
                      (["list", "dict"] if depth < 2 else []))
    if kind == "int":
        return rng.randint(-10**9, 10**9)
    if kind == "float":
        return rng.uniform(-1e9, 1e9)
    if kind == "str":
        return "".join(rng.choice('ab"\\\n\t €deΩ')
                       for _ in range(rng.randint(0, 10)))
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "none":
        return None
    if kind == "list":
        return [_random_value(rng, depth + 1)
                for _ in range(rng.randint(0, 4))]
    return {f"f{i}": _random_value(rng, depth + 1)
            for i in range(rng.randint(0, 3))}


def _sorted_run(rng, n):
    keys, seen = [], set()
    while len(keys) < n:
        k = _random_key(rng)
        marker = dump_key(k)
        if marker not in seen:
            seen.add(marker)
            keys.append(k)
    return [(k, [_random_value(rng) for _ in range(rng.randint(1, 4))])
            for k in sorted_keys(keys)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_fuzz_v1_v2_identical_streams_and_merge(tmp_path, backend):
    store = _backends(tmp_path)[backend]
    rng = random.Random(BACKENDS.index(backend))
    runs = [_sorted_run(rng, rng.randint(5, 60)) for _ in range(5)]
    for i, run in enumerate(runs):
        for fmt in ("v1", "v2"):
            w = SegmentWriter(store.builder(), frame_bytes=512) \
                if fmt == "v2" else writer_for(store, "v1")
            for k, v in run:
                w.add(k, v)
            w.build(f"{fmt}.run{i}")
        a = list(record_stream(store, f"v1.run{i}"))
        b = list(record_stream(store, f"v2.run{i}"))
        assert a == b
        assert [type(k) for k, _ in a] == [type(k) for k, _ in b]
    names_v1 = [f"v1.run{i}" for i in range(len(runs))]
    names_v2 = [f"v2.run{i}" for i in range(len(runs))]
    mixed = [(names_v1[i] if i % 2 else names_v2[i])
             for i in range(len(runs))]
    m1 = list(merge_iterator(store, names_v1))
    assert m1 == list(merge_iterator(store, names_v2)) == \
        list(merge_iterator(store, mixed))
    for (ka, _), (kb, _) in zip(m1, m1[1:]):
        assert key_lt(ka, kb)


def test_str_keyed_merge_equals_jax_merge(tmp_path):
    """The all-str-key heapq merge (footer's str_keys promise) gives the
    JAX package's merge groups over the same segments."""
    from lua_mapreduce_tpu.core.merge import merge_iterator as jax_merge
    rng = random.Random(5)
    store = SharedStore(str(tmp_path))
    names = []
    for i in range(4):
        keys = sorted({f"w{rng.randint(0, 300):04d}" for _ in range(80)})
        w = writer_for(store, "v2")
        for k in keys:
            w.add(k, [i, rng.randint(0, 9)])
        w.build(f"r{i}")
        names.append(f"r{i}")
    assert open_segment(store, "r0").str_keys
    assert list(merge_iterator(store, names)) == \
        list(jax_merge(JaxShared(str(tmp_path)), names))


# ---------------------------------------------------------------------------
# engine interop: mixed formats, mixed fleets, byte-equal results
# ---------------------------------------------------------------------------

def _wc_module(name):
    mod = types.ModuleType(name)
    corpus = {f"d{i}": " ".join(
        random.Random(i).choice(["alpha", "beta", "gamma", "delta", "eps"])
        for _ in range(200)) for i in range(8)}
    mod.taskfn = lambda emit: [emit(k, v) for k, v in corpus.items()]

    def mapfn(key, value, emit):
        for w in value.split():
            emit(w, 1)
    mod.mapfn = mapfn
    mod.partitionfn = lambda key: sum(key.encode()) % 3
    mod.reducefn = lambda key, values: sum(values)
    mod.associative_reducer = True
    mod.commutative_reducer = True
    sys.modules[name] = mod
    return mod


def _spec(mod, storage, **extra):
    from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
    return TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod, reducefn=mod,
                    storage=storage, **extra)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("pipeline", [False, True])
def test_local_executor_v1_v2_byte_identical(tmp_path, backend, pipeline):
    """Result files are v1 text under both spill formats and both
    shuffle modes, byte-equal to the JAX package's v1 barrier run."""
    from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
    from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxExecutor
    from lua_mapreduce_tpu.store.router import get_storage_from as jax_store
    from lua_mapreduce_tpu_torch.engine.local import LocalExecutor
    _wc_module("_tseg_interop_wc")
    jspec = f"shared:{tmp_path}/jax"
    JaxExecutor(JaxSpec(taskfn="_tseg_interop_wc",
                        mapfn="_tseg_interop_wc",
                        partitionfn="_tseg_interop_wc",
                        reducefn="_tseg_interop_wc", storage=jspec)).run()
    js = jax_store(jspec)
    want = {n: "".join(js.lines(n)) for n in js.list("result.P*")}
    for fmt in ("v1", "v2"):
        storage = {
            "mem": f"mem:_tseg_ip_{pipeline}_{fmt}",
            "shared": f"shared:{tmp_path}/sh_{pipeline}_{fmt}",
            "object": f"object:{tmp_path}/ob_{pipeline}_{fmt}",
        }[backend]
        ex = LocalExecutor(_spec("_tseg_interop_wc", storage),
                           map_parallelism=2, pipeline=pipeline,
                           premerge_min_runs=2, segment_format=fmt,
                           engine="store")
        ex.run()
        got = {n: "".join(ex.result_store.lines(n))
               for n in ex.result_store.list("result.P*")}
        assert want and got == want


@pytest.mark.parametrize("combo", [("v1", "v1"), ("v2", "v2"),
                                   ("v1", "v2"), ("v2", "v1")])
def test_reduce_over_mixed_format_runs(tmp_path, combo):
    """One partition's runs written by a v1 and a v2 mapper reduce to
    the bytes of the all-v1 case."""
    from lua_mapreduce_tpu_torch.engine.job import (run_map_job,
                                                    run_reduce_job)
    mod = _wc_module("_tseg_mixed_wc")
    spec = _spec("_tseg_mixed_wc", "mem:_tseg_mixed")
    out = {}
    for fmts in (("v1", "v1"), combo):
        store = SharedStore(str(tmp_path / "_".join(fmts)))
        jobs = []
        mod.taskfn(lambda k, v: jobs.append((k, v)))
        for i, (k, v) in enumerate(jobs):
            run_map_job(spec, store, str(i), k, v,
                        segment_format=fmts[i % 2])
        res = {}
        for part in (0, 1, 2):
            files = store.list(f"result.P{part}.M*")
            if files:
                run_reduce_job(spec, store, store, str(part), files,
                               f"result.P{part}")
                res[part] = "".join(store.lines(f"result.P{part}"))
        out[fmts] = res
    assert out[("v1", "v1")] and out[combo] == out[("v1", "v1")]


def test_mixed_fleet_v1_and_v2_workers():
    """A v1-pinned worker and a v2 worker complete one pipelined v2
    task against one store; readers sniff per file."""
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
    from lua_mapreduce_tpu_torch.engine.local import iter_results
    from lua_mapreduce_tpu_torch.engine.server import Server
    from lua_mapreduce_tpu_torch.engine.worker import Worker
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    mod = _wc_module("_tseg_fleet_wc")
    spec = _spec("_tseg_fleet_wc", "mem:_tseg_fleet",
                 init_args={"device": "cpu"})
    store = MemJobStore()
    server = Server(store, poll_interval=0.01, segment_format="v2",
                    pipeline=True, premerge_min_runs=2,
                    engine="store").configure(spec)
    w_old = Worker(store, name="v1-only").configure(
        max_iter=600, max_sleep=0.02, segment_format="v1")
    w_new = Worker(store, name="v2").configure(max_iter=600, max_sleep=0.02)
    threads = [threading.Thread(target=w.execute, daemon=True)
               for w in (w_old, w_new)]
    for t in threads:
        t.start()
    server.loop()
    for t in threads:
        t.join(timeout=30)
    got = {k: v[0] for k, v in
           iter_results(get_storage_from("mem:_tseg_fleet"), "result")}
    jobs, expect = [], {}
    mod.taskfn(lambda k, v: jobs.append((k, v)))
    for _, text in jobs:
        for w in text.split():
            expect[w] = expect.get(w, 0) + 1
    assert got == expect
    assert w_old.jobs_executed + w_new.jobs_executed > 0


def test_jax_pipelined_v2_server_with_jax_and_port_workers(tmp_path):
    """A mixed fleet on one FileJobStore: a JAX pipelined v2 server with
    one JAX worker and one port worker (threads); the result bytes equal
    the barrier v1 run's."""
    from lua_mapreduce_tpu.coord.filestore import FileJobStore as JaxFJS
    from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
    from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxExecutor
    from lua_mapreduce_tpu.engine.server import Server as JaxServer
    from lua_mapreduce_tpu.engine.worker import Worker as JaxWorker
    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.engine.worker import Worker
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    import glob
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(repo, "lua_mapreduce_tpu", "core",
                                          "*.py")))[:10]
    fns = dict(taskfn="examples.wordcount.taskfn",
               mapfn="examples.wordcount.mapfn",
               partitionfn="examples.wordcount.partitionfn",
               reducefn="examples.wordcount.reducefn",
               combinerfn="examples.wordcount.reducefn")
    JaxExecutor(JaxSpec(init_args={"files": files},
                        storage=f"shared:{tmp_path}/bar", **fns)).run()
    bar = get_storage_from(f"shared:{tmp_path}/bar")
    want = {n: "".join(bar.lines(n)) for n in bar.list("result.P*")}

    coord = str(tmp_path / "coord")
    spill = f"shared:{tmp_path}/spill"
    server = JaxServer(JaxFJS(coord, engine="python"), poll_interval=0.02,
                       pipeline=True, premerge_min_runs=2,
                       segment_format="v2", engine="store").configure(
        JaxSpec(init_args={"files": files, "device": "cpu"},
                storage=spill, **fns))
    workers = [JaxWorker(JaxFJS(coord, engine="python"), name="jax-w"),
               Worker(FileJobStore(coord), name="port-w")]
    for w in workers:
        w.configure(max_iter=400, max_sleep=0.05)
    threads = [threading.Thread(target=w.execute, daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    server.loop()
    for t in threads:
        t.join(timeout=60)
    out = get_storage_from(spill)
    got = {n: "".join(out.lines(n)) for n in out.list("result.P*")}
    assert want and got == want
    assert workers[1].jobs_executed > 0


def test_abandoned_builder_leaves_no_tempfile(tmp_path):
    """close() of an unbuilt shared builder publishes nothing and leaves
    no ``.tmp.`` file; close() after build keeps the file."""
    store = SharedStore(str(tmp_path / "cl"))
    b = store.builder()
    b.write("x" * (2 << 20))
    b.close()
    b.close()                             # idempotent
    assert store.list("*") == []
    assert not any(f.startswith(".tmp.") for f in os.listdir(store.path))
    b3 = store.builder()
    b3.write("keep\n")
    b3.build("kept")
    b3.close()
    assert list(store.lines("kept")) == ["keep\n"]


def test_bad_segment_format_rejected():
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
    from lua_mapreduce_tpu_torch.engine.job import run_map_job
    from lua_mapreduce_tpu_torch.engine.server import Server
    with pytest.raises(ValueError):
        Server(MemJobStore(), segment_format="v3")
    with pytest.raises(ValueError):
        run_map_job(None, None, "0", "k", "v", segment_format="binary")
