"""The port's native C++ shuffle merge (core/native_merge.py over its
own copy of shufflemerge.cpp) against the JAX package: the same seeded
run files go through the JAX package's Python heap merge, the JAX
package's native merge and the port's native merge — merged records,
merged-file bytes, fused-sum result bytes and pre-merge spill bytes
equal — over v1 text and v2 framed runs, keys of every rank, and the
int64 cases that must fall back. Mirrors tests/test_native_merge.py
and test_segment.py's native golden diff; runs wherever g++ builds
(both packages' libraries), no card needed."""

import ctypes
import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest

from lua_mapreduce_tpu.core import native_merge as jax_nm
from lua_mapreduce_tpu.core.merge import merge_iterator as jax_merge
from lua_mapreduce_tpu.store.sharedfs import SharedStore as JaxShared
from lua_mapreduce_tpu_torch.core import native_merge
from lua_mapreduce_tpu_torch.core.merge import merge_iterator
from lua_mapreduce_tpu_torch.core.segment import SegmentWriter
from lua_mapreduce_tpu_torch.core.serialize import (dump_key, dump_record,
                                                    sorted_keys)
from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore

pytestmark = pytest.mark.skipif(
    not (native_merge.native_available() and jax_nm.native_available()),
    reason="native merge did not build (no g++?)")


def _write_run(store, name, records):
    b = store.builder()
    for k, vs in records:
        b.write(dump_record(k, vs) + "\n")
    b.build(name)


def _write_runs(store, runs):
    for name, recs in runs.items():
        _write_run(store, name, recs)
    return sorted(runs)


def _sorted_run(pairs):
    keys = sorted_keys([k for k, _ in pairs])
    d = dict(pairs)
    return [(k, d[k]) for k in keys]


def _merged_bytes(mod, paths, out):
    mod.merge_paths(paths, out)
    with open(out, "rb") as f:
        return f.read()


def _three_way(tmp_path, names):
    """(port native records, JAX native records, JAX Python records),
    and the two merged files' bytes, over ``names`` in tmp_path/runs."""
    port = SharedStore(str(tmp_path / "runs"))
    jax = JaxShared(str(tmp_path / "runs"))
    got = list(native_merge.native_merge_records(port, names))
    jgot = list(jax_nm.native_merge_records(jax, names))
    want = list(jax_merge(jax, names))
    paths = [port.local_path(n) for n in names]
    pb = _merged_bytes(native_merge, paths, str(tmp_path / "port.m"))
    jb = _merged_bytes(jax_nm, paths, str(tmp_path / "jax.m"))
    return got, jgot, want, pb, jb


def test_matches_python_merge_mixed_types(tmp_path):
    store = SharedStore(str(tmp_path / "runs"))
    names = _write_runs(store, {
        "r.0": _sorted_run([(False, [1]), (3, [10]), ("apple", [1, 2]),
                            ((1, "a"), [5]), (None, ["z"])]),
        "r.1": _sorted_run([(True, [2]), (3, [20]), (3.5, [9]),
                            ("apple", [3]), ("käse", [7]),
                            ((1, "a"), [6]), ((1, "a", 0), [8])]),
        "r.2": _sorted_run([(-2, [0]), ("Zebra", [4]),
                            ("line\nbreak\t\"q\"", [11])]),
    })
    got, jgot, want, pb, jb = _three_way(tmp_path, names)
    assert got == jgot == want
    assert list(merge_iterator(store, names)) == want
    assert pb == jb


def test_large_fanin_wordcount_shape(tmp_path):
    """Many runs, overlapping string keys, concatenated value lists."""
    store = SharedStore(str(tmp_path / "runs"))
    rng = np.random.RandomState(0)
    vocab = [f"w{i:03d}" for i in range(200)]
    runs = {}
    for r in range(16):
        words = sorted(rng.choice(vocab, size=80, replace=False))
        runs[f"run.{r:02d}"] = [(str(w), [1] * int(rng.randint(1, 4)))
                                for w in words]
    names = _write_runs(store, runs)
    got, jgot, want, pb, jb = _three_way(tmp_path, names)
    assert got == jgot == want and pb == jb
    assert sum(len(v) for _, v in got) == \
        sum(len(v) for r in runs.values() for _, v in r)


def test_empty_and_blank_runs(tmp_path):
    store = SharedStore(str(tmp_path / "runs"))
    _write_run(store, "a", [("k", [1])])
    b = store.builder()
    b.write("\n\n")
    b.build("blank")
    store.builder().build("empty")
    got, jgot, want, pb, jb = _three_way(tmp_path, ["a", "blank", "empty"])
    assert got == jgot == want == [("k", [1])]
    assert pb == jb


def test_non_local_store_falls_back(tmp_path):
    from lua_mapreduce_tpu_torch.store.memfs import MemStore
    from lua_mapreduce_tpu_torch.store.objectfs import ObjectStore
    assert native_merge.native_merge_records(MemStore(), ["x"]) is None
    assert native_merge.native_merge_records(
        ObjectStore(str(tmp_path / "obj")), ["x"]) is None
    assert native_merge.native_premerge(MemStore(), ["x"], "s") is False


def test_bigint_keys_stay_distinct(tmp_path):
    """Keys beyond double precision must not merge (exact digit-string
    comparison, as Python's arbitrary-precision ints)."""
    store = SharedStore(str(tmp_path / "runs"))
    big = 2 ** 64
    _write_run(store, "a", [(big, [1])])
    _write_run(store, "b", [(-big - 1, [3]), (big + 1, [2])])
    got, jgot, want, pb, jb = _three_way(tmp_path, ["a", "b"])
    assert got == jgot == want and pb == jb
    assert len(got) == 3


def test_mixed_int_float_keys_beyond_2p53(tmp_path):
    """2**53+1 and 9007199254740992.0 round to one double; Python keeps
    them distinct, and so must both native merges."""
    store = SharedStore(str(tmp_path / "runs"))
    names = _write_runs(store, {
        "a": _sorted_run([(2 ** 53 + 1, [1]), (2 ** 53, [7])]),
        "b": _sorted_run([(float(2 ** 53 + 2), [3]), (-(2 ** 53) - 1, [4]),
                          (float(2 ** 53), [2]), (0.5, [6])]),
        "c": _sorted_run([(10 ** 40, [8]), (1e40, [9]),
                          (-float(2 ** 53), [5])]),
    })
    got, jgot, want, pb, jb = _three_way(tmp_path, names)
    assert got == jgot == want and pb == jb


def _random_key(rng):
    kind = rng.choice(["int", "float", "str", "bool", "none", "tuple"])
    if kind == "int":
        return rng.randint(-10 ** 6, 10 ** 6)
    if kind == "float":
        return rng.uniform(-1e9, 1e9)
    if kind == "str":
        return "".join(rng.choice('ab"\\\n\t €deΩ')
                       for _ in range(rng.randint(0, 8)))
    if kind == "bool":
        return rng.random() < 0.5
    if kind == "none":
        return None
    return (rng.randint(0, 3), "".join(rng.choice("xyz")
                                       for _ in range(rng.randint(0, 3))))


def _random_value(rng):
    kind = rng.choice(["int", "float", "str", "list"])
    if kind == "int":
        return rng.randint(-10 ** 9, 10 ** 9)
    if kind == "float":
        return rng.uniform(-1e6, 1e6) * 10 ** rng.randint(-30, 30)
    if kind == "str":
        return "".join(rng.choice('q"\\é\n ')
                       for _ in range(rng.randint(0, 5)))
    return [rng.random() for _ in range(rng.randint(0, 3))]


def _random_run(rng, n):
    keys, seen = [], set()
    while len(keys) < n:
        k = _random_key(rng)
        if dump_key(k) not in seen:           # run files hold unique keys
            seen.add(dump_key(k))
            keys.append(k)
    return [(k, [_random_value(rng) for _ in range(rng.randint(1, 3))])
            for k in sorted_keys(keys)]


@pytest.mark.parametrize("fmt", ["v1", "v2-zlib", "v2-raw", "mixed"])
def test_merge_over_v1_and_v2_runs(tmp_path, fmt):
    """Keys of every rank and floats of every exponent, in v1 text and
    v2 frames (zlib and raw codecs), mixed per run: the three merges
    agree and the merged files are byte-equal."""
    store = SharedStore(str(tmp_path / "runs"))
    rng = random.Random(17)
    runs = [_random_run(rng, rng.randint(20, 50)) for _ in range(5)]
    names = []
    for i, run in enumerate(runs):
        v2 = fmt.startswith("v2") or (fmt == "mixed" and i % 2)
        if v2:
            w = SegmentWriter(store.builder(),
                              codec="raw" if fmt == "v2-raw" else "zlib",
                              frame_bytes=512)
            for k, v in run:
                w.add(k, v)
            w.build(f"run{i}")
        else:
            _write_run(store, f"run{i}", run)
        names.append(f"run{i}")
    got, jgot, want, pb, jb = _three_way(tmp_path, names)
    assert got == jgot == want
    assert pb == jb


def test_fold_sum_matches_python_reduce(tmp_path):
    """The fused merge + int64 sum publishes a result file byte-equal to
    the JAX package's native fold and to its Python merge + sum +
    dump_record."""
    store = SharedStore(str(tmp_path / "runs"))
    names = _write_runs(store, {
        "r.0": _sorted_run([("a", [1, 2]), ("b", [3]), ("z", [0]),
                            (7, [10]), ((1, "k"), [4])]),
        "r.1": _sorted_run([("a", [5]), ("c", [-2, 2]), (7, [1]),
                            ((1, "k"), [6]), ("big", [2 ** 62])]),
    })
    outs = {n: SharedStore(str(tmp_path / n)) for n in ("port", "jax", "py")}
    assert native_merge.native_merge_reduce_sum(store, names, outs["port"],
                                                "res.P0")
    jax_runs = JaxShared(str(tmp_path / "runs"))
    assert jax_nm.native_merge_reduce_sum(
        jax_runs, names, JaxShared(str(tmp_path / "jax")), "res.P0")
    b = outs["py"].builder()
    for k, vs in jax_merge(jax_runs, names):
        b.write(dump_record(k, [sum(vs)]) + "\n")
    b.build("res.P0")
    got = {n: "".join(s.lines("res.P0")) for n, s in outs.items()}
    assert got["port"] == got["jax"] == got["py"]


@pytest.mark.parametrize("poison", [
    [("a", [1.5])],                    # float value
    [("a", ["x"])],                    # string value
    [("a", [[1, 2]])],                 # nested value
    [("a", [2 ** 64])],                # > int64
    [("a", [2 ** 62]), ("a", [2 ** 62, 2 ** 62])],   # overflow on fold
])
def test_fold_sum_falls_back_on_non_int64(tmp_path, poison):
    """What the int64 fold cannot hold returns False on both packages and
    publishes nothing: the Python fold takes the job."""
    store = SharedStore(str(tmp_path / "runs"))
    names = _write_runs(store, {"r.0": _sorted_run([("a", [1])]),
                                "r.1": poison})
    out = SharedStore(str(tmp_path / "out"))
    assert native_merge.native_merge_reduce_sum(store, names, out,
                                                "res.P0") is False
    assert jax_nm.native_merge_reduce_sum(
        JaxShared(str(tmp_path / "runs")), names,
        JaxShared(str(tmp_path / "jout")), "res.P0") is False
    assert out.list("*") == []         # no partial result published


def test_premerge_spill_bytes_equal_jax(tmp_path):
    """A whole pre-merge job in one native pass: the port's spill bytes
    equal the JAX package's native spill and a v1 spill written by the
    Python merge (the C++ splices value spans raw; the Python path
    re-serializes them — identical text either way)."""
    rng = random.Random(5)
    runs = {f"result.P0.M{i:08d}": _random_run(rng, 30) for i in range(4)}
    spills = {}
    for side in ("port", "jax"):
        store = SharedStore(str(tmp_path / side))
        names = _write_runs(store, runs)
        mod, st = ((native_merge, store) if side == "port" else
                   (jax_nm, JaxShared(str(tmp_path / side))))
        assert mod.native_premerge(st, names, "result.P0.SPILL-00000-00003")
        spills[side] = store.read_range("result.P0.SPILL-00000-00003", 0,
                                        1 << 30)
    py = SharedStore(str(tmp_path / "py"))
    names = _write_runs(py, runs)
    b = py.builder()
    for k, vs in merge_iterator(py, names):
        b.write(dump_record(k, vs) + "\n")
    b.build("spill")
    assert spills["port"] == spills["jax"] == py.read_range("spill", 0,
                                                            1 << 30)


def _module(name, native_tag):
    mod = types.ModuleType(name)
    corpus = {"d1": "a b a c a", "d2": "b a d", "d3": "c c e"}
    mod.taskfn = lambda emit: [emit(k, v) for k, v in corpus.items()]

    def mapfn(key, value, emit):
        for w in value.split():
            emit(w, 1)
    mod.mapfn = mapfn
    mod.partitionfn = lambda key: sum(key.encode()) % 3

    def reducefn(key, values):
        return sum(values)
    reducefn.associative_reducer = True
    reducefn.commutative_reducer = True
    if native_tag:
        reducefn.native_reduce = "sum"
    mod.reducefn = reducefn
    sys.modules[name] = mod
    return name


def _results(tmp_path, sub):
    st = SharedStore(str(tmp_path / sub))
    return {n: st.read_range(n, 0, 1 << 20) for n in st.list("result.P*")}


def test_fold_sum_reduce_job_end_to_end(tmp_path, monkeypatch):
    """run_reduce_job routes a native_reduce='sum' + ACI reducer through
    the fused pass (a spy proves it ran) and the result files are
    byte-equal to the untagged Python run and to the JAX package's
    LocalExecutor on the same task."""
    from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
    from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxLocal
    from lua_mapreduce_tpu_torch.engine import job as job_mod
    from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
    from lua_mapreduce_tpu_torch.engine.local import LocalExecutor

    hits = []
    real = job_mod.native_merge_reduce_sum

    def counting(*a, **k):
        ok = real(*a, **k)
        hits.append(ok)
        return ok
    monkeypatch.setattr(job_mod, "native_merge_reduce_sum", counting)
    for variant, tag in (("native", True), ("python", False)):
        m = _module(f"tnm_fold_{variant}", tag)
        LocalExecutor(TaskSpec(taskfn=m, mapfn=m, partitionfn=m,
                               reducefn=m, init_args={"device": "cpu"},
                               storage=f"shared:{tmp_path}/{variant}")).run()
    JaxLocal(JaxSpec(taskfn="tnm_fold_native", mapfn="tnm_fold_native",
                     partitionfn="tnm_fold_native",
                     reducefn="tnm_fold_native",
                     storage=f"shared:{tmp_path}/jax")).run()
    assert hits and all(hits), "the fused native reduce never ran"
    got = _results(tmp_path, "native")
    assert got and got == _results(tmp_path, "python") \
        == _results(tmp_path, "jax")


def test_reduce_path_uses_it_end_to_end(tmp_path, monkeypatch):
    """A whole port run on shared: reduces through the native record
    merge (spied), results byte-equal to the JAX package's run."""
    from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
    from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxLocal
    from lua_mapreduce_tpu_torch.engine import job as job_mod
    from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
    from lua_mapreduce_tpu_torch.engine.local import LocalExecutor

    served = []
    real = job_mod.native_merge_records

    def counting(*a, **k):
        out = real(*a, **k)
        served.append(out is not None)
        return out
    monkeypatch.setattr(job_mod, "native_merge_records", counting)
    m = _module("tnm_merge", False)
    ex = LocalExecutor(TaskSpec(taskfn=m, mapfn=m, partitionfn=m,
                                reducefn=m, init_args={"device": "cpu"},
                                storage=f"shared:{tmp_path}/port"))
    ex.run()
    JaxLocal(JaxSpec(taskfn=m, mapfn=m, partitionfn=m, reducefn=m,
                     storage=f"shared:{tmp_path}/jax")).run()
    assert served and all(served)
    assert {k: v[0] for k, v in ex.results()} == \
        {"a": 4, "b": 2, "c": 3, "d": 1, "e": 1}
    assert _results(tmp_path, "port") == _results(tmp_path, "jax")


def test_unparseable_records_fall_back(tmp_path):
    """NaN keys parse on the Python path but not in C++: None (the
    caller falls back), not a raise mid-reduce — on both packages."""
    store = SharedStore(str(tmp_path))
    b = store.builder()
    b.write('[NaN,[1]]\n')
    b.build("nan_run")
    assert native_merge.native_merge_records(store, ["nan_run"]) is None
    assert jax_nm.native_merge_records(JaxShared(str(tmp_path)),
                                       ["nan_run"]) is None
    assert list(merge_iterator(store, ["nan_run"]))[0][1] == [1]


def test_global_native_kill_switch(tmp_path, monkeypatch):
    """LMR_DISABLE_NATIVE=1 turns every native path of the port off
    (one choke point: native_build.load_native)."""
    from lua_mapreduce_tpu_torch.core import native_wcmap
    from lua_mapreduce_tpu_torch.coord import idx
    store = SharedStore(str(tmp_path))
    _write_run(store, "a", [("k", [1, 2])])
    monkeypatch.setenv("LMR_DISABLE_NATIVE", "1")
    assert native_merge.native_available() is False
    assert native_merge.native_merge_records(store, ["a"]) is None
    assert native_merge.native_merge_reduce_sum(store, ["a"], store,
                                                "res") is False
    assert native_wcmap.native_available() is False
    assert idx.native_available() is False
    monkeypatch.delenv("LMR_DISABLE_NATIVE")
    assert native_merge.native_available() is True


def _segment_run(tmp_path, codec):
    store = SharedStore(str(tmp_path / f"seg-{codec}"))
    rng = random.Random(3)
    w = SegmentWriter(store.builder(), codec=codec, frame_bytes=256)
    run = _random_run(rng, 40)
    for k, v in run:
        w.add(k, v)
    w.build("run")
    return store.local_path("run")


def test_zlib_and_bare_builds(tmp_path):
    """The library builds with zlib first (-DLMR_HAVE_ZLIB -lz), else
    bare: a bare build decodes raw v2 frames but returns rc 2 on a
    zlib-compressed frame, where the Python reader takes over. Both
    variants built here from the port's source."""
    from lua_mapreduce_tpu_torch.core.native_build import library_path
    with open(library_path(native_merge._SRC) + ".src.sha256") as f:
        assert f.read().split()[1:] == ["-DLMR_HAVE_ZLIB", "-lz"]
    bare = str(tmp_path / "libbare.so")
    subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", bare,
                    native_merge._SRC], check=True, capture_output=True)
    libs = {"zlib": native_merge._load(), "bare": ctypes.CDLL(bare)}
    for lib in libs.values():
        lib.smerge_files.restype = ctypes.c_int
        lib.smerge_files.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                     ctypes.c_int, ctypes.c_char_p]
    rcs = {}
    for codec in ("raw", "zlib"):
        path = _segment_run(tmp_path, codec)
        for name, lib in libs.items():
            arr = (ctypes.c_char_p * 1)(path.encode())
            out = str(tmp_path / f"{name}-{codec}.m")
            rcs[name, codec] = lib.smerge_files(arr, 1, out.encode())
    assert rcs == {("zlib", "raw"): 0, ("bare", "raw"): 0,
                   ("zlib", "zlib"): 0, ("bare", "zlib"): 2}


def test_library_lives_under_build_native():
    """The port's libraries build into <repo>/build/native/, never beside
    the sources."""
    from lua_mapreduce_tpu_torch.core.native_build import (BUILD_DIR,
                                                           library_path)
    so = library_path(native_merge._SRC)
    assert os.path.dirname(so) == str(BUILD_DIR)
    assert BUILD_DIR.parts[-2:] == ("build", "native")
    assert os.path.exists(so)
    assert not os.path.exists(os.path.join(os.path.dirname(
        native_merge._SRC), "libshufflemerge.so"))
