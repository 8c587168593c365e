"""The port's native C++ word-count map (core/native_wcmap.py over its
own copy of wcmap.cpp) against the JAX package: the same map job run
natively by the port, natively by the JAX package and through the
Python mapfn + partitionfn writes byte-equal run files; non-ASCII input
falls back to Python on both; the Europarl-scale task module's tag runs
natively inside a whole port run, byte-equal to the JAX package's run.
Mirrors tests/test_native_wcmap.py; runs wherever g++ builds."""

import sys
import types
from collections import Counter

import pytest

from lua_mapreduce_tpu.core import native_wcmap as jax_nw
from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
from lua_mapreduce_tpu.engine.job import run_map_job as jax_run_map_job
from lua_mapreduce_tpu.store.sharedfs import SharedStore as JaxShared
from lua_mapreduce_tpu_torch.core import native_wcmap
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.job import run_map_job
from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore

pytestmark = pytest.mark.skipif(
    not (native_wcmap.native_available() and jax_nw.native_available()),
    reason="native wcmap did not build (no g++?)")

TEXT = ('the quick "brown" fox\tjumps\n over the lazy dog\n'
        'the fox\x1cagain\nback\\slash and tab\there\n' + "zz " * 2500)

_MOD = "tests._torch_wcmap_mod"


def _module(inp):
    mod = types.ModuleType(_MOD)

    def mapfn(key, value, emit):
        with open(value) as f:
            counts = Counter(f.read().split())
        for w, n in counts.items():
            emit(w, n)
    mod.mapfn = mapfn
    mod.taskfn = lambda emit: emit("s", str(inp))
    mod.partitionfn = lambda key: sum(key[:4].encode()) % 5
    mod.reducefn = lambda key, values: sum(values)
    sys.modules[_MOD] = mod
    return mod


def _run_all(tmp_path, text):
    """One map job four ways: port native, port Python, JAX native, JAX
    Python; each variant's run files by name."""
    inp = tmp_path / "split0.txt"
    inp.write_text(text)
    mapfn = _module(inp).mapfn
    outs = {}
    for pkg, spec_cls, store_cls, run in (
            ("port", TaskSpec, SharedStore, run_map_job),
            ("jax", JaxSpec, JaxShared, jax_run_map_job)):
        for variant in ("native", "python"):
            if variant == "native":
                mapfn.native_map = {"kind": "wordcount_file",
                                    "num_reducers": 5, "hash_prefix": 4}
            else:
                mapfn.__dict__.pop("native_map", None)
            spill = str(tmp_path / f"spill_{pkg}_{variant}")
            kw = {"init_args": {"device": "cpu"}} if pkg == "port" else {}
            spec = spec_cls(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                            reducefn=_MOD, storage=f"shared:{spill}", **kw)
            store = store_cls(spill)
            run(spec, store, "0", "s", str(inp))
            outs[pkg, variant] = {n: "".join(store.lines(n))
                                  for n in store.list("result.P*.M*")}
    return outs


def test_native_run_files_byte_identical(tmp_path):
    outs = _run_all(tmp_path, TEXT)
    assert outs["port", "native"], "the native path wrote no run files"
    assert outs["port", "native"] == outs["port", "python"] \
        == outs["jax", "native"] == outs["jax", "python"]


def test_non_ascii_falls_back_to_python(tmp_path, monkeypatch):
    """Unicode input (NBSP is Python whitespace): rc 2 hands the job to
    Python on both packages — the results are still right."""
    seen = []
    real = native_wcmap.run_native_map
    import lua_mapreduce_tpu_torch.core.native_wcmap as nw

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]
    monkeypatch.setattr(nw, "run_native_map", spy)
    outs = _run_all(tmp_path, "café nb sp café\n")
    assert seen == [False]
    assert outs["port", "native"] == outs["port", "python"] \
        == outs["jax", "native"]
    joined = "".join(outs["port", "native"].values())
    assert '["café",[2]]' in joined
    assert '["nb",[1]]' in joined and '["sp",[1]]' in joined


def test_bigtask_tag_runs_native_end_to_end(tmp_path, monkeypatch):
    """examples/wordcount_big/bigtask's tags route a whole port run
    through the native map (every map job, spied) and the fused native
    sum; result files byte-equal to the JAX package's LocalExecutor and
    the counts to a naive count."""
    from examples.wordcount_big import corpus
    from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxLocal
    from lua_mapreduce_tpu_torch.core import native_merge
    from lua_mapreduce_tpu_torch.engine import job as job_mod
    from lua_mapreduce_tpu_torch.engine.local import LocalExecutor

    hits = {"map": [], "sum": []}
    real_map = native_wcmap.run_native_map
    real_sum = native_merge.native_merge_reduce_sum

    def map_spy(*a, **k):
        hits["map"].append(real_map(*a, **k))
        return hits["map"][-1]

    def sum_spy(*a, **k):
        hits["sum"].append(real_sum(*a, **k))
        return hits["sum"][-1]
    monkeypatch.setattr(native_wcmap, "run_native_map", map_spy)
    monkeypatch.setattr(job_mod, "native_merge_reduce_sum", sum_spy)

    cdir = str(tmp_path / "corpus")
    corpus.build(cdir, n_splits=3)
    big = "examples.wordcount_big.bigtask"
    args = {"corpus_dir": cdir, "n_splits": 3}
    ex = LocalExecutor(TaskSpec(taskfn=big, mapfn=big, partitionfn=big,
                                reducefn=big,
                                init_args={**args, "device": "cpu"},
                                storage=f"shared:{tmp_path}/port"))
    ex.run()
    JaxLocal(JaxSpec(taskfn=big, mapfn=big, partitionfn=big, reducefn=big,
                     init_args=args,
                     storage=f"shared:{tmp_path}/jax")).run()
    assert hits["map"] == [True] * 3, "native map did not serve every map"
    assert hits["sum"] and all(hits["sum"]), "the fused sum did not run"
    want = Counter()
    for i in range(3):
        with open(corpus.split_path(cdir, i)) as f:
            want.update(f.read().split())
    assert {k: v[0] for k, v in ex.results()} == dict(want)
    port, jax = (SharedStore(str(tmp_path / s)) for s in ("port", "jax"))
    names = port.list("result.P*")
    assert names and names == jax.list("result.P*")
    assert all(port.read_range(n, 0, 1 << 24) == jax.read_range(n, 0, 1 << 24)
               for n in names)


def test_replicated_map_takes_the_python_path(tmp_path):
    """Under replication the reading view hides ``local_path``: the map
    runs the Python path and publishes every copy (a native map would
    write the primary only)."""
    from lua_mapreduce_tpu_torch.faults.replicate import reading_view
    inp = tmp_path / "split0.txt"
    inp.write_text(TEXT)
    mapfn = _module(inp).mapfn
    mapfn.native_map = {"kind": "wordcount_file", "num_reducers": 5,
                        "hash_prefix": 4}
    spill = str(tmp_path / "spill_r2")
    store = SharedStore(spill)
    assert not hasattr(reading_view(store, 2), "local_path")
    spec = TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, storage=f"shared:{spill}",
                    init_args={"device": "cpu"})
    calls = []
    real = native_wcmap.run_native_map

    def spy(*a, **k):
        calls.append(real(*a, **k))
        return calls[-1]
    native_wcmap.run_native_map = spy
    try:
        run_map_job(spec, store, "0", "s", str(inp), replication=2)
    finally:
        native_wcmap.run_native_map = real
    assert calls == [False]
    names = store.list("*")
    assert sum(n.startswith("~1.") for n in names) == 5, names   # copies
