"""The port's pipelined shuffle (``engine/premerge.py``, eager pre-merge
with no map→reduce barrier) ≡ the JAX package's: the same spill names
and spill bytes as the JAX ``LocalExecutor(pipeline=True)``, result
files byte-equal to the JAX package's and to the barrier run over the
wordcount configs × {mem, shared, object}, the loop protocol, the
Server / Worker pool with ``pre_merge`` jobs, and the tracker's and
discovery's rules. Counterparts of ``tests/test_pipeline_shuffle.py``."""

import glob
import os
import re
import sys
import threading
import types

import pytest

from examples.wordcount.naive import naive_wordcount
from lua_mapreduce_tpu.engine import local as jax_local
from lua_mapreduce_tpu.engine import premerge as jax_premerge
from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
from lua_mapreduce_tpu.store.router import get_storage_from as jax_store
from lua_mapreduce_tpu_torch.engine import local as port_local
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.job import map_key_str
from lua_mapreduce_tpu_torch.engine.local import LocalExecutor
from lua_mapreduce_tpu_torch.engine.premerge import (PremergeTracker,
                                                     discover_pipelined,
                                                     parse_spill_name,
                                                     spill_name)
from lua_mapreduce_tpu_torch.store.router import get_storage_from

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(
    glob.glob(os.path.join(REPO, "lua_mapreduce_tpu", "engine", "*.py"))
    + glob.glob(os.path.join(REPO, "lua_mapreduce_tpu", "store", "*.py"))
    + glob.glob(os.path.join(REPO, "lua_mapreduce_tpu", "coord", "*.py")))

CONFIGS = {
    "combiner": dict(
        taskfn="examples.wordcount.taskfn",
        mapfn="examples.wordcount.mapfn",
        partitionfn="examples.wordcount.partitionfn",
        reducefn="examples.wordcount.reducefn",
        combinerfn="examples.wordcount.reducefn",
        finalfn="examples.wordcount.finalfn"),
    "no_combiner": dict(
        taskfn="examples.wordcount.taskfn",
        mapfn="examples.wordcount.mapfn",
        partitionfn="examples.wordcount.partitionfn",
        reducefn="examples.wordcount.reducefn",
        finalfn="examples.wordcount.finalfn"),
    "general_reducer": dict(
        taskfn="examples.wordcount.taskfn",
        mapfn="examples.wordcount.mapfn",
        partitionfn="examples.wordcount.partitionfn",
        reducefn="examples.wordcount.reducefn2",
        finalfn="examples.wordcount.finalfn"),
}

_RESULT_RE = re.compile(r"^result\.P(\d+)$")


def _result_bytes(store):
    return {n: "".join(store.lines(n)) for n in store.list("result.P*")
            if _RESULT_RE.match(n)}


def _storages(tmp_path, backend, tag):
    return {side: {"mem": f"mem:tpipe-{tag}-{side}",
                   "shared": f"shared:{tmp_path}/{side}",
                   "object": f"object:{tmp_path}/{side}"}[backend]
            for side in ("jax", "port", "bar")}


def _spill_recorder(module, sink):
    """Wrap ``module.run_premerge_job`` so every published spill's name
    and bytes land in ``sink`` before the reduce consumes it."""
    orig = module.run_premerge_job

    def recording(spec, store, run_files, spill_file, **kw):
        t = orig(spec, store, run_files, spill_file, **kw)
        sink[spill_file] = store.read_range(spill_file, 0,
                                            store.size(spill_file))
        return t
    return recording


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("backend", ["mem", "shared", "object"])
def test_pipelined_spills_and_results_equal_jax(tmp_path, monkeypatch,
                                                config, backend):
    """One map thread makes the spill schedule deterministic: the port
    publishes the JAX package's spill names with the same bytes (v2
    frames), and the result files equal the JAX package's pipelined run
    and the port's barrier run."""
    monkeypatch.setenv("LMR_DISABLE_NATIVE", "1")   # JAX's Python merge
    st = _storages(tmp_path, backend, config)
    jax_spills, port_spills = {}, {}
    monkeypatch.setattr(jax_local, "run_premerge_job",
                        _spill_recorder(jax_local, jax_spills))
    monkeypatch.setattr(port_local, "run_premerge_job",
                        _spill_recorder(port_local, port_spills))
    jax_local.LocalExecutor(
        JaxSpec(init_args={"files": CORPUS}, storage=st["jax"],
                **CONFIGS[config]),
        map_parallelism=1, pipeline=True, premerge_min_runs=2,
        segment_format="v2").run()
    stats = LocalExecutor(
        TaskSpec(init_args={"files": CORPUS}, storage=st["port"],
                 **CONFIGS[config]),
        map_parallelism=1, pipeline=True, premerge_min_runs=2,
        segment_format="v2", engine="store").run()
    LocalExecutor(TaskSpec(init_args={"files": CORPUS}, storage=st["bar"],
                           **CONFIGS[config]), engine="store").run()
    assert jax_spills and sorted(port_spills) == sorted(jax_spills)
    for name, data in jax_spills.items():
        assert parse_spill_name("result", name) is not None
        assert port_spills[name] == data, name
    want = _result_bytes(jax_store(st["jax"]))
    assert want and _result_bytes(get_storage_from(st["port"])) == want
    assert _result_bytes(get_storage_from(st["bar"])) == want
    it = stats.iterations[-1]
    assert it.premerge.count == len(port_spills) and it.premerge.failed == 0
    assert 0.0 <= it.overlap_fraction <= 1.0
    leftovers = [n for n in get_storage_from(st["port"]).list("result.P*")
                 if ".SPILL-" in n or ".M" in n]
    assert leftovers == []


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("backend", ["mem", "shared", "object"])
def test_pipelined_byte_identical_to_barrier(tmp_path, config, backend):
    """Four map threads (the schedule then depends on timing): the
    pipelined result bytes still equal the barrier run's and the naive
    count."""
    import examples.wordcount.finalfn as fmod
    st = _storages(tmp_path, backend, f"mt-{config}")
    out = {}
    for side, pipeline in (("bar", False), ("port", True)):
        ex = LocalExecutor(TaskSpec(init_args={"files": CORPUS},
                                    storage=st[side], **CONFIGS[config]),
                           map_parallelism=4, pipeline=pipeline,
                           premerge_min_runs=2, engine="store")
        stats = ex.run()
        assert dict(fmod.counts) == naive_wordcount(CORPUS)
        out[side] = _result_bytes(ex.result_store)
    assert out["bar"] and out["bar"] == out["port"]
    it = stats.iterations[-1]
    assert it.premerge.count > 0 and it.premerge.failed == 0


def test_pipelined_loop_protocol():
    state = {"it": 0, "seen": []}

    def taskfn(emit):
        words = (["alpha", "beta"] * 8) if state["it"] == 0 else ["alpha"] * 8
        for i, w in enumerate(words):
            emit(i, [w])

    def mapfn(key, words, emit):
        for w in words:
            emit(w, 1)

    def finalfn(pairs):
        state["seen"] = sorted((k, v[0]) for k, v in pairs)
        state["it"] += 1
        return "loop" if state["it"] < 3 else None

    spec = TaskSpec(taskfn=taskfn, mapfn=mapfn,
                    partitionfn=lambda key: 0 if key == "alpha" else 1,
                    reducefn=lambda key, values: sum(values),
                    finalfn=finalfn, storage="mem:tpipe-loop")
    stats = LocalExecutor(spec, map_parallelism=4, pipeline=True,
                          premerge_min_runs=2, engine="store").run()
    assert state["it"] == 3 and len(stats.iterations) == 3
    assert state["seen"] == [("alpha", 8)]
    assert sum(it.premerge.count for it in stats.iterations) > 0


def _srv_module():
    mod = types.ModuleType("_tpipe_srv_mod")

    def taskfn(emit):
        for i in range(12):
            emit(i, i)

    def mapfn(key, value, emit):
        for j in range(30):
            emit(f"k{(value * 31 + j) % 17:02d}", 1)

    mod.taskfn, mod.mapfn = taskfn, mapfn
    mod.reducefn = lambda key, values: sum(values)
    mod.partitionfn = lambda key: int(key[1:]) % 3
    sys.modules["_tpipe_srv_mod"] = mod


@pytest.mark.parametrize("segment_format", ["v1", "v2"])
def test_pipelined_server_inprocess(segment_format):
    """Server + worker threads with pipeline=True: pre_merge jobs are
    claimed under the CAS protocol and the result equals the barrier
    server's byte for byte; the task document carries the mode."""
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
    from lua_mapreduce_tpu_torch.engine.server import Server
    from lua_mapreduce_tpu_torch.engine.worker import Worker
    _srv_module()

    def leg(pipeline, tag):
        store = MemJobStore()
        spec = TaskSpec(taskfn="_tpipe_srv_mod", mapfn="_tpipe_srv_mod",
                        partitionfn="_tpipe_srv_mod",
                        reducefn="_tpipe_srv_mod", storage=f"mem:{tag}",
                        init_args={"device": "cpu"})
        server = Server(store, poll_interval=0.01, pipeline=pipeline,
                        premerge_min_runs=2, segment_format=segment_format,
                        engine="store").configure(spec)
        workers = [Worker(store).configure(max_iter=600, max_sleep=0.02)
                   for _ in range(3)]
        threads = [threading.Thread(target=w.execute, daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        stats = server.loop()
        for t in threads:
            t.join(timeout=30)
        doc = store.get_task()
        assert doc["pipeline"] is pipeline
        assert doc["segment_format"] == segment_format
        return _result_bytes(get_storage_from(f"mem:{tag}")), stats

    bytes_b, _ = leg(False, f"tpipe-srv-b-{segment_format}")
    bytes_p, stats_p = leg(True, f"tpipe-srv-p-{segment_format}")
    assert bytes_b and bytes_b == bytes_p
    it = stats_p.iterations[-1]
    assert it.map.failed == it.reduce.failed == it.premerge.failed == 0


def test_pipeline_is_sticky_on_resume_from_the_task_document():
    """A resumed server keeps the crashed run's shuffle mode: a doc that
    says pipelined wins over a barrier server's own setting."""
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
    from lua_mapreduce_tpu_torch.core.constants import TaskStatus
    from lua_mapreduce_tpu_torch.engine.server import Server
    from lua_mapreduce_tpu_torch.engine.worker import Worker
    _srv_module()
    store = MemJobStore()
    spec = TaskSpec(taskfn="_tpipe_srv_mod", mapfn="_tpipe_srv_mod",
                    partitionfn="_tpipe_srv_mod", reducefn="_tpipe_srv_mod",
                    storage="mem:tpipe-sticky", init_args={"device": "cpu"})
    store.put_task({"_id": "unique", "status": TaskStatus.WAIT.value,
                    "iteration": 1, "spec": spec.describe(),
                    "pipeline": True, "engine": "store"})
    server = Server(store, poll_interval=0.01, premerge_min_runs=2)
    w = Worker(store).configure(max_iter=600, max_sleep=0.02)
    t = threading.Thread(target=w.execute, daemon=True)
    t.start()
    stats = server.loop()
    t.join(timeout=30)
    assert server.pipeline is True and store.get_task()["pipeline"] is True
    got = {k: v[0] for k, v in port_local.iter_results(
        get_storage_from("mem:tpipe-sticky"), "result")}
    assert sum(got.values()) == 12 * 30
    assert stats.iterations[-1].map.count == 12


def test_pipelined_with_compiled_engines_follows_jax():
    """The JAX rule: an in-graph iteration ignores ``pipeline`` (the
    compiled plane publishes results itself); the hybrid compiled map
    leg runs only on the barrier path, so a pipelined hybrid task maps
    interpreted (no ``hybrid_map_legs``) and still pre-merges."""
    from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
    mod = types.ModuleType("_tpipe_hy")
    src = '''
import torch

def taskfn(emit):
    for j in range(8):
        emit(j, {"v": [float(j), 1.0]})

def mapfn(key, value, emit):
    v = torch.tensor(value["v"])
    emit(key % 3, {"s": torch.sum(v)})

def partitionfn(key):
    return key % 2

def reducefn(key, values):
    return {"s": sum(v["s"] for v in values)}
'''
    exec(compile(src, "_tpipe_hy", "exec"), mod.__dict__)
    sys.modules["_tpipe_hy"] = mod
    spec = TaskSpec(taskfn="_tpipe_hy", mapfn="_tpipe_hy",
                    partitionfn="_tpipe_hy", reducefn="_tpipe_hy",
                    storage="mem:tpipe-hy", init_args={"device": "cpu"})
    base = LocalExecutor(spec, engine="store")
    base.run()
    want = _result_bytes(base.result_store)
    c0 = COUNTERS.snapshot()
    ex = LocalExecutor(spec, engine="hybrid", pipeline=True,
                       premerge_min_runs=2)
    stats = ex.run()
    delta = COUNTERS.delta(c0, COUNTERS.snapshot())
    assert _result_bytes(ex.result_store) == want
    assert delta.get("hybrid_map_legs", 0) == 0
    assert stats.iterations[-1].premerge.count > 0


# --- tracker and discovery ---------------------------------------------------

def test_tracker_schedule_equals_jax():
    """The same commit sequence gives the same spill jobs (names, files,
    ranges) in both packages, absent runs transparent, failures
    poisoning their range."""
    keys = [map_key_str(i) for i in range(12)]
    out = []
    for Tracker in (PremergeTracker, jax_premerge.PremergeTracker):
        tr = Tracker("r", keys, min_runs=3, max_runs=4)
        log = []
        for i in (0, 2, 3, 1, 5, 4, 6, 7, 8, 11, 9, 10):
            parts = {} if i == 1 else {p: f"r.P{p}.M{keys[i]}"
                                       for p in (0, 1) if (i + p) % 5}
            tr.note_map_committed(keys[i], parts)
            spills = tr.take_eligible()
            for sp in spills:
                if sp.seq == 1:
                    tr.spill_failed(sp.part, sp.seq, spill_exists=False)
                else:
                    tr.spill_done(sp.part, sp.seq)
            log.append([(sp.part, sp.seq, sp.a, sp.b, sp.files, sp.name)
                        for sp in spills])
        out.append((log, {p: sorted(s) for p, s in tr.poisoned.items()}))
    assert out[0] == out[1]
    assert any(out[0][0])


def test_spill_names_parse_like_jax():
    for args in (("result", 0, 0, 7), ("r.x", 12, 100, 12345)):
        name = spill_name(*args)
        assert name == jax_premerge.spill_name(*args)
        assert parse_spill_name(args[0], name) == \
            jax_premerge.parse_spill_name(args[0], name) == args[1:]
    assert parse_spill_name("result", "result.P0.M00000001") is None


def test_discover_pipelined_overlapping_spills():
    ns = "result"
    keys = [map_key_str(i) for i in range(10)]

    def put(store, name):
        b = store.builder()
        b.write("x 1\n")
        b.build(name)

    st = get_storage_from("mem:toverlap-nested")
    put(st, spill_name(ns, 0, 0, 7))
    put(st, spill_name(ns, 0, 0, 5))
    put(st, f"{ns}.P0.M{keys[8]}")
    put(st, f"{ns}.P0.M{keys[3]}")            # leftover inside the spill
    parts = discover_pipelined(st, ns, keys)
    assert parts[0] == [spill_name(ns, 0, 0, 7), f"{ns}.P0.M{keys[8]}"]
    assert not st.exists(spill_name(ns, 0, 0, 5))
    assert not st.exists(f"{ns}.P0.M{keys[3]}")
    st2 = get_storage_from("mem:toverlap-staggered")
    put(st2, spill_name(ns, 0, 0, 3))
    put(st2, spill_name(ns, 0, 2, 5))
    with pytest.raises(RuntimeError, match="staggered"):
        discover_pipelined(st2, ns, keys)


def test_premerge_job_short_circuits_on_an_existing_spill():
    """A duplicate pre_merge execution (stale requeue) finds the spill
    already published and only sweeps leftover inputs; missing inputs
    with no spill raise."""
    from lua_mapreduce_tpu_torch.engine.job import run_premerge_job
    st = get_storage_from("mem:tpipe-dup")
    for name, body in (("result.P0.SPILL-00000-00001", '["a",[1,2]]\n'),
                       ("result.P0.M00000001", '["a",[2]]\n')):
        b = st.builder()
        b.write(body)
        b.build(name)
    run_premerge_job(None, st, ["result.P0.M00000000", "result.P0.M00000001"],
                     "result.P0.SPILL-00000-00001")
    assert st.list("result.P0.*") == ["result.P0.SPILL-00000-00001"]
    with pytest.raises(RuntimeError, match="missing"):
        run_premerge_job(None, st, ["result.P1.M00000000"],
                         "result.P1.SPILL-00000-00000")
