"""The port's lmr-trace (``trace/``) ≡ the JAX package's: deterministic
span ids, the collector's report and Chrome export on the same span
dicts, the trace CLI reading a store the JAX package traced, and the
engines' invariants — tracing off and on give the same result bytes,
the wrapper layers are absent when off, every committed job keeps an
unbroken claim → body → commit chain under a fault plan, an errors
entry links to its live span, both executors fold the same counter key
set as the JAX package, and ``--trace --profile`` puts span names into
the torch profile, and a speculated job shows one commit span beside
its clone's speculative claim and a loser chain. Counterparts of
``tests/test_trace.py``."""

import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import threading
import types
from typing import Dict

import pytest

from lua_mapreduce_tpu.trace import collect as jax_collect
from lua_mapreduce_tpu.trace import span as jax_span
from lua_mapreduce_tpu.utils.stats import IterationStats as JaxIterStats
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.core.constants import (MAP_NS, PRE_NS, RED_NS,
                                                    Status)
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.local import LocalExecutor, iter_results
from lua_mapreduce_tpu_torch.engine.server import Server
from lua_mapreduce_tpu_torch.engine.worker import Worker
from lua_mapreduce_tpu_torch.faults import FaultPlan, install_fault_plan
from lua_mapreduce_tpu_torch.store.router import get_storage_from
from lua_mapreduce_tpu_torch.trace import (TraceCollection, Tracer,
                                           install_tracer, span_id,
                                           validate_chrome)
from lua_mapreduce_tpu_torch.utils.stats import COUNTER_FOLD, IterationStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu"}

CORPUS = {f"doc{i}": " ".join(f"w{(i * 5 + j) % 17}" for j in range(30))
          for i in range(6)}
GOLDEN: Dict[str, int] = {}
for _text in CORPUS.values():
    for _w in _text.split():
        GOLDEN[_w] = GOLDEN.get(_w, 0) + 1

_MOD = "tests._torch_trace_wc"


def _install_module():
    mod = sys.modules.get(_MOD)
    if mod is None:
        mod = types.ModuleType(_MOD)

        def taskfn(emit):
            for k, v in sorted(CORPUS.items()):
                emit(k, v)

        def mapfn(key, value, emit):
            for w in value.split():
                emit(w, 1)

        mod.taskfn = taskfn
        mod.mapfn = mapfn
        mod.partitionfn = lambda key: sum(key.encode()) % 3
        mod.reducefn = lambda key, values: sum(values)
        sys.modules[_MOD] = mod
    return mod


def _spec(storage):
    _install_module()
    return TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, storage=storage, init_args=dict(CPU))


def _storage(tmp_path, backend, tag):
    return {"mem": f"mem:{tag}",
            "shared": f"shared:{tmp_path}/shared-{tag}",
            "object": f"object:{tmp_path}/object-{tag}"}[backend]


def _result_bytes(storage_spec, ns="result"):
    store = get_storage_from(storage_spec)
    keep = re.compile(rf"^{re.escape(ns)}\.P\d+$")
    return {name: "".join(store.lines(name))
            for name in store.list(f"{ns}.P*") if keep.match(name)}


def _run_local(tmp_path, backend, tag, traced, pipeline=True, plan=None,
               tracer=None):
    spec = _spec(_storage(tmp_path, backend, tag))
    install_fault_plan(plan)
    install_tracer((tracer or Tracer()) if traced else None)
    try:
        ex = LocalExecutor(spec, map_parallelism=3, pipeline=pipeline,
                           premerge_min_runs=2, engine="store")
        stats = ex.run()
    finally:
        install_tracer(None)
        install_fault_plan(None)
    assert {k: v[0] for k, v in ex.results()} == GOLDEN
    return spec, stats


def _run_distributed(tmp_path, backend, tag, traced, plan=None,
                     n_workers=2, batch_k=2, pipeline=False,
                     speculation=0.0, straggler=False):
    spec = _spec(_storage(tmp_path, backend, tag))
    store = MemJobStore()
    install_fault_plan(plan)
    install_tracer(Tracer() if traced else None)
    try:
        server = Server(store, poll_interval=0.01, pipeline=pipeline,
                        premerge_min_runs=2, batch_k=batch_k,
                        speculation=speculation,
                        engine="store").configure(spec)
        # ``straggler``: the last worker is "straggler-0" (the slow plan
        # kind's target) and claims first
        names = ([f"healthy-{i}" for i in range(n_workers - 1)]
                 + ["straggler-0"] if straggler else [None] * n_workers)
        workers = [Worker(store, name=names[i]).configure(max_iter=800,
                                                          max_sleep=0.02)
                   for i in range(n_workers)]
        threads = [threading.Thread(target=w.execute, daemon=True)
                   for w in workers]
        if straggler:
            import time
            final = {}
            st = threading.Thread(
                target=lambda: final.setdefault("stats", server.loop()),
                daemon=True)
            st.start()
            threads[-1].start()
            deadline = time.time() + 30
            while store.counts(MAP_NS)[Status.RUNNING] == 0:
                assert time.time() < deadline, "no lease was claimed"
                time.sleep(0.005)
            for t in threads[:-1]:
                t.start()
            st.join(timeout=120)
            assert not st.is_alive(), "server wedged under the straggler"
            stats = final["stats"]
        else:
            for t in threads:
                t.start()
            stats = server.loop()
        for t in threads:
            t.join(timeout=30)
    finally:
        install_tracer(None)
        install_fault_plan(None)
    got = {k: v[0] for k, v in iter_results(get_storage_from(spec.storage),
                                            "result")}
    assert got == GOLDEN
    return spec, store, stats, server


def _committed(store):
    return [(ns, d["_id"]) for ns in (MAP_NS, PRE_NS, RED_NS)
            for d in store.jobs(ns) if d["status"] == Status.WRITTEN]


# --- cross-package parity ----------------------------------------------------

@pytest.mark.parametrize("coords", [
    ("w1", "map_jobs", 3, 0, "map.body", 0),
    ("server", None, None, None, "phase.map", 2),
    ("worker-ab12-77", "red_jobs", 0, -1, "commit", 5),
    ("local", "pre_jobs", "1.4", 0, "pre_merge.body", 1),
])
def test_span_ids_equal_jax(coords):
    assert span_id(*coords) == jax_span.span_id(*coords)


def test_tracers_on_a_virtual_clock_record_the_same_spans():
    """The same recording sequence on an injected clock gives the same
    span dicts (ids, parents, context inheritance) in both packages."""
    out = []
    for Tr in (Tracer, jax_span.Tracer):
        now = [100.0]
        tr = Tr(clock=lambda: now[0])
        tr.set_actor("w1")
        tr.set_iteration(2)
        with tr.span("map.body", ns="map_jobs", job_id=3, attempt=0):
            now[0] = 101.0
            tr.op("store.build", 100.5, file="result.P0.M3")
        try:
            with tr.span("reduce.body", ns="red_jobs", job_id=0, attempt=1):
                raise ValueError("boom")
        except ValueError:
            pass
        tr.add("claim", 99.0, 99.5, ns="map_jobs", job_id=3, attempt=0)
        out.append(tr.drain())
    assert out[0] == out[1]


def _span_dicts(tmp_path):
    """Real spans from a traced port pool run with a fault plan."""
    plan = FaultPlan(29, transient=0.08, latency=0.05,
                     error_after_write=0.3, latency_ms=1.0, max_per_key=2)
    spec, store, _, _ = _run_distributed(tmp_path, "mem", "tr-parity",
                                         traced=True, plan=plan,
                                         pipeline=True)
    return TraceCollection.from_store(
        get_storage_from(spec.storage)).spans, _committed(store)


def test_collector_report_and_chrome_export_equal_jax(tmp_path):
    spans, committed = _span_dicts(tmp_path)
    port = TraceCollection(json.loads(json.dumps(spans)))
    jax = jax_collect.TraceCollection(json.loads(json.dumps(spans)))
    assert port.op_stats() == jax.op_stats()
    assert port.phase_waterfall() == jax.phase_waterfall()
    assert port.premerge_overlap() == jax.premerge_overlap()
    assert port.slowest_jobs(5) == jax.slowest_jobs(5)
    assert port.engines_by_iteration() == jax.engines_by_iteration()
    assert port.lowering_decisions() == jax.lowering_decisions()
    assert port.dispatch_stats() == jax.dispatch_stats()
    assert port.check_complete(committed) == \
        jax.check_complete(committed) == []
    doc = port.to_chrome()
    assert doc == jax.to_chrome()
    assert validate_chrome(doc) == jax_collect.validate_chrome(doc) == []


def test_port_trace_cli_reads_a_jax_traced_store(tmp_path):
    """``python -m lua_mapreduce_tpu_torch.trace`` over a shared store a
    JAX-package traced run wrote: the port's report equals the JAX
    CLI's report on the same store."""
    from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxSpec
    from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxExecutor
    files = sorted(glob.glob(os.path.join(REPO, "lua_mapreduce_tpu",
                                          "core", "*.py")))[:5]
    storage = f"shared:{tmp_path}/jax"
    jax_span.install_tracer(jax_span.Tracer())
    try:
        JaxExecutor(JaxSpec(init_args={"files": files}, storage=storage,
                            taskfn="examples.wordcount.taskfn",
                            mapfn="examples.wordcount.mapfn",
                            partitionfn="examples.wordcount.partitionfn",
                            reducefn="examples.wordcount.reducefn"),
                    map_parallelism=2, pipeline=True,
                    premerge_min_runs=2).run()
    finally:
        jax_span.install_tracer(None)
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    reports = []
    for pkg in ("lua_mapreduce_tpu_torch", "lua_mapreduce_tpu"):
        r = subprocess.run([sys.executable, "-m", f"{pkg}.trace", storage,
                            "--format", "json"], capture_output=True,
                           text=True, env=env, cwd=REPO, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr
        reports.append(json.loads(r.stdout))
    assert reports[0]["spans"] > 0 and reports[0] == reports[1]


# --- engine invariants -------------------------------------------------------

def test_trace_smoke_local_artifacts(tmp_path):
    spec, _ = _run_local(tmp_path, "mem", "ttr-smoke", traced=True)
    col = TraceCollection.from_store(get_storage_from(spec.storage))
    assert col.spans
    assert {"map", "reduce"} <= {r["phase"] for r in col.phase_waterfall()}
    ops = col.op_stats()
    assert ops and any(n.startswith("store.") for n in ops)
    for name, st in ops.items():
        assert st["count"] > 0 and st["p50_ms"] <= st["p99_ms"] \
            <= st["max_ms"] + 1e-9, (name, st)
    doc = col.to_chrome()
    assert validate_chrome(doc) == []
    assert any(e["ph"] == "X" and e["name"] == "map.body"
               for e in doc["traceEvents"])
    assert col.premerge_overlap() is not None
    assert col.slowest_jobs(3)


@pytest.mark.parametrize("backend", ["mem", "shared", "object"])
def test_trace_smoke_off_on_byte_identical(tmp_path, backend):
    _run_local(tmp_path, backend, f"ttr-off-{backend}", traced=False)
    _run_local(tmp_path, backend, f"ttr-on-{backend}", traced=True)
    off = _result_bytes(_storage(tmp_path, backend, f"ttr-off-{backend}"))
    on = _result_bytes(_storage(tmp_path, backend, f"ttr-on-{backend}"))
    assert off and off == on
    assert get_storage_from(_storage(
        tmp_path, backend, f"ttr-off-{backend}")).list("_trace.*") == []
    assert get_storage_from(_storage(
        tmp_path, backend, f"ttr-on-{backend}")).list("_trace.*") != []


def _layers(obj):
    names = []
    while hasattr(obj, "_inner"):
        names.append(type(obj).__name__)
        obj = obj._inner
    return names


def test_trace_off_wiring_is_absent():
    from lua_mapreduce_tpu_torch.faults.wrappers import (unwrap,
                                                         wrap_jobstore,
                                                         wrap_store)
    from lua_mapreduce_tpu_torch.store.memfs import MemStore
    assert "TracingStore" not in _layers(wrap_store(MemStore()))
    js = MemJobStore()
    wrapped = wrap_jobstore(js)
    assert unwrap(wrapped) is js
    assert "TracingJobStore" not in _layers(wrapped)
    install_tracer(Tracer())
    try:
        assert "TracingStore" in _layers(wrap_store(MemStore()))
        assert "TracingJobStore" in _layers(wrap_jobstore(MemJobStore()))
        assert wrap_jobstore(wrapped) is wrapped
    finally:
        install_tracer(None)


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["barrier", "pipelined"])
def test_trace_completeness_under_chaos(tmp_path, pipeline):
    plan = FaultPlan(29 + int(pipeline), transient=0.08, latency=0.05,
                     error_after_write=0.3, latency_ms=1.0, max_per_key=2)
    spec, store, stats, _ = _run_distributed(
        tmp_path, "mem", f"ttr-chaos-{int(pipeline)}", traced=True,
        plan=plan, pipeline=pipeline)
    assert plan.total_fired() > 0
    committed = _committed(store)
    assert committed
    col = TraceCollection.from_store(get_storage_from(spec.storage))
    assert col.check_complete(committed) == []
    errored = [s for s in col.spans
               if s.get("attrs", {}).get("error", "").startswith("Injected")]
    assert errored
    assert any(col.by_sid.get(s.get("parent"), {}).get(
        "name", "").endswith(".body") for s in errored)
    assert validate_chrome(col.to_chrome()) == []
    for ns in (MAP_NS, PRE_NS, RED_NS):
        for d in store.jobs(ns):
            assert d["repetitions"] == 0


def test_trace_speculation_winner_and_loser_chains(tmp_path):
    """A slow-plan straggler with speculation on: the speculated job has
    exactly one commit span (first commit wins), the clone's speculative
    claim span, and a loser chain — a second worker's body with no
    commit, or a cancelled clone."""
    plan = FaultPlan(91, slow_worker="straggler-*", slow_ms=120.0,
                     slow_s=3600.0)
    spec, store, stats, _ = _run_distributed(
        tmp_path, "mem", "ttr-spec", traced=True, plan=plan, n_workers=3,
        speculation=3.0, straggler=True, batch_k=1)
    it = stats.iterations[-1]
    assert it.spec_launched >= 1 and it.spec_wins >= 1
    col = TraceCollection.from_store(get_storage_from(spec.storage))
    assert col.check_complete(_committed(store)) == []
    outcomes = col.speculation_outcomes()
    assert outcomes, "no speculative claim spans recorded"
    assert all(o["commit_count"] == 1 for o in outcomes), outcomes
    assert any(o["losers"] or o["cancelled"] for o in outcomes), outcomes
    assert validate_chrome(col.to_chrome()) == []
    # the collector's reading of these spans equals the JAX package's
    jcol = jax_collect.TraceCollection(col.spans)
    assert jcol.speculation_outcomes() == outcomes


def test_error_entry_links_to_live_span(tmp_path):
    plan = FaultPlan(37, transient=1.0, pattern="result.P0.M00000000",
                     max_per_key=4)
    spec, store, stats, server = _run_distributed(
        tmp_path, "mem", "ttr-errlink", traced=True, plan=plan)
    assert stats.iterations[-1].infra_releases >= 1
    linked = [e for e in server.errors if e.get("span_id")]
    assert linked
    col = TraceCollection.from_store(get_storage_from(spec.storage))
    for e in linked:
        sp = col.by_sid.get(e["span_id"])
        assert sp is not None and sp["name"].endswith(".body")
        assert sp["ns"] == e["ns"] and sp["job"] == e["job_id"]
        assert sp["worker"] == e["span_worker"] == e["worker"]
        assert sp.get("attrs", {}).get("error")


def test_counter_fold_shared_and_key_sets_identical(tmp_path, monkeypatch):
    """Both executors fold through IterationStats.fold_fault_counters and
    surface the JAX package's counter key set; counters nothing bumps
    yet stay 0."""
    calls = []
    orig = IterationStats.fold_fault_counters

    def spy(self, delta):
        calls.append(sorted(delta))
        return orig(self, delta)

    monkeypatch.setattr(IterationStats, "fold_fault_counters", spy)
    _, local_stats = _run_local(tmp_path, "mem", "tfold-local",
                                traced=False, pipeline=False)
    n_local = len(calls)
    assert n_local
    _, _, dist_stats, _ = _run_distributed(tmp_path, "mem", "tfold-dist",
                                           traced=False)
    assert len(calls) > n_local
    local_keys = set(local_stats.iterations[-1].as_dict())
    assert local_keys == set(dist_stats.iterations[-1].as_dict()) == \
        set(JaxIterStats(iteration=1).as_dict())
    fields = {f.name for f in dataclasses.fields(IterationStats)}
    assert set(COUNTER_FOLD) <= fields and set(COUNTER_FOLD) <= local_keys
    d = local_stats.iterations[-1].as_dict()
    for key in ("spec_launched", "push_frames", "failover_reads",
                "autotune_decisions", "leader_takeovers", "decode_reads"):
        assert d[key] == 0


def test_trace_cli_report_and_export(tmp_path):
    _run_local(tmp_path, "shared", "ttr-cli", traced=True)
    storage = _storage(tmp_path, "shared", "ttr-cli")
    out = tmp_path / "chrome.json"
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "lua_mapreduce_tpu_torch.trace", storage,
         "--export", str(out), "--format", "json"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    rep = json.loads(r.stdout)
    assert rep["spans"] > 0 and rep["ops"]
    assert {row["phase"] for row in rep["phases"]} >= {"map", "reduce"}
    assert validate_chrome(json.load(open(out))) == []
    r = subprocess.run(
        [sys.executable, "-m", "lua_mapreduce_tpu_torch.trace", storage,
         "--top", "3"], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120)
    assert r.returncode == 0 and "per-op latency" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "lua_mapreduce_tpu_torch.trace",
         f"shared:{tmp_path}/empty-ns"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 1 and "no _trace" in r.stderr


def test_cli_parsers_accept_trace_and_profile():
    from lua_mapreduce_tpu_torch.cli.execute_server import \
        build_parser as server_parser
    from lua_mapreduce_tpu_torch.cli.execute_worker import \
        build_parser as worker_parser
    a = server_parser().parse_args(
        ["coord", "t", "m", "p", "r", "--trace", "--profile", "/tmp/prof"])
    assert a.trace and a.profile == "/tmp/prof"
    a = worker_parser().parse_args(["coord", "--trace", "--profile",
                                    "/tmp/prof"])
    assert a.trace and a.profile == "/tmp/prof"


def test_trace_profile_bridge_puts_span_names_in_the_torch_profile(
        tmp_path):
    """``--trace --profile DIR`` on the CPU: a tracer with ``annotate``
    inside ``device_trace`` leaves the job-body span names as rows of
    the exported torch profile."""
    from lua_mapreduce_tpu_torch.utils.profiling import device_trace
    prof = tmp_path / "prof"
    with device_trace(str(prof)):
        _run_local(tmp_path, "mem", "ttr-prof", traced=True,
                   tracer=Tracer(annotate=True))
    (trace_file,) = glob.glob(str(prof / "*.pt.trace.json"))
    names = {e.get("name") for e in json.load(open(trace_file))
             ["traceEvents"]}
    assert {"map.body", "pre_merge.body", "reduce.body"} <= names
