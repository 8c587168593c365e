"""The port's whole-program call graph and deep (interprocedural) rules,
held against the JAX package's: every call-graph fixture and every
LMR013-016 fixture pair goes through both engines and must give equal
edges and findings (rule, severity, path, line, col, message) and the
expected ones; LMR017 has fixtures of its own (helpers reached from the
port's graph captures). Then suppression and the stale-suppression
audit, the SARIF export, the port package deep-clean inside the wall
budget, and the whole JAX package read by both engines."""

import json
import textwrap
import time

import pytest

from lua_mapreduce_tpu.analysis import callgraph as jax_callgraph
from lua_mapreduce_tpu.analysis import dataflow as jax_dataflow
from lua_mapreduce_tpu.analysis import lint as jax_lint
from lua_mapreduce_tpu.analysis import sarif as jax_sarif
from lua_mapreduce_tpu_torch.analysis import callgraph, dataflow, lint, sarif
from lua_mapreduce_tpu_torch.analysis.lint import Finding, run_audit

from test_torch_analysis import JAX_PKG, _key, whole_tree_parity


def _write(tmp_path, fixtures):
    for rel, src in fixtures.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def _deep_both(tmp_path, fixtures):
    """The port's deep findings over the fixture tree, after checking the
    reference engine finds the same."""
    _write(tmp_path, fixtures)
    port = dataflow.run_deep([str(tmp_path)], baseline="/nonexistent")
    ref = jax_dataflow.run_deep([str(tmp_path)], baseline="/nonexistent")
    assert [_key(f) for f in port] == [_key(f) for f in ref]
    return port


def _edges(g):
    return {(e.caller, e.callee, e.line, e.kind)
            for es in g.edges_from.values() for e in es}


def _graphs(sources):
    srcs = [(rel, textwrap.dedent(src)) for rel, src in sources]
    port = callgraph.CallGraph.from_sources(srcs)
    ref = jax_callgraph.CallGraph.from_sources(srcs)
    assert _edges(port) == _edges(ref)
    assert port.interface_methods() == ref.interface_methods()
    return port


# --- call graph -------------------------------------------------------------

def test_callgraph_resolves_every_edge_kind():
    g = _graphs([
        ("engine/a.py", """\
            from engine.b import helper, Tool
            import engine.b

            class Runner:
                def top(self, cb):
                    self.low()
                    helper()
                    engine.b.other()
                    t = Tool()
                    cb(1)

                def low(self):
                    def inner():
                        return 1
                    return inner()
            """),
        ("engine/b.py", """\
            def helper():
                return other()

            def other():
                return 2

            class Tool:
                def __init__(self):
                    self.x = 1
            """),
    ])
    kinds = {(e.caller.split("::")[1], e.callee, e.kind)
             for edges in g.edges_from.values() for e in edges}
    assert ("Runner.top", "engine/a.py::Runner.low", "method") in kinds
    assert ("Runner.top", "engine/b.py::helper", "direct") in kinds
    assert ("Runner.top", "engine/b.py::other", "direct") in kinds
    assert ("Runner.top", "engine/b.py::Tool.__init__", "ctor") in kinds
    assert ("Runner.top", "<param:cb>", "param") in kinds
    assert ("Runner.low", "engine/a.py::Runner.low.inner",
            "direct") in kinds
    assert ("helper", "engine/b.py::other", "direct") in kinds


def test_callgraph_interface_surface_fans_out():
    g = _graphs([
        ("store/base.py", """\
            class Store:
                def lines(self, name):
                    raise NotImplementedError
            """),
        ("store/memfs.py", """\
            class MemStore(Store):
                def lines(self, name):
                    return []
            """),
        ("engine/job.py", """\
            def read_all(store):
                return list(store.lines('x'))
            """),
    ])
    edges = [e for e in g.callees("engine/job.py::read_all")
             if e.kind == "interface"]
    assert len(edges) == 1
    assert set(g.iface_targets("lines")) == {
        "store/base.py::Store.lines", "store/memfs.py::MemStore.lines"}


def test_callgraph_base_class_resolution_across_modules():
    g = _graphs([
        ("store/base.py", "class Base:\n"
                          "    def shared(self):\n"
                          "        return 1\n"),
        ("store/impl.py", "from store.base import Base\n"
                          "class Impl(Base):\n"
                          "    def use(self):\n"
                          "        return self.shared()\n"),
    ])
    assert [(e.callee, e.kind) for e in g.callees("store/impl.py::Impl.use")] \
        == [("store/base.py::Base.shared", "method")]


def test_callgraph_indexes_defs_inside_except_handlers(tmp_path):
    deep = _deep_both(tmp_path, {
        "coord/fb.py": """\
            import os
            try:
                from fast import helper
            except ImportError:
                def helper():
                    import json
                    return json.load(open('x'))

            class Idx:
                def claim(self):
                    fd = self._open_locked()
                    try:
                        return helper()
                    finally:
                        os.close(fd)
            """,
    })
    assert [(f.rule, f.line) for f in deep] == [("LMR013", 7)]


def test_port_package_graph_size_and_speed():
    t0 = time.perf_counter()
    g = callgraph.build_callgraph()
    wall = time.perf_counter() - t0
    assert g.node_count() > 800 and g.edge_count() > 1500
    assert wall < 15.0, f"callgraph build took {wall:.1f}s"
    assert {"lines", "build", "claim_batch",
            "read_range"} <= g.interface_methods()
    assert any(e.callee.endswith("::Worker.run_one")
               for edges in g.edges_from.values() for e in edges)


# --- deep rules: fixture pairs through both engines -------------------------

# (case, fixture tree, the port engine's findings as (rule, path, line),
#  a word each finding's message carries)
DEEP_FIXTURES = [
    ("lmr013-helper-io", {
        "coord/fx.py": """\
            import json, os, time

            class Idx:
                def claim(self):
                    fd = self._open_locked()
                    try:
                        return self._load_doc(fd)
                    finally:
                        os.close(fd)

                def _load_doc(self, fd):
                    doc = json.load(open('sidecar'))
                    time.sleep(0.1)
                    return doc
            """}, [("LMR013", "coord/fx.py", 12),
                   ("LMR013", "coord/fx.py", 13)], "reached from"),
    ("lmr013-dataplane-and-clean-twin", {
        "coord/direct.py": """\
            import os

            class Idx:
                def scan(self, store):
                    fd = self._open_locked()
                    try:
                        return store.lines('manifest')
                    finally:
                        os.close(fd)
            """,
        "coord/clean.py": """\
            import os

            class Idx:
                def good(self):
                    fd = self._open_locked()
                    try:
                        return self._read_rec(fd)
                    finally:
                        os.close(fd)

                def _read_rec(self, fd):
                    return os.read(fd, 88)
            """}, [("LMR013", "coord/direct.py", 7)],
        "store data-plane call"),
    ("lmr013-user-callback", {
        "coord/cb.py": """\
            import os

            class Idx:
                def claim(self, notify):
                    fd = self._open_locked()
                    try:
                        self._fire(notify)
                    finally:
                        os.close(fd)

                def _fire(self, notify):
                    notify("claimed")
            """}, [("LMR013", "coord/cb.py", 12)], "user callback"),
    ("lmr014-helper-raise", {
        "store/fx.py": """\
            class MyStore:
                def read_range(self, name, offset, length):
                    return self._fetch(name)

                def _fetch(self, name):
                    raise RuntimeError('backend hiccup')
            """}, [("LMR014", "store/fx.py", 6)], "RuntimeError"),
    ("lmr014-classified", {
        "store/ok.py": """\
            class MyStore:
                def read_range(self, name, offset, length):
                    return self._fetch(name)

                def _fetch(self, name):
                    raise TransientStoreError('blip')

                def size(self, name):
                    return self._stat(name)

                def _stat(self, name):
                    raise FileNotFoundError(name)
            """}, [], ""),
    ("lmr014-policy-frame", {
        "faults/fx.py": """\
            def fetch_with_retry(policy):
                return policy.call(_do_fetch)

            def _do_fetch():
                raise RuntimeError('backend hiccup')
            """}, [("LMR014", "faults/fx.py", 5)], "RuntimeError"),
    ("lmr014-outside-store-paths", {
        "core/codec.py": """\
            def encode_frame(payload):
                raise RuntimeError('bad frame')
            """,
        "store/user.py": """\
            from core.codec import encode_frame

            class S:
                def build(self, name):
                    return encode_frame(name)
            """}, [("LMR014", "core/codec.py", 2)], "RuntimeError"),
    ("lmr015-hoistable-clock", {
        "coord/fx.py": """\
            import time

            class S:
                def stamp(self):
                    with self._lock:
                        self.t = self._now()

                def _now(self):
                    return time.time()
            """}, [("LMR015", "coord/fx.py", 9)], "time.time()"),
    ("lmr015-trace-chain-and-hoisted-twin", {
        "trace/fx.py": """\
            from core.util import jitter

            class Tracer:
                def add(self, name):
                    return jitter()
            """,
        "core/util.py": """\
            import random

            def jitter():
                return random.random()
            """,
        "coord/clean.py": """\
            import time

            class S:
                def stamp(self):
                    now = self._now()
                    with self._lock:
                        self.t = now

                def _now(self):
                    return time.time()
            """}, [("LMR015", "core/util.py", 4)], "random.random"),
    ("lmr016-insert-jobs", {
        "store/fx.py": """\
            class S:
                def build(self, name):
                    self._publish(name)

                def _publish(self, name):
                    self.js.insert_jobs('ns', [])
            """}, [("LMR016", "store/fx.py", 6)], "insert_jobs"),
    ("lmr016-policy-lambda-and-unretried-claim", {
        "faults/fx.py": """\
            class Wrapper:
                def flush(self, name):
                    self._policy.call(lambda: self._inner.pt_cas(
                        name, None, {}), op='flush', name=name)
            """,
        "coord/ok.py": """\
            class JS:
                def claim(self, ns, worker):
                    return self.claim_batch(ns, worker, 1)

                def claim_batch(self, ns, worker, k):
                    return []
            """}, [("LMR016", "faults/fx.py", 3)], "pt_cas"),
    ("deep-utest-retry-pair", {
        "store/fx.py": """\
            class MyStore:
                def read_range(self, name, offset, length):
                    return self._fetch(name)
                def _fetch(self, name):
                    raise RuntimeError('backend hiccup')
                def build(self, name):
                    self._publish(name)
                def _publish(self, name):
                    self.js.insert_jobs('ns', [])
            """}, [("LMR014", "store/fx.py", 5),
                   ("LMR016", "store/fx.py", 9)], "reached from"),
]


@pytest.mark.parametrize("fixtures,want,word", [
    pytest.param(fx, want, word, id=case)
    for case, fx, want, word in DEEP_FIXTURES])
def test_deep_fixture_parity(tmp_path, fixtures, want, word):
    deep = _deep_both(tmp_path, fixtures)
    assert sorted((f.rule, f.path, f.line) for f in deep) == want
    assert all(word in f.message for f in deep)
    # the per-function pass misses what the deep pass finds
    shallow = lint.run_lint([str(tmp_path)], baseline="/nonexistent")
    assert not {(f.path, f.line) for f in shallow
                if f.rule in ("LMR002", "LMR004", "LMR008")} \
        & {(f.path, f.line) for f in deep}


# --- LMR017: the port's graph captures, one frame deep ----------------------

CAPTURE_HELPERS = {
    "models/fx.py": """\
        import time

        import numpy as np
        import torch

        from lua_mapreduce_tpu_torch import graphs


        def _step(state, x):
            return state + x * _noise(4), state


        def _noise(n):
            return torch.as_tensor(np.random.randn(n))


        def run(state, x):
            return graphs.scan(_step, state, 8, x)


        class Decoder:
            def _body(self):
                return self._stamp()

            def _stamp(self):
                print("at", time.time())
                return self.x

            def record(self, g):
                with torch.cuda.graph(g):
                    self._body()
        """,
}


def test_lmr017_helpers_under_a_capture_found_deep_missed_shallow(tmp_path):
    _write(tmp_path, CAPTURE_HELPERS)
    deep = dataflow.run_deep([str(tmp_path)], baseline="/nonexistent")
    # print() and time.time() share line 26: one finding per (path,
    # line, rule)
    assert [(f.rule, f.line) for f in deep] == [
        ("LMR017", 14), ("LMR017", 26)]
    assert all("runs under under-graph-capture" in f.message
               for f in deep)
    assert "np.random.randn" in deep[0].message
    assert "via _step:10" in deep[0].message
    shallow = lint.run_lint([str(tmp_path)], baseline="/nonexistent")
    assert [f for f in shallow if f.rule == "LMR007"] == []


def test_lmr017_pure_helpers_and_uncaptured_users_pass(tmp_path):
    _write(tmp_path, {
        "models/ok.py": """\
            import numpy as np
            import torch

            from lua_mapreduce_tpu_torch import graphs


            def _step(state, x, gen):
                return state + _scale(x, gen), state


            def _scale(x, gen):
                return x * torch.rand(1, generator=gen, device=x.device)


            def run(state, x, gen):
                return graphs.scan(_step, state, 8, x, gen)


            def host_bench():
                return _noise(np.random.default_rng(0))


            def _noise(rng):
                return rng.normal()
            """,
        "store/out.py": CAPTURE_HELPERS["models/fx.py"],   # out of scope
    })
    assert dataflow.run_deep([str(tmp_path)], baseline="/nonexistent") == []


def test_lmr017_deep_rule_scope_is_lmr007s():
    rule = {r.id: r for r in dataflow.DEEP_RULES}["LMR017"]
    assert rule.paths == ("engine/", "graphs.py", "models/", "parallel/",
                          "train/")
    assert "torch.Generator" in rule.rationale


# --- suppression + the stale audit -----------------------------------------

REPLAY_INDIRECT = {
    "coord/fx.py": """\
        import time

        class S:
            def stamp(self):
                with self._lock:
                    self.t = self._now()

            def _now(self):
                return time.time()
        """,
}


def test_deep_findings_respect_inline_and_baseline(tmp_path):
    _write(tmp_path, REPLAY_INDIRECT)
    assert len(dataflow.run_deep([str(tmp_path)],
                                 baseline="/nonexistent")) == 1
    src = textwrap.dedent(REPLAY_INDIRECT["coord/fx.py"]).replace(
        "return time.time()", "return time.time()  # lmr: disable=LMR015")
    (tmp_path / "coord" / "fx.py").write_text(src)
    assert dataflow.run_deep([str(tmp_path)], baseline="/nonexistent") == []
    _write(tmp_path, REPLAY_INDIRECT)
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps([{"rule": "LMR015", "path": "coord/fx.py",
                               "reason": "test"}]))
    assert dataflow.run_deep([str(tmp_path)], baseline=str(bl)) == []


@pytest.mark.parametrize("src,stale", [
    ("def fine():\n    return 1  # lmr: disable=LMR005\n",
     [{"path": "train/fx.py", "line": 2, "rule": "LMR005"}]),
    ("def swallow():\n    try:\n        work()\n"
     "    except BaseException:  # lmr: disable=LMR005\n        pass\n", []),
    ('"""Suppress with ``# lmr: disable=LMR005`` on the line."""\n'
     'SNIPPET = "x = 1  # lmr: disable=LMR001"\n', []),
], ids=["stale-pragma", "live-pragma", "docstring-mention"])
def test_stale_pragma_audit_matches_the_reference(tmp_path, src, stale):
    (tmp_path / "train").mkdir()
    (tmp_path / "train" / "fx.py").write_text(src)
    port = run_audit([str(tmp_path)], baseline="/nonexistent")
    ref = jax_lint.run_audit([str(tmp_path)], baseline="/nonexistent")
    assert port.findings == [] and port.stale_pragmas == stale
    assert port.stale_pragmas == ref.stale_pragmas


def test_stale_baseline_entry_detected(tmp_path):
    (tmp_path / "train").mkdir()
    (tmp_path / "train" / "fx.py").write_text("x = 1\n")
    bl = tmp_path / "baseline.json"
    entry = {"rule": "LMR001", "path": "train/gone.py",
             "reason": "file was deleted"}
    bl.write_text(json.dumps([entry]))
    audit = run_audit([str(tmp_path)], baseline=str(bl))
    assert audit.findings == [] and audit.stale_baseline == [entry]
    assert audit.stale


# --- SARIF -----------------------------------------------------------------

def test_sarif_export_schema_and_results(tmp_path):
    _write(tmp_path, {"store/fx.py": DEEP_FIXTURES[3][1]["store/fx.py"]})
    findings = dataflow.run_deep([str(tmp_path)], baseline="/nonexistent")
    doc = sarif.to_sarif(findings)
    sarif.validate_sarif(doc)
    jax_sarif.validate_sarif(doc)
    results = doc["runs"][0]["results"]
    assert len(results) == 1 and results[0]["ruleId"] == "LMR014"
    assert results[0]["locations"][0]["physicalLocation"][
        "artifactLocation"]["uri"] == "store/fx.py"
    json.loads(sarif.format_sarif(findings))


def test_sarif_catalog_and_region_clamping():
    fs = [Finding("LMR005", "error", "train/x.py", 7, 4, "swallowed"),
          Finding("LMR013", "error", "coord/y.py", 3, 0, "deep IO"),
          Finding("LMR022", "error", "task.py", 0, 0, "emit arity"),
          Finding("LMR029", "error", "engine/z.py", 9, 0, "convoy")]
    doc = sarif.to_sarif(fs)
    sarif.validate_sarif(doc)
    assert doc["runs"][0]["results"][2]["locations"][0][
        "physicalLocation"]["region"]["startLine"] == 1
    ids = {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
    assert {"LMR001", "LMR013", "LMR020", "LMR029"} <= ids
    assert all("ruleIndex" in r for r in doc["runs"][0]["results"])


# --- whole-package gates ----------------------------------------------------

def test_port_package_deep_pass_clean_and_fast():
    res = dataflow.analyze()
    assert res.findings == [], lint.format_text(res.findings)
    assert res.wall_s < 30.0, f"deep pass took {res.wall_s:.1f}s"
    assert res.reached > 100


def test_full_rule_catalog_spans_every_band():
    ids = [r["id"] for r in lint.rule_catalog()]
    assert ids == sorted(ids) and len(ids) == len(set(ids))
    for rid in ("LMR001", "LMR013", "LMR014", "LMR015", "LMR016",
                "LMR017", "LMR020", "LMR025", "LMR026", "LMR030"):
        assert rid in ids, rid


def test_whole_jax_tree_parity():
    """The reference package's own source, read as text by both engines:
    the same call graph, thread roots, lock model and raw findings."""
    model = whole_tree_parity(JAX_PKG)
    assert model["locks"] and model["cyclic"] == []
