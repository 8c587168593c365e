"""The port's lint engine and per-function rules, held against the JAX
package's: every rule fixture (positive and negative) goes through both
engines at the same package path and must give equal findings (rule,
severity, path, line, col, message) and the expected ones; LMR007 has
fixtures of its own (the port's graph captures). Then the engine's
plumbing (pragmas, the baseline, unparseable files), the port package
audited clean with an empty baseline, the whole port tree read by both
engines (call graph, thread roots, lock model, raw findings), and the
repaired builder leak of the digits task."""

import json
import os
import textwrap

import pytest

from lua_mapreduce_tpu.analysis import callgraph as jax_callgraph
from lua_mapreduce_tpu.analysis import dataflow as jax_dataflow
from lua_mapreduce_tpu.analysis import lint as jax_lint
from lua_mapreduce_tpu.analysis import lockset as jax_lockset
from lua_mapreduce_tpu.analysis import threads as jax_threads
from lua_mapreduce_tpu_torch.analysis import callgraph, dataflow, lint
from lua_mapreduce_tpu_torch.analysis import lockset, threads

PORT_PKG = os.path.dirname(os.path.dirname(os.path.abspath(lint.__file__)))
JAX_PKG = os.path.dirname(os.path.dirname(
    os.path.abspath(jax_lint.__file__)))


def _snippet(mod, tmp_path, rel, src):
    """Lint one fixture with engine ``mod`` as if it lived at package
    path ``rel`` (inline pragmas honoured)."""
    p = tmp_path / os.path.basename(rel)
    p.write_text(textwrap.dedent(src))
    ctx = mod.FileContext(str(p), rel, p.read_text())
    out = []
    for rule in mod.all_rules():
        if rule.applies(rel):
            out.extend(f for f in rule.check(ctx)
                       if f.rule not in ctx.line_disables(f.line))
    return out


def _key(f):
    return (f.rule, f.severity, f.path, f.line, f.col, f.message)


# (case, package path, source, the port engine's findings as (rule, line))
FIXTURES = [
    ("lmr001-unclosed", "engine/fx.py", """\
        def leak(store):
            b = store.builder()
            b.write("x")
            b.build("f")
        """, [("LMR001", 2)]),
    ("lmr001-clean", "engine/fx.py", """\
        def with_block(store):
            with store.builder() as b:
                b.write("x")
                b.build("f")

        def try_finally(store):
            b = store.builder()
            try:
                b.write("x")
                b.build("f")
            finally:
                b.close()

        def container(store, parts):
            writers = {}
            try:
                for p in parts:
                    w = writers[p] = writer_for(store, "v2")
                    w.add(p, [1])
            finally:
                for w in writers.values():
                    w.close()

        def transfer(store):
            return store.builder()

        def wrapped(store):
            consume(SegmentWriter(store.builder()))
        """, [("LMR009", 18), ("LMR009", 28)]),
    ("lmr001-dropped", "train/fx.py", """\
        def dropped(store):
            store.builder()
        """, [("LMR001", 2)]),
    ("lmr002-foreign-io", "coord/fx.py", """\
        import json, os

        class Idx:
            def bad(self, cb):
                fd = self._open_locked()
                try:
                    doc = json.load(open(self.sidecar))
                    cb(doc)
                    os.replace("a", "b")
                    return os.read(fd, 8)
                finally:
                    os.close(fd)
        """, [("LMR002", 7), ("LMR002", 7), ("LMR002", 8), ("LMR002", 9)]),
    ("lmr002-fd-local", "coord/fx.py", """\
        import os

        class Idx:
            def good(self):
                fd = self._open_locked()
                try:
                    os.lseek(fd, 0, 0)
                    head = os.read(fd, 16)
                    os.write(fd, head)
                    return self._read_count(fd)
                finally:
                    os.close(fd)
        """, []),
    ("lmr003-nested", "coord/fx.py", """\
        class S:
            def nested_with(self):
                with self._lock:
                    with self._rounds_lock:
                        pass

            def flock_under_memlock(self, path):
                with self._lock:
                    with _FLock(path):
                        pass

            def bump_under_lock(self):
                with self._lock:
                    self._bump("claim")

            def acquire_under_lock(self):
                with self._lock:
                    self._other.acquire()
        """, [("LMR003", 4), ("LMR003", 9), ("LMR003", 9),
              ("LMR003", 14), ("LMR003", 18)]),
    ("lmr003-sequential", "coord/fx.py", """\
        class S:
            def sequential(self):
                self._bump("claim")
                with self._lock:
                    return list(self._jobs)
        """, []),
    ("lmr004-clock", "coord/fx.py", """\
        import time

        class S:
            def bad(self):
                with self._lock:
                    self.t = time.time()

            def good(self):
                now = time.time()
                with self._lock:
                    self.t = now
        """, [("LMR004", 6)]),
    ("lmr004-out-of-scope", "store/fx.py", """\
        import time

        class S:
            def elsewhere(self):
                with self._lock:
                    self.t = time.time()
        """, []),
    ("lmr005-swallowers", "train/fx.py", """\
        def bare():
            try:
                work()
            except:
                pass

        def base_exc(box):
            try:
                work()
            except BaseException as e:
                box.append(e)
        """, [("LMR005", 4), ("LMR005", 10)]),
    ("lmr005-handled", "train/fx.py", """\
        import logging
        _log = logging.getLogger(__name__)

        def reraises():
            try:
                work()
            except BaseException:
                cleanup()
                raise

        def logs(box):
            try:
                work()
            except BaseException as e:
                _log.warning("deferred: %r", e)
                box.append(e)

        def narrow():
            try:
                work()
            except Exception:
                pass

        def pragma():
            try:
                work()
            except BaseException:  # lmr: disable=LMR005
                pass
        """, []),
    ("lmr006-half-pair", "store/fx.py", """\
        class HalfStore(Store):
            def read_range(self, name, offset, length):
                return b""
        """, [("LMR006", 2)]),
    ("lmr006-shims", "store/fx.py", """\
        class B1(FileBuilder):
            def write_bytes(self, data):
                self.write(data.decode("utf-8"))

        class B2(FileBuilder):
            def write_bytes(self, data):
                self.write(data.decode("latin-1"))

        class FullStore(Store):
            def read_range(self, name, offset, length):
                return b""

            def size(self, name):
                return 0
        """, [("LMR006", 3)]),
    ("lmr008-generic-raise", "store/fx.py", """\
        class MyStore:
            def read_range(self, name, offset, length):
                raise RuntimeError("backend hiccup")

            def build(self, name):
                raise OSError("publish failed")
        """, [("LMR008", 3), ("LMR008", 6)]),
    ("lmr008-classified", "coord/fx.py", """\
        class MyJobStore:
            def update_task(self, fields):
                raise NoTaskError("no task document")

            def commit_batch(self, entries, worker):
                raise NativeIndexError("jsx_commit_batch failed")

            def lines(self, name):
                raise FileNotFoundError(name)      # taxonomy maps it

            def helper_not_an_op(self):
                raise RuntimeError("not a retry-boundary method")

            def claim(self, worker):
                raise self._err_box[0]             # re-raise: unknowable
        """, []),
    ("lmr008-out-of-scope", "engine/fx.py", """\
        class Runner:
            def build(self, name):
                raise RuntimeError("engine-side, different contract")
        """, []),
    ("lmr009-raw-spill", "engine/fx.py", """\
        from lua_mapreduce_tpu_torch.core.segment import writer_for

        def run_map(store, fmt):
            w = writer_for(store, fmt)
            try:
                w.add("k", [1])
                w.build("ns.P0.M1")
            finally:
                w.close()

        def run_premerge(builder):
            w = SegmentWriter(builder, codec="zlib")
            try:
                w.build("ns.P0.SPILL-0-1")
            finally:
                w.close()
        """, [("LMR009", 4), ("LMR009", 12)]),
    ("lmr009-helper", "engine/fx.py", """\
        from lua_mapreduce_tpu_torch.faults.replicate import spill_writer

        def run_map(store, fmt, r):
            w = spill_writer(store, fmt, r)
            try:
                w.add("k", [1])
                w.build("ns.P0.M1")
            finally:
                w.close()

        def publish_result(store, name):
            with store.builder() as b:
                b.write("x\\t[1]\\n")
                b.build(name)
        """, []),
    ("lmr009-factory-home", "core/fx.py", """\
        def writer_for(store, fmt):
            return TextWriter(store.builder())
        """, []),
    ("lmr009-stripe-literals", "engine/fx.py", """\
        def read_block(store, base, i, t):
            return store.read_range(f"^{i}.{t}^{base}", 0, 8)

        def guess_block(store, base):
            return store.exists("^0.3^" + base)

        def scan_blocks(store, pat):
            return store.list(f"^*^{pat}")
        """, [("LMR009", 2), ("LMR009", 5), ("LMR009", 8)]),
    ("lmr009-coded-home", "faults/coded.py", """\
        def block_names(name, i, t):
            return f"^{i}.{t}^{name}"

        def manifest_name(name):
            return f"^M^{name}"
        """, []),
    ("lmr009-docstring", "engine/fx.py", '''\
        from lua_mapreduce_tpu_torch.faults.coded import stripe_patterns

        def scan(store, pat):
            """Lists physical stripe files (^0.3^x blocks etc.)."""
            out = []
            for sp in stripe_patterns(pat):
                out += store.list(sp)
            return out
        ''', []),
    ("lmr010-direct-clock", "trace/fx.py", """\
        import time

        class Recorder:
            def op(self, name):
                t0 = time.time()
                self._spans.append((name, t0, time.perf_counter()))

        def stamp():
            return time.monotonic_ns()
        """, [("LMR010", 5), ("LMR010", 6), ("LMR010", 9)]),
    ("lmr010-injectable", "trace/fx.py", """\
        import time

        class Recorder:
            def __init__(self, clock=time.time):
                self._clock = clock

            def op(self, name):
                t0 = self._clock()
                self._spans.append((name, t0, self._clock()))

        def wait(tracer):
            time.sleep(0.1)
            return tracer.clock()
        """, []),
    ("lmr010-out-of-scope", "engine/fx.py", """\
        import time

        def run_job():
            return time.time()
        """, []),
    ("lmr011-engine-sleep", "engine/fx.py", """\
        import time

        def idle_loop(self):
            while True:
                time.sleep(self.poll)
        """, [("LMR011", 5)]),
    ("lmr011-coord-sleep", "coord/fx.py", """\
        import time

        def lock(self, poll):
            while not self.try_lock():
                time.sleep(poll)
        """, [("LMR011", 5)]),
    ("lmr011-waiter", "engine/fx.py", """\
        import time

        def idle_loop(self, waiter):
            while True:
                woken = waiter.wait(self.poll)

        def make_waiter(sleep=time.sleep):
            return sleep
        """, []),
    ("lmr011-out-of-scope", "sched/fx.py", """\
        import time

        def wait(self, timeout):
            time.sleep(timeout)
        """, []),
    ("lmr012-raw-inbox", "engine/fx.py", """\
        def publish_frame(store, ns, key, seq):
            b = store.builder()
            try:
                b.write_bytes(b"JSEG0001")
                b.build(f"{ns}.P0.INBOX-{key}-{seq:05d}")
            finally:
                b.close()

        def publish_manifest(store, ns, key, payload):
            with store.builder() as b:
                b.write(payload)
                b.build(f"{ns}.PUSH.M{key}")
        """, [("LMR012", 5), ("LMR012", 12)]),
    ("lmr012-spill-writer", "engine/fx.py", """\
        from lua_mapreduce_tpu_torch.faults.replicate import spill_writer

        def publish_frame(store, ns, key, seq, r):
            w = spill_writer(store, "v2", r)
            try:
                w.add_line("k", '["k",[1]]')
                w.build(f"{ns}.P0.INBOX-{key}-{seq:05d}")
            finally:
                w.close()

        def publish_result(store, name):
            with store.builder() as b:
                b.write("x")
                b.build(f"{name}.P0")
        """, []),
    ("lmr012-out-of-scope", "store/fx.py", """\
        def fixture(store):
            with store.builder() as b:
                b.build("r.P0.INBOX-1-00000")
        """, []),
    ("lmr012-manifest-engine", "engine/fx.py", """\
        def forge_gate(store, name):
            with store.builder() as b:
                b.write("{}")
                b.build(f"^M^{name}")
        """, [("LMR012", 4)]),
    ("lmr012-manifest-faults", "faults/fx.py", """\
        def peek(store, name):
            return store.exists("^M^" + name)
        """, [("LMR012", 2)]),
    ("lmr012-manifest-helpers", "engine/fx.py", '''\
        from lua_mapreduce_tpu_torch.faults.coded import manifest_pattern

        def scan_manifests(store, pat):
            """Stripe manifests (^M^x) gate block visibility."""
            return store.list(manifest_pattern(pat))
        ''', []),
    ("lmr018-knob-read", "engine/fx.py", """\
        def lease_width(self, store):
            task = store.get_task() or {}
            cap = self.batch_k
            return max(1, cap)

        def detector(self, task):
            return self.speculation * task.get("dur_ewma:map", 1.0)
        """, [("LMR018", 3), ("LMR018", 7)]),
    ("lmr018-negotiated", "engine/fx.py", """\
        def negotiated(self, task):
            return float(task.get("speculation") or self.speculation)

        def deploy(self, store):
            task = store.get_task() or {}
            store.update_task({"batch_k": self.batch_k})
            return task

        def no_task_in_scope(self):
            return self.batch_k * 2

        def other_attr(self, task):
            return self.poll_interval
        """, []),
    ("lmr018-out-of-scope", "benchmarks/fx.py", """\
        def lease_width(self, task):
            return self.batch_k
        """, []),
]


@pytest.mark.parametrize("rel,src,want", [
    pytest.param(rel, src, want, id=case)
    for case, rel, src, want in FIXTURES])
def test_rule_fixture_parity(tmp_path, rel, src, want):
    port = _snippet(lint, tmp_path, rel, src)
    ref = _snippet(jax_lint, tmp_path, rel, src)
    assert [_key(f) for f in port] == [_key(f) for f in ref]
    assert sorted((f.rule, f.line) for f in port) == want


# --- LMR007: the port's graph captures ------------------------------------

CAPTURES = """\
    import random
    import time

    import numpy as np
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    from lua_mapreduce_tpu_torch import graphs
    from lua_mapreduce_tpu_torch.graphs import CapturedGraph


    def _noisy_step(state, x):
        noise = np.random.randn(4)
        return state + x, torch.as_tensor(noise)


    def run_scan(state, x):
        return graphs.scan(_noisy_step, state, 8, x)


    class Trainer:
        def _step(self):
            print("step", self.n)
            return self.loss()

        def capture(self):
            return CapturedGraph(lambda: self._step(), tag="train")

        def eager(self):
            print("eager", self.n)


    def stamped():
        return torch.full((1,), time.time())


    def record():
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = stamped()
            open("capture.log")
        return g, out


    def _fold(a, b):
        return a + b * random.random()


    def trace(a, b):
        return make_fx(_fold)(a, b)
    """

CAPTURES_CLEAN = """\
    import time

    import numpy as np
    import torch

    from lua_mapreduce_tpu_torch import graphs
    from lua_mapreduce_tpu_torch.graphs import CapturedGraph


    def _step(state, x, gen):
        noise = torch.randn(4, generator=gen, device=x.device)
        return state + x, noise


    def run_scan(state, x, gen):
        return graphs.scan(_step, state, 8, x, gen)


    class Trainer:
        def _step(self, lr):
            return self.loss() * lr

        def capture(self, lr):
            t0 = time.perf_counter()
            g = CapturedGraph(lambda: self._step(lr), tag="train")
            print("captured in", time.perf_counter() - t0)
            return g


    def host_side():
        return np.random.RandomState(0).randn(8)
    """


@pytest.mark.parametrize("rel", ["models/fx.py", "engine/fx.py",
                                 "train/fx.py", "parallel/fx.py",
                                 "graphs.py"])
def test_lmr007_flags_host_effects_in_captured_functions(tmp_path, rel):
    got = [f for f in _snippet(lint, tmp_path, rel, CAPTURES)
           if f.rule == "LMR007"]
    assert [(f.line, f.message.split(" inside ")[1].split(" ")[0:3])
            for f in got] == [
        (13, ["captured", "function", "'_noisy_step'"]),
        (23, ["captured", "function", "'_step'"]),
        (34, ["captured", "function", "'stamped'"]),
        (46, ["captured", "function", "'_fold'"]),
        (41, ["the", "torch.cuda.graph", "block"])]
    assert "torch.Generator" in got[0].message
    assert "capture time" in got[1].message


@pytest.mark.parametrize("rel,src", [
    ("models/fx.py", CAPTURES_CLEAN),   # generator draws, host timing
    ("store/fx.py", CAPTURES),          # out of the rule's paths
    ("ops/fx.py", CAPTURES),
])
def test_lmr007_quiet_on_clean_twins_and_out_of_scope(tmp_path, rel, src):
    assert [f for f in _snippet(lint, tmp_path, rel, src)
            if f.rule == "LMR007"] == []


def test_lmr007_port_rule_keeps_the_reference_id_and_severity():
    port = {r.id: r for r in lint.all_rules()}["LMR007"]
    ref = {r.id: r for r in jax_lint.all_rules()}["LMR007"]
    assert port.severity == ref.severity == "error"
    assert port.paths == ("engine/", "graphs.py", "models/", "parallel/",
                          "train/")
    assert "torch.Generator" in port.rationale


# --- engine plumbing ------------------------------------------------------

def test_inline_suppression_and_baseline(tmp_path):
    src = "try:\n    pass\nexcept BaseException:\n    pass\n"
    p = tmp_path / "fx.py"
    p.write_text(src)
    assert [f.rule for f in lint.run_lint([str(p)],
                                          baseline="/nonexistent")] \
        == ["LMR005"]
    p.write_text(src.replace("except BaseException:",
                             "except BaseException:  # lmr: disable=LMR005"))
    assert lint.run_lint([str(p)], baseline="/nonexistent") == []
    p.write_text(src)
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps(
        [{"rule": "LMR005", "path": "fx.py", "line": 3, "reason": "test"}]))
    assert lint.run_lint([str(p)], baseline=str(bl)) == []
    bl.write_text(json.dumps(
        [{"rule": "LMR005", "path": "fx.py", "line": 99, "reason": "test"}]))
    assert len(lint.run_lint([str(p)], baseline=str(bl))) == 1
    # a reason-less entry is refused
    bl.write_text(json.dumps([{"rule": "LMR005", "path": "fx.py"}]))
    with pytest.raises(ValueError):
        lint.run_lint([str(p)], baseline=str(bl))


@pytest.mark.parametrize("name,data", [
    ("broken.py", b"def oops(:\n"),
    ("nul.py", b"x = 1\n\x00\n"),
    ("lat.py", b"caf\xe9 = 1\n"),
])
def test_unparseable_files_are_findings_in_both_engines(tmp_path, name,
                                                        data):
    p = tmp_path / name
    p.write_bytes(data)
    port = lint.run_lint([str(p)], baseline="/nonexistent")
    ref = jax_lint.run_lint([str(p)], baseline="/nonexistent")
    assert [f.rule for f in port] == ["LMR000"]
    assert [_key(f) for f in port] == [_key(f) for f in ref]


def test_shipped_baseline_is_empty():
    assert lint.load_baseline() == []
    with open(os.path.join(PORT_PKG, "analysis", "baseline.json")) as f:
        assert json.load(f) == []


def test_rule_catalog_matches_the_reference():
    assert [r.id for r in lint.all_rules()] == \
        [r.id for r in jax_lint.all_rules()]
    ids = [r["id"] for r in lint.rule_catalog()]
    assert ids == [r["id"] for r in jax_lint.rule_catalog()]
    assert ids == sorted(ids) and len(ids) == len(set(ids))
    for r in lint.all_rules():
        assert r.title and r.rationale and r.severity in ("error",
                                                          "warning")


def test_every_rule_scope_names_a_port_directory():
    scopes = {p for r in lint.all_rules() for p in r.paths}
    scopes |= {p for r in dataflow.DEEP_RULES for p in r.paths}
    for p in scopes:
        assert os.path.exists(os.path.join(PORT_PKG, p)), p


# --- the port package is clean --------------------------------------------

def test_port_package_audit_is_clean():
    audit = lint.run_audit()
    assert audit.findings == [], lint.format_text(audit.findings)
    assert not audit.stale, (audit.stale_pragmas, audit.stale_baseline)


# --- whole-tree parity over the port's own source -------------------------

def _raw_findings(lint_mod, dataflow_mod, lockset_mod, graph, root):
    raw = lint_mod._collect_raw([root], lint_mod.all_rules())[0]
    raw += dataflow_mod.analyze(graph=graph).raw
    raw += lockset_mod.analyze_conc(graph=graph).raw
    return sorted(_key(f) for f in raw if f.rule not in ("LMR007",
                                                         "LMR017"))


def _edges(g):
    return {(e.caller, e.callee, e.line, e.kind)
            for es in g.edges_from.values() for e in es}


def whole_tree_parity(root):
    """The two engines over one directory read as text: call-graph
    edges, spawn sites and thread roots, the static lock model and the
    raw (pre-suppression) findings, LMR007/017 aside. Returns the port
    engine's lock model."""
    port_g = callgraph.build_callgraph([root])
    ref_g = jax_callgraph.build_callgraph([root])
    assert _edges(port_g) == _edges(ref_g)
    port_t = threads.build_thread_graph(port_g)
    ref_t = jax_threads.build_thread_graph(ref_g)
    assert port_t.roots == ref_t.roots
    assert [(s.rel, s.line, s.via, s.entry, s.daemon, s.multi)
            for s in port_t.spawns] == \
        [(s.rel, s.line, s.via, s.entry, s.daemon, s.multi)
         for s in ref_t.spawns]
    port_m = lockset.static_lock_model(
        lockset.analyze_conc(graph=port_g, tgraph=port_t))
    ref_m = jax_lockset.static_lock_model(
        jax_lockset.analyze_conc(graph=ref_g, tgraph=ref_t))
    assert port_m == ref_m
    assert _raw_findings(lint, dataflow, lockset, port_g, root) == \
        _raw_findings(jax_lint, jax_dataflow, jax_lockset, ref_g, root)
    return port_m


def test_whole_port_tree_parity_pins_its_lock_plane():
    model = whole_tree_parity(PORT_PKG)
    # 27 package locks and the three the sanitizer's self-test creates
    # under install() (utils/lockcheck.py::utest.a, .b, .c)
    assert len(model["locks"]) == 30 and model["cyclic"] == []
    assert sorted(s for s in model["locks"].values()
                  if "::utest." in s) == [
        "utils/lockcheck.py::utest.a", "utils/lockcheck.py::utest.b",
        "utils/lockcheck.py::utest.c"]
    assert model["edges"] == [
        ["core/native_build.py::_lock", "store/memfs.py::MemStore._lock"],
        ["engine/hybrid.py::HybridReduceFold._lock",
         "engine/ingraph.py::COMPILE_LOCK"],
        ["engine/ingraph.py::COMPILE_LOCK", "ops/__init__.py::_launch_lock"],
        ["ops/_build.py::_lock", "store/memfs.py::MemStore._lock"],
        ["sched/lease.py::LeaderLease._lock",
         "coord/jobstore.py::MemJobStore._lock"]]


# --- the builder leak LMR001 found in the digits task ---------------------

def test_digits_meta_write_closes_its_builder_on_failure():
    from lua_mapreduce_tpu_torch.examples.digits import mr_train

    class Builder:
        closed = built = False

        def write(self, text):
            pass

        def build(self, name):
            raise OSError("publish failed")

        def close(self):
            self.closed = True

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.close()

    class Store:
        def builder(self):
            self.b = Builder()
            return self.b

    store = Store()
    with pytest.raises(OSError):
        mr_train._write_meta(store, {"step": 0})
    assert store.b.closed
    # an unserialisable meta fails before the build: closed as well
    with pytest.raises(TypeError):
        mr_train._write_meta(store, {"step": object()})
    assert store.b.closed
    src = os.path.join(PORT_PKG, "examples", "digits", "mr_train.py")
    assert [f for f in lint.run_lint([src], baseline="/nonexistent")
            if f.rule == "LMR001"] == []
