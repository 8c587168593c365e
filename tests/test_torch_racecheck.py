"""The port's thread-spawn graph, lockset / lock-order pass (LMR026-030)
and runtime lock-order sanitizer, held against the JAX package's: every
fixture goes through both engines and must give equal findings (rule,
severity, path, line, col, message) and the expected ones. Then the
seeded races, the port package conc-clean inside the wall budget, its
thread-shutdown audit and lock model, the sanitizer's unit behaviour on
locks the port creates, the regressions the reference band found (held
on the port's code), the router repair LMR029 found, and a sanitized
run of a threaded digits pool on the CPU verified against the port's
static model with results byte-equal to a LocalExecutor's."""

import collections
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import uuid

import pytest

from lua_mapreduce_tpu.analysis import lockset as jax_lockset
from lua_mapreduce_tpu.analysis import threads as jax_threads
from lua_mapreduce_tpu.analysis.callgraph import CallGraph as JaxCallGraph
from lua_mapreduce_tpu_torch.analysis import lockset, threads
from lua_mapreduce_tpu_torch.analysis.callgraph import (CallGraph,
                                                        build_callgraph)
from lua_mapreduce_tpu_torch.utils import lockcheck

from test_torch_analysis import PORT_PKG, _key

REPO = os.path.dirname(PORT_PKG)
TESTS = os.path.dirname(os.path.abspath(__file__))


def _conc(*files):
    """The port's conc findings over the fixture files, after checking the
    reference engine finds the same."""
    srcs = [(rel, textwrap.dedent(src)) for rel, src in files]
    port = lockset.analyze_conc(graph=CallGraph.from_sources(srcs),
                                baseline="/nonexistent")
    ref = jax_lockset.analyze_conc(graph=JaxCallGraph.from_sources(srcs),
                                   baseline="/nonexistent")
    assert [_key(f) for f in port.findings] == \
        [_key(f) for f in ref.findings]
    assert [_key(f) for f in port.raw] == [_key(f) for f in ref.raw]
    assert port.cycles == ref.cycles
    return port


# --- thread-spawn graph -----------------------------------------------------

SPAWNY = ("engine/fx.py", """\
    import threading

    class Worker:
        def configure(self):
            return self

        def execute(self):
            self.state = 1

    def mint():
        w = Worker()
        return w

    def spawn_fluent():
        w = Worker().configure()
        threading.Thread(target=w.execute, daemon=True).start()

    def spawn_factory():
        w = mint()
        threading.Thread(target=w.execute, daemon=True).start()
    """)

KINDS = ("engine/fx.py", """\
    import threading
    from sched.controller import FleetSupervisor

    class W:
        def go(self):
            def loop():
                self.tick()
            t = threading.Thread(target=loop, daemon=True)
            t.start()
            for i in range(3):
                threading.Thread(target=self.run_one).start()
            pool.submit(self.reduce_one, 1)
            sup = FleetSupervisor(spawn=self.mint, retire=print,
                                  baseline=1, cap=2)

        def tick(self):
            self.shared = 1

        def run_one(self):
            pass

        def reduce_one(self, i):
            pass

        def mint(self, i):
            pass

    def main():
        W().go()
    """)

CONTROLLER = ("sched/controller.py", """\
    class FleetSupervisor:
        def __init__(self, spawn, retire, baseline, cap):
            pass
    """)


def _thread_graphs(*files):
    srcs = [(rel, textwrap.dedent(src)) for rel, src in files]
    port = threads.build_thread_graph(CallGraph.from_sources(srcs))
    ref = jax_threads.build_thread_graph(JaxCallGraph.from_sources(srcs))
    assert [dataclasses.astuple(s) for s in port.spawns] == \
        [dataclasses.astuple(s) for s in ref.spawns]
    assert port.roots == ref.roots
    assert port.multi_entries == ref.multi_entries
    return port


def test_thread_graph_resolves_fluent_builder_and_factory_targets():
    tg = _thread_graphs(SPAWNY)
    assert {s.entry for s in tg.spawns} == {"engine/fx.py::Worker.execute"}
    assert "engine/fx.py::Worker.execute" in tg.multi_entries
    assert tg.contested(["engine/fx.py::Worker.execute"])


def test_thread_graph_resolves_every_spawn_kind():
    tg = _thread_graphs(KINDS, CONTROLLER)
    by = {(s.via, s.entry): s for s in tg.spawns}
    loop = "engine/fx.py::W.go.loop"
    assert by[("thread", loop)].daemon and not by[("thread", loop)].multi
    assert by[("thread", "engine/fx.py::W.run_one")].multi
    assert ("submit", "engine/fx.py::W.reduce_one") in by
    assert ("fleet", "engine/fx.py::W.mint") in by
    assert tg.roots_of(loop) == {loop}
    assert tg.roots_of("engine/fx.py::W.tick") == {loop}
    assert "main" in tg.roots_of("engine/fx.py::W.go")
    assert tg.contested(["engine/fx.py::W.go", "engine/fx.py::W.tick"])
    assert tg.contested(["engine/fx.py::W.run_one"])
    assert not tg.contested(["engine/fx.py::W.go"])


def test_thread_graph_roots_separate_thread_code_from_main():
    tg = _thread_graphs(("engine/fx.py", """\
        import threading

        class W:
            def go(self):
                threading.Thread(target=self.loop, daemon=True).start()
                self.prep()

            def loop(self):
                self.tick()

            def tick(self):
                pass

            def prep(self):
                pass
        """))
    assert tg.roots_of("engine/fx.py::W.tick") == {"engine/fx.py::W.loop"}
    assert "main" in tg.roots_of("engine/fx.py::W.prep")


# --- LMR026-030: fixture pairs through both engines ------------------------

LEDGER = textwrap.dedent("""\
    import threading

    class Ledger:
        def __init__(self):
            self._lock = threading.Lock()
            self.total = 0

        def start(self):
            threading.Thread(target=self.add, daemon=True).start()

        def add(self):
            with self._lock:
                self.total += 1

        def drain(self):
            out = self.total
            self.total = 0
            return out
    """)

SPLIT_GUARD = textwrap.dedent("""\
    import threading

    class Split:
        def __init__(self):
            self._a_lock = threading.Lock()
            self._b_lock = threading.Lock()
            self.v = 0

        def start(self):
            threading.Thread(target=self.inc, daemon=True).start()

        def inc(self):
            with self._a_lock:
                self.v += 1

        def dec(self):
            with self._b_lock:
                self.v -= 1
    """)

ABBA = textwrap.dedent("""\
    import threading

    class Pair:
        def __init__(self):
            self._a_lock = threading.Lock()
            self._b_lock = threading.Lock()

        def start(self):
            threading.Thread(target=self.ab, daemon=True).start()

        def ab(self):
            with self._a_lock:
                with self._b_lock:
                    pass

        def ba(self):
            with self._b_lock:
                with self._a_lock:
                    pass
    """)

REACQUIRE = textwrap.dedent("""\
    import threading
    _lock = threading.Lock()

    def outer():
        with _lock:
            inner()

    def inner():
        with _lock:
            pass
    """)

SLEEPY = textwrap.dedent("""\
    import threading
    import time

    class Slow:
        def __init__(self):
            self._lock = threading.Lock()

        def tick(self):
            with self._lock:
                time.sleep(1)
    """)

PUBLISH = textwrap.dedent("""\
    import threading

    def collect():
        out = []

        def work():
            out.append(1)

        t = threading.Thread(target=work)
        t.start()
        return len(out)
    """)

# (case, files, the port engine's findings as (rule, line), cycles?)
CONC_FIXTURES = [
    ("lmr026-dropped-guard", [("engine/fx.py", LEDGER)],
     [("LMR026", 17)], False),
    ("lmr026-all-guarded", [("engine/fx.py", LEDGER.replace(
        "        out = self.total\n        self.total = 0\n",
        "        with self._lock:\n            out = self.total\n"
        "            self.total = 0\n"))], [], False),
    ("lmr026-one-thread-root", [("engine/fx.py", LEDGER.replace(
        "        threading.Thread(target=self.add, daemon=True).start()\n",
        "        self.add()\n"))], [], False),
    ("lmr027-disjoint-guards", [("engine/fx.py", SPLIT_GUARD)],
     [("LMR027", 18)], False),
    ("lmr027-one-guard", [("engine/fx.py", SPLIT_GUARD.replace(
        "self._b_lock:", "self._a_lock:"))], [], False),
    ("lmr028-abba", [("engine/fx.py", ABBA)],
     [("LMR028", 13), ("LMR028", 18)], True),
    ("lmr028-ordered", [("engine/fx.py", ABBA.replace(
        "with self._b_lock:\n            with self._a_lock:",
        "with self._a_lock:\n            with self._b_lock:"))], [], False),
    ("lmr028-reacquire", [("engine/fx.py", REACQUIRE)], [("LMR028", 9)],
     False),
    ("lmr028-reacquire-rlock", [("engine/fx.py", REACQUIRE.replace(
        "threading.Lock()", "threading.RLock()"))], [], False),
    ("lmr029-sleep", [("engine/fx.py", SLEEPY)], [("LMR029", 10)], False),
    ("lmr029-sleep-outside", [("engine/fx.py", SLEEPY.replace(
        "        with self._lock:\n            time.sleep(1)\n",
        "        with self._lock:\n            pass\n"
        "        time.sleep(1)\n"))], [], False),
    ("lmr029-three-frames-deep", [("engine/fx.py", """\
        import threading
        import time

        class Deep:
            def __init__(self):
                self._lock = threading.Lock()

            def top(self):
                with self._lock:
                    self.mid()

            def mid(self):
                self.low()

            def low(self):
                time.sleep(1)
        """)], [("LMR029", 16)], False),
    ("lmr029-store-io", [("engine/fx_io.py", """\
        import threading
        class Sink:
            def __init__(self, store):
                self._lock = threading.Lock()
                self.store = store
            def flush(self, name):
                with self._lock:
                    return self.store.read_range(name, 0, 10)
            def flush2(self, name):
                with self._lock:
                    self._emit(name)
            def _emit(self, name):
                return self.store.read_range(name, 0, 10)
        """)], [("LMR029", 8), ("LMR029", 13)], False),
    ("lmr029-hoisted", [("engine/fx_ho.py", """\
        import threading
        class Sink:
            def __init__(self, store):
                self._lock = threading.Lock()
                self.store = store
                self.cache = None
            def flush(self, name):
                data = self.store.read_range(name, 0, 10)
                with self._lock:
                    self.cache = data
        """)], [], False),
    ("lmr029-injected-callback", [("engine/fx_cb.py", """\
        import threading
        class Sup:
            def __init__(self, spawn):
                self._lock = threading.Lock()
                self.spawn = spawn
            def grow(self):
                with self._lock:
                    return self.spawn(1)
        """)], [("LMR029", 8)], False),
    ("lmr029-premerge-probe-under-tracker-lock", [("engine/fx.py", """\
        import threading

        class View:
            def exists(self, name):
                return True

        class Pipeline:
            def __init__(self):
                self._view = View()
                self._lock = threading.Lock()
                self.failed = 0

            def start(self):
                threading.Thread(target=self.premerge,
                                 daemon=True).start()

            def premerge(self):
                with self._lock:
                    self.failed += 1
                    self._view.exists("sp")
        """)], [("LMR029", 20)], False),
    ("lmr030-read-without-handoff", [("engine/fx.py", PUBLISH)],
     [("LMR030", 11)], False),
    ("lmr030-joined", [("engine/fx.py", PUBLISH.replace(
        "t.start()", "t.start()\n    t.join()"))], [], False),
]


@pytest.mark.parametrize("files,want,cyclic", [
    pytest.param(files, want, cyclic, id=case)
    for case, files, want, cyclic in CONC_FIXTURES])
def test_conc_fixture_parity(files, want, cyclic):
    res = _conc(*files)
    assert sorted((f.rule, f.line) for f in res.findings) == want
    assert bool(res.cycles) == cyclic


def test_conc_findings_honor_inline_pragmas():
    rel, _rule, src = lockset.KNOWN_RACES["dropped-lock-write"]
    lines = src.splitlines()
    lines[12] += "  # lmr: disable=LMR026"
    res = _conc((rel, "\n".join(lines) + "\n"))
    assert "LMR026" not in [f.rule for f in res.findings]
    assert any(f.rule == "LMR026" for f in res.raw)


@pytest.mark.parametrize("name", sorted(lockset.KNOWN_RACES))
def test_seeded_race_is_refound(name):
    assert lockset.KNOWN_RACES[name] == jax_lockset.KNOWN_RACES[name]
    hits = lockset.find_seeded(name)
    expected = lockset.KNOWN_RACES[name][1]
    assert hits and all(f.rule == expected for f in hits), (name, hits)
    assert [_key(f) for f in hits] == \
        [_key(f) for f in jax_lockset.find_seeded(name)]


def test_rule_catalog_includes_the_conc_band():
    from lua_mapreduce_tpu_torch.analysis.lint import rule_catalog
    ids = {r["id"] for r in rule_catalog()}
    assert {"LMR026", "LMR027", "LMR028", "LMR029", "LMR030"} <= ids
    assert lockset.conc_rule_catalog() == jax_lockset.conc_rule_catalog()


# --- the port package -------------------------------------------------------

def test_port_package_is_conc_clean_within_the_wall_budget():
    res = lockset.analyze_conc()
    assert res.findings == [], "\n".join(
        f"{f.path}:{f.line}: {f.rule} {f.message}" for f in res.findings)
    assert not res.cycles
    assert res.wall_s < 30.0, res.wall_s
    for label in ("trace/span.py::Tracer._lock",
                  "engine/push.py::BufferPool._lock",
                  "ops/__init__.py::_launch_lock",
                  "engine/ingraph.py::COMPILE_LOCK"):
        assert label in res.locks, label
    # the router no longer wires stores under its lock (LMR029 repaired)
    assert not [e for e in res.edges_gen
                if e[0] == "store/router.py::_mem_lock"]


def test_port_thread_shutdown_audit():
    tg = threads.build_thread_graph(build_callgraph(None))
    report = threads.shutdown_report(tg)
    entries = {e["entry"] for e in report}
    assert "engine/worker.py::Worker._beating.beat" in entries
    assert "store/sharedfs.py::_writer_loop" in entries
    assert "main" not in tg.roots_of("engine/worker.py::Worker._beating.beat")
    bad = [e for e in report if not (e["daemon"] or e["module_joins"])]
    assert bad == [], bad


def test_static_lock_model_matches_source_sites():
    model = lockset.static_lock_model()
    assert model["locks"] and not model["cyclic"]
    for site in model["locks"]:
        rel, _, line = site.rpartition(":")
        with open(os.path.join(PORT_PKG, rel)) as f:
            src_line = f.read().splitlines()[int(line) - 1]
        assert "Lock(" in src_line, (site, src_line)


# --- the runtime sanitizer, on locks the port creates -----------------------

@pytest.fixture
def sanitizer():
    now = [0.0]
    lockcheck.install(clock=lambda: now[0])
    lockcheck.reset()
    try:
        yield now
    finally:
        lockcheck.uninstall()
        lockcheck.reset()


def _port_locks():
    """A Lock (engine/push.py) and an RLock (coord/jobstore.py), each
    created by the port's own code."""
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
    from lua_mapreduce_tpu_torch.engine.push import BufferPool
    return BufferPool(1 << 10)._lock, MemJobStore()._lock


def test_lockcheck_records_nested_order(sanitizer):
    a, b = _port_locks()
    assert isinstance(a, lockcheck._LockProxy)
    assert isinstance(b, lockcheck._LockProxy)
    assert a.site.startswith("engine/push.py:")
    assert b.site.startswith("coord/jobstore.py:")
    with a:
        sanitizer[0] += 0.25
        with b:
            pass
    rep = lockcheck.report()
    assert rep["acquisitions"] == 2
    assert rep["site_acquisitions"] == {a.site: 1, b.site: 1}
    assert rep["edges"] == [(a.site, b.site)]
    assert rep["max_hold_s"][a.site] >= 0.25
    model = {"locks": {a.site: "A", b.site: "B"}, "edges": [["A", "B"]],
             "cyclic": []}
    assert lockcheck.verify(model) == []
    ctl = lockcheck.control(model)
    assert ctl["edge"] == ["A", "B"]
    assert any("unmodeled acquisition order A -> B" in v
               for v in ctl["violations"])


def test_lockcheck_flags_an_unmodelled_order(sanitizer):
    a, b = _port_locks()
    model = {"locks": {a.site: "A", b.site: "B"}, "edges": [["A", "B"]],
             "cyclic": []}
    with b:
        with a:
            pass
    assert any("unmodeled acquisition order B -> A" in v
               for v in lockcheck.verify(model))


def test_lockcheck_flags_an_unmodelled_site(sanitizer):
    a, b = _port_locks()
    with a:
        pass
    bad = lockcheck.verify({"locks": {b.site: "B"}, "edges": [],
                            "cyclic": []})
    assert any(f"unmodeled site {a.site}" in v for v in bad)


def test_lockcheck_flags_any_order_between_cyclic_labels(sanitizer):
    a, b = _port_locks()
    with a:
        with b:
            pass
    bad = lockcheck.verify({"locks": {a.site: "A", b.site: "B"},
                            "edges": [["A", "B"], ["B", "A"]],
                            "cyclic": ["A", "B"]})
    assert any("statically-cyclic" in v for v in bad)


def test_lockcheck_leaves_condition_and_foreign_locks_raw(sanitizer):
    from lua_mapreduce_tpu_torch.sched.waiter import LocalChannel
    # a Condition's internal lock is made inside threading.py
    assert not isinstance(LocalChannel()._cond._lock, lockcheck._LockProxy)
    # a lock this test creates is not the port's
    assert not isinstance(threading.Lock(), lockcheck._LockProxy)
    # a lock made by C code that a port frame calls is not the port's:
    # numpy's RandomState in a process that imported numpy after
    # install(), here a defaultdict the FleetSupervisor spawns through
    from lua_mapreduce_tpu_torch.sched.controller import FleetSupervisor
    made = collections.defaultdict(threading.Lock)
    sup = FleetSupervisor(spawn=made.__getitem__,
                          retire=lambda m: None, baseline=1, cap=2)
    assert isinstance(sup._lock, lockcheck._LockProxy)
    assert sup.resize(2) == 2
    assert not any(isinstance(m, lockcheck._LockProxy) for m in sup.members)
    assert lockcheck.report()["sites"] == [sup._lock.site]


def test_lockcheck_factories_are_the_builtins_when_uninstalled():
    assert threading.Lock is lockcheck._real_lock
    assert threading.RLock is lockcheck._real_rlock
    lockcheck.install()
    lockcheck.uninstall()
    assert threading.Lock is lockcheck._real_lock
    assert threading.RLock is lockcheck._real_rlock


# --- regressions the reference band found, held on the port's code --------

def test_bufferpool_budget_is_a_locked_property():
    from lua_mapreduce_tpu_torch.engine.push import BufferPool
    assert isinstance(BufferPool.budget, property)
    pool = BufferPool(1 << 20)
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            pool.budget = pool.budget + 1

    ts = [threading.Thread(target=churn) for _ in range(3)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 0.5
    while time.monotonic() < deadline:
        assert pool.budget >= (1 << 20)
        pool.charge(64)
        pool.uncharge(64)
    stop.set()
    for t in ts:
        t.join(5.0)
    assert not any(t.is_alive() for t in ts)
    assert pool.held == 0


def test_fleet_resize_runs_spawn_and_retire_outside_the_lock():
    from lua_mapreduce_tpu_torch.sched.controller import FleetSupervisor
    sizes = []
    sup = FleetSupervisor(
        spawn=lambda seq: sizes.append(sup.size) or f"w{seq}",
        retire=lambda m: sizes.append(sup.size),
        baseline=1, cap=8)
    done = []

    def run():
        sup.resize(5)
        sup.resize(2)
        done.append(True)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(10.0)
    assert done, "resize deadlocked on a re-entrant spawn/retire hook"
    assert sup.size == 2
    assert len(sizes) == 5 + 3


def test_fleet_concurrent_resize_converges():
    from lua_mapreduce_tpu_torch.sched.controller import FleetSupervisor
    sup = FleetSupervisor(spawn=lambda seq: f"w{seq}",
                          retire=lambda m: None, baseline=1, cap=16)
    ts = [threading.Thread(target=sup.resize, args=(n,))
          for n in (4, 9, 16, 2, 7)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10.0)
    assert 1 <= sup.size <= 16
    assert len(sup.members) == len(set(sup.members))


# --- the router repair LMR029 found ----------------------------------------

def test_mem_lookups_wire_their_store_outside_the_router_lock(monkeypatch):
    import importlib

    from lua_mapreduce_tpu_torch.faults import retry

    # the module: the package's ``router`` is the reference-named alias
    router = importlib.import_module("lua_mapreduce_tpu_torch.store.router")

    class OwnedLock:
        """The router's lock, knowing which thread holds it."""

        def __init__(self):
            self._lock = threading.Lock()
            self.owner = None

        def __enter__(self):
            self._lock.acquire()
            self.owner = threading.get_ident()

        def __exit__(self, *exc):
            self.owner = None
            self._lock.release()

    lock = OwnedLock()
    monkeypatch.setattr(router, "_mem_lock", lock)
    real = retry.retry_settings
    under_lock = []

    def spy():
        under_lock.append(lock.owner == threading.get_ident())
        return real()

    monkeypatch.setattr(retry, "retry_settings", spy)
    tag = f"mem:racecheck-{uuid.uuid4().hex}"
    first = router.get_storage_from(tag)
    assert under_lock and not any(under_lock)
    assert router.get_storage_from(tag) is first
    # concurrent first lookups of one fresh tag agree on one store
    tag = f"mem:racecheck-{uuid.uuid4().hex}"
    gate = threading.Barrier(8)
    got = []

    def look():
        gate.wait()
        got.append(router.get_storage_from(tag))

    ts = [threading.Thread(target=look) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(10.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert len(got) == 8 and all(s is got[0] for s in got)
    assert not any(under_lock)
    got[0].builder().build("x")
    assert router.get_storage_from(tag).exists("x")


# --- a sanitized threaded digits pool on the CPU ---------------------------

def _result_files(root):
    out = {}
    for sub in ("spill", "model"):
        d = os.path.join(root, sub)
        for name in sorted(os.listdir(d)):
            if name.startswith("result.P") or name in ("model.ckpt",
                                                       "model.meta"):
                with open(os.path.join(d, name), "rb") as f:
                    out[f"{sub}/{name}"] = f.read()
    return out


def test_sanitized_digits_pool_verifies_against_the_static_model(tmp_path):
    import torch_lockcheck_child as child
    from lua_mapreduce_tpu_torch import LocalExecutor
    report = tmp_path / "lockcheck.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([TESTS, REPO]))
    proc = subprocess.run(
        [sys.executable, os.path.join(PORT_PKG, "utils", "lockcheck.py"),
         str(report), "torch_lockcheck_child:run", str(tmp_path / "pool")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(report.read_text())
    res, seen = rep["result"], rep["report"]
    assert res["iterations"] == child.ITERATIONS and res["alive"] == 0
    assert res["bodies"] >= child.ITERATIONS * child.ARGS["n_shards"]
    for target in ("Worker.execute", "Worker._beating.<locals>.beat",
                   "LeaderLease.start_renewal.<locals>.loop"):
        assert res["threads"].get(target), (target, res["threads"])
    assert rep["violations"] == [], rep["violations"]
    assert rep["model"]["cyclic"] == [] and seen["acquisitions"] > 0
    assert seen["sites"] and set(seen["sites"]) <= \
        set(rep["model"]["labels"])
    # the negative control: the model less one observed order reports it
    ctl = rep["control"]
    assert ctl and any(f"order {ctl['edge'][0]} -> {ctl['edge'][1]} " in v
                       for v in ctl["violations"]), ctl
    # the same task through a barrier LocalExecutor: the same bytes
    LocalExecutor(child.spec(str(tmp_path / "local")),
                  max_iterations=child.ITERATIONS + 2).run()
    want = _result_files(tmp_path / "local")
    assert [n for n in want if n.startswith("spill/")]
    assert _result_files(tmp_path / "pool") == want
