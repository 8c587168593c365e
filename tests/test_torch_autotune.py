"""The port's feedback controller (``lua_mapreduce_tpu_torch/sched/
controller.py``) and its wiring into the Server, the Worker and the
LocalExecutor: counterparts of tests/test_autotune.py — the controller's
bands, cooldowns and flip lockout on a virtual clock, its evidence
spans, the adaptive chaos legs byte-equal to the controller-off run
(one with a straggler and speculation), the elastic fleet growing and
retiring without losing a lease, the LocalExecutor mirror, the
doc-seeded EWMA guard, and the worker following the controller's knobs
only under the task document's marker.

Parity with the JAX package: the same seeded Observation stream on one
injected clock gives identical Decision lists from both packages'
controllers.
"""

import threading
import time
import types
from typing import Dict

import pytest

from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.core.constants import Status
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.local import LocalExecutor
from lua_mapreduce_tpu_torch.engine.server import Server
from lua_mapreduce_tpu_torch.engine.worker import MAP_NS, PRE_NS, RED_NS, Worker
from lua_mapreduce_tpu_torch.faults import FaultPlan, install_fault_plan
from lua_mapreduce_tpu_torch.faults.retry import (COUNTERS, configure_retry,
                                            retry_settings)
from lua_mapreduce_tpu_torch.sched import controller as ctl
from lua_mapreduce_tpu_torch.sched.controller import (AutotuneConfig,
                                                AutotuneController,
                                                FleetSupervisor,
                                                Observation,
                                                resolve_autotune)
from lua_mapreduce_tpu_torch.store.router import get_storage_from
from lua_mapreduce_tpu_torch.trace.span import Tracer, install_tracer

from tests.test_torch_chaos import (CORPUS, GOLDEN, _install_module, _MOD,
                              _plan, _result_bytes, _wait_for_claim)


CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _restore_globals():
    """Autotune legs move process-global state (the retry backoff base,
    the installed tracer); every test leaves both exactly as found."""
    before = retry_settings()
    try:
        yield
    finally:
        configure_retry(retries=int(before["retries"]),
                        base_ms=float(before["base_ms"]))
        install_tracer(None)
        install_fault_plan(None)


def _assert_no_oscillation(decisions):
    """The chaos-stability acceptance: no knob reverses direction more
    than once across the observed window."""
    seq: Dict[str, list] = {}
    for d in decisions:
        seq.setdefault(d.knob, []).append(d.direction)
    for knob, dirs in seq.items():
        flips = sum(1 for a, b in zip(dirs, dirs[1:]) if a != b)
        assert flips <= 1, f"knob {knob} oscillated: directions {dirs}"


# --- controller unit behavior ------------------------------------------------

def test_controller_utest():
    """The JAX module's self-test, on the port's controller: bands,
    cooldowns and the flip lockout on a virtual clock, the supervisor's
    newest-first retirement and the tenant quota cap."""
    now = [0.0]
    cfg = AutotuneConfig(cooldown_s=1.0, flip_reset_s=100.0,
                         shrink_after=2)
    c = AutotuneController(batch_k=1, push_budget_mb=8.0, speculation=2.0,
                           retry_base_ms=25.0, fleet=2, fleet_max=6,
                           config=cfg, clock=lambda: now[0])

    def obs(**kw):
        kw.setdefault("t", now[0])
        return Observation(**kw)

    # claim overhead dominates tiny jobs: batch_k doubles...
    c.note_rpc(0.05)
    d = c.tick(obs(body_ewma_s=0.01, rpc_p99_s=0.05, jobs_done=10))
    assert [x.knob for x in d] == ["batch_k"] and c.value("batch_k") == 2
    # ...but not again inside the cooldown
    now[0] += 0.5
    assert c.tick(obs(body_ewma_s=0.01, rpc_p99_s=0.05)) == []
    now[0] += 1.0
    c.tick(obs(body_ewma_s=0.01, rpc_p99_s=0.05))
    assert c.value("batch_k") == 4
    now[0] += 2.0                                   # dead band
    assert c.tick(obs(body_ewma_s=0.1, rpc_p99_s=0.05)) == []
    now[0] += 2.0                                   # one reversal...
    c.tick(obs(body_ewma_s=10.0, rpc_p99_s=0.05))
    assert c.value("batch_k") == 2
    now[0] += 2.0                                   # ...then locked
    assert c.tick(obs(body_ewma_s=0.01, rpc_p99_s=0.05)) == []
    now[0] += 2.0
    c.tick(obs(body_ewma_s=10.0, rpc_p99_s=0.05))
    assert c.value("batch_k") == 1
    # push budget grows on an eviction burst, decays after quiet windows
    now[0] += 10.0
    c.tick(obs(push_evictions=8, push_frames=8))
    assert c.value("push_budget_mb") == 12.0
    for _ in range(2):
        now[0] += 2.0
        c.tick(obs(push_frames=4))
    assert c.value("push_budget_mb") == 9.0
    now[0] += 2.0                                   # heavy waste
    c.tick(obs(body_ewma_s=0.1, jobs_done=4, spec_launched=4,
               spec_wasted_s=5.0))
    assert c.value("speculation") == 2.5
    now[0] += 2.0                                   # a fault storm
    c.tick(obs(store_retries=50))
    assert c.value("retry_base_ms") == 50.0
    now[0] += 2.0                                   # backlog: scale up
    c.tick(obs(body_ewma_s=5.0, waiting=20, running=2, fleet=2))
    assert c.value("fleet") == 6
    for _ in range(2):
        now[0] += 2.0
        c.tick(obs(waiting=0, fleet=6))
    assert c.value("fleet") == 2

    retired = []
    sup = FleetSupervisor(lambda i: f"w{i}", retired.append,
                          baseline=2, cap=4)
    sup.ensure_baseline()
    assert sup.size == 2
    sup.resize(10)
    assert sup.size == 4 and not retired
    sup.resize(1)                                   # clamped to baseline
    assert sup.size == 2 and retired == ["w3", "w2"]
    with pytest.raises(ValueError):
        FleetSupervisor(lambda i: i, retired.append, baseline=3, cap=2)

    from lua_mapreduce_tpu_torch.sched.tenancy import Tenant
    assert ctl.tenant_fleet_cap([Tenant("a", max_pending=2),
                                 Tenant("b", max_pending=3)],
                                baseline=2, hard_max=32) == 7
    assert ctl.tenant_fleet_cap([], baseline=2, hard_max=32) == 32
    assert resolve_autotune(True) and not resolve_autotune(False)


def test_controller_decisions_match_the_jax_package():
    """One seeded Observation stream, one injected clock, both packages'
    controllers with every knob armed: identical Decision lists."""
    import dataclasses

    import numpy as np

    import lua_mapreduce_tpu.sched.controller as jctl
    rng = np.random.default_rng(29)
    now = [0.0]
    clock = lambda: now[0]    # noqa: E731 — shared virtual clock
    kw = dict(batch_k=2, push_budget_mb=16.0, speculation=3.0,
              retry_base_ms=25.0, fleet=2, fleet_max=6)
    pc = AutotuneController(config=AutotuneConfig(cooldown_s=1.0,
                                                  flip_reset_s=30.0,
                                                  shrink_after=2),
                            clock=clock, **kw)
    jc = jctl.AutotuneController(config=jctl.AutotuneConfig(
        cooldown_s=1.0, flip_reset_s=30.0, shrink_after=2),
        clock=clock, **kw)
    for i in range(400):
        now[0] += float(rng.uniform(0.2, 2.5))
        rpc = float(rng.uniform(0.0005, 0.05))
        pc.note_rpc(rpc)
        jc.note_rpc(rpc)
        fields = dict(
            t=now[0], body_ewma_s=float(rng.choice([0.002, 0.05, 2.0])),
            jobs_done=int(rng.integers(0, 20)),
            claim_rounds=int(rng.integers(0, 20)),
            push_frames=int(rng.integers(0, 10)),
            push_evictions=int(rng.choice([0, 0, 1, 6])),
            spec_launched=int(rng.integers(0, 3)),
            spec_wins=int(rng.integers(0, 2)),
            spec_wasted_s=float(rng.choice([0.0, 0.0, 0.5, 20.0])),
            store_retries=int(rng.choice([0, 0, 3, 40])),
            waiting=int(rng.choice([0, 0, 5, 80])),
            running=int(rng.integers(0, 4)),
            fleet=int(pc.value("fleet")))
        pd = pc.tick(Observation(rpc_p99_s=pc.rpc_p99(), **fields))
        jd = jc.tick(jctl.Observation(rpc_p99_s=jc.rpc_p99(), **fields))
        assert [dataclasses.astuple(d) for d in pd] == \
            [dataclasses.astuple(d) for d in jd], i
    assert len(pc.decisions) > 20
    assert {d.knob for d in pc.decisions} == set(ctl.CONTROLLER_KNOBS)


def test_resolve_autotune_resolution_order(monkeypatch):
    monkeypatch.delenv("LMR_AUTOTUNE", raising=False)
    assert resolve_autotune(None) is False
    monkeypatch.setenv("LMR_AUTOTUNE", "1")
    assert resolve_autotune(None) is True
    assert resolve_autotune(False) is False     # explicit arg wins
    monkeypatch.setenv("LMR_AUTOTUNE", "off")
    assert resolve_autotune(None) is False


def test_none_initialized_knobs_stay_disabled():
    """An owner with no push pool / no fleet hook never tunes those
    knobs, whatever the evidence says."""
    now = [0.0]
    c = AutotuneController(batch_k=2,
                           config=AutotuneConfig(cooldown_s=0.0),
                           clock=lambda: now[0])
    c.note_rpc(1.0)
    c.tick(Observation(t=0.0, body_ewma_s=0.01, rpc_p99_s=1.0,
                       push_evictions=100, push_frames=100,
                       store_retries=1000, waiting=500, fleet=1))
    assert {d.knob for d in c.decisions} == {"batch_k"}
    for knob in ("push_budget_mb", "speculation", "retry_base_ms",
                 "fleet"):
        assert c.value(knob) is None


def test_flip_lockout_is_structural_under_adversarial_signal():
    """Feed the controller a signal engineered to whipsaw batch_k every
    window; the flip lockout must bound the damage to ONE reversal no
    matter how long the storm lasts — the zero-oscillation acceptance
    as a structural property, not a tuning accident."""
    now = [0.0]
    c = AutotuneController(batch_k=4,
                           config=AutotuneConfig(cooldown_s=0.5,
                                                 flip_reset_s=1000.0),
                           clock=lambda: now[0])
    for i in range(40):
        now[0] += 1.0                  # always past the cooldown
        body = 0.001 if i % 2 == 0 else 100.0   # whipsaw ratio
        c.tick(Observation(t=now[0], body_ewma_s=body, rpc_p99_s=0.05))
    _assert_no_oscillation(c.decisions)
    assert len(c.decisions) >= 2       # it did act before locking out
    vetoed = COUNTERS.snapshot().get("autotune_vetoes", 0)
    assert vetoed > 0                  # and the storm WAS suppressed


def test_every_decision_emits_evidence_span():
    """The explainability contract: one ``autotune.<knob>`` span per
    applied decision, carrying metric / observed / threshold / old /
    new / direction — and the trace collector parses them back out."""
    tr = Tracer()
    install_tracer(tr)
    now = [0.0]
    c = AutotuneController(batch_k=1, retry_base_ms=25.0,
                           config=AutotuneConfig(cooldown_s=0.0),
                           clock=lambda: now[0])
    c.note_rpc(0.5)
    c.tick(Observation(t=0.0, body_ewma_s=0.01, rpc_p99_s=0.5,
                       store_retries=50))
    now[0] += 1.0
    c.tick(Observation(t=1.0, body_ewma_s=0.01, rpc_p99_s=0.5))
    assert len(c.decisions) >= 3
    store = get_storage_from("mem:autotune-evidence")
    tr.flush(store)
    from lua_mapreduce_tpu_torch.trace.collect import TraceCollection
    col = TraceCollection.from_store(store)
    entries = col.autotune_decisions()
    assert len(entries) == len(c.decisions)
    for entry, d in zip(entries, c.decisions):
        assert entry["span"] == f"autotune.{d.knob}"
        assert entry["knob"] == d.knob
        assert entry["metric"] == d.metric
        assert entry["old"] == d.old and entry["new"] == d.new
        assert entry["direction"] == d.direction
        assert entry["threshold"] == pytest.approx(d.threshold, rel=1e-4)
    # and the CLI report surfaces them (DESIGN §29's "explainable
    # after the fact" includes the human rendering)
    from lua_mapreduce_tpu_torch.trace.__main__ import render_text
    text = render_text(col, top=3)
    assert "autotune: " in text and "batch_k" in text


# --- chaos stability (distributed) -------------------------------------------

def _run_wordcount(tmp_path, tag, *, autotune, plan=None, n_workers=2,
                   speculation=0.0, straggler=False, tracer=None):
    """One distributed wordcount leg, autotune on or off — the
    byte-compare twin harness (mirrors tests/test_chaos.py)."""
    _install_module()
    spec = TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, init_args=CPU, storage=f"mem:{tag}")
    store = MemJobStore()
    if tracer is not None:
        install_tracer(tracer)
    install_fault_plan(plan)
    try:
        server = Server(store, poll_interval=0.01, batch_k=2,
                        speculation=speculation,
                        autotune=autotune).configure(spec)
        names = ([f"healthy-{i}" for i in range(n_workers - 1)]
                 + ["straggler-0"] if straggler
                 else [None] * n_workers)
        workers = [Worker(store, name=names[i]).configure(max_iter=800,
                                                          max_sleep=0.02)
                   for i in range(n_workers)]
        threads = [threading.Thread(target=w.execute, daemon=True)
                   for w in workers]
        if straggler:
            final = {}
            st = threading.Thread(
                target=lambda: final.setdefault("stats", server.loop()),
                daemon=True)
            st.start()
            threads[-1].start()
            _wait_for_claim(store)
            for t in threads[:-1]:
                t.start()
            st.join(timeout=120)
            assert not st.is_alive(), "server wedged under the straggler"
        else:
            for t in threads:
                t.start()
            server.loop()
        for t in threads:
            t.join(timeout=30)
    finally:
        install_fault_plan(None)
        if tracer is not None:
            install_tracer(None)
    for ns in (MAP_NS, PRE_NS, RED_NS):
        for d in store.jobs(ns):
            assert d["repetitions"] == 0, \
                (f"chaos charged a repetition under autotune={autotune}: "
                 f"{ns} job {d['_id']} -> {d['repetitions']}")
    narrowed = speculation > 0
    return (_result_bytes(spec.storage, only_results=narrowed),
            server, store)


def test_chaos_adaptive_run_byte_identical_to_controller_off(tmp_path):
    """The headline stability leg: controller-off fault-free vs
    controller-on under the seeded chaos mix — byte-identical results,
    zero repetition charges (asserted in the harness), zero knob
    oscillation, and every applied decision carries an evidence span."""
    clean, off_server, _ = _run_wordcount(tmp_path, "at-off",
                                          autotune=False)
    assert off_server._controller is None   # off never builds one
    plan = _plan(seed=29)
    tr = Tracer()
    chaotic, server, store = _run_wordcount(tmp_path, "at-on",
                                            autotune=True, plan=plan,
                                            tracer=tr)
    assert chaotic == clean, \
        "adaptive chaos leg output differs from controller-off clean leg"
    assert plan.total_fired() > 0
    c = server._controller
    assert c is not None                    # autotune=True did engage
    _assert_no_oscillation(c.decisions)
    # every decision explainable: spans live in the store (housekeeping
    # flush) or still buffered — count both
    from lua_mapreduce_tpu_torch.trace.collect import TraceCollection
    spans = list(TraceCollection.from_store(
        get_storage_from(f"mem:at-on")).spans) + tr.drain()
    evidence = [s for s in spans if s["name"].startswith("autotune.")]
    assert len(evidence) == len(c.decisions)
    for s in evidence:
        attrs = s.get("attrs") or {}
        for key in ("metric", "observed", "threshold", "old", "new"):
            assert key in attrs, f"evidence span missing {key}: {s}"


def test_chaos_adaptive_straggler_leg(tmp_path):
    """Chaos + speculation + a named slow worker, controller on: the
    straggler detector follows the doc-negotiated factor (the LMR018
    contract), results stay golden, no oscillation."""
    plan = FaultPlan(37, transient=0.05, latency=0.03, latency_ms=1.0,
                     slow_worker="straggler-*", slow_ms=250.0,
                     max_per_key=2)
    _, server, store = _run_wordcount(tmp_path, "at-strag",
                                      autotune=True, plan=plan,
                                      n_workers=3, speculation=3.0,
                                      straggler=True)
    from lua_mapreduce_tpu_torch.engine.local import iter_results
    got = {k: v[0] for k, v in iter_results(
        get_storage_from(f"mem:at-strag"), "result")}
    assert got == GOLDEN
    _assert_no_oscillation(server._controller.decisions)


# --- the elastic fleet -------------------------------------------------------

_SLOW = "tests._torch_autotune_slow_wc"


def _install_slow_module(map_sleep, reduce_sleep):
    """Wordcount with deliberate body weight — the backlog the elastic
    controller sees is real wall time, not scheduler noise."""
    import sys

    mod = types.ModuleType(_SLOW)

    def taskfn(emit):
        for k, v in sorted(CORPUS.items()):
            emit(k, v)

    def mapfn(key, value, emit):
        time.sleep(map_sleep)
        for w in value.split():
            emit(w, 1)

    def reducefn(key, values):
        time.sleep(reduce_sleep)
        return sum(values)

    mod.taskfn = taskfn
    mod.mapfn = mapfn
    mod.partitionfn = lambda key: sum(key.encode()) % 4
    mod.reducefn = reducefn
    sys.modules[_SLOW] = mod
    return mod


def test_elastic_fleet_grows_and_retires_without_losing_leases(tmp_path):
    """The full elastic loop against a REAL thread fleet: baseline of
    one worker, a flood of slow map jobs → the controller scales the
    FleetSupervisor up; the queue drains → it retires back to baseline;
    retired workers finish their in-flight lease first (max_jobs=0 is
    checked at the poll boundary), so zero repetitions are charged and
    the count golden-diffs — the runtime twin of the protocol model's
    join/retire edges."""
    _install_slow_module(map_sleep=0.08, reduce_sleep=0.005)
    # reducefn sleeps per KEY, and every partition holds many words —
    # the reduce phase leaves plenty of waiting==0 housekeeping windows
    # for the shrink decision to fire before the task completes
    spec = TaskSpec(taskfn=_SLOW, mapfn=_SLOW, partitionfn=_SLOW,
                    reducefn=_SLOW, init_args=CPU,
                    storage="mem:at-elastic")
    store = MemJobStore()
    # compress the control clock to the test's scale: the default
    # config's 10s drain target would never trip on a sub-second queue
    server = Server(store, poll_interval=0.02, autotune=True,
                    autotune_config=AutotuneConfig(
                        cooldown_s=0.05, flip_reset_s=300.0,
                        shrink_after=2,
                        drain_target_s=0.2)).configure(spec)

    threads: Dict[object, threading.Thread] = {}

    def spawn(seq):
        w = Worker(store, name=f"elastic-{seq}").configure(max_iter=4000,
                                                           max_sleep=0.02)
        t = threading.Thread(target=w.execute, daemon=True)
        threads[w] = t
        t.start()
        return w

    sup = FleetSupervisor(spawn,
                          retire=lambda w: w.configure(max_jobs=0),
                          baseline=1, cap=4)
    sup.ensure_baseline()
    server.set_fleet(sup.resize, size=1, max_workers=4)
    before = COUNTERS.snapshot()
    server.loop()
    for t in threads.values():
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads.values()), \
        "a retired worker never exited"

    decisions = server._controller.decisions
    grew = [d for d in decisions if d.knob == "fleet" and d.direction > 0]
    shrank = [d for d in decisions
              if d.knob == "fleet" and d.direction < 0]
    assert grew, "the backlog flood never scaled the fleet up"
    assert shrank, "the drained queue never retired the surplus"
    assert sup.size == 1, "fleet did not settle back at baseline"
    assert int(shrank[-1].new) == 1
    _assert_no_oscillation(decisions)
    delta = COUNTERS.delta(before, COUNTERS.snapshot())
    assert delta.get("autotune_scale_events", 0) >= 2

    # no lease lost across the retirements: zero repetitions anywhere,
    # and the counts golden-diff
    for ns in (MAP_NS, PRE_NS, RED_NS):
        for d in store.jobs(ns):
            assert d["repetitions"] == 0, \
                f"retire abandoned a lease: {ns} job {d['_id']}"
    from lua_mapreduce_tpu_torch.engine.local import iter_results
    got = {k: v[0] for k, v in iter_results(
        get_storage_from(spec.storage), "result")}
    assert got == GOLDEN
    # the deploy also landed on the doc for CLI subprocess autoscalers
    task = store.get_task() or {}
    assert task.get("autotune") is True
    assert int(task.get("fleet_target", -1)) == 1


def test_fleet_supervisor_retire_waits_for_inflight_lease():
    """The graceful-retire primitive in isolation: retiring a worker
    MID-LEASE must let the lease commit (no requeue, no repetition) —
    max_jobs=0 only fires at the next poll boundary."""
    _install_slow_module(map_sleep=0.15, reduce_sleep=0.0)
    spec = TaskSpec(taskfn=_SLOW, mapfn=_SLOW, partitionfn=_SLOW,
                    reducefn=_SLOW, init_args=CPU,
                    storage="mem:at-retire")
    store = MemJobStore()
    server = Server(store, poll_interval=0.01).configure(spec)
    w = Worker(store, name="retiree-0").configure(max_iter=2000,
                                                  max_sleep=0.02)
    w2 = Worker(store, name="keeper-0").configure(max_iter=2000,
                                                  max_sleep=0.02)
    t1 = threading.Thread(target=w.execute, daemon=True)
    t2 = threading.Thread(target=w2.execute, daemon=True)
    st = threading.Thread(target=server.loop, daemon=True)
    st.start()
    t1.start()
    _wait_for_claim(store)          # the retiree holds a live lease NOW
    w.configure(max_jobs=0)          # retire it mid-lease
    t2.start()                       # the keeper finishes the task
    st.join(timeout=60)
    assert not st.is_alive()
    t1.join(timeout=10)
    assert not t1.is_alive(), "retired worker kept running"
    t2.join(timeout=10)
    for ns in (MAP_NS, PRE_NS, RED_NS):
        for d in store.jobs(ns):
            assert d["repetitions"] == 0
    from lua_mapreduce_tpu_torch.engine.local import iter_results
    got = {k: v[0] for k, v in iter_results(
        get_storage_from(spec.storage), "result")}
    assert got == GOLDEN


# --- LocalExecutor mirror ----------------------------------------------------

def test_local_executor_autotune_matches_golden(tmp_path):
    """The LocalExecutor mirror of the loop: adaptive and controller-off
    runs both golden-diff (the controller is semantics-neutral)."""
    _install_module()
    for autotune in (False, True):
        spec = TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                        reducefn=_MOD, init_args=CPU,
                        storage=f"mem:at-local-{int(autotune)}")
        ex = LocalExecutor(spec, map_parallelism=3, autotune=autotune)
        ex.run()
        got = {k: v[0] for k, v in ex.results()}
        assert got == GOLDEN


# --- the doc-seeded EWMA cold-start guard (satellite) ------------------------

def test_seeded_worker_first_overshoot_folds_at_quarter_weight():
    """A fresh (elastically spawned) worker seeded from the doc's fleet
    EWMA runs its first job with compile/warmup cost the steady state
    never pays. Folding that outlier at full alpha would inflate the
    very aggregate every OTHER fresh worker is seeded from."""
    from lua_mapreduce_tpu_torch.engine.worker import _DUR_ALPHA
    w = Worker(MemJobStore(), name="cold-0")
    # the poll_once seeding path, minimally
    w._dur_ewma["m"] = 0.1
    w._ewma_seeded.add("m")
    w._note_duration("m", 1.0)          # 10x overshoot: compile cost
    quarter = _DUR_ALPHA / 4.0
    assert w._dur_ewma["m"] == pytest.approx(
        quarter * 1.0 + (1 - quarter) * 0.1)
    # an UNDERSHOOT folds at full weight — faster hardware should pull
    # the estimate down immediately
    w2 = Worker(MemJobStore(), name="cold-1")
    w2._dur_ewma["m"] = 0.5
    w2._ewma_seeded.add("m")
    w2._note_duration("m", 0.1)
    assert w2._dur_ewma["m"] == pytest.approx(
        _DUR_ALPHA * 0.1 + (1 - _DUR_ALPHA) * 0.5)
    # an UNSEEDED worker is untouched: first observation calibrates
    w3 = Worker(MemJobStore(), name="warm-0")
    w3._note_duration("m", 1.0)
    assert w3._dur_ewma["m"] == 1.0


def test_seeded_worker_holds_persist_until_two_own_observations():
    """The echo guard: a doc-seeded worker must not push its EWMA back
    into the fleet aggregate until it has folded two OWN observations —
    one sample over the doc's own value is an amplifier, not a signal."""
    store = MemJobStore()
    store.put_task({"taskfn": "x"})
    w = Worker(store, name="cold-2")
    w._dur_ewma["m"] = 0.1
    w._ewma_seeded.add("m")
    w._note_duration("m", 1.0)
    w._persist_ewma("m")                # held: only one own observation
    assert "dur_ewma:m" not in (store.get_task() or {})
    w._note_duration("m", 1.0)
    w._persist_ewma("m")                # two own observations: folds
    doc = store.get_task() or {}
    assert doc.get("dur_ewma:m") == pytest.approx(w._dur_ewma["m"])


# --- worker-side doc follow (controller-off inertness) -----------------------

def test_worker_follows_controller_knobs_only_under_marker():
    """Workers apply controller-owned process-state knobs (retry base,
    push budget) ONLY when the doc carries the autotune marker — an
    autotune-off fleet is bit-for-bit inert to stray doc keys."""
    base = float(retry_settings()["base_ms"])
    w = Worker(MemJobStore(), name="inert-0")
    # the poll path gates on the marker; the raw doc without it must
    # leave the process-global backoff untouched
    task = {"retry_base_ms": base * 7, "push_budget_mb": 3.0}
    if task.get("autotune"):
        w._follow_autotune(task)
    assert float(retry_settings()["base_ms"]) == base
    assert w._task_push_budget is None
    # under the marker both apply, and a live pool re-budgets in place
    w.push = True
    pool = w._push_pool()
    task["autotune"] = True
    w._follow_autotune(task)
    assert float(retry_settings()["base_ms"]) == base * 7
    assert w._task_push_budget == 3.0
    assert pool.budget == int(3.0 * 1024 * 1024)
    assert w._push_pool() is pool       # same pool, moved threshold
