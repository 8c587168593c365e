"""A spill copy that no sweep could remove, on the port and on the JAX
package. Under replication a sweep removes every copy of a file and
swallows a copy's failure to go (its placement tag dark), and a listing
names the file while any copy is left. An earlier iteration's spill can
so outlive the sweep at the start of an iteration under a name this
iteration's pipelined shuffle would use. The reference takes it for a
crash leftover of this iteration, and once the tag is back serves its
older data. The port records such names after the sweep: the pre-merge
tracker publishes no spill under them and discovery reads none.

The stale spill is planted before the run (a fresh start sweeps the
namespace as every loop rollover does), on the word count of
``test_torch_chaos``, with the dark tag that of its replica copy."""

import threading
import types

import pytest

from test_torch_chaos import (CORPUS, GOLDEN, _MOD, _install_module,
                              _result_bytes)

PART, FIRST, LAST = 0, 0, 1     # the stale spill: partition 0, docs 0-1
STALE_VALUE = 1000


def _pkg(name):
    """One package's engine, fault and store surface."""
    if name == "jax":
        from lua_mapreduce_tpu.coord.jobstore import MemJobStore
        from lua_mapreduce_tpu.engine.contract import TaskSpec
        from lua_mapreduce_tpu.engine.local import (LocalExecutor,
                                                    iter_results)
        from lua_mapreduce_tpu.engine.placement import replica_names, tag_of
        from lua_mapreduce_tpu.engine.premerge import spill_name
        from lua_mapreduce_tpu.engine.server import Server
        from lua_mapreduce_tpu.engine.worker import Worker
        from lua_mapreduce_tpu.faults import FaultPlan, install_fault_plan
        from lua_mapreduce_tpu.faults.replicate import spill_writer
        from lua_mapreduce_tpu.faults.wrappers import unwrap
        from lua_mapreduce_tpu.store.router import get_storage_from
        init_args = {}
    else:
        from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
        from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
        from lua_mapreduce_tpu_torch.engine.local import (LocalExecutor,
                                                          iter_results)
        from lua_mapreduce_tpu_torch.engine.placement import (replica_names,
                                                              tag_of)
        from lua_mapreduce_tpu_torch.engine.premerge import spill_name
        from lua_mapreduce_tpu_torch.engine.server import Server
        from lua_mapreduce_tpu_torch.engine.worker import Worker
        from lua_mapreduce_tpu_torch.faults import (FaultPlan,
                                                    install_fault_plan)
        from lua_mapreduce_tpu_torch.faults.replicate import spill_writer
        from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
        from lua_mapreduce_tpu_torch.store.router import get_storage_from
        init_args = {"device": "cpu"}
    return types.SimpleNamespace(**locals())


def _words(part):
    return sorted(w for w in GOLDEN if sum(w.encode()) % 4 == part)


def _plant(pkg, storage):
    """The stale spill, both copies, every value STALE_VALUE; returns
    its name, its copies' names and their bytes."""
    name = pkg.spill_name("result", PART, FIRST, LAST)
    raw = pkg.unwrap(pkg.get_storage_from(storage))
    w = pkg.spill_writer(raw, "v2", 2)
    try:
        for word in _words(PART):
            w.add(word, [STALE_VALUE])
        w.build(name)
    finally:
        w.close()
    copies = pkg.replica_names(name, 2)
    return name, copies, [raw.read_range(c, 0, raw.size(c))
                          for c in copies]


def _dark_plan(pkg, copies, clock=None):
    """The replica copy's tag dark, scoped to the stale spill's copies;
    on ``clock`` (a one-item list) the window is [0, 1) s, else the
    whole run."""
    kw = dict(blackout_tag=pkg.tag_of(copies[1]), latency_ms=0,
              pattern="|".join(copies))
    if clock is None:
        return pkg.FaultPlan(5, blackout_s=3600.0, **kw)
    return pkg.FaultPlan(5, blackout_s=1.0, clock=lambda: clock[0], **kw)


def _spec(pkg, storage):
    _install_module()
    return pkg.TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                        reducefn=_MOD, init_args=dict(pkg.init_args),
                        storage=storage)


def _run_server(pkg, storage, plan=None, after_sweep=None):
    """The pipelined word count at replication 2 through a Server and
    two in-process workers; ``after_sweep()`` runs right after the
    server's sweep of the namespace's runs and spills."""
    spec = _spec(pkg, storage)
    store = pkg.MemJobStore()
    pkg.install_fault_plan(plan)
    try:
        server = pkg.Server(store, poll_interval=0.01, pipeline=True,
                            premerge_min_runs=2, segment_format="v2",
                            replication=2).configure(spec)
        if after_sweep is not None:
            sweep = server._clean_runs

            def clean_runs(st):
                sweep(st)
                after_sweep()
            server._clean_runs = clean_runs
        workers = [pkg.Worker(store).configure(max_iter=800, max_sleep=0.02)
                   for _ in range(2)]
        threads = [threading.Thread(target=w.execute, daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        stats = server.loop()
        for t in threads:
            t.join(timeout=30)
    finally:
        pkg.install_fault_plan(None)
    got = {k: v[0] for k, v in pkg.iter_results(
        pkg.get_storage_from(storage), "result")}
    return got, stats


@pytest.mark.parametrize("lit_after_sweep", [True, False],
                         ids=["lit-after-sweep", "dark-throughout"])
def test_server_ignores_a_spill_its_sweep_could_not_remove(lit_after_sweep):
    """The port's Server: the stale spill's replica copy survives the
    sweep (its tag dark), then either comes back or stays dark. The
    result bytes equal the clean run's, no map re-ran, and the stale
    copy was neither read nor rewritten."""
    port = _pkg("port")
    tag = f"tstale-srv-{int(lit_after_sweep)}"
    clean, _ = _run_server(port, f"mem:{tag}-c")
    assert clean == GOLDEN
    name, copies, planted = _plant(port, f"mem:{tag}-f")
    clock = [0.0] if lit_after_sweep else None
    plan = _dark_plan(port, copies, clock)

    def lights_on():
        if clock is not None:
            clock[0] = 5.0
    got, stats = _run_server(port, f"mem:{tag}-f", plan, lights_on)
    assert got == GOLDEN
    assert _result_bytes(f"mem:{tag}-f", only_results=True) == \
        _result_bytes(f"mem:{tag}-c", only_results=True)
    assert plan.fired.get("blackout", 0) > 0
    assert sum(it.map_reruns for it in stats.iterations) == 0
    raw = port.unwrap(port.get_storage_from(f"mem:{tag}-f"))
    if lit_after_sweep:
        # the iteration's discovery swept the name once its tag was back
        assert not any(raw.exists(c) for c in copies)
    else:
        assert raw.read_range(copies[1], 0, raw.size(copies[1])) == \
            planted[1]


def test_reference_server_serves_the_unremoved_spill():
    """The JAX package's Server on the same plant, the tag back right
    after the sweep: it takes the stale spill for this iteration's, so
    partition 0's words count the planted value in place of docs 0-1 —
    the fault the port's sweep record repairs."""
    jax = _pkg("jax")
    name, copies, _ = _plant(jax, "mem:tstale-jax")
    clock = [0.0]
    plan = _dark_plan(jax, copies, clock)
    got, _ = _run_server(jax, "mem:tstale-jax", plan,
                         lambda: clock.__setitem__(0, 5.0))
    assert plan.fired.get("blackout", 0) > 0
    later = [CORPUS[k] for k in sorted(CORPUS)[LAST + 1:]]
    for word in _words(PART):
        assert got[word] == STALE_VALUE + sum(
            t.split().count(word) for t in later)
    assert {w: c for w, c in got.items() if w not in _words(PART)} == \
        {w: c for w, c in GOLDEN.items() if w not in _words(PART)}


def test_local_executor_ignores_a_spill_it_could_not_remove():
    """The port's LocalExecutor, the stale spill's replica tag dark for
    the whole run: the result bytes equal the clean run's."""
    port = _pkg("port")
    spec_c, spec_f = (_spec(port, f"mem:tstale-local-{s}") for s in "cf")
    port.LocalExecutor(spec_c, map_parallelism=3, pipeline=True,
                       premerge_min_runs=2, segment_format="v2",
                       replication=2).run()
    name, copies, planted = _plant(port, spec_f.storage)
    plan = _dark_plan(port, copies)
    port.install_fault_plan(plan)
    try:
        ex = port.LocalExecutor(spec_f, map_parallelism=3, pipeline=True,
                                premerge_min_runs=2, segment_format="v2",
                                replication=2)
        ex.run()
    finally:
        port.install_fault_plan(None)
    assert {k: v[0] for k, v in ex.results()} == GOLDEN
    assert _result_bytes(spec_f.storage, only_results=True) == \
        _result_bytes(spec_c.storage, only_results=True)
    assert plan.fired.get("blackout", 0) > 0
    assert sum(it.map_reruns for it in ex.stats.iterations) == 0
    raw = port.unwrap(port.get_storage_from(spec_f.storage))
    assert raw.read_range(copies[1], 0, raw.size(copies[1])) == planted[1]


def test_tracker_keeps_an_avoided_range_raw_and_discovery_ignores_it():
    """The unit: a chunk whose spill name is avoided is poisoned (its
    runs reduce raw), and discovery lists the raw runs in place of the
    avoided spill, which it sweeps."""
    from lua_mapreduce_tpu_torch.engine.premerge import (PremergeTracker,
                                                         discover_pipelined,
                                                         spill_name)
    from lua_mapreduce_tpu_torch.store.memfs import MemStore
    keys = [f"{i:08d}" for i in range(4)]
    avoided = spill_name("ns", 0, 0, 1)
    tr = PremergeTracker("ns", keys, min_runs=2, max_runs=2,
                         avoid=[avoided])
    store = MemStore()
    for k in keys:
        with store.builder() as b:
            b.write(f"w\t[{k}]\n")
            b.build(f"ns.P0.M{k}")
        tr.note_map_committed(k, {0: f"ns.P0.M{k}"})
    made = tr.take_eligible()
    assert [sp.name for sp in made] == [spill_name("ns", 0, 2, 3)]
    assert tr.poisoned == {0: {0, 1}}
    with store.builder() as b:
        b.write("w\t[0]\n")
        b.build(avoided)
    got = discover_pipelined(store, "ns", keys, ignore=[avoided])
    assert got == {0: [f"ns.P0.M{k}" for k in keys]}
    assert not store.exists(avoided)
