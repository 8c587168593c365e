"""An earlier iteration's canonical push manifest ``result.PUSH.M<key>``
and the inbox fragment it names, left by a sweep that could not remove
them (their replica copies' placement tag dark), on the two paths that
``test_torch_stale_runs`` does not take:

* a speculative clone that wins a map of that key. Its output is
  quarantined under its lineage until its commit wins; then
  ``engine/push.py::promote`` makes it canonical. Promote publishes if
  absent, so over a leftover it would keep the old manifest, and
  discovery would read the old fragment in place of the map's output.
  The job doc names the leftover (``Server._map_docs``): the winner
  publishes over it.
* the LocalExecutor's push sweep at the start of an iteration
  (``sweep_push_files``), which swallows a failed remove. Its maps
  publish if absent, so a manifest it left would win over this
  iteration's. The sweep returns what it left, and the maps publish
  over it.
"""

import pytest

from test_torch_chaos import GOLDEN, _result_bytes
from test_torch_stale_runs import STALE_VALUE, _map_keys, _plant
from test_torch_stale_spill import _pkg, _spec


def _manifest(storage, key):
    from lua_mapreduce_tpu_torch.engine.push import (manifest_name,
                                                     read_manifest)
    from lua_mapreduce_tpu_torch.faults.replicate import reading_view
    port = _pkg("port")
    view = reading_view(port.get_storage_from(storage), 2)
    return read_manifest(view, manifest_name("result", key))


@pytest.mark.parametrize("leftover", [True, False],
                         ids=["over-a-leftover", "no-leftover"])
def test_winning_clone_publishes_over_a_leftover_manifest(leftover):
    """A map job whose key has a leftover canonical manifest (its doc
    says so): its original claims it and stalls, a clone runs it, wins
    the commit race and promotes its lineage. The canonical manifest is
    then the clone's, naming none of the planted files. Without a
    leftover, promote still publishes only if absent."""
    from lua_mapreduce_tpu_torch.core.constants import MAP_NS
    from lua_mapreduce_tpu_torch.coord.jobstore import make_job
    from lua_mapreduce_tpu_torch.engine.local import collect_task_jobs
    from lua_mapreduce_tpu_torch.engine.push import (lineage_token,
                                                     manifest_files_by_part,
                                                     manifest_name)
    port = _pkg("port")
    storage = f"mem:tstale-promote-{int(leftover)}"
    spec = _spec(port, storage)
    key = _map_keys()[0]
    (_, frag, man_name), _ = _plant(storage)
    stale = _manifest(storage, key)
    assert manifest_files_by_part(stale) and frag in str(stale)
    store = port.MemJobStore()
    docs = [make_job(k, v) for k, v in collect_task_jobs(spec)]
    if leftover:
        docs[0]["leftovers"] = [man_name]
    store.insert_jobs(MAP_NS, docs)
    jid = store.claim_batch(MAP_NS, "orig", 1)[0]["_id"]
    assert manifest_name("result", key) == man_name
    assert store.speculate(MAP_NS, jid)
    w = port.Worker(store, name="clone").configure(
        push=True, replication=2, segment_format="v2")
    clone = store.claim_spec(MAP_NS, w.name)
    assert clone["_id"] == jid
    assert w.run_one(spec, MAP_NS, clone) is True
    got = _manifest(storage, key)
    if not leftover:
        assert got == stale            # publish-if-absent, as before
        return
    files = [f for fs in manifest_files_by_part(got).values() for f in fs]
    assert files and frag not in files
    assert all(lineage_token("clone") in f for f in files), files
    assert got["lineage"] == lineage_token("clone")


def test_discovery_right_after_a_winning_clones_commit_skips_the_leftover():
    """The gap between a winning clone's commit and the rest of its
    run_one: the commit makes the map WRITTEN, and the server's
    discovery (``push_file_lists``, as barrier and pipelined discovery
    resolve a committed map) may run at once. A job whose key has a
    leftover canonical manifest must then resolve to the clone's
    lineage, never to the leftover's fragment."""
    from lua_mapreduce_tpu_torch.core.constants import MAP_NS
    from lua_mapreduce_tpu_torch.coord.jobstore import make_job
    from lua_mapreduce_tpu_torch.engine.local import collect_task_jobs
    from lua_mapreduce_tpu_torch.engine.push import (lineage_token,
                                                     push_file_lists)
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    port = _pkg("port")
    storage = "mem:tstale-promote-gap"
    spec = _spec(port, storage)
    key = _map_keys()[0]
    (_, frag, man_name), _ = _plant(storage)
    store = port.MemJobStore()
    docs = [make_job(k, v) for k, v in collect_task_jobs(spec)]
    docs[0]["leftovers"] = [man_name]
    store.insert_jobs(MAP_NS, docs)
    jid = store.claim_batch(MAP_NS, "orig", 1)[0]["_id"]
    assert store.speculate(MAP_NS, jid)
    seen = []
    commit = store.commit_batch

    def commit_then_discover(ns, worker, entries):
        done = commit(ns, worker, entries)
        if done and ns == MAP_NS:
            lists, _ = push_file_lists(get_storage_from(storage), "result",
                                       [key], 2)
            seen.append([f for fs in lists.get(key, {}).values()
                         for f in fs])
        return done
    store.commit_batch = commit_then_discover
    w = port.Worker(store, name="clone").configure(
        push=True, replication=2, segment_format="v2")
    clone = store.claim_spec(MAP_NS, w.name)
    assert w.run_one(spec, MAP_NS, clone) is True
    assert len(seen) == 1 and seen[0], seen
    assert frag not in seen[0]
    assert all(lineage_token("clone") in f for f in seen[0]), seen[0]


def test_local_executor_publishes_over_a_manifest_its_sweep_left():
    """The LocalExecutor with push on at replication 2: the stale
    manifest and fragment outlive its iteration-start push sweep (their
    replica tag dark), then the tag comes back. The results and result
    bytes equal a clean run's: no map took the old manifest for its
    own."""
    from lua_mapreduce_tpu_torch.engine import local
    port = _pkg("port")
    spec_c, spec_f = (_spec(port, f"mem:tstale-push-local-{s}")
                      for s in "cf")
    kw = dict(map_parallelism=3, push=True, segment_format="v2",
              replication=2)
    port.LocalExecutor(spec_c, **kw).run()
    names, dark = _plant(spec_f.storage)
    raw = port.unwrap(port.get_storage_from(spec_f.storage))
    copies = [c for n in names for c in port.replica_names(n, 2)]
    clock = [0.0]
    plan = port.FaultPlan(5, blackout_tag=dark, blackout_s=1.0,
                          clock=lambda: clock[0], latency_ms=0,
                          pattern="|".join(copies))
    sweep = local.sweep_push_files

    def sweep_then_lights_on(*a, **k):
        out = sweep(*a, **k)
        # the sweep left the replica copies: the fault under test
        assert all(raw.exists(c) for c in copies[1::2])
        clock[0] = 5.0
        return out
    port.install_fault_plan(plan)
    local.sweep_push_files = sweep_then_lights_on
    try:
        ex = port.LocalExecutor(spec_f, **kw)
        ex.run()
    finally:
        local.sweep_push_files = sweep
        port.install_fault_plan(None)
    assert plan.fired.get("blackout", 0) > 0
    got = {k: v[0] for k, v in ex.results()}
    assert not any(v == STALE_VALUE for v in got.values())
    assert got == GOLDEN
    assert _result_bytes(spec_f.storage, only_results=True) == \
        _result_bytes(spec_c.storage, only_results=True)
