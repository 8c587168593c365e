"""Raw runs, inbox fragments and push manifests that no sweep could
remove, on the port's Server. Beside ``test_torch_stale_spill`` (which
covers spills): under replication a sweep removes every copy of a file
and swallows a copy's failure to go (its placement tag dark), and a
listing names the file while any copy is left. The iteration-start
sweep can so leave, once the tag is back, an earlier iteration's

* raw run ``result.P<p>.M<key>`` of a map key this iteration does not
  have — the barrier and pipelined discoveries list every ``.P*.M*``;
* canonical push manifest ``result.PUSH.M<key>`` of a key it does have,
  naming an inbox fragment ``result.P<p>.INBOX-*`` that survived too —
  the map's publish-if-absent keeps the old manifest, and discovery
  reads the old fragment in place of the map's own output.

The plant is made before the run (a fresh start sweeps the namespace as
every loop rollover does), every copy written, the replica copies' tag
dark until right after the sweep. The next iteration must reduce none
of the planted files: its results and result bytes equal a clean run's.
"""

import threading

import pytest

from test_torch_chaos import CORPUS, GOLDEN, _result_bytes
from test_torch_stale_spill import _pkg, _spec, _words

STALE_VALUE = 1000
MODES = {"barrier": dict(pipeline=False, push=False),
         "pipelined": dict(pipeline=True, push=False),
         "push": dict(pipeline=False, push=True),
         "pipelined-push": dict(pipeline=True, push=True)}


def _map_keys():
    """The word count's map keys: one job a document, ids 0, 1, ..."""
    from lua_mapreduce_tpu_torch.engine.job import map_key_str
    return [map_key_str(i) for i in range(len(CORPUS))]


def _plant(storage):
    """The stale run, fragment and manifest, both copies of each, every
    value STALE_VALUE; the three replica copies share one placement tag.
    Returns the three names and that tag."""
    from lua_mapreduce_tpu_torch.engine.placement import (replica_names,
                                                          tag_of)
    from lua_mapreduce_tpu_torch.engine.push import (frag_name,
                                                     manifest_name,
                                                     write_manifest)
    from lua_mapreduce_tpu_torch.faults.replicate import spill_writer
    from lua_mapreduce_tpu_torch.faults.wrappers import unwrap
    from lua_mapreduce_tpu_torch.store.router import get_storage_from

    def replica_tag(name):
        return tag_of(replica_names(name, 2)[1])
    key = _map_keys()[0]
    manifest = manifest_name("result", key)
    tag = replica_tag(manifest)
    run = next(n for n in (f"result.P{p}.M{90000000 + i:08d}"
                           for i in range(64) for p in range(4))
               if replica_tag(n) == tag)
    frag = next(n for n in (frag_name("result", p, key, None, seq)
                            for seq in range(100, 400) for p in range(4))
                if replica_tag(n) == tag)
    raw = unwrap(get_storage_from(storage))
    for name in (run, frag):
        part = int(name.split(".P", 1)[1].split(".", 1)[0])
        w = spill_writer(raw, "v2", 2)
        try:
            for word in _words(part):
                w.add(word, [STALE_VALUE])
            w.build(name)
        finally:
            w.close()
    frag_part = frag.split(".P", 1)[1].split(".", 1)[0]
    write_manifest(raw, manifest, {"lineage": "", "parts": {
        frag_part: {"frags": [frag], "tail": None}}}, 2)
    return (run, frag, manifest), tag


def _run_server(storage, mode, plan=None, after_sweep=None):
    """The word count at replication 2 through the port's Server and two
    in-process workers; ``after_sweep()`` runs right after the server's
    sweep of the namespace's runs."""
    port = _pkg("port")
    spec = _spec(port, storage)
    store = port.MemJobStore()
    port.install_fault_plan(plan)
    try:
        server = port.Server(store, poll_interval=0.01, premerge_min_runs=2,
                             segment_format="v2", replication=2,
                             **MODES[mode]).configure(spec)
        if after_sweep is not None:
            sweep = server._clean_runs

            def clean_runs(st):
                sweep(st)
                after_sweep()
            server._clean_runs = clean_runs
        workers = [port.Worker(store).configure(max_iter=800, max_sleep=0.02)
                   for _ in range(2)]
        threads = [threading.Thread(target=w.execute, daemon=True)
                   for w in workers]
        for t in threads:
            t.start()
        server.loop()
        for t in threads:
            t.join(timeout=30)
    finally:
        port.install_fault_plan(None)
    return {k: v[0] for k, v in port.iter_results(
        port.get_storage_from(storage), "result")}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_server_reduces_no_run_fragment_or_manifest_its_sweep_left(mode):
    """The stale raw run, inbox fragment and manifest outlive the sweep
    (their replica tag dark), then the tag comes back. The results and
    the result bytes equal a clean run's: the iteration reduced none of
    them."""
    port = _pkg("port")
    tag = f"tstale-runs-{mode}"
    clean = _run_server(f"mem:{tag}-c", mode)
    assert clean == GOLDEN
    names, dark = _plant(f"mem:{tag}-f")
    raw = port.unwrap(port.get_storage_from(f"mem:{tag}-f"))
    copies = [c for n in names for c in port.replica_names(n, 2)]
    assert all(raw.exists(c) for c in copies)
    clock = [0.0]
    plan = port.FaultPlan(5, blackout_tag=dark, blackout_s=1.0,
                          clock=lambda: clock[0], latency_ms=0,
                          pattern="|".join(copies))

    def lights_on():
        # the sweep left the replica copies: the fault under test
        assert all(raw.exists(c) for c in copies[1::2])
        clock[0] = 5.0
    got = _run_server(f"mem:{tag}-f", mode, plan, lights_on)
    assert plan.fired.get("blackout", 0) > 0
    assert got == GOLDEN
    assert _result_bytes(f"mem:{tag}-f", only_results=True) == \
        _result_bytes(f"mem:{tag}-c", only_results=True)
