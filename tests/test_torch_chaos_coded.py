"""The erasure-coded shuffle under chaos, on the port ≡ the JAX
package's ``tests/test_chaos.py:860-1077`` without its hybrid leg: one
block of every stripe destroyed (decode from the survivors, zero
re-runs) on both executors over {mem, shared, object} × {barrier,
pipelined}, a placement tag dark during a coded push run, and a
corrupted parity block refused by its CRC."""

import threading

import pytest

from test_torch_chaos import (GOLDEN, _MOD, _install_module,
                                _result_bytes, _run_distributed,
                                _run_local, _storage)
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.core.constants import Status
from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.local import iter_results
from lua_mapreduce_tpu_torch.engine.server import Server
from lua_mapreduce_tpu_torch.engine.worker import RED_NS, Worker
from lua_mapreduce_tpu_torch.faults import FaultPlan
from lua_mapreduce_tpu_torch.store.router import get_storage_from


# --- erasure-coded shuffle legs (DESIGN §27) ---------------------------------
#
# The coded chaos gate: the replication bar carried over verbatim to
# the coded plane at ~1.3x write amplification instead of 2x. A
# FaultPlan destroys one block of EVERY stripe (the coded analog of
# 'every primary destroyed' — any <= m losses per stripe must decode
# inline), a whole placement tag goes dark during a coded push run, a
# producer is SIGKILLed mid-stripe (above), and a corrupted parity
# block must be caught by the block CRC and treated as one more lost
# block, not served.

def _kill_block0_plan(seed):
    """Every read of the FIRST data block of every stripe fails
    permanently — one destroyed block per stripe, the r-1-of-r kill
    translated to k+m (the pattern's ^0. prefix never matches a
    manifest copy, a plain tail, or a list() pattern argument)."""
    return FaultPlan(seed, permanent=1.0, pattern="^0.*^result.*",
                     max_per_key=100_000, latency_ms=0)


def test_coded_smoke_decode(tmp_path):
    """The test.sh coded chaos gate: one fast leg — a data block of
    every stripe destroyed, parity decodes inline, zero map re-runs,
    byte-identical output."""
    clean, _ = _run_local(tmp_path, "mem", False, "cod-smoke-c")
    plan = _kill_block0_plan(251)
    chaotic, stats = _run_local(tmp_path, "mem", False, "cod-smoke-f",
                                plan=plan, coding="4+1")
    assert chaotic == clean, "coded decode leg output differs"
    assert plan.total_fired() > 0
    it = stats.iterations[-1]
    assert it.decode_reads > 0, "plan never forced a decode"
    assert it.map_reruns_avoided > 0
    assert it.map_reruns == 0, "parity failed to absorb the block kills"


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["barrier", "pipelined"])
@pytest.mark.parametrize("backend", ["mem", "shared", "object"])
def test_coded_chaos_distributed_matrix(tmp_path, backend, pipeline):
    """The acceptance matrix on the distributed engine under coding
    4+1: one block of every stripe destroyed across
    {mem,shared,object} x {barrier,pipelined} — byte-identical to the
    fault-free twin, zero repetition bumps (asserted per job inside
    _run_distributed), zero map re-runs: pure decode reads."""
    tag = f"cod-{backend}-{int(pipeline)}"
    clean, _ = _run_distributed(tmp_path, backend, pipeline, tag + "-c")
    plan = _kill_block0_plan(257)
    chaotic, stats = _run_distributed(tmp_path, backend, pipeline,
                                      tag + "-f", plan=plan, coding="4+1")
    assert chaotic == clean, "coded decode leg output differs"
    assert plan.total_fired() > 0
    it = stats.iterations[-1]
    assert it.decode_reads > 0, "plan never forced a decode"
    assert it.map_reruns == 0, "parity failed to absorb the block kills"


def test_coded_chaos_blackout_push(tmp_path):
    """m placement tags dark (m=1 for 4+1) for the WHOLE of a coded
    PUSH run — every stripe block, group-stripe block, manifest copy
    and replicated eviction tail routed onto the dark tag is
    unreadable. Each stripe spans k+m distinct tags so it loses at
    most one block; each manifest and tail has m+1 copies on distinct
    tags: the run completes byte-identical with ZERO map re-runs."""
    from lua_mapreduce_tpu_torch.engine.placement import replica_pattern
    from lua_mapreduce_tpu_torch.faults.coded import stripe_patterns

    clean, _ = _run_local(tmp_path, "mem", True, "cod-bo-c")
    # scope the blackout to the whole shuffle plane, in every physical
    # spelling: plain names (staged runs, eviction tails), ~-replica
    # copies, ^-stripe blocks and manifest copies, and the shared
    # group-stripe blocks under the CODE tag
    shuffle = ["result.P[0-9]*.M*", "result.P[0-9]*.SPILL-*",
               "result.P[0-9]*.INBOX-*", "result.PUSH.M*", "result.CODE.*"]
    phys = []
    for p in shuffle:
        phys += [p, replica_pattern(p)]
        for sp in stripe_patterns(p):
            phys += [sp, replica_pattern(sp)]
    plan = FaultPlan(241, blackout_tag=2, blackout_s=3600.0,
                     pattern="|".join(phys), latency_ms=0)
    chaotic, stats = _run_local(tmp_path, "mem", True, "cod-bo-f",
                                plan=plan, push=True, coding="4+1")
    assert chaotic == clean, "coded blackout leg output differs"
    assert plan.fired.get("blackout", 0) > 0, "the dark tag was never hit"
    it = stats.iterations[-1]
    assert it.push_frames > 0
    assert it.decode_reads + it.failover_reads > 0, \
        "the blackout never forced a degraded read"
    assert it.map_reruns == 0


def test_coded_chaos_corrupt_parity_block(tmp_path):
    """A corrupted parity block is DETECTED by the per-block CRC and
    treated as one more lost block — never folded into a decode. With
    4+2, one data block destroyed AND one parity block corrupted on
    the same stripe still leaves k readable blocks: the reduce decodes
    inline, zero map re-runs, byte-identical output."""
    import time

    clean, _ = _run_distributed(tmp_path, "shared", False, "cod-crc-c")

    _install_module()
    spec = TaskSpec(taskfn=_MOD, mapfn=_MOD, partitionfn=_MOD,
                    reducefn=_MOD, init_args={"device": "cpu"},
                    storage=_storage(tmp_path, "shared", "cod-crc-f"))
    store = MemJobStore()
    server = Server(store, poll_interval=0.01, premerge_min_runs=2,
                    batch_k=2, coding="4+2").configure(spec)
    # map-only worker first: the reduce phase is reached with NO reduce
    # consumer, so the corruption below races nothing
    mapper = Worker(store).configure(max_iter=4000, max_sleep=0.02,
                                     phases=("map",))
    final = {}
    st = threading.Thread(
        target=lambda: final.setdefault("stats", server.loop()),
        daemon=True)
    mt = threading.Thread(target=mapper.execute, daemon=True)
    st.start()
    mt.start()

    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            if store.counts(RED_NS)[Status.WAITING] > 0:
                break
        except Exception:
            pass
        time.sleep(0.01)
    else:
        raise AssertionError("never reached the reduce phase")

    # mutate the stripe on disk, under the engine: delete the block-0
    # file of one partition-0 run and flip one byte inside the SAME
    # stripe's first parity block (index k=4) — the decode that the
    # deletion forces must reject the corrupted parity on CRC and
    # reconstruct from the remaining k survivors
    import os

    from lua_mapreduce_tpu_torch.engine.placement import base_name

    spill_dir = str(tmp_path / "shared-cod-crc-f")
    data0 = [f for f in os.listdir(spill_dir)
             if f.startswith("^0.") and "result.P0." in f]
    assert data0, "partition 0 produced no stripe blocks"
    victim_base = base_name(data0[0])
    stripe = [f for f in os.listdir(spill_dir)
              if f.endswith(victim_base) and "^" in f]
    parity = [f for f in stripe if f.startswith("^4.")]
    assert parity, f"stripe of {victim_base} has no parity block"
    ppath = os.path.join(spill_dir, parity[0])
    blob = open(ppath, "rb").read()
    pos = min(10, len(blob) - 1)
    with open(ppath, "wb") as fh:
        fh.write(blob[:pos] + bytes([blob[pos] ^ 0xFF]) + blob[pos + 1:])
    os.remove(os.path.join(spill_dir, data0[0]))

    reducer = Worker(store).configure(max_iter=4000, max_sleep=0.05)
    rt = threading.Thread(target=reducer.execute, daemon=True)
    rt.start()
    st.join(timeout=60)
    assert not st.is_alive(), "server wedged after the block mutation"
    mt.join(timeout=10)
    rt.join(timeout=10)

    raw = get_storage_from(spec.storage)
    got = {k: v[0] for k, v in iter_results(raw, "result")}
    assert got == GOLDEN
    assert _result_bytes(spec.storage, only_results=True) == clean
    it = final["stats"].iterations[-1]
    assert it.decode_reads > 0, "the mutation never forced a decode"
    assert it.map_reruns == 0, \
        "corrupt parity + one lost data block must decode, not re-run"
