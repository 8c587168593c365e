"""The push shuffle under chaos, on the port ≡ the JAX package's
``tests/test_chaos.py:578-614, 648-858``: seeded faults on a push run, a
placement tag dark while frames are pushed, and a pushing mapper
SIGKILLed mid-frame (and mid-stripe under coding), covered by the stale
requeue and, as in the JAX file, by a speculative clone with the stale
requeue off. The speculation straggler leg is in
tests/test_torch_chaos.py."""

from test_torch_chaos import _plan, _run_local, _sigkill_pusher_leg
from lua_mapreduce_tpu_torch.faults import FaultPlan


# --- push-shuffle legs (DESIGN §24) ------------------------------------------
#
# The streaming shuffle under the same storms as the staged plane —
# seeded transient faults, a whole placement tag dark during the push,
# and a SIGKILLed mapper mid-frame, its job covered by the stale requeue
# (one repetition charged) or by a clone (zero charged).

def test_push_chaos_smoke_faultplan(tmp_path):
    """Seeded transient/latency/error-after-write faults on a push run:
    invisible in the bytes (vs the fault-free STAGED twin — one oracle
    covers both mode equivalence and fault absorption)."""
    clean, _ = _run_local(tmp_path, "mem", False, "push-sm-c")
    plan = _plan(seed=211)
    chaotic, stats = _run_local(tmp_path, "mem", False, "push-sm-f",
                                plan=plan, push=True)
    assert chaotic == clean
    assert plan.total_fired() > 0
    assert stats.iterations[-1].push_frames > 0


def test_push_chaos_blackout_tag(tmp_path):
    """One placement tag dark for the whole run while frames are being
    pushed (fragments, tails, manifests AND their replica copies on the
    dark tag): r=2 failover serves every read — byte-identical output,
    zero map re-runs."""
    from lua_mapreduce_tpu_torch.engine.placement import replica_pattern

    clean, _ = _run_local(tmp_path, "mem", True, "push-bo-c")
    shuffle = ["result.P[0-9]*.M*", "result.P[0-9]*.SPILL-*",
               "result.P[0-9]*.INBOX-*", "result.PUSH.M*"]
    plan = FaultPlan(223, blackout_tag=5, blackout_s=3600.0,
                     pattern="|".join(shuffle
                                      + [replica_pattern(p)
                                         for p in shuffle]),
                     latency_ms=0)
    chaotic, stats = _run_local(tmp_path, "mem", True, "push-bo-f",
                                plan=plan, push=True, replication=2)
    assert chaotic == clean
    assert plan.fired.get("blackout", 0) > 0, "the dark tag was never hit"
    it = stats.iterations[-1]
    assert it.push_frames > 0
    assert it.map_reruns == 0


def test_push_chaos_sigkill_pusher_midframe(tmp_path):
    _sigkill_pusher_leg(tmp_path, "pushkill_wc")


def test_push_chaos_sigkill_pusher_midframe_clone_covers(tmp_path):
    """The JAX file's form: the stale requeue off, speculation on — a
    clone finishes the killed pusher's job at zero repetitions."""
    _sigkill_pusher_leg(tmp_path, "pushkill_clone_wc", clone=True)
