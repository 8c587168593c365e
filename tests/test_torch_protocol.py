"""Parity of the port's lease-protocol model checker with the JAX package's.

Each box and seeded bug of the JAX package's protocol tests
(``tests/test_analysis.py``, ``tests/test_sched.py``,
``tests/test_speculation.py``) goes through ``check_protocol`` of both
packages: states, transitions, quiescent states, verdict, violation
message and trace must be equal, and the port's result must pass the
JAX test's own assertions. Traces replay on the port's three job stores
— ``MemJobStore``, ``FileJobStore`` on the Python index and on the
native one (g++ builds it) — with the same verdict and divergent step as
on the JAX package's store of the same kind. The whole default suite of
``python -m ...analysis protocol`` is one heavy test.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from lua_mapreduce_tpu.analysis import protocol as jproto
from lua_mapreduce_tpu.coord.filestore import FileJobStore as JaxFileJobStore
from lua_mapreduce_tpu.coord.jobstore import MemJobStore as JaxMemJobStore
from lua_mapreduce_tpu_torch.analysis import protocol as proto
from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.core.constants import Status

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (port store, the JAX package's store of the same kind)
STORES = {
    "mem": (lambda d: MemJobStore(), lambda d: JaxMemJobStore()),
    "file-py": (lambda d: FileJobStore(d, engine="python"),
                lambda d: JaxFileJobStore(d, engine="python")),
    "file-native": (lambda d: FileJobStore(d, engine="native"),
                    lambda d: JaxFileJobStore(d, engine="native")),
}
stores = pytest.mark.parametrize("kind", sorted(STORES))


def _summary(res):
    v = res.violation
    return (dataclasses.asdict(res.config), res.states, res.transitions,
            res.quiescent, res.ok,
            None if v is None else (v.message, [tuple(t) for t in v.trace],
                                    v.state))


def check(max_states=None, **cfg):
    """check_protocol of both packages on one box; they must agree. The
    port's result is returned."""
    kw = {} if max_states is None else {"max_states": max_states}
    got = proto.check_protocol(proto.ModelConfig(**cfg), **kw)
    want = jproto.check_protocol(jproto.ModelConfig(**cfg), **kw)
    assert _summary(got) == _summary(want)
    return got


def replay(kind, tmp_path, trace, cfg, **kw):
    """replay_trace on the port's store of ``kind`` and on the JAX
    package's; verdict, divergent step and reason must agree. The port's
    report is returned."""
    make_port, make_jax = STORES[kind]
    got = proto.replay_trace(make_port(str(tmp_path / "port")), trace,
                             proto.ModelConfig(**dataclasses.asdict(cfg)),
                             **kw)
    want = jproto.replay_trace(make_jax(str(tmp_path / "jax")), trace,
                               jproto.ModelConfig(**dataclasses.asdict(cfg)),
                               **kw)
    assert got == want
    return got


# --- tests/test_analysis.py ------------------------------------------------

@pytest.mark.parametrize("box", [
    dict(n_workers=1, n_jobs=2, batch_k=2),
    dict(n_workers=2, n_jobs=2, batch_k=1),
    dict(n_workers=2, n_jobs=2, batch_k=2, allow_fail=True,
         allow_death=False)], ids=["1w", "2w", "failure-path"])
def test_protocol_exhaustive_small_configs_pass(box):
    res = check(**box)
    assert res.ok, res.violation.message
    assert res.quiescent > 0 and res.states > 50


def test_protocol_finds_seeded_commit_requeue_race():
    res = check(max_states=200_000, n_workers=2, n_jobs=2, batch_k=1,
                bug="commit_skips_owner_cas")
    assert not res.ok
    assert "ownership" in res.violation.message
    ops = [t[0] for t in res.violation.trace]
    assert "requeue" in ops and "claim" in ops
    assert ops[-1].startswith("commit")
    assert len(res.violation.trace) <= 30


def test_protocol_finds_stuck_finished_gap():
    res = check(max_states=200_000, n_workers=2, n_jobs=2, batch_k=1,
                bug="requeue_ignores_finished")
    assert not res.ok
    assert "FINISHED" in res.violation.message
    assert any(t[0] == "die" for t in res.violation.trace)


@stores
def test_replay_confirms_real_store_blocks_seeded_race(tmp_path, kind):
    res = check(n_workers=2, n_jobs=2, batch_k=1,
                bug="commit_skips_owner_cas")
    rep = replay(kind, tmp_path, res.violation.trace, res.config)
    assert not rep["ok"]
    assert rep["label"][0].startswith("commit")
    assert "refuses" in rep["reason"]


def _quiescent_traces(model, limit):
    """The JAX test's walk: full traces to quiescence by DFS parents."""
    init = model.initial()
    visited = {init: []}
    frontier = [init]
    finals = []
    while frontier and len(finals) < limit:
        state = frontier.pop()
        trans = model.transitions(state)
        if all(label[0] == "die" for label, _ in trans):
            finals.append((visited[state], state))
            continue
        for label, new in trans:
            if new not in visited:
                visited[new] = visited[state] + [label]
                frontier.append(new)
    return finals


@stores
def test_replay_reproduces_correct_traces(tmp_path, kind):
    box = dict(n_workers=2, n_jobs=2, batch_k=2)
    finals = _quiescent_traces(proto.LeaseModel(proto.ModelConfig(**box)),
                               25)
    assert finals == _quiescent_traces(
        jproto.LeaseModel(jproto.ModelConfig(**box)), 25)
    for i, (trace, final) in enumerate(finals):
        rep = replay(kind, tmp_path / str(i), trace,
                     proto.ModelConfig(**box), final_state=final,
                     ns=f"ns{i}")
        assert rep["ok"], rep


@pytest.mark.parametrize("box", [
    dict(n_workers=1, n_jobs=2, batch_k=2, data_loss_budget=2),
    dict(n_workers=2, n_jobs=2, batch_k=1, data_loss_budget=1)],
    ids=["1w", "2w"])
def test_protocol_replica_recovery_edge_exhaustive(box):
    res = check(**box)
    assert res.ok, res.violation.message
    assert res.quiescent > 0


def test_protocol_finds_scavenger_that_never_requeues_lost_data():
    res = check(max_states=200_000, n_workers=1, n_jobs=2, batch_k=1,
                data_loss_budget=1, bug="scavenge_skips_lost_data")
    assert not res.ok
    assert "stranded" in res.violation.message
    assert any(t[0] == "lose_all" for t in res.violation.trace)


def test_protocol_finds_lost_requeue_without_written_cas():
    res = check(max_states=400_000, n_workers=2, n_jobs=2, batch_k=1,
                data_loss_budget=2, bug="lost_requeue_skips_written_cas")
    assert not res.ok
    assert "illegal status edge" in res.violation.message
    assert res.violation.trace[-1][0] == "rerun_requeue"


@stores
def test_replay_lost_data_requeue_on_real_stores(tmp_path, kind):
    cfg = proto.ModelConfig(n_workers=1, n_jobs=1, batch_k=1,
                            data_loss_budget=1, allow_death=False)
    model = proto.LeaseModel(cfg)
    init = model.initial()
    visited = {init: []}
    frontier = [init]
    picked = None
    while frontier:
        state = frontier.pop()
        trace = visited[state]
        ops = [t[0] for t in trace]
        if "rerun_requeue" in ops and "lose_all" in ops:
            if all(s == int(Status.WRITTEN) for s, *_ in state[0]):
                picked = (trace, state)
                break
        for label, new in model.transitions(state):
            if new not in visited:
                visited[new] = trace + [label]
                frontier.append(new)
    assert picked, "no loss→requeue→recommit trace reachable"
    rep = replay(kind, tmp_path, picked[0], cfg, final_state=picked[1])
    assert rep["ok"], rep


@pytest.mark.parametrize("box", [
    dict(n_workers=1, n_jobs=2, batch_k=2, data_loss_budget=2, coded=True),
    dict(n_workers=2, n_jobs=2, batch_k=1, data_loss_budget=2, coded=True)],
    ids=["1w", "2w"])
def test_protocol_coded_recovery_edge_exhaustive(box):
    res = check(**box)
    assert res.ok, res.violation.message
    assert res.quiescent > 0


def test_protocol_finds_decode_of_lost_stripe():
    res = check(max_states=200_000, n_workers=1, n_jobs=2, batch_k=1,
                data_loss_budget=1, coded=True,
                bug="coded_decode_lost_stripe")
    assert not res.ok
    assert "below-k" in res.violation.message
    assert res.violation.trace[-1][0] == "repair"


def test_protocol_finds_decode_blind_requeue():
    res = check(max_states=400_000, n_workers=2, n_jobs=2, batch_k=1,
                data_loss_budget=2, coded=True,
                bug="coded_requeue_skips_decode")
    assert not res.ok
    assert "illegal status edge" in res.violation.message
    assert res.violation.trace[-1][0] == "rerun_requeue"


@stores
def test_replay_decode_blind_requeue_diverges_on_real_stores(tmp_path, kind):
    res = check(max_states=400_000, n_workers=2, n_jobs=2, batch_k=1,
                data_loss_budget=2, coded=True,
                bug="coded_requeue_skips_decode")
    assert not res.ok
    rep = replay(kind, tmp_path, res.violation.trace, res.config)
    assert not rep["ok"], rep
    assert rep["label"][0] in ("rerun_requeue", "commit_a", "commit_b",
                               "claim")


@pytest.mark.parametrize("cfg", [
    dict(n_workers=9), dict(bug="nope"),
    dict(bug="coded_requeue_skips_decode", data_loss_budget=2),
    dict(coded=True)], ids=["oversize", "unknown-bug", "coded-bug-no-plane",
                            "inert-coded-plane"])
def test_model_rejects_oversize_and_unknown_bug(cfg):
    with pytest.raises(ValueError) as got:
        proto.ModelConfig(**cfg)
    with pytest.raises(ValueError) as want:
        jproto.ModelConfig(**cfg)
    assert str(got.value) == str(want.value)


# --- tests/test_sched.py ---------------------------------------------------

def test_protocol_notify_edges_hold_invariants():
    res = check(n_workers=2, n_jobs=2, allow_notify=True)
    assert res.ok, res.violation and res.violation.message
    base = check(n_workers=2, n_jobs=2)
    assert res.states > base.states


@stores
def test_protocol_lost_wakeup_race_refound_and_replayable(tmp_path, kind):
    bug = check(n_workers=2, n_jobs=2, allow_notify=True,
                bug="lost_wakeup_no_fallback")
    assert not bug.ok
    assert "asleep" in bug.violation.message
    rep = replay(kind, tmp_path, bug.violation.trace, bug.config,
                 final_state=bug.violation.state)
    assert rep["ok"], rep


def test_protocol_notify_bug_requires_notify_dimension():
    with pytest.raises(ValueError):
        proto.ModelConfig(bug="lost_wakeup_no_fallback")


# --- tests/test_speculation.py ---------------------------------------------

@stores
def test_seeded_spec_race_found_and_diverges(tmp_path, kind):
    bug = check(n_workers=2, n_jobs=2, batch_k=2, allow_spec=True,
                bug="spec_commit_skips_winner_cas")
    assert not bug.ok
    rep = replay(kind, tmp_path, bug.violation.trace, bug.config,
                 ns="seeded")
    assert not rep["ok"]
    assert rep["label"][0].startswith(("commit", "claim_spec",
                                       "spec_cancel"))


def test_spec_model_exhaustive_small_box():
    res = check(n_workers=2, n_jobs=1, batch_k=1, allow_spec=True)
    assert res.ok and res.quiescent > 0


# --- every seeded bug of the CLI's sweep, replayed -------------------------

def _seeded_box(bug):
    """The CLI's default box for a seeded bug (``_protocol_suite``)."""
    base = dict(n_workers=2, n_jobs=3, batch_k=2, bug=bug)
    if bug in proto.LOSS_BUGS:
        return {**base, "n_jobs": 2, "data_loss_budget": 2}
    if bug in proto.SPEC_BUGS:
        return {**base, "n_jobs": 2, "allow_spec": True}
    if bug in proto.NOTIFY_BUGS:
        return {**base, "n_jobs": 2, "allow_notify": True}
    if bug in proto.ELASTIC_BUGS:
        return {**base, "n_jobs": 2, "elastic": True}
    if bug in proto.HA_BUGS:
        return {**base, "n_jobs": 2, "ha": True}
    if bug in proto.CODED_BUGS:
        return {**base, "n_jobs": 2, "data_loss_budget": 2, "coded": True}
    return base


def test_bug_catalogues_equal():
    for name in ("KNOWN_BUGS", "LOSS_BUGS", "CODED_BUGS", "SPEC_BUGS",
                 "NOTIFY_BUGS", "ELASTIC_BUGS", "HA_BUGS"):
        assert getattr(proto, name) == getattr(jproto, name), name


@pytest.mark.parametrize("bug", proto.KNOWN_BUGS)
@stores
def test_seeded_bug_trace_replays_alike(tmp_path, kind, bug):
    """The JAX-found trace of each seeded bug: the port re-finds the same
    trace, and its replay on the port's store gives the JAX store's
    verdict at the same step."""
    res = check(**_seeded_box(bug))
    assert not res.ok
    replay(kind, tmp_path, res.violation.trace, res.config)


# --- the CLI's whole default suite (heavy) ---------------------------------

# python -m lua_mapreduce_tpu.analysis protocol --format json on the CPU:
# states (and transitions) of each run, states to each seeded bug
SUITE_COUNTS = {
    "lifecycle+death": (425_708, 1_583_986),
    "failure-path": (47_673, 150_626),
    "replica-recovery": (299_442, 1_336_164),
    "speculation": (376_724, 1_563_636),
    "notify-wakeup": (75_432, 324_150),
    "coded-recovery": (299_442, 1_346_880),
    "elastic-pool": (13_873, 45_618),
    "leader-lease": (340_952, 2_386_800),
    "seeded:commit_skips_owner_cas": (666, None),
    "seeded:requeue_ignores_finished": (3_936, None),
    "seeded:scavenge_skips_lost_data": (459, None),
    "seeded:lost_requeue_skips_written_cas": (1_730, None),
    "seeded:spec_commit_skips_winner_cas": (1_699, None),
    "seeded:lost_wakeup_no_fallback": (236, None),
    "seeded:coded_decode_lost_stripe": (152, None),
    "seeded:coded_requeue_skips_decode": (2_019, None),
    "seeded:elastic_retire_holds_lease": (8, None),
    "seeded:zombie_leader_write": (165, None),
    "seeded:double_leader": (26, None),
}


def _suite(package):
    r = subprocess.run(
        [sys.executable, "-m", f"{package}.analysis", "protocol",
         "--format", "json"], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    runs = json.loads(r.stdout)["protocol"]
    for run in runs:
        run.pop("wall_s")
    return runs


@pytest.mark.heavy
def test_default_protocol_suite_counts_equal():
    got = _suite("lua_mapreduce_tpu_torch")
    assert got == _suite("lua_mapreduce_tpu")
    assert {r["run"]: (r["states"], r.get("transitions")) for r in got} \
        == SUITE_COUNTS
    assert all(r.get("ok", r.get("found")) for r in got)
