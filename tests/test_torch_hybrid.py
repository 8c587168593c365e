"""The port's hybrid stage-granular engine (``lua_mapreduce_tpu_torch/
engine/hybrid.py``) and its two structural proofs on the CPU:
counterparts of the LocalExecutor and fold tests of
``tests/test_hybrid.py``, with the fixture sources rewritten against
torch, plus a table of reducers for ``_sum_fold`` (torch.fx graphs in
place of jaxprs).

The port is held to the store plane's bytes, not to the JAX package's
tier choices: on jax 0.9.0 the JAX proofs never hold (ROADMAP C1: their
catch-all turns a missing ``jax.core.Literal`` into "not provable"), so
the JAX fold never folds; the port's does, and
``test_fold_accepts_accumulator_loop_and_restores_bytes`` passes here.
The server-, CLI- and span-backed tests of ``tests/test_hybrid.py`` wait
for the port's Server/Worker/CLI and tracer.
"""

import pytest
import torch

from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
from lua_mapreduce_tpu_torch.engine import ingraph
from lua_mapreduce_tpu_torch.engine.hybrid import HybridReduceFold
from lua_mapreduce_tpu_torch.engine.ingraph import (_singleton_passthrough,
                                                    _sum_fold)
from lua_mapreduce_tpu_torch.faults.retry import COUNTERS

from tests.test_torch_ingraph import _result_bytes, igmod  # noqa: F401

# ---------------------------------------------------------------------------
# fixture task sources
# ---------------------------------------------------------------------------

# every data-plane function in-graph: integer values, uniform two-key
# emission (the collective tier's shape), explicit-accumulator sum
# reducer (the provable fold shape) — forced hybrid must be
# byte-identical
HY_FULL = """
import torch

def taskfn(emit):
    for j in range(6):
        emit(j, {"v": [(j * 7 + i) % 23 for i in range(8)]})

def mapfn(key, value, emit):
    v = torch.as_tensor(value["v"], dtype=torch.int32)
    emit(0, torch.sum(v))
    emit(1, v[0] * 2)

def partitionfn(key):
    return int(key) % 2

def reducefn(key, values):
    acc = values[0]
    for i in range(1, len(values)):
        acc = acc + values[i]
    return acc

reducefn.associative_reducer = True
reducefn.commutative_reducer = True

combinerfn = reducefn
"""

# the hybrid-rung shape: numeric map+reduce, but partitionfn routes
# through hashlib (an "indirect call" — store-plane verdict), so the
# WHOLE task can never lower and engine=auto must take the stage rung
HY_PARTIAL = """
import hashlib
import torch

def taskfn(emit):
    for j in range(6):
        emit(j, {"v": [(j * 5 + i) % 17 for i in range(8)]})

def mapfn(key, value, emit):
    v = torch.as_tensor(value["v"], dtype=torch.int32)
    emit(0, torch.sum(v))
    emit(1, v[0] + 10)

def partitionfn(key):
    h = hashlib.blake2b(str(key).encode(), digest_size=2).hexdigest()
    return int(h, 16) % 2

def reducefn(key, values):
    acc = values[0]
    for i in range(1, len(values)):
        acc = acc + values[i]
    return acc

reducefn.associative_reducer = True
reducefn.commutative_reducer = True
"""

# fully host-bound: every stage store-plane — forced hybrid has ZERO
# qualifying legs and must still run (pure store) with evidence
HY_HOSTBOUND = """
def taskfn(emit):
    for j in range(4):
        emit(j, {"v": [j + i for i in range(4)]})

def mapfn(key, value, emit):
    emit(0, sorted(value["v"])[0])
    emit(1, sorted(value["v"])[-1])

def partitionfn(key):
    return int(key) % 2

def reducefn(key, values):
    return sorted(values)[0]
"""

# oracle-accepted map leg whose lowering fails at build time: the
# emitted KEY is a tensor (the same refusal as the whole-task plane) —
# forced hybrid must degrade the leg, never crash
HY_TRACE_FAIL = """
import torch

def taskfn(emit):
    for j in range(4):
        emit(j, {"v": [float(j + 1), 2.0]})

def mapfn(key, value, emit):
    v = torch.as_tensor(value["v"], dtype=torch.float32)
    emit(torch.sum(v), v[0])

def partitionfn(key):
    return int(key) % 2

def reducefn(key, values):
    acc = values[0]
    for i in range(1, len(values)):
        acc = acc + values[i]
    return acc
"""


def _local(mod, engine, tag, **kw):
    spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod, reducefn=mod,
                    combinerfn=mod if kw.pop("combiner", False) else None,
                    storage=f"mem:thy-{tag}")
    ex = LocalExecutor(spec, engine=engine, device="cpu", **kw)
    ex.run()
    return ex


# ---------------------------------------------------------------------------
# golden diffs + ladder, LocalExecutor
# ---------------------------------------------------------------------------

def test_forced_hybrid_both_legs_byte_identical(igmod):  # noqa: F811
    mod = igmod("thy_full", HY_FULL)
    ex_s = _local(mod, "store", "full-s", combiner=True)
    ex_h = _local(mod, "hybrid", "full-h", combiner=True)
    assert ex_h.engine_decision.chosen == "hybrid"
    assert ex_h.engine_decision.stages == {"map": True, "reduce": True}
    out = _result_bytes(ex_h.result_store)
    assert out and out == _result_bytes(ex_s.result_store)
    it = ex_h.stats.iterations[-1]
    assert it.hybrid_map_legs == 1
    assert it.hybrid_reduce_legs >= 1
    assert it.hybrid_fallbacks == 0
    # uniform numeric-keyed jobs ride the batched collective tier, once
    assert ex_h._hybrid.map_engine.mode == "shard_map"
    assert ex_h._hybrid.map_engine.traces == 1
    assert ex_h._hybrid.fold.folded_groups >= 1
    # the store twin never touched the hybrid plane
    it_s = ex_s.stats.iterations[-1]
    assert it_s.hybrid_map_legs == 0 and it_s.hybrid_reduce_legs == 0


def test_auto_ladder_ingraph_still_wins(igmod):  # noqa: F811
    """A fully in-graph task under auto keeps the WHOLE-task plane —
    the hybrid rung only catches tasks the top rung rejects."""
    mod = igmod("thy_full_auto", HY_FULL)
    ex = _local(mod, "auto", "full-auto", combiner=True)
    assert ex.engine_decision.chosen == "ingraph"
    assert ex.stats.iterations[-1].hybrid_map_legs == 0


def test_auto_partial_task_takes_hybrid_rung(igmod):  # noqa: F811
    mod = igmod("thy_partial", HY_PARTIAL)
    ex_s = _local(mod, "store", "part-s")
    ex_h = _local(mod, "auto", "part-h")
    dec = ex_h.engine_decision
    assert dec.verdict == "store-plane"
    assert dec.chosen == "hybrid"
    assert dec.stages == {"map": True, "reduce": True}
    assert "partitionfn" in dec.reason
    assert _result_bytes(ex_h.result_store) == \
        _result_bytes(ex_s.result_store)
    it = ex_h.stats.iterations[-1]
    assert it.hybrid_map_legs == 1 and it.hybrid_fallbacks == 0
    # where the JAX fold never folds on jax 0.9.0 (ROADMAP C1), the
    # port's proves the accumulator loop and folds
    assert it.hybrid_reduce_legs >= 1


def test_auto_hostbound_task_stays_store(igmod):  # noqa: F811
    mod = igmod("thy_hostbound_auto", HY_HOSTBOUND)
    ex = _local(mod, "auto", "host-auto")
    assert ex.engine_decision.chosen == "store"
    assert ex.engine_decision.stages is None
    it = ex.stats.iterations[-1]
    assert it.hybrid_map_legs == 0 and it.hybrid_fallbacks == 0
    assert len(_result_bytes(ex.result_store)) > 0


def test_forced_hybrid_zero_legs_never_crashes(igmod):  # noqa: F811
    """engine=hybrid on a fully host-bound task: pure store-plane run,
    normal output, and the once-per-task degrade evidence (counter)."""
    mod = igmod("thy_hostbound_forced", HY_HOSTBOUND)
    ex_s = _local(mod, "store", "host-s")
    ex_h = _local(mod, "hybrid", "host-h")
    assert ex_h.engine_decision.chosen == "hybrid"
    assert ex_h.engine_decision.stages == {"map": False, "reduce": False}
    assert _result_bytes(ex_h.result_store) == \
        _result_bytes(ex_s.result_store)
    it = ex_h.stats.iterations[-1]
    assert it.hybrid_fallbacks == 1
    assert it.hybrid_map_legs == 0 and it.hybrid_reduce_legs == 0


def test_trace_failure_degrades_map_leg(igmod):  # noqa: F811
    mod = igmod("thy_trace_fail", HY_TRACE_FAIL)
    ex_s = _local(mod, "store", "tf-s")
    ex_h = _local(mod, "hybrid", "tf-h")
    assert ex_h.engine_decision.chosen == "hybrid"
    # the map leg died at build time: retired, counted, replayed
    # interpreted — bytes still equal
    assert ex_h._hybrid.map_engine is None
    it = ex_h.stats.iterations[-1]
    assert it.hybrid_fallbacks >= 1 and it.hybrid_map_legs == 0
    assert _result_bytes(ex_h.result_store) == \
        _result_bytes(ex_s.result_store)


# ---------------------------------------------------------------------------
# reduce fold proof gating (unit)
# ---------------------------------------------------------------------------

def _fold_spec(reducefn):
    # the fold's first witness is the declared algebra; these unit
    # tests exercise the second (the structural fx-graph proof)
    reducefn.associative_reducer = True
    reducefn.commutative_reducer = True
    return TaskSpec(taskfn={"taskfn": lambda e: e(0, 1)},
                    mapfn={"mapfn": lambda k, v, e: e(0, v)},
                    partitionfn={"partitionfn": lambda k: 0},
                    reducefn={"reducefn": reducefn},
                    storage="mem:thy-foldunit")


def _acc_loop(k, vs):
    acc = vs[0]
    for i in range(1, len(vs)):
        acc = acc + vs[i]
    return acc


def test_fold_rejects_literal_seeded_sum():
    """python sum(values) folds from the LITERAL 0 — an fx graph the sum
    proof must refuse (an add with a literal operand), so the group
    interprets; the fold stays live for provable groups."""
    fold = HybridReduceFold(_fold_spec(lambda k, vs: sum(vs)), device="cpu")
    assert fold(0, [1, 2, 3]) is None
    assert not fold.retired
    assert fold.folded_groups == 0 and not fold.take_used()


def test_fold_accepts_accumulator_loop_and_restores_bytes():
    fold = HybridReduceFold(_fold_spec(_acc_loop), device="cpu")
    assert fold(0, [3, 4, 5]) == 12
    assert fold.folded_groups == 1
    assert fold.take_used() and not fold.take_used()
    # singletons never fold (run_reduce_job's fast path owns them)
    assert fold(0, [7]) is None
    # non-numeric groups interpret without retiring the fold
    assert fold(1, ["a", "b"]) is None and not fold.retired
    # dict values: the singleton pass restores the user's structure
    fold2 = HybridReduceFold(_fold_spec(
        lambda k, vs: {"s": _acc_loop(k, [v["s"] for v in vs])}),
        device="cpu")
    assert fold2(0, [{"s": [1.5, 2.0]}, {"s": [0.5, 1.0]}]) == \
        {"s": [2.0, 3.0]}


def test_fold_retires_on_proof_cache_blowup():
    fold = HybridReduceFold(_fold_spec(_acc_loop), device="cpu")
    fold.MAX_PROBES = 4
    for key in range(6):
        fold(key, [key, key + 1])
    assert fold.retired
    assert "signatures" in fold.retire_reason
    # retired: every later group interprets, silently and safely
    assert fold(99, [1, 2]) is None


def _seeded(k, vs):
    return sum(vs)


def _bias(k, vs):
    return _acc_loop(k, vs) + 1


def _scaled(k, vs):
    acc = 2 * vs[0]
    for i in range(1, len(vs)):
        acc = acc + 2 * vs[i]
    return acc


def _dropped(k, vs):
    acc = vs[0]
    for i in range(1, len(vs) - 1):
        acc = acc + vs[i]
    return acc


def _repeated(k, vs):
    acc = vs[0] + vs[0]
    for i in range(1, len(vs)):
        acc = acc + vs[i]
    return acc


def _restructured(k, vs):
    return {"s": _acc_loop(k, vs)}


def _widened(k, vs):
    acc = vs[0].to(torch.float64)
    for i in range(1, len(vs)):
        acc = acc + vs[i].to(torch.float64)
    return acc.to(torch.float32)


def _branchy(k, vs):
    acc = _acc_loop(k, vs)
    if acc.sum() > 0:          # a data-dependent Python branch
        acc = acc + vs[0]
    return acc


@pytest.mark.parametrize("reducer,proven", [
    (_acc_loop, True),          # the accumulator loop
    (_widened, True),           # summed in f64, converted back to f32
    (_seeded, False),           # sum() seeded with the literal 0
    (_bias, False),             # + a literal bias
    (_scaled, False),           # 2 * v: a weighted fold
    (_dropped, False),          # the last value dropped
    (_repeated, False),         # the first value counted twice
    (_restructured, False),     # a changed output structure
    (_branchy, False),          # the tracer refuses a data-dependent branch
], ids=lambda p: p.__name__.strip("_") if callable(p) else str(p))
def test_sum_proof_table(reducer, proven):
    spec = _fold_spec(reducer)
    template = torch.zeros(3, dtype=torch.float32)
    assert _sum_fold(spec, 0, template, 4) is proven
    if proven:
        # the proven fold threads a sum through one singleton call
        assert _singleton_passthrough(spec, 0, template)


def test_proof_errors_propagate_instead_of_not_provable(monkeypatch):
    """Only the tracer's own refusal of a reducefn means "not provable".
    An error inside the proof — here the C1 shape, an attribute the
    proof reads that does not exist — propagates out of ``_sum_fold``,
    and the hybrid fold retires with the error as its counted reason
    (where the JAX package's catch-all returned "not provable" and
    silently never folded)."""
    def missing(node):
        raise AttributeError("module 'torch' has no attribute 'Literal'")

    monkeypatch.setattr(ingraph, "_is_dtype_convert", missing)
    spec = _fold_spec(_widened)
    with pytest.raises(AttributeError, match="Literal"):
        _sum_fold(spec, 0, torch.zeros(3), 3)
    before = COUNTERS.snapshot()
    fold = HybridReduceFold(spec, device="cpu")
    assert fold(0, [[1.0], [2.0]]) is None
    assert fold.retired and "AttributeError" in fold.retire_reason
    assert COUNTERS.delta(before, COUNTERS.snapshot())[
        "hybrid_fallbacks"] == 1
    # an error of the reducefn itself propagates the same way
    def broken(k, vs):
        raise ValueError("reducer bug")

    with pytest.raises(ValueError, match="reducer bug"):
        _sum_fold(_fold_spec(broken), 0, torch.zeros(3), 2)


def test_resolve_engine_accepts_hybrid(monkeypatch):
    from lua_mapreduce_tpu_torch.engine.ingraph import resolve_engine
    assert resolve_engine("hybrid") == "hybrid"
    monkeypatch.setenv("LMR_ENGINE", "hybrid")
    assert resolve_engine(None) == "hybrid"
    with pytest.raises(ValueError):
        resolve_engine("stagewise")
