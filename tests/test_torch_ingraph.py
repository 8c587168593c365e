"""The port's in-graph engine (``lua_mapreduce_tpu_torch/engine/
ingraph.py``) on the CPU: counterparts of the LocalExecutor tests of
``tests/test_ingraph.py``, with the fixture task sources rewritten
against torch.

Besides port in-graph ≡ port store plane, the port's in-graph results
are held against the JAX package's ``LocalExecutor(engine="store")`` on
the reference's own fixtures and examples from the same seeds (the same
data gives the same answers across packages): ints byte-identical,
floats rtol/atol 1e-4 (digits parameters atol 1e-5), the tolerances of
``tests/test_ingraph.py``. On the CPU the program's body runs eagerly
every iteration (a card captures it once); the build counter ``traces``
means the same on both. The server-, CLI- and span-backed tests of
``tests/test_ingraph.py`` wait for the port's Server/Worker/CLI and
tracer.
"""

import re
import sys

import numpy as np
import pytest

import torch_parallel_ranks as ranks
from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxTaskSpec
from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxExecutor
from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
from lua_mapreduce_tpu_torch.engine.ingraph import (LoweringError,
                                                    resolve_engine,
                                                    select_engine)
from lua_mapreduce_tpu_torch.parallel import spawn
from tests.test_ingraph import IG_SORT as JAX_IG_SORT
from tests.test_ingraph import IG_SUM as JAX_IG_SUM

# ---------------------------------------------------------------------------
# fixture task modules (materialized on sys.path so the STATIC oracle can
# resolve them — the engine selection never imports, it parses)
# ---------------------------------------------------------------------------

# the wordcount sum-reducer shape with integer keys/values: mapfn buckets
# this shard's token ids, examples.wordcount.reducefn sums the counts —
# integer folds must be BYTE-identical across the planes
IG_SUM = """
import torch

def taskfn(emit):
    for j in range(6):
        emit(j, {"ids": [(j * 13 + i * 7) % 8 for i in range(32)]})

def mapfn(key, value, emit):
    ids = torch.as_tensor(value["ids"], dtype=torch.int32)
    for b in range(8):
        emit(b, torch.sum(torch.where(ids == b, 1, 0)))

def partitionfn(key):
    return int(key) % 3
"""

# the extsort shape: unique integer keys, range partitionfn monotone in
# the key, identity reducefn flagged ACI — every group is a singleton,
# exercising the merge fast path on both planes
IG_SORT = """
import torch

def taskfn(emit):
    for j in range(4):
        emit(j, {"vals": [(j * 16 + i) * 7 % 101 for i in range(16)]})

def mapfn(key, value, emit):
    v = torch.as_tensor(value["vals"], dtype=torch.int32)
    for i in range(16):
        emit(int(key) * 16 + i, {"v": v[i] * 2})

def partitionfn(key):
    return (int(key) * 4) // 64

def reducefn(key, values):
    return values[0]

reducefn.associative_reducer = True
reducefn.commutative_reducer = True
reducefn.idempotent_reducer = True
"""

# oracle/runtime disagreement: every call is inside the oracle's
# whitelisted surface (verdict: in-graph), but the emitted KEY is a
# tensor — the lowering refuses data-dependent key spaces at build
# time, so engine=auto must degrade to the store plane (where a tensor
# key serializes as its value) and engine=ingraph must raise
IG_TRACED_KEY = """
import torch

def taskfn(emit):
    for j in range(4):
        emit(j, {"v": [float(j + 1), 2.0]})

def mapfn(key, value, emit):
    v = torch.as_tensor(value["v"], dtype=torch.float32)
    emit(torch.sum(v), {"s": v[0]})

def partitionfn(key):
    return int(key) % 2

def reducefn(key, values):
    s = torch.as_tensor(values[0]["s"])
    for i in range(1, len(values)):
        s = s + torch.as_tensor(values[i]["s"])
    return {"s": s}
"""

IG_COMBINER = """
import torch

def taskfn(emit):
    for j in range(4):
        emit(j, {"v": [float(j + 1), 2.0]})

def mapfn(key, value, emit):
    v = torch.as_tensor(value["v"], dtype=torch.float32)
    emit(0, {"s": torch.sum(v)})
    emit(0, {"s": v[0] * 2.0})

def partitionfn(key):
    return int(key) % 2

def reducefn(key, values):
    s = torch.as_tensor(values[0]["s"])
    for i in range(1, len(values)):
        s = s + torch.as_tensor(values[i]["s"])
    return {"s": s}

combinerfn = reducefn
reducefn.associative_reducer = True
reducefn.commutative_reducer = True
"""

IG_KEY_LOOP = """
import torch

STEP = [0]

def taskfn(emit):
    for i in range(8):
        emit(STEP[0] * 8 + i, {"v": [float(i + 1), 2.0]})

def mapfn(key, value, emit):
    v = torch.as_tensor(value["v"], dtype=torch.float32)
    emit(0, {"s": torch.sum(v) + 0.0 * key})

def partitionfn(key):
    return 0

def reducefn(key, values):
    s = torch.as_tensor(values[0]["s"])
    for i in range(1, len(values)):
        s = s + torch.as_tensor(values[i]["s"])
    return {"s": s}

reducefn.associative_reducer = True
reducefn.commutative_reducer = True

def finalfn(pairs):
    STEP[0] += 1
    return False if STEP[0] >= 3 else "loop"
"""

SGD = "lua_mapreduce_tpu_torch.examples.digits.mr_sgd"
KMEANS = "lua_mapreduce_tpu_torch.examples.kmeans.mr_kmeans"
ALS = "lua_mapreduce_tpu_torch.examples.als.mr_als"


@pytest.fixture(scope="module")
def igmod(tmp_path_factory):
    """Materialize fixture task sources as importable modules on
    sys.path (the oracle resolves module NAMES statically; tmp modules
    must be visible to both importlib and resolve_spec)."""
    root = tmp_path_factory.mktemp("torch_igtasks")
    sys.path.insert(0, str(root))
    made = []

    def factory(name: str, src: str) -> str:
        (root / f"{name}.py").write_text(src)
        made.append(name)
        return name

    yield factory
    sys.path.remove(str(root))
    for name in made:
        sys.modules.pop(name, None)


def _result_bytes(store, result_ns="result"):
    pat = re.compile(rf"^{re.escape(result_ns)}\.P(\d+)$")
    return {n: "".join(store.lines(n))
            for n in store.list(f"{result_ns}.P*") if pat.match(n)}


def _local(mod, engine, tag, *, reducefn=None, **kw):
    spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod,
                    reducefn=reducefn or mod, storage=f"mem:tig-{tag}")
    ex = LocalExecutor(spec, engine=engine, device="cpu", **kw)
    ex.run()
    return ex


def _jax_store_bytes(mod, tag, *, reducefn=None):
    """The JAX package's store plane on a fixture module: the golden
    bytes across packages."""
    spec = JaxTaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod,
                       reducefn=reducefn or mod, storage=f"mem:jig-{tag}")
    ex = JaxExecutor(spec, engine="store")
    ex.run()
    return _result_bytes(ex.result_store)


def _example(mod, engine, args, tag, max_iterations=10):
    spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod, reducefn=mod,
                    finalfn=mod, init_args={**args, "device": "cpu"},
                    storage=f"mem:tig-{tag}")
    ex = LocalExecutor(spec, engine=engine, max_iterations=max_iterations)
    ex.run()
    return ex


def _jax_example(mod, args, tag, max_iterations=10):
    spec = JaxTaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod,
                       reducefn=mod, finalfn=mod, init_args=args,
                       storage=f"mem:jig-{tag}")
    JaxExecutor(spec, engine="store", max_iterations=max_iterations).run()


# ---------------------------------------------------------------------------
# golden diffs: integer byte-identity
# ---------------------------------------------------------------------------

def test_int_sum_reducer_byte_identical(igmod):
    mod = igmod("tig_sum_a", IG_SUM)
    ex_s = _local(mod, "store", "sum-s",
                  reducefn="examples.wordcount.reducefn")
    ex_i = _local(mod, "ingraph", "sum-i",
                  reducefn="examples.wordcount.reducefn")
    assert ex_i.engine_decision.verdict == "in-graph"
    assert ex_i.engine_decision.chosen == "ingraph"
    got = _result_bytes(ex_i.result_store)
    assert got == _result_bytes(ex_s.result_store)
    # the same bytes as the JAX package's store plane on its fixture
    jmod = igmod("jig_sum_a", JAX_IG_SUM)
    assert got == _jax_store_bytes(jmod, "sum",
                                   reducefn="examples.wordcount.reducefn")
    assert ex_i._ingraph.engine.traces == 1
    assert ex_i.stats.iterations[-1].ingraph_iterations == 1
    assert ex_i.stats.iterations[-1].ingraph_fallbacks == 0
    # the store leg ran zero compiled iterations
    assert ex_s.stats.iterations[-1].ingraph_iterations == 0


def test_int_sum_auto_selects_ingraph(igmod):
    mod = igmod("tig_sum_b", IG_SUM)
    ex_a = _local(mod, "auto", "sum-auto",
                  reducefn="examples.wordcount.reducefn")
    assert ex_a.engine_decision.requested == "auto"
    assert ex_a.engine_decision.chosen == "ingraph"
    assert ex_a.stats.iterations[-1].ingraph_iterations == 1


def test_int_sort_singleton_fastpath_byte_identical(igmod):
    mod = igmod("tig_sort", IG_SORT)
    ex_s = _local(mod, "store", "sort-s")
    ex_i = _local(mod, "ingraph", "sort-i")
    out_s, out_i = (_result_bytes(ex_s.result_store),
                    _result_bytes(ex_i.result_store))
    assert out_i == out_s
    # range partition: 4 partitions, 16 unique singleton keys each
    assert len(out_i) == 4
    assert sum(o.count("\n") for o in out_i.values()) == 64
    # job-dependent emitted keys: the unrolled tier carries it
    assert ex_i._ingraph.engine.mode == "jit"
    assert out_i == _jax_store_bytes(igmod("jig_sort", JAX_IG_SORT), "sort")


# ---------------------------------------------------------------------------
# golden diffs: float allclose (kmeans / ALS / digits), loop no-rebuild
# ---------------------------------------------------------------------------

def _kmeans_states(engine, tag, **args):
    from examples.kmeans import mr_kmeans as jax_km
    from lua_mapreduce_tpu_torch.examples.kmeans import mr_kmeans
    init_args = {"k": 8, "n": 512, "dim": 8, "n_shards": 4,
                 "max_iters": 4, "tol": 0.0, "seed": 11, "coord": "mem",
                 **args}
    ex = _example(KMEANS, engine, init_args, f"km-{tag}")
    return ex, mr_kmeans.read_state("mem"), init_args, jax_km


def test_kmeans_allclose_and_compile_once():
    ex_s, st_s, _, _ = _kmeans_states("store", "s")
    ex_i, st_i, args, jax_km = _kmeans_states("ingraph", "i")
    assert st_i["iter"] == st_s["iter"] == 4
    np.testing.assert_allclose(st_i["centroids"], st_s["centroids"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st_i["sse"], st_s["sse"], rtol=1e-4)
    # the "loop" protocol re-runs the SAME program with fresh centroids:
    # one build across all 4 iterations
    assert ex_i._ingraph.engine.traces == 1
    assert sum(it.ingraph_iterations for it in ex_i.stats.iterations) == 4
    # the JAX package's example from the same seed
    _jax_example("examples.kmeans.mr_kmeans", args, "km")
    st_j = jax_km.read_state("mem")
    assert st_j["iter"] == 4
    np.testing.assert_allclose(st_i["centroids"], st_j["centroids"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st_i["sse"], st_j["sse"], rtol=1e-4)


def test_als_allclose():
    from examples.als import mr_als as jax_als
    from lua_mapreduce_tpu_torch.examples.als import mr_als
    args = {"n_users": 64, "n_items": 16, "rank": 4, "density": 0.4,
            "reg": 0.1, "n_shards": 4, "max_iters": 3, "seed": 9,
            "coord": "mem"}
    _example(ALS, "store", args, "als-s", max_iterations=5)
    st_s = mr_als.read_state("mem")
    ex_i = _example(ALS, "ingraph", args, "als-i", max_iterations=5)
    st_i = mr_als.read_state("mem")
    np.testing.assert_allclose(st_i["item_factors"], st_s["item_factors"],
                               rtol=1e-4, atol=1e-4)
    assert ex_i._ingraph.engine.traces == 1
    _jax_example("examples.als.mr_als", args, "als", max_iterations=5)
    np.testing.assert_allclose(st_i["item_factors"],
                               jax_als.read_state("mem")["item_factors"],
                               rtol=1e-4, atol=1e-4)


def _sgd_run(engine, tag, **args):
    from lua_mapreduce_tpu_torch.examples.digits import mr_sgd
    ex = _example(SGD, engine, {"max_steps": 5, "seed": 2, **args},
                  f"sgd-{tag}")
    st = mr_sgd.read_state()
    return ex, ({k: v.copy() for k, v in st["params"].items()},
                st["val_loss"])


def test_digits_sgd_allclose_collective_tier():
    from examples.digits import mr_sgd as jax_sgd
    ex_s, (p_s, val_s) = _sgd_run("store", "s")
    ex_i, (p_i, val_i) = _sgd_run("ingraph", "i")
    # numeric keys + uniform per-job emission: the COLLECTIVE tier
    # carries this workload, its gradient sums on the psum path
    assert ex_i._ingraph.engine.mode == "shard_map"
    assert set(ex_i._ingraph.engine._plan.folds.values()) == {"psum"}
    assert ex_i._ingraph.engine.traces == 1
    for k in p_s:
        np.testing.assert_allclose(p_i[k], p_s[k], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(val_i, val_s, rtol=1e-4)
    _jax_example("examples.digits.mr_sgd", {"max_steps": 5, "seed": 2},
                 "sgd")
    st_j = jax_sgd.read_state()
    for k in p_i:
        np.testing.assert_allclose(p_i[k], st_j["params"][k], rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(val_i, st_j["val_loss"], rtol=1e-4)


def test_digits_sgd_collective_tier_over_two_ranks():
    """mr_sgd on the collective tier in a gloo world of 2 ranks: jobs
    dealt 2 a rank, the gradient sums all-reduced. Every rank publishes
    the same bytes and ends with the same parameters, equal to the
    one-rank run within 1e-5."""
    args = {"max_steps": 4, "seed": 3}
    out = spawn(ranks.ingraph_sgd, 2, args, device="cpu", timeout_s=240)
    _, (p_1, val_1) = _sgd_run("ingraph", "dp1", **args)
    assert [o["ranks"] for o in out] == [2, 2]
    for o in out:
        assert o["mode"] == "shard_map" and o["traces"] == 1
        assert set(o["folds"]) == {"psum"}
        for k in p_1:
            np.testing.assert_allclose(o["params"][k], p_1[k], rtol=0,
                                       atol=1e-5)
        np.testing.assert_allclose(o["val_loss"], val_1, rtol=1e-5)
    assert out[0]["bytes"] and out[0]["bytes"] == out[1]["bytes"]
    for k in p_1:
        np.testing.assert_array_equal(out[0]["params"][k],
                                      out[1]["params"][k])


# five jobs over two ranks: rank 1 holds two jobs and a padding slot
# (job 0 replayed), which no fold may see
DP_TASKS = {
    # sum(values) seeds with the literal 0: no psum proof, the
    # all-gather tier with the user's fold in job-major order
    "gather": """
import torch

def taskfn(emit):
    for j in range(5):
        emit(j, {"ids": [(j * 13 + i * 7) % 8 for i in range(32)]})

def mapfn(key, value, emit):
    ids = torch.as_tensor(value["ids"], dtype=torch.int32)
    for b in range(8):
        emit(b, {"n": torch.sum(torch.where(ids == b, 1, 0)),
                 "hit": ids[0] == b})
    emit(8, {"n": torch.sum(ids), "hit": ids[1] == 3})

def partitionfn(key):
    return int(key) % 3

def reducefn(key, values):
    return {"n": sum(v["n"] for v in values),
            "hit": [v["hit"] for v in values]}
""",
    # the accumulator loop: proven, a local sum + one all-reduce
    "psum": """
import torch

def taskfn(emit):
    for j in range(5):
        emit(j, {"v": [(j * 7 + i) % 23 for i in range(8)]})

def mapfn(key, value, emit):
    v = torch.as_tensor(value["v"], dtype=torch.int32)
    emit(0, torch.sum(v))
    emit(1, {"a": v[0] * 2, "b": v[1:3] + 1})

def partitionfn(key):
    return int(key) % 2

def reducefn(key, values):
    if key == 0:
        acc = torch.as_tensor(values[0])
        for i in range(1, len(values)):
            acc = acc + torch.as_tensor(values[i])
        return acc
    a = torch.as_tensor(values[0]["a"])
    b = torch.as_tensor(values[0]["b"])
    for i in range(1, len(values)):
        a = a + torch.as_tensor(values[i]["a"])
        b = b + torch.as_tensor(values[i]["b"])
    return {"a": a, "b": b}

reducefn.associative_reducer = True
reducefn.commutative_reducer = True
""",
}


def test_compiled_tiers_over_two_ranks(tmp_path):
    """The collective tier in a gloo world of 2 ranks with a padding
    slot: the all-gather fold (bool and int leaves, job-major order),
    the psum fold (one all-reduce per dtype), and the hybrid map leg
    (its rows all-gathered) — every rank publishes the bytes of the
    store plane."""
    for name, src in DP_TASKS.items():
        (tmp_path / f"tdp_{name}.py").write_text(src)
    cases = {"gather": ("tdp_gather", "ingraph"),
             "psum": ("tdp_psum", "ingraph"),
             "hybrid": ("tdp_psum", "hybrid")}
    out = spawn(ranks.compiled_tasks, 2, str(tmp_path), cases,
                device="cpu", timeout_s=240)
    sys.path.insert(0, str(tmp_path))
    try:
        want = {mod: _result_bytes(_local(mod, "store", f"dp-{mod}")
                                   .result_store)
                for mod, _ in cases.values()}
    finally:
        sys.path.remove(str(tmp_path))
        for name in DP_TASKS:
            sys.modules.pop(f"tdp_{name}", None)
    for rank in out:
        for name, (mod, engine) in cases.items():
            got = rank[name]
            assert got["ranks"] == 2 and got["mode"] == "shard_map", name
            assert got["bytes"] and got["bytes"] == want[mod], name
        assert rank["gather"]["folds"] == ["all_gather"]
        assert rank["psum"]["folds"] == ["psum"]
        assert rank["hybrid"]["stats"]["hybrid_map_legs"] == 1
        assert rank["hybrid"]["stats"]["hybrid_fallbacks"] == 0
    assert out[0]["gather"]["bytes"] == out[1]["gather"]["bytes"]


# ---------------------------------------------------------------------------
# oracle/runtime agreement: a lowering failure degrades (auto) / raises
# (forced)
# ---------------------------------------------------------------------------

def test_auto_fallback_on_trace_failure_byte_identical(igmod):
    mod = igmod("tig_traced_key", IG_TRACED_KEY)
    ex_s = _local(mod, "store", "fb-s")
    ex_a = _local(mod, "auto", "fb-a")
    # the static oracle accepted it...
    assert ex_a.engine_decision.verdict == "in-graph"
    assert ex_a.engine_decision.chosen == "ingraph"
    # ...the lowering refused it at build time, and the iteration re-ran
    # on the store plane: counted, engine retired, bytes equal
    it = ex_a.stats.iterations[-1]
    assert it.ingraph_fallbacks == 1
    assert it.ingraph_iterations == 0
    assert ex_a._ingraph.engine is None
    assert _result_bytes(ex_a.result_store) == \
        _result_bytes(ex_s.result_store)


def test_hard_mode_raises_instead_of_falling_back(igmod):
    mod = igmod("tig_traced_key_hard", IG_TRACED_KEY)
    spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod, reducefn=mod,
                    storage="mem:tig-hard")
    ex = LocalExecutor(spec, engine="ingraph", device="cpu")
    with pytest.raises(LoweringError, match="tensor"):
        ex.run()


def test_hard_mode_forces_store_plane_task(igmod):
    """engine=ingraph on a host-bound task (oracle verdict store-plane)
    still tries — and raises at build time instead of silently running
    the store plane: the CI mode must not mask a lost lowering."""
    src = IG_SUM.replace(
        'emit(b, torch.sum(torch.where(ids == b, 1, 0)))',
        'emit(b, value["ids"].count(b))')
    mod = igmod("tig_hostbound", src)
    spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod,
                    reducefn="examples.wordcount.reducefn",
                    storage="mem:tig-hard2")
    dec = select_engine(spec, "ingraph")
    assert dec.requested == "ingraph" and dec.chosen == "ingraph"
    assert dec.verdict == "store-plane"
    ex = LocalExecutor(spec, engine="ingraph", device="cpu")
    with pytest.raises(LoweringError):
        ex.run()
    # the same task runs on the store plane
    assert _local(mod, "store", "hard2-s",
                  reducefn="examples.wordcount.reducefn").stats.iterations


def test_auto_store_plane_task_never_crashes(igmod):
    """engine=auto on a store-plane-verdicted task never compiles the
    whole plane: the offending function is named in the reason, zero
    whole-task compiled iterations, normal output (the hybrid rung may
    take single legs — tests/test_torch_hybrid.py owns that)."""
    src = IG_SUM.replace(
        'emit(b, torch.sum(torch.where(ids == b, 1, 0)))',
        'emit(str(b), 1)')
    mod = igmod("tig_storeplane", src)
    ex = _local(mod, "auto", "sp-auto",
                reducefn="examples.wordcount.reducefn")
    assert ex.engine_decision.chosen in ("store", "hybrid")
    assert ex.engine_decision.verdict == "store-plane"
    assert "mapfn" in ex.engine_decision.reason
    it = ex.stats.iterations[-1]
    assert it.ingraph_iterations == 0 and it.ingraph_fallbacks == 0
    assert len(_result_bytes(ex.result_store)) > 0


def test_auto_unresolvable_spec_degrades():
    """Dict/callable module specs can't be statically checked: auto
    degrades to the store plane with a reason, never a crash."""
    spec = TaskSpec(taskfn={"taskfn": lambda e: e(0, {"v": [1.0]})},
                    mapfn={"mapfn": lambda k, v, e: e(0, v["v"][0])},
                    partitionfn={"partitionfn": lambda k: 0},
                    reducefn={"reducefn": lambda k, vs: sum(vs)},
                    storage="mem:tig-dicts")
    ex = LocalExecutor(spec, engine="auto")
    ex.run()
    assert ex.engine_decision.chosen == "store"
    assert "not statically checkable" in ex.engine_decision.reason
    assert len(_result_bytes(ex.result_store)) == 1


# ---------------------------------------------------------------------------
# knob resolution
# ---------------------------------------------------------------------------

def test_engine_env_resolution(monkeypatch):
    monkeypatch.setenv("LMR_ENGINE", "store")
    assert resolve_engine(None) == "store"
    monkeypatch.setenv("LMR_ENGINE", "ingraph")
    assert resolve_engine(None) == "ingraph"
    assert resolve_engine("store") == "store"   # explicit arg wins
    monkeypatch.delenv("LMR_ENGINE")
    assert resolve_engine(None) == "auto"
    with pytest.raises(ValueError):
        resolve_engine("tpu")


# ---------------------------------------------------------------------------
# combiner normalization, int32 overflow refusal, the collective tier's
# key-value-free signature
# ---------------------------------------------------------------------------

def test_array_combiner_normalized_on_store_plane(igmod):
    """A tensor-returning combinerfn serializes on the store plane
    exactly like emitted values do, and agrees with the compiled plane,
    which runs the same combiner in the program."""
    mod = igmod("tig_combiner", IG_COMBINER)

    def run(engine, tag):
        spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod,
                        reducefn=mod, combinerfn=mod,
                        storage=f"mem:tig-comb-{tag}")
        ex = LocalExecutor(spec, engine=engine, device="cpu")
        ex.run()
        return ex

    out_s = _result_bytes(run("store", "s").result_store)
    assert out_s and out_s == _result_bytes(run("ingraph", "i").result_store)


def test_int64_job_values_degrade_to_store(igmod):
    """Integers outside int32 range must NOT silently wrap on the
    compiled plane: auto degrades to the store plane (counted) and the
    exact values survive."""
    src = """
def taskfn(emit):
    for j in range(4):
        emit(j, {"ids": [3_000_000_000 + j]})

def mapfn(key, value, emit):
    emit(0, value["ids"][0])
    emit(1, value["ids"][0] % 97)

def partitionfn(key):
    return int(key) % 2
"""
    mod = igmod("tig_bigint", src)
    ex_s = _local(mod, "store", "big-s",
                  reducefn="examples.wordcount.reducefn")
    ex_a = _local(mod, "auto", "big-a",
                  reducefn="examples.wordcount.reducefn")
    assert ex_a.engine_decision.chosen == "ingraph"   # oracle accepted
    assert ex_a.stats.iterations[-1].ingraph_fallbacks == 1
    assert _result_bytes(ex_a.result_store) == \
        _result_bytes(ex_s.result_store)


def test_collective_tier_no_retrace_on_key_values(igmod):
    """On the collective tier job keys ride as a tensor input: a loop
    emitting iteration-dependent NUMERIC keys must still build once (the
    jit tier, which bakes keys, legitimately rebuilds)."""
    mod = igmod("tig_key_loop", IG_KEY_LOOP)
    spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod, reducefn=mod,
                    finalfn=mod, storage="mem:tig-keyloop")
    ex = LocalExecutor(spec, engine="ingraph", device="cpu",
                       max_iterations=5)
    ex.run()
    assert ex._ingraph.engine.mode == "shard_map"
    assert ex._ingraph.engine.traces == 1
    assert sum(it.ingraph_iterations for it in ex.stats.iterations) == 3


def test_counter_schema():
    from lua_mapreduce_tpu_torch.utils.stats import (COUNTER_FOLD,
                                                     IterationStats)
    assert "ingraph_iterations" in COUNTER_FOLD
    assert "ingraph_fallbacks" in COUNTER_FOLD
    d = IterationStats(iteration=1).as_dict()
    assert d["ingraph_iterations"] == 0 and d["ingraph_fallbacks"] == 0
