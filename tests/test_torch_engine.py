"""The port's host plane ≡ the JAX package's: the wordcount golden
matrix (tests/test_wordcount_golden.py:23-52) through both
LocalExecutors must publish byte-identical ``result.P*`` files, on
``mem:`` and ``shared:`` storage. Also: the options the port does not
implement raise, tensors serialize like their ``.tolist()``, and the
port imports nothing of JAX."""

import ast
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.wordcount.naive import naive_wordcount
from lua_mapreduce_tpu.engine.contract import TaskSpec as JaxTaskSpec
from lua_mapreduce_tpu.engine.local import LocalExecutor as JaxExecutor
from lua_mapreduce_tpu.store.router import get_storage_from as jax_storage
from lua_mapreduce_tpu_torch.core.serialize import dump_record, to_plain
from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
from lua_mapreduce_tpu_torch.store.router import get_storage_from

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a fixed slice of the JAX package's own sources: big enough for every
# partition to see data, small enough to keep the matrix quick
CORPUS = sorted(glob.glob(os.path.join(REPO, "lua_mapreduce_tpu", "core",
                                       "*.py")))[:12]

CONFIGS = {
    "combiner": dict(
        taskfn="examples.wordcount.taskfn",
        mapfn="examples.wordcount.mapfn",
        partitionfn="examples.wordcount.partitionfn",
        reducefn="examples.wordcount.reducefn",
        combinerfn="examples.wordcount.reducefn",
        finalfn="examples.wordcount.finalfn",
    ),
    "no_combiner": dict(
        taskfn="examples.wordcount.taskfn",
        mapfn="examples.wordcount.mapfn",
        partitionfn="examples.wordcount.partitionfn",
        reducefn="examples.wordcount.reducefn",
        finalfn="examples.wordcount.finalfn",
    ),
    "general_reducer": dict(
        taskfn="examples.wordcount.taskfn",
        mapfn="examples.wordcount.mapfn",
        partitionfn="examples.wordcount.partitionfn",
        reducefn="examples.wordcount.reducefn2",
        finalfn="examples.wordcount.finalfn",
    ),
    "single_module": dict(
        taskfn="examples.wordcount.single",
        mapfn="examples.wordcount.single",
        partitionfn="examples.wordcount.single",
        reducefn="examples.wordcount.single",
        combinerfn="examples.wordcount.single",
        finalfn="examples.wordcount.single",
    ),
}


def _result_files(store):
    names = [n for n in store.list("result.P*") if "." not in n[8:]]
    return {n: "".join(store.lines(n)) for n in names}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("backend", ["mem", "shared"])
def test_wordcount_results_byte_identical_to_jax(tmp_path, config, backend):
    tag = f"torch-wc-{config}-{backend}"
    if backend == "mem":
        jax_spec, port_spec = f"mem:{tag}-jax", f"mem:{tag}"
    else:
        jax_spec = f"shared:{tmp_path}/jax"
        port_spec = f"shared:{tmp_path}/port"

    JaxExecutor(JaxTaskSpec(init_args={"files": CORPUS}, storage=jax_spec,
                            **CONFIGS[config]), map_parallelism=4).run()
    want = _result_files(jax_storage(jax_spec))

    ex = LocalExecutor(TaskSpec(init_args={"files": CORPUS},
                                storage=port_spec, **CONFIGS[config]),
                       map_parallelism=4)
    stats = ex.run()
    got = _result_files(get_storage_from(port_spec))

    assert want and got == want
    assert dict((k, v[0]) for k, v in ex.results()) == \
        naive_wordcount(CORPUS)
    it = stats.iterations[-1]
    assert it.map.count == len(CORPUS)
    assert it.reduce.count == len(got)
    # consumed run files are gone; only the results remain
    assert get_storage_from(port_spec).list("result.P*.M*") == []


@pytest.mark.parametrize("option,value", [
    ("pipeline", True), ("push", True), ("replication", 2),
    ("coding", "4+1"), ("autotune", True), ("engine", "ingraph"),
    ("segment_format", "v2"), ("push_budget_mb", 4.0),
])
def test_unimplemented_executor_options_raise(option, value):
    spec = TaskSpec(init_args={"files": CORPUS[:1]},
                    storage="mem:torch-opts", **CONFIGS["combiner"])
    with pytest.raises(ValueError, match=option):
        LocalExecutor(spec, **{option: value})


def test_executor_accepts_off_values_and_rejects_unknown_options():
    spec = TaskSpec(init_args={"files": CORPUS[:1]},
                    storage="mem:torch-opts-off", **CONFIGS["combiner"])
    LocalExecutor(spec, pipeline=False, push=False, replication=1,
                  engine="store", segment_format="v1").run()
    with pytest.raises(TypeError, match="batch_kk"):
        LocalExecutor(spec, batch_kk=2)


@pytest.mark.parametrize("spec", ["object:/tmp/x", "mongo:db", "shared"])
def test_unsupported_storage_rejected_at_taskspec(spec):
    with pytest.raises(ValueError):
        TaskSpec(storage=spec, **CONFIGS["combiner"])


def test_loop_protocol_and_finalfn_true_deletes_results():
    state = {"iters": 0}

    def taskfn(emit):
        emit(1, state["iters"])

    def mapfn(key, value, emit):
        emit("count", 1)

    def finalfn(pairs):
        assert list(pairs) == [("count", [1])]
        state["iters"] += 1
        return "loop" if state["iters"] < 3 else True

    ex = LocalExecutor(TaskSpec(taskfn=taskfn, mapfn=mapfn,
                                partitionfn=lambda k: 0,
                                reducefn=lambda k, vs: sum(vs),
                                finalfn=finalfn, storage="mem:torch-loop"))
    stats = ex.run()
    assert state["iters"] == 3 and len(stats.iterations) == 3
    assert ex.finished_value is True and list(ex.results()) == []
    with pytest.raises(RuntimeError, match="max_iterations"):
        state["iters"] = -100
        LocalExecutor(ex.spec, max_iterations=2).run()


def test_taskfn_duplicate_keys_and_value_cap():
    def dup(emit):
        emit(1, "a")
        emit(1, "b")

    def big(emit):
        emit(1, "x" * (17 * 1024))

    for taskfn, match in ((dup, "duplicate"), (big, "bytes")):
        spec = TaskSpec(taskfn=taskfn, mapfn="examples.wordcount.mapfn",
                        partitionfn="examples.wordcount.partitionfn",
                        reducefn="examples.wordcount.reducefn",
                        storage="mem:torch-badtask")
        with pytest.raises(ValueError, match=match):
            LocalExecutor(spec).run()


def test_tensor_records_serialize_like_tolist_and_jax_arrays():
    """to_plain accepts torch tensors: the record bytes equal the
    ``.tolist()`` record's and the JAX package's for a jax array."""
    from lua_mapreduce_tpu.core.serialize import (dump_record as jax_dump,
                                                  to_plain as jax_plain)
    vals = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    t = torch.from_numpy(vals)
    rec = dump_record("g", [to_plain({"grad": t, "n": torch.tensor(3)})])
    assert rec == dump_record("g", [{"grad": vals.tolist(), "n": 3}])
    assert rec == jax_dump("g", [jax_plain({"grad": jnp.asarray(vals),
                                            "n": jnp.asarray(3)})])


_FORBIDDEN = ("jax", "jaxlib", "optax", "ml_dtypes", "lua_mapreduce_tpu",
              "examples")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, node.lineno


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted(glob.glob(os.path.join(REPO, "lua_mapreduce_tpu_torch",
                                          "**", "*.py"), recursive=True))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20 and os.path.exists(files[-1])
    bad = []
    for path in files:
        for name, line in _imported_roots(path):
            if name.split(".")[0] in _FORBIDDEN:
                bad.append(f"{os.path.relpath(path, REPO)}:{line}: {name}")
    assert bad == []
