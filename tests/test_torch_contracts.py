"""The port's lowerability oracle (``lua_mapreduce_tpu_torch/analysis/
contracts.py``) against the JAX package's.

The port's oracle reads torch-surface code: its array roots are
``torch``, ``np``/``numpy``, ``math`` and the names bound to the port's
kernel library by an import, where the JAX oracle's are ``jnp``/``np``/
``numpy``/``math``/``jax``. So the port's six-function examples must
get, function by function, the verdicts the JAX oracle gives the JAX
examples they port; task modules that use neither array library
(wordcount, extsort) get the same verdicts from both oracles; and a
``jnp`` call is an unknown root in the port (store-plane), as
``pandas`` is in the JAX package. Static only: no user module is
imported (both oracles promise it).
"""

import sys

import pytest

from lua_mapreduce_tpu.analysis import contracts as jax_contracts
from lua_mapreduce_tpu_torch.analysis import contracts

EXAMPLES = [
    ("examples.kmeans.mr_kmeans",
     "lua_mapreduce_tpu_torch.examples.kmeans.mr_kmeans"),
    ("examples.als.mr_als", "lua_mapreduce_tpu_torch.examples.als.mr_als"),
    ("examples.digits.mr_sgd",
     "lua_mapreduce_tpu_torch.examples.digits.mr_sgd"),
    # the store-plane task modules: the same source under both oracles
    ("examples.wordcount", "examples.wordcount"),
    ("examples.extsort.sorttask", "examples.extsort.sorttask"),
]


def _verdicts(rep):
    return rep.verdict, {f: fr.verdict for f, fr in rep.functions.items()}


@pytest.mark.parametrize("ref,port", EXAMPLES,
                         ids=[r.split(".")[-1] for r, _ in EXAMPLES])
def test_port_verdicts_equal_the_jax_oracles(ref, port):
    want = jax_contracts.check_task(ref)
    got = contracts.check_task(port)
    assert _verdicts(got) == _verdicts(want)
    assert contracts.stage_report(got) == jax_contracts.stage_report(want)
    assert [f.rule for f in got.findings] == \
        [f.rule for f in want.findings]


def test_examples_lower_and_wordcount_stays_store_plane():
    for _, port in EXAMPLES[:3]:
        rep = contracts.check_task(port)
        assert rep.verdict == contracts.VERDICT_INGRAPH, port
    wc = contracts.check_task("examples.wordcount")
    assert wc.verdict == contracts.VERDICT_STORE
    assert wc.functions["mapfn"].verdict == contracts.VERDICT_STORE
    assert wc.functions["reducefn"].verdict == contracts.VERDICT_INGRAPH
    assert contracts.stage_report(wc)["reduce"]["compiled"]


def test_no_user_module_is_imported():
    before = set(sys.modules)
    for _, port in EXAMPLES:
        contracts.check_task(port)
    assert not {m for m in set(sys.modules) - before
                if m.startswith(("examples", "lua_mapreduce_tpu_torch."
                                 "examples"))}


TASK = """
import numpy as np
import torch
{imports}

def taskfn(emit):
    for j in range(4):
        emit(j, {{"v": [j, j + 1]}})

def mapfn(key, value, emit):
    v = torch.as_tensor(value["v"])
    emit(0, {call})

def partitionfn(key):
    return int(key) % 2

def reducefn(key, values):
    acc = values[0]
    for i in range(1, len(values)):
        acc = acc + values[i]
    return acc
"""


@pytest.mark.parametrize("imports,call,verdict,reason", [
    ("", "torch.sum(v)", "in-graph", None),
    ("", "np.sum(v)", "in-graph", None),
    ("import jax.numpy as jnp", "jnp.sum(v)", "store-plane",
     "call to jnp.sum()"),
    ("from lua_mapreduce_tpu_torch import ops",
     "ops.matmul(v[None], v[:, None])", "in-graph", None),
    ("from lua_mapreduce_tpu_torch import ops as kernels",
     "kernels.log_softmax(v[None])", "in-graph", None),
    ("from lua_mapreduce_tpu_torch.ops import matmul",
     "matmul(v[None], v[:, None])", "in-graph", None),
    ("import pandas", "pandas.Series(v)", "store-plane",
     "call to pandas.Series()"),
    ("", "v.sum()", "store-plane", "call to v.sum()"),
    ("", "torch.randn(3)", "store-plane", "determinism hazard"),
], ids=["torch", "numpy", "jnp", "ops", "ops-alias", "ops-function",
        "pandas", "method", "torch-rng"])
def test_array_roots(tmp_path, imports, call, verdict, reason):
    path = tmp_path / "roots_task.py"
    path.write_text(TASK.format(imports=imports, call=call))
    rep = contracts.check_task(str(path))
    fr = rep.functions["mapfn"]
    assert fr.verdict == verdict
    if reason is not None:
        assert reason in fr.reasons[0]
    if verdict == "in-graph":
        assert rep.verdict == "in-graph" and not fr.findings


def test_contract_and_determinism_layers(tmp_path):
    bad = (
        "import time, random, torch\n"
        "def taskfn(emit, extra):\n"
        "    emit(1)\n"
        "def mapfn(key, value, emit):\n"
        "    emit(key, value, time.time())\n"
        "    random.shuffle(value)\n"
        "def partitionfn(key):\n"
        "    return hash(key) % 4\n"
        "def reducefn(key, values):\n"
        "    for v in set(values):\n"
        "        pass\n"
        "    return torch.rand(2)\n"
    )
    path = tmp_path / "badtask.py"
    path.write_text(bad)
    rep = contracts.check_task(str(path))
    assert rep.verdict == contracts.VERDICT_INVALID
    assert {"LMR021", "LMR022", "LMR023", "LMR024", "LMR025"} <= \
        {f.rule for f in rep.findings}
    half = tmp_path / "half.py"
    half.write_text("def mapfn(key, value, emit):\n    emit(key, value)\n")
    rep = contracts.check_task(str(half))
    assert rep.verdict == contracts.VERDICT_INVALID
    assert sum(1 for f in rep.findings if f.rule == "LMR020") == 3
    assert contracts.check_task("no.such.module").verdict == \
        contracts.VERDICT_INVALID
