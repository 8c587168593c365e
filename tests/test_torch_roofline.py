"""The port's roofline accounting against the JAX package's, on the CPU.

``utils/roofline.py`` resolves a card's peak dense bf16 FLOP/s and HBM
rate by ``torch.cuda.get_device_name`` (NVIDIA data-sheet values for the
H100s; no TPU entry), falls back to a measured n³ bf16 product for any
other device, honours the same ``LMR_PEAK_FLOPS`` / ``LMR_PEAK_HBM_BYTES``
overrides and gives the same MFU as the JAX module on the same figures.
The fixed-batch hot loop MFU is read over (``run_steps``) is the same
trajectory as discrete ``step`` calls, and as the JAX harness's. The
card's own reading (the table, the probe, B1's MFU) is ``chip_smoke.py``
phase 29.
"""

import ast
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from lua_mapreduce_tpu.models import mlp as jax_mlp
from lua_mapreduce_tpu.parallel.mesh import host_mesh
from lua_mapreduce_tpu.train.harness import (DataParallelTrainer as
                                             JaxTrainer,
                                             TrainConfig as JaxConfig)
from lua_mapreduce_tpu.utils import roofline as jax_roofline
from lua_mapreduce_tpu_torch.convert import params_from_jax
from lua_mapreduce_tpu_torch.models import mlp
from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                   TrainConfig)
from lua_mapreduce_tpu_torch.utils import roofline

H100_SXM = "NVIDIA H100 80GB HBM3"
CHIP_SMOKE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chip_smoke.py")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", CHIP_SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_peak_env_override(monkeypatch):
    monkeypatch.setenv("LMR_PEAK_FLOPS", "1e15")
    monkeypatch.setenv("LMR_PEAK_HBM_BYTES", "2e12")
    # the override needs no device: it holds even with no card here
    assert roofline.peak_flops_per_s() == 1e15
    assert roofline.peak_hbm_bytes_per_s() == 2e12
    assert jax_roofline.peak_flops_per_s() == 1e15


def test_peak_known_card_table():
    # the card the port runs on, at its data-sheet values; the tables
    # hold cards only
    assert roofline.PEAK_BF16_FLOPS[H100_SXM] == 989e12
    assert roofline.PEAK_HBM_BYTES[H100_SXM] == 3.35e12
    assert set(roofline.PEAK_BF16_FLOPS) == set(roofline.PEAK_HBM_BYTES)
    assert not any("TPU" in k for k in roofline.PEAK_BF16_FLOPS)


def test_peak_unknown_kind_probes(monkeypatch):
    monkeypatch.delenv("LMR_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("LMR_PEAK_HBM_BYTES", raising=False)
    # the CPU is not in the table → the measured probe (n = 1024 there)
    peak = roofline.peak_flops_per_s("cpu")
    assert peak > 0
    assert roofline.peak_flops_per_s("cpu") == peak          # cached
    assert roofline._probe_cache[("cpu", 1024)] == peak
    assert roofline.peak_hbm_bytes_per_s("cpu") is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_default_device_is_the_card(monkeypatch):
    monkeypatch.delenv("LMR_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("LMR_PEAK_HBM_BYTES", raising=False)
    for fn in (roofline.peak_flops_per_s, roofline.peak_hbm_bytes_per_s):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_mfu_formula(monkeypatch):
    monkeypatch.setenv("LMR_PEAK_FLOPS", "2e12")
    # 1e12 FLOPs in 1s on 1 card of peak 2e12 → 50%
    assert roofline.mfu(1e12, 1.0, n_chips=1) == pytest.approx(0.5)
    assert roofline.mfu(1e12, 1.0, n_chips=2) == pytest.approx(0.25)
    for flops, s, n in ((1e12, 1.0, 1), (3.3e15, 0.0123, 4)):
        assert roofline.mfu(flops, s, n) == jax_roofline.mfu(flops, s, n)


def test_best_time_takes_the_fastest_call(monkeypatch):
    import time
    reads = iter([0.0, 3.0, 3.0, 4.0, 4.0, 4.5])    # perf_counter reads
    monkeypatch.setattr(time, "perf_counter", lambda: next(reads))
    assert roofline.best_time(lambda: None) == 0.5


def test_run_steps_matches_discrete_steps():
    """run_steps(n) is the same trajectory as n step() calls on the same
    fixed batch — the loop a benchmark reads MFU over measures real
    training — and as the JAX harness's run_steps from the same
    parameters."""
    rng = np.random.RandomState(0)
    x = rng.rand(8, 16).astype(np.float32)
    y = rng.randint(0, 4, 8)
    npp = {k: np.asarray(v) for k, v in
           jax_mlp.init_mlp(jax.random.PRNGKey(0), (16, 8, 4)).items()}

    def make():
        return DataParallelTrainer(mlp.nll_loss, params_from_jax(npp, "cpu"),
                                   TrainConfig(batch_size=8, seed=0),
                                   device="cpu")

    tr_a = make()
    losses = tr_a.run_steps(x, y, 3).numpy()
    tr_b = make()
    discrete = [tr_b.step(x, y) for _ in range(3)]

    assert losses.shape == (3,)
    np.testing.assert_allclose(losses, discrete, rtol=1e-5)
    np.testing.assert_allclose(tr_a.params["W0"].detach().numpy(),
                               tr_b.params["W0"].detach().numpy(),
                               rtol=1e-5)
    # loss decreases on a fixed batch: it is really optimizing
    assert losses[-1] < losses[0]
    jtr = JaxTrainer(jax_mlp.nll_loss, npp, host_mesh(1),
                     JaxConfig(batch_size=8, seed=0))
    np.testing.assert_allclose(losses, np.asarray(jtr.run_steps(x, y, 3)),
                               rtol=1e-4, atol=1e-4)


def test_chip_smoke_phases_read_no_unset_global():
    """``chip_ab.py`` imports ``chip_smoke`` and calls its phases without
    ``main()``: no function may read a module-level name that is None
    until ``main()`` sets it, and no function sets module state."""
    tree = ast.parse(open(CHIP_SMOKE).read())
    unset = {t.id for node in tree.body if isinstance(node, ast.Assign)
             and isinstance(node.value, ast.Constant)
             and node.value.value is None
             for t in ast.walk(node) if isinstance(t, ast.Name)}
    read, declared = set(), []
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for node in ast.walk(fn):
                if isinstance(node, ast.Name) and isinstance(node.ctx,
                                                             ast.Load):
                    read.add(node.id)
                elif isinstance(node, ast.Global):
                    declared += node.names
    assert not unset & read, sorted(unset & read)
    assert declared == []


def test_chip_smoke_peaks_come_from_the_table(monkeypatch):
    """The peaks every bound and MFU line of ``chip_smoke.py`` divides by
    resolve, on first use and with no ``main()``, to the roofline table's
    entry for the card's name (here a stubbed H100 SXM)."""
    monkeypatch.delenv("LMR_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("LMR_PEAK_HBM_BYTES", raising=False)
    monkeypatch.setattr(roofline, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: H100_SXM)
    cs = _chip_smoke()
    assert cs.peaks() == (989e12, 3.35e12)
    # 3.35 GB at 3.35 TB/s: 1 ms, bound by the bytes
    assert cs.bound(0, 3.35e9, cs.PEAK_F32_FLOPS) == (1.0, "bytes")
    assert cs.bound(989e9, 0, cs.peaks()[0]) == (1.0, "operations")
