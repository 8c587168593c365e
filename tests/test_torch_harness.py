"""The port's training harness against the JAX package's, on the CPU:
gradient accumulation, ``fit(conf=)`` resume through a persistent table,
``profile_dir``, ``zero1``'s need of a mesh; the data-parallel step over
a mesh (an n-rank gloo world, n = 2 and 4, per-rank bodies in
``tests/torch_parallel_ranks.py``) and its resume; the launch crediting
of captured graphs (pure Python); the digits-sheet end-to-end example.

The captured CUDA-graph step itself runs only on a card
(``tests/test_torch_cuda.py``); on the CPU the same step function runs
eagerly, so these tests hold its arithmetic. Tolerances are the JAX
suite's (``tests/test_training.py``: rtol 1e-5 / atol 1e-6 between
grad_accum settings; ``tests/test_ops.py``: 1e-4 across packages)."""

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
from lua_mapreduce_tpu_torch import graphs, ops
from lua_mapreduce_tpu_torch.convert import (params_from_jax,
                                             params_to_numpy)
from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.coord.persistent_table import PersistentTable
from lua_mapreduce_tpu_torch.models import mlp
from lua_mapreduce_tpu_torch.parallel import spawn
from lua_mapreduce_tpu_torch.store.memfs import MemStore
from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore
from lua_mapreduce_tpu_torch.train import checkpoint as ckpt
from lua_mapreduce_tpu_torch.train.data import make_digits
from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                   TrainConfig)

SIZES = (64, 32, 10)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_params(seed=0, sizes=SIZES):
    return {k: np.asarray(v) for k, v in
            jax_mlp.init_mlp(jax.random.PRNGKey(seed), sizes).items()}


def _trainer(npp, **cfg):
    return DataParallelTrainer(mlp.nll_loss, params_from_jax(npp, "cpu"),
                               TrainConfig(**cfg), device="cpu")


@pytest.fixture(scope="module")
def digits():
    return make_digits(seed=0, n_train=256, n_val=64, dim=SIZES[0])


# ---------------------------------------------------------- grad_accum

def test_grad_accum_matches_whole_batch_and_jax(digits):
    """grad_accum=4 takes the step of the whole batch (the JAX suite's
    rtol 1e-5 / atol 1e-6) and the JAX harness's grad_accum=4 step on a
    one-device mesh (1e-4)."""
    x, y = digits[0][:128], digits[1][:128]
    npp = _jax_params(7)
    losses, stepped = {}, {}
    for accum in (1, 4):
        tr = _trainer(npp, grad_accum=accum)
        losses[accum] = tr.step(x, y)
        stepped[accum] = params_to_numpy(tr.params)
    assert abs(losses[1] - losses[4]) < 1e-6
    for k in stepped[1]:
        np.testing.assert_allclose(stepped[1][k], stepped[4][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    jtr = JaxTrainer(jax_mlp.nll_loss, npp, host_mesh(1),
                     JaxConfig(grad_accum=4))
    assert abs(jtr.step(x, y) - losses[4]) < 1e-4
    for k, v in jtr.params.items():
        np.testing.assert_allclose(stepped[4][k], np.asarray(v),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("call", ["step", "run_steps", "run_epoch"])
def test_grad_accum_that_does_not_split_raises(digits, call):
    x, y = digits[0][:128], digits[1][:128]
    tr = _trainer(_jax_params(), grad_accum=3, batch_size=128)
    with pytest.raises(ValueError, match="grad_accum"):
        if call == "step":
            tr.step(x, y)
        elif call == "run_steps":
            tr.run_steps(x, y, 2)
        else:
            tr.run_epoch(x, y, np.random.RandomState(0))


def test_grad_accum_epoch_matches_jax(digits):
    """A whole epoch at grad_accum=2 (the same shuffles from the same
    seed) gives the JAX harness's mean loss and parameters."""
    x_tr, y_tr = digits[0], digits[1]
    npp = _jax_params(3)
    cfg = dict(batch_size=32, grad_accum=2)
    jtr = JaxTrainer(jax_mlp.nll_loss, npp, host_mesh(1), JaxConfig(**cfg))
    ptr = _trainer(npp, **cfg)
    got = ptr.run_epoch(x_tr, y_tr, np.random.RandomState(5))
    want = jtr.run_epoch(x_tr, y_tr, np.random.RandomState(5))
    assert abs(got - want) < 1e-4
    for k, v in jtr.params.items():
        np.testing.assert_allclose(params_to_numpy(ptr.params)[k],
                                   np.asarray(v), rtol=1e-4, atol=1e-4)


def test_zero1_and_bad_grad_accum_raise():
    with pytest.raises(ValueError, match="mesh"):
        _trainer(_jax_params(), zero1=True)
    with pytest.raises(ValueError, match="grad_accum"):
        _trainer(_jax_params(), grad_accum=0)


def test_cpu_steps_run_eagerly_and_capture_nothing(digits):
    x, y = digits[0][:32], digits[1][:32]
    graphs.reset_captures()
    tr = _trainer(_jax_params(), batch_size=32)
    tr.run_steps(x, y, 3)
    tr.step(x, y)
    assert tr.traces == 0 and graphs.captures() == (0, None)
    assert torch.isfinite(tr.run_steps(x, y, 2)).all()


# ----------------------------------------------------- data-parallel

@pytest.mark.parametrize("n", [2, 4], ids=["dp2", "dp4"])
def test_dp_step_equals_single_device_step(digits, n):
    """The mean of the ranks' gradients is the whole batch's: one step of
    the trainer over an n-rank mesh equals one plain full-batch step
    (torch SGD with the config's momentum and weight decay) and the JAX
    DP trainer's step on ``host_mesh(n)`` (tests/test_training.py:56-78:
    rtol 2e-5, atol 2e-6); a whole epoch at grad_accum=2 gives the JAX
    harness's loss and parameters (1e-4)."""
    from torch_parallel_ranks import dp_step_cases
    x, y = digits[0][:128], digits[1][:128]
    npp = _jax_params(42)
    out = spawn(dp_step_cases, n, {"params": npp, "x": x, "y": y},
                device="cpu", timeout_s=240)
    c = TrainConfig()
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in npp.items()}
    opt = torch.optim.SGD(list(p.values()), lr=c.learning_rate,
                          momentum=c.momentum, weight_decay=c.weight_decay)
    loss = mlp.nll_loss(p, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    opt.step()
    jtr = JaxTrainer(jax_mlp.nll_loss, npp, host_mesh(n), JaxConfig())
    jloss = jtr.step(x, y)
    jep = JaxTrainer(jax_mlp.nll_loss, npp, host_mesh(n),
                     JaxConfig(batch_size=32, grad_accum=2))
    jep_loss = jep.run_epoch(x, y, np.random.RandomState(5))
    for o in out:
        assert abs(o["loss"] - loss.item()) < 1e-6
        assert abs(o["loss"] - jloss) < 1e-5
        for k in npp:
            np.testing.assert_allclose(o["params"][k], p[k].detach().numpy(),
                                       rtol=2e-5, atol=2e-6, err_msg=k)
            np.testing.assert_allclose(o["params"][k],
                                       np.asarray(jtr.params[k]),
                                       rtol=2e-5, atol=2e-6, err_msg=k)
            np.testing.assert_allclose(o["epoch_params"][k],
                                       np.asarray(jep.params[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        assert abs(o["epoch_loss"] - jep_loss) < 1e-4


@pytest.mark.parametrize("zero1", [False, True], ids=["replicated", "zero1"])
def test_fit_resume_over_a_mesh(tmp_path, zero1):
    """fit(conf=) over a 2-rank mesh on shared stores: rank 0 writes the
    checkpoints and the table, every rank loads them after a barrier. 2
    epochs, then a fresh trainer (other initial parameters) resumes and
    runs epoch 3 only, ending on the never-stopped 3-epoch run's
    parameters (1e-6) on every rank; under ZeRO-1 the momentum chunks
    are gathered into the checkpoint and re-chunked on load."""
    from torch_parallel_ranks import fit_resume_cases
    d = {"params": _jax_params(4), "other": _jax_params(8),
         "data": make_digits(seed=0, n_train=256, n_val=64, dim=SIZES[0])}
    out = spawn(fit_resume_cases, 2, d, str(tmp_path), zero1, device="cpu",
                timeout_s=240)
    for o in out:
        assert o["epochs"] == [3]
        for k in o["whole"]:
            np.testing.assert_allclose(o["resumed"][k], o["whole"][k],
                                       rtol=1e-6, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(o["resumed"][k],
                                          out[0]["resumed"][k])
        np.testing.assert_allclose(o["val"], o["ref_val"], atol=1e-6)


# ------------------------------------------------------------ resume

def _fit(npp, store, conf, epochs, **kw):
    tr = _trainer(npp, max_epochs=epochs, patience=10, batch_size=32, **kw)
    out = tr.fit(*make_digits(seed=0, n_train=256, n_val=64, dim=SIZES[0]),
                 checkpoint_store=store, conf=conf)
    return tr, out


@pytest.mark.parametrize("backend", ["mem", "file"])
def test_fit_resumes_from_conf(tmp_path, backend):
    """The JAX suite's resume test (tests/test_training.py:100-135) on
    the port: 3 epochs record epoch 3 and a resume file with non-zero
    momentum; a fresh trainer (other initial params) resumes at 4 and
    runs 4 and 5 only."""
    if backend == "mem":
        store, jobstore = MemStore(), MemJobStore()
    else:
        store = SharedStore(str(tmp_path / "ckpt"))
        jobstore = FileJobStore(str(tmp_path / "coord"))
    tr, _ = _fit(_jax_params(0), store, PersistentTable("conf", jobstore), 3)
    conf = PersistentTable("conf", jobstore)
    assert conf["epoch"] == 3
    assert store.exists("model.ckpt.resume")
    saved_p, saved_b = ckpt.load_pytree(
        store, "model.ckpt.resume", (tr.params, tr.momentum_buffers()))
    for k in tr.params:
        assert torch.equal(saved_p[k], tr.params[k].detach())
    assert any(float(b.abs().max()) > 0 for b in saved_b.values())
    tr2, out2 = _fit(_jax_params(9), store, conf, 5)
    assert [h["epoch"] for h in out2["history"]] == [4, 5]
    assert out2["epochs"] == 5
    assert PersistentTable("conf", jobstore)["epoch"] == 5


def test_kill_and_resume_equals_never_stopped():
    """3 epochs, then a new trainer resuming to 5, ends with the
    parameters of one 5-epoch run (within 1e-6): the resume loads
    params and momentum in place and replays the finished epochs'
    shuffles."""
    npp = _jax_params(4)
    store, jobstore = MemStore(), MemJobStore()
    _fit(npp, store, PersistentTable("c", jobstore), 3)
    resumed, out = _fit(_jax_params(8), store, PersistentTable("c", jobstore),
                        5)
    assert [h["epoch"] for h in out["history"]] == [4, 5]
    whole, ref = _fit(npp, MemStore(), PersistentTable("c", MemJobStore()), 5)
    for k in whole.params:
        np.testing.assert_allclose(resumed.params[k].detach().numpy(),
                                   whole.params[k].detach().numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for got, want in zip(out["history"], ref["history"][3:]):
        assert abs(got["train_loss"] - want["train_loss"]) < 1e-6


def test_resume_against_jax_and_the_reference_rng_restart():
    """Kill-and-resume in both packages, from the same numpy inputs and
    initial parameters. The port's resumed run ends where the JAX
    package's never-stopped run ends (1e-4). The JAX resume makes its
    shuffling rng from the seed before it loads the resume file
    (lua_mapreduce_tpu/train/harness.py:286), so its epochs 4 and 5
    take the batches of epochs 1 and 2 and it ends away from its own
    never-stopped run: a fault of the reference (ROADMAP C). The port's
    trainer reproduces that run when its epochs 4 and 5 are fed a fresh
    rng from the seed."""
    from lua_mapreduce_tpu.coord.jobstore import MemJobStore as JaxJobs
    from lua_mapreduce_tpu.coord.persistent_table import (
        PersistentTable as JaxTable)
    from lua_mapreduce_tpu.store.memfs import MemStore as JaxStore

    data = make_digits(seed=0, n_train=256, n_val=64, dim=SIZES[0])
    npp = _jax_params(4)

    def jax_fit(init, store, conf, epochs):
        tr = JaxTrainer(jax_mlp.nll_loss, init, host_mesh(1),
                        JaxConfig(max_epochs=epochs, patience=10,
                                  batch_size=32))
        return tr, tr.fit(*data, checkpoint_store=store, conf=conf)

    jstore, jjobs = JaxStore(), JaxJobs()
    jax_fit(npp, jstore, JaxTable("c", jjobs), 3)
    jres, jout = jax_fit(_jax_params(8), jstore, JaxTable("c", jjobs), 5)
    assert [h["epoch"] for h in jout["history"]] == [4, 5]
    jwhole, _ = jax_fit(npp, JaxStore(), JaxTable("c", JaxJobs()), 5)

    store, jobs = MemStore(), MemJobStore()
    stopped, _ = _fit(npp, store, PersistentTable("c", jobs), 3)
    resumed, _ = _fit(_jax_params(8), store, PersistentTable("c", jobs), 5)
    rng = np.random.RandomState(TrainConfig().seed)
    for _ in range(2):
        stopped.run_epoch(data[0], data[1], rng)
    drift = 0.0
    for k, v in jwhole.params.items():
        np.testing.assert_allclose(resumed.params[k].detach().numpy(),
                                   np.asarray(v), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(stopped.params[k].detach().numpy(),
                                   np.asarray(jres.params[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
        drift = max(drift, float(np.abs(np.asarray(jres.params[k])
                                        - np.asarray(v)).max()))
    assert drift > 1e-3


def test_fit_without_conf_matches_jax(digits):
    """fit(conf=None) keeps the JAX harness's history: same epochs, same
    losses (1e-4), same early-stopping record."""
    npp = _jax_params(12)
    x_tr, y_tr, x_va, y_va = digits
    cfg = dict(batch_size=32, max_epochs=3, patience=5)
    jout = JaxTrainer(jax_mlp.nll_loss, npp, host_mesh(1),
                      JaxConfig(**cfg)).fit(x_tr, y_tr, x_va, y_va)
    pout = _trainer(npp, **cfg).fit(x_tr, y_tr, x_va, y_va)
    assert pout["epochs"] == jout["epochs"]
    assert pout["best_epoch"] == jout["best_epoch"]
    for jh, ph in zip(jout["history"], pout["history"]):
        assert abs(ph["val_loss"] - jh["val_loss"]) < 1e-4


# ----------------------------------------------------------- profiling

def test_profile_dir_traces_the_second_epoch(digits, tmp_path):
    """TrainConfig.profile_dir: nothing after the first epoch, a trace
    file after the second (tests/test_training.py:217-235)."""
    pdir = str(tmp_path / "trace")
    tr = _trainer(_jax_params(), batch_size=64, profile_dir=pdir)
    rng = np.random.RandomState(0)
    tr.run_epoch(digits[0], digits[1], rng)
    assert not os.path.exists(pdir) or not os.listdir(pdir)
    tr.run_epoch(digits[0], digits[1], rng)
    found = [f for _, _, fs in os.walk(pdir) for f in fs]
    assert found and all(f.endswith(".pt.trace.json") for f in found)
    tr.run_epoch(digits[0], digits[1], rng)
    assert [f for _, _, fs in os.walk(pdir) for f in fs] == found


def test_device_trace_and_annotations(tmp_path):
    from lua_mapreduce_tpu_torch.utils.profiling import (annotate,
                                                         device_trace,
                                                         maybe_annotate)
    with device_trace(str(tmp_path / "t")) as d:
        with annotate("outer"), maybe_annotate("inner"):
            torch.ones(8).sum()
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        text = f.read()
    assert '"outer"' in text and '"inner"' in text


def test_train_lm_profile_writes_a_trace(tmp_path):
    from lua_mapreduce_tpu_torch.examples.lm import train_lm
    args = train_lm.build_parser().parse_args(
        ["--device", "cpu", "--steps", "2", "--d-model", "32",
         "--n-heads", "2", "--n-layers", "1", "--d-ff", "64", "--seq", "16",
         "--batch", "2", "--grad-accum", "1", "--profile",
         str(tmp_path / "p")])
    out = train_lm.run(args)
    assert len(out["losses"]) == 2
    assert os.listdir(tmp_path / "p")


# ------------------------------------------ launch crediting (pure Python)

def test_recorded_launches_are_credited_per_replay():
    """A capture records the launches its step passes through without
    counting them (captured kernels do not run); each replay credits
    them once."""
    ops.reset_launch_counts()
    ops.count_launch("decode")
    with ops.recording_launches() as tally:
        ops.count_launch("q8")
        ops.count_launch("q8")
        ops.count_launch("decode")
    assert tally == {"q8": 2, "decode": 1}
    assert ops.launch_counts()["q8"] == 0
    assert ops.launch_counts()["decode"] == 1
    for _ in range(5):
        ops.credit_launches(tally)
    counts = ops.launch_counts()
    assert counts["q8"] == 10 and counts["decode"] == 6
    assert sum(counts.values()) == 16


def test_recording_restores_counts_when_the_capture_fails():
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError):
        with ops.recording_launches() as tally:
            ops.count_launch("pool")
            raise RuntimeError("capture failed")
    assert tally == {"pool": 1}
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_graph_replay_credits_its_capture(monkeypatch):
    """CapturedGraph wiring, with torch's graph replaced by a stub: the
    capture's launches are credited at every replay, not at capture."""

    class StubGraph:
        def replay(self):
            pass

    modes = []

    class StubContext:
        def __init__(self, graph, capture_error_mode="global"):
            modes.append(capture_error_mode)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", StubContext)
    ops.reset_launch_counts()
    graphs.reset_captures()

    def step():
        ops.count_launch("matmul_bf16")
        ops.count_launch("rowwise_softmax")
        return "out"

    g = graphs.CapturedGraph(step, tag="t")
    assert ops.launch_counts()["matmul_bf16"] == 0
    n, (tag, ms) = graphs.captures()
    assert g.output == "out" and (n, tag) == (1, "t") and ms >= 0
    # other threads of the process (an in-process worker pool) neither
    # break the capture nor are refused by it
    assert modes == ["thread_local"]
    for _ in range(4):
        assert g.replay() == "out"
    counts = ops.launch_counts()
    assert counts["matmul_bf16"] == 4 and counts["rowwise_softmax"] == 4


# ------------------------------------------------------- digits e2e

def test_digits_e2e_runs_both_paths_on_the_cpu():
    """examples/digits/e2e.py at a small budget: both paths learn the
    sheet and the report stands beside the JAX package's result."""
    from lua_mapreduce_tpu_torch.examples.digits import e2e
    out = e2e.run("cpu", harness_steps=60, mr_steps=6, target=0.5)
    assert out["harness_path"]["val_accuracy"] >= 0.5, out
    assert out["mapreduce_path"]["val_accuracy"] >= 0.5, out
    assert out["harness_path"]["captures"] == 0
    assert out["jax_package"] == {"harness_path": 1.0,
                                  "mapreduce_path": 1.0, "platform": "cpu"}
