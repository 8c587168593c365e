"""PyTorch/CUDA port of lua_mapreduce_tpu.

A second package beside the JAX one, written for one NVIDIA H100. It
carries its own copy of the host plane it needs (core/, store/,
engine/, faults/, trace/, sched/: the LocalExecutor and the Server/Worker
pool on ``mem:``, ``shared:`` and ``object:`` storage, barrier or
pipelined shuffle, v1 or v2 spills, under the retry and fault-injection
layers and lmr-trace, with notify wakeups, fair share, the HA leader
lease and the autotune controller), and ports the digits DP-SGD path, the LM serving path, the conv-family
training path and single-device LM training on top of it:

- ``ops``: hand-written Hopper kernels (CUDA C++, sm_90a) — matmul,
  row log_softmax/softmax, flash attention forward and its
  FlashAttention-2 backward (dq, dkv), decode attention, the
  weight-only int8 matmul and max/avg pooling — each beside a plain
  PyTorch version of the same function. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel or raises. ``conv2d`` is
  im2col over the matmul kernel.
- ``models.mlp``: the 256-128-10 tanh/log_softmax MLP over those ops.
- ``examples.digits.mr_train``: the six-function MapReduce trainer.
- ``train.harness``: the single-device ``DataParallelTrainer``.
- ``models.transformer``: ``prefill`` and KV-cached ``greedy_decode``
  (GQA, rolling window, int8 weights via ``quantize_lm`` and an int8
  KV cache), and ``make_train_step`` (ring attention on one shard,
  remat, gradient accumulation) with ``train.{accum,precision,optim}``
  and the trainer script ``examples.lm.train_lm``.
- ``models.lenet`` / ``models.resnet``: LeNet-5 and ResNet-18 (NHWC,
  HWIO, GroupNorm) over ``conv2d``, ``maxpool2d`` and ``log_softmax``.
- ``parallel``: the data-parallel plane over ``torch.distributed``
  (NCCL on the card, gloo on the CPU): the mesh and ``spawn``, the
  collectives, ``TpuExecutor``, ``differentiable_keyed``, ZeRO-1; the
  trainer over a mesh, and ``models.kmeans`` / ``models.als``.
- ``analysis``: the static analyzer, the task-contract checker and the
  lease-protocol model checker (``python -m
  lua_mapreduce_tpu_torch.analysis``); ``utils.roofline``: the card's
  peaks and MFU.

The top-level names are the JAX package's (the pool and executor
eagerly, the rest lazily), and :func:`utest` runs the host-path
modules' self-tests (reference mapreduce/init.lua:25-38). It imports
``torch`` and numpy, never ``jax`` and nothing of
``lua_mapreduce_tpu``. Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``; with no CUDA device they raise.
"""

from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.core import tuples
from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.engine import (LocalExecutor, PhaseFailed,
                                            Server, TaskSpec, Worker)

_LAZY = {
    "PersistentTable": ("lua_mapreduce_tpu_torch.coord.persistent_table",
                        "PersistentTable"),
    # fault subsystem
    "StoreError": ("lua_mapreduce_tpu_torch.faults.errors", "StoreError"),
    "TransientStoreError": ("lua_mapreduce_tpu_torch.faults.errors",
                            "TransientStoreError"),
    "PermanentStoreError": ("lua_mapreduce_tpu_torch.faults.errors",
                            "PermanentStoreError"),
    "RetryPolicy": ("lua_mapreduce_tpu_torch.faults.retry", "RetryPolicy"),
    "FaultPlan": ("lua_mapreduce_tpu_torch.faults.plan", "FaultPlan"),
    # in-graph engine
    "InGraphEngine": ("lua_mapreduce_tpu_torch.engine.ingraph",
                      "InGraphEngine"),
    "LoweringError": ("lua_mapreduce_tpu_torch.engine.ingraph",
                      "LoweringError"),
    # lmr-trace
    "Tracer": ("lua_mapreduce_tpu_torch.trace.span", "Tracer"),
    "TraceCollection": ("lua_mapreduce_tpu_torch.trace.collect",
                        "TraceCollection"),
    # lmr-sched
    "Tenant": ("lua_mapreduce_tpu_torch.sched.tenancy", "Tenant"),
    "TenantView": ("lua_mapreduce_tpu_torch.sched.tenancy", "TenantView"),
    "FairWorker": ("lua_mapreduce_tpu_torch.sched.tenancy", "FairWorker"),
    "FairScheduler": ("lua_mapreduce_tpu_torch.sched.tenancy",
                      "FairScheduler"),
    "AdmissionError": ("lua_mapreduce_tpu_torch.sched.tenancy",
                       "AdmissionError"),
    "Waiter": ("lua_mapreduce_tpu_torch.sched.waiter", "Waiter"),
    # lmr-ha
    "LeaderLease": ("lua_mapreduce_tpu_torch.sched.lease", "LeaderLease"),
    "FencedJobStore": ("lua_mapreduce_tpu_torch.sched.lease",
                       "FencedJobStore"),
    "StaleLeaderError": ("lua_mapreduce_tpu_torch.faults.errors",
                         "StaleLeaderError"),
}


def __getattr__(name):
    """Lazy exports: the fault, trace, sched and in-graph layers load
    on first use; the contract, local and pool layers above are eager."""
    try:
        modname, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib
    return getattr(importlib.import_module(modname), attr)


__all__ = ["resolve_device", "Server", "Worker", "MemJobStore",
           "FileJobStore", "TaskSpec", "LocalExecutor", "PhaseFailed",
           *_LAZY, "tuples", "utest"]


def utest():
    """Run every host-path module's self-test (reference
    mapreduce/test.lua:30-39)."""
    import importlib

    from lua_mapreduce_tpu_torch import analysis, faults, sched, trace
    from lua_mapreduce_tpu_torch.coord import jobstore, persistent_table
    from lua_mapreduce_tpu_torch.core import heap, merge, segment, serialize
    from lua_mapreduce_tpu_torch.engine import (contract, ingraph,
                                                placement, premerge, push,
                                                server, worker)
    from lua_mapreduce_tpu_torch.store import memfs
    from lua_mapreduce_tpu_torch.utils import lockcheck, stats

    # the module: the store package's ``router`` is the function of that
    # name, which has no self-test
    router = importlib.import_module("lua_mapreduce_tpu_torch.store.router")

    # host-path modules only, the JAX package's list: the ops' self-test
    # (ops/q8.py) runs the plain version on CPU tensors and is called on
    # its own; ingraph's is host-only by design (knob resolution and the
    # static oracle consult)
    for mod in (tuples, heap, serialize, segment, merge, jobstore, memfs,
                contract, router, persistent_table, stats, placement,
                premerge, push, worker, server, ingraph, analysis, faults,
                trace, sched, lockcheck):
        mod.utest()
