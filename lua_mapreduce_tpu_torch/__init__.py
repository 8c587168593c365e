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

It imports ``torch`` and numpy, never ``jax`` and nothing of
``lua_mapreduce_tpu``. Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``; with no CUDA device they raise.
"""

from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.engine import (LocalExecutor, PhaseFailed,
                                            Server, TaskSpec, Worker)

__all__ = ["resolve_device", "Server", "Worker", "MemJobStore",
           "FileJobStore", "TaskSpec", "LocalExecutor", "PhaseFailed"]
