"""PyTorch/CUDA port of lua_mapreduce_tpu.

A second package beside the JAX one, written for one NVIDIA H100. It
carries its own copy of the host plane it needs (core/, store/, engine/:
the barrier LocalExecutor on ``mem:`` and ``shared:`` storage), and
ports the digits DP-SGD path on top of it:

- ``ops``: hand-written Hopper kernels (CUDA C++, sm_90a) for the row
  log_softmax/softmax and the matmul, each beside a plain PyTorch
  version of the same function. A CPU tensor takes the plain version;
  a CUDA tensor launches the kernel or raises.
- ``models.mlp``: the 256-128-10 tanh/log_softmax MLP over those ops.
- ``examples.digits.mr_train``: the six-function MapReduce trainer.
- ``train.harness``: the single-device ``DataParallelTrainer``.

It imports ``torch`` and numpy, never ``jax`` and nothing of
``lua_mapreduce_tpu``. Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``; with no CUDA device they raise.
"""

from lua_mapreduce_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
