"""Training: digits data, checkpoints (sync and async), the single-device
harness, gradient accumulation, f32 master weights and the LM
trainer's optimizers."""

from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                   TrainConfig)

__all__ = ["DataParallelTrainer", "TrainConfig"]
