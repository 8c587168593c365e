"""The six-function engine: contract, job runners and the barrier
LocalExecutor (copies of the JAX package's store-plane engine)."""

from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.local import LocalExecutor

__all__ = ["TaskSpec", "LocalExecutor"]
