"""The six-function engine: contract, job runners, the LocalExecutor,
the pipelined shuffle's pre-merge scheduling, and the distributed
Server / Worker pair over a job store (copies of the JAX package's
store-plane engine)."""

from lua_mapreduce_tpu_torch.engine.contract import TaskSpec
from lua_mapreduce_tpu_torch.engine.local import LocalExecutor
from lua_mapreduce_tpu_torch.engine.server import PhaseFailed, Server
from lua_mapreduce_tpu_torch.engine.worker import Worker

__all__ = ["TaskSpec", "LocalExecutor", "Server", "Worker", "PhaseFailed"]
