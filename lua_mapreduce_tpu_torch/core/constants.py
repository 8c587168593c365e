"""Engine tuning constants and status enums.

Copy of the JAX package's ``core/constants.py`` (reference
mapreduce/utils.lua:27-55 constants, utils.lua:33-46 STATUS /
TASK_STATUS enums), trimmed to what the port's barrier engine, job
stores, Server and Worker consult, plus the job-store namespaces the
Server and Worker share.
"""

import enum

DEFAULT_SLEEP = 0.1               # utils.lua:29 is 1s; local store polls cheaper
MAX_PENDING_INSERTS = 50_000      # utils.lua:50 — batched control-plane writes
MAX_JOB_RETRIES = 3               # utils.lua:51 — BROKEN→FAILED threshold
MAX_WORKER_RETRIES = 3            # utils.lua:52 — worker gives up after 3 errors
MAX_MAP_RESULT = 5_000            # utils.lua:53 — in-map combiner threshold
MAX_TASKFN_VALUE_SIZE = 16 * 1024 # utils.lua:54 — serialized task-value cap
MAX_IDLE_COUNT = 5                # utils.lua:55 — map-affinity steal threshold

# job-store namespaces (the reference's map_jobs / red_jobs collections).
# PRE_NS holds the pipelined shuffle's eager pre-merge jobs, published
# during the map phase (engine/premerge.py).
MAP_NS = "map_jobs"
RED_NS = "red_jobs"
PRE_NS = "pre_jobs"


class Status(enum.IntEnum):
    """Per-job status machine (reference utils.lua:33-40).

    WAITING → RUNNING → FINISHED → WRITTEN, with BROKEN (re-claimable) and
    FAILED (given up after MAX_JOB_RETRIES) side states. The values are
    the on-disk encoding of the job index (``coord/idx_py.py``).
    """

    WAITING = 0
    RUNNING = 1
    BROKEN = 2
    FINISHED = 3
    WRITTEN = 4
    FAILED = 5


class TaskStatus(str, enum.Enum):
    """Global task phase (reference utils.lua:42-46)."""

    WAIT = "WAIT"
    MAP = "MAP"
    REDUCE = "REDUCE"
    FINISHED = "FINISHED"
