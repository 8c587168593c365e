"""Fault plane: the store/coord error taxonomy (``errors``), the retry
policy and process-global counters (``retry``), seeded fault schedules
(``plan``) and the injection/retry wrappers with their wiring points
(``wrappers``). Copies of the JAX package's modules of the same names;
the replicated and erasure-coded shuffles (``replicate``, ``coded``)
are a later slice (ROADMAP A6b)."""

from lua_mapreduce_tpu_torch.faults.errors import (ConcurrentInsertError,
                                                   InjectedFault,
                                                   InjectedPermanentFault,
                                                   LostShuffleDataError,
                                                   NoTaskError,
                                                   PermanentStoreError,
                                                   StoreError,
                                                   TransientStoreError,
                                                   classify_exception)
from lua_mapreduce_tpu_torch.faults.plan import FaultPlan
from lua_mapreduce_tpu_torch.faults.retry import (COUNTERS, FaultCounters,
                                                  RetryPolicy,
                                                  configure_retry)
from lua_mapreduce_tpu_torch.faults.wrappers import (FaultyJobStore,
                                                     FaultyStore,
                                                     RetryingJobStore,
                                                     RetryingStore,
                                                     install_fault_plan,
                                                     unwrap, wrap_jobstore,
                                                     wrap_store)

__all__ = [
    "ConcurrentInsertError", "InjectedFault", "InjectedPermanentFault",
    "LostShuffleDataError", "NoTaskError", "PermanentStoreError",
    "StoreError", "TransientStoreError", "classify_exception", "FaultPlan",
    "COUNTERS", "FaultCounters", "RetryPolicy", "configure_retry",
    "FaultyJobStore", "FaultyStore", "RetryingJobStore", "RetryingStore",
    "install_fault_plan", "unwrap", "wrap_jobstore", "wrap_store",
]
