"""Fault plane: the store/coord error taxonomy (``errors``), the retry
policy and process-global counters (``retry``), seeded fault schedules
(``plan``), the injection/retry wrappers with their wiring points
(``wrappers``), the replicated shuffle data plane (``replicate``:
r-way publish, failover reads, repair) and the erasure-coded one
(``coded``: GF(256) Reed-Solomon k+m stripes, decode from the
survivors). Copies of the JAX package's modules of the same names."""

from lua_mapreduce_tpu_torch.faults.errors import (ConcurrentInsertError,
                                                   InjectedFault,
                                                   InjectedPermanentFault,
                                                   LostShuffleDataError,
                                                   NoTaskError,
                                                   PermanentStoreError,
                                                   StaleLeaderError,
                                                   StoreError,
                                                   TransientStoreError,
                                                   classify_exception,
                                                   describe_classification,
                                                   is_transient_fault)
from lua_mapreduce_tpu_torch.faults.coded import (CodedStore, Coding,
                                                  check_redundancy,
                                                  parse_coding,
                                                  redundancy_on,
                                                  repair_stripe,
                                                  resolve_redundancy)
from lua_mapreduce_tpu_torch.faults.plan import FaultPlan
from lua_mapreduce_tpu_torch.faults.replicate import (ReplicatedStore,
                                                      reading_view, repair,
                                                      spill_writer)
from lua_mapreduce_tpu_torch.faults.retry import (COUNTERS, FaultCounters,
                                                  RetryPolicy,
                                                  configure_retry,
                                                  default_policy,
                                                  retry_settings)
from lua_mapreduce_tpu_torch.faults.wrappers import (FaultyJobStore,
                                                     FaultyStore,
                                                     RetryingJobStore,
                                                     RetryingStore,
                                                     active_plan,
                                                     install_fault_plan,
                                                     unwrap, wiring_token,
                                                     wrap_jobstore,
                                                     wrap_store)

__all__ = [
    "ConcurrentInsertError", "InjectedFault", "InjectedPermanentFault",
    "LostShuffleDataError", "NoTaskError", "PermanentStoreError",
    "StaleLeaderError", "StoreError", "TransientStoreError",
    "classify_exception", "is_transient_fault", "describe_classification",
    "FaultPlan",
    "CodedStore", "Coding", "check_redundancy", "parse_coding",
    "redundancy_on", "repair_stripe", "resolve_redundancy",
    "ReplicatedStore", "reading_view", "repair", "spill_writer",
    "COUNTERS", "FaultCounters", "RetryPolicy", "configure_retry",
    "retry_settings", "default_policy",
    "FaultyJobStore", "FaultyStore", "RetryingJobStore", "RetryingStore",
    "install_fault_plan", "active_plan", "unwrap", "wiring_token",
    "wrap_jobstore", "wrap_store",
]


def utest() -> None:
    """Run the subsystem's module self-tests."""
    from lua_mapreduce_tpu_torch.faults import (coded, errors, plan, replicate,
                                                retry, wrappers)
    for mod in (errors, retry, plan, wrappers, replicate, coded):
        mod.utest()
