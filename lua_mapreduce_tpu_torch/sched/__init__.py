"""lmr-sched: the event-driven, multi-tenant control plane (DESIGN §23).

Port of ``lua_mapreduce_tpu/sched/``:

- **watch/notify** (:mod:`sched.waiter`) — per-backend wakeup channels
  (in-process event bus, dirmtime cursors, generation-stamped
  conditional reads) behind one :class:`Waiter`, so job inserts and
  phase flips wake idle pool members in milliseconds while the jittered
  long-interval poll stays as the lost-notification fallback;
- **multi-tenancy** (:mod:`sched.tenancy`) — many concurrent tasks per
  store under per-tenant namespaces, with weighted-fair-share claim
  ordering (stride scheduling) and admission quotas;
- **leader lease** (:mod:`sched.lease`) — the epoch-fenced CAS lease on
  the store's persistent table plus the :class:`FencedJobStore` guard
  (DESIGN §31): standbys watch the "leader" topic and take over
  mid-phase through the server's resume matrix;
- **autotune** (:mod:`sched.controller`) — the feedback controller that
  retunes the perf knobs through the task document (DESIGN §29).
"""

from lua_mapreduce_tpu_torch.sched.lease import (FENCED_OPS, LEASE_NAME,
                                                 STATE_NS, FencedJobStore,
                                                 LeaderLease,
                                                 default_holder,
                                                 frame_state,
                                                 resolve_lease_ttl,
                                                 unframe_state)
from lua_mapreduce_tpu_torch.sched.tenancy import (AdmissionError,
                                                   FairScheduler, FairWorker,
                                                   Tenant, TenantView,
                                                   dispatch_latencies,
                                                   tenant_ns)
from lua_mapreduce_tpu_torch.sched.waiter import (Channel, DirChannel,
                                                  LocalChannel, NullChannel,
                                                  NullWaiter, StoreChannel,
                                                  Waiter, channel_for,
                                                  notify, notify_enabled)

__all__ = [
    "AdmissionError", "FairScheduler", "FairWorker", "Tenant", "TenantView",
    "dispatch_latencies", "tenant_ns",
    "Channel", "DirChannel", "LocalChannel", "NullChannel", "NullWaiter",
    "StoreChannel", "Waiter", "channel_for", "notify", "notify_enabled",
    "LeaderLease", "FencedJobStore", "FENCED_OPS", "LEASE_NAME", "STATE_NS",
    "default_holder", "frame_state", "resolve_lease_ttl", "unframe_state",
]


def utest() -> None:
    from lua_mapreduce_tpu_torch.sched import lease, tenancy, waiter
    waiter.utest()
    tenancy.utest()
    lease.utest()
