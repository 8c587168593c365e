"""Worker launcher.

Port of ``lua_mapreduce_tpu/cli/execute_worker.py`` (reference
execute_worker.lua:1-11):

    python -m lua_mapreduce_tpu_torch.cli.execute_worker COORD_DIR \\
        [--max-iter N] [--max-sleep S] [--max-tasks N] [--name NAME] \\
        [--max-jobs N] [--batch-k K] [--phases map,reduce] \\
        [--segment-format v1|v2] [--replication R | --coding K+M] \\
        [--push] [--push-budget-mb MB] [--store-retries N] \\
        [--retry-base-ms MS] [--idle-poll-ms MS] \\
        [--autotune-fleet N [--autotune-max-workers M]] [--trace] \\
        [--profile DIR] [--report FILE] [--verbose]

One elastic worker polling the shared job-store directory an
``execute_server`` process coordinates. It runs its task on the card:
``--init-arg device=cpu`` given to the server is the only way to the
CPU, and without a card any other task raises. ``--report FILE`` writes
what this process did as JSON to FILE when the worker leaves: the jobs
it executed, its control-plane round trips, the kernel launches it made
(``ops.launch_counts()``), the fault-plane counters it bumped
(``faults/retry.COUNTERS``) and the faults its ``LMR_FAULT_PLAN`` fired,
by kind — a pool's launches and counters are the sums over its
processes — the job bodies it ran by kind (``bodies``: a body that
failed and was run again counts each time) and the wall-clock time its
imports were done (``ready``). ``--replication``/``--coding``/``--push``
override the task document's values for this worker. ``--trace`` and
``--profile DIR`` are the server's. Speculation follows the task
document (the server's ``--speculation-factor``): an idle worker races
a straggler's clone, and ``bodies`` counts the clone's body too. The
job index is the native one where it builds.

``--idle-poll-ms`` caps the idle wait between claim scans (wakeups ride
the store's notify channel; ``LMR_SCHED_NOTIFY=0`` makes every wait a
plain sleep). ``--autotune-fleet N`` runs an elastic pool of N baseline
worker threads in this process that follows the task document's
controller-written ``fleet_target`` (a server's ``--autotune``), up to
``--autotune-max-workers``; a retiring member leaves after its current
lease commits. The report then sums the members.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from lua_mapreduce_tpu_torch.cli.execute_server import (
    add_fault_trace_args, add_redundancy_push_args, setup_fault_trace)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="execute_worker",
        description="Run one elastic MapReduce worker.")
    p.add_argument("coord", help="shared job-store directory")
    p.add_argument("--max-iter", type=int, default=20,
                   help="idle polls before the worker leaves")
    p.add_argument("--max-sleep", type=float, default=20.0,
                   help="cap in seconds of the idle poll back-off")
    p.add_argument("--max-tasks", type=int, default=1)
    p.add_argument("--name")
    p.add_argument("--max-jobs", type=int, default=None,
                   help="leave after executing N jobs (bounded lifetime "
                        "for churned elastic pools)")
    p.add_argument("--batch-k", type=int, default=None,
                   help="claim up to K jobs per control-plane round trip; "
                        "default follows the task document's batch_k")
    p.add_argument("--engine",
                   choices=("auto", "ingraph", "hybrid", "store"),
                   default=None,
                   help="exports LMR_ENGINE: the hybrid legs follow the "
                        "task document's negotiated split regardless; "
                        "this is the fallback for a document with none")
    p.add_argument("--segment-format", choices=("v1", "v2"), default=None,
                   help="spill encoding this worker writes; default "
                        "follows the task document")
    add_redundancy_push_args(p, "this worker (default: the task "
                                "document's)")
    add_fault_trace_args(p)
    p.add_argument("--phases", default="map,reduce",
                   help="comma list of phases this worker claims")
    p.add_argument("--report", metavar="FILE", default=None,
                   help="write this worker's jobs, round trips and kernel "
                        "launches (JSON) to FILE on exit")
    p.add_argument("--idle-poll-ms", type=float, default=None,
                   help="idle-poll cap in ms (default LMR_IDLE_POLL_MS, "
                        "else --max-sleep): the longest wait between "
                        "claim scans when no wakeup arrives")
    p.add_argument("--autotune-fleet", type=int, default=None, metavar="N",
                   help="elastic pool: run N baseline worker threads and "
                        "follow the task document's controller-written "
                        "fleet_target, retiring surplus members after "
                        "their current lease commits")
    p.add_argument("--autotune-max-workers", type=int, default=8,
                   help="elastic ceiling for --autotune-fleet (raised to "
                        "the baseline if smaller)")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    profile_ctx = setup_fault_trace(args)
    phases = tuple(s.strip() for s in args.phases.split(",") if s.strip())
    for ph in phases:
        if ph not in ("map", "reduce"):
            raise SystemExit(f"--phases: unknown phase {ph!r}")
    if args.engine is not None:
        from lua_mapreduce_tpu_torch.engine.ingraph import resolve_engine
        os.environ["LMR_ENGINE"] = resolve_engine(args.engine)

    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.engine.worker import Worker
    from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
    from lua_mapreduce_tpu_torch.faults.wrappers import active_plan

    store = FileJobStore(args.coord)

    def mint(name):
        w = Worker(store, name=name, verbose=args.verbose).configure(
            max_iter=args.max_iter, max_sleep=args.max_sleep,
            max_tasks=args.max_tasks, phases=phases, max_jobs=args.max_jobs,
            segment_format=args.segment_format,
            replication=args.replication, coding=args.coding,
            push=args.push, push_budget_mb=args.push_budget_mb,
            idle_poll_ms=args.idle_poll_ms)
        if args.batch_k is not None:
            w.configure(batch_k=args.batch_k)
        return w

    members = []
    counters0 = COUNTERS.snapshot()
    ready = time.time()
    try:
        with profile_ctx:
            if args.autotune_fleet:
                run_elastic(store, mint, args, members)
            else:
                members.append(mint(args.name))
                members[0].execute()
    finally:
        if args.report:
            from lua_mapreduce_tpu_torch import ops
            bodies = {}
            for w in members:
                for k, v in w.bodies.items():
                    bodies[k] = bodies.get(k, 0) + v
            name = (members[0].name if len(members) == 1
                    else args.name or "elastic")
            with open(args.report, "w") as f:
                json.dump({"worker": name, "ready": ready,
                           "jobs": sum(w.jobs_executed for w in members),
                           "bodies": bodies,
                           "members": len(members),
                           "rounds": store.round_counts(),
                           "launches": ops.launch_counts(),
                           "counters": COUNTERS.delta(
                               counters0, COUNTERS.snapshot()),
                           "faults_fired": dict(plan.fired)
                           if (plan := active_plan()) else {}}, f)
    return 0


def run_elastic(store, mint, args, members) -> None:
    """The elastic pool: worker threads sharing this process's store,
    resized toward the task document's ``fleet_target`` (under its
    ``autotune`` marker) until every member has left on its own idle or
    task bounds. ``members`` collects every member ever started."""
    import threading

    from lua_mapreduce_tpu_torch.sched.controller import FleetSupervisor
    threads = []

    def spawn(seq):
        w = mint(f"{args.name or 'elastic'}-{seq}")
        t = threading.Thread(target=w.execute, daemon=True)
        members.append(w)
        threads.append(t)
        t.start()
        return w

    cap = max(args.autotune_fleet, args.autotune_max_workers)
    sup = FleetSupervisor(spawn, retire=lambda w: w.configure(max_jobs=0),
                          baseline=args.autotune_fleet, cap=cap)
    sup.ensure_baseline()
    while any(t.is_alive() for t in threads):
        task = store.get_task() or {}
        if task.get("autotune") and task.get("fleet_target"):
            sup.resize(int(task["fleet_target"]))
        time.sleep(0.2)


if __name__ == "__main__":
    raise SystemExit(main())
