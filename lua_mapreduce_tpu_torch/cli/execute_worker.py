"""Worker launcher.

Port of ``lua_mapreduce_tpu/cli/execute_worker.py`` (reference
execute_worker.lua:1-11):

    python -m lua_mapreduce_tpu_torch.cli.execute_worker COORD_DIR \\
        [--max-iter N] [--max-sleep S] [--max-tasks N] [--name NAME] \\
        [--max-jobs N] [--batch-k K] [--phases map,reduce] \\
        [--segment-format v1|v2] [--replication R | --coding K+M] \\
        [--push] [--push-budget-mb MB] [--store-retries N] \\
        [--retry-base-ms MS] [--trace] [--profile DIR] [--report FILE] \\
        [--verbose]

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

The JAX launcher's flags for planes the port does not run yet
(``--idle-poll-ms``, ``--autotune-*``) parse, and raise
NotImplementedError when set (ROADMAP A6b).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from lua_mapreduce_tpu_torch.cli.execute_server import (
    add_fault_trace_args, add_redundancy_push_args, add_trimmed,
    reject_trimmed, setup_fault_trace)

TRIMMED = (
    ("--idle-poll-ms", dict(type=float, default=None)),
    ("--autotune-fleet", dict(type=int, default=None)),
    ("--autotune-max-workers", dict(type=int, default=8)),
)


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
    p.add_argument("--verbose", action="store_true")
    add_trimmed(p, TRIMMED)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    reject_trimmed(p, args, TRIMMED)
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

    worker = Worker(FileJobStore(args.coord), name=args.name,
                    verbose=args.verbose).configure(
        max_iter=args.max_iter, max_sleep=args.max_sleep,
        max_tasks=args.max_tasks, phases=phases, max_jobs=args.max_jobs,
        segment_format=args.segment_format, replication=args.replication,
        coding=args.coding, push=args.push,
        push_budget_mb=args.push_budget_mb)
    if args.batch_k is not None:
        worker.configure(batch_k=args.batch_k)
    counters0 = COUNTERS.snapshot()
    ready = time.time()
    try:
        with profile_ctx:
            worker.execute()
    finally:
        if args.report:
            from lua_mapreduce_tpu_torch import ops
            with open(args.report, "w") as f:
                json.dump({"worker": worker.name, "ready": ready,
                           "jobs": worker.jobs_executed,
                           "bodies": worker.bodies,
                           "rounds": worker.store.round_counts(),
                           "launches": ops.launch_counts(),
                           "counters": COUNTERS.delta(
                               counters0, COUNTERS.snapshot()),
                           "faults_fired": dict(plan.fired)
                           if (plan := active_plan()) else {}}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
