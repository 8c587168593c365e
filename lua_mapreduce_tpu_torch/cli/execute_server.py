"""Server launcher.

Port of ``lua_mapreduce_tpu/cli/execute_server.py`` (reference
execute_server.lua:1-62), with the same positional contract:
coordination spec, then the user-function module names, then storage.
``/``-paths are normalized to dotted module names
(execute_server.lua:37-39).

    python -m lua_mapreduce_tpu_torch.cli.execute_server \\
        COORD_DIR TASKFN MAPFN PARTITIONFN REDUCEFN \\
        [--combinerfn M] [--finalfn M] [--storage SPEC] \\
        [--result-ns NS] [--init-arg K=V ...] [--inline-workers N] \\
        [--pipeline [--premerge-min-runs N] [--premerge-max-runs N]] \\
        [--segment-format v1|v2] [--replication R | --coding K+M] \\
        [--push [--push-budget-mb MB]] [--speculation-factor F \\
        [--speculation-cap N]] [--store-retries N] \\
        [--retry-base-ms MS] [--trace] [--profile DIR]

COORD_DIR is the shared job-store directory (the connection-string
analog) that ``execute_worker`` processes poll; "mem" runs an in-process
pool with ``--inline-workers N``. The task runs on the card unless it
asks for the CPU (``--init-arg device=cpu``). ``--trace`` records spans
into the task storage (``python -m lua_mapreduce_tpu_torch.trace
STORAGE`` reads them); ``--profile DIR`` wraps the run in a torch
profile, and with ``--trace`` the span names appear in it.

``--replication R`` publishes every spill to R placement copies and
``--coding K+M`` as K+M erasure-coded stripes (reads fail over or decode
from the survivors, and a file with no readable copy left has its
producing map re-run); ``--push`` runs the push shuffle, with
``--push-budget-mb`` bounding the inline workers' buffers. All are
written to the task document for the fleet. ``--speculation-factor F``
gives a straggler (a job RUNNING longer than F × the fleet's duration
EWMA) a speculative duplicate lease, at most ``--speculation-cap`` live
clones per namespace; the first commit wins.

The JAX launcher's flags for planes the port does not run yet
(``--autotune``, ``--ha``, ``--idle-poll-ms``, ...) parse, and raise
NotImplementedError when set (ROADMAP A6b).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import threading


def normalize_module(name: str) -> str:
    """a/b/c.py or a/b/c → a.b.c (execute_server.lua:37-39)."""
    if name.endswith(".py"):
        name = name[:-3]
    return name.strip("/").replace("/", ".")


def parse_init_args(pairs) -> dict:
    out = {}
    for pair in pairs or ():
        k, sep, v = pair.partition("=")
        if not sep:
            raise SystemExit(f"--init-arg needs K=V, got {pair!r}")
        out[k] = v
    return out


# the JAX launcher's flags for planes not ported yet: (flag, argparse
# keywords[, other values meaning "off"]) — any value other than the
# default or those raises in main()
TRIMMED = (
    ("--idle-poll-ms", dict(type=float, default=None)),
    ("--autotune", dict(action="store_true", default=None)),
    ("--autotune-max-workers", dict(type=int, default=None)),
    ("--ha", dict(action="store_true", default=None)),
    ("--lease-ttl-s", dict(type=float, default=None)),
)


def _dest(flag: str) -> str:
    return flag.lstrip("-").replace("-", "_")


def add_trimmed(p: argparse.ArgumentParser, trimmed) -> None:
    group = p.add_argument_group(
        "not ported yet (ROADMAP A6b): setting one raises")
    for flag, kw, *_ in trimmed:
        group.add_argument(flag, **kw)


def reject_trimmed(p: argparse.ArgumentParser, args, trimmed) -> None:
    """NotImplementedError naming every trimmed flag the caller set."""
    set_flags = [flag for flag, _, *off in trimmed
                 if getattr(args, _dest(flag))
                 not in (p.get_default(_dest(flag)), *(off[0] if off else ()))]
    if set_flags:
        raise NotImplementedError(
            f"{p.prog}: {', '.join(set_flags)} not ported to the torch "
            "package yet (ROADMAP A6b)")


def add_redundancy_push_args(p: argparse.ArgumentParser,
                             whose: str) -> None:
    """The shuffle-redundancy and push flags both launchers share;
    ``whose`` says who the value applies to in the help text."""
    p.add_argument("--replication", type=int, default=None,
                   help=f"shuffle replication factor r for {whose} "
                        "(default 1, or LMR_REPLICATION): each spill "
                        "publishes r copies on distinct placement "
                        "targets, readers fail over to any survivor, and "
                        "a file with no copy left has its producing map "
                        "re-run")
    p.add_argument("--coding", type=str, default=None, metavar="K+M",
                   help=f"erasure-coding spec 'k+m' for {whose} (or "
                        "LMR_CODING): each spill stripes into k data + m "
                        "Reed-Solomon parity blocks on distinct placement "
                        "targets, any m losses decode from the survivors;"
                        " exclusive with --replication")
    p.add_argument("--push", action="store_true", default=None,
                   help=f"push shuffle for {whose} (or LMR_PUSH=1): maps "
                        "push JSEG frames into per-partition reducer "
                        "inboxes as they fill, gated by per-map "
                        "manifests; the same result bytes either way")
    p.add_argument("--push-budget-mb", type=float, default=None,
                   help="push buffer-pool memory budget in MB (default "
                        "64, or LMR_PUSH_BUDGET_MB): over-budget "
                        "partitions evict to a staged tail spill "
                        "(counted push_evictions)")


def add_fault_trace_args(p: argparse.ArgumentParser) -> None:
    """The retry, trace and profile flags both launchers share."""
    p.add_argument("--store-retries", type=int, default=None,
                   help="transient store/coord fault retry budget per op "
                        "(default 3, or LMR_STORE_RETRIES; 0 disables the "
                        "retry layer)")
    p.add_argument("--retry-base-ms", type=float, default=None,
                   help="first backoff draw's lower bound in ms (default "
                        "25, or LMR_RETRY_BASE_MS)")
    p.add_argument("--trace", action="store_true",
                   help="record spans of this process into the task "
                        "storage as _trace.* files; read them with "
                        "'python -m lua_mapreduce_tpu_torch.trace "
                        "STORAGE'. Worker processes take their own "
                        "--trace (or LMR_TRACE=1)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="wrap the run in a torch profile written into DIR "
                        "(utils/profiling.device_trace); with --trace the "
                        "span names are rows of the profile beside the "
                        "kernels")


def setup_fault_trace(args):
    """Apply the shared flags; returns the profile context to run in."""
    from lua_mapreduce_tpu_torch.faults.retry import configure_retry
    if args.store_retries is not None or args.retry_base_ms is not None:
        configure_retry(args.store_retries, args.retry_base_ms)
    if args.trace:
        from lua_mapreduce_tpu_torch.trace.span import (Tracer,
                                                        install_tracer)
        install_tracer(Tracer(annotate=bool(args.profile)))
    if args.profile:
        from lua_mapreduce_tpu_torch.utils.profiling import device_trace
        return device_trace(args.profile)
    return contextlib.nullcontext()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="execute_server",
        description="Run the MapReduce server (orchestrator).")
    p.add_argument("coord", help="shared job-store directory, or 'mem'")
    p.add_argument("taskfn")
    p.add_argument("mapfn")
    p.add_argument("partitionfn")
    p.add_argument("reducefn")
    p.add_argument("--combinerfn")
    p.add_argument("--finalfn")
    p.add_argument("--storage", default=None,
                   help="backend[:path] — mem:TAG | shared:DIR | "
                        "object:DIR (default: mem:cli for an in-process "
                        "pool, shared:<COORD>/spill for a shared-dir "
                        "pool)")
    p.add_argument("--result-ns", default="result")
    p.add_argument("--init-arg", action="append", metavar="K=V")
    p.add_argument("--inline-workers", type=int, default=0,
                   help="run N worker threads in this process")
    p.add_argument("--poll", type=float, default=0.1,
                   help="barrier poll interval in seconds")
    p.add_argument("--stale-timeout", type=float, default=600.0,
                   help="requeue RUNNING jobs of silently-dead workers "
                        "after this many seconds (0 disables)")
    p.add_argument("--strict", action="store_true",
                   help="abort with PhaseFailed when any job goes FAILED "
                        "instead of running finalfn on partial results")
    p.add_argument("--pipeline", action="store_true",
                   help="pipelined shuffle: publish eager pre_merge jobs "
                        "over committed runs while mappers still run")
    p.add_argument("--premerge-min-runs", type=int, default=4,
                   help="runs a pre_merge job consolidates at least")
    p.add_argument("--premerge-max-runs", type=int, default=8,
                   help="runs a pre_merge job consolidates at most")
    p.add_argument("--segment-format", choices=("v1", "v2"), default="v1",
                   help="intermediate spill encoding, written to the task "
                        "doc: v1 = text lines, v2 = framed binary "
                        "segments; results stay v1 text")
    add_redundancy_push_args(p, "the fleet, written to the task doc")
    add_fault_trace_args(p)
    p.add_argument("--speculation-factor", type=float, default=None,
                   help="straggler factor (default 0 = off, or "
                        "LMR_SPECULATION), written to the task doc: a "
                        "RUNNING job older than FACTOR x the fleet's "
                        "per-namespace duration EWMA gets a speculative "
                        "duplicate lease; idle workers race it and the "
                        "first commit wins, the loser a zero-repetition "
                        "no-op")
    p.add_argument("--speculation-cap", type=int, default=2,
                   help="max live speculative clones per namespace "
                        "(bounds wasted duplicate work)")
    p.add_argument("--batch-k", type=int, default=1,
                   help="fleet default claim-lease size, written to the "
                        "task doc: workers claim up to K jobs per "
                        "control-plane round trip")
    p.add_argument("--engine",
                   choices=("auto", "ingraph", "hybrid", "store"),
                   default=None,
                   help="execution engine (default auto, or LMR_ENGINE): "
                        "'auto' runs an in-graph-verdicted task's data "
                        "plane as one captured program on this server, "
                        "takes the hybrid rung where single legs "
                        "qualify, else the store plane; 'ingraph' "
                        "forces (lowering failures raise); 'hybrid' "
                        "forces stage-granular legs; 'store' opts out")
    p.add_argument("--quiet", action="store_true")
    add_trimmed(p, TRIMMED)
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    reject_trimmed(p, args, TRIMMED)
    profile_ctx = setup_fault_trace(args)

    from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
    from lua_mapreduce_tpu_torch.engine import Server, TaskSpec, Worker

    storage = args.storage or (
        "mem:cli" if args.coord == "mem"
        else f"shared:{os.path.join(args.coord, 'spill')}")
    spec = TaskSpec(
        taskfn=normalize_module(args.taskfn),
        mapfn=normalize_module(args.mapfn),
        partitionfn=normalize_module(args.partitionfn),
        reducefn=normalize_module(args.reducefn),
        combinerfn=(normalize_module(args.combinerfn)
                    if args.combinerfn else None),
        finalfn=normalize_module(args.finalfn) if args.finalfn else None,
        init_args=parse_init_args(args.init_arg),
        storage=storage,
        result_ns=args.result_ns,
    )
    store = MemJobStore() if args.coord == "mem" else FileJobStore(args.coord)
    server = Server(store, poll_interval=args.poll,
                    stale_timeout_s=args.stale_timeout or None,
                    verbose=not args.quiet, strict=args.strict,
                    pipeline=args.pipeline,
                    premerge_min_runs=args.premerge_min_runs,
                    premerge_max_runs=args.premerge_max_runs,
                    batch_k=args.batch_k,
                    segment_format=args.segment_format,
                    replication=args.replication, coding=args.coding,
                    speculation=args.speculation_factor,
                    speculation_cap=args.speculation_cap,
                    push=args.push, engine=args.engine).configure(spec)
    for _ in range(args.inline_workers):
        w = Worker(store).configure(max_iter=10_000)
        if args.push_budget_mb is not None:
            w.configure(push_budget_mb=args.push_budget_mb)
        threading.Thread(target=w.execute, daemon=True).start()

    def report(phase: str, frac: float) -> None:
        if not args.quiet:
            print(f"\r[{phase}] {100 * frac:5.1f}%", end="", file=sys.stderr)
            if frac >= 1:
                print(file=sys.stderr)

    with profile_ctx:
        stats = server.loop(progress=report)
    last = stats.last
    if not args.quiet and last is not None:
        print(f"cluster_time={last.cluster_time:.2f}s "
              f"wall={stats.wall_time:.2f}s "
              f"map(sum cpu/real)={last.map.sum_cpu_time:.2f}/"
              f"{last.map.sum_real_time:.2f}s "
              f"reduce(sum cpu/real)={last.reduce.sum_cpu_time:.2f}/"
              f"{last.reduce.sum_real_time:.2f}s "
              f"failed={last.map.failed}/{last.reduce.failed}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
