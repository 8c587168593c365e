"""Server launcher.

Port of ``lua_mapreduce_tpu/cli/execute_server.py`` (reference
execute_server.lua:1-62), with the same positional contract:
coordination spec, then the user-function module names, then storage.
``/``-paths are normalized to dotted module names
(execute_server.lua:37-39).

    python -m lua_mapreduce_tpu_torch.cli.execute_server \\
        COORD_DIR TASKFN MAPFN PARTITIONFN REDUCEFN \\
        [--combinerfn M] [--finalfn M] [--storage SPEC] \\
        [--result-ns NS] [--init-arg K=V ...] [--inline-workers N]

COORD_DIR is the shared job-store directory (the connection-string
analog) that ``execute_worker`` processes poll; "mem" runs an in-process
pool with ``--inline-workers N``. The task runs on the card unless it
asks for the CPU (``--init-arg device=cpu``).

The JAX launcher's flags for planes the port does not run yet
(``--pipeline``, ``--push``, ``--replication``, ``--coding``,
``--segment-format v2``, ``--speculation-factor``, ``--autotune``,
``--ha``, ``--trace``, ...) parse, and raise NotImplementedError when
set (ROADMAP A6b).
"""

from __future__ import annotations

import argparse
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
    ("--pipeline", dict(action="store_true")),
    ("--premerge-min-runs", dict(type=int, default=4)),
    ("--premerge-max-runs", dict(type=int, default=8)),
    ("--segment-format", dict(choices=("v1", "v2"), default="v1")),
    ("--store-retries", dict(type=int, default=None)),
    ("--retry-base-ms", dict(type=float, default=None)),
    ("--replication", dict(type=int, default=None), (1,)),
    ("--coding", dict(type=str, default=None)),
    ("--speculation-factor", dict(type=float, default=None), (0.0,)),
    ("--speculation-cap", dict(type=int, default=2)),
    ("--push", dict(action="store_true", default=None)),
    ("--push-budget-mb", dict(type=float, default=None)),
    ("--idle-poll-ms", dict(type=float, default=None)),
    ("--autotune", dict(action="store_true", default=None)),
    ("--autotune-max-workers", dict(type=int, default=None)),
    ("--ha", dict(action="store_true", default=None)),
    ("--lease-ttl-s", dict(type=float, default=None)),
    ("--trace", dict(action="store_true")),
    ("--profile", dict(default=None)),
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
                   help="backend[:path] — mem:TAG | shared:DIR (default: "
                        "mem:cli for an in-process pool, "
                        "shared:<COORD>/spill for a shared-dir pool)")
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
                    batch_k=args.batch_k, engine=args.engine
                    ).configure(spec)
    for _ in range(args.inline_workers):
        w = Worker(store).configure(max_iter=10_000)
        threading.Thread(target=w.execute, daemon=True).start()

    def report(phase: str, frac: float) -> None:
        if not args.quiet:
            print(f"\r[{phase}] {100 * frac:5.1f}%", end="", file=sys.stderr)
            if frac >= 1:
                print(file=sys.stderr)

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
