"""Result/coordination cleanup launcher.

Port of ``lua_mapreduce_tpu/cli/remove_results.py`` (reference
remove_results.sh:1-9, which drops the whole task database): drop the
job store's task state (map/reduce namespaces, task doc, errors) and
delete the task's result files from storage.

    python -m lua_mapreduce_tpu_torch.cli.remove_results COORD_DIR \\
        [--storage SPEC] [--result-ns NS] [--yes]

COORD_DIR may be a FileJobStore directory or "mem" (no-op for the
store half — in-process stores die with their process).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="remove_results",
        description="Drop a task's coordination state and results "
                    "(remove_results.sh analog).")
    p.add_argument("coord", help="job-store directory, or 'mem'")
    p.add_argument("--storage", default=None,
                   help="also delete this storage spec's task files "
                        "(backend[:path])")
    p.add_argument("--result-ns", default="result")
    p.add_argument("--yes", action="store_true",
                   help="skip the confirmation prompt")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.yes:
        try:
            reply = input(f"drop task state in {args.coord!r}"
                          + (f" and files under {args.storage!r}"
                             if args.storage else "")
                          + "? [y/N] ")
        except (EOFError, KeyboardInterrupt):
            reply = ""          # no TTY without --yes = no
        if reply.strip().lower() not in ("y", "yes"):
            print("aborted", file=sys.stderr)
            return 1

    if args.coord != "mem":
        from lua_mapreduce_tpu_torch.coord.filestore import FileJobStore
        from lua_mapreduce_tpu_torch.core.constants import MAP_NS, RED_NS
        store = FileJobStore(args.coord)
        store.drop_ns(MAP_NS)
        store.drop_ns(RED_NS)
        store.delete_task()
        store.drain_errors()
        print(f"dropped {MAP_NS}/{RED_NS}/task/errors in {args.coord}")

    if args.storage:
        from lua_mapreduce_tpu_torch.store.router import get_storage_from
        data = get_storage_from(args.storage)
        removed = 0
        for name in data.list(f"{args.result_ns}.P*"):
            data.remove(name)
            removed += 1
        print(f"removed {removed} file(s) under {args.result_ns}.P* "
              f"in {args.storage}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
