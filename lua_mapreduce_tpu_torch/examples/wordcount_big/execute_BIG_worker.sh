#!/bin/sh
# Europarl-scale WordCount worker through the torch package's launcher
# (the reference's execute_BIG_worker.sh). Run from the root of the
# repository.
#   usage: ./execute_BIG_worker.sh COORD_DIR [extra args...]
COORD="${1:?usage: execute_BIG_worker.sh COORD_DIR [args...]}"; shift
exec python -m lua_mapreduce_tpu_torch.cli.execute_worker "$COORD" \
    --max-iter 100000 --max-tasks 100000 "$@"
