#!/bin/sh
# WordCount worker through the torch package's launcher (the reference's
# execute_example_worker.sh). Run from the root of the repository.
#   usage: ./execute_example_worker.sh COORD_DIR [extra args...]
COORD="${1:?usage: execute_example_worker.sh COORD_DIR [args...]}"; shift
exec python -m lua_mapreduce_tpu_torch.cli.execute_worker "$COORD" "$@"
