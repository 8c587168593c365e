#!/bin/sh
# WordCount server through the torch package's launcher (the reference's
# execute_example_server.sh): the unchanged WordCount modules of
# examples/wordcount, wired into the generic server; extra args pass
# through (e.g. --storage shared:/tmp/spill --inline-workers 2, or
# --init-arg device=cpu on a machine with no card). Run from the root of
# the repository.
#   usage: ./execute_example_server.sh COORD_DIR [extra args...]
COORD="${1:?usage: execute_example_server.sh COORD_DIR [args...]}"; shift
exec python -m lua_mapreduce_tpu_torch.cli.execute_server "$COORD" \
    examples/wordcount/taskfn examples/wordcount/mapfn \
    examples/wordcount/partitionfn examples/wordcount/reducefn \
    --combinerfn examples/wordcount/reducefn \
    --finalfn examples/wordcount/finalfn "$@"
