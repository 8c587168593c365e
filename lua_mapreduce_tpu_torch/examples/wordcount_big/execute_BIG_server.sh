#!/bin/sh
# Europarl-scale WordCount server through the torch package's launcher
# (the reference's execute_BIG_server.sh): the unchanged single-module
# task examples/wordcount_big/bigtask over a 197-split corpus. bigtask
# tags its mapfn for the native C++ word-count map and its reducefn for
# the fused native sum, which run when the storage is shared: and the
# toolchain builds (else the Python functions run, with the same bytes).
# A corpus directory without split196.txt is generated first (~350 MB).
# Extra args pass through (e.g. --storage shared:/tmp/spill
# --inline-workers 4). Run from the root of the repository.
#   usage: ./execute_BIG_server.sh COORD_DIR CORPUS_DIR [extra args...]
COORD="${1:?usage: execute_BIG_server.sh COORD_DIR CORPUS_DIR [args...]}"
CORPUS="${2:?usage: execute_BIG_server.sh COORD_DIR CORPUS_DIR [args...]}"
shift 2
exec python -m lua_mapreduce_tpu_torch.cli.execute_server "$COORD" \
    examples/wordcount_big/bigtask examples/wordcount_big/bigtask \
    examples/wordcount_big/bigtask examples/wordcount_big/bigtask \
    --init-arg "corpus_dir=$CORPUS" "$@"
