"""ctypes facade over the native C++ wordcount map (wcmap.cpp).

Port of ``lua_mapreduce_tpu/core/native_wcmap.py``, over the port's own
copy of ``core/native/wcmap.cpp`` (built into ``build/native/``).

A task module opts in by tagging its mapfn:

    def mapfn(key, value, emit): ...              # the Python truth
    mapfn.native_map = {"kind": "wordcount_file",
                        "num_reducers": 15, "hash_prefix": 4}

The declaration is a PROMISE that the Python mapfn+partitionfn compute
exactly: whitespace-split word counts of the file at ``value``,
partitioned by byte-sum of the word's first ``hash_prefix`` bytes mod
``num_reducers`` (the reference examples' partition scheme,
partitionfn.lua:1-16). The engine (engine/job.py) then routes the map
job through one C++ pass — tokenize, count, partition, sort, serialize,
atomic per-partition publish — when the store is a local-path backend,
and falls back to the Python path otherwise (same discipline as
core/native_merge.py; golden-diffed in tests/test_torch_native_wcmap.py).
"""

from __future__ import annotations

import ctypes
import os
import uuid
from typing import Optional

from lua_mapreduce_tpu_torch.core.native_build import load_native

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "wcmap.cpp")


def _load() -> Optional[ctypes.CDLL]:
    lib = load_native(_SRC)
    if lib is not None and not hasattr(lib.wc_map_file, "_configured"):
        lib.wc_map_file.restype = ctypes.c_int
        lib.wc_map_file.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int]
        lib.wc_map_file._configured = True
    return lib


def native_available() -> bool:
    return _load() is not None


def run_native_map(store, spec_native: dict, input_path: str,
                   result_ns: str, job_id: str) -> bool:
    """Execute one wordcount map job natively. Returns False when the
    native path can't serve it (caller runs the Python mapfn instead):
    non-local store, missing input, no toolchain, or rc=2 (non-ASCII
    input whose tokenization Python must own)."""
    from lua_mapreduce_tpu_torch.engine.job import map_output_name

    local_path = getattr(store, "local_path", None)
    base_dir = getattr(store, "path", None)
    if local_path is None or base_dir is None or not native_available():
        return False
    if not os.path.isfile(input_path):
        return False
    n_red = int(spec_native["num_reducers"])
    prefix = int(spec_native.get("hash_prefix", 4))
    if n_red <= 0 or prefix < 0:
        # C++ would SIGFPE on % 0 — let the Python path raise cleanly
        return False

    # Publish discipline mirrors the Python path exactly: UNIQUE tmp
    # names (a stale-requeued twin of this job running concurrently must
    # not interleave writes with ours) and replace-only rename — a
    # published run file is never deleted, only atomically superseded.
    attempt = uuid.uuid4().hex[:8]
    finals, tmps = [], []
    for p in range(n_red):
        name = map_output_name(result_ns, p, job_id)
        finals.append(local_path(name))
        tmps.append(os.path.join(
            base_dir, f".tmp.wcmap.{job_id}.{os.getpid()}.{attempt}.{p}"))

    lib = _load()
    tmp_arr = (ctypes.c_char_p * n_red)(*[t.encode() for t in tmps])
    fin_arr = (ctypes.c_char_p * n_red)(*[f.encode() for f in finals])
    rc = lib.wc_map_file(input_path.encode(), tmp_arr, fin_arr,
                         n_red, prefix)
    for t in tmps:                      # rc!=0 can leave tmp files behind
        try:
            os.remove(t)
        except FileNotFoundError:
            pass
    if rc == 1:
        raise OSError(f"native wordcount map I/O error on {input_path}")
    return rc == 0
