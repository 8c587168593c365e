"""ctypes facade over the native C++ shuffle merge.

Port of ``lua_mapreduce_tpu/core/native_merge.py``, over the port's own
copy of ``core/native/shufflemerge.cpp``. Build/load discipline is the
shared one (core/native_build.py; the library lands in
``build/native/``): the
native path is an OPTIMIZATION of core/merge.py's merge_iterator, never a
requirement — both produce identical merged groups (tests golden-diff
them), so a box without g++ just runs the Python heap merge, and ANY
native failure (including records only the Python parser understands)
falls back the same way.

The native merge applies when every run file is a local POSIX path (the
SharedStore backend exposes ``local_path``); other backends keep the
streaming Python path, exactly how the reference routes gridfs/sshfs
through different iterators (fs.lua:185-208). Tradeoff: the C++ pass
materializes the merged partition as one file (written next to the run
files, same real filesystem — NOT the system tmpfs) before the reduce
fold starts, buying a single-pass merge at the cost of the Python path's
record-at-a-time streaming; partitions too big for that are what the
fallback is for.
"""

from __future__ import annotations

import ctypes
import os
import tempfile
from typing import Iterator, List, Optional, Sequence, Tuple

from lua_mapreduce_tpu_torch.core.native_build import load_native
from lua_mapreduce_tpu_torch.core.serialize import load_record

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "shufflemerge.cpp")


def _load() -> Optional[ctypes.CDLL]:
    # zlib is an optional capability: with it the C++ pass decodes
    # compressed v2 segment frames; without it those runs fall back to
    # the Python reader (rc=2), raw-codec segments still decode natively
    lib = load_native(_SRC, extra_flags=("-DLMR_HAVE_ZLIB", "-lz"))
    if lib is not None and not hasattr(lib.smerge_files, "_configured"):
        for fn in (lib.smerge_files, lib.smerge_fold_sum):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                           ctypes.c_char_p]
        lib.smerge_files._configured = True
    return lib


def native_available() -> bool:
    return _load() is not None


def merge_paths(paths: Sequence[str], out_path: str) -> None:
    """Merge sorted run files at local ``paths`` into ``out_path``
    (equal-key value lists concatenated in run order). Raises on
    failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native shuffle merge unavailable")
    arr = (ctypes.c_char_p * len(paths))(
        *[p.encode() for p in paths])
    rc = lib.smerge_files(arr, len(paths), out_path.encode())
    if rc == 1:
        raise OSError(f"native merge I/O error over {list(paths)}")
    if rc:
        raise ValueError(f"native merge parse error over {list(paths)}")


def _local_run_paths(store, filenames: Sequence[str]
                     ) -> Optional[List[str]]:
    """Shared gate for both native entry points: every run must be a
    local POSIX path and the toolchain must have built. None = caller
    falls back to the Python path."""
    local_path = getattr(store, "local_path", None)
    if local_path is None or not native_available():
        return None
    paths = []
    for name in filenames:
        p = local_path(name)
        if not os.path.exists(p):
            return None
        paths.append(p)
    return paths


def native_merge_reduce_sum(store, filenames: Sequence[str],
                            result_store, result_file: str) -> bool:
    """Fused merge+reduce: fold every merged group with an int64 sum IN
    the C++ pass and publish the partition result file directly — the
    whole reduce job in one native pass, for reducers declared
    ``native_reduce = "sum"`` (run_reduce_job gates on the ACI flags
    too). Returns False when the native path can't serve it (non-local
    stores, toolchain, non-integer values, int64 overflow) — the caller
    falls back to the Python merge+fold, which is the semantic truth.
    """
    dst_path = getattr(result_store, "local_path", None)
    dst_dir = getattr(result_store, "path", None)
    paths = _local_run_paths(store, filenames)
    if paths is None or dst_path is None or dst_dir is None:
        return False

    lib = _load()
    fd, tmp = tempfile.mkstemp(prefix=".tmp.redsum.", suffix=".jsonl",
                               dir=dst_dir)
    os.close(fd)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.smerge_fold_sum(arr, len(paths), tmp.encode())
    if rc:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        # rc=1 I/O (e.g. a run deleted by a duplicate job between the
        # exists() precheck and the C++ open) and rc=2 shape fallback
        # both route to the Python fold — ANY native failure falls back,
        # the module's contract
        return False
    # builder durability discipline: fsync before the atomic publish
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, dst_path(result_file))
    return True


def native_premerge(store, filenames: Sequence[str], out_name: str) -> bool:
    """Whole pre-merge job in one native pass: merge sorted runs at local
    paths and publish the consolidated spill run atomically under
    ``out_name`` — no Python parse/re-dump round trip. Returns False when
    the native path can't serve it (non-local store, no toolchain, parser
    rejects a record); the caller falls back to the streaming Python
    merge, which is the semantic truth."""
    dst_path = getattr(store, "local_path", None)
    dst_dir = getattr(store, "path", None)
    paths = _local_run_paths(store, filenames)
    if paths is None or dst_path is None or dst_dir is None:
        return False
    fd, tmp = tempfile.mkstemp(prefix=".tmp.spill.", suffix=".jsonl",
                               dir=dst_dir)
    os.close(fd)
    try:
        merge_paths(paths, tmp)
    except (OSError, ValueError, RuntimeError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False
    # builder durability discipline: fsync before the atomic publish
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, dst_path(out_name))
    return True


def native_merge_records(store, filenames: Sequence[str]
                         ) -> Optional[Iterator[Tuple[object, List[object]]]]:
    """merge_iterator-compatible stream via the native pass, or ``None``
    when the native path can't serve these runs — wrong store type, no
    toolchain, or records the C++ parser rejects (e.g. NaN keys, which
    json.dumps emits as bare ``NaN``). The merge runs EAGERLY here so
    every failure mode surfaces as None (caller falls back) rather than
    as an exception mid-reduce."""
    paths = _local_run_paths(store, filenames)
    if paths is None:
        return None

    out_dir = getattr(store, "path", None) or tempfile.gettempdir()
    fd, out = tempfile.mkstemp(prefix=".tmp.merge.", suffix=".jsonl",
                               dir=out_dir)
    os.close(fd)
    try:
        merge_paths(paths, out)
    except (OSError, ValueError, RuntimeError):
        try:
            os.unlink(out)
        except OSError:
            pass
        return None

    # Unlink eagerly: POSIX keeps the open fd readable, and the
    # partition-sized temp must not leak into the spill dir if the reduce
    # fold raises (or the worker dies) before exhausting the stream.
    f = open(out)
    try:
        os.unlink(out)
    except OSError:
        pass

    def stream() -> Iterator[Tuple[object, List[object]]]:
        with f:
            for line in f:
                line = line.strip()
                if line:
                    yield load_record(line)

    return stream()
