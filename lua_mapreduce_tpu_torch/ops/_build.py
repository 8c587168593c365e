"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, from the sources in this checkout and nothing
else, into ``<repo>/build/kernels/`` (listed in ``.gitignore``). Library
names carry a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads at once; the hash also covers the
shared headers (``csrc/*.cuh``). The first call builds every
source, one ``nvcc`` process each, all started together. The build holds
an ``flock`` on ``BUILD_DIR/.build.lock``: processes that start cold
together (a server and its worker processes) run ``nvcc`` once between
them — the others wait, then find the libraries built.

Each library keeps its build's ``nvcc -Xptxas -v`` output beside it
(``<library>.ptxas.txt``), so that what ptxas said of a kernel can be
read on every run, not only on the one that built it
(:func:`ptxas_log`, :func:`ptxas_functions`).

Nothing here runs at import: the CPU tests import every module, and the
CPU machine has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"matmul": "matmul.cu", "softmax": "softmax.cu",
           "flash": "flash.cu", "flash_bwd": "flash_bwd.cu",
           "decode": "decode.cu", "q8": "q8.cu", "pool": "pool.cu"}
# --split-compile=0: a source's device code is optimised on every core
# (matmul.cu's ~50 kernel instantiations are the longest build)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of every entry point, by library
_SIGNATURES = {
    "matmul": {"lmr_matmul": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L,
                              _I, _I, _P],
               "lmr_matmul_splits": [_P, _P, _I, _I, _I, _L, _L, _L, _L,
                                     _I],
               "lmr_matmul_slab": [_P, _P, _I, _I, _I, _L, _L, _L, _L,
                                   _I],
               "lmr_matmul_plan": [_P, _P, _I, _I, _I, _L, _L, _L, _L, _I,
                                   _P],
               "lmr_matmul_plan_ex": [_P, _P, _I, _I, _I, _L, _L, _L, _L,
                                      _I, _P],
               "lmr_matmul_cluster_sms": [_P],
               "lmr_matmul_forced": [_P, _P, _P, _P, _I, _I, _I, _L, _L,
                                     _L, _L] + [_I] * 5 + [_P],
               "lmr_matmul_tma_available": []},
    "softmax": {"lmr_softmax": [_P, _P, _L, _I, _L] + [_I] * 7
                + [_L, _P]},
    "flash": {"lmr_flash_fwd": [_P] * 6 + [_I] * 5 + [_L] * 9 + [_I] * 5
              + [_P],
              "lmr_flash_path": [_P] * 3 + [_I] * 5 + [_L] * 9 + [_I],
              "lmr_flash_fwd_forced": [_P] * 5 + [_I] * 5 + [_L] * 9
              + [_I] * 4 + [_P],
              "lmr_flash_plan": [_I] * 8 + [_P, _I]},
    "flash_bwd": {**{fn: [_P] * 8 + [_I] * 5 + [_L] * 12 + [_I] * 4 + [_P]
                     for fn in ("lmr_flash_bwd_dq", "lmr_flash_bwd_dkv")},
                  "lmr_flash_bwd_path": [_P] * 4 + [_I] * 5 + [_L] * 12
                  + [_I],
                  "lmr_flash_bwd": [_P] * 10 + [_I] * 5 + [_L] * 12
                  + [_I] * 4 + [_P],
                  "lmr_flash_bwd_plan": [_I] * 4 + [_P],
                  "lmr_flash_bwd_prep": [_P] * 6 + [_I] * 8 + [_P]},
    "decode": {"lmr_decode": [_P] * 10 + [_I] * 6 + [_L] * 3 + [_I, _P],
               "lmr_decode_splits": [_I] * 5,
               "lmr_decode_combine": [_P] * 4 + [_I] * 4 + [_P]},
    "q8": {"lmr_q8_matmul": [_P] * 4 + [_I] * 5 + [_P],
           "lmr_q8_splits": [_I] * 3,
           "lmr_q8_prefill_plan": [_P] * 2 + [_I] * 4 + [_P],
           "lmr_q8_prefill_forced": [_P] * 4 + [_I] * 5 + [_P],
           "lmr_q8_plan": [_I] * 3 + [_P],
           "lmr_q8_gemv": [_P] * 4 + [_I] * 6 + [_P]},
    "pool": {"lmr_pool": [_P, _P] + [_I] * 18 + [_P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build did, for the smoke script's report
BUILD_REPORT: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    # the first-use build is serialised on purpose: every thread that
    # needs a kernel waits for it; the probe is a stat of a local file
    if cand.exists():  # lmr: disable=LMR029
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _target(name: str, csrc: Path = CSRC) -> Path:
    """The library path of source ``name``: its hash covers the source,
    every shared header in ``csrc`` (an edited header rebuilds what
    includes it) and the flags."""
    h = hashlib.sha256()
    h.update((csrc / SOURCES[name]).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lmr_{name}-{h.hexdigest()[:16]}.so"


def _build_missing() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel, under
    the cross-process build lock."""
    targets = {n: _target(n) for n in SOURCES}
    BUILD_REPORT.clear()
    BUILD_REPORT.update({"built": [], "seconds": 0.0, "ptxas": {}})
    # a stat of the local build dir under the serialised first-use build
    if all(t.exists() for t in targets.values()):  # lmr: disable=LMR029
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd = os.open(BUILD_DIR / ".build.lock", os.O_RDWR | os.O_CREAT, 0o666)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        # another process may have built them while this one waited
        _compile({n: t for n, t in targets.items()
                  if not t.exists()})  # lmr: disable=LMR029
    finally:
        os.close(fd)
    return targets


def _compile(todo: Dict[str, Path]) -> None:
    BUILD_REPORT["built"] = sorted(todo)
    if not todo:
        return
    nvcc = _nvcc()
    # the build's timing is host bookkeeping that no graph records (a
    # capture reaches the build only through a kernel's first use)
    t0 = time.perf_counter()  # lmr: disable=LMR017
    procs = {}
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_REPORT["ptxas"][name] = out
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            log = todo[name].with_suffix(".ptxas.txt")
            log_tmp = log.with_suffix(f".{os.getpid()}.tmp")
            log_tmp.write_text(out)
            os.replace(log_tmp, log)
            os.replace(tmp, todo[name])     # atomic publish, log first
    BUILD_REPORT["seconds"] = \
        time.perf_counter() - t0  # lmr: disable=LMR017
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def _load(path: Path, name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.lmr_error_string.argtypes = [ctypes.c_int]
    lib.lmr_error_string.restype = ctypes.c_char_p
    return lib


def build_all() -> Dict[str, object]:
    """Build (if needed) and load every kernel library; returns the
    build report (which sources were compiled, seconds, ptxas output)."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return {"built": [], "seconds": 0.0, "ptxas": {}}
        for name, path in _build_missing().items():
            _libs[name] = _load(path, name)
        return dict(BUILD_REPORT)


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of ``SOURCES``), building all
    kernels on first use."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def ptxas_log(name: str) -> str:
    """The ``nvcc -Xptxas -v`` output of the build of library ``name``'s
    current source, kept beside the library; raises if there is none (a
    library built before the logs were kept)."""
    log = _target(name).with_suffix(".ptxas.txt")
    if not log.exists():
        raise RuntimeError(f"no ptxas report beside {_target(name).name}: "
                           f"remove the library to rebuild it")
    return log.read_text()


def ptxas_functions(out: str) -> Dict[str, Tuple[int, int, bool]]:
    """``nvcc -Xptxas -v`` output → {function: (registers, spill bytes
    stored and loaded, serialised wgmma: a ptxas C75xx notice, C7512 for
    registers or C7514 for accumulators read in flight, named it)}."""
    funcs: Dict[str, list] = {}
    cur = None
    for line in out.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            funcs.setdefault(cur, [0, 0, False])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            funcs[cur][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            funcs[cur][0] = int(m.group(1))
        m = re.search(r"wgmma.mma_async instructions are serialized.*"
                      r"function '(\S+)'", line)
        if m:
            funcs.setdefault(m.group(1), [0, 0, False])[2] = True
    return {k: tuple(v) for k, v in funcs.items()}


def ptxas_serialisations(out: str) -> Dict[str, set]:
    """``nvcc -Xptxas -v`` output → {function: the reasons ptxas gave for
    serialising its wgmmas}: the text after "serialized" in each notice
    naming it (C7512's is "due to insufficient register resources";
    C7514's and the others' name the instructions or the control flow
    at fault)."""
    found: Dict[str, set] = {}
    for m in re.finditer(r"wgmma.mma_async instructions are serialized "
                         r"(.*?) (?:in|for) (?:the )?function '(\S+)'",
                         out):
        found.setdefault(m.group(2), set()).add(m.group(1))
    return found


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.lmr_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
