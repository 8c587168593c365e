"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, from the sources in this checkout and nothing
else, into ``<repo>/build/kernels/`` (listed in ``.gitignore``). Library
names carry a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads at once. The first call builds every
source, one ``nvcc`` process each, all started together.

Nothing here runs at import: the CPU tests import every module, and the
CPU machine has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"matmul": "matmul.cu", "softmax": "softmax.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of every entry point, by library
_SIGNATURES = {
    "matmul": {"lmr_matmul": [_P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _I,
                              _I, _P]},
    "softmax": {"lmr_rowwise_softmax": [_P, _P, _L, _I, _I, _I, _P]},
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
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / SOURCES[name]).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lmr_{name}-{h.hexdigest()[:16]}.so"


def _build_missing() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel."""
    targets = {n: _target(n) for n in SOURCES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    BUILD_REPORT.clear()
    BUILD_REPORT.update({"built": sorted(todo), "seconds": 0.0,
                         "ptxas": {}})
    if not todo:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
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
            os.replace(tmp, todo[name])     # atomic publish
    BUILD_REPORT["seconds"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


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
    """The loaded library ``name`` (``"matmul"`` or ``"softmax"``),
    building all kernels on first use."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = lib.lmr_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
