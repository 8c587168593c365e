"""Build and load the port's native C++ host libraries.

Port of ``lua_mapreduce_tpu/core/native_build.py``: one discipline for
every native piece (``coord/native/jobstore.cpp``,
``core/native/{shufflemerge,wcmap}.cpp``). Each source compiles with the
host ``g++`` on first use and loads with ``ctypes``; the library is
cached under a SOURCE HASH (a checkout gives a source and a stale binary
the same mtimes), and a failed build reports ``None``: native code is an
optimization with a pure-Python fallback, never a requirement.

Unlike the JAX package, which writes its libraries beside the sources,
the port builds into ``<repo>/build/native/`` (listed in
``.gitignore``), next to the CUDA kernels' ``build/kernels/``. A library
compiles to a temporary name and is published with ``os.replace``, so
cold processes that race each other never load a half-written file.
``LMR_DISABLE_NATIVE=1`` turns every native path off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_cache: Dict[str, Optional[ctypes.CDLL]] = {}   # so path -> lib or None


def library_path(src: str) -> str:
    """Where ``src`` builds: ``build/native/lib<stem>.so``."""
    return str(BUILD_DIR / f"lib{Path(src).stem}.so")


def _src_digest(src: str) -> str:
    with open(src, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build(src: str, so: str, extra_flags: Sequence[str] = ()
           ) -> Optional[str]:
    """Compile ``src`` to ``so`` unless the cached library was built
    from the same source with the preferred flags; the path, or None
    when no flag variant builds."""
    digest_file = so + ".src.sha256"
    digest = _src_digest(src)
    variants = (tuple(extra_flags), ()) if extra_flags else ((),)
    # the digest file records WHICH flag variant built the cached library
    # ("<sha> <flags>"): one built bare (the optional library missing)
    # is retried with the preferred flags once per process, so
    # installing the library (zlib) upgrades it
    cached_flags = None
    if os.path.exists(so):
        try:
            with open(digest_file) as f:
                rec = f.read().strip().split(None, 1)
            if rec and rec[0] == digest:
                cached_flags = tuple((rec[1] if len(rec) > 1 else "").split())
                if cached_flags == variants[0]:
                    return so
        except OSError:
            pass
    os.makedirs(os.path.dirname(so), exist_ok=True)
    # extra flags are OPTIONAL capabilities (-DLMR_HAVE_ZLIB -lz for
    # compressed v2 frames): tried first, then bare — the source gates
    # the capability on the macro, so the bare build degrades features,
    # not correctness
    for flags in variants:
        if flags == cached_flags:
            return so
        tmp = f"{so}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-o", tmp,
                            src, *flags],
                           check=True, capture_output=True, timeout=180)
            os.replace(tmp, so)
            with open(tmp, "w") as f:
                f.write(f"{digest} {' '.join(flags)}".rstrip())
            os.replace(tmp, digest_file)
            return so
        except (OSError, subprocess.SubprocessError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            continue
    return None


def load_native(src: str, extra_flags: Sequence[str] = ()
                ) -> Optional[ctypes.CDLL]:
    """Build (if stale or absent) and load ``src``; None on any failure.
    One build attempt per library per process.

    ``LMR_DISABLE_NATIVE=1`` forces the pure-Python semantics for every
    load after it is set — a component that already holds a loaded
    library (a NativeJobIndex built earlier) keeps it, so set it at
    process start."""
    if os.environ.get("LMR_DISABLE_NATIVE") == "1":
        return None
    so = library_path(src)
    with _lock:
        if so in _cache:
            return _cache[so]
        path = _build(src, so, extra_flags)
        lib = None
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                lib = None
        _cache[so] = lib
        return lib
