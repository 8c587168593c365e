"""Device-level tracing through ``torch.profiler``.

Port of ``lua_mapreduce_tpu/utils/profiling.py``: the interesting time
of an accelerator run is inside the step — kernels, copies, the gaps
between them — which only the profiler sees. :func:`device_trace`
wraps a region in a ``torch.profiler`` trace written into a directory
as a Chrome trace (``chrome://tracing``, Perfetto, TensorBoard's
profile plugin); ``train_lm --profile``, ``TrainConfig.profile_dir`` and
the MapReduce CLIs' ``--profile`` use it. :func:`annotate` names a host span inside the trace, and
:func:`maybe_annotate` does so without ever failing the traced work.

On a card, CUDA activity is traced with the host's; kernels replayed
from a captured CUDA graph appear as the trace's CUPTI layer lists them.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace everything inside the ``with`` to ``log_dir`` (created if
    missing): host operators and annotations, and on a card the CUDA
    kernels. The trace lands as ``<host>.<pid>.<ns>.pt.trace.json`` when
    the block exits."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 experimental_config=_all_threads_config()) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir, name + ".pt.trace.json"))


def _all_threads_config():
    """Kineto's option to record every thread's host annotations (an
    in-process pool runs its job bodies on worker threads), where this
    torch build has it; None (the calling thread only) where not."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def annotate(name: str):
    """Named sub-span inside a :func:`device_trace`
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


def capturing() -> bool:
    """True while the current CUDA stream is being captured into a
    graph (no profiler range may open there)."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def maybe_annotate(name: str):
    """Best-effort :func:`annotate`: a no-op context when the profiler's
    span cannot be made. Telemetry must never sink a job body."""
    try:
        return annotate(name)
    except Exception:
        return contextlib.nullcontext()
