"""Roofline accounting: a card's peak FLOP/s and HBM rate, and MFU.

Copy of the JAX package's ``utils/roofline.py`` for CUDA cards. Model
FLOP helpers (``models/*/flops_per_example``, ``flops_per_token``) need
a denominator: the card's peak dense bf16 matmul FLOP/s. Known cards are
in a table keyed by ``torch.cuda.get_device_name``; anything else (the
CPU included) falls back to a measured big-matmul probe, so MFU stays
defined (if optimistically scaled) on CPU test boxes.
"""

from __future__ import annotations

import os
from typing import Optional

from lua_mapreduce_tpu_torch.device import resolve_device

# Per-card peak dense bf16 tensor-core FLOP/s, keyed by
# torch.cuda.get_device_name. NVIDIA data-sheet values (H100 Tensor Core
# GPU data sheet, dense, without sparsity), not measurements.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,    # H100 SXM5, 700 W
    "NVIDIA H100 PCIe": 756e12,         # H100 PCIe, 350 W
    "NVIDIA H100 NVL": 835e12,          # H100 NVL, 400 W
}

# Per-card HBM bandwidth (bytes/s), keyed like PEAK_BF16_FLOPS; the same
# data sheet's values, not measurements. The memory-roofline
# denominator: an op cannot finish faster than reading its inputs once
# at this rate.
PEAK_HBM_BYTES = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # HBM3
    "NVIDIA H100 PCIe": 2.0e12,         # HBM2e
    "NVIDIA H100 NVL": 3.9e12,          # HBM3
}


def _device_kind(device) -> str:
    """The table key of ``device``: the card's name, or ``"cpu"``."""
    if device.type == "cuda":
        import torch
        return torch.cuda.get_device_name(device)
    return device.type


def peak_hbm_bytes_per_s(device=None) -> Optional[float]:
    """Peak HBM bandwidth of one card, or None when the card is unknown
    (no probe fallback: a bandwidth probe measures caches as much as
    memory, and a consumer that needs the figure skips its check when
    this is None)."""
    env = os.environ.get("LMR_PEAK_HBM_BYTES")
    if env:
        return float(env)
    return PEAK_HBM_BYTES.get(_device_kind(resolve_device(device)))


_probe_cache: dict = {}


def peak_flops_per_s(device=None) -> float:
    """Peak dense bf16 FLOP/s of one card.

    Resolution order: ``LMR_PEAK_FLOPS`` env override → known-card table
    → measured probe (timed n³ bf16 matmul — a floor on peak, so MFU
    against it is an upper bound; fine for CPU test boxes). ``device``
    defaults to the port's default device (``device.resolve_device``).
    """
    env = os.environ.get("LMR_PEAK_FLOPS")
    if env:
        return float(env)
    device = resolve_device(device)
    kind = _device_kind(device)
    if kind in PEAK_BF16_FLOPS:
        return PEAK_BF16_FLOPS[kind]
    # smaller probe off the card: resolution does not need a 4096³
    # product on a CPU test box
    return _measured_peak(device, n=1024 if device.type == "cpu" else 4096)


def best_time(fn, reps: int = 3) -> float:
    """Best wall time of ``fn()`` over ``reps`` calls. ``fn`` must force
    completion itself (``torch.cuda.synchronize()`` after a card's work:
    a launch returns before the kernel runs, yielding impossible
    throughputs)."""
    import time

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _measured_peak(device, n: int = 4096) -> float:
    """Best achieved FLOP/s over a few timed n³ bf16 matmuls."""
    import torch

    device = resolve_device(device)
    key = (str(device), n)
    if key in _probe_cache:
        return _probe_cache[key]
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=device,
                    dtype=torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=device,
                    dtype=torch.bfloat16)

    def run():
        torch.matmul(a, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()                        # warm: the library's first-call set-up
    peak = 2 * n ** 3 / best_time(run)
    _probe_cache[key] = peak
    return peak


def mfu(model_flops: float, seconds: float, n_chips: int = 1,
        device=None) -> float:
    """Model FLOP utilization in [0,1]: counted model FLOPs per second
    as a fraction of ``n_chips`` × card peak."""
    return model_flops / seconds / (n_chips * peak_flops_per_s(device))
