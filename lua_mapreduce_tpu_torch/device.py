"""Device resolution for the port's entry points.

Takes the role ``utils/jax_env.py::ensure_backend`` plays in the JAX
package, minus its fallback: an entry point runs on the card unless the
caller names the CPU, and asking for CUDA on a machine without it is an
error, never a silent move to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` (default ``"cuda"``) as a validated ``torch.device``.

    Raises RuntimeError when a CUDA device is asked for and none is
    available, and ValueError for any device type other than cuda/cpu.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r}; "
                         "use 'cuda' or 'cpu'")
    return dev
