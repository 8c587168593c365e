"""Weight-only int8 matmul — the kernel and its plain version.

Port of ``lua_mapreduce_tpu/ops/q8.py``: the Pallas ``_q8_kernel``
becomes ``csrc/q8.cu`` (its source note says what bounds it and what
the design does about it). Quantization is symmetric per output
channel, q = round(w / s), s = max|w_col| / 127, so the scale factors
out of the contraction and is applied once to the f32 accumulator. The
kernel casts x to bf16 before the product (as the TPU kernel does); the
plain version dequantizes and multiplies in f32 (the JAX op's XLA
path), so the two agree to a bf16 rounding of x.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lua_mapreduce_tpu_torch.ops import _build, count_launch, device_kind

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_q8(w: torch.Tensor, axis: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-channel int8: returns (q int8, s f32) with
    w ≈ q · s broadcast along ``axis`` (the contraction axis — scales
    live per output channel). For a (K, N) weight use axis=0."""
    wf = w.float()
    s = wf.abs().amax(dim=axis, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(wf / s), -127, 127)
    return q.to(torch.int8), s


def q8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                    ) -> torch.Tensor:
    """The plain version (the JAX op's ``_dequant_matmul_xla``):
    dequantize, then an f32 product, cast to x's dtype."""
    w = q.float() * s.reshape(1, -1).float()
    return torch.matmul(x.float(), w).to(x.dtype)


def q8_matmul_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
                   ) -> torch.Tensor:
    """Launch ``csrc/q8.cu`` on CUDA tensors x (M, K) f32/bf16, q (K, N)
    int8, s (N,); returns a contiguous (M, N) in x's dtype."""
    if x.dtype not in _CODES:
        raise TypeError(f"q8 kernel takes float32/bfloat16 x, got {x.dtype}")
    m, k = x.shape
    n = q.shape[1]
    x, q = x.contiguous(), q.contiguous()
    s = s.reshape(-1).float().contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    lib = _build.library("q8")
    with torch.cuda.device(x.device):
        # the kernel's K-split policy lives in csrc/q8.cu; it says how
        # much f32 scratch the split needs
        splits = lib.lmr_q8_splits(m, k, n)
        if splits < 1:
            raise ValueError(f"q8 kernel does not take M={m}, K={k}, N={n} "
                             f"(M past its grid limit)")
        part = (torch.empty((splits, m, n), dtype=torch.float32,
                            device=x.device) if splits > 1 else None)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmr_q8_matmul(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                               out.data_ptr(),
                               part.data_ptr() if part is not None else None,
                               m, k, n, _CODES[x.dtype], stream)
    _build.check(lib, rc, "q8 kernel launch")
    count_launch("q8")
    return out


def q8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
              ) -> torch.Tensor:
    """x (M, K) @ dequant(q (K, N), s (N,)) → (M, N) in x's dtype.

    CPU tensors take the plain version, CUDA tensors the kernel."""
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"x and q must be rank-2; got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}")
    if x.shape[1] != q.shape[0]:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)} vs q "
                         f"{tuple(q.shape)}")
    if q.dtype != torch.int8:
        raise ValueError(f"q must be int8, got {q.dtype}")
    if s.numel() != q.shape[1]:
        raise ValueError(f"scale has {s.numel()} entries for {q.shape[1]} "
                         f"output channels")
    if device_kind(x, q, s) == "cpu":
        return q8_matmul_plain(x, q, s)
    return q8_matmul_cuda(x, q, s)


def utest() -> None:
    """Quantization round-trip + matmul parity at f32 tolerances, on CPU
    tensors (the plain version; the kernel is held on the card by
    ``chip_smoke.py``)."""
    import numpy as np

    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(64, 96).astype(np.float32))
    q, s = quantize_q8(w)
    err = float((q.float() * s - w).abs().max())
    assert err <= float(w.abs().max()) / 127.0 + 1e-6
    x = torch.from_numpy(rng.randn(4, 64).astype(np.float32))
    got = q8_matmul(x, q, s.reshape(-1))
    want = x @ (q.float() * s)
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
