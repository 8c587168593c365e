"""conv2d — im2col + the matmul kernel.

Port of ``lua_mapreduce_tpu/ops/conv.py``. A convolution is a matmul in
disguise: the (KH·KW·Cin) patch matrix is cut out with KH·KW strided
slices and one ``torch.cat`` (plain data movement, as XLA does it
outside any Pallas kernel in the JAX package), and every FLOP goes
through ``ops.matmul`` — on a CUDA tensor the hand-written matmul kernel
(``csrc/matmul.cu``) with its custom backward, on a CPU tensor its plain
version. conv2d has no kernel of its own, in either package.

Layouts are the JAX package's: activations NHWC, weights HWIO, so
parameters cross from JAX unchanged and the patch order (kh, kw, c)
matches ``w.reshape(kh*kw*cin, cout)``.

``conv2d_plain`` (``F.conv2d`` on NCHW views) plays the role of the JAX
op's ``backend="xla"`` ``lax.conv_general_dilated``: an independent
oracle for the tests. It never runs on the main path.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from lua_mapreduce_tpu_torch.ops.matmul import matmul

Padding = Union[str, int, Tuple[int, int]]


def _norm_stride(s) -> Tuple[int, int]:
    return (s, s) if isinstance(s, int) else tuple(s)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF-style SAME: output = ceil(size/s), low/high pads may differ
    (symmetric (k-1)//2 shrinks the output for even kernels)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return (total // 2, total - total // 2)


def _norm_padding(padding: Padding, kh: int, kw: int, h: int, w: int,
                  sh: int, sw: int):
    """→ ((ph_lo, ph_hi), (pw_lo, pw_hi))."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return ((0, 0), (0, 0))
        if p == "SAME":
            return (_same_pads(h, kh, sh), _same_pads(w, kw, sw))
        raise ValueError(f"unknown padding {padding!r}")
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    ph, pw = padding
    return ((ph, ph), (pw, pw))


def _pad_hw(x: torch.Tensor, ph, pw, value: float = 0.0) -> torch.Tensor:
    """Pad the H and W axes of an NHWC tensor (``F.pad`` takes its pads
    last axis first: C, then W, then H)."""
    if not (any(ph) or any(pw)):
        return x
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=value)


def _im2col(x: torch.Tensor, kh: int, kw: int, sh: int, sw: int):
    """(N,H,W,C) → (N,Ho,Wo,KH·KW·C) patch tensor via KH·KW strided
    slices; patch order (kh, kw, c) matches the HWIO weight reshape."""
    n, h, w, c = x.shape
    ho = (h - kh) // sh + 1
    wo = (w - kw) // sw + 1
    if ho <= 0 or wo <= 0:
        raise ValueError(f"window {kh}x{kw} larger than the padded input "
                         f"{h}x{w}")
    cols = [x[:, i:i + (ho - 1) * sh + 1:sh, j:j + (wo - 1) * sw + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(cols, dim=-1), ho, wo


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           *, stride=1, padding: Padding = "VALID") -> torch.Tensor:
    """2-D convolution, NHWC × HWIO → NHWC, as im2col + ``ops.matmul``
    (f32 accumulation, output in x's dtype); differentiable."""
    kh, kw, cin, cout = w.shape
    sh, sw = _norm_stride(stride)
    ph, pw = _norm_padding(padding, kh, kw, x.shape[1], x.shape[2], sh, sw)
    x = _pad_hw(x, ph, pw)
    patches, ho, wo = _im2col(x, kh, kw, sh, sw)
    n = x.shape[0]
    out = matmul(patches.reshape(n * ho * wo, kh * kw * cin),
                 w.reshape(kh * kw * cin, cout), out_dtype=x.dtype)
    out = out.reshape(n, ho, wo, cout)
    if b is not None:
        out = out + b
    return out


def conv2d_plain(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *, stride=1,
                 padding: Padding = "VALID") -> torch.Tensor:
    """The oracle: ``F.conv2d`` on NCHW/OIHW views of the same operands,
    after the same (possibly asymmetric) padding."""
    kh, kw, _, _ = w.shape
    sh, sw = _norm_stride(stride)
    ph, pw = _norm_padding(padding, kh, kw, x.shape[1], x.shape[2], sh, sw)
    x = _pad_hw(x, ph, pw)
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   stride=(sh, sw)).permute(0, 2, 3, 1)
    if b is not None:
        out = out + b
    return out
