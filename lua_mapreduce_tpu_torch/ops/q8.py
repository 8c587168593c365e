"""Weight-only int8 matmul — the kernel and its plain version.

Port of ``lua_mapreduce_tpu/ops/q8.py``: the Pallas ``_q8_kernel``
becomes ``csrc/q8.cu`` (its source note says what bounds it and what
the design does about it): a GEMV for M <= GEMV_MAX_M (:func:`gemv_plan`
mirrors its plan) and, past it, a wgmma kernel with the int8 weight as
the A operand widened in registers (:func:`prefill_plan` mirrors its
plan, :func:`q8_prefill_plan` reports the card's). Quantization is
symmetric per output channel, q = round(w / s), s = max|w_col| / 127,
so the scale factors out of the contraction and is applied once to the
f32 accumulator. The kernel casts x to bf16 before the product (as the
TPU kernel does); the plain version dequantizes and multiplies in f32
(the JAX op's XLA path), so the two agree to a bf16 rounding of x.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from lua_mapreduce_tpu_torch.ops import _build, count_launch, device_kind

_CODES = {torch.float32: 0, torch.bfloat16: 1}

# csrc/q8.cu's GEMV (M <= GEMV_MAX_M) launch constants, as it defines
# them: threads a CTA, the largest cluster along K, x's rows staged at
# a time, the k rows a thread has in flight (its ring's stages), the
# strip widths (widest first), and the byte permute that widens int8 (a
# sign flip, the exponent of 2^23, a selector) less its bias 2^23 + 128
GEMV_NT = 256
GEMV_MAX_M = 8
GEMV_MAX_CLUSTER = 8
GEMV_XCH = 1024
GEMV_CTA_COST = 4
GEMV_STAGES = 8
GEMV_COLS = (128, 64, 32)
GEMV_SIGN_FLIP = 0x80808080
GEMV_MAGIC = 0x4B000000
GEMV_PERM = 0x7440
GEMV_WIDEN_BIAS = 8388736.0
_CPT = 16                        # int8 columns a thread loads (16 bytes)

# csrc/q8.cu's prefill (M > GEMV_MAX_M) constants, as it defines them:
# output channels a tile, its tokens (PF_F32_TOKENS for an f32 output),
# threads a block, the shared memory a block's ring and C tile may hold,
# the most stages, the byte selectors of its widening (bytes 0, 2 and
# 1, 3 of a word under bf16 128's exponent byte), the routes
# lmr_q8_prefill_plan reports and lmr_q8_prefill_forced takes
PF_CHANNELS = 128
PF_TOKENS = 208
PF_F32_TOKENS = 128
PF_THREADS = 384
PF_SMEM_BUDGET = 232192
PF_MAX_STAGES = 8
PF_PERM_LO = 0x4240
PF_PERM_HI = 0x4341
PF_KIND_RS, PF_KIND_GENERAL = 0, 1
PF_ROUTES = {"rs": PF_KIND_RS, "general": PF_KIND_GENERAL}


class GemvPlan(NamedTuple):
    """One launch of csrc/q8.cu's GEMV: ``strips`` CTAs of ``cols``
    output columns along grid x, ``split`` CTAs along K (one cluster)
    along grid y, each taking ``kper`` rows of K (the last fewer)."""
    cols: int
    split: int
    kper: int
    strips: int

    @property
    def ctas(self) -> int:
        return self.strips * self.split

    @property
    def k_lanes(self) -> int:
        """The k rows a CTA's threads load in one step (KSB)."""
        return GEMV_NT * _CPT // self.cols


def gemv_mt(m: int) -> int:
    """The M the kernel is instantiated for: 1, 2, 4 or 8 rows."""
    return 1 if m == 1 else 2 if m == 2 else 4 if m <= 4 else 8


def gemv_smem_bytes(m: int, cols: int) -> int:
    """Shared memory of a GEMV CTA for ``m`` rows and ``cols``-wide
    strips: the weight ring (16 bytes a thread a stage), x's chunk (whose
    bytes the warps' partials reuse) and the CTA's sums its cluster
    reads."""
    mt = gemv_mt(m)
    return (GEMV_STAGES * GEMV_NT * _CPT + 4 * (
        max(GEMV_XCH * mt, GEMV_NT // 32 * mt * cols) + mt * cols))


def gemv_plan(k: int, n: int, cluster_sms: Sequence[int]) -> GemvPlan:
    """Mirror of csrc/q8.cu::gemv_plan. ``cluster_sms[i]``: the SMs a
    cluster of 2**i CTAs can use (``q8_gemv_plan`` reads the card's).
    Minimises the busiest SM's work, ceil(CTAs / cluster_sms) · (k steps
    a thread + GEMV_CTA_COST · x chunks), over the strip widths and the
    power-of-two splits up to GEMV_MAX_CLUSTER (and K's steps); ties go
    to the wider strip, then the smaller split."""
    best, best_cost = None, None
    for cols in GEMV_COLS:
        strips = -(-n // cols)
        ksb = GEMV_NT * _CPT // cols
        steps = -(-k // ksb)
        split, lg = 1, 0
        while split <= GEMV_MAX_CLUSTER and (split == 1 or split <= steps):
            kper = -(-k // split)
            chunks = -(-kper // GEMV_XCH)
            per_sm = -(-(strips * split) // cluster_sms[lg])
            cost = per_sm * (-(-kper // ksb) + GEMV_CTA_COST * chunks)
            if best is None or cost < best_cost:
                best, best_cost = GemvPlan(cols, split, kper, strips), cost
            split, lg = split * 2, lg + 1
    return best


class PrefillPlan(NamedTuple):
    """One launch of csrc/q8.cu's prefill kernel: tiles of PF_CHANNELS
    channels × ``tokens`` tokens, a ring of ``stages``, ``ctas``
    persistent blocks."""
    tokens: int
    stages: int
    tiles: int
    ctas: int


def prefill_stages(tokens: int, out_f32: bool) -> int:
    """Stages of the prefill kernel's ring (csrc/q8.cu's pf::Layout): as
    many {x tile, int8 tile} stages as fit in PF_SMEM_BUDGET beside the
    staged C tile and 1 KB of alignment, at most PF_MAX_STAGES."""
    stage = tokens * 64 * 2 + 64 * PF_CHANNELS
    c_tile = tokens * PF_CHANNELS * (4 if out_f32 else 2)
    return min((PF_SMEM_BUDGET - 1024 - c_tile) // stage, PF_MAX_STAGES)


def prefill_smem_bytes(tokens: int, out_f32: bool) -> int:
    """The prefill kernel's dynamic shared memory (pf::Layout::DYN)."""
    return (prefill_stages(tokens, out_f32) * (tokens * 64 * 2 + 64 *
                                               PF_CHANNELS)
            + tokens * PF_CHANNELS * (4 if out_f32 else 2) + 1024)


def prefill_tokens(out_f32: bool) -> int:
    """The prefill kernel's token width for this output dtype."""
    return PF_F32_TOKENS if out_f32 else PF_TOKENS


def prefill_plan(m: int, n: int, out_f32: bool, sms: int) -> PrefillPlan:
    """Mirror of csrc/q8.cu::prefill_plan: the token width of the output
    dtype, its ring's stages, the tiles of PF_CHANNELS channels × that
    width, and a persistent grid of at most one block an SM."""
    b = prefill_tokens(out_f32)
    tiles = -(-m // b) * -(-n // PF_CHANNELS)
    return PrefillPlan(b, prefill_stages(b, out_f32), tiles, min(tiles, sms))


def q8_prefill_plan(x: torch.Tensor, q: torch.Tensor,
                    out_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[str, PrefillPlan, int]:
    """The route (a PF_ROUTES key), the plan and the SM count csrc/q8.cu
    takes for an M > GEMV_MAX_M product of these CUDA operands (x as the
    kernel reads it: bf16, the wrapper rounding an f32 x first) on their
    card. The general kernel's plan is all zeros."""
    m, k = x.shape
    n = q.shape[1]
    out_dtype = out_dtype or x.dtype
    xk = x.contiguous().to(torch.bfloat16)
    lib = _build.library("q8")
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(x.device):
        rc = lib.lmr_q8_prefill_plan(xk.data_ptr(), q.contiguous().data_ptr(),
                                     m, k, n, _CODES[out_dtype],
                                     ctypes.addressof(out))
    _build.check(lib, rc, f"q8 prefill plan for M={m}, K={k}, N={n}")
    route = {v: r for r, v in PF_ROUTES.items()}[out[0]]
    return route, PrefillPlan(*out[1:5]), out[5]


def q8_prefill_forced(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      route: str) -> torch.Tensor:
    """An M > GEMV_MAX_M product by a given route on CUDA tensors: "rs"
    (the prefill kernel at its plan) or "general" (the general kernel,
    which the main path takes only for layouts TMA cannot read) — for
    the tests and for timing the general kernel. x is rounded to bf16
    first, as the main path does. Raises on a route that cannot take the
    operands."""
    m, k = x.shape
    n = q.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    xk = x.contiguous().to(torch.bfloat16)
    q, s = q.contiguous(), s.reshape(-1).float().contiguous()
    lib = _build.library("q8")
    with torch.cuda.device(x.device):
        rc = lib.lmr_q8_prefill_forced(
            xk.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, k,
            n, _CODES[x.dtype], PF_ROUTES[route],
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, f"q8 prefill launch by {route}")
    count_launch("q8")
    return out


def q8_gemv_plan(m: int, k: int, n: int
                 ) -> Tuple[GemvPlan, Tuple[int, ...]]:
    """The plan csrc/q8.cu launches for an M <= 8 shape on the current
    card, and the SMs clusters of 1, 2, 4 and 8 CTAs can use there (the
    occupancy query's, which the plan reads)."""
    lib = _build.library("q8")
    out = (ctypes.c_int * 8)()
    _build.check(lib, lib.lmr_q8_plan(m, k, n, ctypes.addressof(out)),
                 f"q8 plan for M={m}, K={k}, N={n}")
    return GemvPlan(*out[:4]), tuple(out[4:])


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
    # past the GEMV the kernels read a bf16 x: an f32 x is rounded first,
    # as the TPU kernel casts x before the dot (the GEMV rounds it itself)
    xk = x if m <= GEMV_MAX_M else x.to(torch.bfloat16)
    lib = _build.library("q8")
    with torch.cuda.device(x.device):
        # the kernel's split policy lives in csrc/q8.cu; an M <= 8 split
        # is summed inside the launch, so nothing but out is allocated
        if lib.lmr_q8_splits(m, k, n) < 1:
            raise ValueError(f"q8 kernel does not take M={m}, K={k}, N={n} "
                             f"(M past its grid limit)")
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmr_q8_matmul(xk.data_ptr(), q.data_ptr(), s.data_ptr(),
                               out.data_ptr(), m, k, n, _CODES[xk.dtype],
                               _CODES[out.dtype], stream)
    _build.check(lib, rc, "q8 kernel launch")
    count_launch("q8")
    return out


def q8_gemv_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 cols: int, split: int) -> torch.Tensor:
    """The GEMV (M <= 8) at a given strip width and split, on CUDA
    tensors: the kernel q8_matmul_cuda launches with its own plan, here
    at any plan it takes, for the tests and for timing the
    alternatives."""
    m, k = x.shape
    n = q.shape[1]
    x, q = x.contiguous(), q.contiguous()
    s = s.reshape(-1).float().contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.library("q8")
    with torch.cuda.device(x.device):
        rc = lib.lmr_q8_gemv(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                             out.data_ptr(), m, k, n, _CODES[x.dtype], cols,
                             split, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, f"q8 GEMV launch at {cols} columns, split {split}")
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
