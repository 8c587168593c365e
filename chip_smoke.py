#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lua_mapreduce_tpu_torch``) on
one NVIDIA card.

    python3 chip_smoke.py

Phases, each a hard failure on any mismatch:

1. build   — compile every CUDA kernel from ``ops/csrc`` with nvcc
             (sm_90a), one process per source, all started together;
2. kernels — each kernel against its plain PyTorch version on the card,
             at the shapes the main paths give it, with the time of the
             kernel, the plain version, one library call (yardstick
             only) and the H100 bound for the same work; bf16 and
             int8 serving rows are also held normwise, and each
             attention row shows its check refuses a wrong output;
3. grads   — autograd through the kernels against autograd through the
             plain versions;
4. digits  — the six-function MapReduce DP-SGD trainer (256-128-10,
             4 shards × 128, a few loop iterations) through the port's
             LocalExecutor on ``mem:``, held against the same run on the
             CPU;
5. wide    — the single-device trainer on a (8192,)×4 bf16 MLP at batch
             8192, a few steps: images/s and model TFLOP/s;
6. serving — the LM serving path at the full width of the repo's decode
             benchmark (d_model 1024, 16 heads, 8 layers, d_ff 4096,
             vocab 32768; batch 4, prompt 3968, 128 new tokens), random
             weights from a seed: ``greedy_decode(use_prefill=True)`` in
             bf16, then with int8 weights (``quantize_lm``) and an int8
             KV cache — prefill ms, decode-tail and end-to-end tokens/s,
             and from a profiled repeat the kernel time and the kernel
             launches per decode step;
7. serving check — the same widths at 2 layers in f32 (prompt 256, 32
             new tokens): greedy tokens on the card equal the CPU run
             through the plain versions, prefill equals the position
             scan on the card, the int8 dict's prefill logits agree
             with the CPU's, and its greedy run with an int8 KV cache
             is held step by step on the head's logits.

Launch counts are zeroed just before each run of phases 4, 5 and 6 and
read just after, and must equal the counts worked out from the code; a
kernel of the paths with no launch there fails the run. The
card's name and power limit, then one JSON line of per-kernel numbers,
then ``{"ok": true, "device": {...}}`` end the output; the full report
is also written to ``chiprun_out/chip_smoke.json``. Exits non-zero
without printing a result when CUDA is unavailable or the port cannot
be imported.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense), for the bound of each kernel call
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12       # FP32 FMA outside the tensor cores
PEAK_BYTES = 3.35e12         # HBM3

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "lua_mapreduce_tpu_torch/ops/csrc/"
KERNEL_META = {
    "matmul_f32": (CSRC + "matmul.cu", "lua_mapreduce_tpu/ops/matmul.py:34"),
    "matmul_bf16": (CSRC + "matmul.cu", "lua_mapreduce_tpu/ops/matmul.py:34"),
    "rowwise_softmax": (CSRC + "softmax.cu",
                        "lua_mapreduce_tpu/ops/softmax.py:24"),
    "flash_fwd": (CSRC + "flash.cu", "lua_mapreduce_tpu/ops/attention.py:188"),
    "decode": (CSRC + "decode.cu", "lua_mapreduce_tpu/ops/decode.py:108"),
    "q8": (CSRC + "q8.cu", "lua_mapreduce_tpu/ops/q8.py:59"),
}
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}   # (rtol, atol)
# the JAX package's op tolerances for the serving kernels
# (test_attention_op.py, test_decode_op.py, test_q8.py)
SERVE_TOL = {"flash float32": (2e-5, 2e-5), "flash bfloat16": (2e-2, 2e-2),
             "decode float32": (2e-5, 2e-5), "decode bfloat16": (2e-2, 2e-2),
             "decode int8": (5e-3, 5e-3), "q8": (2e-2, 2e-2)}
# A bf16 or int8 serving row must also hold ‖got − want‖ / ‖want‖ to
# this: an elementwise tolerance near the size of the values it holds
# would pass a kernel that is wrong in every element.
NORM_TOL = 1e-2
# Attention inputs at the serving shapes are drawn so the softmax is
# peaked (scores of std 2: q at scale 2, k and v at 1) and the outputs
# are O(0.1-1), where the tolerances above mean something. A wrong
# output — the plain version with its softmax scale 5% off — must fail
# the same check (a negative control on every attention row).
Q_SCALE, WRONG_SCALE = 2.0, 1.05
# int8 weights + int8 KV cache at 2 layers: the card's head logits at
# every decode step up to the first token where it parts from the CPU
# reference may differ from the reference's by at most this, and the
# reference's own margin between its token and the card's there must be
# within it (a near-tie, not a wrong kernel).
INT8_LOGIT_TOL = 2e-2
# bench_decode's configuration (benchmarks/kernel_bench.py:533-567)
SERVE = dict(vocab=32768, d_model=1024, n_heads=16, n_layers=8, d_ff=4096,
             max_seq=4096)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 3968, 128


def log(msg):
    print(msg, flush=True)


def time_ms(fn, torch):
    """Device ms per call. After warm-up calls, enough calls to fill
    ~0.1 s are captured into one CUDA graph and the graph's replay is
    timed by CUDA events: the host's cost of launching each call (tens
    of µs through Python, more than a small kernel takes on the card)
    stays out of the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        est = time.perf_counter() - t0
    torch.cuda.current_stream().wait_stream(side)
    reps = int(min(200, max(3, 0.1 / max(est, 1e-6))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def norm_err(got, want):
    """‖got − want‖ / ‖want‖ over the whole tensor, in f32."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def check_close(name, got, want, dtype_name, tol=None, norm_tol=None):
    """Max abs error of ``got`` against ``want``; raises unless every
    element is within ``atol + rtol·|want|`` and, with ``norm_tol``, the
    normwise relative error is within it."""
    rtol, atol = tol or TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(g.isfinite().all()) and bool((err <= atol + rtol * w.abs()).all())
    max_abs = float(err.max()) if err.numel() else 0.0
    del err
    rel = norm_err(g, w) if norm_tol is not None else 0.0
    if not ok or rel > (norm_tol or 0.0):
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version (max abs err {max_abs:.3e}, "
                             f"rtol={rtol}, atol={atol}; normwise {rel:.3e}, "
                             f"limit {norm_tol})")
    return max_abs


def assert_rejects(name, wrong, want, dtype_name, tol, norm_tol):
    """The negative control: ``check_close`` must refuse ``wrong``.
    Returns its normwise error."""
    try:
        check_close(name, wrong, want, dtype_name, tol, norm_tol)
    except AssertionError:
        return norm_err(wrong, want)
    raise AssertionError(f"{name}: the check passed a wrong output "
                         f"(normwise {norm_err(wrong, want):.3e})")


# ------------------------------------------------------------ phase 2

def matmul_cases():
    """(label, M, K, N, dtype, a transposed?, b transposed?) at the main
    path's shapes: the digits step's forward products, its backward
    products (transposed views, as the autograd Function passes them),
    the validation products, and the wide trainer's 8192³ products."""
    f32 = [("digits fwd x·W0", 128, 256, 128, False, False),
           ("digits fwd h·W1", 128, 128, 10, False, False),
           ("digits bwd g·W1ᵀ", 128, 10, 128, False, True),
           ("digits bwd hᵀ·g", 128, 128, 10, True, False),
           ("digits bwd xᵀ·g", 256, 128, 128, True, False),
           ("digits val x·W0", 200, 256, 128, False, False),
           ("digits val h·W1", 200, 128, 10, False, False)]
    bf16 = [("4096³", 4096, 4096, 4096, False, False),
            ("wide fwd 8192³", 8192, 8192, 8192, False, False),
            ("wide bwd g·Wᵀ", 8192, 8192, 8192, False, True),
            ("wide bwd hᵀ·g", 8192, 8192, 8192, True, False)]
    return ([(*c[:4], "float32", *c[4:]) for c in f32] +
            [(*c[:4], "bfloat16", *c[4:]) for c in bf16])


def phase_kernels(torch, ops, gen):
    from lua_mapreduce_tpu_torch.ops.matmul import matmul_cuda, matmul_plain
    from lua_mapreduce_tpu_torch.ops.softmax import (log_softmax_plain,
                                                     rowwise_softmax_cuda,
                                                     softmax_plain)
    rows = []
    for label, m, k, n, dt, ta, tb in matmul_cases():
        dtype = getattr(torch, dt)
        scale = k ** -0.25
        a = (torch.randn((k, m) if ta else (m, k), device="cuda",
                         generator=gen) * scale).to(dtype)
        b = (torch.randn((n, k) if tb else (k, n), device="cuda",
                         generator=gen) * scale).to(dtype)
        a, b = (a.t() if ta else a), (b.t() if tb else b)
        got = matmul_cuda(a, b, dtype)
        torch.cuda.synchronize()
        err = check_close(f"matmul {label}", got, matmul_plain(a, b, dtype),
                          dt)
        item = 2 if dtype == torch.bfloat16 else 4
        bms, by = bound(2 * m * n * k, (m * k + k * n + m * n) * item,
                        PEAK_BF16_FLOPS if dt == "bfloat16"
                        else PEAK_F32_FLOPS)
        rows.append({
            "kernel": "matmul_f32" if dt == "float32" else "matmul_bf16",
            "case": f"matmul {label} ({m},{k})x({k},{n}) {dt}",
            "max_abs_err": err,
            "ms": time_ms(lambda: matmul_cuda(a, b, dtype), torch),
            "plain_ms": time_ms(lambda: matmul_plain(a, b, dtype), torch),
            "library_ms": time_ms(lambda: torch.matmul(a, b), torch),
            "bound_ms": bms, "bound_by": by})
        del a, b, got
    for shape, dt in (((128, 10), "float32"), ((200, 10), "float32"),
                      ((8192, 8192), "bfloat16")):
        dtype = getattr(torch, dt)
        x = (torch.randn(shape, device="cuda", generator=gen) * 3).to(dtype)
        for mode, name, plain, lib in (
                (0, "log_softmax", log_softmax_plain, torch.log_softmax),
                (1, "softmax", softmax_plain, torch.softmax)):
            got = rowwise_softmax_cuda(x, mode)
            torch.cuda.synchronize()
            err = check_close(f"{name} {shape}", got, plain(x), dt)
            if mode == 0:
                assert bool(torch.isfinite(got).all())
            item = 2 if dtype == torch.bfloat16 else 4
            numel = shape[0] * shape[1]
            # ~5 f32 operations per element: max, sub, exp, add, sub/mul
            bms, by = bound(5 * numel, 2 * numel * item, PEAK_F32_FLOPS)
            rows.append({
                "kernel": "rowwise_softmax",
                "case": f"{name} {shape} {dt}", "max_abs_err": err,
                "ms": time_ms(lambda: rowwise_softmax_cuda(x, mode), torch),
                "plain_ms": time_ms(lambda: plain(x), torch),
                "library_ms": time_ms(lambda: lib(x, dim=-1), torch),
                "bound_ms": bms, "bound_by": by})
    # the digits extreme-value row stays finite through the kernel
    ext = torch.tensor([[1e4, -1e4, 0.0, 5.0]], device="cuda")
    got = rowwise_softmax_cuda(ext, 0)
    check_close("log_softmax extreme values", got, log_softmax_plain(ext),
                "float32")
    return rows


def visible_pairs(l, causal, window):
    """(query, key) pairs a causal/windowed attention over L rows sees."""
    if not causal:
        return l * l
    if not window or window >= l:
        return l * (l + 1) // 2
    return window * (window + 1) // 2 + (l - window) * window


def serving_row(torch, kernel, case, err, fn, plain, lib, flops, nbytes,
                peak, rel, control=None):
    """One phase-2 row; ``rel`` is the kernel's normwise error against
    the plain version, ``control`` the wrong output's, which the check
    refused."""
    bms, by = bound(flops, nbytes, peak)
    return {"kernel": kernel, "case": case, "max_abs_err": err,
            "norm_err": rel, "control_norm_err": control,
            "ms": time_ms(fn, torch), "plain_ms": time_ms(plain, torch),
            "library_ms": time_ms(lib, torch) if lib else None,
            "bound_ms": bms, "bound_by": by}


def phase_serving_kernels(torch, gen):
    """flash / decode / q8 against their plain versions at the serving
    path's shapes (batch 4, prompt 3968, 16 heads of 64, cache 4096;
    q8 at every projection and the head, decode M = 4 and prefill
    M = 15872), plus the f32 shapes of the reduced-depth check. bf16 and
    int8 rows are also held normwise (NORM_TOL), and every attention
    row shows that its check refuses a wrong output."""
    import torch.nn.functional as F
    from lua_mapreduce_tpu_torch import ops
    from lua_mapreduce_tpu_torch.ops.attention import (flash_attention_cuda,
                                                       flash_attention_plain)
    from lua_mapreduce_tpu_torch.ops.decode import (decode_attention_cuda,
                                                    decode_attention_plain)
    from lua_mapreduce_tpu_torch.ops.q8 import q8_matmul_cuda, q8_matmul_plain
    rows = []

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, device="cuda", generator=gen)
                * scale).to(dtype)

    # ---- flash: prefill (B, L, H, D), causal, one call per layer
    for label, b, l, h, hkv, d, dt, window, lse in (
            ("prefill causal", 4, 3968, 16, 16, 64, "bfloat16", 0, False),
            ("prefill causal, lse mode", 4, 3968, 16, 16, 64, "bfloat16", 0,
             True),
            ("GQA 4:1 causal", 4, 3968, 16, 4, 64, "bfloat16", 0, False),
            ("window 512", 4, 3968, 16, 16, 64, "bfloat16", 512, False),
            ("check-run prefill causal", 4, 256, 16, 16, 64, "float32", 0,
             False)):
        dtype = getattr(torch, dt)
        q = randn(b, l, h, d, dtype=dtype, scale=Q_SCALE)
        k = randn(b, l, hkv, d, dtype=dtype)
        v = randn(b, l, hkv, d, dtype=dtype)
        scale = d ** -0.5
        tol = SERVE_TOL[f"flash {dt}"]
        ntol = NORM_TOL if dt == "bfloat16" else None

        def run(q=q, k=k, v=v, window=window, lse=lse):
            return flash_attention_cuda(q, k, v, causal=True, window=window,
                                        with_lse=lse)

        def plain(q=q, k=k, v=v, window=window, lse=lse, scale=scale):
            return flash_attention_plain(q, k, v, True, scale,
                                         with_lse=lse, window=window)
        got, want = run(), plain()
        torch.cuda.synchronize()
        out_got, out_want = (got[0], want[0]) if lse else (got, want)
        err = check_close(f"flash {label}", out_got, out_want, dt, tol, ntol)
        rel = norm_err(out_got, out_want)
        if lse:
            err = max(err, check_close(f"flash {label} lse", got[1], want[1],
                                       dt, (1e-5, 1e-4)))
        wrong = flash_attention_plain(q, k, v, True, scale * WRONG_SCALE,
                                      with_lse=lse, window=window)
        control = assert_rejects(f"flash {label} (scale 5% off)",
                                 wrong[0] if lse else wrong, out_want, dt,
                                 tol, ntol)
        del got, want, out_got, out_want, wrong
        lib = None
        if not lse:         # SDPA returns no lse: no one-call yardstick
            mask = None
            if window:
                i = torch.arange(l, device="cuda")
                mask = (i[:, None] >= i[None, :]) & \
                    (i[:, None] - i[None, :] < window)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def lib(qt=qt, kt=kt, vt=vt, mask=mask, gqa=hkv != h):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=gqa)
        item = q.element_size()
        nbytes = (2 * b * l * h * d + 2 * b * l * hkv * d) * item
        if lse:
            nbytes += b * l * h * d * (4 - item) + b * l * h * 4
        flops = 4 * b * h * d * visible_pairs(l, True, window)
        rows.append(serving_row(
            torch, "flash_fwd", f"flash {label} ({b},{l},{h}/{hkv},{d}) {dt}", err,
            run, plain, lib, flops, nbytes,
            PEAK_BF16_FLOPS if dt == "bfloat16" else PEAK_F32_FLOPS,
            rel, control))
        del q, k, v
        torch.cuda.empty_cache()

    # ---- decode: one position vs the (B, H_kv, S, D) cache, per layer
    for label, b, hkv, g, d, s_len, t, kind, roll in (
            ("bf16 t=4094", 4, 16, 1, 64, 4096, 4094, "bfloat16", False),
            ("int8+scales t=4094", 4, 16, 1, 64, 4096, 4094, "int8", False),
            ("roll S=512 t=4000", 4, 16, 1, 64, 512, 4000, "bfloat16", True),
            ("GQA 4:1 t=4094", 4, 4, 4, 64, 4096, 4094, "bfloat16", False),
            ("check-run f32 t=287", 4, 16, 1, 64, 288, 287, "float32",
             False)):
        dtype = torch.float32 if kind == "float32" else torch.bfloat16
        q = randn(b, hkv, g, d, dtype=dtype, scale=Q_SCALE)
        k = randn(b, hkv, s_len, d, dtype=dtype)
        v = randn(b, hkv, s_len, d, dtype=dtype)
        kd, vd = k, v
        scales = {}
        if kind == "int8":
            k, ks = ops.quantize_kv(kd)
            v, vs = ops.quantize_kv(vd)
            scales = dict(k_scale=ks, v_scale=vs)
            kd = (k.float() * ks[..., None]).to(torch.bfloat16)
            vd = (v.float() * vs[..., None]).to(torch.bfloat16)

        def run(q=q, k=k, v=v, t=t, roll=roll, scales=scales):
            return decode_attention_cuda(q, k, v, t, roll, **scales)

        def plain(q=q, k=k, v=v, t=t, roll=roll, scales=scales):
            return decode_attention_plain(q, k, v, t, roll, **scales)
        got, want = run(), plain()
        torch.cuda.synchronize()
        tol = SERVE_TOL[f"decode {kind}"]
        ntol = NORM_TOL if kind != "float32" else None
        err = check_close(f"decode {label}", got, want, kind, tol, ntol)
        rel = norm_err(got, want)
        # the softmax scale 5% off: q scaled, since the scale is 1/√d
        control = assert_rejects(
            f"decode {label} (scale 5% off)",
            decode_attention_plain((q.float() * WRONG_SCALE).to(q.dtype), k,
                                   v, t, roll, **scales),
            want, kind, tol, ntol)
        del got, want
        n_live = s_len if (roll and t >= s_len) else min(t + 1, s_len)
        qs = q.reshape(b, hkv * g, 1, d)
        kp, vp = kd[:, :, :n_live], vd[:, :, :n_live]

        def lib(qs=qs, kp=kp, vp=vp, gqa=g > 1):
            return F.scaled_dot_product_attention(qs, kp, vp,
                                                  enable_gqa=gqa)
        kv_item = k.element_size()
        nbytes = (2 * b * hkv * n_live * d * kv_item + q.numel()
                  * q.element_size() + b * hkv * g * d * 4)
        if scales:
            nbytes += 2 * b * hkv * n_live * 4
        rows.append(serving_row(
            torch, "decode", f"decode {label} q ({b},{hkv},{g},{d}) cache S={s_len} "
            f"{kind}", err, run, plain, lib, 4 * b * hkv * g * n_live * d,
            nbytes, PEAK_F32_FLOPS if kind == "float32" else PEAK_BF16_FLOPS,
            rel, control))
        del q, k, v, kd, vd
        torch.cuda.empty_cache()

    # ---- q8: every projection and the head under quantize_lm
    for label, m, k_dim, n, dt in (
            ("decode qkv", 4, 1024, 3072, "bfloat16"),
            ("decode out", 4, 1024, 1024, "bfloat16"),
            ("decode ff1", 4, 1024, 4096, "bfloat16"),
            ("decode ff2", 4, 4096, 1024, "bfloat16"),
            ("decode head", 4, 1024, 32768, "bfloat16"),
            ("prefill qkv", 15872, 1024, 3072, "bfloat16"),
            ("prefill out", 15872, 1024, 1024, "bfloat16"),
            ("prefill ff1", 15872, 1024, 4096, "bfloat16"),
            ("prefill ff2", 15872, 4096, 1024, "bfloat16"),
            ("prefill head", 15872, 1024, 32768, "bfloat16"),
            ("check-run prefill qkv (x bf16-valued)", 1024, 1024, 3072,
             "float32")):
        dtype = getattr(torch, dt)
        w = randn(k_dim, n, dtype=torch.float32, scale=k_dim ** -0.5)
        qw, sw = ops.quantize_q8(w)
        sw = sw.reshape(-1)
        # bf16 values: the kernel rounds x to bf16, the plain version not
        x = randn(m, k_dim).to(dtype)
        wd = (qw.float() * sw).to(torch.bfloat16)
        xb = x.to(torch.bfloat16)

        def run(x=x, qw=qw, sw=sw):
            return q8_matmul_cuda(x, qw, sw)

        def plain(x=x, qw=qw, sw=sw):
            return q8_matmul_plain(x, qw, sw)

        def lib(xb=xb, wd=wd):
            return torch.matmul(xb, wd)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = check_close(f"q8 {label}", got, want, dt, SERVE_TOL["q8"],
                          NORM_TOL if dt == "bfloat16" else None)
        rel = norm_err(got, want)
        del got, want
        item = x.element_size()
        nbytes = m * k_dim * item + k_dim * n + n * 4 + m * n * item
        rows.append(serving_row(
            torch, "q8", f"q8 {label} ({m},{k_dim})x({k_dim},{n}) x {dt}", err, run,
            plain, lib, 2 * m * k_dim * n, nbytes, PEAK_BF16_FLOPS, rel))
        del w, qw, x, wd, xb
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phase 3

def phase_grads(torch, ops, gen):
    """Digits-MLP loss and parameter gradients through the kernels
    (custom autograd Functions) against plain autograd, on the card."""
    from lua_mapreduce_tpu_torch.models.mlp import init_mlp, nll_loss
    from lua_mapreduce_tpu_torch.ops.matmul import matmul_plain
    from lua_mapreduce_tpu_torch.ops.softmax import log_softmax_plain

    def plain_loss(p, x, y):
        h = torch.tanh(matmul_plain(x, p["W0"]) + p["b0"])
        logp = log_softmax_plain(matmul_plain(h, p["W1"]) + p["b1"])
        return -logp.gather(1, y[:, None]).mean()

    out = {}
    for dt, sizes, batch in (("float32", (256, 128, 10), 128),
                             ("bfloat16", (1024, 512, 256), 512)):
        dtype = getattr(torch, dt)
        x = torch.rand((batch, sizes[0]), device="cuda",
                       generator=gen).to(dtype)
        y = torch.randint(0, sizes[-1], (batch,), device="cuda",
                          generator=gen)
        grads = []
        for fn in (nll_loss, plain_loss):
            p = {k: v.requires_grad_(True)
                 for k, v in init_mlp(1, sizes, dtype, "cuda").items()}
            loss = fn(p, x, y)
            g = torch.autograd.grad(loss, list(p.values()))
            grads.append((loss.detach(), dict(zip(p, g))))
        (lk, gk), (lp, gp) = grads
        err = check_close(f"loss {dt}", lk.reshape(1), lp.reshape(1), dt)
        for k in gk:
            err = max(err, check_close(f"grad {k} {dt}", gk[k], gp[k], dt))
        out[dt] = err
        log(f"[grads] {dt} sizes={sizes} batch={batch}: loss kernel="
            f"{float(lk):.6f} plain={float(lp):.6f} max_abs_err={err:.3e}")
    return out


# ------------------------------------------------------------ phase 4

def run_digits(device, tag, n_iter):
    """The six-function digits trainer for ``n_iter`` loop iterations;
    returns the validation loss after each."""
    from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
    from lua_mapreduce_tpu_torch.examples.digits import mr_train

    model_store = f"mem:smoke-digits-model-{tag}"
    val = []

    def finalfn(pairs):
        verdict = mr_train.finalfn(pairs)
        val.append(mr_train.read_meta(model_store)["val_loss"])
        return verdict

    mod = "lua_mapreduce_tpu_torch.examples.digits.mr_train"
    spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod, reducefn=mod,
                    finalfn={"finalfn": finalfn},
                    init_args={"sizes": (256, 128, 10), "n_shards": 4,
                               "bunch": 128, "max_steps": n_iter,
                               "patience": 10_000, "seed": 0,
                               "model_store": model_store,
                               "device": device},
                    storage=f"mem:smoke-digits-shuffle-{tag}")
    t0 = time.perf_counter()
    stats = LocalExecutor(spec, max_iterations=n_iter + 1).run()
    wall = time.perf_counter() - t0
    if len(stats.iterations) != n_iter:
        raise AssertionError(f"digits ran {len(stats.iterations)} "
                             f"iterations, expected {n_iter}")
    return val, wall


def phase_digits(torch, ops, n_iter=6):
    ops.reset_launch_counts()
    val, wall = run_digits("cuda", "cuda", n_iter)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"[digits] val loss per iteration: "
        + " ".join(f"{v:.6f}" for v in val))
    log(f"[digits] {n_iter} iterations in {wall:.3f} s "
        f"({n_iter * 4 * 128 / wall:.1f} images/s, host clock); "
        f"launches {counts}")
    # per iteration: 4 map jobs × (2 forward + 3 backward products, 1
    # log_softmax) + the validation loss (2 products, 1 log_softmax)
    want = {**dict.fromkeys(ops.KERNELS, 0),
            "matmul_f32": n_iter * (4 * 5 + 2),
            "rowwise_softmax": n_iter * (4 + 1)}
    if counts != want:
        raise AssertionError(f"digits launches {counts}, expected {want}")
    if not (all(math.isfinite(v) for v in val) and val[-1] < val[0]):
        raise AssertionError(f"digits val loss did not fall: {val}")
    # the same run on the CPU (plain versions) from the same seed
    ref, _ = run_digits("cpu", "cpu", 2)
    for i, (g, w) in enumerate(zip(val, ref)):
        if abs(g - w) > 1e-4 * max(1.0, abs(w)):
            raise AssertionError(f"digits iteration {i + 1}: card val loss "
                                 f"{g} vs CPU {w}")
    log(f"[digits] CPU reference val loss {ref} agrees within 1e-4")
    return counts, val, wall


# ------------------------------------------------------------ phase 5

def phase_wide(torch, ops, gen, steps=5, width=8192, batch=8192):
    from lua_mapreduce_tpu_torch.models.mlp import (flops_per_example,
                                                    init_mlp, nll_loss)
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)
    sizes = (width,) * 4
    params = init_mlp(0, sizes, torch.bfloat16, "cuda")
    x = torch.randn((batch, width), device="cuda", generator=gen).to(
        torch.bfloat16)
    y = torch.randint(0, width, (batch,), device="cuda", generator=gen)
    ops.reset_launch_counts()
    tr = DataParallelTrainer(nll_loss, params, TrainConfig(batch_size=batch),
                             device="cuda")
    del params
    first = tr.step(x, y)                       # warm-up step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = tr.run_steps(x, y, steps - 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    losses = [first] + [float(v) for v in losses]
    imgs = (steps - 1) * batch / dt
    tflops = imgs * flops_per_example(sizes) / 1e12
    log(f"[wide] mlp {'x'.join(map(str, sizes))} bf16 batch={batch}: "
        f"losses {losses}")
    log(f"[wide] {steps - 1} timed steps in {dt * 1e3:.3f} ms: "
        f"{imgs:.1f} images/s, {tflops:.3f} model TFLOP/s "
        f"({100 * tflops * 1e12 / PEAK_BF16_FLOPS:.2f}% of the 989 TFLOP/s "
        f"bf16 dense peak); launches {counts}")
    want = {**dict.fromkeys(ops.KERNELS, 0), "matmul_bf16": steps * 8,
            "rowwise_softmax": steps}
    if counts != want:
        raise AssertionError(f"wide launches {counts}, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"wide trainer loss not finite: {losses}")
    return counts, {"images_per_s": imgs, "model_tflops": tflops,
                    "step_ms": dt * 1e3 / (steps - 1), "losses": losses}


# ------------------------------------------------------------ phase 6

def serve_counts(n_layers, n_new, quantized):
    """Launches of one greedy_decode(use_prefill=True), from the code:
    one flash call per layer in prefill; one decode call per layer in
    each of the n_new - 1 steps after it; under quantize_lm four q8
    projections per layer (qkv, out, ff1, ff2) and the head, in prefill
    and in every step."""
    return {"matmul_f32": 0, "matmul_bf16": 0, "rowwise_softmax": 0,
            "flash_fwd": n_layers, "decode": n_layers * (n_new - 1),
            "q8": (4 * n_layers + 1) * n_new if quantized else 0}


def kernel_profile(torch, fn):
    """Run ``fn`` under torch.profiler; device time (ms) and launches by
    kernel name, largest first. Operator rows are left out: they repeat
    their kernels' device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])


def phase_serving(torch, ops, seed=0):
    """The serving path at bench_decode's full width, bf16 then int8
    weights + int8 KV cache. Counts are zeroed just before each timed
    greedy_decode and read just after. A second, profiled run of each
    gives the kernel time and the kernel launches per decode step."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    cfg = tt.TransformerConfig(**SERVE)
    params = tt.init_transformer(seed, cfg, dtype=torch.bfloat16,
                                 device="cuda")
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=torch.Generator().manual_seed(seed + 1)
                           ).cuda()
    b, p_len, n_new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    out = {}
    for tag, quantized in (("bf16", False), ("int8", True)):
        p = tt.quantize_lm(params) if quantized else params
        kw = dict(cfg=cfg, use_prefill=True, kv_q8=quantized)
        tt.greedy_decode(p, prompt, 2, **kw)               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        toks = tt.greedy_decode(p, prompt, n_new, **kw)
        torch.cuda.synchronize()
        e2e = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = serve_counts(cfg.n_layers, n_new, quantized)
        if counts != want:
            raise AssertionError(f"serving {tag} launches {counts}, "
                                 f"expected {want}")
        pre = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tt.prefill(p, prompt, cfg=cfg, total=p_len + n_new)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t0)
        prefill_s = min(pre)
        tail = e2e - prefill_s
        toks = toks.cpu()
        if toks.shape != (b, p_len + n_new) or \
                not torch.equal(toks[:, :p_len], prompt.cpu().int()) or \
                int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
            raise AssertionError(f"serving {tag}: bad output {toks.shape}")
        kernels = kernel_profile(
            torch, lambda: tt.greedy_decode(p, prompt, n_new, **kw))
        pre_kernels = kernel_profile(
            torch, lambda: tt.prefill(p, prompt, cfg=cfg,
                                      total=p_len + n_new))
        step_ms = (sum(k[1] for k in kernels)
                   - sum(k[1] for k in pre_kernels)) / (n_new - 1)
        step_launches = (sum(k[2] for k in kernels)
                         - sum(k[2] for k in pre_kernels)) / (n_new - 1)
        r = {"prefill_ms": prefill_s * 1e3, "e2e_ms": e2e * 1e3,
             "decode_tail_ms": tail * 1e3,
             "decode_step_ms": tail * 1e3 / (n_new - 1),
             "decode_tail_tokens_per_s": b * (n_new - 1) / tail,
             "e2e_tokens_per_s": b * n_new / e2e,
             "prefill_tokens_per_s": b * p_len / prefill_s,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "step_kernel_ms": step_ms, "step_kernel_launches": step_launches,
             "device_idle_share": 1 - step_ms / (tail * 1e3 / (n_new - 1)),
             "top_kernels": kernels[:12],
             "launches": counts, "first_tokens": toks[0, p_len:p_len + 8]
             .tolist()}
        log(f"[serving] {tag}: prefill {r['prefill_ms']:.3f} ms "
            f"({r['prefill_tokens_per_s']:.1f} prompt tokens/s), decode "
            f"tail {r['decode_tail_ms']:.3f} ms = {r['decode_step_ms']:.4f} "
            f"ms/step ({r['decode_tail_tokens_per_s']:.1f} tokens/s), "
            f"end to end {r['e2e_ms']:.3f} ms ({r['e2e_tokens_per_s']:.1f} "
            f"tokens/s); launches {counts}")
        log(f"[serving] {tag}: per decode step {step_ms:.4f} ms of kernels "
            f"over {step_launches:.1f} kernel launches; device idle "
            f"{100 * r['device_idle_share']:.1f}% of the decode tail")
        for name, ms, n in kernels[:12]:
            log(f"[serving] {tag}   {ms:10.3f} ms {n:6d}x  {name[:90]}")
        out[tag] = r
        del p
    return out


# ------------------------------------------------------------ phase 7

def phase_serving_check(torch, ops, seed=3):
    """The serving widths at 2 layers in f32: greedy tokens on the card
    (kernels) equal the CPU's (plain versions); prefill equals the
    position scan on the card. With int8 weights and an int8 KV cache
    the card's prefill logits agree with the CPU's within the q8 op
    tolerance (the kernel rounds x to bf16, the plain version does
    not), and the greedy run is held step by step against a CPU run
    that rounds x as the kernel does (``int8_divergence``)."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    cfg = tt.TransformerConfig(**{**SERVE, "n_layers": 2})
    p_len, n_new, b = 256, 32, SERVE_BATCH
    p_cpu = tt.init_transformer(seed, cfg, device="cpu")
    p_gpu = {k: v.cuda() for k, v in p_cpu.items()}
    prompt = torch.randint(0, cfg.vocab, (b, p_len),
                           generator=torch.Generator().manual_seed(seed + 1))
    want = tt.greedy_decode(p_cpu, prompt, n_new, cfg=cfg, use_prefill=True)
    ops.reset_launch_counts()
    got = tt.greedy_decode(p_gpu, prompt.cuda(), n_new, cfg=cfg,
                           use_prefill=True).cpu()
    counts = ops.launch_counts()
    if counts != serve_counts(cfg.n_layers, n_new, False):
        raise AssertionError(f"serving check launches {counts}")
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"serving check: {bad} greedy tokens on the "
                             f"card differ from the CPU run")
    scan = tt.greedy_decode(p_gpu, prompt.cuda(), n_new, cfg=cfg,
                            use_prefill=False).cpu()
    if not torch.equal(scan, got):
        raise AssertionError("serving check: prefill and position-scan "
                             "decoding disagree on the card")
    log(f"[check] f32 2 layers, prompt {p_len}, {n_new} new: card tokens "
        f"== CPU tokens, prefill == scan on the card")

    # int8 weights + int8 KV cache, with the head's logits at every step
    q_cpu = tt.quantize_lm(p_cpu)
    q_gpu = {k: v.cuda() for k, v in q_cpu.items()}
    runs = {}
    for tag, params, round_x in (("card", q_gpu, False),
                                 ("plain", q_cpu, False),
                                 ("bf16-x", q_cpu, True)):
        sink = []
        with head_logits(tt, sink, round_x):
            toks = tt.greedy_decode(params, prompt.to(params["tok_emb"]
                                                      .device), n_new,
                                    cfg=cfg, use_prefill=True, kv_q8=True)
        runs[tag] = (toks.cpu()[:, p_len:], torch.stack(sink, 1))
    (tg, lg), (tp, lp) = runs["card"], runs["plain"]
    # prefill's last-position logits (the first head call) against the
    # plain versions, at the q8 op tolerance
    err = check_close("int8 prefill last logits", lg[:, 0], lp[:, 0],
                      "float32", SERVE_TOL["q8"])
    agree = {t: float((runs[t][0] == tg).float().mean())
             for t in ("plain", "bf16-x")}
    seqs = int8_divergence(tg, lg, *runs["bf16-x"])
    log(f"[check] int8 weights: prefill logits max abs err {err:.3e} "
        f"(|logits| max {float(lp.abs().max()):.3f}); int8 weights + int8 "
        f"KV greedy tokens agree with the CPU on "
        f"{100 * agree['plain']:.1f}% (plain versions) and "
        f"{100 * agree['bf16-x']:.1f}% (plain versions with x rounded to "
        f"bf16 before each q8 product, as the kernel does)")
    for i, s in enumerate(seqs):
        log(f"[check] int8 sequence {i}: first token apart "
            f"{s['first_apart']} of {n_new}; step logits through it "
            f"within {s['max_logit_diff']:.3e} of the reference"
            + (f"; there the reference's margin for its token over the "
               f"card's is {s['margin']:.3e}" if s["margin"] is not None
               else ""))
    return {"tokens_equal": True, "prefill_equals_scan": True,
            "int8_logits_max_abs_err": err, "int8_token_agreement": agree,
            "int8_sequences": seqs}


def int8_divergence(tg, lg, tr, lr):
    """Hold the card's int8 greedy run (tokens ``tg``, per-step head
    logits ``lg``) against the CPU reference (``tr``, ``lr``): in each
    sequence, through the first token where the two part (every step
    when none does) the step logits agree within INT8_LOGIT_TOL, and
    there the reference's own margin for its token over the card's is
    within it too — the two parted at a near-tie that the rounding
    differences can flip, not at a clear choice."""
    n_new = tg.shape[1]
    out = []
    for i in range(tg.shape[0]):
        apart = (tg[i] != tr[i]).nonzero()
        j = int(apart[0]) if len(apart) else n_new
        upto = min(j, n_new - 1) + 1
        diff = float((lg[i, :upto] - lr[i, :upto]).abs().max())
        margin = None
        if j < n_new:
            margin = float(lr[i, j, tr[i, j]] - lr[i, j, tg[i, j]])
        if diff > INT8_LOGIT_TOL or (margin is not None
                                     and margin > INT8_LOGIT_TOL):
            raise AssertionError(
                f"int8 serving check, sequence {i}: step logits differ by "
                f"{diff:.3e} through step {j}, reference margin {margin} "
                f"(limit {INT8_LOGIT_TOL})")
        out.append({"first_apart": j, "max_logit_diff": diff,
                    "margin": margin})
    return out


@contextlib.contextmanager
def head_logits(tt, sink, round_x):
    """Within the block, every LM-head call of ``tt`` (prefill's, then
    one per decode step) appends its last-position logits (f32, on the
    host) to ``sink``. With ``round_x``, q8 products of CPU tensors
    round x to bf16 first: the rounding point the q8 kernel has (as the
    TPU kernel does) and its plain version lacks."""
    import torch
    head, q8_matmul = tt._head, tt.q8_matmul

    def recording_head(params, x):
        out = head(params, x)
        sink.append(out[:, -1].float().cpu())
        return out

    def q8_bf16_x(x, q, s):
        if not x.is_cuda:
            x = x.to(torch.bfloat16).to(x.dtype)
        return q8_matmul(x, q, s)
    tt._head = recording_head
    if round_x:
        tt.q8_matmul = q8_bf16_x
    try:
        yield
    finally:
        tt._head, tt.q8_matmul = head, q8_matmul


# ------------------------------------------------------------ main

def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi failed: {out.stderr.strip()}"


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from lua_mapreduce_tpu_torch import ops
    from lua_mapreduce_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    rep = _build.build_all()
    log(f"[build] compiled {rep['built']} in {rep['seconds']:.2f} s")
    for name, out in rep["ptxas"].items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(torch, ops, gen) + phase_serving_kernels(torch, gen)
    for r in rows:
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        extra = ""
        if r.get("norm_err") is not None:
            extra = f", normwise {r['norm_err']:.3e}"
        if r.get("control_norm_err") is not None:
            extra += (f" (scale 5% off: {r['control_norm_err']:.3e}, "
                      f"refused)")
        log(f"[kernel] {r['case']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {lib}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"max_abs_err {r['max_abs_err']:.3e}{extra}")
    grads = phase_grads(torch, ops, gen)
    digits_counts, val, _ = phase_digits(torch, ops)
    wide_counts, wide = phase_wide(torch, ops, gen)
    serving = phase_serving(torch, ops)
    check = phase_serving_check(torch, ops)
    runs = [digits_counts, wide_counts] + [serving[t]["launches"]
                                           for t in serving]
    launches = {k: sum(c[k] for c in runs) for k in ops.KERNELS}
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    kernels = []
    for name in ops.KERNELS:
        mine = [r for r in rows if r["kernel"] == name]
        top = max(mine, key=lambda r: r["bound_ms"])
        src, replaces = KERNEL_META[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"]})

    gpu = gpu_line()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    report = {"gpu": gpu, "device": device, "build": {
        "built": rep["built"], "seconds": rep["seconds"],
        "ptxas": rep["ptxas"]},
        "cases": rows, "grads_max_abs_err": grads,
        "digits": {"val_loss": val, "launches": digits_counts},
        "wide": {**wide, "launches": wide_counts}, "serving": serving,
        "serving_check": check, "kernels": kernels,
        "seconds": time.perf_counter() - t_start}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] {report['seconds']:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
