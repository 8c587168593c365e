#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lua_mapreduce_tpu_torch``) on
one NVIDIA card.

    python3 chip_smoke.py

Phases, each a hard failure on any mismatch:

1. build   — compile every CUDA kernel from ``ops/csrc`` with nvcc
             (sm_90a), one process per source, all started together;
2. kernels — each kernel against its plain PyTorch version on the card,
             at the shapes the main path gives it, with the time of the
             kernel, the plain version, one library call (yardstick
             only) and the H100 bound for the same work;
3. grads   — autograd through the kernels against autograd through the
             plain versions;
4. digits  — the six-function MapReduce DP-SGD trainer (256-128-10,
             4 shards × 128, a few loop iterations) through the port's
             LocalExecutor on ``mem:``, held against the same run on the
             CPU;
5. wide    — the single-device trainer on a (8192,)×4 bf16 MLP at batch
             8192, a few steps: images/s and model TFLOP/s.

Launch counts are zeroed just before phases 4 and 5 and read just
after; a kernel of the path with no launch there fails the run. The
card's name and power limit, then one JSON line of per-kernel numbers,
then ``{"ok": true, "device": {...}}`` end the output; the full report
is also written to ``chiprun_out/chip_smoke.json``. Exits non-zero
without printing a result when CUDA is unavailable or the port cannot
be imported.
"""

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
MATMUL_SRC = "lua_mapreduce_tpu_torch/ops/csrc/matmul.cu"
SOFTMAX_SRC = "lua_mapreduce_tpu_torch/ops/csrc/softmax.cu"
KERNEL_META = {
    "matmul_f32": (MATMUL_SRC, "lua_mapreduce_tpu/ops/matmul.py:34"),
    "matmul_bf16": (MATMUL_SRC, "lua_mapreduce_tpu/ops/matmul.py:34"),
    "rowwise_softmax": (SOFTMAX_SRC, "lua_mapreduce_tpu/ops/softmax.py:24"),
}
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}   # (rtol, atol)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, torch):
    """Mean ms per call over enough back-to-back calls to fill ~0.1 s,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = time.perf_counter() - t0
    reps = int(min(200, max(3, 0.1 / max(est, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check_close(name, got, want, dtype_name):
    rtol, atol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(g.isfinite().all()) and bool((err <= atol + rtol * w.abs()).all())
    max_abs = float(err.max()) if err.numel() else 0.0
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version (max abs err {max_abs:.3e}, "
                             f"rtol={rtol}, atol={atol})")
    return max_abs


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
    want = {"matmul_f32": n_iter * (4 * 5 + 2), "matmul_bf16": 0,
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
    want = {"matmul_f32": 0, "matmul_bf16": steps * 8,
            "rowwise_softmax": steps}
    if counts != want:
        raise AssertionError(f"wide launches {counts}, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"wide trainer loss not finite: {losses}")
    return counts, {"images_per_s": imgs, "model_tflops": tflops,
                    "step_ms": dt * 1e3 / (steps - 1), "losses": losses}


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
    rows = phase_kernels(torch, ops, gen)
    for r in rows:
        log(f"[kernel] {r['case']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"max_abs_err {r['max_abs_err']:.3e}")
    grads = phase_grads(torch, ops, gen)
    digits_counts, val, _ = phase_digits(torch, ops)
    wide_counts, wide = phase_wide(torch, ops, gen)
    launches = {k: digits_counts[k] + wide_counts[k] for k in ops.KERNELS}
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
        "built": rep["built"], "seconds": rep["seconds"]},
        "cases": rows, "grads_max_abs_err": grads,
        "digits": {"val_loss": val, "launches": digits_counts},
        "wide": {**wide, "launches": wide_counts}, "kernels": kernels,
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
