"""csrc/q8.cu's M <= 8 GEMV, step by step in numpy float32: the plan's
strips, cluster ranks and K-slices, each thread's k rows and 16 columns,
the int8 widening by byte permute, its f32 FMAs in k order, the warp's
halving exchanges, the warps in order, then the cluster's ranks in
order, the scale once and the cast. Every f32 operation is the kernel's
in the kernel's order (a bf16 x times an int8 weight is exact in f32, so
an FMA rounds once as a multiply and an add do here), so the result is
the card's bit for bit. The CPU tests hold it to the plain version and
the JAX op; the card tests hold the kernel to it.
"""

import numpy as np
import torch

from lua_mapreduce_tpu_torch.ops import q8 as tq8


def byte_perm(x, y, s):
    """CUDA's ``__byte_perm(x, y, s)`` on uint32 arrays: byte j of the
    result is byte (s >> 4j) & 7 of the 8 bytes {x (0-3), y (4-7)}."""
    x, y = np.asarray(x, np.uint64), np.asarray(y, np.uint64)
    src = x | (y << np.uint64(32))
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for j in range(4):
        b = (np.uint64(s) >> np.uint64(4 * j)) & np.uint64(7)
        out |= ((src >> (b * np.uint64(8))) & np.uint64(0xFF)) << \
            np.uint64(8 * j)
    return out.astype(np.uint32)


def widen(words):
    """The kernel's widening of packed int8 weights: uint32 words (..., 4
    bytes) → float32 (..., 4), byte e of a word at index e."""
    flipped = np.asarray(words, np.uint32) ^ np.uint32(tq8.GEMV_SIGN_FLIP)
    out = [byte_perm(flipped, tq8.GEMV_MAGIC, tq8.GEMV_PERM + e)
           .view(np.float32) - np.float32(tq8.GEMV_WIDEN_BIAS)
           for e in range(4)]
    return np.stack(out, axis=-1).astype(np.float32)


def _bitrev(v, bits):
    return int(format(v, f"0{bits}b")[::-1], 2)


def gemv(x, q, s, cluster_sms, plan=None):
    """x (M, K) f32 or bf16 tensor, q (K, N) int8, s (N,) → the kernel's
    (M, N) in x's dtype, with M <= 8, on a card whose clusters of 1, 2, 4
    and 8 CTAs can use ``cluster_sms`` SMs; at ``plan`` (a (strip width,
    split) pair) in place of the kernel's own."""
    m, k = x.shape
    n = q.shape[1]
    p = tq8.gemv_plan(k, n, cluster_sms)
    if plan is not None:
        cols, split = plan
        p = tq8.GemvPlan(cols, split, -(-k // split), -(-n // cols))
    mt, nt, cpt = tq8.gemv_mt(m), tq8.GEMV_NT, 16
    cg = p.cols // cpt
    ksw, ksb, v = 32 // cg, nt // cg, mt * cpt
    xb = x.to(torch.bfloat16).float().numpy()
    qn = q.numpy().view(np.uint8)
    sc = s.reshape(-1).float().numpy()
    out = np.zeros((m, n), np.float32)
    tid = np.arange(nt)
    lane, warp = tid % 32, tid // 32
    grp, sel = lane % cg, lane // cg
    ks = warp * ksw + sel
    for bx in range(p.strips):
        col = bx * p.cols + grp * cpt                         # (nt,)
        cols = col[:, None] + np.arange(cpt)                  # (nt, 16)
        parts = []
        for by in range(p.split):
            kbeg = by * p.kper
            kend = min(k, kbeg + p.kper)
            acc = np.zeros((nt, v), np.float32)
            for c0 in range(kbeg, kend, tq8.GEMV_XCH):
                c1 = min(kend, c0 + tq8.GEMV_XCH)
                rows = -(-(c1 - c0) // ksb)
                xs = np.zeros((rows * ksb, mt), np.float32)
                xs[:c1 - c0, :m] = xb[:, c0:c1].T
                for r in range(rows):
                    kk = ks + r * ksb
                    kr = c0 + kk
                    live = (kr < c1)[:, None] & (cols < n)
                    b = np.zeros((nt, cpt), np.uint8)
                    b[live] = qn[np.minimum(kr, k - 1)[:, None]
                                 .repeat(cpt, 1)[live],
                                 np.minimum(cols, n - 1)[live]]
                    words = b.reshape(nt, 4, 4).astype(np.uint32)
                    words = (words << (8 * np.arange(4, dtype=np.uint32))
                             ).sum(-1, dtype=np.uint32)
                    w = widen(words).reshape(nt, cpt)
                    xv = xs[kk]                                # (nt, mt)
                    for mm in range(mt):
                        sl = slice(mm * cpt, (mm + 1) * cpt)
                        acc[:, sl] = acc[:, sl] + xv[:, mm:mm + 1] * w
            # the halving exchanges among a warp's K-lanes
            o, h = cg, v // 2
            while o < 32:
                up = (lane & o) != 0
                partner = tid ^ o
                lo, hi = acc[:, :h].copy(), acc[:, h:2 * h].copy()
                send = np.where(up[:, None], lo, hi)
                acc = acc.copy()
                acc[:, :h] = np.where(up[:, None], hi, lo) + send[partner]
                o, h = o << 1, h >> 1
            kept, log_ksw = v // ksw, ksw.bit_length() - 1
            first = kept * np.array([_bitrev(int(t), log_ksw) for t in sel])
            red = np.zeros((nt // 32, mt, p.cols), np.float32)
            for i in range(kept):
                vv = first + i
                red[warp, vv // cpt, grp * cpt + vv % cpt] = acc[:, i]
            total = np.zeros((mt, p.cols), np.float32)
            for w_ in range(nt // 32):
                total = total + red[w_]
            parts.append(total)
        # the ranks' partials in rank order (each owner adds its columns'
        # rows so)
        total = np.zeros((mt, p.cols), np.float32)
        for part in parts:
            total = total + part
        n0 = bx * p.cols
        n1 = min(n, n0 + p.cols)
        out[:, n0:n1] = total[:m, :n1 - n0] * sc[n0:n1]
    return torch.from_numpy(out).to(x.dtype)
