"""csrc/q8.cu's prefill kernel (M > 8), its data movement step by step in
numpy: TMA's 128-byte-swizzled boxes of x and of the int8 weight, each
consumer warp's pair-ldmatrix.trans of the int8 tile, the widening (a
byte permute under bf16's exponent, a bf16x2 subtraction), the A
fragments as wgmma reads them from
registers (fragment row r of a warp is its channel 2·(r % 8) + r / 8),
the products Wᵀ·xᵀ k16 step by k16 step, then the epilogue: each lane's
accumulator registers read back as (channel pair, token), scaled, cast
and written into the swizzled transposed C tile, which the TMA store
unswizzles and clips at the ragged edges.

The tensor cores' own order of sums inside a k16 step is not modelled:
on integer-valued x and weights, whose sums f32 holds exactly, the
model gives the card's bits; on other inputs it agrees to f32 rounding.
The CPU tests hold it to the plain version and the JAX op; the card
tests hold the kernel to it.
"""

import numpy as np
import torch

from lua_mapreduce_tpu_torch.ops import q8 as tq8
from torch_q8_gemv_model import byte_perm

CH = tq8.PF_CHANNELS            # channels a tile: 64 a consumer warpgroup
LANE = np.arange(32)
G8, T4 = LANE // 4, LANE % 4    # a lane's (group, thread in group)


def swizzle(tile):
    """A box as TMA writes it with the 128-byte swizzle: (rows, 128)
    uint8, row r's 16-byte chunk c at chunk c ^ (r % 8)."""
    rows = tile.shape[0]
    out = np.zeros_like(tile)
    for c in range(8):
        dst = (c ^ (np.arange(rows) % 8))[:, None] * 16 + np.arange(16)
        out[np.arange(rows)[:, None], dst] = tile[:, c * 16:(c + 1) * 16]
    return out.reshape(-1)


def unswizzle(flat, rows):
    """The TMA store's read of a swizzled box: flat bytes → (rows, 128)."""
    sw = flat.reshape(rows, 128)
    out = np.zeros_like(sw)
    for c in range(8):
        src = (c ^ (np.arange(rows) % 8))[:, None] * 16 + np.arange(16)
        out[:, c * 16:(c + 1) * 16] = sw[np.arange(rows)[:, None], src]
    return out


def ldmatrix_x4_trans(smem, addr):
    """``ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16``: lanes 8j..8j+7
    address the 8 rows (16 bytes, 8 b16 elements each) of matrix j; lane
    (g, t) gets, of each matrix, elements (2t, g) in the low half and
    (2t + 1, g) in the high half. Returns uint32 (32, 4)."""
    b16 = np.zeros((4, 8, 8), np.uint32)
    for j in range(4):
        for i in range(8):
            row = smem[addr[8 * j + i]:addr[8 * j + i] + 16]
            b16[j, i] = row.view(np.uint16).astype(np.uint32)
    out = np.zeros((32, 4), np.uint32)
    for j in range(4):
        out[:, j] = b16[j, 2 * T4, G8] | (b16[j, 2 * T4 + 1, G8] << 16)
    return out


def widen_pair(words):
    """pf::widen_pair: uint32 words → (lo, hi) bf16 pairs as uint32. A
    byte permute puts bytes 0, 2 (lo) or 1, 3 (hi) under 0x43 in each
    16-bit half; v1 keeps a byte's low 7 bits (128 + (b & 127)), v2 its
    sign bit (128 or 256); the bf16x2 difference v1 − v2 is exact."""
    out = []
    for sel in (tq8.PF_PERM_LO, tq8.PF_PERM_HI):
        t = byte_perm(words, 0x43434343, sel)
        v1 = bf16_pair(t & np.uint32(0xFF7FFF7F))
        v2 = bf16_pair(t & np.uint32(0xFF80FF80))
        d = (v1 - v2).astype(np.float32)        # exact: integers, |d| <= 128
        bits = d.view(np.uint32) >> np.uint32(16)
        assert np.array_equal(bf16_bits_to_f32(bits), d)
        out.append(bits[..., 0] | (bits[..., 1] << np.uint32(16)))
    return out[0], out[1]


def bf16_pair(words):
    """uint32 words as their two bf16 halves, f32 (..., 2): low, high."""
    w = np.asarray(words, np.uint32)
    return np.stack([bf16_bits_to_f32(w & np.uint32(0xFFFF)),
                     bf16_bits_to_f32(w >> np.uint32(16))], axis=-1)


def bf16_bits_to_f32(bits):
    return (np.asarray(bits, np.uint32) << np.uint32(16)).view(np.float32)


def a_fragments(wsmem, wg, kt_step):
    """The A operand of k16 step ``kt_step`` (0-3) of a K-tile that one
    consumer warpgroup builds in its registers, as wgmma reads them:
    (64 fragment rows, 16 k) f32. Each warp loads the 32-k half holding
    the step with one pair-ldmatrix.trans and widens it."""
    a = np.zeros((64, 16), np.float32)
    half, second = kt_step // 2, kt_step % 2
    for w4 in range(4):
        chunk = wg * 4 + w4
        k = 32 * half + LANE
        addr = k * 128 + ((chunk ^ (LANE & 7)) << 4)
        r = ldmatrix_x4_trans(wsmem, addr)
        regs = []
        for j in (2 * second, 2 * second + 1):
            lo, hi = widen_pair(r[:, j])
            regs += [lo, hi]
        # register q of lane (g, t): rows g + 8·(q % 2), k 2t + 8·(q // 2)
        # (low half) and k + 1 (high half)
        for q, reg in enumerate(regs):
            row = 16 * w4 + G8 + 8 * (q % 2)
            col = 2 * T4 + 8 * (q // 2)
            a[row, col] = bf16_bits_to_f32(reg & np.uint32(0xFFFF))
            a[row, col + 1] = bf16_bits_to_f32(reg >> np.uint32(16))
    return a


def prefill(x, q, s):
    """x (M, K) f32 or bf16 tensor, q (K, N) int8, s (N,) → the kernel's
    (M, N) in x's dtype, M > 8, K % 8 == 0 and N % 16 == 0 (the layouts
    the kernel takes), at the kernel's token width for that dtype."""
    m, k = x.shape
    n = q.shape[1]
    out_f32 = x.dtype == torch.float32
    bt = tq8.prefill_tokens(out_f32)
    xb = x.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint8)
    xb = xb.reshape(m, 2 * k)
    qn = q.numpy().view(np.uint8)
    sc = s.reshape(-1).float().numpy()
    kt_all = -(-k // 64)
    out = np.zeros((m, n), np.float32)
    esize = 4 if out_f32 else 2
    for m_t in range(-(-m // bt)):
        for n_t in range(-(-n // CH)):
            m0, n0 = m_t * bt, n_t * CH
            acc = np.zeros((2, 64, bt), np.float32)
            for kt in range(kt_all):
                # TMA: x's box {64 k, bt tokens}, W's {128 channels, 64 k},
                # zeros past the edges
                xt = np.zeros((bt, 128), np.uint8)
                xs = xb[m0:m0 + bt, 2 * 64 * kt:2 * 64 * (kt + 1)]
                xt[:xs.shape[0], :xs.shape[1]] = xs
                wt = np.zeros((64, 128), np.uint8)
                ws = qn[64 * kt:64 * (kt + 1), n0:n0 + CH]
                wt[:ws.shape[0], :ws.shape[1]] = ws
                xsmem = swizzle(xt)
                wsmem = swizzle(wt)
                # x as wgmma's K-major B: row r's 16-byte chunk c at
                # chunk c ^ (r % 8), read back by the descriptor
                xmat = bf16_bits_to_f32(unswizzle(xsmem, bt).view(np.uint16)
                                        .astype(np.uint32))      # (bt, 64)
                for step in range(4):
                    bmat = xmat[:, 16 * step:16 * (step + 1)].T  # (16, bt)
                    for wg in range(2):
                        acc[wg] += a_fragments(wsmem, wg, step) @ bmat
            # the epilogue: register 4j + 2h + e of warp w4, lane (g, t)
            # is fragment row 16·w4 + g + 8h, token 8j + 2t + e; the
            # kernel stores rows g and g + 8 as channels 2g and 2g + 1
            for wg in range(2):
                cbuf = np.zeros(bt * 64 * esize, np.uint8)
                for w4 in range(4):
                    ch = w4 * 16 + 2 * G8                   # (32,)
                    gc = n0 + wg * 64 + ch
                    s0 = np.where(gc < n, sc[np.minimum(gc, n - 1)], 0)
                    s1 = np.where(gc + 1 < n, sc[np.minimum(gc + 1, n - 1)],
                                  0)
                    for j in range(bt // 8):
                        for e in range(2):
                            r = 8 * j + 2 * T4 + e              # tokens
                            v0 = acc[wg, 16 * w4 + G8, r] \
                                * s0.astype(np.float32)
                            v1 = acc[wg, 16 * w4 + G8 + 8, r] \
                                * s1.astype(np.float32)
                            if out_f32:
                                box = (ch // 32) * (bt * 128)
                                at = (box + r * 128 + ((((ch % 32) // 4)
                                                        ^ (r & 7)) << 4)
                                      + (ch % 4) * 4)
                                pair = np.stack([v0, v1], -1).astype(
                                    np.float32).view(np.uint8)
                                for b in range(8):
                                    cbuf[at + b] = pair[:, b]
                            else:
                                at = (r * 128 + (((ch // 8) ^ (r & 7)) << 4)
                                      + (ch % 8) * 2)
                                pair = torch.from_numpy(
                                    np.stack([v0, v1], -1).astype(np.float32)
                                ).to(torch.bfloat16).view(torch.int16)
                                pair = pair.numpy().view(np.uint8)
                                for b in range(4):
                                    cbuf[at + b] = pair[:, b]
                # the TMA store: each box unswizzled, clipped to (M, N)
                per = 128 // esize
                for box in range(64 // per):
                    rows = unswizzle(cbuf[box * bt * 128:(box + 1) * bt * 128],
                                     bt)
                    vals = (rows.view(np.float32) if out_f32 else
                            bf16_bits_to_f32(rows.view(np.uint16)
                                             .astype(np.uint32)))
                    c0 = n0 + wg * 64 + box * per
                    mm, nn = min(bt, m - m0), min(per, n - c0)
                    if mm > 0 and nn > 0:
                        out[m0:m0 + mm, c0:c0 + nn] = vals[:mm, :nn]
    return torch.from_numpy(out).to(x.dtype)
