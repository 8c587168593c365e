"""The branch choices of the softmax and pool kernels, the f32 matmul
kernels' tiles, and the bf16 matmul plan, on the CPU.

``ops.softmax.softmax_plan`` and ``ops.pool.pool_plan`` are pure
functions of the shape, dtype and alignment; the C entry points
(``csrc/softmax.cu``, ``csrc/pool.cu``) check each plan with
``plan_ok`` and refuse one they cannot run. Here every width gets a plan
that the C checks (mirrored below, their constants read from the
sources) accept, the boundaries fall where the card tests in
``tests/test_torch_cuda.py`` expect them, and the plain versions that a
CPU tensor takes agree with the JAX ops at widths on both sides of each
boundary.
"""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lua_mapreduce_tpu import ops as jops
from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.ops import _build, alignment

# the modules (``ops.softmax`` is also the name of the op)
tsoft = importlib.import_module("lua_mapreduce_tpu_torch.ops.softmax")
tpool = importlib.import_module("lua_mapreduce_tpu_torch.ops.pool")
tmm = importlib.import_module("lua_mapreduce_tpu_torch.ops.matmul")

DTYPES = (torch.float32, torch.bfloat16)


def _defines(name):
    text = (_build.CSRC / _build.SOURCES[name]).read_text()
    plain = {k: int(v) for k, v in
             re.findall(r"^#define (\w+) (\d+)$", text, re.M)}
    lists = {k: tuple(int(v) for v in re.findall(r"X\((\d+)\)", body))
             for k, body in re.findall(r"^#define (\w+)\(X\) (.*)$", text,
                                       re.M)}
    return plain, lists


def test_softmax_constants_match_the_source():
    plain, lists = _defines("softmax")
    assert plain == {"WARP_MAX_N": tsoft.WARP_MAX_N,
                     "WARP_ROWS": tsoft.WARP_ROWS,
                     "REGS_MAX_THREADS": tsoft.REGS_MAX_THREADS,
                     "STREAM_THREADS": tsoft.STREAM_THREADS,
                     "STREAM_LOADS": tsoft.STREAM_LOADS}
    assert lists == {"WARP_ELEMS": tsoft.WARP_ELEMS,
                     "REGS_ELEMS": tsoft.REGS_ELEMS}
    assert tsoft.REGS_MAX_N == 16384


def test_pool_constants_match_the_source():
    plain, lists = _defines("pool")
    assert plain == {"POOL_MAX_THREADS": tpool.POOL_MAX_THREADS,
                     "POOL_MAX_GRID_YZ": tpool.POOL_MAX_GRID_YZ}
    assert lists == {}


def test_matmul_f32_constants_match_the_wrapper():
    """The wrapper's grid limit follows csrc/matmul.cu's f32 tiles: M
    rides grid.y in every kernel, so the shortest tile bounds the rows of
    any f32 product; k-means' 10⁶ rows take 7,813 rows of 128-row tiles.
    The small tile's reach holds the digits step's products and not
    k-means' or ALS's."""
    plain, _ = _defines("matmul")
    tile_m = min(plain["F32_SMALL_TILE"], plain["F32_BM"])
    assert tmm._TILE_M[torch.float32] == tile_m
    assert -(-1_000_000 // plain["F32_BM"]) == 7813 <= tmm._MAX_GRID_Y
    assert 256 * 128 <= plain["F32_SMALL_MN"] < 1024 * 128
    assert plain["F32_SMALL_MN"] < 3706 * 64
    rows = tmm._MAX_GRID_Y * tile_m
    with pytest.raises(ValueError, match="grid limit"):
        tmm.matmul_cuda(torch.zeros(1, 1).expand(rows + 1, 1),
                        torch.zeros(1, 1), torch.float32)


def _f32_copies(mode, cols, nt, bk, pad):
    """csrc/matmul.cu's f32w::Loader: every copy of one operand's K-tile
    as (thread, j, k, c, floats), for a tile whose axis c is ``cols``
    wide (M of A, N of B) and ``nt`` threads."""
    w = {"v16": 4, "v8": 2, "e4c": 1, "e4k": 1}[mode]
    kg = bk // 8
    dk = 0 if mode == "e4k" else nt // (cols // w)
    dc = 4 * (nt // 32) // kg if mode == "e4k" else 0
    out = []
    for tid in range(nt):
        if mode == "e4k":
            kb = tid % 8 + 8 * ((tid // 32) % kg)
            cb = 4 * ((tid // 32) // kg) + (tid // 8) % 4
        else:
            kb, cb = tid // (cols // w), (tid % (cols // w)) * w
        for j in range(bk * cols // w // nt):
            out.append((tid, j, kb + j * dk, cb + j * dc, w))
    return out


def _conflicts(words_by_lane, lanes_per_phase):
    """Bank conflicts of one warp-wide shared-memory access: the lanes go
    in phases of ``lanes_per_phase``; two lanes of a phase conflict when
    they touch different words of one bank (one word is a broadcast)."""
    bad = 0
    for p0 in range(0, 32, lanes_per_phase):
        banks = {}
        for lane in range(p0, p0 + lanes_per_phase):
            for word in words_by_lane.get(lane, ()):
                banks.setdefault(word % 32, set()).add(word)
        bad += sum(len(ws) - 1 for ws in banks.values())
    return bad


@pytest.mark.parametrize("bm,bn", [("F32_BM", "F32_BN"),
                                   ("F32_BM", "F32_BN_NARROW")])
def test_matmul_f32_tile_copies_and_reads_are_conflict_free(bm, bn):
    """The wide f32 kernels' shared-memory accesses, mirrored from
    csrc/matmul.cu with its constants: every copy mode fills each K-tile
    of A (BM wide) and B (BN wide) exactly once, and no copy and no
    fragment read has a bank conflict (16-byte accesses go in phases of
    8 lanes, 8-byte in 16, 4-byte in 32)."""
    plain, _ = _defines("matmul")
    bm, bn = plain[bm], plain[bn]
    bk, pad = plain["F32_BK"], plain["F32_PAD"]
    nt = (bm // 8) * (bn // 8)
    for cols in (bm, bn):
        ld = cols + pad
        for mode in ("v16", "v8", "e4c", "e4k"):
            copies = _f32_copies(mode, cols, nt, bk, pad)
            cells = [(k, c + e) for _, _, k, c, w in copies for e in range(w)]
            assert sorted(cells) == [(k, c) for k in range(bk)
                                     for c in range(cols)], mode
            w = copies[0][4]
            for warp in range(nt // 32):
                for j in range(bk * cols // w // nt):
                    words = {t % 32: [k * ld + c + e for e in range(w)]
                             for t, jj, k, c, _ in copies
                             if t // 32 == warp and jj == j}
                    assert _conflicts(words, {4: 8, 2: 16, 1: 32}[w]) == 0, (
                        mode, cols, warp, j)
    # fragment reads: thread (tx, ty) reads 16 bytes at k·LD + ty·4 and
    # + BM/2 of A, at k·LD + tx·4 and + BN/2 of B
    tx_n = bn // 8
    for warp in range(nt // 32):
        for k in range(bk):
            for half in (0, 1):
                for cols, of in ((bm, lambda t: t // tx_n),
                                 (bn, lambda t: t % tx_n)):
                    ld = cols + pad
                    words = {}
                    for lane in range(32):
                        base = k * ld + of(warp * 32 + lane) * 4 + \
                            half * cols // 2
                        words[lane] = [base + e for e in range(4)]
                    assert _conflicts(words, 8) == 0, (cols, warp, k)


def _softmax_plan_ok(p, rows, n, item, align):
    """csrc/softmax.cu::plan_ok for pointers and pitches that are
    ``align``-byte aligned."""
    if not (32 <= p.threads <= 1024 and p.threads % 32 == 0):
        return False
    w = 16 // item if p.vector else 1
    if p.vector and (align < 16 or n % w):
        return False
    if p.branch == "warp":
        return (n <= tsoft.WARP_MAX_N and p.per_thread in tsoft.WARP_ELEMS
                and p.per_thread % w == 0 and 32 * p.per_thread >= n
                and p.rows_per_block == tsoft.WARP_ROWS
                and p.threads == 32 * tsoft.WARP_ROWS
                and p.blocks == -(-rows // tsoft.WARP_ROWS))
    if p.branch == "regs":
        return (p.per_thread in tsoft.REGS_ELEMS and p.per_thread % w == 0
                and p.threads <= tsoft.REGS_MAX_THREADS
                and p.threads * p.per_thread >= n
                and p.rows_per_block == 1 and p.blocks == rows)
    return (p.branch == "stream" and p.per_thread == tsoft.STREAM_LOADS
            and p.threads == tsoft.STREAM_THREADS
            and p.rows_per_block == 1 and p.blocks == rows)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("align", [16, 2])
def test_every_width_gets_a_legal_softmax_plan(dtype, align):
    item = 4 if dtype == torch.float32 else 2
    branches = set()
    for n in range(1, 70001):
        rows = 1 + n % 7
        p = tsoft.softmax_plan(rows, n, dtype, align)
        assert _softmax_plan_ok(p, rows, n, item, align), (n, p)
        assert p.vector == (align == 16 and n * item % 16 == 0), (n, p)
        branches.add(p.branch)
    assert branches == set(tsoft.BRANCHES)


# (n, branch) at and one past each boundary, as the card tests take them
SOFTMAX_EDGES = [(1, "warp"), (10, "warp"), (1024, "warp"), (1025, "regs"),
                 (16384, "regs"), (16385, "stream"), (70000, "stream")]


@pytest.mark.parametrize("n,branch", SOFTMAX_EDGES)
def test_softmax_boundaries(n, branch):
    for dtype in DTYPES:
        for align in (16, 4):
            assert tsoft.softmax_plan(3, n, dtype, align).branch == branch


@pytest.mark.parametrize("rows,n,name", [
    (8192, 8192, "regs/v16"), (1024, 32768, "stream/v16"),
    (32, 1000, "warp/v16"), (1024, 10, "warp/scalar"),
    (128, 10, "warp/scalar")])
def test_softmax_main_path_shapes_take_their_branches(rows, n, name):
    """The wide trainer's, the vocab-wide, ResNet's and LeNet's logits
    (bf16) and the digits' (f32, 40-byte rows: scalar)."""
    dtype = torch.float32 if (rows, n) == (128, 10) else torch.bfloat16
    assert tsoft.softmax_plan(rows, n, dtype, 16).name == name


def test_softmax_kernel_plan_reads_the_layout():
    x = torch.zeros(4, 1032)                    # a 4128-byte pitch
    assert tsoft.softmax_kernel_plan(x[:, 8:]).name == "warp/v16"
    assert tsoft.softmax_kernel_plan(x[:, 1:1025]).name == "warp/scalar"
    assert tsoft.softmax_kernel_plan(x[:, :1025]).name == "regs/scalar"
    x2, ldx, _ = tsoft._rows_view(x[:, 1:])
    assert ldx == 1032 and x2.data_ptr() == x[:, 1:].data_ptr()
    x2, ldx, _ = tsoft._rows_view(torch.zeros(8, 6).t())  # copied
    assert ldx == 8 and x2.is_contiguous()
    assert alignment(48, 1025 * 4) == 4 and alignment(0, 4096) == 16


def test_softmax_plan_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError):
        tsoft.softmax_plan(2, 8, torch.float16, 16)
    with pytest.raises(ValueError):
        tsoft.softmax_plan(0, 8, torch.float32, 16)


def _pool_plan_ok(p, n, h, w, c, window, stride, item, align):
    """csrc/pool.cu::plan_ok for pointers that are ``align``-byte
    aligned."""
    (kh, kw), (sh, sw) = window, stride
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    chunk = p.width * item
    vector = chunk == 16
    if p.branch != ("vector" if vector else "general"):
        return False
    if not (p.width == 1 or (item == 2 and p.width == 2) or vector):
        return False
    if c % p.width or align % chunk:
        return False
    bx, by, bz = p.block
    gx, gy, gz = p.grid
    return (1 <= bx <= c // p.width and by >= 1 and bz >= 1
            and bx * by * bz <= tpool.POOL_MAX_THREADS
            and min(gx, gy, gz) >= 1 and gx * by >= wo and gy * bz >= ho
            and gy <= tpool.POOL_MAX_GRID_YZ and gz <= tpool.POOL_MAX_GRID_YZ
            and gz <= n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window,stride", [((2, 2), (2, 2)), ((3, 3), (2, 2)),
                                           ((3, 2), (1, 2)), ((1, 1), (1, 1))])
def test_every_pool_shape_gets_a_legal_plan(dtype, window, stride):
    item = 4 if dtype == torch.float32 else 2
    for c in range(1, 300):
        for hw in (3, 10, 28, 114, 300):
            for align in (16, 8, 4, 2)[: 3 if item == 4 else 4]:
                n = 1 + (c + hw) % 5
                p = tpool.pool_plan(n, hw, hw + 1, c, window, stride, dtype,
                                    align)
                assert _pool_plan_ok(p, n, hw, hw + 1, c, window, stride,
                                     item, align), (c, hw, align, p)
    big = tpool.pool_plan(100000, 4, 4, 8, (2, 2), (2, 2), dtype, 16)
    assert big.grid[2] == tpool.POOL_MAX_GRID_YZ      # images loop


@pytest.mark.parametrize("c,dtype,align,name", [
    (64, torch.bfloat16, 16, "vector/w8"), (16, torch.bfloat16, 16,
                                            "vector/w8"),
    (8, torch.bfloat16, 16, "vector/w8"), (6, torch.bfloat16, 16,
                                           "general/w2"),
    (5, torch.bfloat16, 16, "general/w1"), (64, torch.bfloat16, 2,
                                            "general/w1"),
    (64, torch.bfloat16, 4, "general/w2"), (4, torch.float32, 16,
                                            "vector/w4"),
    (6, torch.float32, 16, "general/w1"), (64, torch.float32, 8,
                                           "general/w1")])
def test_pool_boundaries(c, dtype, align, name):
    p = tpool.pool_plan(4, 12, 12, c, (3, 3), (2, 2), dtype, align)
    assert p.name == name


def test_pool_main_path_shapes_take_their_branches():
    bf = torch.bfloat16
    stem = tpool.pool_plan(32, 114, 114, 64, (3, 3), (2, 2), bf, 16)
    assert stem.name == "vector/w8" and stem.block == (8, 28, 1)
    assert tpool.pool_plan(1024, 10, 10, 16, (2, 2), (2, 2), bf,
                           16).name == "vector/w8"
    assert tpool.pool_plan(1024, 28, 28, 6, (2, 2), (2, 2), bf,
                           16).name == "general/w2"


def test_pool_plan_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError):
        tpool.pool_plan(1, 4, 4, 2, (2, 2), (2, 2), torch.float16, 16)
    with pytest.raises(ValueError, match="32 bits"):
        tpool.pool_plan(1, 2 ** 16, 2 ** 16, 1024, (2, 2), (2, 2),
                        torch.float32, 16)
    with pytest.raises(ValueError):
        tpool.pool_plan(1, 4, 4, 2, (5, 5), (1, 1), torch.float32, 16)


# ---- JAX parity of the plain versions at widths across the boundaries

@pytest.mark.parametrize("n", [1024, 1025, 16384, 16385])
def test_softmax_across_boundaries_matches_jax(n):
    x = np.random.RandomState(n).randn(2, n).astype(np.float32) * 6.0
    for jfn, tfn in ((jops.log_softmax, ops.log_softmax),
                     (jops.softmax, ops.softmax)):
        want = np.asarray(jfn(jnp.asarray(x), backend="pallas_interpret"))
        got = tfn(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("c", [5, 6, 8, 16, 64])
@pytest.mark.parametrize("mode", ["max", "avg"])
def test_pool_across_channel_widths_matches_jax(c, mode):
    x = np.random.RandomState(c).randn(2, 11, 11, c).astype(np.float32)
    jfn = jops.maxpool2d if mode == "max" else jops.avgpool2d
    tfn = ops.maxpool2d if mode == "max" else ops.avgpool2d
    for window, stride in ((2, 2), (3, 2)):
        want = np.asarray(jfn(jnp.asarray(x), window, stride,
                              backend="pallas_interpret"))
        got = tfn(torch.from_numpy(x), window, stride).numpy()
        if mode == "max":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---- the q8 GEMV (M <= 8): its plan, its widening, its order of sums

tq8 = importlib.import_module("lua_mapreduce_tpu_torch.ops.q8")
# the SMs an H100 SXM (132 SMs) gives clusters of 1, 2, 4 and 8 GEMV CTAs,
# as the card's occupancy query reports them (csrc/q8.cu::cluster_sms;
# chip_smoke.py prints them): a cluster lands within one GPC
H100_CLUSTER_SMS = (132, 132, 124, 120)
# (K, N) of the serving and MoE serving cells' decode products: qkv,
# out, ff1, ff2 (the dense FFN; MoE keeps its experts in full precision)
# and the head, with the (strip width, split) the plan gives each: the
# fastest of phase 2's sweep of every plan on the card
DECODE_PLANS = {(1024, 3072): (128, 4), (1024, 1024): (128, 8),
                (1024, 4096): (64, 2), (4096, 1024): (128, 8),
                (1024, 32768): (128, 1)}
# test_torch_cuda.py's M <= 8 cases of test_q8_kernel_matches_plain
CARD_GEMV_SHAPES = [(1, 256, 128), (4, 1024, 3072), (4, 4096, 1024),
                    (3, 1100, 200), (8, 300, 501), (5, 1030, 520),
                    (7, 96, 17), (2, 20000, 16)]


def test_q8_gemv_constants_match_the_source():
    plain, lists = _defines("q8")
    assert plain == {"GEMV_NT": tq8.GEMV_NT, "GEMV_MAX_M": tq8.GEMV_MAX_M,
                     "GEMV_MAX_CLUSTER": tq8.GEMV_MAX_CLUSTER,
                     "GEMV_XCH": tq8.GEMV_XCH,
                     "GEMV_CTA_COST": tq8.GEMV_CTA_COST,
                     "GEMV_STAGES": tq8.GEMV_STAGES}
    assert lists == {"GEMV_COLS": tq8.GEMV_COLS}
    text = (_build.CSRC / _build.SOURCES["q8"]).read_text()
    hexes = {k: int(v, 16) for k, v in re.findall(
        r"^#define (GEMV_\w+) (0x[0-9A-Fa-f]+)u$", text, re.M)}
    assert hexes == {"GEMV_SIGN_FLIP": tq8.GEMV_SIGN_FLIP,
                     "GEMV_MAGIC": tq8.GEMV_MAGIC,
                     "GEMV_PERM": tq8.GEMV_PERM}
    bias = re.findall(r"WIDEN_BIAS = (\d+)\.f;", text)
    assert [float(b) for b in bias] == [tq8.GEMV_WIDEN_BIAS] == [2.0 ** 23
                                                                 + 128]
    # the widest strip is what a warp's 8 column groups load in one row
    assert tq8.GEMV_COLS[0] == 8 * 16 and tq8.GEMV_COLS[-1] == 2 * 16


def _assert_legal_gemv_plan(m, k, n, cluster_sms):
    p = tq8.gemv_plan(k, n, cluster_sms)
    assert p.cols in tq8.GEMV_COLS, p
    # one cluster spans the split axis: a power of two up to 8, no more
    # than K's steps
    assert 1 <= p.split <= tq8.GEMV_MAX_CLUSTER, p
    assert p.split & (p.split - 1) == 0, p
    assert p.split == 1 or p.split <= -(-k // p.k_lanes), p
    # every column once: the strips, and in each its 16-column groups
    ncols = sorted(bx * p.cols + g * 16 + c for bx in range(p.strips)
                   for g in range(p.cols // 16) for c in range(16)
                   if bx * p.cols + g * 16 + c < n)
    assert ncols == list(range(n)), p
    # every k row once: the ranks' K-slices, x's chunks in each, each
    # chunk's rows over the CTA's K-lanes
    ksb = p.k_lanes
    rows_seen = []
    for rank in range(p.split):
        kbeg, kend = rank * p.kper, min(k, (rank + 1) * p.kper)
        assert kend > kbeg, p                     # no rank is idle
        for c0 in range(kbeg, kend, tq8.GEMV_XCH):
            c1 = min(kend, c0 + tq8.GEMV_XCH)
            rows = -(-(c1 - c0) // ksb)
            assert rows * ksb <= tq8.GEMV_XCH          # x's chunk fits
            for ks in range(ksb):
                rows_seen += [c0 + ks + r * ksb for r in range(rows)
                              if c0 + ks + r * ksb < c1]
    assert sorted(rows_seen) == list(range(k)), p
    # the output columns the cluster's ranks own: each once
    cw = p.cols // p.split
    assert cw >= 4 and sorted(r * cw + c for r in range(p.split)
                              for c in range(cw)) == list(range(p.cols))
    # shared memory under the 227 KB a CTA may take; at M <= 4 two CTAs
    # fit in an SM's 228 KB (the kernel's launch bounds ask for two)
    smem = tq8.gemv_smem_bytes(m, p.cols)
    assert smem <= 227 * 1024
    assert m > 4 or 2 * smem <= 228 * 1024
    return p


@pytest.mark.parametrize("k,n", sorted(DECODE_PLANS))
def test_q8_gemv_decode_shapes_take_their_plans(k, n):
    """At the H100's cluster SMs every decode product of the serving and
    MoE serving cells, at every M of the GEMV, gets a legal plan, the one
    phase 2 timed fastest, and no SM holds two of its CTAs but the
    head's (256 strips over 132 SMs); only the head is not split."""
    for m in range(1, tq8.GEMV_MAX_M + 1):
        p = _assert_legal_gemv_plan(m, k, n, H100_CLUSTER_SMS)
        assert (p.cols, p.split) == DECODE_PLANS[(k, n)], p
        per_sm = -(-p.ctas // H100_CLUSTER_SMS[p.split.bit_length() - 1])
        assert per_sm == (2 if n == 32768 else 1), p
        assert (p.split == 1) == (n == 32768), p


@pytest.mark.parametrize("m,k,n", CARD_GEMV_SHAPES)
def test_q8_gemv_card_test_shapes_get_legal_plans(m, k, n):
    _assert_legal_gemv_plan(m, k, n, H100_CLUSTER_SMS)


def test_q8_gemv_plans_are_legal_across_shapes():
    rng = np.random.RandomState(3)
    tables = [H100_CLUSTER_SMS, (1, 1, 1, 1), (8, 8, 8, 8),
              (114, 112, 112, 104)]
    for _ in range(300):
        k, n = int(rng.randint(1, 5000)), int(rng.randint(1, 3000))
        table = tables[int(rng.randint(len(tables)))]
        _assert_legal_gemv_plan(int(rng.randint(1, 9)), k, n, table)


def test_q8_gemv_plan_keeps_one_cta_an_sm_where_it_can():
    """A grid that puts two CTAs on some SM is taken only where every
    grid of that shape does (N alone past the cluster SMs) or it halves
    the work of the busiest SM's CTA."""
    for k, n in [(1024, 1024), (1024, 4096), (4096, 1024), (2048, 2048),
                 (512, 8192), (1024, 16384), (8192, 512)]:
        p = tq8.gemv_plan(k, n, H100_CLUSTER_SMS)
        lg = p.split.bit_length() - 1
        if p.ctas > H100_CLUSTER_SMS[lg]:
            fits = [tq8.GemvPlan(c, 2 ** i, -(-k // 2 ** i), -(-n // c))
                    for c in tq8.GEMV_COLS for i in range(4)
                    if -(-n // c) * 2 ** i <= H100_CLUSTER_SMS[i]]
            assert not fits or min(
                -(-f.kper // f.k_lanes) for f in fits) >= \
                2 * -(-p.kper // p.k_lanes), (k, n, p)


def test_q8_gemv_widening_is_exact_for_every_byte():
    """The byte permute into 2^23 with the sign bit flipped, less
    2^23 + 128, gives float(q) for all 256 bytes, at each byte position
    of a word."""
    from torch_q8_gemv_model import widen
    b = np.arange(256, dtype=np.uint32)
    want = b.astype(np.uint8).view(np.int8).astype(np.float32)
    for pos in range(4):
        got = widen(b << np.uint32(8 * pos))[:, pos]
        np.testing.assert_array_equal(got, want)
    assert widen(np.array([0x807F0181], np.uint32)).tolist() == \
        [[-127.0, 1.0, 127.0, -128.0]]


@pytest.mark.parametrize("m,k,n", CARD_GEMV_SHAPES + [(4, 1024, 1024)])
def test_q8_gemv_model_matches_plain_and_jax(m, k, n):
    """The kernel's sums in its order (tests/torch_q8_gemv_model.py, the
    card's bits) against the plain version and the JAX op in interpret
    mode, on x already rounded to bf16, at test_q8.py's tolerance."""
    from torch_q8_gemv_model import gemv
    rng = np.random.RandomState(m * 7 + n)
    w = rng.randn(k, n).astype(np.float32)
    x = np.array(jnp.asarray(rng.randn(m, k), jnp.bfloat16)
                 .astype(jnp.float32))
    q, s = ops.quantize_q8(torch.from_numpy(w))
    got = gemv(torch.from_numpy(x), q, s.reshape(-1), H100_CLUSTER_SMS)
    plain = tq8.q8_matmul_plain(torch.from_numpy(x), q, s)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-2,
                               atol=2e-2)
    jq, js = jops.quantize_q8(jnp.asarray(w))
    want = np.asarray(jops.q8_matmul(jnp.asarray(x), jq, js,
                                     backend="pallas_interpret"))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    # bf16 x: the model casts as the kernel's store does
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = gemv(xb, q, s.reshape(-1), H100_CLUSTER_SMS)
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), plain.numpy(),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------- B1's bf16 plan (matmul.cu)

# csrc/matmul.cu's bf16_plan mirror (ops.matmul.bf16_plan): the SMs
# clusters of 1-8 wgmma CTAs can use on the H100 SXM, by size
# (lmr_matmul_cluster_sms on the card)
H100_SMS = 132
H100_WGMMA_CLUSTER_SMS = (132, 132, 117, 120, 110, 102, 105, 120)
BF16_PLAN_CONSTANTS = ("BF16_PEAK_GFLOPS", "WG_RATE_PCT", "WG64_RATE_PCT",
                       "GEN_RATE_PCT",
                       "HBM_GBS", "REGS_STORE_GBS", "ITEM_NS", "CTA_NS",
                       "CLUSTER_NS", "GEN_STEP_NS", "SLAB_NS",
                       "WG_MAX_CLUSTER")


def _commented_defines(name):
    """``#define NAME value`` lines of a source, a trailing comment
    allowed."""
    text = (_build.CSRC / _build.SOURCES[name]).read_text()
    return {k: int(v) for k, v in re.findall(
        r"^#define (\w+) (\d+)\s*(?://.*)?$", text, re.M)}


def test_matmul_bf16_plan_constants_match_the_source():
    found = _commented_defines("matmul")
    assert {k: found[k] for k in BF16_PLAN_CONSTANTS} == \
        {k: getattr(tmm, k) for k in BF16_PLAN_CONSTANTS}
    # the general kernel's staging: all K of 128 patches rows at the
    # stem's pitch is one slab, and 64 rows of a 128-wide g one ring slot
    assert 128 * 152 <= found["GEN_RAW_ONCE"]
    assert 64 * 128 <= found["GEN_RAW_TILE"] and found["GEN_RSTAGES"] >= 2
    # a cluster split's ranks: at least 16 of a tile's 128 rows each,
    # in clusters of the portable size
    assert 128 // tmm.WG_MAX_CLUSTER >= 16 and tmm.WG_MAX_CLUSTER == 8


def _assert_legal_bf16_plan(m, n, k, path, cluster_sms, per_sm=2):
    p = tmm.bf16_plan(m, n, k, path, H100_SMS, cluster_sms, per_sm)
    units = -(-k // 64)
    # the tile: 64 wide for N <= 64; on the wgmma kernel 64 or 128 for
    # N <= 128, else 64, 128 or 256 (the general kernel: 64, else 128)
    if n <= 64:
        assert p.bn == 64, p
    elif path == tmm.PATH_TMA:
        assert p.bn in ((64, 128) if n <= 128 else (64, 128, 256)), p
    else:
        assert p.bn == 128, p
    # every rank takes K: whole K-tiles of 64, the last rank the rest
    assert 1 <= p.splits <= units, p
    assert p.chunk == -(-units // p.splits), p
    assert -(-units // p.chunk) == p.splits, p
    assert (p.splits - 1) * p.chunk < units <= p.splits * p.chunk, p
    if units == 1:
        assert p.splits == 1, p
    # a cluster sums the split: up to the allowed size, one that fits
    # on the card, on the wgmma kernel; its ranks own the tile's 128
    # rows, each row once (rank r·cluster // 128), none empty
    if p.cluster > 1:
        assert path == tmm.PATH_TMA and p.cluster == p.splits, p
        assert p.cluster <= tmm.WG_MAX_CLUSTER, p
        assert cluster_sms[p.cluster - 1] > 0, p
        owners = [r * p.cluster // 128 for r in range(128)]
        assert sorted(set(owners)) == list(range(p.cluster)), p
        most = -(-128 // p.cluster)
        assert max(owners.count(o) for o in set(owners)) <= most, p
    else:
        assert p.cluster == 1, p
    # the TMA store: an unsplit 64- or 128-wide tile whose bf16 rows are
    # 16-byte multiples; the general kernel stores from registers
    if p.epi == tmm.EPI_NAMES.index("tma"):
        assert path == tmm.PATH_TMA and p.splits == 1, p
        assert p.bn <= 128 and n % 8 == 0, p
    return p


def test_matmul_bf16_plans_are_legal_across_shapes():
    rng = np.random.RandomState(5)
    tables = [H100_WGMMA_CLUSTER_SMS, (132,) + (0,) * 7,
              (132, 132, 120, 120) + (0,) * 4, (8,) * 4 + (0,) * 4]
    for _ in range(300):
        m, n = int(rng.randint(1, 20000)), int(rng.randint(1, 3000))
        k = int(rng.choice([rng.randint(1, 600), rng.randint(1, 400000)]))
        path = (tmm.PATH_TMA, tmm.PATH_GENERAL)[int(rng.randint(2))]
        table = tables[int(rng.randint(len(tables)))]
        _assert_legal_bf16_plan(m, n, k, path, table,
                                int(rng.randint(1, 4)))


def test_matmul_bf16_plan_without_clusters_takes_the_slab():
    """A card whose clusters do not fit (the query's 0s) gets slab
    splits only; a product whose K is one tile is never split."""
    for m, n, k in [(576, 64, 100352), (1568, 512, 4608), (128, 256, 6272)]:
        p = tmm.bf16_plan(m, n, k, tmm.PATH_TMA, H100_SMS,
                          (132,) + (0,) * 7)
        assert p.cluster == 1, p
    for m, n in [(100352, 576), (1, 1), (25088, 128)]:
        assert tmm.bf16_plan(m, n, 64, tmm.PATH_TMA, H100_SMS,
                             H100_WGMMA_CLUSTER_SMS).splits == 1


def test_matmul_bf16_plan_keeps_the_wide_products_as_they_were():
    """The (8192,)×4 MLP's products (x·W, g·Wᵀ, hᵀ·g at 8192³) and the
    4096³ row keep the 128 × 256 tile, unsplit, stored from registers:
    the path designed for them, whose kernel code is unchanged."""
    for size in (4096, 8192):
        p = tmm.bf16_plan(size, size, size, tmm.PATH_TMA, H100_SMS,
                          H100_WGMMA_CLUSTER_SMS)
        assert (p.bn, p.splits, p.cluster, tmm.EPI_NAMES[p.epi]) == \
            (256, 1, 1, "regs"), p


def _bf16_path(m, k, n, sa, sb):
    """csrc/matmul.cu's choose_path for 16-byte aligned bf16 operands."""
    def tma(inner_stride, outer_stride, inner):
        return inner_stride == 1 and outer_stride >= inner and \
            outer_stride * 2 % 16 == 0
    a_ok = tma(sa[1], sa[0], k) or tma(sa[0], sa[1], m)
    b_ok = tma(sb[1], sb[0], n) or tma(sb[0], sb[1], k)
    return tmm.PATH_TMA if a_ok and b_ok else tmm.PATH_GENERAL


# the plan every conv product of the two trainers takes on the H100 (its
# SMs and cluster table above; the general kernel at two blocks an SM):
# (tile width, split, reduction, epilogue of an unsplit tile). LeNet c1's
# W and g (rows of 6) take the general kernel; LeNet c2's dA writes rows
# of 150 (300 bytes), which TMA cannot store.
CONV_PLANS = {
    "lenet c1 fwd": (64, 1, "none", "regs"),
    "lenet c1 dB": (64, 206, "slab", None),
    "lenet c2 fwd": (64, 1, "none", "tma"),
    "lenet c2 dA": (256, 1, "none", "regs"),
    "lenet c2 dB": (64, 58, "slab", None),
    "resnet stem fwd": (64, 1, "none", "tma"),
    "resnet stem dB": (64, 40, "slab", None),
    "resnet s0b0 conv1 fwd": (64, 1, "none", "tma"),
    "resnet s0b0 conv1 dA": (128, 1, "none", "tma"),
    "resnet s0b0 conv1 dB": (64, 13, "slab", None),
    "resnet s1b0 conv1 fwd": (128, 1, "none", "tma"),
    "resnet s1b0 conv1 dA": (128, 1, "none", "tma"),
    "resnet s1b0 conv1 dB": (64, 12, "slab", None),
    "resnet s1b0 conv2 fwd": (128, 1, "none", "tma"),
    "resnet s1b0 conv2 dA": (128, 1, "none", "tma"),
    "resnet s1b0 conv2 dB": (128, 8, "cluster", None),
    "resnet s1b0 proj fwd": (128, 1, "none", "tma"),
    "resnet s1b0 proj dA": (64, 1, "none", "tma"),
    "resnet s1b0 proj dB": (64, 56, "slab", None),
    "resnet s2b0 conv1 fwd": (128, 1, "none", "tma"),
    "resnet s2b0 conv1 dA": (128, 1, "none", "tma"),
    "resnet s2b0 conv1 dB": (128, 5, "cluster", None),
    "resnet s2b0 conv2 fwd": (128, 1, "none", "tma"),
    "resnet s2b0 conv2 dA": (128, 1, "none", "tma"),
    "resnet s2b0 conv2 dB": (128, 3, "cluster", None),
    "resnet s2b0 proj fwd": (128, 1, "none", "tma"),
    "resnet s2b0 proj dA": (64, 1, "none", "tma"),
    "resnet s2b0 proj dB": (128, 25, "slab", None),
    "resnet s3b0 conv1 fwd": (256, 4, "cluster", None),
    "resnet s3b0 conv1 dA": (128, 1, "none", "tma"),
    "resnet s3b0 conv1 dB": (128, 1, "none", "tma"),
    "resnet s3b0 conv2 fwd": (256, 4, "cluster", None),
    "resnet s3b0 conv2 dA": (128, 1, "none", "tma"),
    "resnet s3b0 conv2 dB": (256, 1, "none", "regs"),
    "resnet s3b0 proj fwd": (64, 1, "none", "tma"),
    "resnet s3b0 proj dA": (64, 1, "none", "tma"),
    "resnet s3b0 proj dB": (128, 7, "cluster", None),
}


def test_matmul_conv_products_take_their_plans():
    """Every product of the LeNet-5 and ResNet-18 trainer steps gets a
    legal plan at the H100's occupancy; the stem's and LeNet c2's patch
    matrices (rows at a 16-byte pitch) take the wgmma kernel, LeNet c1's
    the general one; a 64-wide output takes the 64-wide tile; every
    unsplit tile whose C rows TMA can write stores through TMA; every
    split of up to 8 whose cluster fits is summed in its cluster; and
    each takes the plan CONV_PLANS pins."""
    from torch_conv_products import conv_products
    products = conv_products()
    assert len(products) == 37
    for label, m, k, n, sa, sb in products:
        path = _bf16_path(m, k, n, sa, sb)
        assert (path == tmm.PATH_GENERAL) == label.startswith("lenet c1"), \
            label
        p = _assert_legal_bf16_plan(m, n, k, path, H100_WGMMA_CLUSTER_SMS)
        if n <= 64:
            assert p.bn == 64, (label, p)
        if path == tmm.PATH_TMA and p.splits == 1 and p.bn <= 128 \
                and n % 8 == 0:
            assert tmm.EPI_NAMES[p.epi] == "tma", (label, p)
        reduce = ("none" if p.splits == 1 else
                  "cluster" if p.cluster > 1 else "slab")
        if 1 < p.splits <= tmm.WG_MAX_CLUSTER and path == tmm.PATH_TMA:
            assert reduce == "cluster", (label, p)
        epi = tmm.EPI_NAMES[p.epi] if p.splits == 1 else None
        assert (p.bn, p.splits, reduce, epi) == CONV_PLANS[label], (label, p)
    assert sorted(CONV_PLANS) == sorted(p[0] for p in products)


@pytest.mark.parametrize("m,k,n,splits", [(75, 802816 // 64, 6, 8),
                                          (147, 4000, 64, 16),
                                          (576, 6400, 64, 25),
                                          (128, 1000, 256, 2),
                                          (64, 130, 40, 3)])
def test_matmul_split_model_matches_plain_and_jax(m, k, n, splits):
    """The split-K sum in the kernel's order (tests/
    torch_matmul_split_model.py: f32 partials of whole 64-deep K-tile
    chunks, added in rank order, one cast) against the plain version and
    the JAX op in interpret mode on bf16-rounded operands, at the bf16
    tolerance of tests/test_torch_cuda.py; and the chunks cover K once."""
    from torch_matmul_split_model import chunks, split_product
    rng = np.random.RandomState(m + k + n)
    a = np.array(jnp.asarray(rng.randn(m, k) * k ** -0.25, jnp.bfloat16)
                 .astype(jnp.float32))
    b = np.array(jnp.asarray(rng.randn(k, n) * k ** -0.25, jnp.bfloat16)
                 .astype(jnp.float32))
    spans = chunks(k, splits)
    assert spans[0][0] == 0 and spans[-1][1] == k and all(
        s1 == t0 for (_, s1), (t0, _) in zip(spans, spans[1:]))
    assert all(s0 % 64 == 0 and s1 > s0 for s0, s1 in spans)
    got = split_product(a, b, splits, torch.bfloat16)
    plain = tmm.matmul_plain(torch.from_numpy(a).to(torch.bfloat16),
                             torch.from_numpy(b).to(torch.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=2e-2, atol=2e-2)
    want = np.asarray(jops.matmul(jnp.asarray(a, jnp.bfloat16),
                                  jnp.asarray(b, jnp.bfloat16),
                                  backend="pallas_interpret")
                      .astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)
    f32 = split_product(a, b, splits)
    np.testing.assert_allclose(f32.numpy(), a @ b, rtol=1e-4, atol=1e-4)
