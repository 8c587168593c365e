"""The branch choices of the softmax and pool kernels, and the f32
matmul kernels' tiles, on the CPU.

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
