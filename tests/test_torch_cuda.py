"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test takes the ``cuda`` fixture, which skips when
``torch.cuda.is_available()`` is false (the CPU-only test machine). On a
machine with a card:

    python -m pytest tests/test_torch_cuda.py -q

Float32 comparisons run with TF32 off and use the JAX package's op
tolerance (tests/test_ops.py:16-17); bfloat16 outputs differ from the
plain version by at most about one bf16 rounding step.
"""

import pytest
import torch

from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.ops.matmul import (matmul_cuda,
                                                matmul_kernel_plan,
                                                matmul_plain)
from lua_mapreduce_tpu_torch.ops.softmax import (REGS_MAX_N,
                                                 log_softmax_plain,
                                                 rowwise_softmax_cuda,
                                                 softmax_kernel_plan,
                                                 softmax_plain)

pytestmark = pytest.mark.cuda

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, device="cuda", generator=gen) * scale).to(
        dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 256, 10), (100, 70, 50),
                                   (128, 256, 128), (200, 128, 10),
                                   (257, 129, 131), (512, 1024, 384),
                                   # split-K: the conv weight gradients
                                   # (ta: patchesᵀ, a.t() of a contiguous
                                   # (K, M)) and K not a multiple of a chunk
                                   (75, 802816, 6), (147, 40000, 64),
                                   (64, 100003, 64)])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True)])
def test_matmul_kernel_matches_plain(cuda, dtype, m, k, n, ta, tb):
    a = _randn(cuda, *((k, m) if ta else (m, k)), dtype=dtype,
               scale=k ** -0.25)
    b = _randn(cuda, *((n, k) if tb else (k, n)), dtype=dtype,
               scale=k ** -0.25)
    a, b = (a.t() if ta else a), (b.t() if tb else b)
    for out in (torch.float32, torch.bfloat16):
        got = matmul_cuda(a, b, out)
        assert got.dtype == out and got.is_contiguous()
        tol = F32 if (dtype, out) == (torch.float32, torch.float32) \
            else BF16
        torch.testing.assert_close(got.float(),
                                   matmul_plain(a, b, out).float(), **tol)


def test_matmul_kernel_unaligned_and_mixed_operands(cuda):
    base = _randn(cuda, 65, 97, dtype=torch.bfloat16)
    a = base[1:, 1:]                    # unaligned view: scalar loads
    b = _randn(cuda, 96, 40, dtype=torch.bfloat16)
    torch.testing.assert_close(ops.matmul(a, b).float(),
                               matmul_plain(a, b).float(), **BF16)
    c = _randn(cuda, 40, 33)            # f32 with bf16: promoted to f32
    got = ops.matmul(b, c)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, matmul_plain(b, c), **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 10), (200, 10), (33, 257),
                                   (2, 3, 100), (4, 8192), (3, 70000)])
def test_rowwise_kernel_matches_plain(cuda, dtype, shape):
    x = _randn(cuda, *shape, dtype=dtype, scale=5.0)
    tol = F32 if dtype == torch.float32 else BF16
    for mode, plain in ((0, log_softmax_plain), (1, softmax_plain)):
        got = rowwise_softmax_cuda(x, mode)
        assert got.dtype == dtype and got.shape == x.shape
        torch.testing.assert_close(got.float(), plain(x).float(), **tol)


def test_rowwise_kernel_extreme_and_noncontiguous(cuda):
    x = torch.tensor([[1e4, -1e4, 0.0, 5.0]], device="cuda")
    got = ops.log_softmax(x)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, log_softmax_plain(x), **F32)
    y = _randn(cuda, 40, 30).t()        # non-contiguous rows
    torch.testing.assert_close(ops.softmax(y), softmax_plain(y), **F32)


def _layout(gen, rows, n, dtype, how, scale=5.0):
    """(rows, n) values in one of three layouts: "contiguous"; "offset",
    contiguous but one element past a 16-byte boundary (every access
    misaligned); "view", the [:, 1:] view of a (rows, n + 1) tensor (row
    pitch n + 1, read in place)."""
    if how == "contiguous":
        return _randn(gen, rows, n, dtype=dtype, scale=scale)
    if how == "offset":
        flat = _randn(gen, rows * n + 1, dtype=dtype, scale=scale)
        return flat[1:].view(rows, n)
    return _randn(gen, rows, n + 1, dtype=dtype, scale=scale)[:, 1:]


# every branch of csrc/softmax.cu at and one past its boundaries, an odd
# width in each, as (n, branch when aligned)
SOFTMAX_EDGES = [(1, "warp"), (10, "warp"), (999, "warp"), (1024, "warp"),
                 (1025, "regs"), (4096, "regs"), (4097, "regs"),
                 (8192, "regs"), (REGS_MAX_N, "regs"),
                 (REGS_MAX_N + 1, "stream"), (32768, "stream"),
                 (70001, "stream")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,branch", SOFTMAX_EDGES)
@pytest.mark.parametrize("how", ["contiguous", "offset", "view"])
def test_softmax_branches_match_plain(cuda, dtype, n, branch, how):
    x = _layout(cuda, 5, n, dtype, how)
    plan = softmax_kernel_plan(x)
    item = x.element_size()
    assert plan.branch == branch
    assert plan.vector == (how == "contiguous" and n * item % 16 == 0)
    tol = F32 if dtype == torch.float32 else BF16
    for mode, plain in ((0, log_softmax_plain), (1, softmax_plain)):
        got = rowwise_softmax_cuda(x, mode)
        want = plain(x)
        assert got.dtype == dtype and got.shape == x.shape
        torch.testing.assert_close(got.float(), want.float(), **tol)
        if dtype == torch.bfloat16:     # (n = 1: log_softmax is all 0)
            rel = ((got.float() - want.float()).norm()
                   / want.float().norm().clamp_min(1e-30))
            assert float(rel) <= 1e-2
        assert torch.equal(rowwise_softmax_cuda(x, mode), got)


def test_softmax_main_path_shapes_take_the_vector_branches(cuda):
    bf = torch.bfloat16
    for shape, name in (((8192, 8192), "regs/v16"),
                        ((1024, 32768), "stream/v16"),
                        ((32, 1000), "warp/v16"),
                        ((1024, 10), "warp/scalar"),
                        ((128, 10), "warp/scalar")):
        x = torch.empty(shape, device="cuda", dtype=bf)
        assert softmax_kernel_plan(x).name == name, shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [12, 2048, REGS_MAX_N + 8])
def test_softmax_nonfinite_rows_match_plain(cuda, dtype, n):
    """Per branch: a row with -inf entries stays finite where the plain
    version is, and rows that are all -inf or hold +inf or NaN give NaN
    as the plain version does (a late NaN after -inf too)."""
    x = _randn(cuda, 6, n, scale=3.0)
    x[0, ::3] = -float("inf")
    x[1] = -float("inf")
    x[2, n // 2] = float("inf")
    x[3, n - 1] = float("nan")
    x[4, : n - 1] = -float("inf")
    x[4, n - 1] = float("nan")
    x[5, :4] = torch.tensor([1e4, -1e4, 0.0, 5.0])
    x = x.to(dtype)
    tol = F32 if dtype == torch.float32 else BF16
    for mode, plain in ((0, log_softmax_plain), (1, softmax_plain)):
        got, want = rowwise_softmax_cuda(x, mode), plain(x)
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   equal_nan=True)
        assert bool(torch.isfinite(got[5]).all()) == bool(
            torch.isfinite(want[5]).all())


def test_softmax_kernel_refuses_a_plan_it_cannot_run(cuda):
    from lua_mapreduce_tpu_torch.ops import _build
    from lua_mapreduce_tpu_torch.ops.softmax import BRANCHES, softmax_plan
    lib = _build.library("softmax")
    x = _randn(cuda, 4, 2048, dtype=torch.bfloat16)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    good = softmax_plan(4, 2048, torch.bfloat16, 16)

    def rc(plan, xp=x.data_ptr(), n=2048):
        return lib.lmr_softmax(xp, y.data_ptr(), 4, n, n, 1, 0,
                               BRANCHES.index(plan.branch),
                               int(plan.vector), plan.per_thread,
                               plan.threads, plan.rows_per_block,
                               plan.blocks, stream)
    assert rc(good) == 0
    for bad in (good._replace(threads=good.threads // 2),   # short rows
                good._replace(per_thread=8),                # no such E
                good._replace(branch="warp"),               # n > 1024
                good._replace(blocks=3)):
        assert rc(bad) != 0, bad
    assert rc(good, xp=x.data_ptr() + 2, n=2047) != 0       # misaligned


def _grads(fn, *xs):
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    return torch.autograd.grad(fn(*xs), xs)


def test_kernel_grads_match_plain_autograd(cuda):
    # each op on its own, as tests/test_ops.py:162-181 holds the JAX ops:
    # a chained loss would let the cancellation in the log_softmax VJP
    # (g − p·Σg) amplify last-bit differences of the forward products
    a = _randn(cuda, 64, 96, scale=96 ** -0.25)
    b = _randn(cuda, 96, 10, scale=96 ** -0.25)
    w = _randn(cuda, 64, 10)
    for got, want in zip(_grads(lambda a, b: (ops.matmul(a, b) * w).sum(),
                                a, b),
                         _grads(lambda a, b: (matmul_plain(a, b) * w).sum(),
                                a, b)):
        torch.testing.assert_close(got, want, **F32)
    x = _randn(cuda, 8, 33, scale=4.0)
    (got,) = _grads(lambda x: (ops.log_softmax(x) ** 2).sum(), x)
    (want,) = _grads(lambda x: (log_softmax_plain(x) ** 2).sum(), x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    x = _randn(cuda, 6, 20, scale=3.0)
    (got,) = _grads(lambda x: (ops.softmax(x) ** 3).sum(), x)
    (want,) = _grads(lambda x: (softmax_plain(x) ** 3).sum(), x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_cuda_tensors_launch_kernels_and_count(cuda):
    ops.reset_launch_counts()
    ops.matmul(_randn(cuda, 8, 8), _randn(cuda, 8, 8))
    ops.matmul(_randn(cuda, 8, 8, dtype=torch.bfloat16),
               _randn(cuda, 8, 8, dtype=torch.bfloat16))
    ops.log_softmax(_randn(cuda, 4, 4))
    ops.softmax(_randn(cuda, 4, 4))
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0),
                                   "matmul_f32": 1, "matmul_bf16": 1,
                                   "rowwise_softmax": 2}


def test_matmul_split_policy_lives_in_the_kernel_source(cuda):
    """csrc/matmul.cu decides the kernel and the K split; the wrapper only
    sizes the scratch. The f32 plan picks its kernel by the output's
    shape, and splits one_hotᵀ·x's 8 output tiles enough to fill every
    SM."""
    import ctypes

    from lua_mapreduce_tpu_torch.ops import _build
    lib = _build.library("matmul")
    assert lib.lmr_matmul_tma_available() == 1

    def plan(m, k, n, dtype, ta=False):
        # contiguous B (k, n); A (m, k) contiguous or, with ta, the .t()
        # view of a contiguous (k, m) (patchesᵀ, one_hotᵀ); 16-byte aligned
        sa = (1, m) if ta else (k, 1)
        out = (ctypes.c_int * 5)()
        lib.lmr_matmul_plan(256, 256, m, n, k, *sa, n, 1, dtype, out)
        assert out[1] == lib.lmr_matmul_splits(256, 256, m, n, k, *sa, n, 1,
                                               dtype)
        return list(out)

    def splits(*args, **kw):
        return plan(*args, **kw)[1]
    for dtype in (0, 1):                            # f32, bf16
        assert splits(75, 802816, 6, dtype, ta=True) > 1
        assert splits(576, 100352, 64, dtype, ta=True) > 1
        assert splits(4096, 4096, 4096, dtype) == 1
        assert splits(8, 8, 8, dtype) == 1
    # f32 kernels (csrc/matmul.cu's Path): 0 the 64×64 tile, 1 128×128,
    # 2 128×64; by shape alone
    assert plan(200, 256, 128, 0)[0] == 0           # digits
    assert plan(75, 802816, 6, 0, ta=True)[0] == 0
    assert plan(576, 100352, 64, 0, ta=True)[0] == 2
    assert plan(4096, 4096, 4096, 0)[0] == 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kind, n_split, chunk, a_copy, b_copy = plan(1024, 1000000, 128, 0,
                                                ta=True)
    assert (kind, a_copy, b_copy) == (1, 0, 0)      # 128×128, 16-byte copies
    assert 8 * n_split >= sms and n_split * chunk * 16 >= 1000000
    assert plan(6040, 3706, 4096, 0)[1] == 1        # ALS: tiles fill it


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(75, 802816, 6), (576, 100352, 64),
                                   (200, 256, 128)])
def test_matmul_split_is_bitwise_repeatable(cuda, dtype, m, k, n):
    a = _randn(cuda, k, m, dtype=dtype, scale=k ** -0.25).t()
    b = _randn(cuda, k, n, dtype=dtype, scale=k ** -0.25)
    first = matmul_cuda(a, b, dtype)
    for _ in range(2):
        assert torch.equal(matmul_cuda(a, b, dtype), first)


def _conv_operands(gen, m, k, n, sa, sb):
    """bf16 operands of a conv product with its strides: A (m, k) row-
    major at a row pitch of sa[0] (the patch matrix, g) or the .t() view
    of a (k, pitch) one (patchesᵀ); B (k, n) contiguous or the .t() view
    of a contiguous (n, k) (Wᵀ)."""
    if sa[1] == 1:
        a = _randn(gen, m, sa[0], dtype=torch.bfloat16,
                   scale=k ** -0.25)[:, :k]
    else:
        a = _randn(gen, k, sa[1], dtype=torch.bfloat16,
                   scale=k ** -0.25)[:, :m].t()
    b = (_randn(gen, k, n, dtype=torch.bfloat16, scale=k ** -0.25)
         if sb[1] == 1 else
         _randn(gen, n, k, dtype=torch.bfloat16, scale=k ** -0.25).t())
    assert a.stride() == tuple(sa) and b.stride() == tuple(sb)
    return a, b


def _conv_product_cases():
    from torch_conv_products import conv_products
    return [pytest.param(*p[1:], id=p[0].replace(" ", "-"))
            for p in conv_products()]


@pytest.mark.parametrize("m,k,n,sa,sb", _conv_product_cases())
def test_matmul_conv_products_at_their_plans(cuda, m, k, n, sa, sb):
    """Every product of the LeNet-5 b1024 and ResNet-18 b32 steps, at
    the plan csrc/matmul.cu takes for it — the plan its Python mirror
    gives at this card's occupancy — against the plain version (bf16
    tolerance and normwise 1e-2), two calls bit-equal."""
    import importlib
    tmm = importlib.import_module("lua_mapreduce_tpu_torch.ops.matmul")
    a, b = _conv_operands(cuda, m, k, n, sa, sb)
    plan = matmul_kernel_plan(a, b)
    path = tmm.KERNEL_NAMES.index(plan.kernel)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = tmm.bf16_plan(m, n, k, path, sms, tmm.matmul_cluster_sms(),
                         plan.resident)
    reduce = ("none" if want.splits == 1 else
              "cluster" if want.cluster > 1 else "slab")
    assert (plan.tile, plan.splits, plan.chunk, plan.cluster,
            plan.reduce) == (f"128x{want.bn}", want.splits, want.chunk,
                             want.cluster, reduce)
    got = matmul_cuda(a, b, torch.bfloat16)
    ref = matmul_plain(a, b, torch.bfloat16).float()
    torch.testing.assert_close(got.float(), ref, **BF16)
    assert float((got.float() - ref).norm() / ref.norm()) < 1e-2
    assert torch.equal(matmul_cuda(a, b, torch.bfloat16), got)


# (M, K, N, A transposed, tile width, split): cluster splits of 2-8 at
# the three tile widths, a short last chunk, and an A read M-major
CLUSTER_CASES = [(576, 6400, 64, False, 64, 2), (576, 10240, 64, True, 64, 8),
                 (147, 4000, 64, True, 64, 8), (256, 1568, 512, True, 128, 4),
                 (1000, 700, 96, False, 128, 4), (300, 2000, 40, False, 64, 7),
                 (1568, 4608, 512, False, 256, 4)]


@pytest.mark.parametrize("m,k,n,ta,bn,splits", CLUSTER_CASES)
def test_matmul_cluster_split_is_its_model_bit_for_bit(cuda, m, k, n, ta,
                                                      bn, splits):
    """A cluster split's result, in f32 and bf16, equals the rank-order
    sum (tests/torch_matmul_split_model.py) of the kernel's own unsplit
    products over each K chunk, bit for bit, and so does the slab split
    of the same chunks; every call gives the same bits."""
    from torch_matmul_split_model import chunks, rank_order_sum, to_dtype
    from lua_mapreduce_tpu_torch.ops.matmul import matmul_forced
    # rows at a pitch of a multiple of 8 (as ops.conv's patch matrix):
    # TMA reads A either way
    a = (_randn(cuda, k, -(-m // 8) * 8, dtype=torch.bfloat16,
                scale=k ** -0.25)[:, :m].t() if ta else
         _randn(cuda, m, -(-k // 8) * 8, dtype=torch.bfloat16,
                scale=k ** -0.25)[:, :k])
    b = _randn(cuda, k, n, dtype=torch.bfloat16, scale=k ** -0.25)
    parts = [matmul_forced(a[:, k0:k1], b[k0:k1], torch.float32, bn, 1)
             .cpu().numpy() for k0, k1 in chunks(k, splits)]
    model = rank_order_sum(parts)
    for out in (torch.float32, torch.bfloat16):
        want = to_dtype(model, out)
        got = matmul_forced(a, b, out, bn, splits, splits)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(matmul_forced(a, b, out, bn, splits, splits), got)
        assert torch.equal(matmul_forced(a, b, out, bn, splits, 1).cpu(),
                           want)
    torch.testing.assert_close(to_dtype(model, torch.float32).cuda(),
                               matmul_plain(a, b, torch.float32),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("m,n", [(1000, 72), (130, 136), (77, 200),
                                 (4097, 8), (129, 36), (64, 64)])
@pytest.mark.parametrize("bn", [64, 128])
def test_matmul_tma_store_epilogue_at_ragged_edges(cuda, m, n, bn):
    """The TMA-store epilogue at ragged M and N edges writes what the
    register stores write, bit for bit, in f32 and bf16 (a bf16 C whose
    rows TMA cannot write, N = 36, falls back to register stores), and
    nothing past the edges: the output is the plain version's."""
    from lua_mapreduce_tpu_torch.ops.matmul import matmul_forced
    k = 200
    a = _randn(cuda, m, k, dtype=torch.bfloat16, scale=k ** -0.25)
    # B N-major where its rows are 16-byte multiples, else K-major (the
    # .t() of a contiguous (N, K)): TMA reads it either way
    b = (_randn(cuda, k, n, dtype=torch.bfloat16, scale=k ** -0.25)
         if n % 8 == 0 else
         _randn(cuda, n, k, dtype=torch.bfloat16, scale=k ** -0.25).t())
    for out in (torch.float32, torch.bfloat16):
        tma = matmul_forced(a, b, out, bn, 1, 1, "tma")
        regs = matmul_forced(a, b, out, bn, 1, 1, "regs")
        assert torch.equal(tma, regs)
        tol = BF16 if out == torch.bfloat16 else dict(rtol=1e-3, atol=1e-3)
        torch.testing.assert_close(tma.float(),
                                   matmul_plain(a, b, out).float(), **tol)


def test_matmul_forced_plan_refuses_what_the_kernel_cannot_run(cuda):
    from lua_mapreduce_tpu_torch.ops.matmul import matmul_forced
    a = _randn(cuda, 256, 1024, dtype=torch.bfloat16)
    b = _randn(cuda, 1024, 128, dtype=torch.bfloat16)
    # a tile width the kernel lacks, a TMA store on a 256-wide or split
    # tile, a cluster past 8 or unequal to the split, a split past K's
    # 16 K-tiles, a split no chunk of whole K-tiles makes (16 / 7)
    for bn, splits, cluster, epi in [(96, 1, 1, "regs"), (256, 1, 1, "tma"),
                                     (128, 2, 1, "tma"), (128, 16, 16, "regs"),
                                     (128, 17, 1, "regs"), (128, 4, 2, "regs"),
                                     (128, 7, 1, "regs")]:
        with pytest.raises(RuntimeError):
            matmul_forced(a, b, torch.bfloat16, bn, splits, cluster, epi)
    with pytest.raises(RuntimeError):       # unaligned: not the TMA path
        matmul_forced(a[:, 1:], b[1:], torch.bfloat16, 128, 1)


@pytest.mark.parametrize("m,k,n,ta", [(576, 100352, 64, True),
                                      (1568, 256, 512, False),
                                      (100352, 64, 576, False),
                                      (75, 802816, 6, True)])
def test_matmul_bf16_captured_replay_equals_eager(cuda, m, k, n, ta):
    """A slab split, a cluster split, a TMA-store tile and the general
    kernel's slab split, each captured in a CUDA graph: the replay equals
    the eager call bit for bit."""
    a = _randn(cuda, *((k, m) if ta else (m, k)), dtype=torch.bfloat16,
               scale=k ** -0.25)
    a = a.t() if ta else a
    b = _randn(cuda, k, n, dtype=torch.bfloat16, scale=k ** -0.25)
    eager = matmul_cuda(a, b, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        matmul_cuda(a, b, torch.bfloat16)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = matmul_cuda(a, b, torch.bfloat16)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def _f32_operand(gen, rows, cols, layout, scale):
    """An f32 (rows, cols) operand: "contiguous"; "pitch2", rows 2 floats
    longer than they are wide (a pitch ≡ 2 mod 4, 8-byte aligned rows,
    like ALS's 3,706); "offset", one float past a 16-byte boundary."""
    if layout == "contiguous":
        return _randn(gen, rows, cols, scale=scale)
    if layout == "pitch2":
        return _randn(gen, rows, cols + 2 + (-cols) % 4,
                      scale=scale)[:, :cols]
    return _randn(gen, rows * cols + 1, scale=scale)[1:].view(rows, cols)


def _copy_mode(x, tile_axis):
    """How the wide f32 kernels copy operand ``x`` whose tile axis (M of
    A: 0, N of B: 1) is ``tile_axis`` (csrc/matmul.cu's copy_mode)."""
    sc, sk = x.stride(tile_axis), x.stride(1 - tile_axis)
    if sc == 1:
        if x.data_ptr() % 16 == 0 and sk % 4 == 0:
            return "v16"
        if x.data_ptr() % 8 == 0 and sk % 2 == 0:
            return "v8"
        return "e4c"
    return "e4k" if sk < sc else "e4c"


@pytest.mark.parametrize("m,k,n,kernel", [
    (100, 70, 50, "f32 64x64"),
    (300, 70, 200, "f32 128x128"), (257, 129, 131, "f32 128x128"),
    (1000, 333, 64, "f32 128x64"), (1300, 1000, 40, "f32 128x64")])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
@pytest.mark.parametrize("layout", ["contiguous", "pitch2", "offset"])
def test_matmul_f32_kernels_match_plain(cuda, m, k, n, kernel, ta, tb,
                                        layout):
    """Every f32 kernel, ragged in M, N and K, in the four major-ness
    combinations and through every copy mode of the wide kernels: 16-byte
    pieces (contiguous, along M or N), 8-byte (pitch2), elements along K
    (a K-major operand) or along the tile's axis (offset)."""
    sc = k ** -0.25
    a = _f32_operand(cuda, *((k, m) if ta else (m, k)), layout, sc)
    b = _f32_operand(cuda, *((n, k) if tb else (k, n)), layout, sc)
    a, b = (a.t() if ta else a), (b.t() if tb else b)
    plan = matmul_kernel_plan(a, b)
    assert plan.kernel == kernel
    if kernel != "f32 64x64":
        assert (plan.a_copy, plan.b_copy) == (_copy_mode(a, 0),
                                              _copy_mode(b, 1))
    for out in (torch.float32, torch.bfloat16):
        got = matmul_cuda(a, b, out)
        assert got.dtype == out and got.is_contiguous()
        torch.testing.assert_close(got.float(),
                                   matmul_plain(a, b, out).float(),
                                   **(F32 if out == torch.float32 else BF16))


def test_matmul_f32_als_pitch_takes_its_copies(cuda):
    """ALS's W (users, 3,706): rows not 16-byte aligned. W·B reads W
    along K element by element, Wᵀ·B in 8-byte pieces; both match the
    plain version."""
    w = (torch.rand((600, 3706), device="cuda", generator=cuda) < 0.05
         ).float()
    vv = _randn(cuda, 3706, 256, scale=0.1)
    uu = _randn(cuda, 600, 256, scale=0.1)
    for a, b, copies in ((w, vv, ("e4k", "v16")), (w.t(), uu, ("v8", "v16"))):
        plan = matmul_kernel_plan(a, b)
        assert (plan.kernel, plan.a_copy, plan.b_copy) == (
            "f32 128x128", *copies)
        torch.testing.assert_close(matmul_cuda(a, b, torch.float32),
                                   matmul_plain(a, b, torch.float32), **F32)


def test_matmul_f32_split_is_bitwise_repeatable_at_one_hot_shape(cuda):
    """one_hotᵀ·x-like: A M-major over K = 200,003, split along K; the
    partials are summed in split order, so every call gives the same
    bits."""
    a = _randn(cuda, 200003, 1024, scale=200003 ** -0.25).t()
    b = _randn(cuda, 200003, 128, scale=200003 ** -0.25)
    plan = matmul_kernel_plan(a, b)
    assert plan.kernel == "f32 128x128" and plan.splits > 1
    first = matmul_cuda(a, b, torch.float32)
    for _ in range(2):
        assert torch.equal(matmul_cuda(a, b, torch.float32), first)
    torch.testing.assert_close(first, matmul_plain(a, b, torch.float32),
                               **F32)


@pytest.mark.parametrize("m,k,n,ta,tb", [(1000, 512, 256, False, True),
                                         (384, 40000, 128, True, False),
                                         (200, 256, 128, False, False)])
def test_matmul_f32_captured_replay_equals_eager(cuda, m, k, n, ta, tb):
    """A captured call (no host sync, scratch from the wrapper's
    allocation) replays to the eager call's bits, and follows its inputs
    when they change in place."""
    sc = k ** -0.25
    a = _randn(cuda, *((k, m) if ta else (m, k)), scale=sc)
    b = _randn(cuda, *((n, k) if tb else (k, n)), scale=sc)
    a, b = (a.t() if ta else a), (b.t() if tb else b)
    eager = matmul_cuda(a, b, torch.float32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        matmul_cuda(a, b, torch.float32)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = matmul_cuda(a, b, torch.float32)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    a.mul_(-0.5)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, matmul_cuda(a, b, torch.float32))


@pytest.mark.parametrize("m,k,n", [(256, 192, 128), (300, 200, 300),
                                   (1000, 4096, 96)])
@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_matmul_tma_and_general_paths_agree(cuda, m, k, n, ta, tb):
    """The same values through an aligned tensor (the TMA + wgmma path)
    and through a [1:, 1:] view of a padded copy (unaligned: the general
    kernel)."""
    def both(*shape):
        big = _randn(cuda, shape[0] + 1, shape[1] + 1, dtype=torch.bfloat16,
                     scale=k ** -0.25)
        return big[1:, 1:].contiguous(), big[1:, 1:]
    a_al, a_un = both(*((k, m) if ta else (m, k)))
    b_al, b_un = both(*((n, k) if tb else (k, n)))
    if ta:
        a_al, a_un = a_al.t(), a_un.t()
    if tb:
        b_al, b_un = b_al.t(), b_un.t()
    want = matmul_plain(a_al, b_al, torch.float32)
    fast = matmul_cuda(a_al, b_al, torch.float32)
    general = matmul_cuda(a_un, b_un, torch.float32)
    torch.testing.assert_close(fast, want, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(general, want, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(fast, general, rtol=1e-3, atol=1e-3)


def test_kernel_rejects_unsupported_dtype(cuda):
    with pytest.raises(TypeError):
        ops.matmul(torch.ones(4, 4, device="cuda", dtype=torch.float16),
                   torch.ones(4, 4, device="cuda", dtype=torch.float16))
    with pytest.raises(TypeError):
        ops.log_softmax(torch.ones(4, 4, device="cuda", dtype=torch.float64))


def test_mlp_on_the_card_matches_the_cpu(cuda):
    from lua_mapreduce_tpu_torch.models.mlp import init_mlp, nll_loss
    p_cpu = {k: v.requires_grad_(True)
             for k, v in init_mlp(3, device="cpu").items()}
    p_gpu = {k: v.detach().cuda().requires_grad_(True)
             for k, v in p_cpu.items()}
    x = torch.rand(128, 256, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 10, (128,),
                      generator=torch.Generator().manual_seed(2))
    lc, lg = nll_loss(p_cpu, x, y), nll_loss(p_gpu, x.cuda(), y.cuda())
    lc.backward()
    lg.backward()
    torch.testing.assert_close(lg.detach().cpu(), lc.detach(), **F32)
    for k in p_cpu:
        torch.testing.assert_close(p_gpu[k].grad.cpu(), p_cpu[k].grad, **F32)


# ------------------------------------------------- serving-path kernels

from lua_mapreduce_tpu_torch.ops.attention import (  # noqa: E402
    flash_attention_bwd_cuda, flash_attention_bwd_plain, flash_attention_cuda,
    flash_attention_plain, flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
    flash_bwd_kernel_path, flash_bwd_kernel_plan, flash_bwd_plan,
    flash_kernel_path)
from lua_mapreduce_tpu_torch.ops.decode import (  # noqa: E402
    _merge_splits_plain, decode_attention_cuda, decode_attention_plain,
    decode_splits, merge_splits_cuda)
from lua_mapreduce_tpu_torch.ops.q8 import (  # noqa: E402
    q8_matmul_cuda, q8_matmul_plain)

# tests/test_attention_op.py, test_decode_op.py and test_q8.py tolerances
FLASH_F32 = dict(rtol=2e-5, atol=2e-5)
DECODE_INT8 = dict(rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,window,hkv,l", [
    (False, 0, 4, 96), (True, 0, 4, 96), (True, 0, 4, 200),
    (True, 0, 1, 130), (True, 37, 2, 300)])
def test_flash_kernel_matches_plain(cuda, dtype, d, causal, window, hkv, l):
    q = _randn(cuda, 2, l, 4, d, dtype=dtype, scale=0.5)
    k = _randn(cuda, 2, l, hkv, d, dtype=dtype, scale=0.5)
    v = _randn(cuda, 2, l, hkv, d, dtype=dtype, scale=0.5)
    scale = d ** -0.5
    tol = FLASH_F32 if dtype == torch.float32 else BF16
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal, scale, window=window)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    go, gl = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  with_lse=True)
    wo, wl = flash_attention_plain(q, k, v, causal, scale, with_lse=True,
                                   window=window)
    assert go.dtype == torch.float32
    torch.testing.assert_close(go, wo, **tol)
    torch.testing.assert_close(gl, wl, rtol=1e-5, atol=1e-4)


def test_flash_kernel_strided_fused_qkv_views(cuda):
    """The model hands the kernel strided views of the fused qkv
    projection; they read as their contiguous copies do."""
    qkv = _randn(cuda, 2, 70, 3 * 4 * 64, dtype=torch.bfloat16)
    q, k, v = (qkv[..., i * 256:(i + 1) * 256].reshape(2, 70, 4, 64)
               for i in range(3))
    got = flash_attention_cuda(q, k, v, causal=True)
    want = flash_attention_cuda(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_kernel_all_masked_rows_zero(cuda):
    q, k, v = (_randn(cuda, 1, 40, 2, 64) for _ in range(3))
    out, lse = flash_attention_cuda(q, k, v, causal=True, window=8,
                                    q_offset=44, with_lse=True)
    assert bool((out[:, 3:] == 0).all()) and bool((lse[:, 3:] < -1e29).all())
    wo, _ = flash_attention_plain(q, k, v, True, 0.125, with_lse=True,
                                  window=8, q_offset=44)
    torch.testing.assert_close(out, wo, **FLASH_F32)


def _aligned_and_misaligned(gen, *shape, scale=1.0):
    """The same bf16 values as a contiguous tensor (16-byte aligned: the
    TMA + wgmma kernel) and as a [..., 1:] view of a tensor one element
    wider (base and head stride off 16 bytes: the general kernel)."""
    big = _randn(gen, *shape[:-1], shape[-1] + 1, dtype=torch.bfloat16,
                 scale=scale)
    view = big[..., 1:]
    return view.contiguous(), view


# (causal, window, q_offset, q heads, kv heads); L = 300 is not a
# multiple of the 128-row tiles
PATH_CASES = [(False, 0, 0, 4, 4), (True, 0, 0, 4, 4), (True, 37, 0, 4, 4),
              (True, 37, 20, 4, 4), (True, 0, 0, 8, 2), (True, 0, 0, 8, 1)]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", PATH_CASES)
def test_flash_tma_and_general_paths_agree(cuda, d, case):
    causal, window, q_offset, h, hkv = case
    l = 300
    qa, qu = _aligned_and_misaligned(cuda, 2, l, h, d, scale=2.0)  # peaked
    ka, ku = _aligned_and_misaligned(cuda, 2, l, hkv, d)
    va, vu = _aligned_and_misaligned(cuda, 2, l, hkv, d)
    assert flash_kernel_path(qa, ka, va) == "tma"
    assert flash_kernel_path(qu, ku, vu) == "general"
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    for lse in (False, True):
        fast = flash_attention_cuda(qa, ka, va, with_lse=lse, **kw)
        general = flash_attention_cuda(qu, ku, vu, with_lse=lse, **kw)
        want = flash_attention_plain(qa, ka, va, causal, d ** -0.5,
                                     with_lse=lse, window=window,
                                     q_offset=q_offset)
        if lse:
            torch.testing.assert_close(fast[1], want[1], rtol=1e-5,
                                       atol=1e-4)
            torch.testing.assert_close(general[1], want[1], rtol=1e-5,
                                       atol=1e-4)
            fast, general, want = fast[0], general[0], want[0]
        for got in (fast, general):
            torch.testing.assert_close(got.float(), want.float(), **BF16)
        torch.testing.assert_close(fast.float(), general.float(), **BF16)


def test_flash_path_follows_the_layout(cuda):
    """lmr_flash_path: contiguous operands and the model's fused-qkv
    views take the TMA + wgmma kernel; a view whose row stride breaks
    16-byte alignment takes the general kernel; f32 its own."""
    x = _randn(cuda, 2, 70, 4, 64, dtype=torch.bfloat16)
    assert flash_kernel_path(x, x, x) == "tma"
    qkv = _randn(cuda, 2, 70, 3 * 4 * 64, dtype=torch.bfloat16)
    q, k, v = (qkv[..., i * 256:(i + 1) * 256].reshape(2, 70, 4, 64)
               for i in range(3))
    assert flash_kernel_path(q, k, v) == "tma"
    odd = _randn(cuda, 2, 70, 4 * 64 + 4, dtype=torch.bfloat16)
    q_odd = odd[..., :256].reshape(2, 70, 4, 64)   # row stride 260
    assert flash_kernel_path(q_odd, k, v) == "general"
    x32 = x.float()
    assert flash_kernel_path(x32, x32, x32) == "f32"


# (B, L, H, H_kv, D, causal, window, q_offset): L not a multiple of the
# 128-row tiles and below one tile, windows with and without an offset,
# GQA 4:1 and 8:1, a q_offset that leaves rows with no visible key, head
# dim 128 (64-key tiles), items fewer than SMs and items over several
# rounds of the persistent walk
WSK_CASES = [(1, 50, 2, 2, 64, True, 0, 0), (2, 300, 8, 2, 64, True, 0, 0),
             (1, 1000, 8, 1, 64, True, 0, 0), (2, 700, 4, 4, 64, True, 200, 150),
             (1, 300, 4, 4, 64, True, 64, 400), (3, 520, 4, 4, 64, False, 0, 0),
             (1, 260, 2, 2, 128, True, 0, 0), (1, 520, 4, 2, 128, True, 96, 40),
             (2, 130, 4, 1, 128, True, 0, 0), (40, 640, 8, 8, 64, True, 0, 0)]


@pytest.mark.parametrize("b,l,h,hkv,d,causal,window,q_offset", WSK_CASES)
def test_flash_persistent_kernel_matches_plain(cuda, b, l, h, hkv, d, causal,
                                               window, q_offset):
    """The TMA kernel's persistent walk against the plain version, both
    forms, on the shapes where its edges are (rows with no visible key
    write 0 and an lse below -1e29); two calls bit-equal."""
    q = _randn(cuda, b, l, h, d, dtype=torch.bfloat16, scale=2.0)
    k = _randn(cuda, b, l, hkv, d, dtype=torch.bfloat16)
    v = _randn(cuda, b, l, hkv, d, dtype=torch.bfloat16)
    assert flash_kernel_path(q, k, v) == "tma"
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, causal, d ** -0.5, window=window,
                                 q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), **BF16)
    assert torch.equal(flash_attention_cuda(q, k, v, **kw), got)
    go, gl = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    wo, wl = flash_attention_plain(q, k, v, causal, d ** -0.5, with_lse=True,
                                   window=window, q_offset=q_offset)
    torch.testing.assert_close(go, wo, **BF16)
    # a row with no visible key: out 0 and an lse below -1e29 (the plain
    # version's is the -1e30 mask fill plus log L, the kernel's the same
    # fill through its log2 domain)
    dead = wl < -1e29
    torch.testing.assert_close(gl[~dead], wl[~dead], rtol=1e-5, atol=1e-4)
    assert bool((go[dead.unsqueeze(-1).expand_as(go)] == 0).all())
    assert bool((gl[dead] < -1e29).all())
    go2, gl2 = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    assert torch.equal(go2, go) and torch.equal(gl2, gl)


@pytest.mark.parametrize("b,l,h,hkv,d,causal,window,q_offset", WSK_CASES)
def test_flash_plan_matches_the_kernel(cuda, b, l, h, hkv, d, causal, window,
                                       q_offset):
    """csrc/flash.cu's make_walk against its mirror, ops/attention.py's
    flash_plan, at the card's SM count."""
    from lua_mapreduce_tpu_torch.ops.attention import (flash_kernel_plan,
                                                       flash_plan)
    props = torch.cuda.get_device_properties(0)
    assert flash_kernel_plan(b, l, h, hkv, d, causal, window, q_offset) == \
        flash_plan(b, l, h, hkv, d, causal, window, q_offset,
                   props.multi_processor_count, props.L2_cache_size)


def test_flash_decomposition_modes_run_and_odd_entries_are_refused(cuda):
    """flash_forced's kernel mode against the plain version and bit-equal
    over two calls; its other decomposition modes launch; a head dim the
    entry does not take is refused."""
    from lua_mapreduce_tpu_torch.ops.attention import FLASH_MODES, flash_forced
    q = _randn(cuda, 2, 700, 4, 64, dtype=torch.bfloat16, scale=2.0)
    k, v = (_randn(cuda, 2, 700, 2, 64, dtype=torch.bfloat16)
            for _ in range(2))
    want = flash_attention_plain(q, k, v, True, 0.125)
    got = flash_forced(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), **BF16)
    assert torch.equal(flash_forced(q, k, v, causal=True), got)
    assert torch.equal(flash_attention_cuda(q, k, v, causal=True), got)
    for mode in FLASH_MODES:
        flash_forced(q, k, v, causal=True, mode=mode)
    torch.cuda.synchronize()
    q128 = _randn(cuda, 1, 64, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="flash kernel launch"):
        flash_forced(q128, q128, q128, causal=True)


def test_flash_item_counter_is_left_at_zero(cuda):
    """The TMA kernel's item counter: one int a stream, back at 0 after
    every launch (the next launch on the stream starts from it), another
    on another stream; a CUDA graph's launch takes its own, and the
    graph's replays equal the eager call."""
    from lua_mapreduce_tpu_torch.ops.attention import _item_counter
    q = _randn(cuda, 2, 700, 4, 64, dtype=torch.bfloat16, scale=2.0)
    k, v = (_randn(cuda, 2, 700, 4, 64, dtype=torch.bfloat16)
            for _ in range(2))
    want = flash_attention_cuda(q, k, v, causal=True)
    counter = _item_counter(q.device)
    assert counter.item() == 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = _item_counter(q.device)
        assert other.data_ptr() != counter.data_ptr()
        on_side = flash_attention_cuda(q, k, v, causal=True)
        assert other.item() == 0
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(on_side, want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flash_attention_cuda(q, k, v, causal=True)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, want)
    assert counter.item() == 0
    assert torch.equal(flash_attention_cuda(q, k, v, causal=True), want)


def test_flash_ptxas_reports_no_spill_or_serialised_wgmma(cuda):
    """ptxas's report of the built flash libraries, kept beside them:
    every TMA kernel instantiation of the forward (head dim 64 and 128,
    both forms, three decomposition modes) and of the backward (the
    one-pass kernel's four modes, the two-kernel form's dq and dkv at
    head dim 128) without a spill and without serialised wgmmas (C7512,
    C7514), on every run, whether or not it built the library — but the
    head dim 128 dkv kernel, whose dk and dv take 128 of its 168
    registers a thread: it may spill at most the 548 bytes it spills
    now, and serialise its wgmmas only for want of registers (C7512), as
    it does now."""
    import re

    from lua_mapreduce_tpu_torch.ops import _build
    from lua_mapreduce_tpu_torch.ops.attention import FLASH_BWD_MODES
    for lib, pattern, count in (
            ("flash", r"flash_wgmma_kernel", 7),
            ("flash_bwd", r"bwd_wgmma_kernel|dq_wgmma_kernel|dkv_wgmma_kernel",
             len(FLASH_BWD_MODES) + 2)):
        _build.library(lib)
        log = _build.ptxas_log(lib)
        fns = {f: r for f, r in _build.ptxas_functions(log).items()
               if re.search(pattern, f)}
        why = _build.ptxas_serialisations(log)
        assert len(fns) == count, sorted(fns)
        for name, (regs, spill, serial) in fns.items():
            if "dkv_wgmma_kernelILi128E" in name:
                assert regs > 0 and spill <= 548, (name, regs, spill)
                assert serial == bool(why.get(name)), (name, why)
                assert all("due to insufficient register resources" in x
                           for x in why.get(name, ())), (name, why)
                continue
            assert regs > 0 and spill == 0 and not serial, (
                name, regs, spill, serial)


def test_flash_sass_keeps_in_flight_wgmma_registers(cuda):
    """The built TMA flash kernels' SASS, checked by
    tests/torch_sass_wgmma.py: no instruction writes P's registers while
    P·V reads them, or touches S or O while their products are in
    flight (the next tile's softmax runs beside this tile's P·V), on any
    path through the kernel's loops; every instantiation, the
    decomposition's included."""
    import subprocess
    from lua_mapreduce_tpu_torch.ops import _build
    from torch_sass_wgmma import functions, hazards
    _build.library("flash")
    sass = subprocess.run([_cuobjdump(), "-sass", str(_build._target("flash"))],
                          capture_output=True, text=True, check=True).stdout
    kernels = {name: insts for name, insts in functions(sass).items()
               if "flash_wgmma_kernel" in name}
    # d 64 and 128 × both forms, three decomposition modes
    assert len(kernels) == 7, sorted(kernels)
    for name, insts in kernels.items():
        assert hazards(insts) == [], name
        # the softmax-alone and loads-alone modes issue no product
        if "Li2EE" not in name and "Li3EE" not in name:
            assert any(i.op.startswith("HGMMA") and
                       i.operands[1].startswith("R") for i in insts), name


def test_flash_bwd_sass_keeps_in_flight_wgmma_registers(cuda):
    """The built backward's wgmma kernels' SASS, checked by
    tests/torch_sass_wgmma.py: in the one-pass kernel no instruction
    writes Pᵀ's or dSᵀ's registers while dV's or dK's product reads them,
    or touches an accumulator (dV, dK, dQ, or Sᵀ and dPᵀ before the waits
    that retire them) while its product is in flight, on any path
    through the kernel's loops; every instantiation of it (the
    decomposition's included) and of the two-kernel form (head dim
    128)."""
    import re
    import subprocess
    from lua_mapreduce_tpu_torch.ops import _build
    from torch_sass_wgmma import functions, hazards
    _build.library("flash_bwd")
    sass = subprocess.run(
        [_cuobjdump(), "-sass", str(_build._target("flash_bwd"))],
        capture_output=True, text=True, check=True).stdout
    kernels = {name: insts for name, insts in functions(sass).items()
               if re.search(r"bwd_wgmma_kernel|dq_wgmma_kernel|"
                            r"dkv_wgmma_kernel", name)}
    from lua_mapreduce_tpu_torch.ops.attention import FLASH_BWD_MODES
    assert len(kernels) == len(FLASH_BWD_MODES) + 2, sorted(kernels)
    for name, insts in kernels.items():
        assert hazards(insts) == [], name
    one_pass = [n for n in kernels if "bwd_wgmma_kernel" in n]
    assert len(one_pass) == len(FLASH_BWD_MODES)
    for name in one_pass:
        # the elementwise-alone and loads-alone modes issue no product
        if "kernelILi2E" not in name and "kernelILi3E" not in name:
            assert any(i.op.startswith("HGMMA") and
                       i.operands[1].startswith("R")
                       for i in kernels[name]), name


# (causal, window, q_offset, q heads, kv heads, B, L) of the one-pass
# kernel: L not a multiple of 128 and below it, windows and q_offset
# (the ring's hops; key tiles wholly behind the window), GQA 4:1 and
# 8:1, rows that see no key at all (L 200, offset 150, window 60: rows
# from 109 on), fewer items than SMs (1 · 2 · 1 and 2 · 1 · 2 items)
ONE_PASS_CASES = [(True, 0, 0, 4, 4, 2, 300), (True, 0, 0, 2, 2, 1, 100),
                  (True, 0, 0, 2, 2, 1, 40), (False, 0, 0, 4, 4, 2, 200),
                  (True, 37, 0, 8, 2, 2, 300), (True, 70, 130, 4, 4, 2, 257),
                  (True, 96, 700, 2, 2, 1, 900), (True, 0, 0, 8, 2, 2, 515),
                  (True, 0, 0, 8, 1, 2, 260), (True, 60, 150, 4, 2, 2, 200),
                  (True, 0, 0, 1, 1, 2, 128)]


@pytest.mark.parametrize("case", ONE_PASS_CASES)
def test_flash_bwd_one_pass_matches_plain(cuda, case):
    """The one-pass kernel (bf16, head dim 64, one launch) against the
    plain backward, with an lse cotangent: dq, dk and dv at the bf16
    tolerance and normwise within 1e-2; rows that see no key get dq 0
    (the rows' pre-pass writes them: dq is not zeroed first); the
    counters it ran on are back at 0."""
    from lua_mapreduce_tpu_torch.ops.attention import _COUNTERS
    causal, window, q_offset, h, hkv, b, l = case
    q = _randn(cuda, b, l, h, 64, dtype=torch.bfloat16, scale=2.0)
    k = _randn(cuda, b, l, hkv, 64, dtype=torch.bfloat16)
    v = _randn(cuda, b, l, hkv, 64, dtype=torch.bfloat16)
    do = _randn(cuda, b, l, h, 64)
    g_lse = _randn(cuda, b, l, h)
    kw = dict(window=window, q_offset=q_offset)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, with_lse=True,
                                  **kw)
    ops.reset_launch_counts()
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal,
                                   g_lse=g_lse, **kw)
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0),
                                   "flash_bwd_prep": 1, "flash_bwd": 1}
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                     g_lse=g_lse, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w.float(), **BF16, msg=name)
        rel = (g.float() - w.float()).norm() / w.float().norm().clamp_min(
            1e-30)
        assert float(rel) <= 1e-2, name
    if window and q_offset:
        rows = torch.arange(l, device="cuda")
        dead = rows + q_offset - (l - 1) >= window
        assert torch.equal(got[0][:, dead], torch.zeros_like(got[0][:, dead]))
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    ctr = _COUNTERS[(stream.device_index, stream.cuda_stream)]
    assert int(ctr.abs().sum()) == 0


@pytest.mark.parametrize("do_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,g_lse", [(300, True), (128, False), (40, True)])
def test_flash_bwd_prep_matches_plain(cuda, do_dtype, l, g_lse):
    """The one-pass kernel's rows pre-pass (one pass over o and do)
    against its plain version: {lse·log2(e), (rowsum(do∘o) − g_lse) ·
    scale} a row, zero past L, at 1e-5 (the 64-term sum in another
    order)."""
    from lua_mapreduce_tpu_torch.ops.attention import (flash_bwd_rows_cuda,
                                                       flash_bwd_rows_plain)
    o = _randn(cuda, 2, l, 4, 64)
    do = _randn(cuda, 2, l, 4, 64, dtype=do_dtype)
    lse = _randn(cuda, 2, l, 4)
    gl = _randn(cuda, 2, l, 4) if g_lse else None
    ops.reset_launch_counts()
    got = flash_bwd_rows_cuda(o, lse, do, gl)
    assert ops.launch_counts()["flash_bwd_prep"] == 1
    torch.testing.assert_close(got, flash_bwd_rows_plain(o, lse, do, gl),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window,q_offset,l", [
    (True, 60, 150, 200), (True, 96, 700, 900), (True, 0, 0, 300),
    (False, 0, 0, 130), (True, 20, 300, 260)])
def test_flash_bwd_prep_zeroes_the_q_tiles_no_step_writes(cuda, causal,
                                                          window, q_offset,
                                                          l):
    """Given the one-pass launch's dq, the rows' pre-pass writes zeros
    into the q tiles no step of the kernel writes (its CPU mirror
    ``flash_bwd_q_tile_written``) and leaves every other element as it
    was; the rows are the same as without dq."""
    from lua_mapreduce_tpu_torch.ops.attention import (
        FLASH_BWD_BQ, flash_bwd_q_tile_written, flash_bwd_rows_cuda)
    o = _randn(cuda, 2, l, 4, 64)
    do = _randn(cuda, 2, l, 4, 64)
    lse = _randn(cuda, 2, l, 4)
    dq = torch.full((2, l, 4, 64), 7.0, device="cuda", dtype=torch.bfloat16)
    rows = flash_bwd_rows_cuda(o, lse, do, None, dq, causal=causal,
                               window=window, q_offset=q_offset)
    assert torch.equal(rows, flash_bwd_rows_cuda(o, lse, do))
    written = torch.tensor(
        [flash_bwd_q_tile_written(i // FLASH_BWD_BQ, l, causal, window,
                                  q_offset) for i in range(l)],
        device="cuda")
    assert bool((dq[:, written] == 7).all())
    assert bool((dq[:, ~written] == 0).all())
    if window and q_offset:
        assert not bool(written.all())


def test_flash_bwd_one_pass_head_dim_128_keeps_the_two_kernels(cuda):
    """At head dim 128 the TMA path stays the dq and dkv kernels (the
    one-pass kernel is head dim 64 only), and matches the plain
    backward."""
    q, k, v = (_randn(cuda, 2, 300, 4, 128, dtype=torch.bfloat16)
               for _ in range(3))
    do = _randn(cuda, 2, 300, 4, 128)
    o, lse = flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    ops.reset_launch_counts()
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0),
                                   "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), **BF16)


def test_flash_bwd_two_kernel_entries_refuse_the_one_pass_operands(cuda):
    """bf16 operands at head dim 64 that TMA can describe run the
    one-pass kernel or raise: the dq and dkv entry points refuse them."""
    q, k, v, do = (_randn(cuda, 1, 70, 2, 64, dtype=torch.bfloat16)
                   for _ in range(4))
    lse = torch.zeros((1, 70, 2), device="cuda")
    with pytest.raises(RuntimeError, match="launch"):
        flash_bwd_dq_cuda(q, k, v, do, lse, lse, causal=True)
    with pytest.raises(RuntimeError, match="launch"):
        flash_bwd_dkv_cuda(q, k, v, do, lse, lse, causal=True)


@pytest.mark.parametrize("b,l,h,hkv", [(8, 2048, 16, 16), (8, 2048, 16, 4),
                                       (1, 100, 2, 2), (2, 300, 8, 1)])
def test_flash_bwd_plan_matches_the_kernel(cuda, b, l, h, hkv):
    """The one-pass kernel's schedule (``lmr_flash_bwd_plan``) is its CPU
    mirror's on this card."""
    props = torch.cuda.get_device_properties(0)
    assert flash_bwd_kernel_plan(b, l, h, hkv) == flash_bwd_plan(
        b, l, h, hkv, props.multi_processor_count, props.L2_cache_size)


def _one_pass_inputs(cuda, b=2, l=700, h=8, hkv=2):
    q = _randn(cuda, b, l, h, 64, dtype=torch.bfloat16, scale=2.0)
    k, v = (_randn(cuda, b, l, hkv, 64, dtype=torch.bfloat16)
            for _ in range(2))
    do = _randn(cuda, b, l, h, 64)
    o, lse = flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    return q, k, v, o, lse, do


def test_flash_bwd_one_pass_bit_equal_beside_a_concurrent_kernel(cuda):
    """dq's partials are summed in one fixed order, not in the order the
    blocks happen to run: a call beside a long product on another stream
    (which holds SMs, so the backward's blocks start and run at other
    times) gives the bits of a call alone."""
    q, k, v, o, lse, do = _one_pass_inputs(cuda, b=4, l=2048, h=16, hkv=4)
    alone = flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    a = _randn(cuda, 8192, 8192, dtype=torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    for _ in range(3):
        with torch.cuda.stream(side):
            busy = [a @ a for _ in range(4)]
        beside = flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
        torch.cuda.synchronize()
        for x, y in zip(alone, beside):
            assert torch.equal(x, y)
        del busy


def test_flash_bwd_one_pass_captured_equals_eager(cuda):
    """A CUDA graph capture of the backward (its workspace and counters
    in the graph's memory) replays to the eager call's bits."""
    q, k, v, o, lse, do = _one_pass_inputs(cuda)
    eager = flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for x, y in zip(captured, eager):
            assert torch.equal(x, y)


def test_flash_gradient_raises_on_the_card(cuda):
    """The backward on the card launches the dq and dkv kernels once
    each (and the forward its lse form once) and matches the plain
    backward; a head dim the kernels do not take (96) raises."""
    q, k, v = (_randn(cuda, 1, 80, 2, 64).requires_grad_(True)
               for _ in range(3))
    ops.reset_launch_counts()
    out = ops.flash_attention(q, k, v, causal=True)
    w = _randn(cuda, 1, 80, 2, 64)
    (out * w).sum().backward()
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0),
                                   "flash_fwd": 1, "flash_bwd_dq": 1,
                                   "flash_bwd_dkv": 1}
    o, lse = flash_attention_plain(q.detach(), k.detach(), v.detach(), True,
                                   0.125, with_lse=True)
    want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o,
                                     lse, w, True)
    for x, ww in zip((q, k, v), want):
        torch.testing.assert_close(x.grad, ww, **F32)
    q96, k96, v96 = (_randn(cuda, 1, 16, 2, 96).requires_grad_(True)
                     for _ in range(3))
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q96, k96, v96, causal=True).sum().backward()


# (causal, window, q_offset, q heads, kv heads, L)
BWD_CASES = [(False, 0, 0, 4, 4, 96), (True, 0, 0, 4, 4, 200),
             (True, 0, 0, 4, 1, 130), (True, 0, 0, 8, 2, 64),
             (True, 37, 0, 4, 2, 300), (True, 20, 10, 2, 2, 64),
             (True, 8, 44, 2, 2, 40), (True, 70, 130, 4, 4, 257)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernels_match_plain(cuda, dtype, d, case):
    """The backward's kernels against the plain backward on the same
    inputs, with an lse cotangent: f32 at 1e-4, bf16 at 2e-2 and
    normwise within 1e-2. bf16 takes the TMA + wgmma kernels: the
    one-pass kernel at head dim 64, the dq and dkv kernels at 128."""
    causal, window, q_offset, h, hkv, l = case
    q = _randn(cuda, 2, l, h, d, dtype=dtype, scale=0.5)
    k = _randn(cuda, 2, l, hkv, d, dtype=dtype, scale=0.5)
    v = _randn(cuda, 2, l, hkv, d, dtype=dtype, scale=0.5)
    do = _randn(cuda, 2, l, h, d)
    assert flash_bwd_kernel_path(q, k, v, do.to(dtype)) == (
        "f32" if dtype == torch.float32 else "tma")
    g_lse = _randn(cuda, 2, l, h)
    kw = dict(window=window, q_offset=q_offset)
    o, lse = flash_attention_cuda(q, k, v, causal=causal, with_lse=True,
                                  **kw)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal,
                                   g_lse=g_lse, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                     g_lse=g_lse, **kw)
    tol = F32 if dtype == torch.float32 else BF16
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w.float(), **tol, msg=name)
        rel = (g.float() - w.float()).norm() / w.float().norm().clamp_min(
            1e-30)
        assert float(rel) <= (1e-4 if dtype == torch.float32 else 1e-2), \
            name


def test_flash_bwd_kernels_strided_views(cuda):
    """Strided q/k/v views of a fused projection and a strided do give
    the gradients of their contiguous copies, bit for bit."""
    qkv = _randn(cuda, 2, 70, 3 * 4 * 64, dtype=torch.bfloat16)
    q, k, v = (qkv[..., i * 256:(i + 1) * 256].reshape(2, 70, 4, 64)
               for i in range(3))
    do = _randn(cuda, 2, 70, 8, 64)[:, :, ::2]
    o, lse = flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
    want = flash_attention_bwd_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), o, lse, do.contiguous(),
                                    True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", PATH_CASES)
def test_flash_bwd_tma_and_general_paths_agree(cuda, d, case):
    """One input as contiguous tensors (the TMA + wgmma kernels) and as
    misaligned views (the general kernels): dq, dk and dv agree with each
    other and with the plain backward at the bf16 tolerance; L = 300 is
    not a multiple of any tile."""
    causal, window, q_offset, h, hkv = case
    l = 300
    qa, qu = _aligned_and_misaligned(cuda, 2, l, h, d, scale=2.0)
    ka, ku = _aligned_and_misaligned(cuda, 2, l, hkv, d)
    va, vu = _aligned_and_misaligned(cuda, 2, l, hkv, d)
    da, du = _aligned_and_misaligned(cuda, 2, l, h, d)
    assert flash_bwd_kernel_path(qa, ka, va, da) == "tma"
    assert flash_bwd_kernel_path(qu, ku, vu, du) == "general"
    g_lse = _randn(cuda, 2, l, h)
    kw = dict(window=window, q_offset=q_offset, g_lse=g_lse)
    o, lse = flash_attention_cuda(qa, ka, va, causal=causal, with_lse=True,
                                  window=window, q_offset=q_offset)
    fast = flash_attention_bwd_cuda(qa, ka, va, o, lse, da, causal, **kw)
    general = flash_attention_bwd_cuda(qu, ku, vu, o, lse, du, causal, **kw)
    want = flash_attention_bwd_plain(qa, ka, va, o, lse, da, causal, **kw)
    for name, f, g, w in zip(("dq", "dk", "dv"), fast, general, want):
        for got in (f, g):
            torch.testing.assert_close(got.float(), w.float(), **BF16,
                                       msg=name)
        torch.testing.assert_close(f.float(), g.float(), **BF16, msg=name)


def test_flash_bwd_path_follows_the_layout(cuda):
    """lmr_flash_bwd_path: contiguous operands, the model's fused-qkv
    views and a strided do take the TMA + wgmma kernels; a view whose
    row stride breaks 16-byte alignment the general kernels; f32 its
    own."""
    x = _randn(cuda, 2, 70, 4, 64, dtype=torch.bfloat16)
    assert flash_bwd_kernel_path(x, x, x, x) == "tma"
    qkv = _randn(cuda, 2, 70, 3 * 4 * 64, dtype=torch.bfloat16)
    q, k, v = (qkv[..., i * 256:(i + 1) * 256].reshape(2, 70, 4, 64)
               for i in range(3))
    do = _randn(cuda, 2, 70, 8, 64, dtype=torch.bfloat16)[:, :, ::2]
    assert flash_bwd_kernel_path(q, k, v, do) == "tma"
    odd = _randn(cuda, 2, 70, 4 * 64 + 4, dtype=torch.bfloat16)
    q_odd = odd[..., :256].reshape(2, 70, 4, 64)   # row stride 260
    assert flash_bwd_kernel_path(q_odd, k, v, do) == "general"
    assert flash_bwd_kernel_path(q, k, v, q_odd) == "general"
    x32 = x.float()
    assert flash_bwd_kernel_path(x32, x32, x32, x32) == "f32"


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_flash_bwd_two_calls_bit_equal(cuda, group):
    """No unordered sums: two calls of the backward give the same bits,
    GQA's sum over the group and dq's partials (summed in a fixed order)
    included — the one-pass kernel at head dim 64, the dq and dkv
    kernels at 128."""
    h, l = 8, 300
    for d in (64, 128):
        q = _randn(cuda, 2, l, h, d, dtype=torch.bfloat16, scale=2.0)
        k, v = (_randn(cuda, 2, l, h // group, d, dtype=torch.bfloat16)
                for _ in range(2))
        do = _randn(cuda, 2, l, h, d, dtype=torch.bfloat16)
        o, lse = flash_attention_cuda(q, k, v, causal=True, with_lse=True)
        assert flash_bwd_kernel_path(q, k, v, do) == "tma"
        first, second = (flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
                         for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_lm_train_step_on_the_card_matches_the_cpu(cuda):
    """Three free-running f32 train steps (SGD with momentum, remat and
    grad_accum=2) on the card through the kernels against the same steps
    on the CPU: losses within 1e-4 relative, parameters normwise within
    1e-4; flash_fwd runs 2·2·L times a step (remat reruns each block's
    forward, for each of 2 microbatches), dq and dkv 2·L."""
    import dataclasses

    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.train import optim
    cfg = tt.TransformerConfig(vocab=256, d_model=128, n_heads=2,
                               n_layers=2, d_ff=256, max_seq=64)
    p0 = tt.init_transformer(0, cfg, device="cpu")
    seq = torch.randint(0, 256, (4, 65),
                        generator=torch.Generator().manual_seed(1))
    runs = {}
    for dev, c, accum in (("cpu", cfg, 1),
                          ("cuda", dataclasses.replace(cfg, remat=True), 2)):
        p = {n: x.detach().clone().to(dev).requires_grad_(True)
             for n, x in p0.items()}
        step = tt.make_train_step(c, optim.sgd(p.values(), 0.1, 0.9),
                                  grad_accum=accum)
        ops.reset_launch_counts()
        losses = [float(step(p, seq[:, :-1], seq[:, 1:])) for _ in range(3)]
        runs[dev] = (losses, p, ops.launch_counts())
    (lc, pc, _), (lg, pg, counts) = runs["cpu"], runs["cuda"]
    assert counts == {**dict.fromkeys(ops.KERNELS, 0),
                      "flash_fwd": 3 * 2 * 2 * 2, "flash_bwd_dq": 3 * 2 * 2,
                      "flash_bwd_dkv": 3 * 2 * 2}
    for a, b in zip(lg, lc):
        assert abs(a - b) <= 1e-4 * abs(b)
    num = sum(float((pg[n].detach().cpu() - pc[n].detach()).norm()) ** 2
              for n in pc)
    den = sum(float(pc[n].detach().norm()) ** 2 for n in pc)
    assert (num / den) ** 0.5 <= 1e-4


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("g,d,s_len", [(1, 64, 256), (4, 64, 384),
                                       (8, 128, 512), (2, 64, 300),
                                       (1, 128, 1000)])
def test_decode_kernel_matches_plain(cuda, kind, g, d, s_len):
    dtype = torch.bfloat16 if kind != "float32" else torch.float32
    q = _randn(cuda, 2, 2, g, d, dtype=dtype)
    k = _randn(cuda, 2, 2, s_len, d, dtype=dtype)
    v = _randn(cuda, 2, 2, s_len, d, dtype=dtype)
    scales = {}
    if kind == "int8":
        k, ks = ops.quantize_kv(k)
        v, vs = ops.quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    tol = {"float32": FLASH_F32, "bfloat16": BF16, "int8": DECODE_INT8}[kind]
    for t in (0, 5, s_len // 2, s_len - 1, s_len + 40):
        for roll in (False, True):
            got = decode_attention_cuda(q, k, v, t, roll, **scales)
            want = decode_attention_plain(q, k, v, t, roll, **scales)
            torch.testing.assert_close(got, want, **tol,
                                       msg=f"t={t} roll={roll}")


def test_decode_split_policy_lives_in_the_kernel_source(cuda):
    """csrc/decode.cu picks n_split from the capacity S (its arguments
    hold no t): more than one split at the serving shape (64 rows) and
    under GQA 4:1 (16 rows), one for a short cache."""
    from lua_mapreduce_tpu_torch.ops import _build
    lib = _build.library("decode")
    assert lib.lmr_decode_splits(64, 4096, 64, 1, 1) > 1
    assert lib.lmr_decode_splits(16, 4096, 64, 4, 1) > 1
    assert lib.lmr_decode_splits(64, 4096, 64, 1, 2) > 1
    assert lib.lmr_decode_splits(64, 288, 64, 1, 0) == 1
    assert lib.lmr_decode_splits(64, 4096, 96, 1, 1) == 0
    assert decode_splits(64, 4096, 64, 1, 1) == \
        lib.lmr_decode_splits(64, 4096, 64, 1, 1)


@pytest.mark.parametrize("hkv,g", [(16, 1), (4, 4)])
def test_decode_two_calls_bit_equal(cuda, hkv, g):
    q = _randn(cuda, 4, hkv, g, 64, dtype=torch.bfloat16, scale=2.0)
    k = _randn(cuda, 4, hkv, 4096, 64, dtype=torch.bfloat16)
    v = _randn(cuda, 4, hkv, 4096, 64, dtype=torch.bfloat16)
    first = decode_attention_cuda(q, k, v, 4094, False)
    for _ in range(2):
        assert torch.equal(decode_attention_cuda(q, k, v, 4094, False), first)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_decode_split_edges_match_plain(cuda, kind, g, d):
    """t at 0, inside the first split only, on a split boundary (its
    last and the next split's first position), at S - 1, and rolled past
    S, with the splits of a 4096-slot cache."""
    dtype = torch.bfloat16 if kind != "float32" else torch.float32
    s_len = 4096
    q = _randn(cuda, 2, 2, g, d, dtype=dtype, scale=2.0)
    k = _randn(cuda, 2, 2, s_len, d, dtype=dtype)
    v = _randn(cuda, 2, 2, s_len, d, dtype=dtype)
    scales = {}
    if kind == "int8":
        k, ks = ops.quantize_kv(k)
        v, vs = ops.quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    code = {"float32": 0, "bfloat16": 1, "int8": 2}[kind]
    n_split = decode_splits(4, s_len, d, g, code)
    assert n_split > 1
    split_len = -(-s_len // n_split)
    tol = {"float32": FLASH_F32, "bfloat16": BF16, "int8": DECODE_INT8}[kind]
    for t, roll in ((0, False), (split_len // 3, False),
                    (split_len - 1, False), (split_len, False),
                    (s_len - 1, False), (s_len + 40, True)):
        got = decode_attention_cuda(q, k, v, t, roll, **scales)
        want = decode_attention_plain(q, k, v, t, roll, **scales)
        torch.testing.assert_close(got, want, **tol,
                                   msg=f"t={t} roll={roll}")


def test_decode_combine_matches_plain(cuda):
    """The combine kernel alone against _merge_splits_plain, one split
    of one row left empty (m = -1e30, l = 0, acc = 0)."""
    rows, n_split, g, d = 16, 9, 4, 64
    m = _randn(cuda, rows, n_split, g, scale=3.0)
    l = torch.rand((rows, n_split, g), device="cuda", generator=cuda) + 0.5
    acc = _randn(cuda, rows, n_split, g, d)
    m[3, 5], l[3, 5], acc[3, 5] = -1e30, 0.0, 0.0
    got = merge_splits_cuda(m, l, acc)
    torch.testing.assert_close(got, _merge_splits_plain(m, l, acc),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(merge_splits_cuda(m, l, acc), got)


# (K, N) of the serving cells' decode products: qkv, out, ff1, ff2, head
Q8_DECODE = [(1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024),
             (1024, 32768)]


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (4, 1024, 3072),
                                   (4, 4096, 1024), (3, 1100, 200),
                                   (8, 300, 501), (9, 128, 200),
                                   (33, 1024, 1024), (256, 512, 384),
                                   # M > 8 at ragged N and K % 8 != 0
                                   (40, 1100, 200), (129, 1024, 272),
                                   (300, 1030, 520),
                                   # the GEMV at ragged N and K, N % 16
                                   # != 0, and K past one staged chunk
                                   (5, 1030, 520), (7, 96, 17),
                                   (2, 20000, 16)]
                         + [(m, k, n) for m in range(1, 9)
                            for k, n in Q8_DECODE])
def test_q8_kernel_matches_plain(cuda, xdtype, m, k, n):
    w = _randn(cuda, k, n)
    q, s = ops.quantize_q8(w)
    # the kernel rounds x to bf16: hold it against the plain version on
    # the same bf16 values (test_q8.py's precision-matched comparison)
    x = _randn(cuda, m, k).to(torch.bfloat16).to(xdtype)
    got = q8_matmul_cuda(x, q, s.reshape(-1))
    assert got.dtype == xdtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(),
                               q8_matmul_plain(x, q, s).float(),
                               rtol=2e-2, atol=2e-2)


def test_q8_split_policy_lives_in_the_kernel_source(cuda):
    """csrc/q8.cu decides the K split (a cluster, summed inside the one
    launch); the wrapper asks for no scratch and refuses what the kernel
    refuses. Its plan equals ops/q8.py's mirror at this card's SMs."""
    from lua_mapreduce_tpu_torch.ops import _build
    from lua_mapreduce_tpu_torch.ops.q8 import gemv_plan, q8_gemv_plan
    lib = _build.library("q8")
    assert lib.lmr_q8_splits(4, 4096, 1024) > 1       # narrow N: split K
    assert lib.lmr_q8_splits(4, 32, 128) == 1         # K too short to split
    assert lib.lmr_q8_splits(4, 1024, 32768) == 1     # N alone fills it
    assert lib.lmr_q8_splits(9, 4096, 1024) == 1      # tensor-core path
    assert lib.lmr_q8_splits(65535 * 128 + 1, 8, 8) == 0
    q, s = ops.quantize_q8(_randn(cuda, 1, 1))
    with pytest.raises(ValueError, match="grid limit"):
        q8_matmul_cuda(torch.zeros((65535 * 128 + 1, 1), device="cuda"), q,
                       s.reshape(-1))
    for k, n in Q8_DECODE + [(256, 128), (1100, 200), (300, 501), (96, 17),
                             (20000, 16), (32, 128)]:
        for m in (1, 4, 8):
            plan, cluster_sms = q8_gemv_plan(m, k, n)
            assert plan == gemv_plan(k, n, cluster_sms), (m, k, n)
            assert lib.lmr_q8_splits(m, k, n) == plan.split
    # M <= 8 split 8 ways: the output is the only allocation
    q, s = ops.quantize_q8(_randn(cuda, 4096, 1024))
    x = _randn(cuda, 4, 4096, dtype=torch.bfloat16)
    assert lib.lmr_q8_splits(4, 4096, 1024) == 8
    q8_matmul_cuda(x, q, s.reshape(-1))
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    q8_matmul_cuda(x, q, s.reshape(-1))
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == \
        before + 1


def _q8_inputs(gen, m, k, n, xdtype=torch.bfloat16):
    q, s = ops.quantize_q8(_randn(gen, k, n))
    return _randn(gen, m, k).to(xdtype), q, s.reshape(-1)


@pytest.mark.parametrize("m,k,n,split", [(4, 1024, 32768, 1),
                                         (4, 1024, 1024, 8),
                                         (8, 4096, 1024, 8),
                                         (1, 1024, 3072, 4),
                                         (2, 1024, 4096, 2)])
def test_q8_gemv_is_one_launch_and_bit_equal_over_calls(cuda, m, k, n,
                                                        split):
    """A GEMV call, split or not, is one kernel in the trace (no
    reduce), and two calls give the same bits."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from lua_mapreduce_tpu_torch.ops import _build
    x, q, s = _q8_inputs(cuda, m, k, n)
    assert _build.library("q8").lmr_q8_splits(m, k, n) == split
    got = q8_matmul_cuda(x, q, s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        again = q8_matmul_cuda(x, q, s)
        torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    assert len(kernels) == 1 and "gv::gemv_kernel" in kernels[0], kernels
    assert torch.equal(again, got)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4, 1024, 1024), (1, 256, 128),
                                   (3, 1100, 200), (8, 300, 501),
                                   (2, 20000, 16), (4, 256, 32768),
                                   (6, 4096, 1024)])
def test_q8_gemv_equals_its_model_bit_for_bit(cuda, xdtype, m, k, n):
    """The kernel's sums in the order csrc/q8.cu says
    (tests/torch_q8_gemv_model.py, numpy on the host) give the card's
    bits: the strips, the cluster's ranks, the K-lanes' halving
    exchanges and the widening."""
    from lua_mapreduce_tpu_torch.ops.q8 import q8_gemv_plan
    from torch_q8_gemv_model import gemv
    x, q, s = _q8_inputs(cuda, m, k, n, xdtype)
    got = q8_matmul_cuda(x, q, s).cpu()
    want = gemv(x.cpu(), q.cpu(), s.cpu(), q8_gemv_plan(m, k, n)[1])
    assert got.dtype == want.dtype
    assert torch.equal(got, want), float((got.float() - want.float())
                                         .abs().max())


@pytest.mark.parametrize("cols", [128, 64, 32])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("m,k,n", [(4, 1024, 1024), (3, 1100, 200)])
def test_q8_gemv_at_every_plan(cuda, m, k, n, cols, split):
    """The GEMV at every strip width and cluster split it takes, whether
    its plan would pick it or not: the model's bits, and two calls give
    the same bits."""
    from lua_mapreduce_tpu_torch.ops.q8 import q8_gemv_cuda
    from torch_q8_gemv_model import gemv
    x, q, s = _q8_inputs(cuda, m, k, n)
    got = q8_gemv_cuda(x, q, s, cols, split)
    assert torch.equal(q8_gemv_cuda(x, q, s, cols, split), got)
    want = gemv(x.cpu(), q.cpu(), s.cpu(), (1, 1, 1, 1), plan=(cols, split))
    assert torch.equal(got.cpu(), want)
    torch.testing.assert_close(got.float(), q8_matmul_plain(x, q, s).float(),
                               rtol=2e-2, atol=2e-2)


# the prefill kernel (M > 8) at ragged M, N and K around its token
# widths (208, 128 for an f32 output) and its 128-channel tile, and at a
# serving shape
Q8_PREFILL = [(9, 64, 16), (300, 200, 272), (257, 1000, 144),
              (129, 8, 400), (209, 136, 48), (417, 192, 256),
              (4000, 1024, 1024)]


@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", Q8_PREFILL)
def test_q8_prefill_matches_plain_and_its_model(cuda, xdtype, m, k, n):
    """The prefill kernel within test_q8.py's tolerance of the plain
    version, bit-equal over two calls and to the main path, and the
    model's bits (tests/torch_q8_prefill_model.py) on integer-valued
    inputs."""
    from lua_mapreduce_tpu_torch.ops.q8 import (q8_prefill_forced,
                                                q8_prefill_plan)
    from torch_q8_prefill_model import prefill
    x, q, s = _q8_inputs(cuda, m, k, n, xdtype)
    x = x.to(torch.bfloat16).to(xdtype)
    want = q8_matmul_plain(x, q, s)
    assert q8_prefill_plan(x, q)[0] == "rs"
    got = q8_prefill_forced(x, q, s, "rs")
    assert got.dtype == xdtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(q8_prefill_forced(x, q, s, "rs"), got)
    assert torch.equal(q8_matmul_cuda(x, q, s), got)
    if m * k * n > 1 << 27:
        return                       # the numpy model's time: small shapes
    # integer-valued x and power-of-two scales: sums f32 holds exactly
    xi = torch.randint(-4, 5, (m, k), device="cuda", generator=cuda
                       ).to(xdtype)
    si = 2.0 ** torch.randint(-12, -6, (n,), device="cuda",
                              generator=cuda).float()
    got = q8_prefill_forced(xi, q, si, "rs").cpu()
    assert torch.equal(got, prefill(xi.cpu(), q.cpu(), si.cpu()))


def test_q8_prefill_plan_equals_its_mirror(cuda):
    """csrc/q8.cu's prefill plan on this card equals ops/q8.py's mirror
    at the card's SMs, for every serving product and the check run's f32
    qkv; layouts TMA cannot read take the general kernel."""
    from lua_mapreduce_tpu_torch.ops.q8 import prefill_plan, q8_prefill_plan
    for m, k, n in [(15872, 1024, 3072), (15872, 1024, 1024),
                    (15872, 1024, 4096), (15872, 4096, 1024),
                    (15872, 1024, 32768), (1024, 1024, 3072)] + Q8_PREFILL:
        for xdtype in (torch.bfloat16, torch.float32):
            x = torch.empty((m, k), device="cuda", dtype=xdtype)
            q = torch.empty((k, n), device="cuda", dtype=torch.int8)
            route, plan, sms = q8_prefill_plan(x, q)
            assert route == "rs"
            assert plan == prefill_plan(m, n, xdtype == torch.float32,
                                        sms), (m, k, n, xdtype)
    for k, n in ((1030, 512), (1024, 200)):          # K % 8, N % 16
        x = torch.empty((64, k), device="cuda", dtype=torch.bfloat16)
        q = torch.empty((k, n), device="cuda", dtype=torch.int8)
        assert q8_prefill_plan(x, q)[0] == "general"


@pytest.mark.parametrize("m,k,n,kernel", [
    (15872, 1024, 3072, "pf::prefill_kernel"),
    (300, 1024, 272, "pf::prefill_kernel"),
    (300, 1030, 520, "mk::mma_kernel")])
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
def test_q8_prefill_is_one_launch(cuda, m, k, n, kernel, xdtype):
    """An M > 8 call is one kernel in the trace: the prefill kernel, or
    the general kernel for a layout TMA cannot read (an f32 x's rounding
    to bf16 is a torch copy before it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x, q, s = _q8_inputs(cuda, m, k, n, xdtype)
    q8_matmul_cuda(x, q, s)
    torch.cuda.synchronize()
    # a window of several calls: the profiler can drop a window's first
    # kernels, and now and then a whole window (a trace with no device
    # events at all is read again, at most three times)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                q8_matmul_cuda(x, q, s)
            torch.cuda.synchronize()
        kernels = [e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and "elementwise" not in e.key]
        if kernels:
            break
    assert len(kernels) == 1 and kernel in kernels[0], kernels


def test_q8_prefill_refuses_a_route_it_cannot_run(cuda):
    from lua_mapreduce_tpu_torch.ops.q8 import q8_prefill_forced
    x, q, s = _q8_inputs(cuda, 64, 256, 128)
    # K % 8 != 0 (TMA cannot read x), M within the GEMV's
    for xx, route in ((x[:, 1:], "rs"), (x[:8], "rs"), (x[:8], "general")):
        with pytest.raises(RuntimeError, match="q8 prefill launch"):
            q8_prefill_forced(xx, q[:xx.shape[1]], s, route)
    with pytest.raises(KeyError):                    # no such route
        q8_prefill_forced(x, q, s, "w8")
    x2, q2, s2 = _q8_inputs(cuda, 64, 256, 200)      # N % 16 != 0
    with pytest.raises(RuntimeError, match="q8 prefill launch"):
        q8_prefill_forced(x2, q2, s2, "rs")
    torch.testing.assert_close(
        q8_prefill_forced(x2, q2, s2, "general").float(),
        q8_matmul_plain(x2, q2, s2).float(), rtol=2e-2, atol=2e-2)


def test_q8_prefill_sass_keeps_in_flight_wgmma_registers(cuda):
    """The built prefill kernels' SASS, checked by
    tests/torch_sass_wgmma.py: no instruction writes the A fragment
    registers of an HGMMA still in flight (the fragments are rebuilt in
    registers while the tensor cores read the last K-tile's), or reads
    or writes its accumulators, before the WARPGROUP.DEPBAR that retires
    it, on any path through the kernel's loops."""
    import os
    import shutil
    import subprocess
    from lua_mapreduce_tpu_torch.ops import _build
    from torch_sass_wgmma import functions, hazards
    _build.library("q8")
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build._target("q8"))],
                          capture_output=True, text=True, check=True).stdout
    kernels = {name: insts for name, insts in functions(sass).items()
               if "prefill_kernel" in name}
    assert len(kernels) == 2, sorted(kernels)
    for name, insts in kernels.items():
        # a K-tile's four k16 steps from registers, twice (two buffers)
        rs = [i for i in insts if i.op.startswith("HGMMA")
              and i.operands[1].startswith("R")]
        assert len(rs) == 8, (name, len(rs))
        assert hazards(insts) == [], name


def test_q8_gemv_refuses_a_plan_it_cannot_run(cuda):
    from lua_mapreduce_tpu_torch.ops.q8 import q8_gemv_cuda
    x, q, s = _q8_inputs(cuda, 4, 64, 128)
    for cols, split in ((48, 1), (128, 3), (128, 16), (32, 2)):
        with pytest.raises(RuntimeError, match="q8 GEMV launch"):
            q8_gemv_cuda(x, q, s, cols, split)


def _cuobjdump():
    import os
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "cuobjdump")


def test_q8_gemv_widens_int8_without_i2f(cuda):
    """The SASS of every GEMV instantiation (2 x dtypes × M of 1, 2, 4,
    8 × 3 strip widths) has byte permutes and no I2F: int8 is widened on
    the full-rate pipes."""
    import re
    import subprocess
    from lua_mapreduce_tpu_torch.ops import _build
    _build.library("q8")
    sass = subprocess.run([_cuobjdump(), "-sass", str(_build._target("q8"))],
                          capture_output=True, text=True, check=True).stdout
    funcs = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split(None, 1)[0]
        if "gemv_kernel" in name:
            funcs[name] = chunk
    assert len(funcs) == 24, sorted(funcs)
    for name, body in funcs.items():
        assert not re.search(r"\bI2F", body), name
        assert re.search(r"\bPRMT\b", body), name


def test_serving_kernels_launch_and_count(cuda):
    ops.reset_launch_counts()
    x = _randn(cuda, 1, 8, 2, 64)
    ops.flash_attention(x, x, x, causal=True)
    c = _randn(cuda, 1, 2, 16, 64)
    ops.decode_attention(_randn(cuda, 1, 2, 1, 64), c, c, 3)
    q, s = ops.quantize_q8(_randn(cuda, 64, 32))
    ops.q8_matmul(_randn(cuda, 4, 64), q, s)
    counts = ops.launch_counts()
    assert {k: counts[k] for k in ("flash_fwd", "decode", "q8")} == \
        {"flash_fwd": 1, "decode": 1, "q8": 1}


def test_lm_on_the_card_matches_the_cpu(cuda):
    """Greedy tokens through the kernels equal the CPU run through the
    plain versions (f32, head dim 64), prefill and scan alike."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    cfg = tt.TransformerConfig(vocab=256, d_model=128, n_heads=2,
                               n_layers=2, d_ff=256, max_seq=64)
    p_cpu = tt.init_transformer(0, cfg, device="cpu")
    p_gpu = {k: v.cuda() for k, v in p_cpu.items()}
    prompt = torch.randint(0, 256, (2, 20),
                           generator=torch.Generator().manual_seed(1))
    want = tt.greedy_decode(p_cpu, prompt, 12, cfg=cfg, use_prefill=True)
    for use_prefill in (True, False):
        got = tt.greedy_decode(p_gpu, prompt.cuda(), 12, cfg=cfg,
                               use_prefill=use_prefill)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


# ----------------------------------------------------- conv-path kernels

from lua_mapreduce_tpu_torch.ops.conv import _pad_hw  # noqa: E402
from lua_mapreduce_tpu_torch.ops.pool import (_pool_plain,  # noqa: E402
                                              pool_cuda, pool_kernel_plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("shape,window,stride", [
    ((4, 28, 28, 6), (2, 2), (2, 2)), ((3, 10, 10, 16), (2, 2), (2, 2)),
    ((2, 23, 23, 64), (3, 3), (2, 2)), ((2, 9, 7, 5), (3, 2), (1, 2))])
def test_pool_kernel_matches_plain(cuda, dtype, mode, shape, window, stride):
    x = _randn(cuda, *shape, dtype=dtype)
    got = pool_cuda(x, window, stride, mode)
    want = _pool_plain(x, window, stride, mode)
    assert got.dtype == dtype and got.shape == want.shape
    if mode == "max":
        torch.testing.assert_close(got, want, rtol=0, atol=0)   # exact
    elif dtype == torch.float32:
        # same sum order; the kernel divides by KH·KW, torch multiplies
        # by its reciprocal (one rounding apart for 3x3)
        torch.testing.assert_close(got, want, **F32)
    else:
        # the kernel sums in f32, the plain version in bf16
        torch.testing.assert_close(got.float(),
                                   _pool_plain(x.float(), window, stride,
                                               mode), **BF16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernel_neg_inf_border_and_ties(cuda, dtype):
    """The stem's -inf border gives no -inf or NaN where a window holds a
    finite value, and -inf where it holds none; on a tie-heavy input the
    gradient through the kernel's Function equals plain autograd."""
    x = torch.relu(_randn(cuda, 2, 16, 16, 8)).to(dtype)   # zero ties
    xp = _pad_hw(x, (1, 1), (1, 1), value=-float("inf"))
    got = ops.maxpool2d(xp, 3, 2)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, _pool_plain(xp, (3, 3), (2, 2), "max"),
                               rtol=0, atol=0)
    ninf = torch.full((1, 4, 4, 3), -float("inf"), device="cuda",
                      dtype=dtype)
    assert bool((pool_cuda(ninf, (2, 2), (2, 2), "max") ==
                 -float("inf")).all())
    ties = torch.randint(0, 3, (2, 9, 9, 4), device="cuda",
                         generator=cuda).to(dtype)
    for window, stride in (((2, 2), (2, 2)), ((3, 3), (2, 2))):
        (got,) = _grads(lambda t: (ops.maxpool2d(t, window, stride).float()
                                   ** 2).sum(), ties)
        (want,) = _grads(lambda t: (_pool_plain(t, window, stride, "max")
                                    .float() ** 2).sum(), ties)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lenet_grads_through_kernels_match_plain(cuda, dtype):
    """LeNet's loss and gradients through the kernels against the same
    model on CPU copies of the inputs and parameters (plain versions)."""
    from lua_mapreduce_tpu_torch.models.lenet import init_lenet, nll_loss
    x = torch.rand((64, 32, 32, 3), device="cuda", generator=cuda).to(dtype)
    y = torch.randint(0, 10, (64,), device="cuda", generator=cuda)
    p0 = init_lenet(1, dtype=dtype, device="cuda")
    grads = []
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev).requires_grad_(True) for k, v in p0.items()}
        loss = nll_loss(p, x.to(dev), y.to(dev))
        grads.append((loss.cpu(), {k: g.cpu() for k, g in zip(
            p, torch.autograd.grad(loss, list(p.values())))}))
    (lk, gk), (lp, gp) = grads
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(lk.float(), lp.float(), **tol)
    for k in gk:
        torch.testing.assert_close(gk[k].float(), gp[k].float(), **tol,
                                   msg=k)
        rel = (gk[k].float() - gp[k].float()).norm() / gp[k].float().norm()
        assert float(rel) <= (1e-4 if dtype == torch.float32 else 1e-2), k


def test_conv_models_launch_the_kernels(cuda):
    """One LeNet and one ImageNet-stem ResNet step launch exactly the
    counts worked out from the code."""
    from lua_mapreduce_tpu_torch.models import lenet, resnet
    p = {k: v.requires_grad_(True)
         for k, v in lenet.init_lenet(0, device="cuda").items()}
    x = torch.rand((8, 32, 32, 3), device="cuda", generator=cuda)
    y = torch.randint(0, 10, (8,), device="cuda", generator=cuda)
    ops.reset_launch_counts()
    lenet.nll_loss(p, x, y).backward()
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0),
                                   "matmul_f32": 5, "pool": 2,
                                   "rowwise_softmax": 1}
    cfg = resnet.ResNetConfig(input_shape=(64, 64, 3), n_classes=1000)
    p = {k: v.requires_grad_(True)
         for k, v in resnet.init_resnet(0, cfg, device="cuda").items()}
    x = torch.rand((2, 64, 64, 3), device="cuda", generator=cuda)
    ops.reset_launch_counts()
    resnet.make_loss(cfg)(p, x, torch.tensor([1, 2], device="cuda")
                          ).backward()
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0),
                                   "matmul_f32": 59, "pool": 1,
                                   "rowwise_softmax": 1}


def test_resnet_on_the_card_matches_the_cpu(cuda):
    from lua_mapreduce_tpu_torch.models import resnet
    cfg = resnet.ResNetConfig(input_shape=(64, 64, 3), n_classes=1000)
    p_cpu = resnet.init_resnet(2, cfg, device="cpu")
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    y = torch.tensor([5, 700])
    losses = []
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev).requires_grad_(True) for k, v in p_cpu.items()}
        loss = resnet.make_loss(cfg)(p, x.to(dev), y.to(dev))
        g = torch.autograd.grad(loss, list(p.values()))
        losses.append((float(loss), {k: v.cpu() for k, v in zip(p, g)}))
    (lc, gc), (lg, gg) = losses
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for k in gc:
        torch.testing.assert_close(gg[k], gc[k], **F32, msg=k)
    # normwise too (small gradients pass any atol); 2e-2 admits a ReLU
    # kink flipped by rounding, as chip_smoke's conv check does
    diff = sum(float((gg[k] - gc[k]).norm()) ** 2 for k in gc) ** 0.5
    assert diff <= 2e-2 * sum(float(v.norm()) ** 2 for v in gc.values()) ** 0.5


def test_pool_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        pool_cuda(torch.zeros(1, 4, 4, 2, device="cuda",
                              dtype=torch.float16), (2, 2), (2, 2), "max")
    with pytest.raises(ValueError, match="mode"):
        pool_cuda(torch.zeros(1, 4, 4, 2, device="cuda"), (2, 2), (2, 2),
                  "min")
    # a non-contiguous input is read through one contiguous copy
    x = _randn(cuda, 2, 8, 8, 6)[..., ::2]
    torch.testing.assert_close(pool_cuda(x, (2, 2), (2, 2), "max"),
                               _pool_plain(x, (2, 2), (2, 2), "max"),
                               rtol=0, atol=0)


def _pool_input(gen, shape, dtype, offset):
    """An NHWC input; with ``offset`` elements of a flat buffer before
    it, so its accesses are misaligned by that many elements."""
    numel = shape[0] * shape[1] * shape[2] * shape[3]
    flat = _randn(gen, numel + offset, dtype=dtype)
    return flat[offset:].view(shape)


# (C, dtype, offset, branch/width): 16-byte chunks where C·itemsize is a
# multiple of 16 on an aligned pointer, else bf16 pairs or elements
POOL_CASES = [(c, dt, off) for c in (5, 6, 8, 16, 64)
              for dt in (torch.float32, torch.bfloat16) for off in (0, 1, 2)]


def _pool_expect(c, dtype, offset):
    item = 4 if dtype == torch.float32 else 2
    if offset == 0 and c * item % 16 == 0:
        return "vector", 16 // item
    if item == 2 and c % 2 == 0 and offset * item % 4 == 0:
        return "general", 2
    return "general", 1


@pytest.mark.parametrize("c,dtype,offset", POOL_CASES)
@pytest.mark.parametrize("mode", ["max", "avg"])
@pytest.mark.parametrize("hw,window,stride", [
    (28, (2, 2), (2, 2)), (23, (3, 3), (2, 2)), (9, (3, 2), (1, 2))])
def test_pool_branches_match_plain(cuda, c, dtype, offset, mode, hw, window,
                                   stride):
    x = _pool_input(cuda, (3, hw, hw, c), dtype, offset)
    plan = pool_kernel_plan(x, window, stride)
    assert (plan.branch, plan.width) == _pool_expect(c, dtype, offset)
    got = pool_cuda(x, window, stride, mode)
    want = _pool_plain(x, window, stride, mode)
    if mode == "max":
        torch.testing.assert_close(got, want, rtol=0, atol=0)   # exact
    elif dtype == torch.float32:
        torch.testing.assert_close(got, want, **F32)
    else:
        torch.testing.assert_close(got.float(),
                                   _pool_plain(x.float(), window, stride,
                                               mode), **BF16)
    assert torch.equal(pool_cuda(x, window, stride, mode), got)


def test_pool_main_path_shapes_take_the_vector_branch(cuda):
    bf = torch.bfloat16
    for shape, window, name in (((32, 114, 114, 64), 3, "vector/w8"),
                                ((1024, 10, 10, 16), 2, "vector/w8"),
                                ((1024, 28, 28, 6), 2, "general/w2")):
        x = torch.empty(shape, device="cuda", dtype=bf)
        got = pool_kernel_plan(x, (window, window), (2, 2)).name
        assert got == name, shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [6, 64])
def test_pool_nan_and_neg_inf_windows(cuda, dtype, c):
    """NaN wins its window and stays; an all -inf window gives -inf; a
    window with -inf and a finite value gives the value."""
    x = torch.relu(_randn(cuda, 2, 9, 9, c))
    x[:, :3, :3] = -float("inf")
    x[0, 4, 4, : c // 2] = float("nan")
    x[1, 6, 0] = -float("inf")
    x = x.to(dtype)
    for window in ((2, 2), (3, 3)):
        got = pool_cuda(x, window, (2, 2), "max")
        want = _pool_plain(x, window, (2, 2), "max")
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
        assert bool(got.isnan().any()) and bool((got == -float("inf")).any())


def test_pool_kernel_refuses_a_plan_it_cannot_run(cuda):
    from lua_mapreduce_tpu_torch.ops import _build
    from lua_mapreduce_tpu_torch.ops.pool import BRANCHES, pool_plan
    lib = _build.library("pool")
    x = _randn(cuda, 2, 8, 8, 16, dtype=torch.bfloat16)
    y = torch.empty(2, 4, 4, 16, device="cuda", dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    good = pool_plan(2, 8, 8, 16, (2, 2), (2, 2), torch.bfloat16, 16)

    def rc(plan, xp=x.data_ptr()):
        return lib.lmr_pool(xp, y.data_ptr(), 2, 8, 8, 16, 2, 2, 2, 2, 1,
                            0, BRANCHES.index(plan.branch), plan.width,
                            *plan.block, *plan.grid, stream)
    assert rc(good) == 0
    for bad in (good._replace(block=(2, 2, 2)),           # rows uncovered
                good._replace(width=2),                   # branch mismatch
                good._replace(block=(8, 8, 8)),           # > 256 threads
                good._replace(grid=(1, 1, 3))):           # more images
        assert rc(bad) != 0, bad
    assert rc(good, xp=x.data_ptr() + 2) != 0             # misaligned


# ------------------------------------------ captured loops (CUDA graphs)

class _EagerGraph:
    """Stands in for ``graphs.CapturedGraph``: calls the step at every
    replay, so a test can run the same loop eagerly on the card."""

    def __init__(self, fn, tag="graph"):
        self.fn = fn
        self.output = None

    def replay(self):
        self.output = self.fn()
        return self.output


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("g", [1, 4])
def test_decode_device_t_at_split_edges_matches_plain(cuda, kind, g):
    """The kernel reads t from device memory: at every t around each
    split's edges (rolled past S too), one device tensor advanced in
    place, it equals the plain version at that t and the int-t call."""
    dtype = torch.bfloat16 if kind != "float32" else torch.float32
    s_len, d = 2048, 64
    q = _randn(cuda, 2, 2, g, d, dtype=dtype, scale=2.0)
    k = _randn(cuda, 2, 2, s_len, d, dtype=dtype)
    v = _randn(cuda, 2, 2, s_len, d, dtype=dtype)
    scales = {}
    if kind == "int8":
        k, ks = ops.quantize_kv(k)
        v, vs = ops.quantize_kv(v)
        scales = dict(k_scale=ks, v_scale=vs)
    code = {"float32": 0, "bfloat16": 1, "int8": 2}[kind]
    n_split = decode_splits(4, s_len, d, g, code)
    split_len = -(-s_len // n_split)
    edges = sorted({e + o for z in range(n_split + 1)
                    for e in [z * split_len] for o in (-1, 0, 1)
                    if 0 <= e + o < s_len + 3})
    tol = {"float32": FLASH_F32, "bfloat16": BF16, "int8": DECODE_INT8}[kind]
    t_dev = torch.zeros((), dtype=torch.int64, device="cuda")
    for roll in (False, True):
        for t in edges:
            t_dev.fill_(t)
            got = decode_attention_cuda(q, k, v, t_dev, roll, **scales)
            want = decode_attention_plain(q, k, v, t, roll, **scales)
            torch.testing.assert_close(got, want, **tol,
                                       msg=f"t={t} roll={roll}")
            assert torch.equal(
                got, decode_attention_cuda(q, k, v, t, roll, **scales))


def _serving_cfg(name):
    from lua_mapreduce_tpu_torch.models import transformer as tt
    base = dict(vocab=512, d_model=256, n_heads=4, n_layers=2, d_ff=512,
                max_seq=128)
    if name == "window":
        base["window"] = 24
    if name == "gqa":
        base.update(n_heads=8, n_kv_heads=2, d_model=512)
    return tt.TransformerConfig(**base)


@pytest.mark.parametrize("name,dtype,kv_q8", [
    ("mha", torch.bfloat16, False), ("mha", torch.bfloat16, True),
    ("window", torch.bfloat16, False), ("gqa", torch.bfloat16, False)])
@pytest.mark.parametrize("use_prefill", [True, False])
def test_captured_decode_equals_eager(cuda, monkeypatch, name, dtype, kv_q8,
                                      use_prefill):
    """greedy_decode's replayed graph gives the tokens the same step
    gives run eagerly on the card: bf16, int8 weights and KV, a rolling
    window, GQA 4:1; greedy and sampled; the launch counts credited per
    replay equal the eager loop's."""
    from lua_mapreduce_tpu_torch import graphs
    from lua_mapreduce_tpu_torch.models import transformer as tt
    cfg = _serving_cfg(name)
    p = tt.init_transformer(0, cfg, dtype=dtype, device="cuda")
    if kv_q8:
        p = tt.quantize_lm(p)
    prompt = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    for sample in ({}, dict(temperature=0.8, top_k=40, key=7)):
        kw = dict(cfg=cfg, use_prefill=use_prefill, kv_q8=kv_q8, **sample)
        ops.reset_launch_counts()
        graphs.reset_captures()
        got = tt.greedy_decode(p, prompt.cuda(), 20, **kw).cpu()
        counts = ops.launch_counts()
        n, (tag, _) = graphs.captures()
        assert (n, tag) == (1, "decode step")
        with monkeypatch.context() as m:
            m.setattr(tt, "CapturedGraph", _EagerGraph)
            ops.reset_launch_counts()
            want = tt.greedy_decode(p, prompt.cuda(), 20, **kw).cpu()
            assert ops.launch_counts() == counts
        assert torch.equal(got, want), sample


def _train_pair(model):
    from lua_mapreduce_tpu_torch.models import lenet, mlp
    gen = torch.Generator().manual_seed(5)
    if model == "digits":
        params = mlp.init_mlp(0, device="cpu")
        x = torch.rand(128, 256, generator=gen)
        y = torch.randint(0, 10, (128,), generator=gen)
        return mlp.nll_loss, params, x, y
    params = lenet.init_lenet(0, device="cpu")
    x = torch.rand(64, 32, 32, 3, generator=gen)
    y = torch.randint(0, 10, (64,), generator=gen)
    return lenet.nll_loss, params, x, y


@pytest.mark.parametrize("model", ["digits", "lenet"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_train_steps_equal_eager(cuda, model, dtype):
    """run_steps' replays equal an eager loop over the same loss_fn with
    a fresh torch SGD, bit for bit: losses, then parameters; a second
    run_steps at the shape does not capture again."""
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)
    loss_fn, params, x, y = _train_pair(model)
    params = {k: v.to(dtype) for k, v in params.items()}
    x = x.to(dtype).cuda()
    y = y.cuda()
    c = TrainConfig(batch_size=len(x))
    tr = DataParallelTrainer(loss_fn, params, c, device="cuda")
    got = tr.run_steps(x, y, 4).cpu()
    assert tr.traces == 1
    got = torch.cat([got, tr.run_steps(x, y, 3).cpu()])
    assert tr.traces == 1
    ref = {k: v.detach().cuda().clone().requires_grad_(True)
           for k, v in params.items()}
    opt = torch.optim.SGD(list(ref.values()), lr=c.learning_rate,
                          momentum=c.momentum, weight_decay=c.weight_decay)
    want = []
    for _ in range(7):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(ref, x, y)
        loss.backward()
        opt.step()
        want.append(loss.detach())
    assert torch.equal(got, torch.stack(want).cpu())
    for k in ref:
        assert torch.equal(tr.params[k].detach(), ref[k].detach()), k


def test_captured_step_launches_credited_per_replay(cuda):
    """Launch counts after captured steps equal the kernels that ran:
    one eager step plus one credit per replay, nothing for the capture."""
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)
    loss_fn, params, x, y = _train_pair("digits")
    tr = DataParallelTrainer(loss_fn, params, TrainConfig(batch_size=128),
                             device="cuda")
    ops.reset_launch_counts()
    tr.run_steps(x.cuda(), y.cuda(), 5)
    torch.cuda.synchronize()
    # per step: 2 forward + 3 backward products, 1 log_softmax
    assert ops.launch_counts() == {**dict.fromkeys(ops.KERNELS, 0),
                                   "matmul_f32": 25, "rowwise_softmax": 5}


# ------------------------------------------- the data-parallel plane (PR 10)

def _card_mesh():
    from lua_mapreduce_tpu_torch.parallel import make_mesh
    return make_mesh(device="cuda")


def test_world_size_one_nccl_mesh(cuda):
    """A CUDA mesh with no world running starts a one-rank NCCL world
    (never gloo) and sits on the current card."""
    import torch.distributed as dist
    mesh = _card_mesh()
    assert "nccl" in dist.get_backend()
    assert dict(mesh.shape) == {"dp": 1, "mp": 1}
    assert mesh.device.type == "cuda"
    assert _card_mesh() is mesh


def test_captured_all_reduce_equals_eager(cuda, monkeypatch):
    """A step with an NCCL all-reduce inside, captured once and replayed
    (graphs.scan), equals the same loop run eagerly, bit for bit."""
    from lua_mapreduce_tpu_torch import graphs
    from lua_mapreduce_tpu_torch.parallel import collectives as C
    mesh = _card_mesh()
    s0 = _randn(cuda, 1000)

    def step(s):
        t = C.psum(s * 0.5, mesh, "dp") + C.pmean(s.square(), mesh, "dp")
        return t.tanh(), C.psum(t.sum(), mesh, "dp")

    graphs.reset_captures()
    graphs.clear_cache()
    got = graphs.scan(step, s0, 6)
    assert graphs.captures()[0] == 1
    graphs.clear_cache()        # the eager loop must not replay the graph
    monkeypatch.setattr(graphs, "CapturedGraph", _EagerGraph)
    want = graphs.scan(step, s0, 6)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kmeans_and_als_on_the_card_match_the_cpu(cuda, monkeypatch):
    """kmeans_fit and als_fit over the card's mesh, captured, against the
    same fits on the CPU (1e-4; inertia rtol 1e-3) and against their
    eager loops on the card (bit for bit)."""
    from lua_mapreduce_tpu_torch import graphs
    from lua_mapreduce_tpu_torch.models import als, kmeans
    from lua_mapreduce_tpu_torch.train.data import make_blobs, make_ratings
    mesh = _card_mesh()
    x, _, _ = make_blobs(seed=1, n=8192, k=16, dim=32)
    r, w = make_ratings(seed=2, n_users=300, n_items=120, rank=8,
                        density=0.3)
    v0 = als.init_item_factors(0, 120, 8)
    km = kmeans.kmeans_fit(x, x[:16], n_iters=6, mesh=mesh)
    al = als.als_fit(r, w, v0, n_iters=4, mesh=mesh)
    km_cpu = kmeans.kmeans_fit(x, x[:16], n_iters=6, device="cpu")
    al_cpu = als.als_fit(r, w, v0, n_iters=4, device="cpu")
    torch.testing.assert_close(km.centroids.cpu(), km_cpu.centroids, **F32)
    torch.testing.assert_close(km.history.cpu(), km_cpu.history,
                               rtol=1e-3, atol=0)
    for a, b in zip(al, al_cpu):
        torch.testing.assert_close(a.cpu(), b, **F32)
    graphs.clear_cache()        # the eager loops must not replay a graph
    monkeypatch.setattr(graphs, "CapturedGraph", _EagerGraph)
    km_e = kmeans.kmeans_fit(x, x[:16], n_iters=6, mesh=mesh)
    al_e = als.als_fit(r, w, v0, n_iters=4, mesh=mesh)
    assert all(torch.equal(a, b) for a, b in zip(km, km_e))
    assert all(torch.equal(a, b) for a, b in zip(al, al_e))
    graphs.clear_cache()


@pytest.mark.parametrize("model", ["digits", "lenet"])
@pytest.mark.parametrize("zero1", [False, True], ids=["replicated", "zero1"])
def test_mesh_trainer_equals_the_no_mesh_trainer(cuda, model, zero1):
    """At world size 1 the mesh trainer's captured steps (an NCCL sum
    over one rank, or ZeRO-1's reduce-scatter and all-gather, inside the
    graph) give the no-mesh trainer's losses, parameters and momentum
    buffers bit for bit."""
    from lua_mapreduce_tpu_torch.train.harness import (DataParallelTrainer,
                                                       TrainConfig)
    loss_fn, params, x, y = _train_pair(model)
    c = TrainConfig(batch_size=len(x))
    x, y = x.cuda(), y.cuda()
    ref = DataParallelTrainer(loss_fn, params, c, device="cuda")
    tr = DataParallelTrainer(loss_fn, params, TrainConfig(
        batch_size=len(x), zero1=zero1), mesh=_card_mesh())
    want = ref.run_steps(x, y, 5)
    got = tr.run_steps(x, y, 5)
    assert tr.traces == 1
    assert torch.equal(got, want)
    for k in params:
        assert torch.equal(tr.params[k], ref.params[k]), k
    mine, theirs = tr.momentum_buffers(), ref.momentum_buffers()
    assert all(torch.equal(mine[k], theirs[k]) for k in params)


def test_tpu_executor_on_the_card_matches_the_cpu(cuda):
    """run_keyed on a digits gradient, run_bucketed on a 16-partition
    histogram and run_loop, on the card's mesh, against the CPU."""
    from lua_mapreduce_tpu_torch.models import mlp
    from lua_mapreduce_tpu_torch.parallel import ArrayTaskSpec, TpuExecutor
    mesh = _card_mesh()
    params = mlp.init_mlp(0, device="cpu")
    loss_fn, _, x, y = _train_pair("digits")

    def grads(device):
        p = {k: v.to(device).requires_grad_(True) for k, v in params.items()}

        def mapfn(shard):
            xs, ys = shard
            g = torch.autograd.grad(loss_fn(p, xs, ys), list(p.values()))
            return dict(zip(p, g))
        return mapfn

    got = TpuExecutor(ArrayTaskSpec(mapfn=grads("cuda"), reduce_op="mean"),
                      mesh).run_keyed((x, y))
    want = grads("cpu")((x, y))
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], **F32)
    ids = torch.randint(0, 64, (4096,),
                        generator=torch.Generator().manual_seed(3))
    spec = ArrayTaskSpec(
        mapfn=lambda s: torch.zeros(64, dtype=torch.int32,
                                    device=s.device).index_add_(
            0, s, torch.ones_like(s, dtype=torch.int32)),
        partitionfn=lambda c: c.reshape(16, 4), num_partitions=16)
    hist = TpuExecutor(spec, mesh).run_bucketed(ids)
    assert torch.equal(hist.cpu().reshape(-1),
                       torch.bincount(ids, minlength=64).int())
    final, trace = TpuExecutor(spec, mesh).run_loop(
        torch.zeros(()), lambda s: (s + 1.0, s * 2.0), n_steps=5)
    assert float(final) == 5.0
    assert trace.cpu().tolist() == [0.0, 2.0, 4.0, 6.0, 8.0]


# ------------------------------- the compiled MapReduce tiers (engine/)

def test_scan_cache_two_fits_capture_once(cuda, monkeypatch):
    """Two kmeans_fit calls (and two als_fit calls) at the same shapes
    capture one graph between them; the second call replays it from its
    own start state and equals the first, and both equal the eager loop,
    bit for bit."""
    from lua_mapreduce_tpu_torch import graphs
    from lua_mapreduce_tpu_torch.models import als, kmeans
    from lua_mapreduce_tpu_torch.train.data import make_blobs, make_ratings
    x, _, _ = make_blobs(seed=1, n=8192, k=16, dim=32)
    xd = torch.from_numpy(x).cuda()
    r, w = make_ratings(seed=2, n_users=300, n_items=120, rank=8,
                        density=0.3)
    v0 = als.init_item_factors(0, 120, 8)
    graphs.clear_cache()
    graphs.reset_captures()
    first = kmeans.kmeans_fit(xd, x[:16], n_iters=6)
    second = kmeans.kmeans_fit(xd, x[:16], n_iters=6)
    longer = kmeans.kmeans_fit(xd, x[16:32], n_iters=9)
    assert graphs.captures()[0] == 1
    a1 = als.als_fit(r, w, v0, n_iters=4, device="cuda")
    a2 = als.als_fit(r, w, v0, n_iters=4, device="cuda")
    assert graphs.captures()[0] == 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(a1, a2))
    # another rate is another graph (a captured round bakes it in)
    als.als_fit(r, w, v0, n_iters=4, reg=0.2, device="cuda")
    assert graphs.captures()[0] == 3
    graphs.clear_cache()
    monkeypatch.setattr(graphs, "CapturedGraph", _EagerGraph)
    eager = kmeans.kmeans_fit(xd, x[:16], n_iters=6)
    eager_longer = kmeans.kmeans_fit(xd, x[16:32], n_iters=9)
    a_e = als.als_fit(r, w, v0, n_iters=4, device="cuda")
    graphs.clear_cache()
    assert all(torch.equal(a, b) for a, b in zip(first, eager))
    assert all(torch.equal(a, b) for a, b in zip(longer, eager_longer))
    assert all(torch.equal(a, b) for a, b in zip(a1, a2))
    assert all(torch.equal(a, b) for a, b in zip(a1, a_e))


_IG_CARD = """
import torch
from lua_mapreduce_tpu_torch import ops

SEEN = []

def taskfn(emit):
    for j in range(4):
        emit(j, {"v": [float(j + i) / 16 for i in range(16)]})

def mapfn(key, value, emit):
    v = value["v"]
    m = ops.matmul(v[:, None], v[None, :])
    emit(0, {"s": torch.sum(m, dim=0)})
    emit(1, {"s": ops.log_softmax(m)[0]})

def partitionfn(key):
    return int(key) % 2

def reducefn(key, values):
    acc = values[0]["s"]
    for i in range(1, len(values)):
        acc = acc + values[i]["s"]
    return {"s": acc}

reducefn.associative_reducer = True
reducefn.commutative_reducer = True

def finalfn(pairs):
    SEEN.append(list(pairs))
    return "loop" if len(SEEN) < 3 else False
"""

_HY_CARD = """
import torch

def taskfn(emit):
    for j in range(6):
        emit(j, {"v": [(j * 7 + i) % 23 for i in range(8)]})

def mapfn(key, value, emit):
    v = torch.as_tensor(value["v"], dtype=torch.int32)
    emit(0, torch.sum(v))
    emit(1, v[0] * 2)

def partitionfn(key):
    return int(key) % 2

def reducefn(key, values):
    acc = values[0]
    for i in range(1, len(values)):
        acc = acc + values[i]
    return acc

reducefn.associative_reducer = True
reducefn.commutative_reducer = True
"""


def _task_module(tmp_path, monkeypatch, name, src):
    import sys
    (tmp_path / f"{name}.py").write_text(src)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, name, raising=False)
    return name


def test_ingraph_replays_equal_the_eager_build_run(cuda, tmp_path,
                                                   monkeypatch):
    """The in-graph program on the card: iteration 1 is the build run
    (eager, on a side stream), iterations 2 and 3 replay its capture on
    the same job values — their published results equal iteration 1's
    bit for bit; one build; the matmul and log_softmax kernels' launches
    credited at every replay."""
    import importlib

    from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
    mod = _task_module(tmp_path, monkeypatch, "ig_card_task", _IG_CARD)
    spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod, reducefn=mod,
                    finalfn=mod, storage="mem:ig-card")
    ex = LocalExecutor(spec, engine="ingraph", device="cuda")
    ops.reset_launch_counts()
    ex.run()
    torch.cuda.synchronize()
    seen = importlib.import_module(mod).SEEN
    assert len(seen) == 3 and seen[0] and seen[1] == seen[0] == seen[2]
    engine = ex._ingraph.engine
    assert engine.traces == 1 and engine.mode == "shard_map"
    assert set(engine._plan.folds.values()) == {"psum"}
    counts = ops.launch_counts()
    assert counts["matmul_f32"] == 3 * 4 and counts["rowwise_softmax"] == 12
    # the same task on the CPU gives the same results within 1e-4
    cpu = LocalExecutor(TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod,
                                 reducefn=mod, finalfn=mod,
                                 storage="mem:ig-card-cpu"),
                        engine="ingraph", device="cpu")
    cpu.run()
    want = seen[-1]
    for (k, [g]), (k2, [w]) in zip(seen[0], want):
        assert k == k2
        torch.testing.assert_close(torch.tensor(g["s"]),
                                   torch.tensor(w["s"]), **F32)


def test_forced_hybrid_int_task_byte_identical_on_the_card(cuda, tmp_path,
                                                           monkeypatch):
    """engine="hybrid" on the card: the map leg one captured program,
    the reduce fold device sums — both legs ran, no fallback, and the
    result bytes equal the store plane's."""
    import re

    from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
    mod = _task_module(tmp_path, monkeypatch, "hy_card_task", _HY_CARD)
    out = {}
    for engine in ("store", "hybrid"):
        spec = TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod,
                        reducefn=mod, storage=f"mem:hy-card-{engine}")
        ex = LocalExecutor(spec, engine=engine, device="cuda")
        ex.run()
        pat = re.compile(r"^result\.P(\d+)$")
        out[engine] = ({n: "".join(ex.result_store.lines(n))
                        for n in ex.result_store.list("result.P*")
                        if pat.match(n)}, ex)
    (got, ex), (want, _) = out["hybrid"], out["store"]
    assert got and got == want
    it = ex.stats.iterations[-1]
    assert it.hybrid_map_legs == 1 and it.hybrid_reduce_legs >= 1
    assert it.hybrid_fallbacks == 0
    assert ex._hybrid.map_engine.traces == 1


# ---------------------------------------------------------------------------
# the distributed Server / Worker on the card (PR 12)
# ---------------------------------------------------------------------------

_DIGITS = "lua_mapreduce_tpu_torch.examples.digits.mr_train"


def _digits_spec(root, n_iter):
    from lua_mapreduce_tpu_torch.engine import TaskSpec
    return TaskSpec(taskfn=_DIGITS, mapfn=_DIGITS, partitionfn=_DIGITS,
                    reducefn=_DIGITS, finalfn=_DIGITS,
                    init_args={"sizes": [256, 128, 10], "n_shards": 4,
                               "bunch": 128, "max_steps": n_iter,
                               "patience": 10_000, "seed": 0,
                               "model_store": f"shared:{root}/model"},
                    storage=f"shared:{root}/spill")


def _task_files(root):
    out = {}
    for sub in ("spill", "model"):
        d = root / sub
        for p in sorted(d.iterdir()):
            if not p.name.startswith(".tmp."):
                out[f"{sub}/{p.name}"] = p.read_bytes()
    return out


def _pool(store, spec, n_workers, **server_kw):
    import threading

    from lua_mapreduce_tpu_torch.engine import Server, Worker
    server = Server(store, poll_interval=0.02, **server_kw).configure(spec)
    workers = [Worker(store).configure(max_iter=400, max_sleep=0.05)
               for _ in range(n_workers)]
    threads = [threading.Thread(target=w.execute, daemon=True)
               for w in workers]
    for t in threads:
        t.start()
    stats = server.loop()
    for t in threads:
        t.join(timeout=60)
    return server, workers, stats


def test_digits_pool_on_the_card_equals_local_executor(cuda, tmp_path):
    """The digits trainer at the flagship width through a Server and two
    Worker threads on the card: its result files and final checkpoint
    equal the LocalExecutor's on the card byte for byte (B1 reduces
    split-K in split order and B2 is deterministic, so the bytes do not
    depend on which worker ran which job); the launches are the code's."""
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
    from lua_mapreduce_tpu_torch.engine import LocalExecutor
    n = 3
    LocalExecutor(_digits_spec(tmp_path / "local", n),
                  max_iterations=n + 1).run()
    ops.reset_launch_counts()
    _, workers, stats = _pool(MemJobStore(), _digits_spec(tmp_path / "pool",
                                                          n), 2)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert len(stats.iterations) == n
    want = _task_files(tmp_path / "local")
    assert any(k.startswith("spill/result.P") for k in want)
    assert _task_files(tmp_path / "pool") == want
    assert counts["matmul_f32"] == n * (4 * 5 + 2)
    assert counts["rowwise_softmax"] == n * (4 + 1)
    assert all(w.device == torch.device("cuda") for w in workers)


_HY_POOL = """
import torch

SEEN = []

def taskfn(emit):
    for j in range(8):
        emit(j, {"v": [(j * 7 + i + len(SEEN)) % 23 for i in range(8)]})

def mapfn(key, value, emit):
    v = torch.as_tensor(value["v"], dtype=torch.int32)
    emit(0, torch.sum(v))
    emit(1, v[0] * 2)

def partitionfn(key):
    return int(key) % 2

def reducefn(key, values):
    acc = values[0]
    for i in range(1, len(values)):
        acc = acc + values[i]
    return acc

reducefn.associative_reducer = True
reducefn.commutative_reducer = True

def finalfn(pairs):
    SEEN.append([(k, v) for k, v in pairs])
    return "loop" if len(SEEN) % 3 else False
"""


def test_two_inline_workers_run_hybrid_legs(cuda, tmp_path, monkeypatch):
    """Two Worker threads of one process, each with its own compiled map
    leg, build (eager run with host syncs made errors, then a capture)
    and replay at the same time: the captures run in "thread_local" mode
    and the compiled work takes one process-wide lock
    (``engine.ingraph.COMPILE_LOCK``), so neither thread breaks the
    other's capture. Three loop iterations; every iteration's results
    equal the store plane's; legs ran on both phases, no fallback."""
    import importlib

    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
    from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
    mod = _task_module(tmp_path, monkeypatch, "hy_pool_task", _HY_POOL)
    seen = importlib.import_module(mod).SEEN

    def spec(tag):
        return TaskSpec(taskfn=mod, mapfn=mod, partitionfn=mod,
                        reducefn=mod, finalfn=mod, storage=f"mem:{tag}")

    LocalExecutor(spec("hy-pool-store"), engine="store",
                  device="cuda").run()
    want = list(seen)
    seen.clear()
    _, workers, stats = _pool(MemJobStore(), spec("hy-pool"), 2,
                              engine="hybrid")
    assert seen == want and len(seen) == 3
    legs = sum(it.hybrid_map_legs for it in stats.iterations)
    folds = sum(it.hybrid_reduce_legs for it in stats.iterations)
    assert legs >= 3 and folds >= 1
    assert sum(it.hybrid_fallbacks for it in stats.iterations) == 0
    assert sum(w.jobs_executed for w in workers) == 3 * (8 + 2)


# ------------------------------------------------- MoE and the (dp, sp) step

def _moe_lm_cfg(**kw):
    from lua_mapreduce_tpu_torch.models import transformer as tt
    base = dict(vocab=256, d_model=128, n_heads=2, n_layers=2, d_ff=256,
                max_seq=64, moe_experts=4, moe_capacity=128)
    base.update(kw)
    return tt.TransformerConfig(**base)


def _lm_mesh():
    from lua_mapreduce_tpu_torch.parallel import make_mesh
    return make_mesh(dp=1, mp=1, device="cuda", axis_names=("dp", "sp"))


def test_moe_train_step_on_the_card_matches_the_cpu(cuda):
    """Three free-running f32 MoE train steps (4 experts, top-1 and
    top-2, SGD with momentum) on the card against the CPU: losses within
    1e-4 relative, parameters normwise within 1e-4; the attention runs
    flash_fwd, dq and dkv once per layer a step, the expert products
    stay torch."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.train import optim
    seq = torch.randint(0, 256, (4, 65),
                        generator=torch.Generator().manual_seed(1))
    for top_k in (1, 2):
        cfg = _moe_lm_cfg(moe_top_k=top_k)
        p0 = tt.init_transformer(0, cfg, device="cpu")
        runs = {}
        for dev in ("cpu", "cuda"):
            p = {n: x.detach().clone().to(dev).requires_grad_(True)
                 for n, x in p0.items()}
            step = tt.make_train_step(cfg, optim.sgd(p.values(), 0.1, 0.9))
            ops.reset_launch_counts()
            losses = [float(step(p, seq[:, :-1], seq[:, 1:]))
                      for _ in range(3)]
            runs[dev] = (losses, p, ops.launch_counts())
        (lc, pc, _), (lg, pg, counts) = runs["cpu"], runs["cuda"]
        assert counts == {**dict.fromkeys(ops.KERNELS, 0),
                          "flash_fwd": 3 * 2, "flash_bwd_dq": 3 * 2,
                          "flash_bwd_dkv": 3 * 2}
        for a, b in zip(lg, lc):
            assert abs(a - b) <= 1e-4 * abs(b)
        num = sum(float((pg[n].detach().cpu() - pc[n].detach()).norm()) ** 2
                  for n in pc)
        den = sum(float(pc[n].detach().norm()) ** 2 for n in pc)
        assert (num / den) ** 0.5 <= 1e-4


@pytest.mark.parametrize("use_prefill", [True, False])
@pytest.mark.parametrize("quantized", [False, True])
def test_captured_moe_decode_equals_eager(cuda, monkeypatch, use_prefill,
                                          quantized):
    """An MoE greedy decode (bf16; int8 weights and KV) replays its
    captured step — the routing reads nothing back to the host — and
    gives the eager loop's tokens and launch counts; f32 tokens equal
    the CPU's when no bucket overflows."""
    from lua_mapreduce_tpu_torch import graphs
    from lua_mapreduce_tpu_torch.models import transformer as tt
    cfg = _moe_lm_cfg(n_layers=2, max_seq=96, moe_capacity=160)
    p = tt.init_transformer(0, cfg, dtype=torch.bfloat16, device="cuda")
    if quantized:
        p = tt.quantize_lm(p)
    prompt = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    kw = dict(cfg=cfg, use_prefill=use_prefill, kv_q8=quantized)
    ops.reset_launch_counts()
    graphs.reset_captures()
    got = tt.greedy_decode(p, prompt.cuda(), 20, **kw).cpu()
    counts = ops.launch_counts()
    assert graphs.captures()[0] == 1
    with monkeypatch.context() as m:
        m.setattr(tt, "CapturedGraph", _EagerGraph)
        ops.reset_launch_counts()
        want = tt.greedy_decode(p, prompt.cuda(), 20, **kw).cpu()
        assert ops.launch_counts() == counts
    assert torch.equal(got, want)
    if not quantized:
        p32 = tt.init_transformer(0, cfg, device="cpu")
        card = tt.greedy_decode({k: v.cuda() for k, v in p32.items()},
                                prompt.cuda(), 20, cfg=cfg,
                                use_prefill=use_prefill).cpu()
        assert torch.equal(card, tt.greedy_decode(
            p32, prompt, 20, cfg=cfg, use_prefill=use_prefill))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_nccl_mesh_lm_step_equals_the_no_mesh_step(cuda, moe):
    """make_train_step over the world-size-1 NCCL (dp, sp) mesh: two
    ring steps equal the no-mesh steps bit for bit (losses, parameters);
    zigzag and Ulysses within 2e-4; ZeRO-1 (dense) within 1e-4."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.parallel import zero1 as z1
    from lua_mapreduce_tpu_torch.train import optim
    mesh = _lm_mesh()
    cfg = _moe_lm_cfg(**({} if moe else dict(moe_experts=0,
                                             moe_capacity=0)))
    p0 = tt.init_transformer(0, cfg, device="cpu")
    seq = torch.randint(0, 256, (4, 65),
                        generator=torch.Generator().manual_seed(2))
    tok, tgt = tt.shard_batch(mesh, seq[:, :-1], seq[:, 1:])
    runs = {}
    variants = [("none", None, "ring", False), ("ring", mesh, "ring", False),
                ("zigzag", mesh, "zigzag", False),
                ("ulysses", mesh, "ulysses", False)]
    if not moe:
        variants.append(("zero1", mesh, "ring", True))
    for name, m, attn, z in variants:
        p = {n: x.detach().clone().cuda().requires_grad_(True)
             for n, x in p0.items()}

        def mk(leaves):
            return optim.sgd(leaves, 0.1, momentum=0.9)
        opt = z1.init_state(mk, p, mesh) if z else mk(p.values())
        step = tt.make_train_step(cfg, opt, mesh=m, attn=attn, zero1=z)
        runs[name] = ([float(step(p, tok, tgt)) for _ in range(2)], p)
    base_l, base_p = runs["none"]
    assert runs["ring"][0] == base_l
    assert all(torch.equal(runs["ring"][1][n], base_p[n]) for n in base_p)
    for name in runs:
        if name in ("none", "ring"):
            continue
        tol = 1e-4 if name == "zero1" else 2e-4
        for a, b in zip(runs[name][0], base_l):
            assert abs(a - b) <= tol * abs(b), name
        num = sum(float((runs[name][1][n] - base_p[n]).norm()) ** 2
                  for n in base_p)
        den = sum(float(base_p[n].norm()) ** 2 for n in base_p)
        assert (num / den) ** 0.5 <= tol, name


def _tp_pp_meshes():
    """The (1, 1, 1) (dp, sp, mp) and (1,) (pp,) meshes of the
    world-size-1 NCCL world, from ``make_multihost_mesh``."""
    from lua_mapreduce_tpu_torch.parallel.multihost import make_multihost_mesh
    _lm_mesh()                       # the world-size-1 NCCL world
    return (make_multihost_mesh((1, 1, 1), ("dp", "sp", "mp"),
                                device="cuda"),
            make_multihost_mesh((1,), ("pp",), device="cuda"))


@pytest.mark.parametrize("form", ["3d", "pp"])
def test_tp_pp_steps_on_the_card_match_the_cpu(cuda, form):
    """Three free-running f32 steps of make_train_step_3d over the
    (1, 1, 1) NCCL mesh, or of make_train_step_pp over (pp,) = (1,) in
    2 microbatches, at 2 layers (head dim 64), on the card against the
    no-mesh step on the CPU (the same function): losses within 1e-4
    relative, parameters normwise within 1e-4; the attention launches
    flash_fwd, dq and dkv once per layer a step (a tick a layer for the
    pipeline)."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.train import optim
    m3, mpp = _tp_pp_meshes()
    cfg = tt.TransformerConfig(vocab=256, d_model=128, n_heads=2,
                               n_layers=2, d_ff=256, max_seq=64)
    p0 = tt.init_transformer(0, cfg, device="cpu")
    seq = torch.randint(0, 256, (4, 65),
                        generator=torch.Generator().manual_seed(3))
    tok, tgt = seq[:, :-1], seq[:, 1:]
    pc = {n: x.detach().clone().requires_grad_(True) for n, x in p0.items()}
    step = tt.make_train_step(cfg, optim.sgd(pc.values(), 0.1, 0.9))
    lc = [float(step(pc, tok, tgt)) for _ in range(3)]
    src = {n: x.detach().clone().cuda() for n, x in p0.items()}
    if form == "3d":
        pg = {n: x.requires_grad_(True)
              for n, x in tt.shard_params_3d(src, m3, cfg).items()}
        step = tt.make_train_step_3d(cfg, m3, optim.sgd(pg.values(), 0.1,
                                                        0.9))
        td, per = tt.shard_batch(m3, tok, tgt), 2
    else:
        pg = {n: x.requires_grad_(True)
              for n, x in tt.shard_params_pp(src, mpp, cfg).items()}
        step = tt.make_train_step_pp(cfg, mpp, optim.sgd(pg.values(), 0.1,
                                                         0.9), n_micro=2)
        td, per = (tok, tgt), 2 * 2
    ops.reset_launch_counts()
    lg = [float(step(pg, *td)) for _ in range(3)]
    assert ops.launch_counts() == {
        **dict.fromkeys(ops.KERNELS, 0), "flash_fwd": 3 * per,
        "flash_bwd_dq": 3 * per, "flash_bwd_dkv": 3 * per}
    for a, b in zip(lg, lc):
        assert abs(a - b) <= 1e-4 * abs(b)
    got = (tt.unshard_params_3d(pg, cfg, m3) if form == "3d"
           else tt.unstack_params_pp(pg, cfg, mpp))
    num = sum(float((got[n].detach().cpu() - pc[n].detach()).norm()) ** 2
              for n in pc)
    den = sum(float(pc[n].detach().norm()) ** 2 for n in pc)
    assert (num / den) ** 0.5 <= 1e-4


def test_3d_step_at_mp_1_equals_the_2d_mesh_step(cuda):
    """make_train_step_3d over the (1, 1, 1) NCCL mesh against
    make_train_step over the (1, 1) (dp, sp) mesh, f32, two ring steps:
    losses within 1e-5 relative, parameters within 2e-4 (the JAX tests'
    3-D against 2-D limits)."""
    from lua_mapreduce_tpu_torch.models import transformer as tt
    from lua_mapreduce_tpu_torch.train import optim
    m3, _ = _tp_pp_meshes()
    m2 = _lm_mesh()
    cfg = tt.TransformerConfig(vocab=256, d_model=128, n_heads=2,
                               n_layers=2, d_ff=256, max_seq=64)
    p0 = tt.init_transformer(1, cfg, device="cuda")
    seq = torch.randint(0, 256, (4, 65),
                        generator=torch.Generator().manual_seed(4))
    runs = {}
    for form, m in (("3d", m3), ("2d", m2)):
        src = {n: x.detach().clone() for n, x in p0.items()}
        if form == "3d":
            src = tt.shard_params_3d(src, m, cfg)
        p = {n: x.requires_grad_(True) for n, x in src.items()}
        opt = optim.sgd(p.values(), 0.1, 0.9)
        step = (tt.make_train_step_3d(cfg, m, opt) if form == "3d"
                else tt.make_train_step(cfg, opt, mesh=m))
        td = tt.shard_batch(m, seq[:, :-1], seq[:, 1:])
        losses = [float(step(p, *td)) for _ in range(2)]
        runs[form] = (losses, tt.unshard_params_3d(p, cfg, m)
                      if form == "3d" else p)
    for a, b in zip(runs["3d"][0], runs["2d"][0]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for n, want in runs["2d"][1].items():
        torch.testing.assert_close(runs["3d"][1][n].detach(), want.detach(),
                                   rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the data plane: object store, v2 segments, faults, trace, pipelined shuffle
# ---------------------------------------------------------------------------

def _task_results(store_spec, model_root):
    import re

    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    st = get_storage_from(store_spec)
    out = {n: st.read_range(n, 0, st.size(n)) for n in st.list("result.P*")
           if re.match(r"^result\.P\d+$", n)}
    for name in ("model.ckpt", "model.meta"):
        out[name] = (model_root / name).read_bytes()
    return out


def test_data_plane_digits_pool_equals_local_executor(cuda, tmp_path,
                                                      monkeypatch):
    """The digits trainer through a pipelined v2 Server and two worker
    threads on ``object:`` spill under a seeded fault plan, traced: the
    result files and the checkpoint equal the barrier v1 LocalExecutor's
    on the card byte for byte, the launches are the code's, the plan
    fired, retries absorbed it, and every committed job of the last
    iteration has a complete span chain."""
    from lua_mapreduce_tpu_torch.coord.jobstore import MemJobStore
    from lua_mapreduce_tpu_torch.core.constants import (MAP_NS, PRE_NS,
                                                        RED_NS, Status)
    from lua_mapreduce_tpu_torch.engine import LocalExecutor, TaskSpec
    from lua_mapreduce_tpu_torch.faults import FaultPlan, install_fault_plan
    from lua_mapreduce_tpu_torch.faults.retry import COUNTERS
    from lua_mapreduce_tpu_torch.store.router import get_storage_from
    from lua_mapreduce_tpu_torch.trace import (TraceCollection, Tracer,
                                               install_tracer)
    n = 3
    LocalExecutor(_digits_spec(tmp_path / "local", n),
                  max_iterations=n + 1).run()
    want = _task_results(f"shared:{tmp_path}/local/spill",
                         tmp_path / "local" / "model")
    spec = TaskSpec(taskfn=_DIGITS, mapfn=_DIGITS, partitionfn=_DIGITS,
                    reducefn=_DIGITS, finalfn=_DIGITS,
                    init_args={"sizes": [256, 128, 10], "n_shards": 4,
                               "bunch": 128, "max_steps": n,
                               "patience": 10_000, "seed": 0,
                               "model_store": f"shared:{tmp_path}/dp/model"},
                    storage=f"object:{tmp_path}/dp/spill")
    plan = FaultPlan(24, transient=0.04, torn=0.08, error_after_write=0.12,
                     rpc_transient=0.03, max_per_key=2)
    c0 = COUNTERS.snapshot()
    install_fault_plan(plan)
    install_tracer(Tracer())
    try:
        ops.reset_launch_counts()
        store = MemJobStore()
        _, workers, stats = _pool(store, spec, 2, pipeline=True,
                                  premerge_min_runs=2, segment_format="v2")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        install_tracer(None)
        install_fault_plan(None)
    delta = COUNTERS.delta(c0, COUNTERS.snapshot())
    assert len(stats.iterations) == n
    assert _task_results(f"object:{tmp_path}/dp/spill",
                         tmp_path / "dp" / "model") == want
    assert counts["matmul_f32"] == n * (4 * 5 + 2)
    assert counts["rowwise_softmax"] == n * (4 + 1)
    assert delta["faults_injected"] == plan.total_fired() > 0
    assert delta.get("retries", 0) > 0
    committed = [(ns, d["_id"]) for ns in (MAP_NS, PRE_NS, RED_NS)
                 for d in store.jobs(ns) if d["status"] == Status.WRITTEN]
    col = TraceCollection.from_store(
        get_storage_from(f"object:{tmp_path}/dp/spill"))
    assert committed and col.check_complete(committed) == []
    assert all(w.device == torch.device("cuda") for w in workers)


def test_data_plane_profile_holds_span_names_beside_kernels(cuda, tmp_path):
    """``--trace --profile`` in one process: a LocalExecutor digits
    iteration under an annotating tracer inside ``device_trace`` leaves
    the job-body span names as rows of the torch profile beside the
    B1/B2 kernel rows."""
    import glob
    import json

    from lua_mapreduce_tpu_torch.engine import LocalExecutor
    from lua_mapreduce_tpu_torch.trace import Tracer, install_tracer
    from lua_mapreduce_tpu_torch.utils.profiling import device_trace
    prof = tmp_path / "prof"
    install_tracer(Tracer(annotate=True))
    try:
        with device_trace(str(prof)):
            LocalExecutor(_digits_spec(tmp_path / "run", 1), max_iterations=2,
                          pipeline=True, premerge_min_runs=2,
                          segment_format="v2").run()
    finally:
        install_tracer(None)
    (path,) = glob.glob(str(prof / "*.pt.trace.json"))
    events = json.load(open(path))["traceEvents"]
    user = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert {"map.body", "reduce.body"} <= user
    assert any("matmul_f32_kernel" in k for k in kernels)
    assert any("softmax_" in k for k in kernels)
