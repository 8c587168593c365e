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
from lua_mapreduce_tpu_torch.ops.matmul import matmul_cuda, matmul_plain
from lua_mapreduce_tpu_torch.ops.softmax import (log_softmax_plain,
                                                 rowwise_softmax_cuda,
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
    """csrc/matmul.cu decides the K split; the wrapper only sizes the
    scratch."""
    from lua_mapreduce_tpu_torch.ops import _build
    lib = _build.library("matmul")
    assert lib.lmr_matmul_tma_available() == 1

    def splits(m, k, n, dtype, ta=False):
        # contiguous B (k, n); A (m, k) contiguous or, with ta, the .t()
        # view of a contiguous (k, m) (patchesᵀ); 16-byte aligned
        sa = (1, m) if ta else (k, 1)
        return lib.lmr_matmul_splits(256, 256, m, n, k, *sa, n, 1, dtype)
    for dtype in (0, 1):                            # f32, bf16
        assert splits(75, 802816, 6, dtype, ta=True) > 1
        assert splits(576, 100352, 64, dtype, ta=True) > 1
        assert splits(4096, 4096, 4096, dtype) == 1
        assert splits(8, 8, 8, dtype) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(75, 802816, 6), (576, 100352, 64),
                                   (200, 256, 128)])
def test_matmul_split_is_bitwise_repeatable(cuda, dtype, m, k, n):
    a = _randn(cuda, k, m, dtype=dtype, scale=k ** -0.25).t()
    b = _randn(cuda, k, n, dtype=dtype, scale=k ** -0.25)
    first = matmul_cuda(a, b, dtype)
    for _ in range(2):
        assert torch.equal(matmul_cuda(a, b, dtype), first)


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
    flash_attention_plain)
from lua_mapreduce_tpu_torch.ops.decode import (  # noqa: E402
    decode_attention_cuda, decode_attention_plain)
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
    """dq from the dq kernel and (dk, dv) from the dkv kernel against
    the plain backward on the same inputs, with an lse cotangent: f32
    at 1e-4, bf16 at 2e-2 and normwise within 1e-2."""
    causal, window, q_offset, h, hkv, l = case
    q = _randn(cuda, 2, l, h, d, dtype=dtype, scale=0.5)
    k = _randn(cuda, 2, l, hkv, d, dtype=dtype, scale=0.5)
    v = _randn(cuda, 2, l, hkv, d, dtype=dtype, scale=0.5)
    do = _randn(cuda, 2, l, h, d)
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


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (4, 1024, 3072),
                                   (4, 4096, 1024), (3, 1100, 200),
                                   (8, 300, 501), (9, 128, 200),
                                   (33, 1024, 1024), (256, 512, 384),
                                   # M > 8 at ragged N and K % 8 != 0
                                   (40, 1100, 200), (129, 1024, 272),
                                   (300, 1030, 520)])
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
    """csrc/q8.cu decides the K split; the wrapper only sizes scratch
    and refuses what the kernel refuses."""
    from lua_mapreduce_tpu_torch.ops import _build
    lib = _build.library("q8")
    assert lib.lmr_q8_splits(4, 4096, 1024) > 1       # narrow N: split K
    assert lib.lmr_q8_splits(4, 256, 128) == 1        # K too short to split
    assert lib.lmr_q8_splits(9, 4096, 1024) == 1      # tensor-core path
    assert lib.lmr_q8_splits(65535 * 128 + 1, 8, 8) == 0
    q, s = ops.quantize_q8(_randn(cuda, 1, 1))
    with pytest.raises(ValueError, match="grid limit"):
        q8_matmul_cuda(torch.zeros((65535 * 128 + 1, 1), device="cuda"), q,
                       s.reshape(-1))


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
from lua_mapreduce_tpu_torch.ops.pool import _pool_plain, pool_cuda  # noqa: E402


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
