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
                                   (257, 129, 131), (512, 1024, 384)])
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
    assert ops.launch_counts() == {"matmul_f32": 1, "matmul_bf16": 1,
                                   "rowwise_softmax": 2}


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
