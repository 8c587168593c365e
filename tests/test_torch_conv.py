"""Port conv/pool ops ≡ JAX ops: the same numpy inputs through the JAX
package's ops (XLA and Pallas interpret mode on the CPU) and the port's
ops (their plain versions on the CPU), with the JAX package's own
tolerances (tests/test_ops.py:79-141, 184-196). Also: the image data
generator is byte-identical to the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lua_mapreduce_tpu import ops as jops
from lua_mapreduce_tpu.train.data import make_images as jax_make_images
from lua_mapreduce_tpu_torch import ops
from lua_mapreduce_tpu_torch.convert import array_to_tensor, tensor_to_array
from lua_mapreduce_tpu_torch.ops.conv import _same_pads, conv2d_plain
from lua_mapreduce_tpu_torch.ops.pool import _pool_plain
from lua_mapreduce_tpu_torch.train.data import make_images

RTOL = ATOL = 1e-4      # tests/test_ops.py:16-17, 97, 123
JAX_BACKENDS = ("xla", "pallas_interpret")


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------------ conv

CONV_CFGS = [     # tests/test_ops.py:80-87
    dict(n=2, h=16, w=16, cin=3, cout=6, k=5, stride=1, padding="VALID"),
    dict(n=1, h=14, w=14, cin=6, cout=16, k=5, stride=1, padding="VALID"),
    dict(n=2, h=8, w=8, cin=4, cout=8, k=3, stride=2, padding="SAME"),
    dict(n=1, h=7, w=9, cin=2, cout=4, k=3, stride=1, padding=1),
    dict(n=1, h=8, w=8, cin=3, cout=4, k=2, stride=1, padding="SAME"),
    dict(n=1, h=9, w=9, cin=2, cout=4, k=4, stride=2, padding="SAME"),
]


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("cfg", CONV_CFGS)
def test_conv2d_matches_jax(cfg, backend):
    x = rand(cfg["n"], cfg["h"], cfg["w"], cfg["cin"], seed=7)
    w = rand(cfg["k"], cfg["k"], cfg["cin"], cfg["cout"], seed=8) * 0.1
    b = rand(cfg["cout"], seed=9)
    kw = dict(stride=cfg["stride"], padding=cfg["padding"])
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), backend=backend, **kw))
    got = ops.conv2d(_t(x), _t(w), _t(b), **kw)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(conv2d_plain(_t(x), _t(w), _t(b), **kw)
                               .numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_conv2d_same_even_kernel_keeps_shape_and_values(k):
    """TF-style SAME at stride 1 keeps 8x8 for even kernels too (the
    asymmetric pad of test_ops.py:101-109), with JAX's values."""
    x = rand(1, 8, 8, 3, seed=20)
    w = rand(k, k, 3, 4, seed=21) * 0.1
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(w),
                                  padding="SAME", backend="xla"))
    got = ops.conv2d(_t(x), _t(w), padding="SAME")
    assert tuple(got.shape) == (1, 8, 8, 4) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_conv2d_imagenet_stem_asymmetric_same():
    """The 7x7/2 stem at 224: SAME pads (2, 3), not a symmetric 3 (which
    gives the same 112x112 shape with shifted values)."""
    assert _same_pads(224, 7, 2) == (2, 3)
    assert [_same_pads(s, 3, 2) for s in (56, 28, 14)] == [(0, 1)] * 3
    x = rand(1, 224, 224, 3, seed=22)
    w = rand(7, 7, 3, 64, seed=23) * 0.1
    want = np.asarray(jops.conv2d(jnp.asarray(x), jnp.asarray(w), stride=2,
                                  padding="SAME", backend="xla"))
    got = ops.conv2d(_t(x), _t(w), stride=2, padding="SAME")
    assert tuple(got.shape) == (1, 112, 112, 64) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    symmetric = ops.conv2d(_t(x), _t(w), stride=2, padding=3)
    assert tuple(symmetric.shape) == want.shape
    assert float(np.abs(symmetric.numpy() - want).max()) > 0.1


@pytest.mark.parametrize("stride,padding", [(1, "VALID"), (2, "SAME")])
def test_conv2d_grad_matches_jax(stride, padding):
    """d/dw and d/dx through im2col + the matmul's custom backward
    against jax.grad (tests/test_ops.py:112-123)."""
    x = rand(2, 8, 8, 3, seed=10)
    w = rand(3, 3, 3, 4, seed=11) * 0.1
    b = rand(4, seed=12)

    def loss(x, w, b):
        return jnp.sum(jops.conv2d(x, w, b, stride=stride, padding=padding,
                                   backend="pallas_interpret") ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                             jnp.asarray(b))
    tx, tw, tb = (_t(a).requires_grad_(True) for a in (x, w, b))
    (ops.conv2d(tx, tw, tb, stride=stride, padding=padding) ** 2
     ).sum().backward()
    for got, ref in zip((tx.grad, tw.grad, tb.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


def test_conv2d_bf16_keeps_dtype():
    x = jnp.asarray(rand(2, 8, 8, 3, seed=13)).astype(jnp.bfloat16)
    w = jnp.asarray(rand(3, 3, 3, 8, seed=14) * 0.1).astype(jnp.bfloat16)
    want = jops.conv2d(x, w, padding="SAME", backend="pallas_interpret")
    got = ops.conv2d(array_to_tensor(np.asarray(x)),
                     array_to_tensor(np.asarray(w)), padding="SAME")
    assert got.dtype == torch.bfloat16
    # both accumulate in f32 and round once to bf16
    np.testing.assert_allclose(tensor_to_array(got),
                               np.asarray(want).astype(np.float32),
                               rtol=1e-2, atol=1e-2)


def test_conv2d_bad_padding_and_window():
    with pytest.raises(ValueError, match="padding"):
        ops.conv2d(torch.zeros(1, 4, 4, 1), torch.zeros(3, 3, 1, 1),
                   padding="FULL")
    with pytest.raises(ValueError, match="larger"):
        ops.conv2d(torch.zeros(1, 2, 2, 1), torch.zeros(3, 3, 1, 1))


# ------------------------------------------------------------------ pool

@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("window,stride", [(2, None), (2, 2), (3, 2)])
def test_maxpool_matches_jax(window, stride, backend):
    x = rand(2, 12, 12, 5, seed=12)
    want = np.asarray(jops.maxpool2d(jnp.asarray(x), window, stride,
                                     backend=backend))
    got = ops.maxpool2d(_t(x), window, stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)    # max is exact


@pytest.mark.parametrize("backend", JAX_BACKENDS)
@pytest.mark.parametrize("window,stride", [(2, None), (3, 2)])
def test_avgpool_matches_jax(window, stride, backend):
    x = rand(3, 8, 8, 4, seed=13)
    want = np.asarray(jops.avgpool2d(jnp.asarray(x), window, stride,
                                     backend=backend))
    got = ops.avgpool2d(_t(x), window, stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode,window,stride", [
    ("max", 2, None), ("max", 3, 2), ("avg", 2, None), ("avg", 3, 2)])
def test_pool_grad_matches_jax(mode, window, stride):
    """tests/test_ops.py:184-196: Pallas forward, XLA-composition VJP."""
    x = rand(2, 8, 8, 4, seed=32)
    jpool = jops.maxpool2d if mode == "max" else jops.avgpool2d
    tpool = ops.maxpool2d if mode == "max" else ops.avgpool2d

    def loss(x):
        return jnp.sum(jpool(x, window, stride,
                             backend="pallas_interpret") ** 2)

    want = jax.grad(loss)(jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    (tpool(tx, window, stride) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window,stride", [(2, None), (3, 2)])
def test_maxpool_tie_heavy_grad_equals_jax(window, stride):
    """Integer-valued input: most windows hold ties. lax.max and
    torch.maximum split a tie's gradient equally, chained in the same
    order, so the gradients are equal exactly (dyadic fractions of
    integers). F.max_pool2d's backward routes each window's whole
    gradient to one element and differs."""
    x = np.random.RandomState(40).randint(0, 3, (2, 9, 9, 3)).astype(
        np.float32)

    def loss(x):
        return jnp.sum(jops.maxpool2d(x, window, stride,
                                      backend="pallas_interpret") ** 2)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    tx = _t(x).requires_grad_(True)
    (ops.maxpool2d(tx, window, stride) ** 2).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), want)

    lx = _t(x).permute(0, 3, 1, 2).detach().requires_grad_(True)
    (F.max_pool2d(lx, window, stride) ** 2).sum().backward()
    assert not np.array_equal(lx.grad.permute(0, 2, 3, 1).numpy(), want)


def test_maxpool_neg_inf_border_matches_jax():
    """The ResNet stem's -inf padded 3x3/2 pool: every window holds a
    finite value, so no -inf (and no NaN) comes out, and the gradient
    never reaches the border."""
    x = np.maximum(rand(2, 10, 10, 4, seed=41), 0.0)   # relu: zero ties
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)),
                constant_values=-np.inf)

    def loss(x):
        xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)),
                     constant_values=-jnp.inf)
        return jnp.sum(jops.maxpool2d(xp, 3, 2,
                                      backend="pallas_interpret") ** 2)

    want = np.asarray(jops.maxpool2d(jnp.asarray(xp), 3, 2,
                                     backend="pallas_interpret"))
    got = ops.maxpool2d(_t(xp), 3, 2)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy(), want)
    tx = _t(x).requires_grad_(True)
    txp = F.pad(tx, (0, 0, 1, 1, 1, 1), value=-float("inf"))
    (ops.maxpool2d(txp, 3, 2) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.asarray(jax.grad(loss)(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    # an all -inf window gives -inf, not NaN (the plain version's rule,
    # which the kernel follows)
    ninf = torch.full((1, 3, 3, 2), -float("inf"))
    assert bool((_pool_plain(ninf, (3, 3), (1, 1), "max") ==
                 -float("inf")).all())


def test_pool_bf16_matches_jax():
    x = jnp.asarray(rand(2, 8, 8, 4, seed=42)).astype(jnp.bfloat16)
    tx = array_to_tensor(np.asarray(x))
    got = ops.maxpool2d(tx, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tensor_to_array(got),
        np.asarray(jops.maxpool2d(x, 2, backend="xla")).astype(np.float32))
    # avg sums in bf16 here and in _pool_xla (the TPU kernel sums in f32)
    np.testing.assert_allclose(
        tensor_to_array(ops.avgpool2d(tx, 2)),
        np.asarray(jops.avgpool2d(x, 2, backend="xla")).astype(np.float32),
        rtol=1e-2, atol=1e-2)


def test_pool_rejects_bad_input():
    with pytest.raises(ValueError, match="4-D"):
        ops.maxpool2d(torch.zeros(4, 4, 1))
    with pytest.raises(ValueError, match="larger"):
        ops.avgpool2d(torch.zeros(1, 2, 2, 1), 3)


# ------------------------------------------------------------- dispatch

def test_cpu_conv_and_pool_take_the_plain_versions():
    before = ops.launch_counts()
    x = torch.ones(1, 6, 6, 2)
    ops.maxpool2d(ops.conv2d(x, torch.ones(3, 3, 2, 4)))
    ops.avgpool2d(x)
    assert ops.launch_counts() == before
    assert "pool" in ops.KERNELS


def test_non_cpu_non_cuda_pool_raises():
    with pytest.raises(ValueError, match="cpu or cuda"):
        ops.maxpool2d(torch.empty(1, 4, 4, 2, device="meta"))


# ----------------------------------------------------------------- data

@pytest.mark.parametrize("kw", [dict(seed=0, n_train=16, n_val=8),
                                dict(seed=3, n_train=4, n_val=2,
                                     shape=(64, 64, 3), n_classes=1000)])
def test_make_images_byte_identical_to_jax(kw):
    for got, want in zip(make_images(**kw), jax_make_images(**kw)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
