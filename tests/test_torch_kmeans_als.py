"""The port's k-means and ALS (BASELINE.json config 5) against the JAX
package's, on the CPU.

The counterparts of ``tests/test_kmeans_als.py``'s ``TestKMeansNative``
and ``TestALSNative``: the single-device fit converges, the mesh fit (an
n-rank gloo world from ``parallel.mesh.spawn``, n = 2 and 4) agrees with
the single-device one, and both agree with the JAX package's fit from
the same initial centroids / item factors (numpy arrays carried
across). Tolerances are that file's: 1e-4 for centroids and (tighter
than its own 1e-3 mesh-against-single bound) ALS factors, rtol 1e-3 for
inertia and RMSE histories. The two packages solve the ALS normal
equations differently (LU there, Cholesky here); they agree to ~1e-5.
The six-function packaging tests (``TestMapReducePackaging``) wait for
the in-graph slice.
"""

import numpy as np
import pytest

import torch_parallel_ranks as ranks
from lua_mapreduce_tpu.models import als as jax_als
from lua_mapreduce_tpu.models import kmeans as jax_km
from lua_mapreduce_tpu.parallel.mesh import host_mesh
from lua_mapreduce_tpu.train import data as jax_data
from lua_mapreduce_tpu_torch.models import als, kmeans
from lua_mapreduce_tpu_torch.parallel import spawn
from lua_mapreduce_tpu_torch.train.data import make_blobs, make_ratings


@pytest.fixture(scope="module")
def blobs():
    return make_blobs(seed=3, n=2048, k=8, dim=16)


@pytest.fixture(scope="module")
def ratings():
    return make_ratings(seed=4, n_users=256, n_items=64, rank=4)


def _v0(seed=1):
    return als.init_item_factors(seed, 64, 4).numpy()


@pytest.fixture(scope="module", params=[2, 4], ids=["dp2", "dp4"])
def world(request, blobs, ratings):
    n = request.param
    d = {"blobs": blobs[0], "c0": blobs[0][:8], "r": ratings[0],
         "w": ratings[1], "v0": _v0()}
    return n, d, spawn(ranks.kmeans_als_cases, n, d, device="cpu",
                       timeout_s=240)


def test_data_generators_match_jax():
    for a, b in zip(make_blobs(seed=5, n=300, k=4, dim=8),
                    jax_data.make_blobs(seed=5, n=300, k=4, dim=8)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(make_ratings(seed=6, n_users=40, n_items=16, rank=3,
                                 density=0.4),
                    jax_data.make_ratings(seed=6, n_users=40, n_items=16,
                                          rank=3, density=0.4)):
        np.testing.assert_array_equal(a, b)


class TestKMeansNative:
    def test_recovers_centers_and_monotone_inertia(self, blobs):
        x, _, centers = blobs
        c0 = kmeans.init_centroids(0, x, 8)
        res = kmeans.kmeans_fit(x, c0, n_iters=25, device="cpu")
        hist = res.history.numpy()
        assert (np.diff(hist) <= 1e-3).all(), "Lloyd inertia must not rise"
        d = np.linalg.norm(res.centroids.numpy()[None, :, :]
                           - centers[:, None, :], axis=-1)
        assert d.min(axis=1).max() < 0.25, d.min(axis=1)
        want = jax_km.kmeans_fit(x, c0.numpy(), n_iters=25)
        np.testing.assert_allclose(res.centroids.numpy(),
                                   np.asarray(want.centroids),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(hist, np.asarray(want.history),
                                   rtol=1e-3)

    def test_mesh_matches_single_device_and_jax(self, world):
        n, d, out = world
        x, c0 = d["blobs"], d["c0"]
        single = kmeans.kmeans_fit(x, c0, n_iters=10, device="cpu")
        jax_mesh = jax_km.kmeans_fit(x, c0, n_iters=10, mesh=host_mesh(n))
        for o in out:
            c, inertia, hist = o["km"]
            np.testing.assert_array_equal(c, out[0]["km"][0])
            np.testing.assert_allclose(c, single.centroids.numpy(),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(float(inertia), float(single.inertia),
                                       rtol=1e-3)
            np.testing.assert_allclose(c, np.asarray(jax_mesh.centroids),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(hist, np.asarray(jax_mesh.history),
                                       rtol=1e-3)

    def test_empty_cluster_keeps_centroid(self):
        x = np.zeros((16, 2), np.float32)       # all points identical
        c0 = np.array([[0.0, 0.0], [9.0, 9.0]], np.float32)
        res = kmeans.kmeans_fit(x, c0, n_iters=3, device="cpu")
        np.testing.assert_allclose(res.centroids.numpy()[1], [9.0, 9.0])
        np.testing.assert_allclose(
            res.centroids.numpy(),
            np.asarray(jax_km.kmeans_fit(x, c0, n_iters=3).centroids))

    def test_assign_and_init_match_contract(self, blobs):
        x = blobs[0]
        c = x[:8]
        np.testing.assert_array_equal(kmeans.assign(x, c).numpy(),
                                      np.asarray(jax_km.assign(x, c)))
        import torch
        a = kmeans.init_centroids(torch.Generator().manual_seed(3), x, 8)
        b = kmeans.init_centroids(torch.Generator().manual_seed(3), x, 8)
        assert torch.equal(a, b) and a.shape == (8, 16)
        r = kmeans.init_centroids(2, x, 8, method="random").numpy()
        assert len({tuple(row) for row in r}) == 8
        assert all((x == row).all(axis=1).any() for row in r)
        with pytest.raises(ValueError, match="unknown init"):
            kmeans.init_centroids(0, x, 8, method="nope")


class TestALSNative:
    def test_converges_to_noise_floor(self, ratings):
        r, w = ratings
        v0 = als.init_item_factors(0, 64, 4)
        res = als.als_fit(r, w, v0, n_iters=10, reg=0.01, device="cpu")
        hist = res.history.numpy()
        assert hist[-1] < 0.05, hist
        assert hist[-1] <= hist[0]
        recon = res.user_factors.numpy() @ res.item_factors.numpy().T
        err = w * (recon - r)
        assert np.sqrt((err ** 2).sum() / w.sum()) < 0.05
        want = jax_als.als_fit(r, w, v0.numpy(), n_iters=10, reg=0.01)
        np.testing.assert_allclose(res.item_factors.numpy(),
                                   np.asarray(want.item_factors),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(hist, np.asarray(want.history),
                                   rtol=1e-3, atol=1e-5)

    def test_mesh_matches_single_device_and_jax(self, world):
        n, d, out = world
        r, w, v0 = d["r"], d["w"], d["v0"]
        single = als.als_fit(r, w, v0, n_iters=5, device="cpu")
        jax_mesh = jax_als.als_fit(r, w, v0, n_iters=5, mesh=host_mesh(n))
        for o in out:
            u, v, rmse, hist = o["als"]
            np.testing.assert_array_equal(v, out[0]["als"][1])
            assert u.shape == (256, 4)
            for got, want in ((v, single.item_factors),
                              (u, single.user_factors),
                              (v, jax_mesh.item_factors),
                              (u, jax_mesh.user_factors)):
                np.testing.assert_allclose(got, np.asarray(want),
                                           rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(hist, np.asarray(jax_mesh.history),
                                       rtol=1e-3)
            assert float(rmse) == float(hist[-1])


def test_kmeans_card_check_start_avoids_assignment_ties():
    """Why chip_smoke.py's card-vs-CPU k-means check (65,536 × 128,
    k = 64, 10 iterations) starts from x[:64]: from randomly drawn
    centroids that data's fit turns on the summation order (points near
    a tie of two distances flip, and the flips compound), so a CPU run
    on the rows permuted parts from the unpermuted run by far more than
    the check's 1e-4; from x[:64] the two agree to float rounding. The
    full-size fit on the card is held to a float64 reference that
    accounts for each flip instead."""
    x, _, _ = make_blobs(seed=1, n=65536, k=64, dim=128)
    perm = np.random.RandomState(0).permutation(len(x))
    gaps = []
    for c0 in (kmeans.init_centroids(1, x, 64, method="random"), x[:64]):
        a = kmeans.kmeans_fit(x, c0, n_iters=10, device="cpu")
        b = kmeans.kmeans_fit(x[perm], c0, n_iters=10, device="cpu")
        gaps.append(float((a.centroids - b.centroids).abs().max()))
    assert gaps[0] > 1e-2 and gaps[1] < 1e-6, gaps
