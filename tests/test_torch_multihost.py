"""The port's multi-host helpers (``parallel/multihost.py``) against the
JAX package's, on gloo CPU worlds.

Counterparts of the light tests of ``tests/test_multihost.py`` (:12-48,
:203) and of its four-process hybrid-mesh test (:300): one world of 8
ranks (``tests/torch_parallel_ranks.py::multihost_cases``) builds the
one-host mesh, the global-batch tile and a DP trainer over a multihost
mesh, then — with ``LOCAL_WORLD_SIZE=2``, four hosts of two ranks — the
hybrid (dp 4, mp 2) mesh: dp rows never span hosts, mp stays inside
one, each host feeds its own rows, a dp ring crosses hosts and a psum
over mp then over dp matches numpy. The rank layout itself is held
against the JAX ``create_hybrid_device_mesh`` on stand-in devices, and
``initialize_multihost`` joins a world of two processes at a
``localhost`` coordinator.
"""

import functools
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.experimental import mesh_utils

import torch_parallel_ranks as ranks
from lua_mapreduce_tpu.models.mlp import init_mlp
from lua_mapreduce_tpu_torch.parallel import multihost as mh
from lua_mapreduce_tpu_torch.parallel import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs():
    rng = np.random.RandomState(0)
    return {
        "x8": np.arange(64, dtype=np.float32).reshape(8, 8),
        "mlp": {k: np.asarray(v) for k, v in
                init_mlp(jax.random.PRNGKey(0), (16, 8, 4)).items()},
        "mlp_x": rng.rand(16, 16).astype(np.float32),
        "mlp_y": rng.randint(0, 4, 16),
        "gx": np.random.RandomState(3).rand(8, 16).astype(np.float32),
        "w": np.linspace(-1, 1, 16).astype(np.float32),
    }


D = _inputs()


@functools.lru_cache(maxsize=None)
def _world():
    return spawn(ranks.multihost_cases, 8, D, device="cpu", timeout_s=300)


@pytest.fixture(scope="module")
def world():
    return _world()


def test_initialize_noop_without_coordinator(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mh.initialize_multihost(device="cpu") is False


def test_process_local_batch_without_world(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert mh.process_local_batch(32) == (32, 0)


class _Dev:
    """A stand-in device for the JAX mesh constructor: an id and a process
    (the granule), no slice."""

    platform = device_kind = "cpu"
    slice_index = None

    def __init__(self, i, process):
        self.id, self.process_index = i, process


@pytest.mark.parametrize("shape,dcn_axis,per_host", [
    ((4, 2), 0, 2), ((2, 2, 2), 0, 4), ((2, 4), 1, 4), ((8, 1), 0, 2),
    ((2, 2, 2), 1, 4), ((4, 2), 0, 8)])
def test_host_layout_matches_jax_hybrid_mesh(shape, dcn_axis, per_host):
    """The rank at each mesh position equals the device id at the same
    position of the JAX package's mesh over the same hosts
    (``create_hybrid_device_mesh`` with processes as granules, or the
    ordinary mesh on one host)."""
    world = int(np.prod(shape))
    n_hosts = world // per_host
    devs = [_Dev(i, i // per_host) for i in range(world)]
    if n_hosts > 1:
        per = list(shape)
        per[dcn_axis] //= n_hosts
        dcn = [1] * len(shape)
        dcn[dcn_axis] = n_hosts
        arr = mesh_utils.create_hybrid_device_mesh(
            per, dcn, devices=devs, process_is_granule=True)
    else:
        arr = np.asarray(devs).reshape(shape)
    want = np.vectorize(lambda d: d.id)(arr)
    np.testing.assert_array_equal(
        mh._host_layout(shape, dcn_axis, world, per_host), want)


def test_multihost_mesh_single_host(world):
    """No LOCAL_WORLD_SIZE: one host, the ordinary (4, 2) mesh over all
    8 ranks (tests/test_multihost.py::test_multihost_mesh_single_slice_
    shape), every rank in it once; a process-local batch is the whole
    batch at offset 0."""
    for o in world:
        assert o["single_shape"] == {"dp": 4, "mp": 2}
        assert o["single_mesh"] == np.arange(8).reshape(4, 2).tolist()
        assert tuple(o["single_batch"]) == (32, 0)


def test_multihost_mesh_rejects_wrong_device_count(world):
    for o in world:
        assert "needs 16 devices" in o["errors"]["count"]


def test_global_batch_array_roundtrip(world):
    """A (dp 8) tile per rank — one row each — that gathers back to the
    host array, and feeds a sum over the mesh."""
    x = D["x8"]
    for r, o in enumerate(world):
        np.testing.assert_array_equal(o["tile"], x[r:r + 1])
        np.testing.assert_array_equal(o["tile_gathered"], x)
        assert o["tile_sum"] == float(x.sum())


def test_dp_training_step_over_multihost_mesh(world):
    """The DP trainer's mesh can come from make_multihost_mesh: three
    steps, finite, alike on every rank (tests/test_multihost.py:203)."""
    for o in world:
        assert o["dp_losses"].size == 3
        assert np.all(np.isfinite(o["dp_losses"]))
        np.testing.assert_array_equal(o["dp_losses"], world[0]["dp_losses"])


def test_hybrid_mesh_over_four_hosts(world):
    """LOCAL_WORLD_SIZE=2 makes four hosts of two ranks: the (dp 4,
    mp 2) mesh factors dp over the hosts, so no dp row spans hosts and
    mp stays inside one; each host feeds its two rows; a dp ring (every
    hop across hosts) and the two-level psum (mp inside a host, dp
    across) match numpy — tests/test_multihost.py:300 with ranks for
    its four two-device processes."""
    gx, w = D["gx"], D["w"]
    for r, o in enumerate(world):
        mesh = np.asarray(o["hybrid_mesh"])
        assert mesh.shape == (4, 2)
        hosts = mesh // 2
        for i in range(4):
            assert len(set(hosts[i])) == 1, f"dp row {i} spans hosts"
        row_host = [hosts[i][0] for i in range(4)]
        assert sorted(row_host) == [0, 1, 2, 3] and row_host != [0, 0, 1, 1]
        dp, mp = o["hybrid_index"]
        assert tuple(o["hybrid_batch"]) == (2, 2 * (r // 2))
        np.testing.assert_array_equal(
            o["hybrid_tile"], gx[2 * dp:2 * dp + 2, 8 * mp:8 * mp + 8])
        rows = np.arange(8)[:, None]
        assert np.isclose(o["poswsum"], np.sum(gx * rows), rtol=1e-6)
        assert np.isclose(o["poswsum_rolled"],
                          np.sum(np.roll(gx, 2, axis=0) * rows), rtol=1e-6)
        assert np.isclose(o["two_level"], np.sum((gx @ w) ** 2) / 8.0,
                          rtol=1e-5)
        assert "not divisible by 4 slices" in o["hybrid_errors"]["dcn"]
        assert "outside its host's rows" in o["hybrid_errors"]["rows"]


_JOIN = r'''
import sys
import torch
from lua_mapreduce_tpu_torch.parallel import collectives as C
from lua_mapreduce_tpu_torch.parallel import multihost as mh
pid, port = int(sys.argv[1]), sys.argv[2]
assert mh.initialize_multihost(f"localhost:{port}", 2, pid, device="cpu")
m = mh.make_multihost_mesh((2,), ("dp",), device="cpu")
s = C.psum(torch.tensor([float(pid + 1)]), m, "dp")
print(f"P{pid}-OK sum={float(s[0])}", flush=True)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
'''


def test_initialize_multihost_joins_two_processes(tmp_path):
    """Two processes join one gloo world through ``initialize_multihost``
    at a localhost coordinator and psum over the multihost mesh."""
    script = tmp_path / "join.py"
    script.write_text(_JOIN)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen([sys.executable, str(script), str(i),
                               str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"P{i}-OK sum=3.0" in out, out
