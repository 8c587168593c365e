"""The port's sharded input pipeline (``train/sharding.py``) against the
JAX package's.

Every test of ``tests/test_sharding.py`` runs on the port's ``mem:``
store, and where it reads batches the port's reader is held to the JAX
reader's batches (same ``np.random.RandomState``, same order, equal
values) for every host. A layout the JAX package writes to a
``shared:`` directory is read by the port, and the other way round, and
the two writers' files are byte-equal.
"""

import os

import numpy as np
import pytest
import torch

from lua_mapreduce_tpu.store.sharedfs import SharedStore as JaxShared
from lua_mapreduce_tpu.train import sharding as jsh
from lua_mapreduce_tpu_torch.store.memfs import MemStore
from lua_mapreduce_tpu_torch.store.sharedfs import SharedStore
from lua_mapreduce_tpu_torch.train.sharding import (ShardedDataset,
                                                    make_sharded)


@pytest.fixture
def data():
    rng = np.random.RandomState(0)
    x = rng.rand(197, 8).astype(np.float32)     # 197-split contract size
    y = rng.randint(0, 10, 197).astype(np.int32)
    return x, y


def _np_batches(it):
    return [(np.asarray(a), np.asarray(b)) for a, b in it]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def _jax_reader(x, y, n_shards):
    from lua_mapreduce_tpu.store.memfs import MemStore as JaxMem
    store = JaxMem()
    jsh.make_sharded(store, "euro", x, y, n_shards=n_shards)
    return jsh.ShardedDataset(store, "euro")


def test_roundtrip_covers_every_example(data):
    x, y = data
    store = MemStore()
    names = make_sharded(store, "euro", x, y, n_shards=13)
    assert len(names) == 13
    ds = ShardedDataset(store, "euro")
    assert ds.n_shards == 13 and ds.n_examples == 197
    xs, ys = zip(*(ds.load_shard(i) for i in range(13)))
    assert all(isinstance(t, torch.Tensor) for t in xs + ys)
    np.testing.assert_array_equal(torch.cat(xs).numpy(), x)
    np.testing.assert_array_equal(torch.cat(ys).numpy(), y)


def test_shard_names_are_the_map_splits(data):
    store = MemStore()
    make_sharded(store, "euro", *data, n_shards=5)
    ds = ShardedDataset(store, "euro")
    for name in ds.shard_names():
        assert store.exists(name)


def test_host_partition_disjoint_and_complete(data):
    """Across hosts, every example is seen exactly once per epoch (shard
    i → host i % n_hosts; labels as example identity), in the JAX
    reader's batches."""
    x, _ = data
    y = np.arange(197, dtype=np.int64)          # unique ids
    store = MemStore()
    make_sharded(store, "euro", x, y, n_shards=8)
    ds = ShardedDataset(store, "euro")
    jds = _jax_reader(x, y, 8)
    seen = []
    for host in range(3):
        got = _np_batches(ds.batches(7, rng=np.random.RandomState(host),
                                     host_id=host, n_hosts=3,
                                     drop_remainder=False))
        want = _np_batches(jds.batches(7, rng=np.random.RandomState(host),
                                       host_id=host, n_hosts=3,
                                       drop_remainder=False))
        _assert_same_batches(got, want)
        for _, yb in got:
            seen.extend(yb.tolist())
    assert sorted(seen) == list(range(197))


def test_batches_cross_shard_boundaries(data):
    """Batch size larger than a shard: leftovers carry across shards
    instead of yielding short batches."""
    x, y = data
    store = MemStore()
    make_sharded(store, "euro", x, y, n_shards=10)   # ~20/shard
    ds = ShardedDataset(store, "euro")
    batches = _np_batches(ds.batches(32, rng=np.random.RandomState(1)))
    assert all(len(xb) == 32 for xb, _ in batches)
    assert len(batches) == 197 // 32
    _assert_same_batches(batches, _np_batches(_jax_reader(x, y, 10).batches(
        32, rng=np.random.RandomState(1))))


def test_manifest_required_and_remove_idempotent(data):
    store = MemStore()
    with pytest.raises(FileNotFoundError):
        ShardedDataset(store, "nope")
    make_sharded(store, "euro", *data, n_shards=4)
    ds = ShardedDataset(store, "euro")
    ds.remove()
    ds.remove()
    assert store.list("euro*") == []


def test_rejects_bad_shard_count(data):
    x, y = data
    store = MemStore()
    with pytest.raises(ValueError):
        make_sharded(store, "e", x, y, n_shards=0)
    with pytest.raises(ValueError):
        make_sharded(store, "e", x, y, n_shards=198)


def test_equal_step_counts_across_hosts(data):
    """SPMD contract: with drop_remainder every host yields EXACTLY
    steps_per_epoch batches, however unevenly shards divide — the JAX
    reader's batches, host by host."""
    x, y = data
    store = MemStore()
    make_sharded(store, "euro", x, y, n_shards=8)    # 3/3/2 shards → 3 hosts
    ds = ShardedDataset(store, "euro")
    jds = _jax_reader(x, y, 8)
    expect = ds.steps_per_epoch(7, n_hosts=3)
    assert expect >= 1 and expect == jds.steps_per_epoch(7, n_hosts=3)
    for h in range(3):
        got = _np_batches(ds.batches(7, rng=np.random.RandomState(h),
                                     host_id=h, n_hosts=3))
        assert len(got) == expect
        _assert_same_batches(got, _np_batches(jds.batches(
            7, rng=np.random.RandomState(h), host_id=h, n_hosts=3)))


def test_zero_step_hosts_raise(data):
    """steps_per_epoch fails loudly, never a silent 0."""
    x, y = data
    store = MemStore()
    make_sharded(store, "euro", x, y, n_shards=4)
    ds = ShardedDataset(store, "euro")
    with pytest.raises(ValueError, match="cannot feed"):
        ds.steps_per_epoch(7, n_hosts=8)        # hosts without shards
    with pytest.raises(ValueError, match="zero steps"):
        ds.steps_per_epoch(120, n_hosts=2)      # batch > host share
    with pytest.raises(ValueError, match="host_id"):
        next(ds.batches(7, rng=np.random.RandomState(0), host_id=2,
                        n_hosts=2))


def test_reshard_replaces_layout_without_orphans(data):
    x, y = data
    store = MemStore()
    make_sharded(store, "euro", x, y, n_shards=13)
    make_sharded(store, "euro", x, y, n_shards=5)
    shards = [n for n in store.list("euro.S*")]
    assert len(shards) == 5, shards              # no 13-shard orphans
    ds = ShardedDataset(store, "euro")
    xs, _ = zip(*(ds.load_shard(i) for i in range(5)))
    np.testing.assert_array_equal(torch.cat(xs).numpy(), x)


def _files(root):
    return {n: open(os.path.join(root, n), "rb").read()
            for n in sorted(os.listdir(root))}


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_layouts_cross_packages_byte_equal(data, tmp_path, as_tensor):
    """The port writes the JAX package's layout byte for byte (from
    numpy arrays or tensors), each package reads the other's, and with
    the same RandomState both readers yield the same batches for every
    host of 3."""
    x, y = data
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsh.make_sharded(JaxShared(jroot), "euro", x, y, n_shards=8)
    tx, ty = (torch.from_numpy(x), torch.from_numpy(y)) if as_tensor \
        else (x, y)
    make_sharded(SharedStore(troot), "euro", tx, ty, n_shards=8)
    assert _files(jroot) == _files(troot)
    port_reads_jax = ShardedDataset(SharedStore(jroot), "euro")
    jax_reads_port = jsh.ShardedDataset(JaxShared(troot), "euro")
    for h in range(3):
        kw = dict(host_id=h, n_hosts=3)
        _assert_same_batches(
            _np_batches(port_reads_jax.batches(
                16, rng=np.random.RandomState(h), **kw)),
            _np_batches(jax_reads_port.batches(
                16, rng=np.random.RandomState(h), **kw)))
