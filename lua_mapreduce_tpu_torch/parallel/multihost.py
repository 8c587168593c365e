"""Multi-host bootstrap: host-aware meshes and global-batch helpers.

Port of ``lua_mapreduce_tpu/parallel/multihost.py``. The JAX package
scales past one machine with multi-process SPMD: every host runs the
same program, a coordinator bootstraps the process group, and the mesh
spans every host's devices, with the data-parallel axis on the slow
links between slices (DCN) and the tensor and sequence axes inside a
slice. Here every rank is a process of one ``torch.distributed`` world
(NCCL on cards, gloo on the CPU, as ``parallel/mesh.py``), and the
granule that stands in for a slice is a host: ``LOCAL_WORLD_SIZE``
consecutive ranks, the variable ``torchrun`` sets on every host. With
it unset the whole world is one host.

On one box everything degrades as in the JAX package:
:func:`initialize_multihost` with nothing configured is a no-op, and
the mesh is the ordinary mesh over the running world.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from lua_mapreduce_tpu_torch.device import resolve_device
from lua_mapreduce_tpu_torch.parallel.mesh import _BACKEND, Mesh, _join_world

_MESHES: Dict[tuple, Mesh] = {}


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> bool:
    """Join the multi-host world; True when this process is in one.

    The arguments default to ``torchrun``'s variables: the coordinator
    to ``MASTER_ADDR:MASTER_PORT``, the process count to
    ``WORLD_SIZE``, the process id to ``RANK``. With neither a
    coordinator nor a process count configured this is a no-op that
    returns False — the one-box path. ``coordinator_address`` is
    ``"host:port"``. ``device`` (default ``"cuda"``) picks the backend,
    NCCL for a card (this process on card ``LOCAL_RANK``, else its rank
    modulo the cards) and gloo for the CPU. With a world configured and
    already running (torchrun's, joined by an earlier call) it returns
    True and starts nothing."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") \
            and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = env.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else
                              (process_id or 0) % torch.cuda.device_count())
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group(_BACKEND[dev.type], init_method=init, **kw)
    return True


def _hosts() -> Tuple[int, int]:
    """(ranks per host, number of hosts) of the running world (one
    host of one rank with no world)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    per = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per < 1 or world % per:
        raise ValueError(f"LOCAL_WORLD_SIZE={per} does not divide the "
                         f"world of {world} ranks")
    return per, world // per


def _host_layout(mesh_shape: Sequence[int], dcn_axis: int, world: int,
                per_host: int) -> np.ndarray:
    """The rank at each position of a mesh over hosts of ``per_host``
    consecutive ranks: each host's ranks form the mesh with the
    ``dcn_axis`` cut by the host count, and the hosts' meshes are laid
    side by side along that axis in host order — the JAX
    ``create_hybrid_device_mesh`` layout, so only the ``dcn_axis``
    crosses hosts."""
    shape = list(mesh_shape)
    n_hosts = world // per_host
    if n_hosts == 1:
        return np.arange(world).reshape(shape)
    per = list(shape)
    per[dcn_axis] //= n_hosts
    return np.concatenate(
        [np.arange(h * per_host, (h + 1) * per_host).reshape(per)
         for h in range(n_hosts)], axis=dcn_axis)


def make_multihost_mesh(mesh_shape: Sequence[int], axis_names: Sequence[str],
                        dcn_axis: int = 0,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Mesh:
    """A mesh of any number of axes over every rank of the running
    world, the host boundary on exactly one axis.

    ``mesh_shape`` / ``axis_names`` describe the global mesh, whose
    size must be the world's. With more than one host the
    ``dcn_axis`` axis is factored as (hosts × per host)
    (:func:`_host_layout`), so only that axis's collectives cross hosts
    and every other axis stays inside one; with one host it is the
    ordinary row-major mesh of ``make_mesh``. ``device`` (default
    ``"cuda"``) as in ``make_mesh``; with no world running a one-rank
    mesh starts one. Meshes are kept per world, layout and names."""
    shape = [int(n) for n in mesh_shape]
    names = tuple(axis_names)
    if len(names) != len(shape):
        raise ValueError(f"{len(shape)} axis sizes but {len(names)} names")
    total = int(np.prod(shape))
    dev = _join_world(resolve_device(device), total,
                      f"mesh {tuple(shape)}")
    world = dist.get_world_size()
    if total != world:
        raise ValueError(f"mesh {tuple(shape)} needs {total} devices, have "
                         f"{world}")
    per_host, n_hosts = _hosts()
    if n_hosts > 1 and shape[dcn_axis] % n_hosts:
        raise ValueError(
            f"dcn axis {names[dcn_axis]}={shape[dcn_axis]} not divisible "
            f"by {n_hosts} slices (hosts of {per_host} ranks)")
    layout = _host_layout(shape, dcn_axis, world, per_host)
    key = (dev, names, layout.tobytes(), layout.shape)
    mesh = _MESHES.get(key)
    if mesh is None or mesh.world is not dist.group.WORLD:
        from torch.distributed.device_mesh import DeviceMesh
        mesh = Mesh(DeviceMesh(dev.type, torch.as_tensor(layout),
                               mesh_dim_names=names), dev)
        _MESHES[key] = mesh
    return mesh


def process_local_batch(global_batch: int) -> Tuple[int, int]:
    """(this host's batch rows, their row offset) for an even split of
    a global batch over hosts — each host feeds only its own rows (the
    ``ShardedDataset`` shard-ownership contract, ``train/sharding.py``).
    A host is ``LOCAL_WORLD_SIZE`` consecutive ranks."""
    per_host, n = _hosts()
    rank = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    rows = global_batch // n
    return rows, (rank // per_host) * rows


def global_batch_array(mesh: Mesh, spec: Sequence[Optional[str]],
                       host_local) -> torch.Tensor:
    """This rank's tile of the global array that every host's local
    rows make together (the JAX ``make_array_from_process_local_data``;
    the port has no global array).

    ``host_local`` holds this host's rows of dimension 0 — the global
    rows [offset, offset + rows) of :func:`process_local_batch` — and
    every other dimension whole. ``spec`` names, per dimension, the
    mesh axis that cuts it or None (as ``PartitionSpec``). No host
    materializes the global batch: a rank's rows must lie in its own
    host's rows. Returns a tensor on the mesh's device."""
    x = torch.as_tensor(host_local)
    n_hosts = _hosts()[1]
    rows, off = process_local_batch(x.shape[0] * n_hosts)
    spec = tuple(spec) + (None,) * (x.dim() - len(tuple(spec)))
    if spec[0] is None and n_hosts > 1:
        raise ValueError("dimension 0 holds each host's own rows: it must "
                         "be cut by a mesh axis (the host axis)")
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        size = x.shape[dim] * (n_hosts if dim == 0 else 1)
        if size % n:
            raise ValueError(f"dimension {dim} of the global array "
                             f"({size}) does not split over {axis}={n}")
        block = size // n
        start = mesh.axis_index(axis) * block - (off if dim == 0 else 0)
        if start < 0 or start + block > x.shape[dim]:
            raise ValueError(
                f"this rank's rows of {axis} lie outside its host's rows "
                f"[{off}, {off + rows}): put the host axis (dcn_axis) on "
                f"dimension 0")
        x = x.narrow(dim, start, block)
    return x.contiguous().to(mesh.device)
