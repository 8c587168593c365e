"""Device-mesh construction and a launcher for one box.

Port of ``lua_mapreduce_tpu/parallel/mesh.py``. The JAX mesh is an array
of devices that one program drives; here every device is a process (a
rank of a ``torch.distributed`` world) and the mesh is torch's own
``DeviceMesh`` over those ranks, wrapped so that ``mesh.shape[name]``
and ``mesh.axis_names`` read as the JAX ``Mesh``'s do. Axis
conventions as in the JAX package:

- ``dp`` — data parallel (batch / map-shard axis; the map-phase analog)
- ``mp`` — model parallel (tensor-sharded parameters)

The backend follows the device the caller names: NCCL for ``cuda``,
gloo for ``cpu``. A CUDA mesh never becomes a gloo or CPU one: a world
without NCCL raises.

A mesh needs a running world, one process per rank. With no world
running, :func:`make_mesh` starts a one-rank world itself when the mesh
has one rank (a ``file://`` store in a temp file, no TCP port), the way
a one-device JAX mesh needs no set-up; any other size raises. Worlds of
several ranks come from :func:`spawn` (one box — the counterpart of
:func:`host_mesh`'s virtual CPU devices, and the way the tests run) or
from a launcher such as ``torchrun``, each rank calling
:func:`make_mesh` after ``init_process_group``.
"""

from __future__ import annotations

import collections
import datetime
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from lua_mapreduce_tpu_torch.device import resolve_device

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}
_MESHES: Dict[tuple, "Mesh"] = {}


class Mesh:
    """A mesh of ranks, of any rank count and number of axes.

    ``shape`` maps each axis name to its size and ``axis_names`` lists
    them, as on the JAX ``Mesh``; :meth:`group` is an axis's process
    group (the ranks that share this rank's index on every other axis),
    :meth:`axis_index` this rank's index along an axis (``lax.
    axis_index``), and ``device`` the device this rank computes on.
    """

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.world = dist.group.WORLD   # the world the groups belong to
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape = collections.OrderedDict(
            (name, device_mesh.size(i))
            for i, name in enumerate(self.axis_names))

    def group(self, name: str):
        return self.device_mesh.get_group(name)

    def axis_index(self, name: str) -> int:
        return self.device_mesh.get_local_rank(name)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, device={self.device}, "
                f"backend={dist.get_backend()})")


def _start_one_rank_world(backend: str) -> None:
    fd, path = tempfile.mkstemp(prefix="lmr-mesh-")
    os.close(fd)
    dist.init_process_group(backend, init_method=f"file://{path}", rank=0,
                            world_size=1)


def _join_world(dev: torch.device, n_ranks: int, what: str) -> torch.device:
    """Check the running world against a mesh of ``n_ranks`` on ``dev``
    — or, with no world running and one rank asked for, start one —
    and return the device this rank computes on (a card with its
    index). The world's backend must be the device's: a CUDA mesh never
    runs gloo."""
    backend = _BACKEND[dev.type]
    if not dist.is_initialized():
        if n_ranks != 1:
            raise RuntimeError(
                f"{what} needs a running world of {n_ranks} ranks: start "
                f"them with lua_mapreduce_tpu_torch.parallel.mesh.spawn on "
                f"one box, or with torchrun, and build the mesh in each")
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        _start_one_rank_world(backend)
    running = dist.get_backend()
    if backend not in running:
        raise RuntimeError(f"the running world's backend is {running!r}: a "
                           f"{dev.type} mesh needs {backend}")
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(dp: Optional[int] = None, mp: int = 1,
              device: Optional[Union[str, torch.device]] = None,
              axis_names: Tuple[str, str] = ("dp", "mp")) -> Mesh:
    """A 2-D mesh of shape (dp, mp) over the running world.

    ``dp`` defaults to ``world_size // mp``; a shape that does not fill
    the world raises. ``device`` (default ``"cuda"``) picks the device
    type and with it the backend the world must run (NCCL for CUDA,
    gloo for the CPU). With no world running, a one-rank mesh starts
    one; a larger mesh raises, naming the launchers. Meshes are kept per
    world and shape, so asking again returns the same groups.
    """
    dev = _join_world(resolve_device(device), (dp or 1) * mp,
                      f"a {dp}x{mp} mesh")
    world = dist.get_world_size()
    if dp is None:
        if world % mp:
            raise ValueError(f"{world} ranks not divisible by mp={mp}")
        dp = world // mp
    if dp * mp != world:
        raise ValueError(f"mesh {dp}x{mp} != {world} ranks")
    key = (dev, dp, mp, tuple(axis_names))
    mesh = _MESHES.get(key)
    if mesh is None or mesh.world is not dist.group.WORLD:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = Mesh(init_device_mesh(dev.type, (dp, mp),
                                     mesh_dim_names=tuple(axis_names)), dev)
        _MESHES[key] = mesh
    return mesh


def host_mesh(n: int = 8, dp: Optional[int] = None, mp: int = 1) -> Mesh:
    """A CPU (gloo) mesh over a running world of ``n`` ranks — the
    counterpart of the JAX package's mesh over ``n`` virtual CPU
    devices (the .travis.yml "multi-node on one machine" analog). Run
    it inside ``spawn(fn, n, ..., device="cpu")``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise RuntimeError(f"need a world of {n} ranks, have {world}: run "
                           f"under lua_mapreduce_tpu_torch.parallel.mesh."
                           f"spawn(fn, {n}, ..., device='cpu')")
    return make_mesh(dp=dp, mp=mp, device="cpu")


def mesh_axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name]


# ---------------------------------------------------------------- launcher

def _rank_main(rank: int, n: int, fn: Callable, args: tuple, device: str,
               workdir: str, timeout_s: float) -> None:
    """One rank of :func:`spawn`: join the world at the ``file://``
    store, build the (n, 1) mesh, run ``fn`` and save its result."""
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        _BACKEND[device], init_method=f"file://{workdir}/store", rank=rank,
        world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(make_mesh(dp=n, device=device), *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        dist.barrier()      # no rank tears its groups down under another
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable[..., Any], n: int, *args: Any,
          device: Optional[Union[str, torch.device]] = None,
          timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on each rank of a new world of ``n``
    processes on this machine and return every rank's result, in rank
    order.

    The processes start with ``torch.multiprocessing``'s ``spawn``
    method and meet at a ``file://`` store in a temp directory; each
    gets the (n, 1) mesh of :func:`make_mesh` on ``device`` (default
    ``"cuda"``: NCCL, rank r on card r; ``"cpu"``: gloo). ``fn`` and ``args`` are
    pickled, so ``fn`` is a module-level function; its result is saved
    with ``torch.save``. A rank that raises or dies fails the call, and
    so does the whole world not finishing within ``timeout_s`` seconds
    (which also bounds every collective): the processes left are
    stopped and ``RuntimeError`` / ``TimeoutError`` raised — no hang.
    """
    device = resolve_device(device).type
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} CUDA ranks need {n} cards, found "
                           f"{torch.cuda.device_count()}")
    import torch.multiprocessing as tmp
    with tempfile.TemporaryDirectory(prefix="lmr-spawn-") as workdir:
        ctx = tmp.start_processes(
            _rank_main, args=(n, fn, args, device, workdir, timeout_s),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.05, min(
                    1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"a world of {n} ranks did not finish "
                                       f"within {timeout_s} s")
        except (tmp.ProcessRaisedException, tmp.ProcessExitedException) as e:
            raise RuntimeError(f"rank {e.error_index} of {n} failed: "
                               f"{e}") from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join(5)
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
