"""Device meshes over ``torch.distributed`` process groups.

Counterpart of ``graphslim_tpu/dist/mesh.py``.  JAX's single controller
sees every device of its mesh; here every rank runs the whole program
(SPMD, as ``torchrun`` launches it) and a mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` whose ``mesh_dim_names``
are the JAX axis names.  On the card the backend is NCCL, one rank per
GPU; with ``device="cpu"`` it is gloo.  Neither falls back to the other.

The process group comes from the launcher's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), from a ``store`` the
caller hands in (a ``FileStore``, as the tests do), or, with neither and
one rank asked for, from an in-process store: a world of one, which is
what the card's single H100 runs.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from graphslim_tpu_torch.utils import resolve_device

# how long a collective waits for its peers before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _launched_world() -> Optional[int]:
    """The world size a launcher put in the environment, if any."""
    w = os.environ.get("WORLD_SIZE")
    return None if w is None else int(w)


def init_process_group(n_devices: Optional[int], device,
                       store=None, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout: Optional[datetime.timedelta] = None) -> int:
    """Initialize the default process group unless it is up → its world
    size.  Raises when fewer than ``n_devices`` ranks exist, before any
    initialization where the environment already says so."""
    if dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = world_size if store is not None else _launched_world()
        world = 1 if world is None else world
    if n_devices is not None and world < n_devices:
        raise RuntimeError(
            f"requested a {n_devices}-device mesh but only {world} rank(s) "
            f"exist; launch one rank per device, e.g. torchrun --standalone "
            f"--nproc-per-node {n_devices} -m graphslim_tpu_torch.train_all "
            f"... --dist_devices {n_devices}")
    if n_devices is not None and world > n_devices:
        raise RuntimeError(
            f"requested a {n_devices}-device mesh in a world of {world} "
            f"ranks; launch exactly {n_devices}")
    dev = resolve_device(device)
    backend = _backend(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"the process group runs {dist.get_backend()!r}, a mesh "
                f"on {dev.type} needs {backend!r}")
        return world
    timeout = DEFAULT_TIMEOUT if timeout is None else timeout
    if store is not None:
        r = rank
    elif _launched_world() is not None:
        r = int(os.environ["RANK"])
    else:
        store, r = dist.HashStore(), 0
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", r))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if store is None:
        dist.init_process_group(backend, init_method="env://", rank=r,
                                world_size=world, timeout=timeout)
    else:
        dist.init_process_group(backend, store=store, rank=r,
                                world_size=world, timeout=timeout)
    return world


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", *,
              device=None, store=None, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              timeout: Optional[datetime.timedelta] = None) -> DeviceMesh:
    """1-D mesh over ``n_devices`` ranks (all of them for ``None``).

    Raises if fewer ranks exist than requested: a silent clamp would let a
    ``--dist_devices 8`` run degrade to one device and still report itself
    as distributed.  ``device`` defaults to the CUDA card (NCCL);
    ``"cpu"`` takes gloo."""
    world = init_process_group(n_devices, device, store, rank, world_size,
                               timeout)
    return init_device_mesh(resolve_device(device).type, (world,),
                            mesh_dim_names=(axis,))


def make_mesh_2d(shape: tuple[int, int],
                 axes: tuple[str, str] = ("data", "model"), *,
                 device=None, store=None, rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 timeout: Optional[datetime.timedelta] = None
                 ) -> DeviceMesh:
    """2-D mesh of ``shape`` ranks, row-major over the world."""
    init_process_group(shape[0] * shape[1], device, store, rank,
                       world_size, timeout)
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=axes)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along the mesh axis named ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


# torch 2.13 renamed ``all_gather_into_tensor`` and
# ``reduce_scatter_tensor`` to ``*_single``; the name is chosen by what the
# installed torch has
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Every rank's ``inp`` [m, ...] stacked in rank order into ``out``
    [S·m, ...] (JAX's tiled ``all_gather``)."""
    _ALL_GATHER(out, inp.contiguous(), group=group)


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Sum ``inp`` [S·m, ...] over the group's ranks and leave rank k's
    block k in ``out`` [m, ...] (JAX's ``psum_scatter``)."""
    _REDUCE_SCATTER(out, inp.contiguous(), group=group)
