"""Groups of worker processes: the port's counterpart of the JAX package's
``launch/mesh.py``.

Where the JAX package builds a device mesh for one controller, the port
starts one process per worker: :func:`spawn` runs ``fn`` on ``world_size``
ranks under ``torch.multiprocessing.spawn`` (the ``spawn`` start method,
never ``fork``: the parent may hold a CUDA context), each in a
``torch.distributed`` group set up from a store file in a temporary
directory (no TCP port, so concurrent groups on one host never collide),
and returns each rank's result to the parent.

:func:`make_mesh` lays a device mesh over the group: the JAX
package's multi-pod ``("pod", "data")`` mesh is the whole group, its ranks
in row-major order (the order ``jax.lax`` collectives index an axis tuple
in), with one subgroup per line of each axis for a collective that names
that axis alone.

Backends, chosen by the caller:

- ``"nccl"``: one card per rank.  NCCL refuses two ranks on one GPU, so
  with fewer visible cards than ranks :func:`spawn` raises before any
  process starts.
- ``"gloo"``: ranks on the CPU, or several ranks sharing cards (the SPMD
  runtime then stages its CUDA tensors through the host,
  :class:`repro_torch.dist.collectives.Wire`).
- ``"staged"``: gloo for CPU tensors and :mod:`repro_torch.dist.staged`
  for CUDA ones (their collectives staged through pinned host buffers):
  the transformer zoo's DTensor mesh of ranks sharing a card.

The transformer zoo's production meshes are the reference's:
:func:`make_production_mesh` lays a ``torch.distributed`` ``DeviceMesh``
of ``(16, 16)`` ``("data", "model")`` or ``(2, 16, 16)`` ``("pod",
"data", "model")`` over the process group that is up (the ``fake``
backend of the dry run, or real ranks), :func:`dp_axes` names its
token-sharding axes, and :class:`HW` holds the card's constants for the
roofline terms.  :class:`AbstractMesh` is a mesh of names and sizes alone,
for the sharding rules where no group is needed.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["BACKENDS", "Mesh", "make_mesh", "rank_devices", "spawn",
           "make_production_mesh", "make_device_mesh", "dp_axes",
           "mesh_sizes", "AbstractMesh", "HW"]

BACKENDS = ("gloo", "nccl", "staged")
# how long a collective waits for its peers before the group fails
_TIMEOUT = datetime.timedelta(seconds=600)


def rank_devices(world_size: int, backend: str,
                 devices: str | Sequence[str]) -> list[str]:
    """Each rank's device.  ``devices`` is ``"cpu"``, ``"cuda"`` (rank
    ``i`` on card ``i`` modulo the visible cards) or one device per rank.
    Raises ``ValueError`` for what the backend cannot run: an unknown
    backend, NCCL on a CPU rank, or NCCL with two ranks on one card or
    fewer visible cards than ranks."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    n_cards = torch.cuda.device_count()
    if backend == "nccl" and n_cards < world_size:
        raise ValueError(f"nccl needs one card per rank: {world_size} ranks, "
                         f"{n_cards} visible cards; run gloo to share cards")
    if isinstance(devices, str):
        kind = torch.device(devices).type
        if kind == "cuda" and n_cards < 1:
            raise RuntimeError("CUDA is not available; pass devices='cpu' to "
                               "run the ranks on the CPU")
        devs = ([f"cuda:{i % n_cards}" for i in range(world_size)]
                if kind == "cuda" else ["cpu"] * world_size)
    else:
        devs = [str(torch.device(d)) for d in devices]
        if len(devs) != world_size:
            raise ValueError(f"{len(devs)} devices for {world_size} ranks")
    if backend == "nccl":
        if any(not d.startswith("cuda") for d in devs):
            raise ValueError(f"nccl runs on CUDA devices only: {devs}")
        if len(set(devs)) != len(devs):
            raise ValueError(f"nccl needs one card per rank: {devs}")
    return devs


def _worker(rank: int, fn: Callable, world_size: int, backend: str,
            devices: list[str], store: str, args: tuple) -> None:
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # P ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    if backend == "staged":
        from ..dist import staged
        staged.register()
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world_size,
                            timeout=_TIMEOUT)
    try:
        result = fn(rank, world_size, device, *args)
        torch.save(result, os.path.join(os.path.dirname(store),
                                        f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *, backend: str,
          devices: str | Sequence[str], args: tuple = ()) -> list:
    """Run ``fn(rank, world_size, device, *args)`` on ``world_size`` ranks
    of one process group; returns the ranks' results in rank order.

    ``fn`` must be importable by name (a module-level function) and its
    arguments and result picklable: they cross process boundaries.  A
    rank that raises ends the group, and the error is raised here."""
    devs = rank_devices(world_size, backend, devices)
    with tempfile.TemporaryDirectory(prefix="repro_torch_group_") as tmp:
        store = os.path.join(tmp, "store")
        mp.spawn(_worker, args=(fn, world_size, backend, devs, store, args),
                 nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh over the default process group, one rank a device:
    ``shape`` and ``axis_names`` as the JAX package's ``jax.make_mesh``
    takes them, the ranks laid out row-major; ``axis_groups[name]`` is
    this rank's subgroup along that axis alone."""
    shape: tuple
    axis_names: tuple
    axis_groups: dict

    def group(self, axis):
        """The process group of the named axes: the default group (None)
        for every axis of the mesh in the mesh's order (the axis tuple of
        the JAX package's multi-pod runtime), this rank's subgroup for one
        axis.  Raises ``ValueError`` for names the mesh lacks or any other
        subset."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        if names == self.axis_names:
            return None
        if len(names) == 1 and names[0] in self.axis_groups:
            return self.axis_groups[names[0]]
        raise ValueError(f"axes {names} of a mesh with axes "
                         f"{self.axis_names}: name every axis in order, "
                         "or one")


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """The :class:`Mesh` of ``shape`` over the default group, whose size
    must be the shape's product.  Every rank calls it (``new_group`` is
    collective): one subgroup for each line of each axis, in the same
    order on every rank."""
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"{len(shape)} dims for axes {axis_names}")
    size = dist.get_world_size()
    if int(np.prod(shape)) != size:
        raise ValueError(f"a mesh of shape {shape} over a group of {size} "
                         "ranks")
    ranks = np.arange(size).reshape(shape)
    axis_groups = {}
    for ax, name in enumerate(axis_names):
        for line in np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax]):
            sub = dist.new_group([int(r) for r in line])
            if dist.get_rank() in line:
                axis_groups[name] = sub
    return Mesh(shape, axis_names, axis_groups)


# ---------------------------------------------------------------------------
# The transformer zoo's DeviceMesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of axis names and sizes with no devices or group behind it
    (``jax.sharding.AbstractMesh``): enough for the sharding rules, which
    read only ``shape`` and ``mesh_dim_names`` (as a ``DeviceMesh`` has
    them)."""
    shape: tuple
    mesh_dim_names: tuple


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or :class:`AbstractMesh`
    (the reference's ``dict(mesh.shape)``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def make_device_mesh(shape: Sequence[int], axis_names: Sequence[str],
                     device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` over the default group, ranks laid out
    row-major (every rank calls it).  ``device_type`` defaults to
    ``"cuda"`` where CUDA is available, else ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(int(n) for n in shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """The reference's production mesh over the process group that is up:
    ``(16, 16)`` as ``("data", "model")``, or ``(2, 16, 16)`` as ``("pod",
    "data", "model")`` with ``multi_pod`` (the ``pod`` axis extends data
    parallelism, or sequence sharding for long context).  Raises when the
    group is smaller than the mesh; the dry run brings up a ``fake`` group
    of 256 or 512 ranks first."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks but the process group has {have}; "
            "the dry run must init_process_group('fake', world_size="
            f"{n}) first")
    if have != n:
        raise RuntimeError(f"mesh {shape} over a group of {have} ranks: the "
                           "mesh must cover the group")
    return make_device_mesh(shape, axes, device_type)


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes that shard tokens (everything except 'model')."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


class HW:
    """Per-card constants of one NVIDIA H100 80GB HBM3 (SXM) at its 700 W
    limit (``nvidia-smi --query-gpu=name,power.limit``: "NVIDIA H100 80GB
    HBM3, 700.00 W"), from NVIDIA's data sheet, for the roofline terms.  A
    card set below 700 W runs slower under load."""
    PEAK_BF16_FLOPS = 989e12     # FLOP/s, dense bf16 tensor cores
    HBM_BW = 3.35e12             # B/s
    LINK_BW = 450e9              # B/s, NVLink 4, one direction per card
    HBM_GIB = 80e9 / 2 ** 30     # 80 GB of HBM3
