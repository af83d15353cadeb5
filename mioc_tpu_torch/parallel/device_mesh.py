"""Device meshes over ``torch.distributed`` ranks.

Counterpart of ``mioc_tpu.parallel.device_mesh``.  The JAX package runs one
process over a ``Mesh`` of ``jax.devices()`` and partitions work with
``shard_map``.  PyTorch runs one process per rank, each the same program
(SPMD), with collectives over process groups, so the names map as follows:

* a JAX device is a rank;
* ``mesh.shape["level"]`` is the mesh's size along ``"level"``, and
  ``lax.axis_index("level")`` is :meth:`Mesh.coord` of this rank;
* ``lax.all_gather(x, "level")`` is :meth:`Mesh.all_gather`, a
  ``torch.distributed.all_gather`` on this rank's ``"level"`` group.

The axes carry

* ``batch`` — scenario/multistart data parallelism (each rank holds a block
  of the starts);
* ``level`` — the partition of the DP's successor-combination contraction
  axis (:mod:`.shard_dp`).

A caller that has initialized no process group gets a world of one
(:func:`ensure_world`): a single-rank group over a ``HashStore``, with no
network, so a sharded solve runs in one process as the JAX call does on one
device.  More ranks come from :func:`~.multihost.init_multihost` (or
``torchrun``) before the mesh is made.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_device_mesh", "ensure_world", "default_level_mesh"]

AXES = ("batch", "level")


class Mesh:
    """A ``(batch, level)`` grid of ranks with one process group along each
    axis through this rank.  ``devices`` is the grid of ranks (the JAX
    mesh's device array), ``shape`` maps an axis name to its size."""

    def __init__(self, devices: np.ndarray, groups: dict):
        self.devices = devices
        self.axis_names = AXES
        self.shape = dict(zip(AXES, devices.shape))
        self._groups = groups
        where = np.argwhere(devices == dist.get_rank())
        self._coords = dict(zip(AXES, map(int, where[0]))) if len(where) else None

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (``lax.axis_index``)."""
        if self._coords is None:
            raise ValueError(f"rank {dist.get_rank()} is not in {self!r}")
        return self._coords[axis]

    def all_gather(self, tensor: torch.Tensor, axis: str) -> torch.Tensor:
        """Every rank's ``tensor`` along ``axis``, stacked in coordinate
        order: ``(D, *tensor.shape)`` (``lax.all_gather``).  The tensors stay
        where they are: gloo takes CUDA tensors as well as CPU ones."""
        self.coord(axis)
        out = [torch.empty_like(tensor) for _ in range(self.shape[axis])]
        dist.all_gather(out, tensor.contiguous(), group=self._groups[axis])
        return torch.stack(out)


def ensure_world(device_type: str = None) -> int:
    """The world size, after making a world of one if no process group is
    initialized: a single-rank group over a ``HashStore`` (no network), with
    NCCL for ``device_type="cuda"`` (the default) and gloo for the CPU."""
    if not dist.is_initialized():
        backend = "gloo" if (device_type or "cuda") == "cpu" else "nccl"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def make_device_mesh(batch: int = None, level: int = 1, devices=None,
                     device_type: str = None) -> Mesh:
    """Create a ``(batch, level)`` mesh over ``devices``, a list of ranks
    (default: the whole world).  ``batch=None`` puts all remaining ranks on
    the batch axis.  ``device_type`` (``"cuda"`` by default, ``"cpu"``) is
    where the mesh's tensors will live: it picks the backend of the world of
    one that a process without a process group gets.

    Every rank of the world must call this with the same arguments: making
    the axis groups is collective.  A rank outside ``devices`` gets the
    mesh but no coordinate in it."""
    world = ensure_world(device_type)
    devices = list(devices if devices is not None else range(world))
    n = len(devices)
    if batch is None:
        if n % level:
            raise ValueError(f"{n} devices not divisible by level={level}")
        batch = n // level
    if batch * level > n:
        raise ValueError(f"mesh {batch}x{level} exceeds {n} devices")
    arr = np.array(devices[: batch * level]).reshape(batch, level)
    rank = dist.get_rank()
    groups = {}
    # One group per row (a "level" group) and per column (a "batch" group),
    # made in the same order on every rank.
    for axis, lines in (("level", arr), ("batch", arr.T)):
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh(arr, groups)


_DEFAULT: dict = {}


def default_level_mesh(device_type: str = None) -> Mesh:
    """The solvers' default mesh for ``dp_backend="sharded"``: every rank of
    the world on the ``level`` axis (``make_device_mesh(batch=1,
    level=world)``).  Made once per process and device type, so repeated
    solves add no process groups; every rank asks for it at the same points
    of the same program, so all of them take the same branch."""
    device_type = device_type or "cuda"
    world = ensure_world(device_type)
    world_group, mesh = _DEFAULT.get(device_type, (None, None))
    if world_group is not dist.group.WORLD:  # none yet, or another world since
        mesh = make_device_mesh(batch=1, level=world, device_type=device_type)
        _DEFAULT[device_type] = (dist.group.WORLD, mesh)
    return mesh
