"""Multi-process initialization.

Counterpart of ``mioc_tpu.parallel.multihost``.  Call :func:`init_multihost`
once per process before any device work, then build meshes with
:func:`mioc_tpu_torch.parallel.make_device_mesh`: the world spans every
process, the ``batch`` axis shards scenario work across ranks and the
``level`` axis partitions each DP contraction.  Under ``torchrun`` it needs
no arguments.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["init_multihost", "default_backend"]


def default_backend(local_ranks: int) -> str:
    """The collective transport for ``local_ranks`` processes on this host:
    ``"nccl"`` when CUDA is available and each of them has a GPU of its own,
    ``"gloo"`` otherwise — ranks that share a card (NCCL refuses a
    communicator in which two ranks share a GPU) or no CUDA at all.  The
    choice is made before anything runs; a backend that then fails fails the
    run."""
    if torch.cuda.is_available() and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_multihost(coordinator_address=None, num_processes=None, process_id=None,
                   backend=None):
    """Initialize ``torch.distributed`` for a multi-process run; returns
    ``(rank, world_size)``.

    The arguments are JAX's, plus ``backend``.  Left out, they come from
    ``torchrun``'s environment: ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``
    and ``RANK`` (the counterpart of JAX's auto-detection).
    ``coordinator_address`` is ``"host:port"`` (a TCP rendezvous) or a URL
    that ``init_process_group`` takes (``"tcp://…"``, ``"file:///…"``).
    ``backend=None`` takes :func:`default_backend` of the ranks on this host
    (``LOCAL_WORLD_SIZE``, else all of them); with NCCL each rank takes the
    GPU ``LOCAL_RANK`` (else its rank) modulo the GPU count.

    Safe to call when a process group is already initialized: it returns
    that world, and raises if it is not the one asked for."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if dist.is_initialized():
        if num_processes is not None and num_processes != dist.get_world_size():
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks is already "
                               f"initialized, not {num_processes}")
        return dist.get_rank(), dist.get_world_size()
    missing = [name for name, value, var in (
        ("coordinator_address", coordinator_address, "MASTER_ADDR"),
        ("num_processes", num_processes, "WORLD_SIZE"),
        ("process_id", process_id, "RANK")) if value is None and var not in env]
    if missing:
        raise ValueError(f"outside torchrun, pass {', '.join(missing)}")
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if process_id is None:
        process_id = int(env["RANK"])
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    if backend is None:
        backend = default_backend(int(env.get("LOCAL_WORLD_SIZE", num_processes)))
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, rank=process_id,
                            world_size=num_processes)
    return dist.get_rank(), dist.get_world_size()
