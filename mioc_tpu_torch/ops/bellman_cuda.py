"""Wrappers of the DP build CUDA kernels.

* :func:`dp_build` — ``csrc/dp_build.cu``, counterpart of
  ``mioc_tpu.ops.bellman_pallas._dp_kernel``: one start;
* :func:`dp_build_batched` — ``csrc/dp_build_batched.cu``, counterpart of
  ``_dp_kernel_batched``: S starts that share one jump table.

Both launch the kernel body of ``csrc/dp_build.cuh``, whose note says what
bounds it and what its design does about it.  Each wrapper takes CUDA
tensors only: it checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the current stream and raises if
the launch failed.  Neither falls back to the plain versions
(``bellman.build_tables_plain``, ``bellman.build_tables_batched_plain``).
"""

from __future__ import annotations

import ctypes

import torch

from .bellman import u_dtype

__all__ = ["dp_build", "dp_build_batched", "MAX_SMEM_BYTES"]

MAX_SMEM_BYTES = 232448  # dynamic shared memory one H100 block may use


def _fn(lib_name: str, symbol: str, n_int: int):
    """The C entry point: five pointers, ``n_int`` ints, the stream."""
    from ._kernels import library

    fn = getattr(library(lib_name), symbol)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(L: int, B: int, itemsize: int) -> int:
    """Shared memory of one build (one block): Φ double buffer plus the jump
    table."""
    return (2 * L * (B + 1) + L * L) * itemsize


def _check(stage, btilde, jump_cost, B: int, lead: tuple):
    """Checks common to both builds; returns ``(nt, L)``."""
    if stage.device.type != "cuda":
        raise ValueError(f"the DP build kernels take CUDA tensors, got {stage.device}")
    if stage.dim() != len(lead) + 2:
        raise ValueError(f"shapes: stage {tuple(stage.shape)}")
    nt, L = stage.shape[-2:]
    if stage.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stage must be float32 or float64, got {stage.dtype}")
    if jump_cost.dtype != stage.dtype:
        raise TypeError("jump_cost must have stage's dtype")
    if btilde.dtype != torch.int32:
        raise TypeError(f"btilde must be int32, got {btilde.dtype}")
    if btilde.shape != (*lead, nt, L) or jump_cost.shape != (L, L):
        raise ValueError(f"shapes: stage {tuple(stage.shape)}, btilde "
                         f"{tuple(btilde.shape)}, jump {tuple(jump_cost.shape)}")
    for name, t in (("stage", stage), ("btilde", btilde), ("jump", jump_cost)):
        if t.device != stage.device:
            raise ValueError(f"{name} is on {t.device}, stage on {stage.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nt < 1 or L < 1 or B < 0:
        raise ValueError(f"need nt ≥ 1, L ≥ 1, B ≥ 0 (got {nt}, {L}, {B})")
    smem = smem_bytes(L, B, stage.element_size())
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"L={L}, B={B} needs {smem} B of shared memory in "
                         f"{stage.dtype}; one block has {MAX_SMEM_BYTES}")
    return nt, L


def _threads(L: int, B: int) -> int:
    return min(1024, -(-L * (B + 1) // 32) * 32)


def dp_build(stage, btilde, jump_cost, B: int, smax: int):
    """Launch the DP build; returns ``(U (nt-1, L, B+1), phi0 (L, B+1))`` with
    ``U`` of :func:`~.bellman.u_dtype` and ``phi0`` of ``stage``'s dtype."""
    nt, L = _check(stage, btilde, jump_cost, B, ())
    U = torch.empty((nt - 1, L, B + 1), dtype=u_dtype(L), device=stage.device)
    phi0 = torch.empty((L, B + 1), dtype=stage.dtype, device=stage.device)
    with torch.cuda.device(stage.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("dp_build", "mioc_dp_build", 7)(
            stage.data_ptr(), btilde.data_ptr(), jump_cost.data_ptr(), U.data_ptr(),
            phi0.data_ptr(), nt, L, B, min(smax, B), stage.element_size(),
            U.element_size(), _threads(L, B), stream)
    if err != 0:
        raise RuntimeError(f"dp_build launch failed: CUDA error {err}")
    dp_build.launches += 1
    return U, phi0


dp_build.launches = 0


def dp_build_batched(stage, btilde, jump_cost, B: int, smax: int):
    """Launch the batched DP build (one block per start): ``stage``/``btilde``
    ``(S, nt, L)`` and the shared ``jump_cost (L, L)`` give ``U (S, nt-1, L,
    B+1)`` and ``phi0 (S, L, B+1)``; start ``s`` equals :func:`dp_build` of
    that start."""
    S = stage.shape[0] if stage.dim() == 3 else -1
    nt, L = _check(stage, btilde, jump_cost, B, (S,))
    U = torch.empty((S, nt - 1, L, B + 1), dtype=u_dtype(L), device=stage.device)
    phi0 = torch.empty((S, L, B + 1), dtype=stage.dtype, device=stage.device)
    with torch.cuda.device(stage.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("dp_build_batched", "mioc_dp_build_batched", 8)(
            stage.data_ptr(), btilde.data_ptr(), jump_cost.data_ptr(), U.data_ptr(),
            phi0.data_ptr(), S, nt, L, B, min(smax, B), stage.element_size(),
            U.element_size(), _threads(L, B), stream)
    if err != 0:
        raise RuntimeError(f"dp_build_batched launch failed: CUDA error {err}")
    dp_build_batched.launches += 1
    return U, phi0


dp_build_batched.launches = 0
