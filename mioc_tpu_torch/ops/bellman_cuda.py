"""Wrapper of the ``dp_build`` CUDA kernel (``csrc/dp_build.cu``).

Counterpart of ``mioc_tpu.ops.bellman_pallas`` (kernel ``_dp_kernel``).  The
source note in ``dp_build.cu`` says what bounds the kernel and what its design
does about it.  :func:`dp_build` takes CUDA tensors only: it checks device,
dtype, shape and contiguity, allocates the outputs with ``torch.empty``,
launches on the current stream and raises if the launch failed.  It never
falls back to the plain version (``bellman.build_tables_plain``).
"""

from __future__ import annotations

import ctypes

import torch

from .bellman import u_dtype

__all__ = ["dp_build", "MAX_SMEM_BYTES"]

MAX_SMEM_BYTES = 232448  # dynamic shared memory one H100 block may use


def _fn():
    from ._kernels import library

    fn = library("dp_build").mioc_dp_build
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def smem_bytes(L: int, B: int, itemsize: int) -> int:
    """Shared memory of one build: Φ double buffer plus the jump table."""
    return (2 * L * (B + 1) + L * L) * itemsize


def dp_build(stage, btilde, jump_cost, B: int, smax: int):
    """Launch the DP build; returns ``(U (nt-1, L, B+1), phi0 (L, B+1))`` with
    ``U`` of :func:`~.bellman.u_dtype` and ``phi0`` of ``stage``'s dtype."""
    if stage.device.type != "cuda":
        raise ValueError(f"dp_build takes CUDA tensors, got {stage.device}")
    nt, L = stage.shape
    if stage.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stage must be float32 or float64, got {stage.dtype}")
    if jump_cost.dtype != stage.dtype:
        raise TypeError("jump_cost must have stage's dtype")
    if btilde.dtype != torch.int32:
        raise TypeError(f"btilde must be int32, got {btilde.dtype}")
    if btilde.shape != (nt, L) or jump_cost.shape != (L, L):
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
    udt = u_dtype(L)
    U = torch.empty((nt - 1, L, B + 1), dtype=udt, device=stage.device)
    phi0 = torch.empty((L, B + 1), dtype=stage.dtype, device=stage.device)
    threads = min(1024, -(-L * (B + 1) // 32) * 32)
    with torch.cuda.device(stage.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(stage.data_ptr(), btilde.data_ptr(), jump_cost.data_ptr(),
                    U.data_ptr(), phi0.data_ptr(), nt, L, B, min(smax, B),
                    stage.element_size(), U.element_size(), threads, stream)
    if err != 0:
        raise RuntimeError(f"dp_build launch failed: CUDA error {err}")
    dp_build.launches += 1
    return U, phi0


dp_build.launches = 0
