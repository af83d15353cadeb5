"""Wrapper of the ``chase`` CUDA kernel (``csrc/chase.cu``).

Counterpart of ``mioc_tpu.ops.backtrack_pallas`` (kernel ``_bt_kernel``).  The
source note in ``chase.cu`` says what bounds the kernel and what its design
does about it.  :func:`chase` takes CUDA tensors only: it checks device,
dtype, shape and contiguity, allocates the output with ``torch.empty``,
launches on the current stream and raises if the launch failed.  It never
falls back to the plain version (``bellman.backtrack_plain``).  The level
lookup ``levels[level_idx]`` stays a torch index in ``bellman.backtrack``
(the TPU kernel's one-hot ``_levels_at`` worked around a TPU gather).
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["chase"]


def _fn():
    from ._kernels import library

    fn = library("chase").mioc_chase
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chase(U, phi0, btilde, B_new: int):
    """Launch the chase; returns ``level_idx (nt,)`` int32 on the card."""
    if phi0.device.type != "cuda":
        raise ValueError(f"chase takes CUDA tensors, got {phi0.device}")
    L, B1 = phi0.shape
    nt = btilde.shape[0]
    if phi0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"phi0 must be float32 or float64, got {phi0.dtype}")
    if U.dtype not in (torch.int8, torch.int32):
        raise TypeError(f"U must be int8 or int32, got {U.dtype}")
    if btilde.dtype != torch.int32:
        raise TypeError(f"btilde must be int32, got {btilde.dtype}")
    if U.shape != (nt - 1, L, B1) or btilde.shape != (nt, L):
        raise ValueError(f"shapes: U {tuple(U.shape)}, phi0 {tuple(phi0.shape)}, "
                         f"btilde {tuple(btilde.shape)}")
    for name, t in (("U", U), ("phi0", phi0), ("btilde", btilde)):
        if t.device != phi0.device:
            raise ValueError(f"{name} is on {t.device}, phi0 on {phi0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty(nt, dtype=torch.int32, device=phi0.device)
    with torch.cuda.device(phi0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(phi0.data_ptr(), btilde.data_ptr(), U.data_ptr(),
                    out.data_ptr(), nt, L, B1 - 1, int(B_new),
                    phi0.element_size(), U.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"chase launch failed: CUDA error {err}")
    chase.launches += 1
    return out


chase.launches = 0
