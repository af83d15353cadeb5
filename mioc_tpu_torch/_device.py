"""Device and dtype defaults of the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``.  There is no fallback: a CUDA request on a machine without
CUDA raises, so a solve never runs on the CPU by accident.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "resolve_dtype"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise ``RuntimeError`` if CUDA is requested and
    not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (it is the default device) but is not "
            "available; pass device='cpu' to run on the CPU."
        )
    return dev


def resolve_dtype(dtype=None) -> torch.dtype:
    """``None`` → float64 (the reference's precision; the H100 has native
    FP64).  ``torch.float32`` stays selectable."""
    dt = torch.float64 if dtype is None else dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dt}")
    return dt
