"""Wrapper of the dense PDE sweep kernel (``csrc/pde_dense.cu``).

* :func:`dense_sweep` — the whole recursion of a dense implicit-Euler sweep
  over a batch of rows, all nt steps in one launch;
* :func:`dense_fits` — the one rule for when the kernel serves a sweep.

It replaces no TPU kernel: it is the card's path of
:class:`~mioc_tpu_torch.objectives.pde.PDEObjective`'s dense sweeps, whose
plain version is ``PDEObjective._sweep`` (a Python loop of one add and one
``torch.matmul`` a chunk and step).  Each row's iterates have the bits of
that row's single evaluation (the kernel's sums run in an order fixed by N
alone); they differ from the plain version's by rounding.  The wrapper
takes CUDA tensors of one dtype, float64 or float32, checks device, dtype,
shape and layout, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch failed and counts the launch in
``dense_sweep.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .backtrack_cuda import _fn, _launch

__all__ = ["dense_sweep", "dense_fits", "group_rows", "smem_bytes", "CLUSTER", "SPAN",
           "THREADS", "MAX_ROWS", "MAX_SMEM"]

CLUSTER = 16  # CTAs of a row group (kCluster)
THREADS = 256  # threads of a CTA, one per (span, column pair) at most (kThreads)
SPAN = 40  # terms of a dot product a thread holds, for two columns (kSpan)
MAX_ROWS = 14  # rows of a group, at most (kMaxRows)
MAX_SPANS = 14  # spans of a dot product, at most (kMaxSpans)
MAX_SMEM = 232_448  # dynamic shared memory one block may take on sm_90 (227 KB)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SWEEP_ARGS = (_P,) * 4 + (_I,) * 5 + (_P,)
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}  # the C entries' storage types
_ITEMSIZE = {torch.float64: 8, torch.float32: 4}


def _shape(N: int):
    """``(CW, NS)``: the columns a CTA owns (⌈N/16⌉ rounded up to even) and
    the spans of SPAN terms of a dot product (``csrc/pde_dense.cu::layout``)."""
    cw = -(-N // CLUSTER)
    return cw + cw % 2, -(-(N + N % 2) // SPAN)


def smem_bytes(N: int, itemsize: int, rows: int) -> int:
    """Shared memory of one CTA for groups of ``rows`` rows: the input rows,
    double-buffered, and the spans' partial sums."""
    CW, NS = _shape(N)
    return itemsize * (2 * rows * NS * SPAN + NS * rows * CW)


def dense_fits(N: int, dtype: torch.dtype, device) -> bool:
    """Whether :func:`dense_sweep` serves a dense sweep of N unknowns in
    ``dtype`` on ``device``: a CUDA device, float64 or float32, and N within
    the design (at most 14 spans, a CTA's (span, column pair) pairs within
    its 256 threads, which holds to N = 560, and a group of 14 rows within a
    block's shared memory)."""
    if torch.device(device).type != "cuda" or dtype not in _SUFFIX or N < 1:
        return False
    CW, NS = _shape(N)
    return (NS <= MAX_SPANS and NS * CW // 2 <= THREADS and MAX_ROWS * CW // 2 <= THREADS
            and smem_bytes(N, _ITEMSIZE[dtype], MAX_ROWS) <= MAX_SMEM)


@functools.lru_cache(maxsize=None)
def _clusters(device_index: int, N: int, itemsize: int) -> int:
    """Clusters of the kernel at N (groups of MAX_ROWS rows) that the card
    holds at once."""
    fn = _fn("pde_dense", "mioc_pde_dense_clusters", (_I, _I, _I, ctypes.POINTER(_I)))
    count = _I(0)
    with torch.cuda.device(device_index):
        err = fn(N, itemsize, MAX_ROWS, ctypes.byref(count))
    if err != 0 or count.value < 1:
        raise RuntimeError(f"mioc_pde_dense_clusters(N={N}): CUDA error {err}, "
                           f"{count.value} clusters")
    return count.value


def group_rows(R: int, N: int, dtype: torch.dtype, device) -> int:
    """The rows of a group for a sweep of R rows: the fewest (at most 14)
    such that the card holds all ⌈R / rows⌉ clusters at once.  The bits do
    not depend on it."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    held = _clusters(index, N, _ITEMSIZE[dtype])
    return min(MAX_ROWS, -(-R // held))


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dense_sweep(v_end, drive, op, reverse: bool):
    """The sweep recursion over ``drive (nt, R, N)`` with the operator ``op
    (N, N)``: forward ``v_{k+1} = fl(v_k + drive[k]) @ op`` from ``v_0 =
    v_end``, or (``reverse``) ``v_k = fl(v_{k+1} + drive[k]) @ op`` from
    ``v_nt = v_end``, where ``v_end`` is a row ``(N,)`` for every row or
    ``None`` for 0.  Returns all ``(nt+1, R, N)`` iterates, as
    ``PDEObjective._sweep`` defines them, to rounding; every row with the
    bits of its single evaluation."""
    if drive.dim() != 3:
        raise ValueError(f"drive must be (nt, R, N), got {tuple(drive.shape)}")
    if drive.dtype not in _SUFFIX:
        raise TypeError(f"the dense sweep kernel takes float64 or float32, got {drive.dtype}")
    if drive.device.type != "cuda":
        raise ValueError(f"the dense sweep kernel takes CUDA tensors, got drive on "
                         f"{drive.device}")
    nt, R, N = drive.shape
    dtype, device = drive.dtype, drive.device
    if R < 1 or not dense_fits(N, dtype, device):
        raise ValueError(f"the dense sweep kernel does not take R={R}, N={N} in {dtype}")
    _check("drive", drive, (nt, R, N), dtype, device)
    _check("op", op, (N, N), dtype, device)
    if v_end is not None:
        _check("v_end", v_end, (N,), dtype, device)
    out = torch.empty((nt + 1, R, N), dtype=dtype, device=device)
    fn = _fn("pde_dense", f"mioc_pde_dense_sweep_{_SUFFIX[dtype]}", _SWEEP_ARGS)
    err = _launch(fn, device, None if v_end is None else v_end.data_ptr(),
                  drive.data_ptr() if nt else None, op.data_ptr(), out.data_ptr(), N, nt, R,
                  group_rows(R, N, dtype, device), int(bool(reverse)))
    if err != 0:
        raise RuntimeError(f"dense_sweep launch failed: CUDA error {err}")
    dense_sweep.launches += 1
    return out


dense_sweep.launches = 0
