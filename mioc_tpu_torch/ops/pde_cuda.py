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
shape and layout, allocates the output with ``torch.empty`` and launches
through :mod:`._kernels`, which takes the current stream, raises if the
launch failed and counts the launch in ``dense_sweep.launches``.
"""

from __future__ import annotations

import torch

from . import _kernels
from ._kernels import I, P

__all__ = ["dense_sweep", "dense_fits", "group_rows", "smem_bytes", "CLUSTER", "SPAN",
           "THREADS", "MAX_ROWS", "MAX_SMEM"]

CLUSTER = 16  # CTAs of a row group (kCluster)
THREADS = 256  # threads of a CTA, one per (span, column pair) at most (kThreads)
SPAN = 40  # terms of a dot product a thread holds, for two columns (kSpan)
MAX_ROWS = 14  # rows of a group, at most (kMaxRows)
MAX_SPANS = 14  # spans of a dot product, at most (kMaxSpans)
MAX_SMEM = 232_448  # dynamic shared memory one block may take on sm_90 (227 KB)

# The C entries (csrc/pde_dense.cu): the sweep's argument types (its symbol
# mioc_pde_dense_sweep_{f64,f32}), the stream last; the cluster query, the
# count's pointer last.
_SWEEP_ARGS = (P,) * 4 + (I,) * 5 + (P,)
_QUERY = ("pde_dense", "mioc_pde_dense_clusters", (I,) * 3 + (P,))
_KERNELS = "the dense sweep kernels"


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
    if torch.device(device).type != "cuda" or dtype not in _kernels.SUFFIX or N < 1:
        return False
    CW, NS = _shape(N)
    return (NS <= MAX_SPANS and NS * CW // 2 <= THREADS and MAX_ROWS * CW // 2 <= THREADS
            and smem_bytes(N, dtype.itemsize, MAX_ROWS) <= MAX_SMEM)


def group_rows(R: int, N: int, dtype: torch.dtype, device) -> int:
    """The rows of a group for a sweep of R rows: the fewest (at most 14)
    such that the card holds all ⌈R / rows⌉ clusters at once.  The bits do
    not depend on it."""
    held = _kernels.clusters_held(_kernels.device_index(device), _QUERY, N, dtype.itemsize,
                                  MAX_ROWS)
    if held < 1:
        raise RuntimeError(f"mioc_pde_dense_clusters(N={N}): the card holds no cluster")
    return min(MAX_ROWS, -(-R // held))


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
    sfx = _kernels.suffix(drive, _KERNELS)
    _kernels.check("drive", drive, drive.dtype, kernels=_KERNELS)
    nt, R, N = drive.shape
    dtype, device = drive.dtype, drive.device
    if R < 1 or not dense_fits(N, dtype, device):
        raise ValueError(f"the dense sweep kernel does not take R={R}, N={N} in {dtype}")
    _kernels.check("op", op, dtype, (N, N), device)
    if v_end is not None:
        _kernels.check("v_end", v_end, dtype, (N,), device)
    out = torch.empty((nt + 1, R, N), dtype=dtype, device=device)
    _kernels.launch(dense_sweep, "dense_sweep",
                    ("pde_dense", f"mioc_pde_dense_sweep_{sfx}", _SWEEP_ARGS), device,
                    None if v_end is None else v_end.data_ptr(),
                    drive.data_ptr() if nt else None, op.data_ptr(), out.data_ptr(), N, nt, R,
                    group_rows(R, N, dtype, device), int(bool(reverse)))
    return out


dense_sweep.launches = 0
