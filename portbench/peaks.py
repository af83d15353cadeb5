"""Published H100 peaks and the work of each DP kernel call.

A frozen copy of ``chip_smoke.py`` at commit 04297e7: the peaks and
``bound`` (``chip_smoke.py:228-231, 334-337``) and the bytes and operations
each kernel's inputs need (``chip_smoke.py:405-417, 659-672, 744-748``).
Bytes count each input read once and each output written once; operations
count the relaxations the data needs (an output ``(i, l, b)`` whose budget
shift is feasible relaxes L successors: L adds and L − 1 compares, plus its
stage add; any other output only adds its stage cost to +inf).
"""

from __future__ import annotations

import numpy as np

# One H100 SXM (NVIDIA data sheet, dense, at 700 W): HBM bandwidth, and the
# rates outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}

# Substrings of the device kernels' symbols that the DP wrappers launch
# (``csrc/dp_build.cuh``, ``csrc/chase_chunked.cuh``, ``csrc/chase_vec.cu``).
DP_KERNEL_SYMBOLS = ("dp_build_kernel", "chunked_chase_kernel", "chase_vec_kernel")


def bound_s(nbytes: int, ops: int, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over the
    bandwidth and the operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype])


def _valid(btilde, B: int, smax: int) -> int:
    """Outputs whose budget shift is feasible, over the steps a build relaxes."""
    s = np.asarray(btilde)[..., :-1, :].astype(np.int64)
    return int(np.where(s <= min(smax, B), np.clip(B + 1 - s, 0, None), 0).sum())


def build_work(btilde, L: int, B: int, smax: int, ds: int, us: int):
    """``(bytes, ops)`` of one build over ``btilde (S, nt, L)`` (S = 1 for
    the single build): stage and b̃ read, the jump table once, U and phi0
    written."""
    S, nt = btilde.shape[0], btilde.shape[1]
    valid = _valid(btilde, B, smax)
    total = S * (nt - 1) * L * (B + 1)
    ops = valid * 2 * L + (total - valid)
    nbytes = S * (nt * L * (ds + 4) + (nt - 1) * L * (B + 1) * us + L * (B + 1) * ds) \
        + L * L * ds
    return nbytes, ops


def chase_work(nt: int, L: int, B: int, ds: int, us: int, sets: int, rows: int):
    """``(bytes, ops)`` of a chase of ``rows`` paths over ``sets`` table
    sets: each set's phi0 plane once (the seeds' masked argmins), then one U
    and one b̃ entry per step and path, the path's indices and its cap."""
    nbytes = sets * L * (B + 1) * ds + rows * ((nt - 1) * (us + 4) + nt * 4 + 4)
    ops = rows * (L * (B + 1) + (nt - 1))
    return nbytes, ops


def call_work(name: str, args):
    """``(bytes, ops, dtype)`` of one call of a DP kernel wrapper with the
    arguments it was called with (``ops/bellman_cuda.py``,
    ``ops/backtrack_cuda.py``)."""
    if name in ("dp_build", "dp_build_batched"):
        stage, btilde, _, B, smax = args[:5]
        bt = btilde.cpu().numpy()
        bt = bt[None] if bt.ndim == 2 else bt
        L = stage.shape[-1]
        us = 1 if L <= 127 else 4          # the successor table's int8 or int32
        nbytes, ops = build_work(bt, L, int(B), int(smax), stage.element_size(), us)
        return nbytes, ops, str(stage.dtype).replace("torch.", "")
    U, phi0, btilde, caps = args[:4]
    L, B1 = phi0.shape[-2], phi0.shape[-1]
    nt = btilde.shape[-2]
    if name in ("chase", "chase_vec"):
        sets, rows = 1, 1
    elif name == "chase_batched":          # tables expanded with stride 0 are one set
        rows = phi0.shape[0]
        sets = 1 if phi0.stride(0) == 0 else rows
    elif name == "chase_trials":
        sets, rows = caps.shape[0], caps.shape[0] * caps.shape[1]
    else:
        raise ValueError(f"unknown DP kernel wrapper {name!r}")
    nbytes, ops = chase_work(nt, L, B1 - 1, phi0.element_size(), U.element_size(), sets, rows)
    return nbytes, ops, str(phi0.dtype).replace("torch.", "")
