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
import functools
from typing import NamedTuple

import torch

from .bellman import u_dtype

__all__ = ["dp_build", "dp_build_batched", "build_plan", "smem_bytes", "BuildPlan",
           "MAX_SMEM_BYTES"]

MAX_SMEM_BYTES = 232448  # dynamic shared memory one H100 block may use
MAX_THREADS = 1024  # threads of one block
JUMP_REGS = 8  # L ≤ 8: each thread holds its jump row in registers
TPL_ALIGN = 16  # float64 planes beyond one block: tpl a multiple of a half-warp


class BuildPlan(NamedTuple):
    """Launch plan of one build block (``csrc/dp_build.cuh``).

    ``R``: stage/b̃ rows per ring chunk (``nt - 1`` when all fit at once, 0
    to read the rows in place); ``jsmem``: the jump table in shared memory
    (else registers for L ≤ 8, or the read-only cache); ``tpl``: threads per
    level combination; ``K``: outputs per thread; ``threads``: the block
    (compute warps and the staging warp); ``smem``: dynamic shared bytes."""

    R: int
    jsmem: bool
    tpl: int
    K: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=None)
def _fn(lib_name: str, symbol: str, n_int: int):
    """The C entry point: five pointers, ``n_int`` ints, the stream (typed
    once)."""
    from ._kernels import library

    fn = getattr(library(lib_name), symbol)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ring_chunks(nt: int, R: int) -> int:
    steps = nt - 1
    return -(-steps // R) if steps > 0 and R > 0 else 0


def smem_bytes(nt: int, L: int, B: int, itemsize: int, R: int, jsmem: bool) -> int:
    """Shared memory of one build block, as ``dp_smem_bytes`` in
    ``csrc/dp_build.cuh`` lays it out: the Φ double buffer, the jump table
    when ``jsmem``, and the ring of stage and b̃ rows (two buffers of ``R``
    rows when the sweep takes more than one chunk, else one)."""
    nbuf = 2 if _ring_chunks(nt, R) > 1 else 1
    return (2 * L * (B + 1) * itemsize + (L * L * itemsize if jsmem else 0)
            + (nbuf * R * L * (itemsize + 4) if R > 0 else 0))


def build_plan(nt: int, L: int, B: int, itemsize: int) -> BuildPlan:
    """The launch plan for one build block of ``(nt, L, B)`` at ``itemsize``
    (4 or 8).

    Ring: all nt-1 rows when they fit beside Φ (and the jump table for
    L > 8); else the most rows that fit twice; else the jump table leaves
    shared memory for the read-only cache.  A shape where not even that
    fits, but the first kernel's layout did (Φ and the jump table in shared
    memory, rows read from device memory), reads the rows in place: only
    L ≤ 2 at the edge of the limit.  Other shapes raise ``ValueError``, as
    does L > 992.

    Threads: the fewest outputs per thread K such that each level
    combination's B+1 budgets take ``tpl`` threads and all of them, rounded
    to warps, plus the staging warp fit in one block.  A float64 plane with
    more outputs than one block has threads rounds ``tpl`` up to a multiple
    of :data:`TPL_ALIGN`, so that each half-warp's Φ column loads read one
    level combination's consecutive budgets, free of bank conflicts
    (``python -m mioc_tpu_torch.profile_kernels`` times the build with and
    without it)."""
    B1 = B + 1
    base = 2 * L * B1 * itemsize
    if base > MAX_SMEM_BYTES:
        raise ValueError(f"L={L}, B={B} needs {base} B of shared memory for Φ at "
                         f"{itemsize} bytes per value; one block has {MAX_SMEM_BYTES}")
    if L > MAX_THREADS - 32:
        raise ValueError(f"L={L}: the build takes at most {MAX_THREADS - 32} level "
                         f"combinations (one thread each at least)")
    steps = max(nt - 1, 0)
    row = L * (itemsize + 4)
    jsmem = L > JUMP_REGS
    jb = L * L * itemsize if jsmem else 0
    if steps == 0:
        R = 0
        jsmem = jsmem and base + jb <= MAX_SMEM_BYTES
    elif base + jb + steps * row <= MAX_SMEM_BYTES:
        R = steps
    elif base + jb + 2 * row <= MAX_SMEM_BYTES:
        R = (MAX_SMEM_BYTES - base - jb) // (2 * row)
    elif jsmem and base + 2 * row <= MAX_SMEM_BYTES:
        jsmem = False
        R = (MAX_SMEM_BYTES - base) // (2 * row)
    elif (2 * L * B1 + L * L) * itemsize <= MAX_SMEM_BYTES:
        R, jsmem = 0, False
    else:
        raise ValueError(f"L={L}, B={B} at {itemsize} bytes per value: Φ leaves no "
                         f"room in shared memory ({MAX_SMEM_BYTES} B) for two ring rows")
    align = TPL_ALIGN if itemsize == 8 and L * B1 > MAX_THREADS - 32 else 1
    K = 1
    while True:
        tpl = -(-B1 // K)
        if tpl > align // 2:
            tpl = -(-tpl // align) * align
        threads = -(-L * tpl // 32) * 32 + 32
        if threads <= MAX_THREADS:
            break
        K += 1
    return BuildPlan(R, jsmem, tpl, K, threads, smem_bytes(nt, L, B, itemsize, R, jsmem))


def _check(stage, btilde, jump_cost, B: int, lead: tuple):
    """Checks common to both builds; returns ``(nt, L, plan)``."""
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
    return nt, L, build_plan(nt, L, B, stage.element_size())


def dp_build(stage, btilde, jump_cost, B: int, smax: int):
    """Launch the DP build; returns ``(U (nt-1, L, B+1), phi0 (L, B+1))`` with
    ``U`` of :func:`~.bellman.u_dtype` and ``phi0`` of ``stage``'s dtype."""
    nt, L, plan = _check(stage, btilde, jump_cost, B, ())
    U = torch.empty((nt - 1, L, B + 1), dtype=u_dtype(L), device=stage.device)
    phi0 = torch.empty((L, B + 1), dtype=stage.dtype, device=stage.device)
    with torch.cuda.device(stage.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("dp_build", "mioc_dp_build", 10)(
            stage.data_ptr(), btilde.data_ptr(), jump_cost.data_ptr(), U.data_ptr(),
            phi0.data_ptr(), nt, L, B, min(smax, B), plan.R, int(plan.jsmem), plan.tpl,
            plan.K, stage.element_size(), U.element_size(), stream)
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
    nt, L, plan = _check(stage, btilde, jump_cost, B, (S,))
    U = torch.empty((S, nt - 1, L, B + 1), dtype=u_dtype(L), device=stage.device)
    phi0 = torch.empty((S, L, B + 1), dtype=stage.dtype, device=stage.device)
    with torch.cuda.device(stage.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("dp_build_batched", "mioc_dp_build_batched", 11)(
            stage.data_ptr(), btilde.data_ptr(), jump_cost.data_ptr(), U.data_ptr(),
            phi0.data_ptr(), S, nt, L, B, min(smax, B), plan.R, int(plan.jsmem),
            plan.tpl, plan.K, stage.element_size(), U.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"dp_build_batched launch failed: CUDA error {err}")
    dp_build_batched.launches += 1
    return U, phi0


dp_build_batched.launches = 0
