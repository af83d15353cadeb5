"""Wrappers of the DP build CUDA kernel (``csrc/dp_build_batched.cu``).

* :func:`dp_build` — counterpart of ``mioc_tpu.ops.bellman_pallas._dp_kernel``:
  one start, the batched entry at S = 1 (a ``(nt-1, L, B+1)`` U is laid out
  as a ``(1, nt-1, L, B+1)`` one): one block where the plan takes C = 1
  (fishing, conv: every L ≤ 8), else one thread-block cluster of C CTAs
  split along the budget axis (heat500: C = 16, 7 budgets a CTA), which
  the cluster barrier and the halo pushes bound (~2 µs a step on an H100);
* :func:`dp_build_batched` — counterpart of ``_dp_kernel_batched``: S
  starts that share one jump table, one block per start or, where
  :func:`batched_build_plan` takes C > 1, one cluster of C CTAs per start.

Both launch the kernel body of ``csrc/dp_build.cuh`` under the plan of
:func:`cluster_build_plan`; its note says what bounds the body and what its
design does about it.  Each wrapper takes CUDA tensors only: it checks
device, dtype, shape and contiguity, allocates the outputs with
``torch.empty`` and launches through :mod:`._kernels`, which takes the
current stream and raises if the launch failed.  Neither falls back to the
plain versions (``bellman.build_tables_plain``,
``bellman.build_tables_batched_plain``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..utils import trace
from . import _kernels
from ._kernels import I, P
from .bellman import u_dtype

__all__ = ["dp_build", "dp_build_batched", "build_plan", "smem_bytes", "BuildPlan",
           "batched_build_plan", "BatchedBuildPlan", "cluster_build_plan",
           "clusters_at_once", "MAX_SMEM_BYTES", "MAX_CLUSTER"]

MAX_SMEM_BYTES = 232448  # dynamic shared memory one H100 block may use
MAX_THREADS = 1024  # threads of one block
JUMP_REGS = 8  # L ≤ 8: each thread holds its jump row in registers
TPL_ALIGN = 16  # float64 planes beyond one block: tpl a multiple of a half-warp
MAX_CLUSTER = 16  # CTAs of one cluster (above 8 a non-portable size)
SMS = 132  # streaming multiprocessors of one H100 SXM
CLUSTER_MIN_RELAX = 32768  # relaxations L·L·(B+1) of a step that take a cluster

# The C entries (csrc/*.cu): library, symbol, argument types (the stream or the
# count's pointer last).
_BATCHED = ("dp_build_batched", "mioc_dp_build_batched", (P,) * 5 + (I,) * 13 + (P,))
_BATCHED_QUERY = ("dp_build_batched", "mioc_dp_build_batched_clusters", (I,) * 13 + (P,))
_KERNELS = "the DP build kernels"


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


def _ring_chunks(nt: int, R: int) -> int:
    steps = nt - 1
    return -(-steps // R) if steps > 0 and R > 0 else 0


def smem_bytes(nt: int, L: int, B: int, itemsize: int, R: int, jsmem: bool,
               row: int = None) -> int:
    """Shared memory of one build block, as ``dp_smem_bytes`` in
    ``csrc/dp_build.cuh`` lays it out: the Φ double buffer (rows of ``row``
    entries, default B+1), the jump table when ``jsmem``, and the ring of
    stage and b̃ rows (two buffers of ``R`` rows when the sweep takes more
    than one chunk, else one)."""
    nbuf = 2 if _ring_chunks(nt, R) > 1 else 1
    row = B + 1 if row is None else row
    return (2 * L * row * itemsize + (L * L * itemsize if jsmem else 0)
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
    return _block_plan(nt, L, B, B + 1, B + 1, itemsize)


def _block_plan(nt: int, L: int, B: int, width: int, phi_row: int,
                itemsize: int) -> BuildPlan:
    """:func:`build_plan` for a block that owns ``width`` budgets of each
    level combination and keeps Φ rows of ``phi_row`` entries (B+1 and B+1
    for one block per start; a slice and its halo in a cluster)."""
    base = 2 * L * phi_row * itemsize
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
    elif base + L * L * itemsize <= MAX_SMEM_BYTES:
        R, jsmem = 0, False
    else:
        raise ValueError(f"L={L}, B={B} at {itemsize} bytes per value: Φ leaves no "
                         f"room in shared memory ({MAX_SMEM_BYTES} B) for two ring rows")
    align = TPL_ALIGN if itemsize == 8 and L * width > MAX_THREADS - 32 else 1
    K = 1
    while True:
        tpl = -(-width // K)
        if tpl > align // 2:
            tpl = -(-tpl // align) * align
        threads = -(-L * tpl // 32) * 32 + 32
        if threads <= MAX_THREADS:
            break
        K += 1
    return BuildPlan(R, jsmem, tpl, K, threads,
                     smem_bytes(nt, L, B, itemsize, R, jsmem, phi_row))


class BatchedBuildPlan(NamedTuple):
    """Launch plan of the batched build (``csrc/dp_build_batched.cu``): ``C``
    CTAs per start (1: one block per start, an ordinary launch; more: one
    thread-block cluster per start), each owning a budget slice of at most
    ``width`` budgets with ``H`` halo budgets below it, and the block plan
    of :class:`BuildPlan` for that slice (``R``, ``jsmem``, ``tpl``, ``K``,
    ``threads``, ``smem``)."""

    C: int
    width: int
    H: int
    R: int
    jsmem: bool
    tpl: int
    K: int
    threads: int
    smem: int


def batched_build_plan(S: int, nt: int, L: int, B: int, itemsize: int, smax: int = None,
                       clusters: int = None) -> BatchedBuildPlan:
    """The launch plan of the batched build of ``S`` starts of ``(nt, L, B)``
    at ``itemsize`` (4 or 8), with per-step budget use at most ``smax``
    (default B).

    ``clusters`` forces C (1 … min(MAX_CLUSTER, B+1)).  Otherwise the rule,
    from ``python -m mioc_tpu_torch.profile_kernels``'s sweep of C (PERF.md):
    one block per start where a step's relaxations L·L·(B+1) are fewer than
    :data:`CLUSTER_MIN_RELAX` (fishing and conv: there a cluster barrier,
    ~0.65 µs a step more than the block's on an H100, costs more than the
    split saves); else the largest C ≤
    min(MAX_CLUSTER, B+1) whose S·C CTAs fit the card's :data:`SMS` at one
    per SM, or 1 where not even C = 2 does.  :func:`cluster_build_plan`
    lowers that C further to what the card holds at once.

    With C > 1, CTA k owns the budgets [⌊k(B+1)/C⌋, ⌊(k+1)(B+1)/C⌋) and a
    halo of H = min(smax, B) budgets below them; the block plan is
    :func:`build_plan`'s for that slice, and a shape whose ring would not
    fit raises ``ValueError``."""
    B1 = B + 1
    H = B if smax is None else min(smax, B)
    if clusters is None:
        C = 1
        if L * L * B1 >= CLUSTER_MIN_RELAX:
            C = min(MAX_CLUSTER, B1, SMS // S)
            C = C if C >= 2 else 1
    else:
        C = int(clusters)
        if not 1 <= C <= min(MAX_CLUSTER, B1):
            raise ValueError(f"clusters={C}: the build takes 1 to "
                             f"{min(MAX_CLUSTER, B1)} CTAs per start at B={B}")
    if C == 1:
        return BatchedBuildPlan(1, B1, 0, *build_plan(nt, L, B, itemsize))
    width = -(-B1 // C)
    plan = _block_plan(nt, L, B, width, H + width, itemsize)
    if plan.R == 0 and nt > 1:
        raise ValueError(f"L={L}, B={B}: the cluster build stages its rows; two ring "
                         f"rows do not fit beside Φ")
    return BatchedBuildPlan(C, width, H, *plan)


def _check(stage, btilde, jump_cost, B: int, lead: tuple):
    """Checks common to both builds; returns ``(nt, L)``."""
    _kernels.check("stage", stage, (torch.float32, torch.float64), kernels=_KERNELS)
    if stage.dim() != len(lead) + 2:
        raise ValueError(f"shapes: stage {tuple(stage.shape)}")
    nt, L = stage.shape[-2:]
    _kernels.check("btilde", btilde, torch.int32, (*lead, nt, L), stage.device)
    _kernels.check("jump", jump_cost, stage.dtype, (L, L), stage.device)
    if nt < 1 or L < 1 or B < 0:
        raise ValueError(f"need nt ≥ 1, L ≥ 1, B ≥ 0 (got {nt}, {L}, {B})")
    return nt, L


def _build(wrapper, name: str, stage, btilde, jump_cost, B: int, smax: int, lead: tuple,
           clusters: int = None):
    """Check, plan, allocate and launch one build of ``lead`` starts (``()``:
    one start, ``(S,)``: S); returns ``(U, phi0, C)``, C the CTAs per start
    the launch took, which the open ``dp.build`` span records as ``ctas``."""
    nt, L = _check(stage, btilde, jump_cost, B, lead)
    S, smax = lead[0] if lead else 1, min(smax, B)
    plan = cluster_build_plan(S, nt, L, B, stage.element_size(), smax, clusters, stage.device)
    U = torch.empty((*lead, nt - 1, L, B + 1), dtype=u_dtype(L), device=stage.device)
    phi0 = torch.empty((*lead, L, B + 1), dtype=stage.dtype, device=stage.device)
    _kernels.launch(wrapper, name, _BATCHED, stage.device, stage.data_ptr(), btilde.data_ptr(),
                    jump_cost.data_ptr(), U.data_ptr(), phi0.data_ptr(), S, nt, L, B, smax,
                    plan.R, int(plan.jsmem), plan.tpl, plan.K, plan.C, plan.H,
                    stage.element_size(), U.element_size())
    trace.annotate(ctas=plan.C)
    return U, phi0, plan.C


def dp_build(stage, btilde, jump_cost, B: int, smax: int):
    """Launch the DP build; returns ``(U (nt-1, L, B+1), phi0 (L, B+1))`` with
    ``U`` of :func:`~.bellman.u_dtype` and ``phi0`` of ``stage``'s dtype.
    One block, or one cluster of C CTAs where :func:`cluster_build_plan`
    takes C > 1 at S = 1, bit for bit the same; a launch with C > 1 also
    advances ``dp_build.cluster_launches``."""
    U, phi0, C = _build(dp_build, "dp_build", stage, btilde, jump_cost, B, smax, ())
    _SINGLE.cluster_launches += C > 1
    return U, phi0


dp_build.launches = 0
# Counted on the function itself: a tracer that stands in for the module's
# attribute carries ``launches`` only.
dp_build.cluster_launches = 0
_SINGLE = dp_build


@functools.lru_cache(maxsize=256)
def _cluster_build_plan(S, nt, L, B, itemsize, smax, clusters, index) -> BatchedBuildPlan:
    plan = batched_build_plan(S, nt, L, B, itemsize, smax, clusters)
    if clusters is not None:
        if plan.C > 1 and clusters_at_once(S, nt, L, B, itemsize, smax, plan.C, index) < 1:
            raise RuntimeError(f"the DP build: the card schedules no cluster of "
                               f"{plan.C} CTAs with {plan.smem} shared bytes each")
        return plan
    C = plan.C
    while C > 1 and clusters_at_once(S, nt, L, B, itemsize, smax, C, index) < S:
        C -= 1
    return plan if C == plan.C else batched_build_plan(S, nt, L, B, itemsize, smax, C)


def cluster_build_plan(S: int, nt: int, L: int, B: int, itemsize: int, smax: int = None,
                       clusters: int = None, device=None) -> BatchedBuildPlan:
    """The plan :func:`dp_build_batched` (and, at S = 1, :func:`dp_build`)
    launches on ``device`` (default: the current card):
    :func:`batched_build_plan`'s C lowered, one at a time, to the largest C
    whose S clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``; a 16-CTA cluster needs 16 SMs of
    one GPC), or 1 (one block per start) where none does: a start split over
    more CTAs gains nothing once its cluster has to wait for another to
    finish (profile_kernels on an H100 SXM at 700 W: heat scale S=8, 16 CTAs
    in two waves 4.9 ms per call, 8 CTAs in one 4.1).  A forced ``clusters``
    is taken as it is, and raises ``RuntimeError`` where the card schedules
    no such cluster."""
    return _cluster_build_plan(S, nt, L, B, itemsize, B if smax is None else min(smax, B),
                               clusters, _kernels.device_index(device))


def clusters_at_once(S: int, nt: int, L: int, B: int, itemsize: int, smax: int,
                     clusters: int, device=None) -> int:
    """How many clusters of ``clusters`` CTAs of the batched build's plan
    the card holds at once (``cudaOccupancyMaxActiveClusters``; 0: it
    schedules none)."""
    smax = min(smax, B)
    plan = batched_build_plan(S, nt, L, B, itemsize, smax, clusters)
    return _kernels.clusters_held(_kernels.device_index(device), _BATCHED_QUERY, S, nt, L,
                                  B, smax, plan.R, int(plan.jsmem), plan.tpl, plan.K, plan.C,
                                  plan.H, itemsize, u_dtype(L).itemsize)


def dp_build_batched(stage, btilde, jump_cost, B: int, smax: int, clusters: int = None):
    """Launch the batched DP build: ``stage``/``btilde`` ``(S, nt, L)`` and
    the shared ``jump_cost (L, L)`` give ``U (S, nt-1, L, B+1)`` and ``phi0
    (S, L, B+1)``; start ``s`` equals :func:`dp_build` of that start, bit
    for bit.  One block per start, or one cluster of C CTAs per start where
    :func:`cluster_build_plan` takes C > 1 (``clusters`` forces C)."""
    S = stage.shape[0] if stage.dim() == 3 else -1
    return _build(dp_build_batched, "dp_build_batched", stage, btilde, jump_cost, B, smax,
                  (S,), clusters)[:2]


dp_build_batched.launches = 0
