"""Wrappers of the chase CUDA kernels.

* :func:`chase` — ``csrc/chase.cu``, counterpart of
  ``mioc_tpu.ops.backtrack_pallas._bt_kernel``: one start, one cap, walked
  as a chunked chase of state maps over many blocks (:func:`chase_plan`);
* :func:`chase_vec` — ``csrc/chase_vec.cu``, counterpart of
  ``_bt_kernel_vec`` (``MIOC_CHASE=vec``): the same function as
  :func:`chase`, in one thread-block cluster that holds the table in its
  distributed shared memory (:func:`vec_plan`);
* :func:`chase_batched` — ``csrc/chase_batched.cu``, counterpart of
  ``_bt_kernel_batched``: S starts, a cap per start, the chunked chase of
  :func:`chase` with one set of state maps per table set;
* :func:`chase_trials` — ``csrc/chase_trials.cu``, counterpart of
  ``_bt_kernel_trials``: Kt caps per start against that start's tables, the
  chunked chase over S table sets of Kt rows each.

The source notes say what bounds each kernel and what its design does about
it.  Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
layout, allocates the output with ``torch.empty`` and launches through
:mod:`._kernels`, which takes the current stream and raises if the launch
failed.  None falls back to the plain
versions (``bellman.backtrack_plain`` and its batched forms).  A cap may be a
Python int or an int32 tensor on the card, which the kernel reads from device
memory, so the device TRM never reads a budget back to the host.  The level
lookup ``levels[level_idx]`` stays a torch index in ``bellman`` (the TPU
kernel's one-hot ``_levels_at`` worked around a TPU gather).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _kernels
from ._kernels import LL, I, P

__all__ = ["chase", "chase_plan", "ChasePlan", "chase_vec", "vec_plan", "VecPlan",
           "cluster_plan", "chase_batched", "table_sets", "chase_trials", "MAX_TRIALS"]

MAX_TRIALS = 128  # caps per start the trial-wave kernel takes
CHASE_CHUNKS = 32  # chunks per table set the chunked chase aims at
CHASE_TASKS = 256  # (set, chunk) tasks it aims at over many table sets
CHASE_SMEM_BYTES = 200 * 1024  # dynamic shared memory of one staged chunk
VEC_CLUSTERS = (16, 8)  # cluster sizes chase_vec takes, the first that fits
VEC_SUBCHUNK_STEPS = 16  # steps per sub-chunk chase_vec aims at where the table fits

# The C entries (csrc/*.cu): library, symbol, argument types (the stream or the
# count's pointer last).
_CHASE = ("chase", "mioc_chase", (P,) * 6 + (I,) * 9 + (P,))
_VEC = ("chase_vec", "mioc_chase_vec", (P,) * 6 + (I,) * 13 + (P,))
_VEC_QUERY = ("chase_vec", "mioc_chase_vec_clusters", (I,) * 10 + (P,))
_BATCHED = ("chase_batched", "mioc_chase_batched",
            (P,) * 6 + (I,) * 8 + (LL,) * 3 + (I,) * 2 + (P,))
_TRIALS = ("chase_trials", "mioc_chase_trials", (P,) * 6 + (I,) * 10 + (P,))
_KERNELS = "the chase kernels"


def _check_tables(U, phi0, btilde, batched: bool, contiguous: bool = True):
    """Types, devices, shapes and, where asked, contiguity of one table set
    (``batched=False``) or of S table sets; returns ``(nt, L, B)``."""
    _kernels.check("phi0", phi0, (torch.float32, torch.float64), contiguous=contiguous,
                   kernels=_KERNELS)
    lead = phi0.shape[:1] if batched else ()
    if phi0.dim() != len(lead) + 2:
        raise ValueError(f"shapes: phi0 {tuple(phi0.shape)}")
    L, B1 = phi0.shape[-2:]
    nt = btilde.shape[-2]
    _kernels.check("U", U, (torch.int8, torch.int32), (*lead, nt - 1, L, B1), phi0.device,
                   contiguous)
    _kernels.check("btilde", btilde, torch.int32, (*lead, nt, L), phi0.device, contiguous)
    return nt, L, B1 - 1


def _caps(B, shape, device) -> torch.Tensor:
    """Budget caps as a contiguous int32 tensor of ``shape`` on ``device``
    (an int32 tensor already there is used as it is, with no host read)."""
    if (isinstance(B, torch.Tensor) and B.dtype == torch.int32 and B.shape == shape
            and B.device == device and B.is_contiguous()):
        return B
    return torch.as_tensor(B, dtype=torch.int32, device=device).expand(shape).contiguous()


def _single(U, phi0, btilde, B_new):
    """Checks of one start's tables and its cap; returns ``(nt, L, B, cap
    tensor on the card or None, cap int)``."""
    nt, L, B = _check_tables(U, phi0, btilde, batched=False)
    if isinstance(B_new, torch.Tensor):
        return nt, L, B, _caps(B_new, (), phi0.device), 0
    return nt, L, B, None, int(B_new)


class ChasePlan(NamedTuple):
    """Plan of the chunked chase (``csrc/chase_chunked.cuh``): ``C`` chunks
    of ``T`` steps per table set (``C·T ≥ nt-1``), U planes ``staged`` in
    shared memory or read in place, ``smem`` dynamic shared bytes of one
    chunk, ``scratch`` int32 entries (the state maps ``E (G, C, P)``, the
    entry states ``(R, C)``, ``first_bad (R,)``)."""

    C: int
    T: int
    staged: bool
    smem: int
    scratch: int


def chase_plan(nt: int, L: int, B: int, u_bytes: int, sets: int = 1,
               rows: int = 1) -> ChasePlan:
    """Chunks of the chunked chase for ``(nt, L, B)``, U of ``u_bytes``,
    ``sets`` table sets and ``rows`` chased rows: :data:`CHASE_CHUNKS` chunks
    per set, fewer where many sets already fill the card (about
    :data:`CHASE_TASKS` tasks in all, never below one chunk per set), with T
    shrunk until T planes and T b̃ rows fit :data:`CHASE_SMEM_BYTES` as
    ``chunk_smem`` in ``csrc/chase_chunked.cuh`` lays them out
    (round16(T·plane + 16) + 4·T·L bytes); where not even one plane fits, the
    planes are read in place.  No shape is refused."""
    return _chase_plan(nt, L, B, u_bytes, sets, rows, CHASE_CHUNKS, CHASE_TASKS,
                       CHASE_SMEM_BYTES)


@functools.lru_cache(maxsize=1024)
def _chase_plan(nt, L, B, u_bytes, sets, rows, chunks_per_set, tasks, budget) -> ChasePlan:
    P = L * (B + 1)
    steps = nt - 1
    plane = P * u_bytes

    def smem(t: int) -> int:
        return _round16(t * plane + 16) + 4 * t * L

    if steps <= 0:
        return ChasePlan(0, 1, False, 0, rows)
    chunks = max(1, min(chunks_per_set, -(-tasks // sets)))
    T = -(-steps // chunks)
    staged = smem(1) <= budget
    if staged:
        T = min(T, max(1, (budget - 32) // (plane + 4 * L)))
        while smem(T) > budget:
            T -= 1
    C = -(-steps // T)
    return ChasePlan(C, T, staged, smem(T) if staged else 0, sets * C * P + rows * C + rows)


def chase(U, phi0, btilde, B_new):
    """Launch the chunked chase of one start; ``B_new`` is an int or a 0-d
    int32 tensor on the card.  Returns ``level_idx (nt,)`` int32 on the
    card."""
    nt, L, B, B_dev, B_int = _single(U, phi0, btilde, B_new)
    plan = chase_plan(nt, L, B, U.element_size())
    out = torch.empty(nt, dtype=torch.int32, device=phi0.device)
    scratch = torch.empty(plan.scratch, dtype=torch.int32, device=phi0.device)
    _kernels.launch(chase, "chase", _CHASE, phi0.device, phi0.data_ptr(), btilde.data_ptr(),
                    U.data_ptr(), None if B_dev is None else B_dev.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), nt, L, B, B_int, plan.T, plan.C, int(plan.staged),
                    phi0.element_size(), U.element_size())
    return out


chase.launches = 0


def _round16(n: int) -> int:
    return -(-n // 16) * 16


class VecPlan(NamedTuple):
    """Plan of the cluster chase (``csrc/chase_vec.cu``): a cluster of ``N``
    CTAs; CTA i takes slices i, N+i, … of ``Ts`` steps in ``Q`` rounds
    (``N·Q·Ts ≥ nt-1``), each slice cut into ``W`` sub-chunks of ``Tw``
    steps; the slice ``staged`` in shared memory or read in place; the state
    maps in shared memory (``maps_in_smem``: the sub-chunks' and, for W > 1,
    the slice's) or, one per slice, in ``scratch`` int32 entries of device
    memory (``N·Q·P``); ``smem`` dynamic shared bytes of a CTA
    (``vec_layout`` in the source)."""

    N: int
    Q: int
    Ts: int
    W: int
    Tw: int
    staged: bool
    maps_in_smem: bool
    smem: int
    scratch: int


def vec_plan(nt: int, L: int, B: int, u_bytes: int, cluster: int,
             subchunk_steps: int = None) -> VecPlan:
    """The cluster chase's plan for ``(nt, L, B)``, U of ``u_bytes`` and a
    cluster of ``cluster`` CTAs, within :data:`CHASE_SMEM_BYTES` of dynamic
    shared memory per CTA:

    * the table fits the cluster: one slice per CTA, cut into sub-chunks of
      about ``subchunk_steps`` (default :data:`VEC_SUBCHUNK_STEPS`) steps, at
      most 32 (a walking warp each), fewer where their maps would not fit;
      the maps in shared memory (fishing, conv);
    * it does not: as many steps per slice as fit, in rounds, one sub-chunk
      per slice, the maps in device memory (heat scale);
    * not even one plane fits: one slice per CTA read in place, the maps in
      device memory.

    No shape is refused."""
    N = cluster
    P = L * (B + 1)
    steps = nt - 1
    plane = P * u_bytes

    def smem(Ts, W, Q, staged, maps_in_smem):
        maps = 4 * W * P + (4 * P if W > 1 else 0) if maps_in_smem else 0
        return (_round16(Ts * plane + 16) + 4 * Ts * L if staged else 0) + maps + 4 * Q

    if steps <= 0:  # no step: no slice, no map
        return VecPlan(N, 1, 1, 1, 1, False, False, smem(1, 1, 1, False, False), 0)
    Ts = -(-steps // N)
    target = VEC_SUBCHUNK_STEPS if subchunk_steps is None else subchunk_steps
    W = min(32, Ts, -(-Ts // target))
    while W > 1 and smem(Ts, W, 1, True, True) > CHASE_SMEM_BYTES:
        W -= 1
    if smem(Ts, W, 1, True, True) <= CHASE_SMEM_BYTES:
        return VecPlan(N, 1, Ts, W, -(-Ts // W), True, True, smem(Ts, W, 1, True, True), 0)
    if smem(1, 1, -(-steps // N), True, False) <= CHASE_SMEM_BYTES:
        Ts = max(1, (CHASE_SMEM_BYTES - 64) // (plane + 4 * L))
        while smem(Ts, 1, -(-steps // (N * Ts)), True, False) > CHASE_SMEM_BYTES:
            Ts -= 1
        Q = -(-steps // (N * Ts))
        Ts = -(-steps // (N * Q))  # the same rounds, the steps spread evenly
        return VecPlan(N, Q, Ts, 1, Ts, True, False, smem(Ts, 1, Q, True, False), N * Q * P)
    return VecPlan(N, 1, Ts, 1, Ts, False, False, smem(Ts, 1, 1, False, False), N * P)


@functools.lru_cache(maxsize=256)
def _cluster_plan(nt: int, L: int, B: int, u_bytes: int, dtype_bytes: int, index: int,
                  clusters: tuple, subchunk_steps: int) -> VecPlan:
    """The plan of the first cluster size in ``clusters`` whose clusters the
    card can hold at that plan's shared memory
    (``cudaOccupancyMaxActiveClusters``); raises if none fits."""
    tried = []
    for N in clusters:
        plan = vec_plan(nt, L, B, u_bytes, N, subchunk_steps)
        if _kernels.clusters_held(index, _VEC_QUERY, L, B, N, plan.Q, plan.Ts, plan.W,
                                  int(plan.staged), int(plan.maps_in_smem), dtype_bytes,
                                  u_bytes) > 0:
            return plan
        tried.append((N, plan.smem))
    raise RuntimeError(f"chase_vec: no cluster of (CTAs, shared bytes) {tried} fits on "
                       "this card")


def cluster_plan(U, phi0) -> VecPlan:
    """The plan :func:`chase_vec` launches for the tables ``U (nt-1, L,
    B+1)`` and ``phi0 (L, B+1)`` on their card: :func:`vec_plan` at the first
    size of :data:`VEC_CLUSTERS` that the card schedules."""
    L, B1 = phi0.shape[-2:]
    return _cluster_plan(U.shape[-3] + 1, L, B1 - 1, U.element_size(), phi0.element_size(),
                         _kernels.device_index(phi0.device), VEC_CLUSTERS, VEC_SUBCHUNK_STEPS)


def chase_vec(U, phi0, btilde, B_new):
    """Launch the cluster chase of one start (``MIOC_CHASE=vec``): the same
    arguments and result as :func:`chase`, bit for bit."""
    nt, L, B, B_dev, B_int = _single(U, phi0, btilde, B_new)
    plan = cluster_plan(U, phi0)
    out = torch.empty(nt, dtype=torch.int32, device=phi0.device)
    maps = (torch.empty(plan.scratch, dtype=torch.int32, device=phi0.device)
            if plan.scratch else None)
    _kernels.launch(chase_vec, "chase_vec", _VEC, phi0.device, phi0.data_ptr(),
                    btilde.data_ptr(), U.data_ptr(), None if B_dev is None else B_dev.data_ptr(),
                    out.data_ptr(), None if maps is None else maps.data_ptr(), nt, L, B, B_int,
                    plan.N, plan.Q, plan.Ts, plan.W, plan.Tw, int(plan.staged),
                    int(plan.maps_in_smem), phi0.element_size(), U.element_size())
    return out


chase_vec.launches = 0


def _start_stride(name, t) -> int:
    """The start-axis stride of ``t`` in elements: each start's slice must be
    contiguous, and the stride is its size (a contiguous batch) or 0 (one
    table set expanded over the starts, read in place)."""
    shape, stride = t.shape, t.stride()
    size = 1  # the size of one start's slice, or -1 where it is not contiguous
    for n, st in zip(reversed(shape[1:]), reversed(stride[1:])):
        if n != 1 and st != size:
            size = -1
        size = n * size if size >= 0 else -1
    if 0 in shape[1:]:
        size = 0  # an empty slice is contiguous
    if size < 0 or stride[0] not in (0, size):
        raise ValueError(f"{name} must be contiguous per start, with a start stride of "
                         f"0 or {t[0].numel()} (got {stride})")
    return stride[0]


def table_sets(U, phi0, btilde):
    """``(sp, sb, su, G)``: the start-axis strides of ``phi0``, ``btilde`` and
    ``U`` (:func:`_start_stride`) and the number of table sets whose state
    maps the batched chase builds.  The maps depend on U and b̃ only, so G is
    1 where both have stride 0 (one set read by every start, whatever phi0's
    stride) and S otherwise."""
    sp, sb, su = (_start_stride(n, t) for n, t in (("phi0", phi0), ("btilde", btilde),
                                                    ("U", U)))
    return sp, sb, su, 1 if sb == 0 and su == 0 else phi0.shape[0]


def chase_batched(U, phi0, btilde, B_new):
    """Launch S chases, start ``s`` at cap ``B_new[s]`` (an int32 ``(S,)``
    tensor on the card, or an int or sequence).  The tables ``U (S, nt-1, L,
    B+1)``, ``phi0 (S, L, B+1)`` and ``btilde (S, nt, L)`` may be expanded
    along the start axis (stride 0): the trial wave of a single solve chases
    K caps against one table set with no copy.  Where U and btilde both have
    stride 0 the kernel builds the state maps of that one set once for every
    start; otherwise each start has its own.  Returns ``level_idx (S, nt)``
    int32 on the card."""
    nt, L, B = _check_tables(U, phi0, btilde, batched=True, contiguous=False)
    S = phi0.shape[0]
    sp, sb, su, G = table_sets(U, phi0, btilde)
    plan = chase_plan(nt, L, B, U.element_size(), sets=G, rows=S)
    caps = _caps(B_new, (S,), phi0.device)
    out = torch.empty((S, nt), dtype=torch.int32, device=phi0.device)
    scratch = torch.empty(plan.scratch, dtype=torch.int32, device=phi0.device)
    _kernels.launch(chase_batched, "chase_batched", _BATCHED, phi0.device, phi0.data_ptr(),
                    btilde.data_ptr(), U.data_ptr(), caps.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), S, G, nt, L, B, plan.T, plan.C, int(plan.staged), sp,
                    sb, su, phi0.element_size(), U.element_size())
    return out


chase_batched.launches = 0


def chase_trials(U, phi0, btilde, B_trials):
    """Launch the trial wave: ``B_trials (S, Kt)`` caps (int32 on the card,
    Kt ≤ 128) against each start's tables ``U (S, nt-1, L, B+1)``, ``phi0
    (S, L, B+1)``, ``btilde (S, nt, L)``: the chunked chase over S table
    sets of Kt rows each, one set of state maps per start for all its caps.
    Returns ``level_idx (S, Kt, nt)`` int32 on the card; row ``(s, t)`` is
    :func:`chase` of start ``s`` at ``B_trials[s, t]``."""
    nt, L, B = _check_tables(U, phi0, btilde, batched=True)
    S = phi0.shape[0]
    caps = torch.as_tensor(B_trials, dtype=torch.int32, device=phi0.device)
    if caps.dim() != 2 or caps.shape[0] != S:
        raise ValueError(f"B_trials must be (S={S}, Kt), got {tuple(caps.shape)}")
    Kt = caps.shape[1]
    if not 1 <= Kt <= MAX_TRIALS:
        raise ValueError(f"the trial-wave chase takes 1 to {MAX_TRIALS} caps per "
                         f"start, got {Kt}")
    caps = caps.contiguous()
    plan = chase_plan(nt, L, B, U.element_size(), sets=S, rows=S * Kt)
    out = torch.empty((S, Kt, nt), dtype=torch.int32, device=phi0.device)
    scratch = torch.empty(plan.scratch, dtype=torch.int32, device=phi0.device)
    _kernels.launch(chase_trials, "chase_trials", _TRIALS, phi0.device, phi0.data_ptr(),
                    btilde.data_ptr(), U.data_ptr(), caps.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), S, Kt, nt, L, B, plan.T, plan.C, int(plan.staged),
                    phi0.element_size(), U.element_size())
    return out


chase_trials.launches = 0
