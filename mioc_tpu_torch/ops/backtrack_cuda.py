"""Wrappers of the chase CUDA kernels.

* :func:`chase` — ``csrc/chase.cu``, counterpart of
  ``mioc_tpu.ops.backtrack_pallas._bt_kernel``: one start, one cap, walked
  as a chunked chase of state maps over many blocks (:func:`chase_plan`);
* :func:`chase_vec` — ``csrc/chase_vec.cu``, counterpart of
  ``_bt_kernel_vec`` (``MIOC_CHASE=vec``): the same function as
  :func:`chase`, walked by one warp with broadcast state on U planes staged
  in shared memory;
* :func:`chase_batched` — ``csrc/chase_batched.cu``, counterpart of
  ``_bt_kernel_batched``: S starts, a cap per start;
* :func:`chase_trials` — ``csrc/chase_trials.cu``, counterpart of
  ``_bt_kernel_trials``: Kt caps per start against that start's tables.

The source notes say what bounds each kernel and what its design does about
it.  Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
layout, allocates the output with ``torch.empty``, launches on the current
stream and raises if the launch failed.  None falls back to the plain
versions (``bellman.backtrack_plain`` and its batched forms).  A cap may be a
Python int or an int32 tensor on the card, which the kernel reads from device
memory, so the device TRM never reads a budget back to the host.  The level
lookup ``levels[level_idx]`` stays a torch index in ``bellman`` (the TPU
kernel's one-hot ``_levels_at`` worked around a TPU gather).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

__all__ = ["chase", "chase_plan", "ChasePlan", "chase_vec", "vec_chunk",
           "chase_batched", "chase_trials", "MAX_TRIALS"]

MAX_TRIALS = 128  # caps per start the trial-wave kernel takes
CHASE_CHUNKS = 32  # chunks the chunked chase aims at
CHASE_SMEM_BYTES = 200 * 1024  # dynamic shared memory of one staged chunk
VEC_SMEM_BYTES = 160 * 1024  # dynamic shared memory chase_vec may stage into
VEC_MAX_CHUNK = 64  # time steps per staged chunk of chase_vec

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _fn(lib_name: str, symbol: str, argtypes: tuple):
    """The C entry point, typed once (the chases launch thousands of times
    in one solve)."""
    from ._kernels import library

    fn = getattr(library(lib_name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _check_tables(U, phi0, btilde, batched: bool):
    """Types, devices and shapes of one table set (``batched=False``) or of
    S table sets; returns ``(nt, L, B)``."""
    if phi0.device.type != "cuda":
        raise ValueError(f"the chase kernels take CUDA tensors, got {phi0.device}")
    if phi0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"phi0 must be float32 or float64, got {phi0.dtype}")
    if U.dtype not in (torch.int8, torch.int32):
        raise TypeError(f"U must be int8 or int32, got {U.dtype}")
    if btilde.dtype != torch.int32:
        raise TypeError(f"btilde must be int32, got {btilde.dtype}")
    lead = phi0.shape[:1] if batched else ()
    if phi0.dim() != len(lead) + 2:
        raise ValueError(f"shapes: phi0 {tuple(phi0.shape)}")
    L, B1 = phi0.shape[-2:]
    nt = btilde.shape[-2]
    if U.shape != (*lead, nt - 1, L, B1) or btilde.shape != (*lead, nt, L):
        raise ValueError(f"shapes: U {tuple(U.shape)}, phi0 {tuple(phi0.shape)}, "
                         f"btilde {tuple(btilde.shape)}")
    for name, t in (("U", U), ("btilde", btilde)):
        if t.device != phi0.device:
            raise ValueError(f"{name} is on {t.device}, phi0 on {phi0.device}")
    return nt, L, B1 - 1


def _caps(B, shape, device) -> torch.Tensor:
    """Budget caps as a contiguous int32 tensor of ``shape`` on ``device``
    (an int32 tensor already there is used as it is, with no host read)."""
    return torch.as_tensor(B, dtype=torch.int32, device=device).expand(shape).contiguous()


def _single(U, phi0, btilde, B_new):
    """Checks of one start's tables and its cap; returns ``(nt, L, B, cap
    tensor on the card or None, cap int)``."""
    nt, L, B = _check_tables(U, phi0, btilde, batched=False)
    for name, t in (("U", U), ("phi0", phi0), ("btilde", btilde)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if isinstance(B_new, torch.Tensor):
        return nt, L, B, _caps(B_new, (), phi0.device), 0
    return nt, L, B, None, int(B_new)


class ChasePlan(NamedTuple):
    """Plan of the chunked chase (``csrc/chase.cu``): ``C`` chunks of ``T``
    steps (``C·T ≥ nt-1``), U planes ``staged`` in shared memory or read in
    place, ``smem`` dynamic shared bytes of one chunk, ``scratch`` int32
    entries (the state maps ``E (C, P)``, the entry states, a flag)."""

    C: int
    T: int
    staged: bool
    smem: int
    scratch: int


def chase_plan(nt: int, L: int, B: int, u_bytes: int) -> ChasePlan:
    """Chunks of the chunked chase for ``(nt, L, B)`` and U of ``u_bytes``:
    about :data:`CHASE_CHUNKS` chunks, with T shrunk until T planes and T b̃
    rows fit :data:`CHASE_SMEM_BYTES` as ``chunk_smem`` in ``csrc/chase.cu``
    lays them out (round16(T·plane + 16) + 4·T·L bytes); where not even one
    plane fits, the planes are read in place.  No shape is refused."""
    P = L * (B + 1)
    steps = nt - 1
    plane = P * u_bytes

    def smem(t: int) -> int:
        return _round16(t * plane + 16) + 4 * t * L

    if steps <= 0:
        return ChasePlan(0, 1, False, 0, 1)
    T = -(-steps // CHASE_CHUNKS)
    staged = smem(1) <= CHASE_SMEM_BYTES
    if staged:
        T = min(T, max(1, (CHASE_SMEM_BYTES - 32) // (plane + 4 * L)))
        while smem(T) > CHASE_SMEM_BYTES:
            T -= 1
    C = -(-steps // T)
    return ChasePlan(C, T, staged, smem(T) if staged else 0, C * P + C + 1)


def chase(U, phi0, btilde, B_new):
    """Launch the chunked chase of one start; ``B_new`` is an int or a 0-d
    int32 tensor on the card.  Returns ``level_idx (nt,)`` int32 on the
    card."""
    nt, L, B, B_dev, B_int = _single(U, phi0, btilde, B_new)
    plan = chase_plan(nt, L, B, U.element_size())
    out = torch.empty(nt, dtype=torch.int32, device=phi0.device)
    scratch = torch.empty(plan.scratch, dtype=torch.int32, device=phi0.device)
    fn = _fn("chase", "mioc_chase", tuple([_P] * 6 + [_I] * 9 + [_P]))
    with torch.cuda.device(phi0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(phi0.data_ptr(), btilde.data_ptr(), U.data_ptr(),
                 None if B_dev is None else B_dev.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), nt, L, B, B_int, plan.T, plan.C, int(plan.staged),
                 phi0.element_size(), U.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"chase launch failed: CUDA error {err}")
    chase.launches += 1
    return out


chase.launches = 0


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def vec_chunk(nt: int, L: int, B: int, u_bytes: int) -> int:
    """Time steps per staged chunk of :func:`chase_vec`: the largest K up to
    ``VEC_MAX_CHUNK`` whose shared layout in ``csrc/chase_vec.cu`` (two U
    buffers of K planes with 16 bytes of alignment slack, two b̃ buffers of K
    rows) fits ``VEC_SMEM_BYTES``; a plane too large for that raises."""
    plane = L * (B + 1) * u_bytes
    K = min(VEC_MAX_CHUNK, max(nt - 1, 1))
    while K > 0 and 2 * _round16(K * plane + 16) + 2 * K * L * 4 > VEC_SMEM_BYTES:
        K -= 1
    if K == 0:
        raise ValueError(f"chase_vec: one U plane of L={L}, B={B} ({plane} B) does not "
                         f"fit twice in {VEC_SMEM_BYTES} B of shared memory")
    return K


def chase_vec(U, phi0, btilde, B_new):
    """Launch the warp-broadcast chase of one start (``MIOC_CHASE=vec``): the
    same arguments and result as :func:`chase`, bit for bit."""
    nt, L, B, B_dev, B_int = _single(U, phi0, btilde, B_new)
    K = vec_chunk(nt, L, B, U.element_size())
    out = torch.empty(nt, dtype=torch.int32, device=phi0.device)
    fn = _fn("chase_vec", "mioc_chase_vec", tuple([_P] * 5 + [_I] * 7 + [_P]))
    with torch.cuda.device(phi0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(phi0.data_ptr(), btilde.data_ptr(), U.data_ptr(),
                 None if B_dev is None else B_dev.data_ptr(), out.data_ptr(),
                 nt, L, B, B_int, K, phi0.element_size(), U.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"chase_vec launch failed: CUDA error {err}")
    chase_vec.launches += 1
    return out


chase_vec.launches = 0


def _start_stride(name, t) -> int:
    """The start-axis stride of ``t`` in elements: each start's slice must be
    contiguous, and the stride is its size (a contiguous batch) or 0 (one
    table set expanded over the starts, read in place)."""
    one = t[0]
    if not one.is_contiguous() or t.stride(0) not in (0, one.numel()):
        raise ValueError(f"{name} must be contiguous per start, with a start "
                         f"stride of 0 or {one.numel()} (got {t.stride()})")
    return t.stride(0)


def chase_batched(U, phi0, btilde, B_new):
    """Launch S chases, start ``s`` at cap ``B_new[s]`` (an int32 ``(S,)``
    tensor on the card, or an int or sequence).  The tables ``U (S, nt-1, L,
    B+1)``, ``phi0 (S, L, B+1)`` and ``btilde (S, nt, L)`` may be expanded
    along the start axis (stride 0): the trial wave of a single solve chases
    K caps against one table set with no copy.  Returns ``level_idx (S,
    nt)`` int32 on the card."""
    nt, L, B = _check_tables(U, phi0, btilde, batched=True)
    S = phi0.shape[0]
    strides = [_start_stride(n, t) for n, t in (("phi0", phi0), ("btilde", btilde),
                                                ("U", U))]
    caps = _caps(B_new, (S,), phi0.device)
    out = torch.empty((S, nt), dtype=torch.int32, device=phi0.device)
    fn = _fn("chase_batched", "mioc_chase_batched",
             tuple([_P] * 5 + [_I] * 4 + [_LL] * 3 + [_I] * 2 + [_P]))
    with torch.cuda.device(phi0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(phi0.data_ptr(), btilde.data_ptr(), U.data_ptr(), caps.data_ptr(),
                 out.data_ptr(), S, nt, L, B, *strides, phi0.element_size(),
                 U.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"chase_batched launch failed: CUDA error {err}")
    chase_batched.launches += 1
    return out


chase_batched.launches = 0


def chase_trials(U, phi0, btilde, B_trials):
    """Launch the trial wave: ``B_trials (S, Kt)`` caps (int32 on the card,
    Kt ≤ 128) against each start's tables ``U (S, nt-1, L, B+1)``, ``phi0
    (S, L, B+1)``, ``btilde (S, nt, L)``.  Returns ``level_idx (S, Kt, nt)``
    int32 on the card; row ``(s, t)`` is :func:`chase` of start ``s`` at
    ``B_trials[s, t]``."""
    nt, L, B = _check_tables(U, phi0, btilde, batched=True)
    for name, t in (("U", U), ("phi0", phi0), ("btilde", btilde)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    S = phi0.shape[0]
    caps = torch.as_tensor(B_trials, dtype=torch.int32, device=phi0.device)
    if caps.dim() != 2 or caps.shape[0] != S:
        raise ValueError(f"B_trials must be (S={S}, Kt), got {tuple(caps.shape)}")
    Kt = caps.shape[1]
    if not 1 <= Kt <= MAX_TRIALS:
        raise ValueError(f"the trial-wave chase takes 1 to {MAX_TRIALS} caps per "
                         f"start, got {Kt}")
    caps = caps.contiguous()
    out = torch.empty((S, Kt, nt), dtype=torch.int32, device=phi0.device)
    fn = _fn("chase_trials", "mioc_chase_trials", tuple([_P] * 5 + [_I] * 7 + [_P]))
    with torch.cuda.device(phi0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(phi0.data_ptr(), btilde.data_ptr(), U.data_ptr(), caps.data_ptr(),
                 out.data_ptr(), S, Kt, nt, L, B, phi0.element_size(),
                 U.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"chase_trials launch failed: CUDA error {err}")
    chase_trials.launches += 1
    return out


chase_trials.launches = 0
