"""Bellman dynamic program for the TV trust-region subproblem.

Counterpart of ``mioc_tpu.ops.bellman`` (the reference's ``bellman_TRM!`` and
``eval_u_TRM!``, ``HelpFunctions.jl:20-124``).  The subproblem solved exactly
is

    min_u  Σ_i τ·∇f_i·u_i  +  β·TV_p(u)      s.t.  Σ_i ‖u_i − u_old_i‖₁ ≤ B,
                                                    u_i ∈ {ν_0, …, ν_{L−1}}

Each backward time step is a min-plus contraction with a budget shift over
the ``(level combination l, budget b)`` plane:

    tmp[l, b]  = min_j ( Φ_{i+1}[j, b] + jump[l, j] )    (first minimal j)
    Φ_i[l, b]  = stage[i, l] + tmp[l, b − b̃[i, l]]       (+inf where b < b̃,
                                                          or b̃ > smax)

This module holds the PLAIN PyTorch versions and the public wrappers: the
single build and chase (:func:`build_tables`, :func:`backtrack`), and their
batched forms over S starts that share one jump table
(:func:`build_tables_batched`, :func:`backtrack_batched` with a budget per
start, :func:`backtrack_trials` with Kt budgets per start against that
start's tables).  A wrapper takes the plain version only for tensors on the
CPU.  For CUDA tensors it launches the hand-written kernel
(:mod:`.bellman_cuda`, :mod:`.backtrack_cuda`) or raises; it never falls
back.  Budgets may be Python ints or int32 tensors on the tables' device, so
a chase on the card needs no host read of its budget.

Semantics kept from the JAX package (each is what makes the port's paths
bit-identical to the reference's):

* the terminal layer seeds only the exact budget ``b = b̃[nt-1, l]``;
* the contraction's argmin is the FIRST minimal ``j`` (``torch.min`` over the
  ``(l, j, b)`` tensor returns the first occurrence);
* ``U`` is the POST-shift argmin plane; entries with ``b < b̃`` or
  ``b̃ > smax`` hold +inf in Φ and 0 in ``U``;
* the chase seed is the row-major flat argmin of ``Φ_0`` masked to
  ``b ≤ B_new`` — Julia's column-major order: smallest ``l``, then ``b``;
* each chase step looks ``U`` up BEFORE decrementing the budget, and a
  budget below 0 indexes ``U`` as a traced JAX index does (:func:`budget_index`);
* ``B_new`` is a plain runtime argument: a halved trust region re-chases the
  same tables without a rebuild.

``U`` is int8 when ``L ≤ 127`` and int32 otherwise, on both routes, so the
CPU and CUDA paths hand the chase the same tables.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils import trace

__all__ = [
    "stage_tables",
    "max_budget_use",
    "u_dtype",
    "build_tables",
    "build_tables_plain",
    "build_tables_batched",
    "build_tables_batched_plain",
    "backtrack",
    "backtrack_plain",
    "budget_index",
    "chase_kernel_name",
    "backtrack_batched",
    "backtrack_batched_plain",
    "backtrack_trials",
    "backtrack_trials_plain",
    "dp_solve",
]


def stage_tables(grad, u_old, levels, tau):
    """Per-(time, combination) stage cost and budget use.

    stage[..., i, l]  = τ · ∇f_i · ν_l       (``HelpFunctions.jl:34-36, 52-56``)
    btilde[..., i, l] = ‖ν_l − u_old_i‖₁     (integer, ``HelpFunctions.jl:37, 57``)

    ``grad`` and ``u_old`` are ``(nt, M)`` or carry a start axis, ``(S, nt,
    M)``.  The dot over M stays a matmul: the CPU's takes it as the JAX
    package does (a fused multiply-add chain over m), which an elementwise
    order would not reproduce.  The M-term dot of one row is computed
    alone whatever the row count, so start ``s`` of a batch has the bits of
    the single call; the tests hold that on the CPU and ``chip_smoke.py``
    on the card.
    """
    levels = torch.as_tensor(levels, dtype=grad.dtype, device=grad.device)
    stage = tau * (grad @ levels.T)  # (..., nt, L)
    btilde = torch.round(
        (levels - u_old[..., :, None, :]).abs().sum(-1)
    ).to(torch.int32)  # (..., nt, L)
    return stage, btilde


def max_budget_use(levels) -> int:
    """Bound on the per-step budget use: the L¹ diameter of the admissible
    set (both ``u_old`` and all DP iterates are admissible rows)."""
    levels = np.asarray(levels)
    d = np.abs(levels[None, :, :] - levels[:, None, :]).sum(-1)
    return int(round(d.max())) if d.size else 0


def u_dtype(L: int) -> torch.dtype:
    """Element type of the argmin table: int8 holds every index when
    ``L ≤ 127``, else int32."""
    return torch.int8 if L <= 127 else torch.int32


def _build_plain(stage, btilde, jump_cost, B: int, smax):
    """The plain backward recursion over S starts at once: ``stage``/
    ``btilde`` ``(S, nt, L)``, one shared ``jump_cost (L, L)``.  Each step is
    a few small tensor ops on the whole batch, so start ``s`` has the bits of
    a batch of one."""
    S, nt, L = stage.shape
    smax = B if smax is None else min(smax, B)
    dev = stage.device
    inf = torch.tensor(torch.inf, dtype=stage.dtype, device=dev)
    b_lane = torch.arange(B + 1, device=dev)
    btilde = btilde.to(torch.int64)

    # Terminal layer i = nt-1: exact-budget seed (HelpFunctions.jl:29-43).
    phi = torch.where(b_lane == btilde[:, -1, :, None],
                      stage[:, -1, :, None], inf)  # (S, L, B+1)
    U = torch.empty((S, max(nt - 1, 0), L, B + 1), dtype=u_dtype(L), device=dev)
    for i in range(nt - 2, -1, -1):
        tot = phi[:, None, :, :] + jump_cost[None, :, :, None]  # (S, l, j, b)
        val, arg = torch.min(tot, dim=2)  # first minimal j
        # Budget shift out[l, b] = val[l, b − b̃_l] as a gather; b < b̃ and
        # b̃ > smax give +inf / arg 0 (the JAX roll-select's fill).
        s = btilde[:, i, :, None]  # (S, L, 1)
        src = b_lane - s
        ok = (src >= 0) & (s <= smax)
        src = src.clamp(min=0)
        new_phi = torch.where(ok, torch.gather(val, 2, src), inf)
        U[:, i] = torch.where(ok, torch.gather(arg, 2, src), 0).to(U.dtype)
        phi = stage[:, i, :, None] + new_phi
    return U, phi


def build_tables_plain(stage, btilde, jump_cost, B: int, smax: int = None):
    """Plain PyTorch backward recursion; returns ``(U, phi0)``.

    U:    ``(nt-1, L, B+1)`` post-shift argmin-successor table (:func:`u_dtype`).
    phi0: ``(L, B+1)`` value table at the first time step.
    Runs on whatever device its inputs are on (one step of small tensor ops
    per time step); the card's production route is the kernel.
    """
    build_tables_plain.calls += 1
    U, phi = _build_plain(stage[None], btilde[None], jump_cost, B, smax)
    return U[0], phi[0]


build_tables_plain.calls = 0


def build_tables(stage, btilde, jump_cost, B: int, smax: int = None, unroll: int = 4):
    """DP tables ``(U, phi0)`` (see :func:`build_tables_plain`).  CPU tensors
    take the plain version; CUDA tensors launch the ``dp_build`` kernel.

    ``unroll`` is the JAX package's ``lax.scan`` unroll of the recursion,
    taken at its position and ignored: its min/argmin recursion has no
    fused multiply-add to contract, so it gives the same tables at every
    unroll, and both routes here schedule the same recursion in the same
    order."""
    with trace.span("dp.build"):
        if stage.device.type == "cpu":
            return build_tables_plain(stage, btilde, jump_cost, B, smax)
        from .bellman_cuda import dp_build

        return dp_build(stage, btilde, jump_cost, B, B if smax is None else smax)


def build_tables_batched_plain(stage, btilde, jump_cost, B: int, smax: int = None):
    """Plain batched build: ``stage``/``btilde`` ``(S, nt, L)`` with one
    shared ``jump_cost (L, L)`` give ``U (S, nt-1, L, B+1)`` and ``phi0 (S,
    L, B+1)``; start ``s`` equals :func:`build_tables_plain` of that start,
    bit for bit."""
    build_tables_batched_plain.calls += 1
    return _build_plain(stage, btilde, jump_cost, B, smax)


build_tables_batched_plain.calls = 0


def build_tables_batched(stage, btilde, jump_cost, B: int, smax: int = None):
    """Batched DP tables (see :func:`build_tables_batched_plain`).  CPU
    tensors take the plain version; CUDA tensors launch the
    ``dp_build_batched`` kernel."""
    with trace.span("dp.build"):
        if stage.device.type == "cpu":
            return build_tables_batched_plain(stage, btilde, jump_cost, B, smax)
        from .bellman_cuda import dp_build_batched

        return dp_build_batched(stage, btilde, jump_cost, B, B if smax is None else smax)


def budget_index(b, B: int):
    """The budget index of a chase lookup ``U[k, l, b]`` under the JAX scan
    chase's rule (``mioc_tpu.ops.bellman.backtrack`` indexes ``U_k[l, b]``
    with a traced ``b``): a negative ``b`` counts from the end, ``b + B + 1``,
    then the index is clamped to ``[0, B]``.  On a walk from a finite seed
    ``b`` stays in ``[0, B]`` and this is ``b``; from a +inf seed (every
    masked ``phi0`` entry +inf) the budget can fall below 0, even below
    ``-(B+1)``.  ``csrc/common.cuh::budget_index`` is the kernels' copy."""
    return np.clip(np.where(b < 0, b + B + 1, b), 0, B)


def _walk_plain(U, phi0, btilde, table, caps):
    """Chase ``N = len(table)`` chains on host copies of S table sets: chain
    ``n`` walks table set ``table[n]`` from the seed under cap ``caps[n]``.
    The chase is a dependent pointer walk, so it runs as a Python loop over
    the time steps, vectorised over the chains (integer arithmetic)."""
    B1 = phi0.shape[-1]
    nt = btilde.shape[1]
    table = torch.as_tensor(table, dtype=torch.long)
    caps = torch.as_tensor(caps).to(device="cpu", dtype=torch.long)
    phi = phi0.cpu()[table]  # (N, L, B+1)
    masked = torch.where(torch.arange(B1) <= caps[:, None, None], phi,
                         torch.tensor(torch.inf, dtype=phi.dtype))
    # Row-major flat argmin over (L, B+1) = Julia's column-major scan
    # (HelpFunctions.jl:106): smallest l, then smallest b.
    flat = torch.argmin(masked.reshape(len(table), -1), dim=1).numpy()
    l, b = flat // B1, flat % B1
    U_h = U.cpu().numpy()
    bt_h = btilde.cpu().numpy()
    t = table.numpy()
    out = np.empty((len(t), nt), dtype=np.int32)
    out[:, 0] = l
    for k in range(nt - 1):
        nl = U_h[t, k, l, budget_index(b, B1 - 1)].astype(np.int64)
        b = b - bt_h[t, k, l]  # decrement AFTER lookup (HelpFunctions.jl:115-122)
        l = nl
        out[:, k + 1] = l
    return torch.from_numpy(out).to(phi0.device)


def backtrack_plain(U, phi0, btilde, B_new):
    """Plain path chase at cap ``B_new`` (an int or a 0-d tensor); returns
    ``level_idx (nt,)`` int32 on ``phi0``'s device."""
    backtrack_plain.calls += 1
    return _walk_plain(U[None], phi0[None], btilde[None], [0],
                       torch.as_tensor(B_new).reshape(1))[0]


backtrack_plain.calls = 0


CHASE_VARIANTS = {"scalar": "chase", "vec": "chase_vec"}


def chase_kernel_name() -> str:
    """The single chase's CUDA kernel that ``MIOC_CHASE`` selects: unset or
    ``"scalar"`` → ``"chase"``, ``"vec"`` → ``"chase_vec"``; any other value
    raises ``ValueError``, so a typo cannot run the other kernel."""
    variant = os.environ.get("MIOC_CHASE", "scalar")
    if variant not in CHASE_VARIANTS:
        raise ValueError(f"MIOC_CHASE must be one of {sorted(CHASE_VARIANTS)}, "
                         f"got {variant!r}")
    return CHASE_VARIANTS[variant]


def backtrack(U, phi0, btilde, levels, B_new):
    """Extract the optimal control from the DP tables (``eval_u_TRM!``).

    Returns ``(u, level_idx)``: ``u = levels[level_idx]`` of shape
    ``(nt, M)`` and ``level_idx (nt,)`` int32.  ``B_new`` is an int or a
    0-d int32 tensor.  CPU tensors take the plain version, which is the
    plain version of both chase kernels; CUDA tensors launch the kernel that
    :func:`chase_kernel_name` names, ``chase`` or ``chase_vec``.

    Two differences from the JAX package's ``MIOC_CHASE``: it is read at
    every call (the JAX package reads it once, at import), so one process can
    switch kernels; and a value other than ``"scalar"`` or ``"vec"`` raises
    on both routes (the JAX package runs the scalar chase for any other
    value).  The batched and trial-wave chases do not read it.
    """
    name = chase_kernel_name()
    with trace.span("dp.chase"):
        if phi0.device.type == "cpu":
            level_idx = backtrack_plain(U, phi0, btilde, B_new)
        else:
            from . import backtrack_cuda

            level_idx = getattr(backtrack_cuda, name)(U, phi0, btilde, B_new)
    return _levels_at(levels, phi0, level_idx), level_idx


def _levels_at(levels, phi0, level_idx):
    levels = torch.as_tensor(levels, dtype=phi0.dtype, device=phi0.device)
    return levels[level_idx.long()]


def backtrack_batched_plain(U, phi0, btilde, B_new):
    """Plain batched chase: tables ``U (S, nt-1, L, B+1)``, ``phi0 (S, L,
    B+1)``, ``btilde (S, nt, L)`` and a cap per start ``B_new (S,)`` (or one
    for all) give ``level_idx (S, nt)`` int32; row ``s`` equals
    :func:`backtrack_plain` of start ``s`` at ``B_new[s]``."""
    backtrack_batched_plain.calls += 1
    S = phi0.shape[0]
    caps = torch.as_tensor(B_new).reshape(-1).expand(S)
    return _walk_plain(U, phi0, btilde, torch.arange(S), caps)


backtrack_batched_plain.calls = 0


def backtrack_trials_plain(U, phi0, btilde, B_trials):
    """Plain trial-wave chase: ``B_trials (S, Kt)`` caps per start against
    that start's tables give ``level_idx (S, Kt, nt)`` int32; row ``(s, t)``
    equals :func:`backtrack_plain` of start ``s`` at ``B_trials[s, t]``."""
    backtrack_trials_plain.calls += 1
    S, Kt = B_trials.shape
    table = torch.arange(S).repeat_interleave(Kt)
    idx = _walk_plain(U, phi0, btilde, table, torch.as_tensor(B_trials).reshape(-1))
    return idx.reshape(S, Kt, -1)


backtrack_trials_plain.calls = 0


def backtrack_batched(U, phi0, btilde, levels, B_new):
    """Chase S table sets, each at its own cap ``B_new (S,)`` (an int32
    tensor on the tables' device, or anything ``torch.as_tensor`` takes);
    returns ``(u (S, nt, M), level_idx (S, nt))``.  CPU tensors take the
    plain version; CUDA tensors launch the ``chase_batched`` kernel, which
    also takes tables expanded along the start axis (batch stride 0)."""
    with trace.span("dp.chase"):
        if phi0.device.type == "cpu":
            level_idx = backtrack_batched_plain(U, phi0, btilde, B_new)
        else:
            from .backtrack_cuda import chase_batched

            level_idx = chase_batched(U, phi0, btilde, B_new)
    return _levels_at(levels, phi0, level_idx), level_idx


def backtrack_trials(U, phi0, btilde, levels, B_trials):
    """Chase ``B_trials (S, Kt)`` caps per start against that start's
    tables; returns ``(u (S, Kt, nt, M), level_idx (S, Kt, nt))``.  CPU
    tensors take the plain version; CUDA tensors launch the
    ``chase_trials`` kernel."""
    with trace.span("dp.chase"):
        if phi0.device.type == "cpu":
            level_idx = backtrack_trials_plain(U, phi0, btilde, B_trials)
        else:
            from .backtrack_cuda import chase_trials

            level_idx = chase_trials(U, phi0, btilde, B_trials)
    return _levels_at(levels, phi0, level_idx), level_idx


def dp_solve(grad, u_old, levels, jump_cost, tau, B: int, smax: int = None):
    """One-shot DP: build tables and extract the optimal control.

    Returns ``(u, level_idx, (U, phi0, btilde))``; the tables can be re-used
    by :func:`backtrack` for budget-halved re-extraction.
    """
    if smax is None:
        smax = max_budget_use(levels)
    stage, btilde = stage_tables(grad, u_old, levels, tau)
    U, phi0 = build_tables(stage, btilde, jump_cost, B, smax)
    u, level_idx = backtrack(U, phi0, btilde, levels, B)
    return u, level_idx, (U, phi0, btilde)
