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

This module holds the PLAIN PyTorch versions (``build_tables_plain``,
``backtrack_plain``) and the two public wrappers, :func:`build_tables` and
:func:`backtrack`.  A wrapper takes the plain version only for tensors on the
CPU.  For CUDA tensors it launches the hand-written kernel
(:mod:`.bellman_cuda`, :mod:`.backtrack_cuda`) or raises; it never falls back.

Semantics kept from the JAX package (each is what makes the port's paths
bit-identical to the reference's):

* the terminal layer seeds only the exact budget ``b = b̃[nt-1, l]``;
* the contraction's argmin is the FIRST minimal ``j`` (``torch.min`` over the
  ``(l, j, b)`` tensor returns the first occurrence);
* ``U`` is the POST-shift argmin plane; entries with ``b < b̃`` or
  ``b̃ > smax`` hold +inf in Φ and 0 in ``U``;
* the chase seed is the row-major flat argmin of ``Φ_0`` masked to
  ``b ≤ B_new`` — Julia's column-major order: smallest ``l``, then ``b``;
* each chase step looks ``U`` up BEFORE decrementing the budget;
* ``B_new`` is a plain runtime argument: a halved trust region re-chases the
  same tables without a rebuild.

``U`` is int8 when ``L ≤ 127`` and int32 otherwise, on both routes, so the
CPU and CUDA paths hand the chase the same tables.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "stage_tables",
    "max_budget_use",
    "u_dtype",
    "build_tables",
    "build_tables_plain",
    "backtrack",
    "backtrack_plain",
    "dp_solve",
]


def stage_tables(grad, u_old, levels, tau):
    """Per-(time, combination) stage cost and budget use.

    stage[i, l]  = τ · ∇f_i · ν_l          (``HelpFunctions.jl:34-36, 52-56``)
    btilde[i, l] = ‖ν_l − u_old_i‖₁        (integer, ``HelpFunctions.jl:37, 57``)
    """
    levels = torch.as_tensor(levels, dtype=grad.dtype, device=grad.device)
    stage = tau * (grad @ levels.T)  # (nt, L)
    btilde = torch.round(
        (levels[None, :, :] - u_old[:, None, :]).abs().sum(-1)
    ).to(torch.int32)  # (nt, L)
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


def build_tables_plain(stage, btilde, jump_cost, B: int, smax: int = None):
    """Plain PyTorch backward recursion; returns ``(U, phi0)``.

    U:    ``(nt-1, L, B+1)`` post-shift argmin-successor table (:func:`u_dtype`).
    phi0: ``(L, B+1)`` value table at the first time step.
    Runs on whatever device its inputs are on (one step of small tensor ops
    per time step); the card's production route is the kernel.
    """
    build_tables_plain.calls += 1
    nt, L = stage.shape
    smax = B if smax is None else min(smax, B)
    dev = stage.device
    inf = torch.tensor(torch.inf, dtype=stage.dtype, device=dev)
    b_lane = torch.arange(B + 1, device=dev)
    btilde = btilde.to(torch.int64)

    # Terminal layer i = nt-1: exact-budget seed (HelpFunctions.jl:29-43).
    phi = torch.where(b_lane[None, :] == btilde[-1][:, None],
                      stage[-1][:, None], inf)  # (L, B+1)
    U = torch.empty((max(nt - 1, 0), L, B + 1), dtype=u_dtype(L), device=dev)
    for i in range(nt - 2, -1, -1):
        tot = phi[None, :, :] + jump_cost[:, :, None]  # (l, j, b)
        val, arg = torch.min(tot, dim=1)  # first minimal j
        # Budget shift out[l, b] = val[l, b − b̃_l] as a gather; b < b̃ and
        # b̃ > smax give +inf / arg 0 (the JAX roll-select's fill).
        s = btilde[i][:, None]  # (L, 1)
        src = b_lane[None, :] - s
        ok = (src >= 0) & (s <= smax)
        src = src.clamp(min=0)
        new_phi = torch.where(ok, torch.gather(val, 1, src), inf)
        U[i] = torch.where(ok, torch.gather(arg, 1, src), 0).to(U.dtype)
        phi = stage[i][:, None] + new_phi
    return U, phi


build_tables_plain.calls = 0


def build_tables(stage, btilde, jump_cost, B: int, smax: int = None):
    """DP tables ``(U, phi0)`` (see :func:`build_tables_plain`).  CPU tensors
    take the plain version; CUDA tensors launch the ``dp_build`` kernel."""
    if stage.device.type == "cpu":
        return build_tables_plain(stage, btilde, jump_cost, B, smax)
    from .bellman_cuda import dp_build

    return dp_build(stage, btilde, jump_cost, B, B if smax is None else smax)


def _seed(phi0, B_new: int):
    L, B1 = phi0.shape
    b_lane = torch.arange(B1, device=phi0.device)
    masked = torch.where(b_lane[None, :] <= B_new, phi0,
                         torch.tensor(torch.inf, dtype=phi0.dtype,
                                      device=phi0.device))
    # Row-major flat argmin over (L, B+1) = Julia's column-major scan
    # (HelpFunctions.jl:106): smallest l, then smallest b.
    flat = int(torch.argmin(masked.reshape(-1)))
    return flat // B1, flat % B1


def backtrack_plain(U, phi0, btilde, B_new: int):
    """Plain path chase; returns ``level_idx (nt,)`` int32 on ``phi0``'s
    device.  The chase is a dependent pointer walk, so it runs as a Python
    loop over a host copy of the tables."""
    backtrack_plain.calls += 1
    nt = btilde.shape[0]
    l, b = _seed(phi0, int(B_new))
    U_h = U.cpu().numpy()
    bt_h = btilde.cpu().numpy()
    out = np.empty(nt, dtype=np.int32)
    out[0] = l
    for k in range(nt - 1):
        nl = int(U_h[k, l, b])
        b -= int(bt_h[k, l])  # decrement AFTER lookup (HelpFunctions.jl:115-122)
        l = nl
        out[k + 1] = l
    return torch.from_numpy(out).to(phi0.device)


backtrack_plain.calls = 0


def backtrack(U, phi0, btilde, levels, B_new: int):
    """Extract the optimal control from the DP tables (``eval_u_TRM!``).

    Returns ``(u, level_idx)``: ``u = levels[level_idx]`` of shape
    ``(nt, M)`` and ``level_idx (nt,)`` int32.  CPU tensors take the plain
    version; CUDA tensors launch the ``chase`` kernel.
    """
    if phi0.device.type == "cpu":
        level_idx = backtrack_plain(U, phi0, btilde, B_new)
    else:
        from .backtrack_cuda import chase

        level_idx = chase(U, phi0, btilde, B_new)
    levels = torch.as_tensor(levels, dtype=phi0.dtype, device=phi0.device)
    return levels[level_idx.long()], level_idx


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
