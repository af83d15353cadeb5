"""The trust-region subproblem's dynamic program, in plain NumPy.

Over the level combinations ν_0 … ν_{L−1} and an L¹ budget B it solves
exactly

    min_v  Σ_i τ·g_i·v_i + β·TV_p(v)   s.t.  Σ_i ‖v_i − u_i‖₁ ≤ B,

with ``g`` the gradient density at ``u`` (the objective's gradient over
τ).  Φ_i[l, b] is the least cost from step i on, with level l at step i,
using exactly b of the budget from step i on; the chase takes the least
Φ_0 entry with b ≤ cap and follows the stored successors.  Ties go to the
smallest successor index, then the smallest level, then the smallest
budget, the upstream toolbox's rule, so the reference's candidate is the
program's wherever the minimum is unique to rounding.
"""

from __future__ import annotations

import numpy as np


def stage_tables(grad, u, levels, tau):
    """``stage (S, nt, L) = τ·g·ν_l`` and ``btilde (S, nt, L) = ‖ν_l − u_i‖₁``."""
    stage = tau * np.einsum("sim,lm->sil", grad, levels)
    btilde = np.rint(np.abs(levels[None, None] - u[:, :, None, :]).sum(-1)).astype(np.int64)
    return stage, btilde


def build(stage, btilde, jump, B: int, smax: int):
    """Backward recursion over S problems at once; returns the successor
    table ``U (S, nt−1, L, B+1)`` and ``phi0 (S, L, B+1)``."""
    S, nt, L = stage.shape
    smax = min(smax, B)
    b = np.arange(B + 1)
    phi = np.where(b == btilde[:, -1, :, None], stage[:, -1, :, None], np.inf)
    U = np.zeros((S, max(nt - 1, 0), L, B + 1), dtype=np.int16)
    for i in range(nt - 2, -1, -1):
        tot = phi[:, None, :, :] + jump[None, :, :, None]         # (S, l, j, b)
        arg = tot.argmin(axis=2)                                   # first minimal j
        val = np.take_along_axis(tot, arg[:, :, None, :], axis=2)[:, :, 0]
        s = btilde[:, i, :, None]                                  # (S, L, 1)
        src = b - s
        ok = (src >= 0) & (s <= smax)
        src = np.clip(src, 0, B)
        shifted = np.take_along_axis(val, src, axis=2)
        U[:, i] = np.where(ok, np.take_along_axis(arg, src, axis=2), 0)
        phi = stage[:, i, :, None] + np.where(ok, shifted, np.inf)
    return U, phi


def chase(U, phi0, btilde, caps):
    """Level indices ``(S, nt)`` of the optimal paths at budget caps
    ``caps (S,)``."""
    S, L, B1 = phi0.shape
    nt = btilde.shape[1]
    masked = np.where(np.arange(B1)[None, None, :] <= np.asarray(caps)[:, None, None],
                      phi0, np.inf)
    flat = masked.reshape(S, -1).argmin(axis=1)
    l, bud = flat // B1, flat % B1
    rows = np.arange(S)
    out = np.empty((S, nt), dtype=np.int64)
    out[:, 0] = l
    for k in range(nt - 1):
        nl = U[rows, k, l, np.clip(bud, 0, B1 - 1)]
        bud = bud - btilde[rows, k, l]
        l = nl.astype(np.int64)
        out[:, k + 1] = l
    return out


def halving_caps(delta0: float, tau: float, kmax: int) -> list:
    """The budgets of the inner accept/halve steps: ⌊δ/τ⌋ for δ = δ⁰,
    δ⁰/2, … down to the first 0, at most ``kmax`` of them."""
    caps, d = [], float(delta0)
    for _ in range(kmax):
        caps.append(int(np.floor(d / tau)))
        if caps[-1] == 0:
            break
        d /= 2.0
    return caps
