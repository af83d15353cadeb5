"""Van der Pol oscillator, binary variant (mintOC; upstream ``example_vanderpol.jl``).

    y₀' = y₁,   y₁' = (1 − y₀²) y₁ (u·c) − y₀,
    f(u) = ∫ (y₀² + y₁²) dt,

discretised by explicit Euler on ``nt`` steps of ``[T0, T1]`` with the
trapezoid rule for the cost.  The gradient is the exact derivative of that
discrete ``f``, divided by τ (a density in time, the convention of the
trust-region model ``Σ_i τ·g_i·v_i``), from a hand-written adjoint sweep.
The NumPy copy of ``plainref/vanderpol.py``, whose docstring lists the
departures from the upstream text.
"""

from __future__ import annotations

import numpy as np

from .levels import admissible_levels


class Model:
    def __init__(self, cfg: dict, dtype=np.float64):
        p = cfg["problem"]
        self.dtype = dtype
        self.nt = int(cfg["nt"])
        self.tau = (p["T1"] - p["T0"]) / self.nt
        self.levels = admissible_levels(cfg["levels"])
        self.c = np.asarray(p["c"], dtype)
        self.y0 = np.asarray(p["state0"], dtype)
        w = np.ones(self.nt + 1, dtype)
        w[0] = w[-1] = 0.5
        self.w = w

    @np.errstate(over="ignore", invalid="ignore")   # an overflow reads as inf or NaN
    def states(self, us):
        """``ys (R, nt+1, 2)``: y_0 … y_nt for every row of ``us (R, nt, 3)``."""
        cu = np.asarray(us, self.dtype) @ self.c                       # (R, nt)
        R = cu.shape[0]
        ys = np.empty((R, self.nt + 1, 2), self.dtype)
        y = np.broadcast_to(self.y0, (R, 2)).copy()
        ys[:, 0] = y
        tau = self.dtype(self.tau)
        for k in range(self.nt):
            y0, y1 = y[:, 0], y[:, 1]
            y = np.stack([y0 + tau * y1,
                          y1 + tau * ((1.0 - y0 * y0) * y1 * cu[:, k] - y0)], axis=1)
            ys[:, k + 1] = y
        return ys

    def value(self, us):
        """``f (R,)``."""
        ys = self.states(us)
        return self.dtype(self.tau) * (((ys * ys).sum(axis=-1)) * self.w).sum(axis=-1)

    @np.errstate(over="ignore", invalid="ignore")
    def gradient(self, us):
        """``∂f/∂u / τ``, ``(R, nt, 3)``."""
        us = np.asarray(us, self.dtype)
        cu = us @ self.c
        ys = self.states(us)
        tau = self.dtype(self.tau)
        R, nt = us.shape[0], self.nt
        mu = tau * self.w[nt] * 2.0 * ys[:, nt]                        # ∂f/∂y_nt
        grad = np.empty((R, nt, 3), self.dtype)
        for k in range(nt - 1, -1, -1):
            y0, y1 = ys[:, k, 0], ys[:, k, 1]
            q = 1.0 - y0 * y0
            # ∂f/∂u_k through y_{k+1} = y_k + τ F(y_k, u_k): F_u(y_k)ᵀ μ_{k+1}
            grad[:, k] = (q * y1 * mu[:, 1])[:, None] * self.c
            if k == 0:
                break
            # μ_k = τ w_k ∇G(y_k) + (I + τ F_y(y_k, u_k))ᵀ μ_{k+1}
            a = cu[:, k]
            m0 = mu[:, 0] + tau * (-2.0 * y0 * y1 * a - 1.0) * mu[:, 1]
            m1 = mu[:, 1] + tau * (mu[:, 0] + q * a * mu[:, 1])
            mu = np.stack([m0, m1], axis=1) + tau * self.w[k] * 2.0 * ys[:, k]
        return grad
