"""Lotka–Volterra multimode fishing (mintOC; upstream ``example_fishing.jl``).

    y₀' = y₀ (α − β y₁ − c₁ u·v₁),   y₁' = y₁ (−γ + δ y₀ − c₂ u·v₂),
    f(u) = ∫ ½ ((y₀ − 1)² + (y₁ − 1)²) dt,

discretised by explicit Euler on ``nt`` steps of ``[T0, T1]`` with the
trapezoid rule for the cost.  The gradient is the exact derivative of that
discrete ``f``, divided by τ (a density in time, the convention of the
trust-region model ``Σ_i τ·g_i·v_i``), from a hand-written adjoint sweep.
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
        c = lambda k: dtype(p[k])
        self.alpha, self.beta, self.gamma, self.delta = c("alpha"), c("beta"), c("gamma"), c("delta")
        self.c1, self.c2 = c("c1"), c("c2")
        self.v1 = np.asarray(p["v1"], dtype)
        self.v2 = np.asarray(p["v2"], dtype)
        self.y0 = np.asarray(p["state0"], dtype)
        w = np.ones(self.nt + 1, dtype)
        w[0] = w[-1] = 0.5
        self.w = w

    def _couplings(self, us):
        return self.c1 * (us @ self.v1), self.c2 * (us @ self.v2)   # (R, nt) each

    def states(self, us):
        """``ys (R, nt+1, 2)``: y_0 … y_nt for every row of ``us (R, nt, 3)``."""
        us = np.asarray(us, self.dtype)
        a, c = self._couplings(us)
        R = us.shape[0]
        ys = np.empty((R, self.nt + 1, 2), self.dtype)
        y = np.broadcast_to(self.y0, (R, 2)).copy()
        ys[:, 0] = y
        tau = self.dtype(self.tau)
        for k in range(self.nt):
            y0, y1 = y[:, 0], y[:, 1]
            y = np.stack([y0 + tau * y0 * (self.alpha - self.beta * y1 - a[:, k]),
                          y1 + tau * y1 * (-self.gamma + self.delta * y0 - c[:, k])], axis=1)
            ys[:, k + 1] = y
        return ys

    def value(self, us):
        """``f (R,)``."""
        ys = self.states(us)
        g = 0.5 * ((ys - 1.0) ** 2).sum(axis=-1)
        return self.dtype(self.tau) * (g * self.w).sum(axis=-1)

    def gradient(self, us):
        """``∂f/∂u / τ``, ``(R, nt, 3)``."""
        us = np.asarray(us, self.dtype)
        ys = self.states(us)
        a, c = self._couplings(us)
        tau = self.dtype(self.tau)
        R, nt = us.shape[0], self.nt
        mu = tau * self.w[nt] * (ys[:, nt] - 1.0)            # ∂f/∂y_nt
        grad = np.empty((R, nt, 3), self.dtype)
        for k in range(nt - 1, -1, -1):
            y0, y1 = ys[:, k, 0], ys[:, k, 1]
            # ∂f/∂u_k through y_{k+1} = y_k + τ F(y_k, u_k)
            grad[:, k] = -(self.c1 * y0 * mu[:, 0])[:, None] * self.v1 \
                - (self.c2 * y1 * mu[:, 1])[:, None] * self.v2
            if k == 0:
                break
            # μ_k = τ w_k (y_k − 1) + (I + τ F_y(y_k, u_k))ᵀ μ_{k+1}
            f00 = self.alpha - self.beta * y1 - a[:, k]
            f11 = -self.gamma + self.delta * y0 - c[:, k]
            m0 = mu[:, 0] + tau * (f00 * mu[:, 0] + self.delta * y1 * mu[:, 1])
            m1 = mu[:, 1] + tau * (-self.beta * y0 * mu[:, 0] + f11 * mu[:, 1])
            mu = np.stack([m0, m1], axis=1) + tau * self.w[k] * (ys[:, k] - 1.0)
        return grad
