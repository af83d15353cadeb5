"""The Van der Pol oscillator, binary variant, in plain PyTorch.

mintOC's binary Van der Pol problem as the upstream repository states it
(``example_vanderpol.jl``): ``VPOObj`` (``:14-46``) on ``[T0, T1] = [0,
20]`` with ``nt = 2000`` steps, three SOS1 modes with coefficients ``c =
(−1, 0.75, −2)`` and ``y(T0) = (1, 0)``; the dynamics (``:48-66``)

    y₀' = y₁,   y₁' = (1 − y₀²) y₁ (u·c) − y₀,

and the running cost ``G = y₀² + y₁²`` (``:69-81``), built from a
configuration file (``portbench/configs/vanderpol-nt2000.json``) alone:

* the states by explicit Euler, ``y_{k+1} = y_k + τ F(y_k, u_k)``,
  ``k = 0 … nt−1``, ``τ = (T1 − T0)/nt``;
* ``f(u) = τ Σ_k w_k G(y_k)`` over ``k = 0 … nt`` with the trapezoid
  weights ``w_0 = w_nt = ½``, else 1;
* the gradient ``∂f/∂u / τ`` from a hand-written discrete adjoint of that
  ``f``: ``μ_nt = τ w_nt ∇G(y_nt)``, ``μ_k = τ w_k ∇G(y_k) + (I + τ
  F_y(y_k, u_k))ᵀ μ_{k+1}``, and ``∂f/∂u_k / τ = F_u(y_k, u_k)ᵀ μ_{k+1}``,
  the convention of ``portbench/reference/fishing.py``.

Departures from the upstream text:

* upstream numbers steps and states from 1 (Julia); here from 0;
* the gradient is divided by τ: a density in time, which the trust-region
  model ``Σ_i τ·g_i·v_i`` reads;
* a control is any real ``(…, nt, 3)`` array: relaxed controls are
  evaluated as the same formulas, and nothing projects onto the SOS1 set;
* upstream warns that explicit Euler may overflow on coarse grids
  (``:3``); nothing here guards against it, so an overflow gives a
  non-finite ``f`` and gradient;
* everything is float64 on the CPU, whatever the configuration states,
  with TF32 switched off for any product on a card.
"""

from __future__ import annotations

import torch


class VanDerPol:
    """The problem a configuration describes; controls are ``(..., nt, 3)``."""

    def __init__(self, cfg: dict):
        # Full float64 products whatever the device defaults say.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        p = cfg["problem"]
        self.nt = nt = int(cfg["nt"])
        self.tau = (p["T1"] - p["T0"]) / nt
        f64 = dict(dtype=torch.float64)
        self.c = torch.tensor(p["c"], **f64)
        self.y0 = torch.tensor(p["state0"], **f64)
        self.w = torch.ones(nt + 1, **f64)
        self.w[0] = self.w[-1] = 0.5

    def states(self, u):
        """``ys (..., nt+1, 2)``: ``y_0 … y_nt`` of controls ``u (..., nt, 3)``."""
        cu = torch.as_tensor(u, dtype=torch.float64) @ self.c          # (..., nt)
        y = self.y0.expand(*cu.shape[:-1], 2)
        ys = [y]
        for k in range(self.nt):
            y0, y1 = y[..., 0], y[..., 1]
            F = torch.stack([y1, (1.0 - y0 * y0) * y1 * cu[..., k] - y0], dim=-1)
            y = y + self.tau * F
            ys.append(y)
        return torch.stack(ys, dim=-2)

    def value(self, u):
        """``f (...)``."""
        ys = self.states(u)
        return self.tau * ((ys * ys).sum(-1) * self.w).sum(-1)

    def gradient(self, u):
        """``∂f/∂u / τ``, ``(..., nt, 3)``."""
        u = torch.as_tensor(u, dtype=torch.float64)
        cu = u @ self.c
        ys = self.states(u)
        tau, nt = self.tau, self.nt
        mu = tau * self.w[nt] * 2.0 * ys[..., nt, :]                    # ∂f/∂y_nt
        grad = torch.empty(u.shape, dtype=torch.float64)
        for k in range(nt - 1, -1, -1):
            y0, y1 = ys[..., k, 0], ys[..., k, 1]
            q = 1.0 - y0 * y0
            # F_u(y_k)ᵀ μ_{k+1}: only y₁' depends on u, through (1 − y₀²) y₁ c
            grad[..., k, :] = (q * y1 * mu[..., 1])[..., None] * self.c
            if k == 0:
                break
            a = cu[..., k]
            # (I + τ F_y(y_k, u_k))ᵀ μ_{k+1} + τ w_k ∇G(y_k), with
            # F_y = [[0, 1], [−2 y₀ y₁ a − 1, q a]]
            m0 = mu[..., 0] + tau * (-2.0 * y0 * y1 * a - 1.0) * mu[..., 1]
            m1 = mu[..., 1] + tau * (mu[..., 0] + q * a * mu[..., 1])
            mu = torch.stack([m0, m1], dim=-1) + tau * self.w[k] * 2.0 * ys[..., k, :]
        return grad
