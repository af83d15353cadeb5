"""The signal-reconstruction (convolution) problem (upstream
``example_convolution.jl``; Marko & Wachsmuth, ESAIM:COCV 2023, §6.2).

    f(u) = ½ (K u − f̂)ᵀ M (K u − f̂)

with one integer control on ``nt`` cells of ``[T0, T1]`` and no
differential equation.  Everything is derived here again from the
configuration: ``K[r, c] = F(d·τ) − F((d−1)·τ)`` at the lag ``d = r − c ≥ 1``
(0-based; else 0) from the kernel's antiderivative ``F(t) = s·e^{−a}(sin a
+ cos a)``, ``a = ω₀ (t − t₁)/√2``; the target ``f̂_i = A cos(2π ν (T0 + τ
i))``, ``i = 1 … nt+1``; and the tridiagonal hat-function mass matrix ``M``
(τ/3 at both ends of the diagonal, 2τ/3 inside, τ/6 beside it).  The
gradient is ``∂f/∂u = Kᵀ M (K u − f̂)``, the program's convention for this
problem.  The same mathematics as ``plainref/conv.py``, in NumPy.
"""

from __future__ import annotations

import numpy as np

from .levels import admissible_levels


class Model:
    def __init__(self, cfg: dict, dtype=np.float64):
        p = cfg["problem"]
        self.dtype = dtype
        self.nt = nt = int(cfg["nt"])
        self.tau = tau = (p["T1"] - p["T0"]) / nt
        self.levels = admissible_levels(cfg["levels"])
        kern, target = p["kernel"], p["target"]
        w0, s, t1 = float(p["omega0"]), float(kern["scale"]), float(kern["shift"])

        def F(t):
            a = w0 * (t - t1) / np.sqrt(2.0)
            return s * np.exp(-a) * (np.sin(a) + np.cos(a))

        lag = (np.arange(nt + 1)[:, None] - np.arange(nt)[None, :]).astype(np.float64)
        self.K = np.where(lag >= 1, F(lag * tau) - F((lag - 1) * tau), 0.0).astype(dtype)
        t = p["T0"] + tau * np.arange(1, nt + 2)
        self.fhat = (target["amplitude"] * np.cos(2 * np.pi * target["frequency"] * t)).astype(dtype)
        self.mdiag = np.full(nt + 1, 2.0 * tau / 3.0, dtype)
        self.mdiag[0] = self.mdiag[-1] = tau / 3.0
        self.moff = dtype(tau / 6.0)

    def _mass(self, r):
        out = self.mdiag * r
        out[..., :-1] += self.moff * r[..., 1:]
        out[..., 1:] += self.moff * r[..., :-1]
        return out

    def _residual(self, us):
        return np.asarray(us, self.dtype)[..., 0] @ self.K.T - self.fhat    # (R, nt+1)

    def value(self, us):
        """``f (R,)`` of ``us (R, nt, 1)``."""
        r = self._residual(us)
        return 0.5 * (self._mass(r) * r).sum(axis=-1)

    def gradient(self, us):
        """``Kᵀ M (K u − f̂)``, ``(R, nt, 1)``."""
        return (self._mass(self._residual(us)) @ self.K)[..., None]
