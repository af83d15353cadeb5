"""The signal-reconstruction (convolution) problem in plain PyTorch.

Upstream ``example_convolution.jl`` (Marko & Wachsmuth, ESAIM:COCV 2023,
§6.2): one integer control ``u`` on ``nt`` cells of ``[T0, T1]`` and no
differential equation,

    f(u) = ½ (K u − f̂)ᵀ M (K u − f̂),

built from a configuration file (``portbench/configs/conv-nt2048.json``)
alone:

* ``K (nt+1, nt)``, the kernel integrated over one cell at each lag
  (``:60-63, 104-125``): ``K[r, c] = F(d·τ) − F((d−1)·τ)`` for the lag
  ``d = r − c ≥ 1`` (0-based), else 0, with the antiderivative
  ``F(t) = s·e^{−a}(sin a + cos a)``, ``a = ω₀ (t − t₁)/√2``;
* the target ``f̂_i = A cos(2π ν (T0 + τ i))``, ``i = 1 … nt+1``
  (``:73-81``);
* the hat-function mass matrix ``M (nt+1, nt+1)``, tridiagonal: τ/3 at
  both ends of the diagonal, 2τ/3 inside, τ/6 beside it (``:85-100``).

The gradient is the port's convention (``ConvObj._df_chunk``, upstream
``eval_df_helper``, ``:138-141``): ``∂f/∂u = Kᵀ M (K u − f̂)``.  Everything
is float64 on the CPU, every product a plain ``@`` on whole matrices.
"""

from __future__ import annotations

import math

import torch


class Conv:
    """The problem a configuration describes; controls are ``(..., nt, 1)``."""

    def __init__(self, cfg: dict):
        # Full float64 products whatever the device defaults say.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        p = cfg["problem"]
        self.nt = nt = int(cfg["nt"])
        self.tau = tau = (p["T1"] - p["T0"]) / nt
        kern, target = p["kernel"], p["target"]
        w0, s, t1 = float(p["omega0"]), float(kern["scale"]), float(kern["shift"])

        def F(t):
            a = w0 * (t - t1) / math.sqrt(2.0)
            return s * torch.exp(-a) * (torch.sin(a) + torch.cos(a))

        f64 = dict(dtype=torch.float64)
        lag = (torch.arange(nt + 1)[:, None] - torch.arange(nt)[None, :]).to(torch.float64)
        self.K = torch.where(lag >= 1, F(lag * tau) - F((lag - 1) * tau), torch.zeros((), **f64))
        t = p["T0"] + tau * torch.arange(1, nt + 2, **f64)
        self.fhat = target["amplitude"] * torch.cos(2 * math.pi * target["frequency"] * t)
        diag = torch.full((nt + 1,), 2.0 * tau / 3.0, **f64)
        diag[0] = diag[-1] = tau / 3.0
        off = torch.full((nt,), tau / 6.0, **f64)
        self.M = torch.diag(diag) + torch.diag(off, 1) + torch.diag(off, -1)

    def _residual(self, u):
        return torch.as_tensor(u, dtype=torch.float64)[..., 0] @ self.K.T - self.fhat  # (..., nt+1)

    def value(self, u):
        """``f (...)`` of controls ``u (..., nt, 1)``."""
        r = self._residual(u)
        return 0.5 * ((r @ self.M) * r).sum(-1)

    def gradient(self, u):
        """``Kᵀ M (K u − f̂)``, ``(..., nt, 1)``."""
        return ((self._residual(u) @ self.M) @ self.K)[..., None]
