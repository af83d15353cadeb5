"""Lotka-Volterra multimode fishing problem (mintoc.de).

Counterpart of ``mioc_tpu.models.fishing`` (the reference's
``example_fishing.jl``): three binary SOS1 controls select a fishing mode;
tracking objective ½‖y − 1‖².
"""

from __future__ import annotations

import numpy as np
import torch

from ..objectives.ode import RowwiseODEObjective, _numpy_dtype, const_dot
from ..ops.levels import bounded_sum_levels
from .._device import resolve_dtype

__all__ = ["LVMObj"]


class LVMObj(RowwiseODEObjective):
    def __init__(
        self,
        nt: int = 1200,
        *,
        alpha=1.0,
        beta=1.0,
        gamma=1.0,
        delta=1.0,
        c1=1.0,
        c2=1.0,
        v1=(0.2, 0.4, 0.01),
        v2=(0.1, 0.2, 0.1),
        state0=(0.5, 0.7),
        T0=0.0,
        T1=12.0,
        device=None,
        dtype=None,
    ):
        self.alpha, self.beta = float(alpha), float(beta)
        self.gamma, self.delta = float(gamma), float(delta)
        self.c1, self.c2 = float(c1), float(c2)
        npdt = _numpy_dtype(resolve_dtype(dtype))
        self.v1 = np.asarray(v1, dtype=npdt)
        self.v2 = np.asarray(v2, dtype=npdt)
        V = [[0, 1], [0, 1], [0, 1]]
        # Exactly one active control at each timestep (example_fishing.jl:24).
        adm = bounded_sum_levels(V, 1, 1)
        super().__init__(T0=T0, T1=T1, nt=nt, state0=state0, V=V,
                         admissible=adm, device=device, dtype=dtype)
        self._v1 = torch.as_tensor(self.v1, device=self.device)
        self._v2 = torch.as_tensor(self.v2, device=self.device)

    # Dynamics (example_fishing.jl:56-76), written on the last axis so that
    # every function takes one row or any batch of rows.  ``a = c1·(u·v1)``
    # and ``c = c2·(u·v2)`` depend on the control only: the sweeps compute
    # them for all rows and steps at once with the same per-step arithmetic.
    def _coupling(self, u):
        return self.c1 * const_dot(u, self.v1), self.c2 * const_dot(u, self.v2)

    def _rhs(self, y, terms):
        a, c = terms
        y0, y1 = y[..., 0], y[..., 1]
        return torch.stack([
            y0 * (self.alpha - self.beta * y1 - a),
            y1 * (-self.gamma + self.delta * y0 - c),
        ], dim=-1)

    # Adjoint product Fyᵀλ written out (the default is torch.func.vjp of F).
    def _rhsT_lam(self, y, lam, terms):
        a, c = terms
        y0, y1 = y[..., 0], y[..., 1]
        l0, l1 = lam[..., 0], lam[..., 1]
        return torch.stack([
            (self.alpha - self.beta * y1 - a) * l0 + self.delta * y1 * l1,
            -self.beta * y0 * l0 + (-self.gamma + self.delta * y0 - c) * l1,
        ], dim=-1)

    def Fy(self, y, u, i):
        a, c = self._coupling(u)
        y0, y1 = y[..., 0], y[..., 1]
        return torch.stack([
            torch.stack([self.alpha - self.beta * y1 - a, -self.beta * y0], dim=-1),
            torch.stack([self.delta * y1, -self.gamma + self.delta * y0 - c], dim=-1),
        ], dim=-2)

    def Fu(self, y, u, i):
        return torch.stack([(-self.c1 * y[..., 0])[..., None] * self._v1,
                            (-self.c2 * y[..., 1])[..., None] * self._v2], dim=-2)

    # Tracking objective (example_fishing.jl:79-92).
    def G(self, y, u, i):
        return 0.5 * (y[..., 0] - 1.0) ** 2 + 0.5 * (y[..., 1] - 1.0) ** 2

    def Gy(self, y, u, i):
        return y - 1.0

    def Gu(self, y, u, i):
        return torch.zeros_like(u)
