"""Double-tank multimode problem (mintoc.de).

Counterpart of ``mioc_tpu.models.doubletank`` (the reference's
``example_doubletank.jl``): sqrt outflow dynamics (the state must stay
positive), SOS1 inflow modes, tracking objective ``k1 (y2 − k2)²``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_dtype
from ..objectives.ode import RowwiseODEObjective, _numpy_dtype, const_dot
from ..ops.levels import bounded_sum_levels

__all__ = ["DTMObj"]


class DTMObj(RowwiseODEObjective):
    def __init__(self, nt: int = 1000, *, k1=2.0, k2=3.0, c=(1.0, 0.5, 2.0),
                 state0=(2.0, 2.0), device=None, dtype=None):
        self.k1, self.k2 = float(k1), float(k2)
        self.c = np.asarray(c, dtype=_numpy_dtype(resolve_dtype(dtype)))
        V = [[0, 1], [0, 1], [0, 1]]
        adm = bounded_sum_levels(V, 1, 1)
        super().__init__(T0=0.0, T1=10.0, nt=nt, state0=state0, V=V, admissible=adm,
                         device=device, dtype=dtype)
        self._c = torch.as_tensor(self.c, device=self.device)

    # Domain-aware FD-check sampling: the sqrt dynamics need y > 0
    # (example_doubletank.jl:116-179 ships its own checks for this).
    def sample_point(self, rng):
        y = self._on_device(1.0 + 3.0 * rng.random(self.ny))
        u = self._on_device(self.admissible.levels[rng.integers(self.admissible.L)])
        return y, u, int(rng.integers(self.nt))

    # Dynamics (example_doubletank.jl:48-67) on the last axis; the inflow
    # u·c depends on the control only.
    def _coupling(self, u):
        return const_dot(u, self.c)

    def _rhs(self, y, a):
        s1 = torch.sqrt(y[..., 0])
        return torch.stack([a - s1, s1 - torch.sqrt(y[..., 1])], dim=-1)

    def _rhsT_lam(self, y, lam, a):
        i1 = -1.0 / (2.0 * torch.sqrt(y[..., 0]))
        return torch.stack([
            i1 * lam[..., 0] - i1 * lam[..., 1],
            (-1.0 / (2.0 * torch.sqrt(y[..., 1]))) * lam[..., 1],
        ], dim=-1)

    def Fy(self, y, u, i):
        i1 = -1.0 / (2.0 * torch.sqrt(y[..., 0]))
        i2 = -1.0 / (2.0 * torch.sqrt(y[..., 1]))
        z = torch.zeros_like(i1)
        return torch.stack([torch.stack([i1, z], dim=-1),
                            torch.stack([-i1, i2], dim=-1)], dim=-2)

    def Fu(self, y, u, i):
        c = self._c.expand(*y.shape[:-1], -1)
        return torch.stack([c, torch.zeros_like(c)], dim=-2)

    # Objective (example_doubletank.jl:70-82).
    def G(self, y, u, i):
        return self.k1 * (y[..., 1] - self.k2) ** 2

    def Gy(self, y, u, i):
        g1 = 2.0 * self.k1 * (y[..., 1] - self.k2)
        return torch.stack([torch.zeros_like(g1), g1], dim=-1)

    def Gu(self, y, u, i):
        return torch.zeros_like(u)
