"""Van der Pol oscillator, binary variant (mintoc.de).

Counterpart of ``mioc_tpu.models.vanderpol`` (the reference's
``example_vanderpol.jl``).  The ODE is unstable: explicit Euler may overflow
on coarse grids (``example_vanderpol.jl:3``).  An overflow gives a
non-finite f, never an exception, and the TRM treats it as a rejected step.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_dtype
from ..objectives.ode import RowwiseODEObjective, _numpy_dtype, const_dot
from ..ops.levels import bounded_sum_levels

__all__ = ["VPOObj"]


class VPOObj(RowwiseODEObjective):
    def __init__(self, nt: int = 2000, *, c=(-1.0, 0.75, -2.0), state0=(1.0, 0.0),
                 device=None, dtype=None):
        self.c = np.asarray(c, dtype=_numpy_dtype(resolve_dtype(dtype)))
        V = [[0, 1], [0, 1], [0, 1]]
        adm = bounded_sum_levels(V, 1, 1)
        super().__init__(T0=0.0, T1=20.0, nt=nt, state0=state0, V=V, admissible=adm,
                         device=device, dtype=dtype)
        self._c = torch.as_tensor(self.c, device=self.device)

    # Dynamics (example_vanderpol.jl:48-66) on the last axis; the mode
    # coefficient cu = u·c depends on the control only.
    def _coupling(self, u):
        return const_dot(u, self.c)

    def _rhs(self, y, cu):
        y0, y1 = y[..., 0], y[..., 1]
        return torch.stack([y1, (1.0 - y0 ** 2) * y1 * cu - y0], dim=-1)

    def _rhsT_lam(self, y, lam, cu):
        y0, y1 = y[..., 0], y[..., 1]
        return torch.stack([
            (-2.0 * y0 * y1 * cu - 1.0) * lam[..., 1],
            lam[..., 0] + (1.0 - y0 ** 2) * cu * lam[..., 1],
        ], dim=-1)

    def Fy(self, y, u, i):
        cu = self._coupling(u)
        y0, y1 = y[..., 0], y[..., 1]
        return torch.stack([
            torch.stack([torch.zeros_like(y0), torch.ones_like(y0)], dim=-1),
            torch.stack([-2.0 * y0 * y1 * cu - 1.0, (1.0 - y0 ** 2) * cu], dim=-1),
        ], dim=-2)

    def Fu(self, y, u, i):
        y0, y1 = y[..., 0], y[..., 1]
        row = ((1.0 - y0 ** 2) * y1)[..., None] * self._c
        return torch.stack([torch.zeros_like(row), row], dim=-2)

    # Objective (example_vanderpol.jl:69-81).
    def G(self, y, u, i):
        return y[..., 0] ** 2 + y[..., 1] ** 2

    def Gy(self, y, u, i):
        return 2.0 * y

    def Gu(self, y, u, i):
        return torch.zeros_like(u)
