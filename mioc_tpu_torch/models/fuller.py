"""Fuller's problem (mintoc.de), the canonical chattering benchmark.

Counterpart of ``mioc_tpu.models.fuller``.  Binary variant::

    min  ∫₀¹ y₁(t)² dt     s.t.   y₁' = y₂,   y₂' = 1 − 2u,   u(t) ∈ {0, 1}

with y(0) = (0.01, 0).  The unregularized optimal control switches
infinitely often in finite time; with β > 0 the TRM returns a control with
finitely many switches.  The terminal condition y(1) = y(0) is dropped
(default) or imposed softly with ``terminal_weight > 0``, which adds
``w·‖y − y⁰‖²`` to the running cost over the final ``terminal_frac`` of the
horizon.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_dtype
from ..objectives.ode import RowwiseODEObjective, _numpy_dtype
from ..ops.levels import product_levels

__all__ = ["FullerObj"]


class FullerObj(RowwiseODEObjective):
    def __init__(self, nt: int = 1000, *, state0=(0.01, 0.0),
                 terminal_weight: float = 0.0, terminal_frac: float = 0.05,
                 device=None, dtype=None):
        self.terminal_weight = float(terminal_weight)
        self.terminal_frac = float(terminal_frac)
        self.target = np.asarray(state0, dtype=_numpy_dtype(resolve_dtype(dtype)))
        V = [[0, 1]]
        adm = product_levels(V)
        super().__init__(T0=0.0, T1=1.0, nt=nt, state0=state0, V=V, admissible=adm,
                         device=device, dtype=dtype)
        self._target = torch.as_tensor(self.target, device=self.device)

    # Dynamics: a double integrator driven by the signed control 1 − 2u.
    def _coupling(self, u):
        return 1.0 - 2.0 * u[..., 0]

    def _rhs(self, y, drive):
        return torch.stack([y[..., 1], drive], dim=-1)

    def _rhsT_lam(self, y, lam, drive):
        return torch.stack([torch.zeros_like(lam[..., 0]), lam[..., 0]], dim=-1)

    def Fy(self, y, u, i):
        z = torch.zeros_like(y[..., 0])
        return torch.stack([torch.stack([z, z + 1.0], dim=-1),
                            torch.stack([z, z], dim=-1)], dim=-2)

    def Fu(self, y, u, i):
        z = torch.zeros_like(y[..., :1])
        return torch.stack([z, z - 2.0], dim=-2)

    def _terminal_mask(self, i):
        """1 on the last ``terminal_frac`` of the steps, else 0: a select on
        the time index, which is an int or a tensor of indices (the batched
        running cost passes all of them at once)."""
        thresh = self.nt * (1.0 - self.terminal_frac)
        if isinstance(i, torch.Tensor):
            return torch.where(i >= thresh, 1.0, 0.0).to(self.dtype)
        return 1.0 if i >= thresh else 0.0

    # Running cost y₁² (+ the optional soft terminal tracking near t = T1).
    def G(self, y, u, i):
        g = y[..., 0] ** 2
        if self.terminal_weight > 0.0:
            d = y - self._target
            g = g + self.terminal_weight * self._terminal_mask(i) * (
                d[..., 0] ** 2 + d[..., 1] ** 2)
        return g

    def Gy(self, y, u, i):
        gy = torch.stack([2.0 * y[..., 0], torch.zeros_like(y[..., 0])], dim=-1)
        if self.terminal_weight > 0.0:
            on = self._terminal_mask(i)
            if isinstance(on, torch.Tensor):
                on = on[..., None]
            gy = gy + 2.0 * self.terminal_weight * on * (y - self._target)
        return gy

    def Gu(self, y, u, i):
        return torch.zeros_like(u)
