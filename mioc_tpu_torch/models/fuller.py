"""Fuller's problem (mintoc.de), the canonical chattering benchmark.

Counterpart of ``mioc_tpu.models.fuller``.  Binary variant::

    min  ∫₀¹ y₁(t)² dt     s.t.   y₁' = y₂,   y₂' = 1 − 2u,   u(t) ∈ {0, 1}

with y(0) = (0.01, 0).  The unregularized optimal control switches
infinitely often in finite time; with β > 0 the TRM returns a control with
finitely many switches.  The terminal condition y(1) = y(0) is dropped
(default) or imposed softly with ``terminal_weight > 0``, which adds
``w·‖y − y⁰‖²`` to the running cost over the final ``terminal_frac`` of the
horizon.

The sweeps round as the JAX package's compiled CPU sweeps do
(:mod:`~mioc_tpu_torch.ops.xla_order`), so f, ∇f, the states and the
adjoints equal the JAX package's bit for bit, on the CPU and on the card:
the Euler step is ``fma(τ, (y₁, 1 − 2u), y)``, the adjoint step ``fma(τ,
(0 − 2y₀, λ₀), λ)``, the running cost ``y₀²`` times the trapezoid weight
summed by :func:`~mioc_tpu_torch.ops.xla_order.window_sum`, a gradient entry
``2λ₁ + 0``.  No step's rounding depends on its place in the scan, so every
``sweep_unroll`` is reproduced.  With ``terminal_weight > 0`` the running
cost is ``fma(w·mask, fma(d₁, d₁, d₀²), y₀²)`` with ``d = y − y⁰``, and
``G_y`` gains ``2w·mask·d``, its product fused but at the last step of each
unrolled body of the JAX scan (``_TERMINAL_ADJ``, read through
:func:`~mioc_tpu_torch.objectives.ode.scan_rules`): the JAX bits at
sweep_unroll 1, 2, 4 and 8, or where the scan is straight code; another
unroll is refused.  The masked weights are tensors built once, so a step
on the card copies nothing from the host.  The state is an ``(S, 2)``
tensor: 2 small ops a forward step and 4 an adjoint step, against 3 and 8 in
the row form they replace.  The tests hold the bits at nt = 32 … 40, 48,
57, 240 and 1024 (``tests/test_torch_ode_bits.py``); below nt = 32 the JAX
trapezoid sum is one fused reduction that rounds otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_dtype
from ..objectives.base import sweep_span
from ..objectives.ode import RowwiseODEObjective, _numpy_dtype
from ..ops.levels import product_levels
from ..ops.xla_order import fma, window_sum

__all__ = ["FullerObj"]

# With a terminal weight, per adjoint step in scan order: "F" fuses the
# masked product of G_y into its sum, "R" rounds it: rounded at the last step
# of each unrolled body (scan_rules; read off the JAX sweeps at nt = 33 …
# 1024).  The mask is 0 but on the scan's first steps, so a remainder's
# letters never matter at nt ≥ 32.
_TERMINAL_ADJ = {u: {"body": "F" * (u - 1) + "R", "rest": "F"} for u in (1, 2, 4, 8)}
_TERMINAL_ADJ["straight"] = {"rest": "F"}


class FullerObj(RowwiseODEObjective):
    def __init__(self, nt: int = 1000, *, state0=(0.01, 0.0),
                 terminal_weight: float = 0.0, terminal_frac: float = 0.05,
                 device=None, dtype=None):
        self.terminal_weight = float(terminal_weight)
        self.terminal_frac = float(terminal_frac)
        if self.terminal_weight > 0.0:
            self._adjoint_rules = _TERMINAL_ADJ
        self.target = np.asarray(state0, dtype=_numpy_dtype(resolve_dtype(dtype)))
        V = [[0, 1]]
        adm = product_levels(V)
        super().__init__(T0=0.0, T1=1.0, nt=nt, state0=state0, V=V, admissible=adm,
                         device=device, dtype=dtype)
        self._target = torch.as_tensor(self.target, device=self.device)
        self._tau_t = torch.tensor(self.tau, dtype=self.dtype, device=self.device)
        # The masked weights w·mask(i) of G and 2w·mask(i) of G_y at every
        # time index i = 0 … nt.
        on = self._terminal_mask(torch.arange(self.nt + 1, device=self.device))
        self._g_w = self.terminal_weight * on
        self._gy_w = 2.0 * self.terminal_weight * on

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
        the time index, an int or a tensor of indices."""
        thresh = self.nt * (1.0 - self.terminal_frac)
        if isinstance(i, torch.Tensor):
            return torch.where(i >= thresh, 1.0, 0.0).to(self.dtype)
        return 1.0 if i >= thresh else 0.0

    # Running cost y₁² (+ the optional soft terminal tracking near t = T1),
    # as XLA's CPU code computes it (0-based components, module docstring).
    def G(self, y, u, i):
        g = y[..., 0] ** 2
        if self.terminal_weight > 0.0:
            d = y - self._target
            g = fma(self._g_w[i], fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0]), g)
        return g

    def Gy(self, y, u, i, rule="F"):
        gy = torch.stack([2.0 * y[..., 0], torch.zeros_like(y[..., 0])], dim=-1)
        if self.terminal_weight > 0.0:
            w = self._gy_w[i]
            if w.dim():
                w = w[..., None]
            # The masked term's product, fused ("F") or rounded ("R").
            d = y - self._target
            gy = fma(w, d, gy) if rule == "F" else gy + w * d
        return gy

    def Gu(self, y, u, i):
        return torch.zeros_like(u)

    # -- sweeps in the JAX package's CPU rounding (module docstring) -----------
    @sweep_span("f")
    def _forward_batch(self, xs):
        tau, nt = self.tau, self.nt
        S = xs.shape[0]
        drive = self.step_terms(xs).transpose(0, 1)[..., None].contiguous()  # (nt, S, 1)
        y0 = self.state0.expand(S, self.ny)
        y = y0
        ys = []
        for k in range(nt):
            y = fma(torch.cat([y[:, 1:], drive[k]], dim=-1), self._tau_t, y)
            ys.append(y)
        ys = torch.stack(ys)  # (nt, S, ny)
        yall = torch.cat([y0[None], ys]).transpose(0, 1)  # (S, nt+1, ny)
        g = self.G(yall, None, self._g_idx)
        return tau * window_sum(self._trap_w * g), ys

    @sweep_span("df")
    def _adjoint_batch(self, xs, ys):
        nt = self.nt
        S = xs.shape[0]
        lam = -0.5 * self.tau * self.Gy(ys[-1], None, nt)  # ODEObjective.jl:165-166
        lams = [lam]
        rules = self.adjoint_rules()
        for i in range(nt - 1):
            k = nt - 2 - i  # uses (y_{k+1}, u_{k+1}) = (ys[k], x[k+1])
            if self.terminal_weight > 0.0:
                gy = self.Gy(ys[k], None, k + 1, rules[i])
                inner = torch.cat([0.0 - gy[:, :1], lam[:, :1] - gy[:, 1:]], dim=-1)
            else:  # G_y = (2y₀, 0), and λ₀ − 0 is λ₀ for every λ₀
                inner = torch.cat([0.0 - 2.0 * ys[k][:, :1], lam[:, :1]], dim=-1)
            lam = fma(inner, self._tau_t, lam)
            lams.append(lam)
        lam = torch.stack(lams[::-1], dim=1)  # (S, nt, ny), 0-based k
        ys0 = torch.cat([self.state0.expand(1, S, self.ny), ys[:-1]]).transpose(0, 1)
        return self.df_rows(ys0, xs, lam), lam

    def df_rows(self, ys0, x, lam):
        return 2.0 * lam[..., 1:] + 0.0
