"""Double-tank multimode problem (mintoc.de).

Counterpart of ``mioc_tpu.models.doubletank`` (the reference's
``example_doubletank.jl``): sqrt outflow dynamics (the state must stay
positive), SOS1 inflow modes, tracking objective ``k1 (y2 − k2)²``.

The sweeps round as the JAX package's compiled CPU sweeps do
(:mod:`~mioc_tpu_torch.ops.xla_order`), at the default parameters, so f, ∇f,
the states and the adjoints equal the JAX package's bit for bit, on the CPU
and on the card:

* the inflow ``u·c`` is :func:`~mioc_tpu_torch.ops.xla_order.const_dot`;
  the square roots are :func:`~mioc_tpu_torch.ops.xla_order.sqrt` and the
  quotient ``−1/(2√y)`` a division, both correctly rounded on the CPU and on
  CUDA (PyTorch's own CPU ``sqrt`` is not, and is corrected);
* the Euler step is ``fma(τ, F, y)``; the running cost ``(y₁ − k₂)²`` times
  the trapezoid weight times ``k₁`` (XLA folds the two constants), summed by
  :func:`~mioc_tpu_torch.ops.xla_order.window_sum`;
* the adjoint step is ``fma(τ, Fyᵀλ − G_y, λ)`` with ``i = −1/(2√y)``:
  ``(Fyᵀλ)₀ = fma(i₀, λ₀, −(i₀λ₁))`` and ``(Fyᵀλ − G_y)₁ = i₁λ₁ − 2k₁(y₁ −
  k₂)``, whose product is fused at the last step of each unrolled body of
  the JAX scan (every ``sweep_unroll``-th step and the scan's last;
  :func:`~mioc_tpu_torch.objectives.ode.scan_rules`) and rounded elsewhere.

The state is an ``(S, 2)`` tensor and both components step together: 4
small ops a forward step (the root of both components, the ``(a, √y₀)``
pair, the difference and the fused step) and ~12 an adjoint step, against 7
and 20 in the row form they replace (PyTorch operations that launch work,
views not counted, the root one operation as on the card).  The tests hold
the bits at nt = 32 … 40, 48, 57, 240 and 1024 and sweep_unroll 1, 2, 4 and 8
(``tests/test_torch_ode_bits.py``); below nt = 32 the JAX trapezoid sum is
one fused reduction that rounds otherwise.  The adjoint steps JAX leaves
after the last trip of its scan run as straight code that XLA fuses with
its neighbours, and there it can carry a λ with another contraction than
the λ it stores: at unroll 8, nt = 200, seed 1 one λ entry rounds
otherwise (∇f is equal).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_dtype
from ..objectives.base import sweep_span
from ..objectives.ode import RowwiseODEObjective, _numpy_dtype
from ..ops.levels import bounded_sum_levels
from ..ops.xla_order import const_dot, fma, sqrt, window_sum

__all__ = ["DTMObj"]

# Per adjoint step in scan order: "F" fuses i₁λ₁ into the step's sum, "R"
# rounds it (scan_rules; read off the JAX sweeps at nt = 32 … 1024).
_ADJ = {1: {"body": "F", "rest": "F"},
        2: {"body": "RF", 1: "F", "rest": "F"},
        4: {"body": "RRRF", 1: "F", 2: "RF", 3: "RRF", "rest": "R"},
        8: {"body": "RRRRRRRF", **{r: "R" * (r - 1) + "F" for r in range(1, 8)}, "rest": "R"},
        "straight": {"rest": "R"}}


class DTMObj(RowwiseODEObjective):
    _adjoint_rules = _ADJ

    def __init__(self, nt: int = 1000, *, k1=2.0, k2=3.0, c=(1.0, 0.5, 2.0),
                 state0=(2.0, 2.0), device=None, dtype=None):
        self.k1, self.k2 = float(k1), float(k2)
        self.c = np.asarray(c, dtype=_numpy_dtype(resolve_dtype(dtype)))
        V = [[0, 1], [0, 1], [0, 1]]
        adm = bounded_sum_levels(V, 1, 1)
        super().__init__(T0=0.0, T1=10.0, nt=nt, state0=state0, V=V, admissible=adm,
                         device=device, dtype=dtype)
        self._c = torch.as_tensor(self.c, device=self.device)
        self._tau_t = torch.tensor(self.tau, dtype=self.dtype, device=self.device)

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
        s1 = sqrt(y[..., 0])
        return torch.stack([a - s1, s1 - sqrt(y[..., 1])], dim=-1)

    def _rhsT_lam(self, y, lam, a):
        i1 = -1.0 / (2.0 * sqrt(y[..., 0]))
        return torch.stack([
            i1 * lam[..., 0] - i1 * lam[..., 1],
            (-1.0 / (2.0 * sqrt(y[..., 1]))) * lam[..., 1],
        ], dim=-1)

    def Fy(self, y, u, i):
        i1 = -1.0 / (2.0 * sqrt(y[..., 0]))
        i2 = -1.0 / (2.0 * sqrt(y[..., 1]))
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

    # -- sweeps in the JAX package's CPU rounding (module docstring) -----------
    @sweep_span("f")
    def _forward_batch(self, xs):
        tau, nt = self.tau, self.nt
        S = xs.shape[0]
        a = self.step_terms(xs).transpose(0, 1)[..., None].contiguous()  # (nt, S, 1)
        y0 = self.state0.expand(S, self.ny)
        y = y0
        ys = []
        for k in range(nt):
            s = sqrt(y)
            y = fma(torch.cat([a[k], s[:, :1]], dim=-1) - s, self._tau_t, y)
            ys.append(y)
        ys = torch.stack(ys)  # (nt, S, ny)
        d = torch.cat([y0[None], ys])[..., 1].transpose(0, 1) - self.k2  # (S, nt+1)
        return tau * window_sum((d * d) * (self.k1 * self._trap_w)), ys

    @sweep_span("df")
    def _adjoint_batch(self, xs, ys):
        nt = self.nt
        S = xs.shape[0]
        g = 2.0 * self.k1
        lam = -0.5 * self.tau * self.Gy(ys[-1], None, nt)  # ODEObjective.jl:165-166
        lams = [lam]
        rules = self.adjoint_rules()
        for i, rule in enumerate(rules):
            y = ys[nt - 2 - i]  # uses (y_{k+1}, u_{k+1}) = (ys[k], x[k+1]), k = nt-2-i
            inv = -0.5 / sqrt(y)  # −1/(2√y), the same quotient
            gy = g * (y[:, 1:] - self.k2)
            if rule == "F":
                rest = torch.cat([-(inv[:, :1] * lam[:, 1:]), -gy], dim=-1)
                inner = fma(inv, lam, rest)
            else:
                p = inv * lam  # (i₀λ₀ unused, i₁λ₁ rounded)
                inner = torch.cat([fma(inv[:, :1], lam[:, :1], -(inv[:, :1] * lam[:, 1:])),
                                   p[:, 1:] - gy], dim=-1)
            lam = fma(inner, self._tau_t, lam)
            lams.append(lam)
        lam = torch.stack(lams[::-1], dim=1)  # (S, nt, ny), 0-based k
        ys0 = torch.cat([self.state0.expand(1, S, self.ny), ys[:-1]]).transpose(0, 1)
        return self.df_rows(ys0, xs, lam), lam

    def df_rows(self, ys0, x, lam):
        # −F_uᵀλ + G_u: the dot's chain fma(0, λ₁, c·λ₀), negated, plus 0.
        cl = self._c * lam[..., :1]
        return -fma(torch.zeros_like(cl), lam[..., 1:], cl) + 0.0
