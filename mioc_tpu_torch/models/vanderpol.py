"""Van der Pol oscillator, binary variant (mintoc.de).

Counterpart of ``mioc_tpu.models.vanderpol`` (the reference's
``example_vanderpol.jl``).  The ODE is unstable: explicit Euler may overflow
on coarse grids (``example_vanderpol.jl:3``).  An overflow gives a
non-finite f, never an exception, and the TRM treats it as a rejected step.

The sweeps round as the JAX package's compiled CPU sweeps do
(:mod:`~mioc_tpu_torch.ops.xla_order`), at the default parameters, so f, ∇f,
the states and the adjoints equal the JAX package's bit for bit, on the CPU
and on the card (where a sweep overflows, NaN stands where the JAX package
has NaN, whatever its sign bit):

* the mode coefficient ``cu = u·c`` is
  :func:`~mioc_tpu_torch.ops.xla_order.const_dot`, ``fma(0.75, u₁, −u₀) −
  2u₂`` at the default ``c`` (the −1 multiplies nothing);
* with ``q = fma(−y₀, y₀, 1)``, the Euler step is ``fma(τ, F, y)`` with
  ``F = (y₁, fma(q·y₁, cu, −y₀))``; the running cost ``fma(y₀, y₀, y₁²)``
  times the trapezoid weight, summed by
  :func:`~mioc_tpu_torch.ops.xla_order.window_sum`;
* the adjoint step is ``fma(τ, Fyᵀλ − 2y, λ)`` with ``A = fma(−2y₀·y₁, cu,
  −1)``: ``(·)₁ = fma(q·cu, λ₁, λ₀) − 2y₁``, and ``(·)₀ = A·λ₁ − 2y₀``, whose
  product is fused at the last step of each unrolled body of the JAX scan
  (every ``sweep_unroll``-th step and the scan's last;
  :func:`~mioc_tpu_torch.objectives.ode.scan_rules`) and rounded elsewhere;
* a gradient entry is ``fma(−q·y₁·c_m, λ₁, −(0·λ₀))`` (XLA's dot of −F_u with λ).

The state is an ``(S, 2)`` tensor: 6 small ops a forward step and 13 an
adjoint step, against 8 and 15 in the row form they replace (PyTorch
operations that launch work, views not counted).  On the card each sweep
after the first at its shape replays those ops from a CUDA graph
(:mod:`~mioc_tpu_torch.ops.graphs`): the same kernels on the same operands,
so the same bits, run back to back on the card instead of one host call
each; only the mode coefficient ``cu`` (a few ops) is computed outside it.  The tests
hold the bits at nt = 32 … 40, 48, 57, 240 and 1024 and sweep_unroll 1, 2, 4 and
8 (``tests/test_torch_ode_bits.py``); below nt = 32 the JAX trapezoid sum is
one fused reduction that rounds otherwise.  The adjoint steps JAX leaves
after the last trip of its scan run as straight code that XLA fuses with
its neighbours: at unroll 8 the scan's last step can give one λ entry that
rounds otherwise (nt = 32, seed 4; nt = 39, a relaxed control).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_dtype
from ..objectives.base import sweep_span
from ..objectives.ode import RowwiseODEObjective, _numpy_dtype
from ..ops.graphs import SweepGraphs
from ..ops.levels import bounded_sum_levels
from ..ops.xla_order import const_dot, fma, window_sum

__all__ = ["VPOObj"]

# Per adjoint step in scan order: "F" fuses A·λ₁ into (Fyᵀλ − 2y)₀, "R"
# rounds it (scan_rules; read off the JAX sweeps at nt = 32 … 1024).
_ADJ = {1: {"body": "F", "rest": "F"},
        2: {"body": "RF", 1: "F", "rest": "F"},
        4: {"body": "RRRF", **{r: "R" * (r - 1) + "F" for r in range(1, 4)}, "rest": "R"},
        8: {"body": "RRRRRRRF", **{r: "R" * (r - 1) + "F" for r in range(1, 8)}, "rest": "R"},
        "straight": {"rest": "R"}}


class VPOObj(RowwiseODEObjective):
    _adjoint_rules = _ADJ
    def __init__(self, nt: int = 2000, *, c=(-1.0, 0.75, -2.0), state0=(1.0, 0.0),
                 device=None, dtype=None):
        self.c = np.asarray(c, dtype=_numpy_dtype(resolve_dtype(dtype)))
        V = [[0, 1], [0, 1], [0, 1]]
        adm = bounded_sum_levels(V, 1, 1)
        super().__init__(T0=0.0, T1=20.0, nt=nt, state0=state0, V=V, admissible=adm,
                         device=device, dtype=dtype)
        self._c = torch.as_tensor(self.c, device=self.device)
        self._tau_t = torch.tensor(self.tau, dtype=self.dtype, device=self.device)
        self._graphs = SweepGraphs()

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

    # -- sweeps in the JAX package's CPU rounding (module docstring) -----------
    @sweep_span("f")
    def _forward_batch(self, xs):
        return self._graphs(self._forward_steps, self._cu(xs))

    @sweep_span("df")
    def _adjoint_batch(self, xs, ys):
        return self._graphs(self._adjoint_steps, xs, self._cu(xs), ys,
                            key=self.scan_unroll())

    def _cu(self, xs):
        """The mode coefficient of every row and step, ``(nt, S, 1)``."""
        return self.step_terms(xs).transpose(0, 1)[..., None].contiguous()

    def _forward_steps(self, cu):
        tau, nt = self.tau, self.nt
        S = cu.shape[1]
        one = torch.ones((), dtype=cu.dtype, device=cu.device)
        y0 = self.state0.expand(S, self.ny)
        y = y0
        ys = []
        for k in range(nt):
            ny0 = -y[:, :1]
            q = fma(ny0, y[:, :1], one)
            F = torch.cat([y[:, 1:], fma(q * y[:, 1:], cu[k], ny0)], dim=-1)
            y = fma(F, self._tau_t, y)
            ys.append(y)
        ys = torch.stack(ys)  # (nt, S, ny)
        yall = torch.cat([y0[None], ys]).transpose(0, 1)  # (S, nt+1, ny)
        a, b = yall[..., 0], yall[..., 1]
        return tau * window_sum(self._trap_w * fma(a, a, b * b)), ys

    def _adjoint_steps(self, xs, cu, ys):
        nt = self.nt
        S = xs.shape[0]
        one = torch.ones((), dtype=xs.dtype, device=xs.device)
        minus_one = -one
        lam = -0.5 * self.tau * self.Gy(ys[-1], None, nt)  # ODEObjective.jl:165-166
        lams = [lam]
        rules = self.adjoint_rules()
        for i, rule in enumerate(rules):
            k = nt - 2 - i  # uses (y_{k+1}, u_{k+1}) = (ys[k], x[k+1])
            y = ys[k]
            y0, y1, l0, l1 = y[:, :1], y[:, 1:], lam[:, :1], lam[:, 1:]
            c = cu[k + 1]
            A = fma((-2.0 * y0) * y1, c, minus_one)
            q = fma(-y0, y0, one)
            gy = 2.0 * y
            i0 = fma(A, l1, -gy[:, :1]) if rule == "F" else A * l1 - gy[:, :1]
            inner = torch.cat([i0, fma(q * c, l1, l0) - gy[:, 1:]], dim=-1)
            lam = fma(inner, self._tau_t, lam)
            lams.append(lam)
        lam = torch.stack(lams[::-1], dim=1)  # (S, nt, ny), 0-based k
        ys0 = torch.cat([self.state0.expand(1, S, self.ny), ys[:-1]]).transpose(0, 1)
        return self.df_rows(ys0, xs, lam), lam

    def df_rows(self, ys0, x, lam):
        # −F_uᵀλ + G_u as XLA computes it: the dot of −F_u's columns with λ
        # from (−0)·λ₀ (NaN where λ₀ is not finite), G_u's zeros dropped.
        y0, y1, l0 = ys0[..., :1], ys0[..., 1:], lam[..., :1]
        q = fma(-y0, y0, torch.ones((), dtype=x.dtype, device=x.device))
        row = (q * y1) * self._c
        return fma(-row, lam[..., 1:], -(0.0 * l0).expand_as(row))
