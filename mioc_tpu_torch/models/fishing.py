"""Lotka-Volterra multimode fishing problem (mintoc.de).

Counterpart of ``mioc_tpu.models.fishing`` (the reference's
``example_fishing.jl``): three binary SOS1 controls select a fishing mode;
tracking objective ½‖y − 1‖².

The sweeps round as the JAX package's compiled CPU sweeps do
(:mod:`~mioc_tpu_torch.ops.xla_order`), at the default parameters (the
products with α, β, γ, δ, c₁ and c₂ exact), so f, ∇f and the states equal
the JAX package's bit for bit, on the CPU and on the card, for binary and
relaxed controls alike:

* the couplings ``v·w`` are :func:`~mioc_tpu_torch.ops.xla_order.const_dot`;
* the Euler step is ``fma(τ, F, y)``; the running cost ``½·fma(d₀, d₀,
  d₁²)`` with ``d = y − 1`` (XLA factors the halves), summed by
  :func:`~mioc_tpu_torch.ops.xla_order.window_sum`;
* the adjoint step is ``fma(τ, Fyᵀλ − (y − 1), λ)`` with ``Fyᵀλ =
  (fma(S₀, λ₀, δy₁·λ₁), fma(S₁, λ₁, −βy₀·λ₀))``, ``S`` the bracketed
  factors of F — except where the JAX scan's place of the step says
  ``fma(δy₁, λ₁, S₀λ₀)`` for the first sum (every step at
  ``sweep_unroll`` 1, every other step at 2; the table ``_ADJ``, read
  through :func:`~mioc_tpu_torch.objectives.ode.scan_rules`); a gradient
  entry is ``fma(c₂y₁·w₂, λ₁, c₁y₀·w₁·λ₀)``.

On the card, in float64 and in float32, each sweep is one launch of
``csrc/ode_lvm.cu`` (:mod:`~mioc_tpu_torch.ops.ode_cuda`), one thread per
row, with the same bits: the couplings ``A`` come from
:meth:`LVMObj._couplings` as for the plain sweeps, and the adjoint's rule
letters from a table built on first use (:meth:`LVMObj._rules_on_device`).
On the CPU the sweeps are the plain PyTorch ones
(:meth:`LVMObj._forward_batch_torch`, :meth:`LVMObj._adjoint_batch_torch`):
the state is an ``(S, 2)`` tensor and both components step together (``S =
fma(K1, y_swapped, K0) − A`` with ``K0 = (α, −γ)``, ``K1 = (−β, δ)``).
The tests hold the bits against the JAX package at nt = 32 … 1200
(``tests/test_torch_tv_ode.py``), at unroll 1, 2 and 4, and at nt = 33 …
40 at every unroll (``tests/test_torch_ode_bits.py``).  The steps JAX
leaves after the last trip of a scan run as straight code, which XLA fuses
with its neighbours;
where 7 forward or 6 adjoint steps are left (unroll 8 at nt = 39, 47, 63,
…) a state or λ of the first steps can round otherwise, and ∇f there
agrees to rounding only.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_dtype
from ..objectives.base import sweep_span
from ..objectives.ode import RowwiseODEObjective, _numpy_dtype
from ..ops import ode_cuda
from ..ops.levels import bounded_sum_levels
from ..ops.xla_order import const_dot, fma, window_sum
from ..utils import trace

__all__ = ["LVMObj"]

# Per adjoint step in scan order, which product of (Fyᵀλ)₀ = S₀λ₀ + δy₁λ₁ is
# fused: "4" the first, "5" the second (scan_rules; read off the JAX sweeps
# at nt = 32 … 1024).
_ADJ = {1: {"body": "5", "rest": "5"},
        2: {"body": "54", 1: "4", "rest": "4"},
        4: {"body": "4444", 2: "45", 3: "445", "rest": "4"},
        8: {"body": "4" * 8, 2: "45", "rest": "4"},
        "straight": {"rest": "4"}}


class LVMObj(RowwiseODEObjective):
    _adjoint_rules = _ADJ
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
        self._tau_t = torch.tensor(self.tau, dtype=self.dtype, device=self.device)

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

    # -- sweeps in the JAX package's CPU rounding (module docstring) -----------
    _rule_table = (None, None)  # ((nt, unroll, device), the adjoint kernel's letters)

    def _rules_on_device(self, device):
        """The adjoint kernel's rule table on ``device``
        (:func:`~mioc_tpu_torch.ops.ode_cuda.rule_table` of
        :meth:`adjoint_rules`), built on first use and again where ``nt`` or
        ``sweep_unroll`` changed since, as the plain sweep reads the rules at
        every evaluation."""
        key = (self.nt, self.scan_unroll(), device)
        if self._rule_table[0] != key:
            self._rule_table = (key, ode_cuda.rule_table(self.adjoint_rules(), device))
        return self._rule_table[1]

    def _couplings(self, xs):
        """The couplings ``(a, c)`` of every row and step, time-major ``(nt,
        S, 2)``."""
        a, c = self.step_terms(xs)  # (S, nt) each
        return torch.stack([a, c], dim=-1).transpose(0, 1).contiguous()

    def _step_consts(self, xs):
        A = self._couplings(xs)
        K0 = torch.tensor([self.alpha, -self.gamma], dtype=xs.dtype, device=xs.device)
        K1 = torch.tensor([-self.beta, self.delta], dtype=xs.dtype, device=xs.device)
        return A, K0, K1

    @sweep_span("f")
    def _forward_batch(self, xs):
        if xs.is_cuda:
            trace.annotate(path="kernel")
            return ode_cuda.lvm_forward(self._couplings(xs), self.state0, self.alpha,
                                        self.beta, self.gamma, self.delta, self.tau)
        return self._forward_batch_torch(xs)

    @sweep_span("df")
    def _adjoint_batch(self, xs, ys):
        if xs.is_cuda:
            trace.annotate(path="kernel")
            return ode_cuda.lvm_adjoint(self._couplings(xs), ys,
                                        self._rules_on_device(xs.device), self.state0,
                                        self._v1, self._v2, self.alpha, self.beta, self.gamma,
                                        self.delta, self.c1, self.c2, self.tau)
        return self._adjoint_batch_torch(xs, ys)

    def _forward_batch_torch(self, xs):
        """The plain forward sweep: a few small ops a step."""
        tau, nt = self.tau, self.nt
        S = xs.shape[0]
        A, K0, K1 = self._step_consts(xs)
        y0 = self.state0.expand(S, self.ny)
        y = y0
        ys = []
        for k in range(nt):
            y = fma(y * (fma(K1, y.flip(-1), K0) - A[k]), self._tau_t, y)
            ys.append(y)
        ys = torch.stack(ys)  # (nt, S, ny)
        yall = torch.cat([y0[None], ys]).transpose(0, 1)  # (S, nt+1, ny)
        d0, d1 = yall[..., 0] - 1.0, yall[..., 1] - 1.0
        return tau * window_sum(self._trap_w * (0.5 * fma(d0, d0, d1 * d1))), ys

    def _adjoint_batch_torch(self, xs, ys):
        """The plain adjoint sweep: about a dozen small ops a step."""
        tau, nt = self.tau, self.nt
        S = xs.shape[0]
        A, K0, K1 = self._step_consts(xs)
        K1f = K1.flip(-1)  # (δ, −β)
        lam = -0.5 * tau * (ys[-1] - 1.0)  # ODEObjective.jl:165-166
        lams = [lam]
        rules = self.adjoint_rules()
        for i, rule in enumerate(rules):
            k = nt - 2 - i  # uses (y_{k+1}, u_{k+1}) = (ys[k], x[k+1])
            y = ys[k]
            yf = y.flip(-1)
            s = fma(K1, yf, K0) - A[k + 1]
            c = K1f * yf  # (δy₁, −βy₀)
            if rule == "4":  # (fma(S₀, λ₀, δy₁·λ₁), fma(S₁, λ₁, −βy₀·λ₀))
                ft = fma(s, lam, c * lam.flip(-1))
            else:  # (fma(δy₁, λ₁, S₀λ₀), fma(S₁, λ₁, −βy₀·λ₀))
                ft = fma(torch.cat([c[:, :1], s[:, 1:]], dim=-1), lam[:, 1:],
                         lam[:, :1] * torch.cat([s[:, :1], c[:, 1:]], dim=-1))
            lam = fma(ft - (y - 1.0), self._tau_t, lam)
            lams.append(lam)
        lam = torch.stack(lams[::-1], dim=1)  # (S, nt, ny), 0-based k
        ys0 = torch.cat([self.state0.expand(1, S, self.ny), ys[:-1]]).transpose(0, 1)
        return self.df_rows(ys0, xs, lam), lam

    def df_rows(self, ys0, x, lam):
        a0 = (self.c1 * ys0[..., 0:1]) * self._v1
        a1 = (self.c2 * ys0[..., 1:2]) * self._v2
        return fma(a1, lam[..., 1:2], a0 * lam[..., 0:1])
