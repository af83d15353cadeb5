"""Mixed continuous + integer optimal control.

Counterpart of ``mioc_tpu.solvers.mixed``: a block-coordinate solver for

    min_{u, v}  f(u, v) + β·TV_p(v)
    s.t.  umin ≤ u(t) ≤ umax   (continuous block, pointwise bounds)
          v(t) ∈ 𝓥             (integer block, admissible level set)

alternating (i) projected-gradient descent with Armijo backtracking on the
continuous block and (ii) a full TV trust-region solve (Bellman DP
subproblem) on the integer block, until neither block improves.

Objectives: any port :class:`~mioc_tpu_torch.objectives.base.LazyObjective`
with ``nu > 0``, ``nv > 0``, pointwise bound attributes ``umin``/``umax``
(broadcastable to ``(nt, nu)``) and ``_forward``/``_adjoint`` sweeps over the
full control ``(nt, nu+nv)``.  The solve runs on the objective's device: on
the card the integer block's TRM launches ``dp_build`` for every build and
``chase`` for every chase (:func:`~.trm.trm_solve`).  The Armijo sum
``Σ g·step`` is a fixed-order reduction, the JAX package's (an eager
``jnp.sum`` of an ``(nt, 1)`` array: :func:`~mioc_tpu_torch.ops.xla_order.window_sum`),
and ``history`` holds Python floats.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..objectives.base import LazyObjective
from ..ops.tv import tv_p
from ..ops.xla_order import window_sum
from ..utils.checks import check_nan
from ..utils.init import rand_func
from .trm import TRMParameters, trm_solve

__all__ = ["MixedParameters", "MixedResult", "mixed_solve"]


@dataclass
class MixedParameters:
    trm: TRMParameters = field(default_factory=TRMParameters)
    rounds: int = 20           # max block alternations
    cont_steps: int = 30       # projected-gradient steps per round
    cont_alpha0: float = 1.0   # initial step size
    cont_beta: float = 0.5     # Armijo backtracking factor
    cont_sigma: float = 1e-4   # Armijo sufficient-decrease fraction
    tol: float = 1e-10         # minimum per-round improvement


@dataclass
class MixedResult:
    J: float                  # f + β·TV_p(v)
    x: np.ndarray             # full control (nt, nu+nv)
    rounds: int
    converged: bool
    history: list             # J after each half-step


class _IntegerBlockView(LazyObjective):
    """Expose the integer block of a mixed objective as a pure-integer
    LazyObjective (the continuous block is held fixed), so the unmodified TRM
    drives the Bellman subproblem on it."""

    def __init__(self, base, u_fixed):
        super().__init__()
        self._base = base
        self.device, self.dtype = base.device, base.dtype
        self._u = self.as_control(u_fixed)
        self.T0, self.T1 = base.T0, base.T1
        self.nt, self.tau = base.nt, base.tau
        self.nu, self.nv = 0, base.nv
        self.V = base.V
        self.admissible = base.admissible
        self.x = base.x[:, base.nu:]

    def _full(self, v):
        return torch.cat([self._u, v], dim=1)

    def eval_f_impl(self, v, cache: bool):
        return self._base._forward(self._full(v))

    def eval_df_impl(self):
        df, _ = self._base._adjoint(self._full(self.x), self._aux)
        return df[:, self._base.nu:]


def _bounds(base, x):
    shape = (base.nt, base.nu)
    return tuple(torch.as_tensor(np.asarray(b, dtype=np.float64), dtype=x.dtype,
                                 device=x.device).broadcast_to(shape)
                 for b in (base.umin, base.umax))


def _pgd_continuous(base, x, par: MixedParameters):
    """Projected-gradient descent with Armijo on the continuous columns."""
    nu = base.nu
    umin, umax = _bounds(base, x)

    u = x[:, :nu]
    v = x[:, nu:]
    f, aux = base._forward(x)
    f = float(f)
    for _ in range(par.cont_steps):
        df, _ = base._adjoint(torch.cat([u, v], dim=1), aux)
        g = df[:, :nu]
        alpha = par.cont_alpha0
        improved = False
        while alpha > 1e-12:
            u_new = torch.clamp(u - alpha * g, umin, umax)
            # Sufficient decrease against the projected step length.
            step = u_new - u
            f_new, aux_new = base._forward(torch.cat([u_new, v], dim=1))
            f_new = float(f_new)
            decrease_req = par.cont_sigma * base.tau * float(window_sum((g * step).reshape(-1)))
            if f_new <= f + decrease_req and f_new < f:
                u, f, aux, improved = u_new, f_new, aux_new, True
                break
            alpha *= par.cont_beta
        if not improved:
            break
    return torch.cat([u, v], dim=1), f


def mixed_solve(obj, par: Optional[MixedParameters] = None, x0=None,
                seed: Optional[int] = None) -> MixedResult:
    """Block-coordinate mixed solve on ``obj.device``; returns the combined
    objective ``f + β·TV_p(v)`` and the full control."""
    par = par or MixedParameters()
    if obj.nu <= 0 or obj.nv <= 0:
        raise ValueError("mixed_solve needs nu > 0 and nv > 0 "
                         "(use trm_solve / opt_optimize for pure problems).")
    if x0 is None:
        x0 = rand_func(obj, seed=seed)
    x = obj.as_control(x0)
    beta, p = par.trm.beta, par.trm.p

    def total(xc, f):
        return check_nan(f + beta * float(tv_p(xc[:, obj.nu:], p)), "the mixed objective")

    f, _ = obj._forward(x)
    J = total(x, float(f))
    history = [J]
    converged = False
    rounds_done = 0

    for r in range(par.rounds):
        rounds_done = r + 1
        # (i) continuous block.
        x, f = _pgd_continuous(obj, x, par)
        history.append(total(x, f))

        # (ii) integer block via the TRM (Bellman DP subproblem).
        view = _IntegerBlockView(obj, x[:, :obj.nu])
        res = trm_solve(view, par.trm, x0=x[:, obj.nu:].cpu().numpy())
        x = torch.cat([x[:, :obj.nu], obj.as_control(res.u)], dim=1)
        f = res.f
        history.append(total(x, f))

        if history[-3] - history[-1] <= par.tol:
            converged = True
            break

    obj.x = x
    obj.eval_f_()
    obj.eval_df_()
    return MixedResult(
        J=history[-1], x=x.cpu().numpy(), rounds=rounds_done,
        converged=converged, history=history,
    )
