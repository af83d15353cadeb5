"""Smooth (continuous) optimizers: steepest descent and nonlinear CG with
Armijo / strong-Wolfe line searches.

Counterpart of ``mioc_tpu.solvers.continuous`` (the reference's
continuous-optimization stack):

  * step-size warm-start policies ``LSInitialStatic`` / ``LSInitialLastInc``
    (``LineSearches.jl:9-37``),
  * backtracking Armijo search (``LineSearches.jl:41-98``),
  * two-phase strong-Wolfe search with cubic/quadratic Hermite interpolation
    and noise-tolerant bracketing (``LineSearches.jl:100-348``),
  * ``SteepestDescent`` (``SteepestDescent.jl``) and Hager-Zhang ``NonlinCG``
    (``NonlinCG.jl``) driven by the ``opt_optimize`` loop
    (``AbstractLineSearchOptimizer.jl:31-44``).

All operate on any port :class:`~mioc_tpu_torch.objectives.base.Objective`
through the ``eval_f_`` / ``eval_df_`` / ``eval_fdf_`` protocol, on the
objective's device.  Every inner product is one fixed-order reduction read
back as a Python float, the order of the JAX package's ``jnp.vdot`` on its
CPU (:func:`~mioc_tpu_torch.ops.xla_order.vdot`, a fused multiply-add chain
run on the host), so a value depends neither on the device nor on the
batch, and a line search near convergence, which compares differences at
the level of f's rounding, takes the JAX package's steps.  The Hermite
solves stay numpy, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..ops.xla_order import vdot

__all__ = [
    "LSInitialStatic",
    "LSInitialLastInc",
    "ArmijoLS",
    "WolfeLS",
    "SteepestDescent",
    "NonlinCG",
    "opt_optimize",
]


def _dot(a, b) -> float:
    return vdot(a, b)


# -- initial step-size policies ----------------------------------------------

@dataclass
class LSInitialStatic:
    alpha0: float = 1.0

    def __call__(self):
        return self.alpha0

    def set_last_alpha(self, alpha):
        pass


@dataclass
class LSInitialLastInc:
    alpha0: float = 1.0
    beta: float = 2.0

    def __call__(self):
        return self.alpha0

    def set_last_alpha(self, alpha):
        self.alpha0 = alpha * self.beta


# -- line searches ------------------------------------------------------------

@dataclass
class ArmijoLS:
    """Backtracking Armijo (LineSearches.jl:41-98)."""

    beta: float = 0.5
    sigma: float = 0.1
    lsi: object = field(default_factory=LSInitialStatic)

    def apply(self, obj, d):
        alpha = self.lsi()
        fval = obj.f
        gd = _dot(obj.df, d)
        if gd >= 0:
            raise ValueError("Armijo: direction is not a descent direction")
        x_old = obj.x
        obj.x = x_old + alpha * d
        while obj.eval_f_() > fval + alpha * self.sigma * gd:
            alpha *= self.beta
            obj.x = x_old + alpha * d
            if alpha < 1e-10:
                raise RuntimeError("Armijo line search failed")
        self.lsi.set_last_alpha(alpha)
        return alpha


@dataclass
class WolfeLS:
    """Two-phase strong-Wolfe search with Hermite interpolation
    (LineSearches.jl:100-348)."""

    sigma: float = 1e-2
    beta: float = 0.5
    tau: float = 1e-1
    gamma: float = 2.0
    gamma1: float = 0.01
    gamma2: float = 0.01
    maxiter_phase1: int = 20
    maxiter_phase2: int = 40
    lsi: object = field(default_factory=LSInitialStatic)

    def __post_init__(self):
        assert 0.0 < self.sigma < self.tau < 1.0
        assert self.gamma > 1.0
        assert 0.0 < self.gamma1 <= 0.5 and 0.0 < self.gamma2 <= 0.5

    def apply(self, obj, d):
        f0 = obj.f
        df0d = _dot(obj.df, d)
        if df0d >= 0:
            raise ValueError("Wolfe: direction is not a descent direction")
        sdf0d = self.sigma * df0d
        f_eps = 1e-12 * (1.0 + abs(f0))
        x_old = obj.x

        def psi(t):
            obj.x = x_old + t * d
            ft = obj.eval_fdf_()
            return ft - (f0 + t * sdf0d), _dot(obj.df, d) - sdf0d

        def strong_wolfe(pv, pd):
            return pv <= f_eps and abs(pd + sdf0d) <= self.tau * abs(df0d)

        # Phase 1: bracket (LineSearches.jl:187-211).
        k = 1
        a, pa_v, pa_d = 0.0, 0.0, (1.0 - self.sigma) * df0d
        b = self.lsi()
        pb_v, pb_d = psi(b)
        while (
            k < self.maxiter_phase1
            and not strong_wolfe(pb_v, pb_d)
            and not (pb_v >= f_eps or pb_d >= 0)
        ):
            a, b = b, self.gamma * b
            pa_v, pa_d = pb_v, pb_d
            pb_v, pb_d = psi(b)
            k += 1
        if k == self.maxiter_phase1:
            raise RuntimeError("Strong Wolfe line search failed in Phase 1.")

        if strong_wolfe(pb_v, pb_d):
            self.lsi.set_last_alpha(b)
            return b

        # Phase 2: zoom with cubic/quadratic Hermite (LineSearches.jl:239-342).
        t = b
        for k in range(self.maxiter_phase2 + 1):
            if k == self.maxiter_phase2:
                raise RuntimeError("Strong Wolfe line search failed in Phase 2.")
            assert pa_v <= f_eps and pa_d < 0 and (pb_v >= f_eps or pb_d >= 0)
            if pb_v > 1e30:
                t = (a + b) / 2.0
            elif pa_v < -f_eps or pb_v > f_eps:
                A = np.array(
                    [
                        [1, a, a**2, a**3],
                        [0, 1, 2 * a, 3 * a**2],
                        [1, b, b**2, b**3],
                        [0, 1, 2 * b, 3 * b**2],
                    ]
                )
                rhs = np.array([pa_v, pa_d, pb_v, pb_d])
                X = np.linalg.solve(A, rhs)
                if abs(X[3]) > 1e-10:
                    if pb_d > self.sigma * abs(df0d):
                        X[1] += sdf0d  # minimize f, not psi
                    disc = (4 * X[2] ** 2 - 12 * X[1] * X[3]) / (36 * X[3] ** 2)
                    assert disc > 0
                    t1 = -X[2] / (3 * X[3]) - math.sqrt(disc)
                    t2 = -X[2] / (3 * X[3]) + math.sqrt(disc)
                    t = t1 if a <= t1 <= b else t2
                else:
                    A2 = np.array(
                        [[1, a, a**2], [0, 1, 2 * a], [1, b, b**2], [0, 1, 2 * b]]
                    )
                    X2, *_ = np.linalg.lstsq(A2, rhs, rcond=None)
                    if pb_d > self.sigma * abs(df0d):
                        X2[1] += sdf0d
                    t = -0.5 * X2[1] / X2[2]
            else:
                # Noisy values: interpolate the derivative linearly.
                t = a - pa_d * (b - a) / (pb_d - pa_d)

            assert a <= t <= b
            t = max(t, a + self.gamma1 * (b - a))
            t = min(t, b - self.gamma2 * (b - a))

            pv, pd = psi(t)
            if strong_wolfe(pv, pd):
                break
            if pv <= f_eps:
                if pd < 0:
                    a, pa_v, pa_d = t, pv, pd
                else:
                    b, pb_v, pb_d = t, pv, pd
            else:
                b, pb_v, pb_d = t, pv, pd

        self.lsi.set_last_alpha(t)
        return t


# -- optimizers ---------------------------------------------------------------

@dataclass
class SteepestDescent:
    ls: object = field(default_factory=ArmijoLS)
    maxiter: int = 4000
    tol: float = 1e-8
    iter: int = 0

    def init(self, obj, x0=None):
        if x0 is not None:
            obj.x = obj.as_control(x0)
        self.iter = 0
        self._g = None

    def compute_direction(self, obj):
        return -self._g

    def update_gradient(self, obj):
        self._g = obj.df


@dataclass
class NonlinCG:
    """Nonlinear CG with the Hager-Zhang beta (NonlinCG.jl:33-59)."""

    ls: object = field(default_factory=lambda: WolfeLS())
    maxiter: int = 4000
    tol: float = 1e-8
    iter: int = 0

    def init(self, obj, x0=None):
        if x0 is not None:
            obj.x = obj.as_control(x0)
        self.iter = 0
        self._g = self._old_g = self._old_df = self._d = None

    def compute_direction(self, obj):
        if self.iter == 0:
            self._d = -self._g
        else:
            y = obj.df - self._old_df
            yz = self._g - self._old_g
            yd = _dot(y, self._d)
            beta = (
                _dot(yz, obj.df) - 2 * _dot(self._d, obj.df) * _dot(yz, y) / yd
            ) / yd
            self._d = -self._g + beta * self._d
        self._old_g = self._g
        self._old_df = obj.df
        return self._d

    def update_gradient(self, obj):
        self._g = obj.df


def opt_optimize(opt, obj, x0=None):
    """Line-search optimizer loop (AbstractLineSearchOptimizer.jl:31-44)."""
    opt.init(obj, x0)
    obj.eval_fdf_()
    opt.update_gradient(obj)

    def converged():
        return math.sqrt(max(_dot(opt._g, obj.df), 0.0)) < opt.tol

    while opt.iter < opt.maxiter and not converged():
        d = opt.compute_direction(obj)
        opt.ls.apply(obj, d)
        obj.eval_df_()
        opt.update_gradient(obj)
        opt.iter += 1
    return obj.f
