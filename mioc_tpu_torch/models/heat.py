"""Heat-distribution problem: PDE-constrained vector integer control.

Counterpart of ``mioc_tpu.models.heat`` (the reference's ``example_heat.jl``,
Section 6.2 of arXiv:2411.06856):

    ∂_t y − αΔy = f₁(x)u₁(t) + f₂(x)u₂(t)   on Ω×[0,10],  Ω = [−1,1]²
    ∂y/∂n + κ y = κ·T_out                    on Γ
    y(0) = temp0

with two Gaussian heat sources, target temperature ``tempT``, tracking cost
``½(y−y_d)ᵀM(y−y_d)`` plus linear heating cost ``γ Σ u``, and the product
control set ``{0..5}²`` (L = 36, the DP stress case for L).

The FEM pipeline runs on the host at construction, with the JAX package's
numpy/scipy code (:mod:`mioc_tpu_torch.fem`): squareg mesh refined 3× (N =
545 P2 dofs with the native triangulator), P2 Lagrange, stiffness+Robin /
mass / load assembly, then the sweep operators, which move to the
objective's device and dtype once, with ``M`` and ``y_d`` for the cost:
the dense ``S⁻¹`` and ``M⁻¹F`` by default, or with ``solver="cg"``/``"mg"``
the sparse large-mesh engines (``sparse_format="ell"`` or ``"banded"``;
``"mg"`` takes the refinement chain ``mesh_hierarchy``), whose tracking cost
applies the engine's sparse ``M``: no N×N array is built there.  The cost's
products run in fixed-shape row chunks (:mod:`mioc_tpu_torch.objectives.
pde`), so every row of a batched evaluation has the single evaluation's
bits.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg as spla
import torch

from ..fem import (
    FE_Lagrange,
    area_integrator,
    bdry_integrator,
    mesh_library,
    ndofs,
    quadrature_unit_triangle_area,
    refine_all_cells,
)
from ..objectives.pde import COST_ROWS, PDEObjective
from ..ops.levels import product_levels
from ..ops.rows import chunked
from ..ops.tv import fold_sum

__all__ = ["HeatObj", "construct_mesh", "construct_mesh_hierarchy"]


def construct_mesh(hmax=1.0, refinements=3):
    mesh = mesh_library("squareg", hmax)
    for _ in range(refinements):
        mesh = refine_all_cells(mesh)
    return mesh


def construct_mesh_hierarchy(hmax=1.0, refinements=3):
    """Coarse→fine uniform-refinement chain (for the multigrid PDE solver)."""
    meshes = [mesh_library("squareg", hmax)]
    for _ in range(refinements):
        meshes.append(refine_all_cells(meshes[-1]))
    return meshes


class HeatObj(PDEObjective):
    """The heat problem on ``nt`` implicit-Euler steps of ``[0, 10]``.

    The JAX package's signature, plus ``device`` (``None`` means ``"cuda"``)
    and ``dtype`` (``None`` means float64).  ``solver="cg"``/``"mg"`` select
    the sparse large-mesh engines with ``cg_iters`` CG iterations per step
    and ``sparse_format`` ``"ell"`` or ``"banded"``; ``"mg"`` runs over
    ``mesh_hierarchy`` (coarse → fine; default
    :func:`construct_mesh_hierarchy`)."""

    def __init__(
        self,
        nt: int = 500,
        *,
        mesh=None,
        fe=None,
        quad_order_a: int = 3,
        quad_order_b: int = 1,
        alpha=1.0,
        c1=(10.0, 10.0),
        c2=(20.0, 20.0),
        kappa=0.12,
        Tout=0.0,
        temp0=10.0,
        tempT=20.0,
        gamma=10.0,
        x1=(-1.0, 0.0),
        x2=(1.0, 0.0),
        solver: str = "dense",
        cg_iters: int = 40,
        mesh_hierarchy=None,
        sparse_format: str = "ell",
        matmul_precision: str = "highest",
        device=None,
        dtype=None,
    ):
        self._init_problem(nt, gamma=gamma, kappa=kappa, Tout=Tout, temp0=temp0,
                           tempT=tempT, device=device, dtype=dtype)
        if solver == "mg" and mesh_hierarchy is None:
            if mesh is not None:
                raise ValueError(
                    "solver='mg' needs the refinement chain: pass "
                    "mesh_hierarchy=[coarse, …, fine] instead of mesh"
                )
            mesh_hierarchy = construct_mesh_hierarchy()
        if mesh_hierarchy is not None:
            mesh = mesh_hierarchy[-1]
        self._mesh_hierarchy = mesh_hierarchy
        self.mesh = mesh if mesh is not None else construct_mesh()
        self.fe = fe if fe is not None else FE_Lagrange(2)

        quad = quadrature_unit_triangle_area(quad_order_a)
        N = ndofs(self.fe, self.mesh)

        # Coefficients (example_heat.jl:70-79).
        h_A = lambda x: alpha * np.eye(2)
        h_alpha = self.kappa
        h_g = self.kappa * self.Tout
        x1 = np.asarray(x1)[:, None]
        x2 = np.asarray(x2)[:, None]
        rhs_fns = [
            lambda x: c2[0] * np.exp(-c1[0] * ((x - x1) ** 2).sum(axis=0)),
            lambda x: c2[1] * np.exp(-c1[1] * ((x - x2) ** 2).sum(axis=0)),
        ]

        # Assembly (assemble_stiffness/mass/rhs/state0, example_heat.jl:228-283).
        A0, _ = area_integrator(self.mesh, self.fe, quad, h_A, None, None, None)
        Q, Gb = bdry_integrator(self.mesh, self.fe, quad_order_b, h_alpha, None)
        A = A0 + Q
        M, _ = area_integrator(self.mesh, self.fe, quad, None, None, 1.0, None)
        _, Gg = bdry_integrator(self.mesh, self.fe, quad_order_b, None, h_g)
        F = np.empty((N, self.nx))
        for i in range(self.nx):
            _, Fi = area_integrator(self.mesh, self.fe, quad, None, None, None, rhs_fns[i])
            F[:, i] = Fi + Gg
        _, Y0 = area_integrator(
            self.mesh, self.fe, quad, None, None, None, lambda x: np.full(x.shape[1], temp0)
        )
        state0 = spla.spsolve(M.tocsc(), Y0)

        # Target temperature distribution (assemble_yd, example_heat.jl:130-132)
        # and, in dense mode, the dense mass matrix of the tracking cost (the
        # sparse modes apply the engine's M: yd is uniform, so the banded
        # engine's permuted cost is the same).
        self._set_cost(M.toarray() if solver == "dense" else None, np.full((N,), self.tempT))
        self.setup_operators(
            M, A, F, state0, mode=solver, cg_iters=cg_iters,
            mg_meshes=self._mesh_hierarchy, mg_fe=self.fe, fmt=sparse_format,
            matmul_precision=matmul_precision,
        )

    def _init_problem(self, nt, *, gamma, kappa, Tout, temp0, tempT, device, dtype):
        V = [[0, 1, 2, 3, 4, 5], [0, 1, 2, 3, 4, 5]]
        adm = product_levels(V)  # no restriction (example_heat.jl:44)
        PDEObjective.__init__(self, T0=0.0, T1=10.0, nt=nt, V=V, admissible=adm,
                              device=device, dtype=dtype)
        self.gamma = float(gamma)
        self.kappa, self.Tout = float(kappa), float(Tout)
        self.temp0, self.tempT = float(temp0), float(tempT)

    def _set_cost(self, M_dense, yd):
        def dev(a):
            return torch.as_tensor(np.array(a, dtype=np.float64),
                                   device=self.device).to(self.dtype)

        self._Mj = self._MjT = None
        if M_dense is not None:
            self._Mj = dev(M_dense)
            self._MjT = self._Mj.T.contiguous()
        self.yd = dev(yd)

    @classmethod
    def from_operators(cls, nt, *, Sinv, M_invF, M, yd, state0, tau=None,
                       gamma=10.0, kappa=0.12, Tout=0.0, temp0=10.0, tempT=20.0,
                       device=None, dtype=None):
        """A heat objective on given operators (numpy arrays: ``Sinv (N,
        N)``, ``M_invF (N, 2)``, the dense mass matrix ``M (N, N)``, ``yd``,
        ``state0``), with no mesh and no assembly of its own; ``tau``, when
        given, replaces ``10/nt``.  The interop path for holding the port
        against another package's assembly."""
        obj = cls.__new__(cls)
        obj._init_problem(nt, gamma=gamma, kappa=kappa, Tout=Tout, temp0=temp0,
                          tempT=tempT, device=device, dtype=dtype)
        if tau is not None:
            obj.tau = float(tau)
        obj.mesh = obj.fe = obj._mesh_hierarchy = None
        obj.solver_mode = "dense"
        obj.matmul_precision = "highest"
        obj._set_cost(M, yd)
        obj.install_operators(Sinv, M_invF, state0)
        return obj

    @classmethod
    def from_sparse_operators(cls, nt, *, A, M, F, state0, tau=None, solver="mg",
                              cg_iters=40, sparse_format="ell", dof_perm=None,
                              prolongations=None, gamma=10.0, kappa=0.12, Tout=0.0,
                              temp0=10.0, tempT=20.0, device=None, dtype=None):
        """A heat objective on the cg/mg engines from given host operators
        (scipy or numpy: stiffness + Robin ``A``, mass ``M``, load ``F (N,
        2)``, ``state0``; for ``"mg"`` the level ``prolongations``, finest
        first; for ``"banded"`` optionally ``dof_perm``), with no mesh and
        no assembly of its own; ``tau``, when given, replaces ``10/nt``."""
        obj = cls.__new__(cls)
        obj._init_problem(nt, gamma=gamma, kappa=kappa, Tout=Tout, temp0=temp0,
                          tempT=tempT, device=device, dtype=dtype)
        if tau is not None:
            obj.tau = float(tau)
        obj.mesh = obj.fe = obj._mesh_hierarchy = None
        obj._set_cost(None, np.full((F.shape[0],), obj.tempT))
        obj.setup_operators(M, A, np.asarray(F), np.asarray(state0), mode=solver,
                            cg_iters=cg_iters, fmt=sparse_format, dof_perm=dof_perm,
                            mg_prolongations=prolongations)
        return obj

    @property
    def _batched_sweeps_bitexact(self):
        # Every row of a batch has the single evaluation's bits in dense mode
        # and on the banded engine (fixed-width products, row sums of one
        # shape, fold sums), so the speculative wave is exact there.  The
        # ELL engine keeps the wave off, as the JAX package does
        # (mioc_tpu/models/heat.py:163-187).
        return self.solver_mode == "dense" or self.sparse_format == "banded"

    def _mass_apply(self, v):
        """``M v`` for one vector (the dense ``M`` or the engine's)."""
        if self._engine is None:
            return self._Mj @ v
        return self._engine.mass_rows(v[None])[0]

    # Costs (example_heat.jl:135-161).  The sweeps call the row forms; the
    # scalar hooks are the JAX package's, for users and tests.
    def G(self, y, u, i):
        v = y - self.yd
        return 0.5 * v @ self._mass_apply(v)

    def G_t(self, u, i):
        return self.gamma * u.sum()

    def Gy(self, y, u, i):
        return self._mass_apply(y - self.yd)

    def Gu(self, u, i):
        return self.gamma * torch.ones(self.nx, dtype=self.dtype, device=self.device)

    def _mass_rows(self, v):
        """``M v`` for every row of ``v (n, N)``: chunks of COST_ROWS rows
        of the dense product, or the engine's sparse M."""
        if self._engine is not None:
            return self._engine.mass_rows(v)
        return chunked(lambda rows: rows @ self._MjT, v, COST_ROWS)

    def _G_rows(self, ys, uu, t_idx):
        v = ys - self.yd
        return 0.5 * fold_sum(v * self._mass_rows(v)) + self.gamma * fold_sum(uu)

    def _Gy_rows(self, ys, uu, t_idx):
        return self._mass_rows(ys - self.yd)

    def _Gu_rows(self, uu, t_idx):
        return torch.full_like(uu, self.gamma)
