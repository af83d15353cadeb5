"""Standalone elliptic FEM solve pipeline and timing harness.

Counterpart of ``mioc_tpu.fem.solve`` (the reference's ``julia_fem/test_FEM.jl``
``FEM(...)`` entry point, :21-95, and ``benchmark.jl``), the same numpy code:
assemble

    A_ij = ∫ ∇φᵢᵀ A ∇φⱼ + φᵢ β·∇φⱼ + φᵢ c₀ φⱼ dx  (+ Robin ∫ φᵢ α φⱼ ds)
    F_i  = ∫ f φᵢ dx (+ ∫ g φᵢ ds)

and solve either the Robin problem ``A u = F`` or the Dirichlet
saddle-point system ``[A Dᵀ; D 0][u; μ] = [F; 0]``.  ``visualize=True``
writes the solution as legacy VTK and a PNG surface plot
(``utils.vtk``, ``utils.plotting``), and :func:`plot_shape_functions`
exports every global shape function as a VTK series.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .assembly import area_integrator, bdry_integrator
from .fe import FE_Lagrange, dirichlet_constraints, name, ndofs
from .mesh import init_mesh, mesh_library, prolongation, refine_all_cells
from .quadrature import quadrature_unit_triangle_area

__all__ = ["FEM", "simple_test_FEM", "fem_benchmark", "plot_shape_functions"]

_FE_TYPES = {
    "Lagrange_1": 1,
    "Lagrange_2": 2,
    "Lagrange_3": 3,
}


def FEM(h_A, h_beta, h_c, h_f, h_alpha, h_g, *, fe_type="Lagrange_2", hmax=0.01,
        geometry="squareg", vertices=None, dirichlet=False, QuadOrderA=2,
        QuadOrderB=1, visualize=False, out_prefix="Solution"):
    """Elliptic solve (test_FEM.jl:21-95).  Returns ``(mesh, U)``;
    ``visualize=True`` also writes ``<out_prefix>-<fe_type>.vtk`` and
    ``.png`` (P2/P3 solutions prolonged onto refined P1 meshes first)."""
    if fe_type not in _FE_TYPES:
        raise ValueError(f"Finite element {fe_type!r} unknown.")
    fe = FE_Lagrange(_FE_TYPES[fe_type])

    mesh = init_mesh(np.asarray(vertices, float), hmax) if vertices is not None \
        else mesh_library(geometry, hmax)

    quad = quadrature_unit_triangle_area(QuadOrderA)
    A, F = area_integrator(mesh, fe, quad, h_A, h_beta, h_c, h_f)
    Q, G = bdry_integrator(mesh, fe, QuadOrderB, h_alpha, h_g)
    A = (A + Q).tocsc()
    F = F + G

    if dirichlet:
        D = dirichlet_constraints(fe, mesh)
        Z = sp.csr_matrix((D.shape[0], D.shape[0]))
        K = sp.bmat([[A, D.T], [D, Z]], format="csc")
        rhs = np.concatenate([F, np.zeros(D.shape[0])])
        U = spla.spsolve(K, rhs)[: ndofs(fe, mesh)]
    else:
        U = spla.spsolve(A, F)

    if visualize:
        from ..utils.plotting import plot_solution
        from ..utils.vtk import write_vtk

        k = fe.k
        if k == 1:
            write_vtk(f"{out_prefix}-{fe_type}", mesh, U)
            plot_solution(mesh, U, name(fe), f"{out_prefix}-{fe_type}.png")
        else:
            # Refine + prolong onto P1 for visualization (test_FEM.jl:79-92).
            rmesh = refine_all_cells(mesh)
            P = prolongation(mesh, rmesh, fe, FE_Lagrange(1))
            U1 = P @ U
            if k == 3:
                rmesh2 = refine_all_cells(rmesh)
                P2 = prolongation(rmesh, rmesh2, FE_Lagrange(1))
                U1, rmesh = P2 @ U1, rmesh2
            write_vtk(f"{out_prefix}-{fe_type}", rmesh, U1[: rmesh.np])
            plot_solution(rmesh, U1[: rmesh.np], name(fe), f"{out_prefix}-{fe_type}.png")
    return mesh, U


def simple_test_FEM(*, hmax=0.01, dirichlet=False, geometry="squareg", **kw):
    """-Δu + boundary terms with unit data (test_FEM.jl:6-19)."""
    return FEM(
        np.eye(2), None, None, 1.0, 1.0, 1.0,
        fe_type="Lagrange_3", hmax=hmax, geometry=geometry,
        dirichlet=dirichlet, QuadOrderA=3, QuadOrderB=3, **kw,
    )


def fem_benchmark(refs=6, verbose=True):
    """Mesh-refine → assembly → solve timing harness (benchmark.jl:9-61).
    Returns a dict of phase timings."""
    out = {}
    t0 = time.perf_counter()
    mesh = init_mesh(np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], float), 1.0)
    for _ in range(refs):
        mesh = refine_all_cells(mesh)
    out["mesh_s"] = time.perf_counter() - t0
    out["ntri"] = mesh.ntri

    fe = FE_Lagrange(1)
    quad = quadrature_unit_triangle_area(2)
    t0 = time.perf_counter()
    A, f = area_integrator(mesh, fe, quad, 1.0, None, 1.0, 1.0)
    out["assembly_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    u = spla.spsolve(A.tocsc(), f)
    out["solve_s"] = time.perf_counter() - t0

    A = A.tolil()
    A[0, 0] = -1.0  # indefinite
    t0 = time.perf_counter()
    u = spla.spsolve(A.tocsc(), f)
    out["solve_indef_s"] = time.perf_counter() - t0

    A[0, 1] = 1.0  # unsymmetric
    t0 = time.perf_counter()
    u = spla.spsolve(A.tocsc(), f)
    out["solve_unsym_s"] = time.perf_counter() - t0

    if verbose:
        print({k: (round(v, 4) if isinstance(v, float) else v) for k, v in out.items()})
    return out


def plot_shape_functions(fe, refs=3, mesh=None, out_prefix=None):
    """Export every global shape function on a refined mesh as a VTK series
    (FE.jl:440-460)."""
    from .mesh import triangle_mesh
    from ..utils.vtk import PVDCollection, pvd_append

    mesh = mesh if mesh is not None else triangle_mesh()
    rmesh = mesh
    for _ in range(refs):
        rmesh = refine_all_cells(rmesh)
    P = prolongation(mesh, rmesh, fe, FE_Lagrange(1))
    prefix = out_prefix or name(fe).replace(" ", "_")
    with PVDCollection(prefix) as pvd:
        for i in range(ndofs(fe, mesh)):
            U = np.asarray(P[:, i].todense()).ravel()
            pvd_append(pvd, i, rmesh, U)
    return prefix + ".pvd"
