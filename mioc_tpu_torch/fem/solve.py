"""Standalone elliptic FEM solve pipeline and timing harness.

Counterpart of ``mioc_tpu.fem.solve`` (the reference's ``julia_fem/test_FEM.jl``
``FEM(...)`` entry point, :21-95, and ``benchmark.jl``), the same numpy code:
assemble

    A_ij = ∫ ∇φᵢᵀ A ∇φⱼ + φᵢ β·∇φⱼ + φᵢ c₀ φⱼ dx  (+ Robin ∫ φᵢ α φⱼ ds)
    F_i  = ∫ f φᵢ dx (+ ∫ g φᵢ ds)

and solve either the Robin problem ``A u = F`` or the Dirichlet
saddle-point system ``[A Dᵀ; D 0][u; μ] = [F; 0]``.  Visualization (the JAX
package's VTK and PNG output of ``visualize=True`` and
:func:`plot_shape_functions`) is not ported yet and raises
``NotImplementedError`` naming ROADMAP.md queue A item 7.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .assembly import area_integrator, bdry_integrator
from .fe import FE_Lagrange, dirichlet_constraints, ndofs
from .mesh import init_mesh, mesh_library, refine_all_cells
from .quadrature import quadrature_unit_triangle_area

__all__ = ["FEM", "simple_test_FEM", "fem_benchmark", "plot_shape_functions"]

_PLOT = "ROADMAP.md queue A item 7 (utils/plotting.py, utils/vtk.py)"

_FE_TYPES = {
    "Lagrange_1": 1,
    "Lagrange_2": 2,
    "Lagrange_3": 3,
}


def FEM(h_A, h_beta, h_c, h_f, h_alpha, h_g, *, fe_type="Lagrange_2", hmax=0.01,
        geometry="squareg", vertices=None, dirichlet=False, QuadOrderA=2,
        QuadOrderB=1, visualize=False, out_prefix="Solution"):
    """Elliptic solve (test_FEM.jl:21-95).  Returns ``(mesh, U)``.
    ``visualize=True`` raises ``NotImplementedError`` (not ported yet)."""
    if fe_type not in _FE_TYPES:
        raise ValueError(f"Finite element {fe_type!r} unknown.")
    if visualize:
        raise NotImplementedError(f"FEM visualization is not ported yet: {_PLOT}")
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
    """Export every global shape function as a VTK series (FE.jl:440-460):
    not ported yet, raises ``NotImplementedError``."""
    raise NotImplementedError(f"plot_shape_functions is not ported yet: {_PLOT}")
