"""The FEM toolkit: meshes, Lagrange elements, quadrature, assembly and the
elliptic solve pipeline.

Counterpart of ``mioc_tpu.fem`` (the reference's ``julia_fem``), with the
same names.  It is numpy/scipy host code that runs at model construction;
the device sees only the assembled operators.  The large-mesh engines of
the PDE sweeps are the submodules ``sparse_device`` (ELL, CG),
``banded_device`` (RCM-permuted block-banded operators) and ``multigrid``
(the V-cycle), as in the JAX package.
"""

from .assembly import affine_transformation, area_integrator, bdry_integrator
from .fe import (
    FE,
    FE_Lagrange,
    cell_dofs,
    dirichlet_constraints,
    dof,
    dofmap,
    flat_dofmap,
    local_dofs,
    name,
    ndofs,
    nlocaldofs,
    shape,
)
from .mesh import (
    Mesh,
    init_mesh,
    klein_bottle_mesh,
    mesh_library,
    moebius_mesh,
    prolongation,
    refine_adaptively,
    refine_all_cells,
    sanity_check,
    torus_mesh,
    triangle_mesh,
)
from .quadrature import quadrature_unit_triangle_area, quadrature_unit_triangle_bdry
from .solve import FEM, fem_benchmark, plot_shape_functions, simple_test_FEM

__all__ = [
    "Mesh", "mesh_library", "init_mesh", "refine_all_cells", "refine_adaptively",
    "prolongation", "triangle_mesh", "torus_mesh", "moebius_mesh",
    "klein_bottle_mesh", "sanity_check",
    "FE", "FE_Lagrange", "ndofs", "nlocaldofs", "cell_dofs", "flat_dofmap",
    "dofmap", "shape", "dirichlet_constraints", "local_dofs", "dof", "name",
    "area_integrator", "bdry_integrator", "affine_transformation",
    "quadrature_unit_triangle_area", "quadrature_unit_triangle_bdry",
    "FEM", "simple_test_FEM", "fem_benchmark", "plot_shape_functions",
]
