"""Weak-form assembly into sparse matrices, vectorized over cells.

Counterpart of ``mioc_tpu.fem.assembly`` (the reference's
``julia_fem/assembly.jl``): the same numpy code, kept in the port so that it
imports nothing of the JAX package.  The reference loops over cells and
quadrature points with per-cell StaticArray accumulation; here local
matrices for ALL cells are produced with einsum batches (host numpy —
model-construction time only, never in the solve hot path) and scattered
into scipy COO/CSR.

Assembled terms (integrals over Ω / Γ, assembly.jl:3-11, 177-183)::

    A_ij = ∫ ∇φ_iᵀ A(x) ∇φ_j dx        B_ij = ∫ φ_i β(x)·∇φ_j dx
    C_ij = ∫ φ_i c0(x) φ_j dx           F_i  = ∫ f(x) φ_i dx
    Q_ij = ∫_Γ φ_i α(s) φ_j ds          G_i  = ∫_Γ g(s) φ_i ds

Coefficients may be ``None`` (term skipped), a scalar, a constant matrix /
vector, or a callable evaluated at world quadrature points (dispatch as in
``assembly.jl:55-96``).  Callables receive ``x`` of shape ``(2, npoints)``
and return a scalar, an ``(npoints,)`` array, or a constant matrix/vector —
matching the reference's coefficient-function convention
(e.g. ``example_heat.jl:70-79``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .fe import cell_dofs, ndofs, nlocaldofs, shape
from .mesh import Mesh, cell_areas
from .quadrature import quadrature_unit_triangle_bdry

__all__ = ["area_integrator", "bdry_integrator", "affine_transformation"]


def affine_transformation(mesh: Mesh, lam, ncell):
    """Map barycentric points into world coordinates of cell(s) ``ncell``
    (assembly.jl:342-344).  Returns ``(gd, nq)`` for a scalar cell index."""
    lam = np.asarray(lam, float)
    if lam.shape[0] != 3:
        lam = lam.T
    local = lam[1:]  # (2, nq)
    B = mesh.affine_matrix[ncell]
    b = mesh.affine_vector[ncell]
    if np.ndim(ncell) == 0:
        return B @ local + b[:, None]
    return np.einsum("nij,jq->niq", B, local) + b[:, :, None]


def _eval_coeff(h, X):
    """Evaluate a coefficient at world points ``X (ncells, gd, nq)``.
    Returns (kind, value) where kind ∈ {none, scalar, matrix, vector, field}."""
    if h is None:
        return "none", None
    if np.isscalar(h):
        return "scalar", float(h)
    if callable(h):
        ncells, gd, nq = X.shape
        sample = np.asarray(h(X[0]))
        if sample.ndim == 2 and sample.shape == (gd, gd):
            # Constant-matrix-valued function (e.g. x -> alpha*I).
            vals = np.stack([np.asarray(h(X[c])) for c in range(ncells)])
            return "cellmatrix", vals  # (ncells, gd, gd)
        vals = np.empty((ncells, nq))
        for c in range(ncells):
            vals[c] = np.asarray(h(X[c])).reshape(-1)[:nq]
        return "field", vals  # (ncells, nq)
    arr = np.asarray(h, float)
    if arr.ndim == 2:
        return "matrix", arr
    if arr.ndim == 1:
        return "vector", arr
    return "scalar", float(arr)


def area_integrator(mesh: Mesh, fe, quadrature, h_A, h_beta, h_c0, h_f):
    """Assemble the area contributions; returns ``(A, F)`` with ``A`` sparse
    CSR ``(N, N)`` and ``F`` dense ``(N,)`` (assembly.jl:12-174)."""
    lam, w = quadrature
    nq = len(w)
    nld = nlocaldofs(fe)
    N = ndofs(fe, mesh)
    ncells = mesh.ntri

    shapef, dshape = shape(fe, lam, return_d=True)  # (nq, nld), (nq, 2, nld)
    # Transformed gradients per cell: G[c, q] = B_K^{-T} · dshape[q]  (gd, nld)
    G = np.einsum("cgd,qdl->cqgl", mesh.affine_invmatrixT, dshape)

    need_X = callable(h_A) or callable(h_beta) or callable(h_c0) or callable(h_f)
    X = (
        affine_transformation(mesh, lam, np.arange(ncells))
        if need_X
        else np.zeros((ncells, mesh.gd, nq))
    )

    AK = np.zeros((ncells, nld, nld))
    FK = np.zeros((ncells, nld))

    kind, val = _eval_coeff(h_A, X)
    if kind == "scalar":
        AK += val * np.einsum("q,cqgi,cqgj->cij", w, G, G)
    elif kind == "matrix":
        AK += np.einsum("q,cqgi,gh,cqhj->cij", w, G, val, G)
    elif kind == "cellmatrix":
        AK += np.einsum("q,cqgi,cgh,cqhj->cij", w, G, val, G)
    elif kind == "field":
        AK += np.einsum("q,cq,cqgi,cqgj->cij", w, val, G, G)
    elif kind != "none":
        raise ValueError("Unsupported coefficient for A")

    kind, val = _eval_coeff(h_beta, X)
    if kind == "vector":
        AK += np.einsum("q,qi,g,cqgj->cij", w, shapef, val, G)
    elif kind == "field":
        raise ValueError("β must be vector-valued")
    elif kind == "scalar":
        raise ValueError("The coefficient beta cannot be a real number.")
    elif kind != "none":
        raise ValueError("Unsupported coefficient for beta")

    kind, val = _eval_coeff(h_c0, X)
    if kind == "scalar":
        AK += val * np.einsum("q,qi,qj->ij", w, shapef, shapef)[None]
    elif kind == "field":
        AK += np.einsum("q,cq,qi,qj->cij", w, val, shapef, shapef)
    elif kind != "none":
        raise ValueError("Unsupported coefficient for c0")

    kind, val = _eval_coeff(h_f, X)
    if kind == "scalar":
        FK += val * np.einsum("q,qi->i", w, shapef)[None]
    elif kind == "field":
        FK += np.einsum("q,cq,qi->ci", w, val, shapef)
    elif kind != "none":
        raise ValueError("Unsupported coefficient for f")

    scale = 2.0 * cell_areas(mesh)  # |det B_K| (or its surface analogue)
    AK *= scale[:, None, None]
    FK *= scale[:, None]

    dofs = cell_dofs(fe, mesh)  # (ncells, nld)
    rows = np.repeat(dofs, nld, axis=1).ravel()
    cols = np.tile(dofs, (1, nld)).ravel()
    A = sp.csr_matrix((AK.ravel(), (rows, cols)), shape=(N, N))
    F = np.zeros(N)
    np.add.at(F, dofs.ravel(), FK.ravel())
    return A, F


def bdry_integrator(mesh: Mesh, fe, h_bdry_quadrature, h_alpha, h_g):
    """Assemble the Robin boundary contributions; returns ``(Q, G)``
    (assembly.jl:184-333).  ``h_bdry_quadrature`` maps an edge number (1-3)
    to an ``(lam, w)`` rule, like the reference's closure convention — or pass
    an int exactness order directly."""
    if isinstance(h_bdry_quadrature, int):
        order = h_bdry_quadrature
        h_bdry_quadrature = lambda edge: quadrature_unit_triangle_bdry(edge, order)

    nld = nlocaldofs(fe)
    N = ndofs(fe, mesh)
    nbe = len(mesh.be)
    QG_rows, QG_cols, QG_vals = [], [], []
    Gvec = np.zeros(N)

    bedges = mesh.be[:, 0]
    # Incident cell (boundary edges have exactly one, assembly.jl:258).
    cells = np.where(mesh.e[bedges, 2] >= 0, mesh.e[bedges, 2], mesh.e[bedges, 3])
    # Local edge number within the cell (1-based like the reference).
    nedge = np.argmax(mesh.cell_to_edge[cells] == bedges[:, None], axis=1) + 1
    v1 = mesh.p[mesh.e[bedges, 0]]
    v2 = mesh.p[mesh.e[bedges, 1]]
    lens = np.linalg.norm(v2 - v1, axis=1)
    dofs = cell_dofs(fe, mesh)

    for le in (1, 2, 3):
        sel = np.nonzero(nedge == le)[0]
        if len(sel) == 0:
            continue
        lam, w = h_bdry_quadrature(le)
        nq = len(w)
        shapef = shape(fe, lam)  # (nq, nld)
        csel = cells[sel]

        need_X = callable(h_alpha) or callable(h_g)
        X = (
            affine_transformation(mesh, lam, csel)
            if need_X
            else np.zeros((len(sel), mesh.gd, nq))
        )

        QK = np.zeros((len(sel), nld, nld))
        GK = np.zeros((len(sel), nld))

        kind, val = _eval_coeff(h_alpha, X)
        if kind == "scalar":
            QK += val * np.einsum("q,qi,qj->ij", w, shapef, shapef)[None]
        elif kind == "field":
            QK += np.einsum("q,cq,qi,qj->cij", w, val, shapef, shapef)
        elif kind != "none":
            raise ValueError("Unsupported coefficient for alpha")

        kind, val = _eval_coeff(h_g, X)
        if kind == "scalar":
            GK += val * np.einsum("q,qi->i", w, shapef)[None]
        elif kind == "field":
            GK += np.einsum("q,cq,qi->ci", w, val, shapef)
        elif kind != "none":
            raise ValueError("Unsupported coefficient for g")

        QK *= lens[sel][:, None, None]
        GK *= lens[sel][:, None]

        d = dofs[csel]
        QG_rows.append(np.repeat(d, nld, axis=1).ravel())
        QG_cols.append(np.tile(d, (1, nld)).ravel())
        QG_vals.append(QK.ravel())
        np.add.at(Gvec, d.ravel(), GK.ravel())

    if QG_rows:
        Q = sp.csr_matrix(
            (
                np.concatenate(QG_vals),
                (np.concatenate(QG_rows), np.concatenate(QG_cols)),
            ),
            shape=(N, N),
        )
    else:
        Q = sp.csr_matrix((N, N))
    return Q, Gvec
