"""Continuous Lagrange finite elements P1-P3 on triangles.

Counterpart of ``mioc_tpu.fem.fe`` (the reference's ``julia_fem/FE.jl``): the
same numpy code, kept in the port so that it imports nothing of the JAX
package.  Shape functions are represented as exact polynomials in the
barycentric coordinates ``(λ1, λ2, λ3)`` and differentiated symbolically, so
values, Cartesian gradients and Hessians come from one code path for every
degree (the reference hand-writes each formula).  Cartesian derivatives use the reference
triangle ``λ = (1−x−y, x, y)``:  ``∂x = ∂λ2 − ∂λ1``, ``∂y = ∂λ3 − ∂λ1``
(``FE.jl:82-84``); Hessians via ``Kᵀ H_λ K`` with ``K = [[-1,-1],[1,0],[0,1]]``
(``FE.jl:196``).

Local dof ordering matches the reference exactly (vertices, then edges —
edge ``i`` opposite vertex ``i`` — then interior), including the P3
edge-orientation flip (``FE.jl:258-280``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["FE", "FE_Lagrange", "ndofs", "nlocaldofs", "cell_dofs",
           "flat_dofmap", "shape", "dirichlet_constraints", "local_dofs",
           "dof", "name", "dofmap"]


# -- barycentric polynomials --------------------------------------------------
class _Poly(dict):
    """Polynomial in (λ1, λ2, λ3): {(i, j, k): coeff}."""

    def diff(self, m):
        out = _Poly()
        for exps, c in self.items():
            if exps[m] > 0:
                e = list(exps)
                e[m] -= 1
                out[tuple(e)] = out.get(tuple(e), 0.0) + c * exps[m]
        return out

    def __call__(self, lam):
        lam = np.asarray(lam, dtype=np.float64)  # (nq, 3)
        out = np.zeros(lam.shape[0])
        for (i, j, k), c in self.items():
            out += c * lam[:, 0] ** i * lam[:, 1] ** j * lam[:, 2] ** k
        return out


def _mono(i, j, k, c=1.0):
    return _Poly({(i, j, k): c})


def _mul(a, b):
    out = _Poly()
    for ea, ca in a.items():
        for eb, cb in b.items():
            e = (ea[0] + eb[0], ea[1] + eb[1], ea[2] + eb[2])
            out[e] = out.get(e, 0.0) + ca * cb
    return out


def _lin(m, scale=1.0, shift=0.0):
    """scale·λ_m + shift"""
    p = _Poly({(0, 0, 0): shift})
    e = [0, 0, 0]
    e[m] = 1
    p[tuple(e)] = p.get(tuple(e), 0.0) + scale
    return p


def _basis(k):
    l1, l2, l3 = _mono(1, 0, 0), _mono(0, 1, 0), _mono(0, 0, 1)
    if k == 1:
        return [l1, l2, l3]
    if k == 2:
        return [
            _mul(l1, _lin(0, 2, -1)),
            _mul(l2, _lin(1, 2, -1)),
            _mul(l3, _lin(2, 2, -1)),
            _mul(_mono(0, 1, 1), _Poly({(0, 0, 0): 4.0})),
            _mul(_mono(1, 0, 1), _Poly({(0, 0, 0): 4.0})),
            _mul(_mono(1, 1, 0), _Poly({(0, 0, 0): 4.0})),
        ]
    if k == 3:
        a = [_lin(m, 3, -1) for m in range(3)]  # 3λ_m − 1
        b = [_lin(m, 3, -2) for m in range(3)]  # 3λ_m − 2
        half = _Poly({(0, 0, 0): 0.5})
        c92 = _Poly({(0, 0, 0): 4.5})
        return [
            _mul(half, _mul(l1, _mul(a[0], b[0]))),
            _mul(half, _mul(l2, _mul(a[1], b[1]))),
            _mul(half, _mul(l3, _mul(a[2], b[2]))),
            _mul(c92, _mul(l2, _mul(a[1], l3))),  # edge 1 (opp v1)
            _mul(c92, _mul(l3, _mul(a[2], l2))),
            _mul(c92, _mul(l3, _mul(a[2], l1))),  # edge 2
            _mul(c92, _mul(l1, _mul(a[0], l3))),
            _mul(c92, _mul(l1, _mul(a[0], l2))),  # edge 3
            _mul(c92, _mul(l2, _mul(a[1], l1))),
            _mul(_mono(1, 1, 1), _Poly({(0, 0, 0): 27.0})),
        ]
    raise ValueError(f"FE_Lagrange degree {k} not implemented (use 1, 2 or 3).")


# Local-dof barycentric node positions (FE.jl:106-114, 220-233, 404-421).
_NODES = {
    1: np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1]], float),
    2: np.array(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1],
         [0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]], float
    ),
    3: np.array(
        [[1, 0, 0], [0, 1, 0], [0, 0, 1],
         [0, 2 / 3, 1 / 3], [0, 1 / 3, 2 / 3],
         [1 / 3, 0, 2 / 3], [2 / 3, 0, 1 / 3],
         [2 / 3, 1 / 3, 0], [1 / 3, 2 / 3, 0],
         [1 / 3, 1 / 3, 1 / 3]], float
    ),
}


class FE:
    """Element protocol.  Beyond Lagrange, a custom element participates in
    assembly/prolongation by implementing METHODS of the same names as the
    module-level functions (``shape``, ``local_dofs``, ``flat_dofmap``,
    ``ndofs``, ``nlocaldofs``, ``cell_dofs``, ``dirichlet_constraints``) —
    the functions dispatch to them when present (mirrors the reference's
    multiple dispatch on the FE type, ``FE.jl``).

    ``needs_derivatives``: the element's local dof functionals consume first
    derivatives (e.g. Hermite-type dofs).  ``prolongation`` then hands
    ``local_dofs`` a callable returning ``(val, dx, dy)`` — values plus the
    E-transformed derivative planes of :func:`mioc_tpu_torch.fem.mesh
    .transform_derivative` (``mesh.jl:541-552``) — instead of plain values.
    """

    needs_derivatives = False


class FE_Lagrange(FE):
    def __init__(self, k: int):
        self.k = int(k)
        self.basis = _basis(self.k)
        self.nodes = _NODES[self.k]

    def __repr__(self):
        return f"FE_Lagrange({self.k})"


def name(fe: FE_Lagrange) -> str:
    return {1: "Linear Lagrange", 2: "Quadratic Lagrange", 3: "Cubic Lagrange"}[fe.k]


def ndofs(fe: FE, mesh) -> int:
    """np + ne·(k−1) + nt·(k−1)(k−2)/2 global dofs (FE.jl:24-28)."""
    if not isinstance(fe, FE_Lagrange):
        return fe.ndofs(mesh)
    k = fe.k
    return mesh.np + mesh.ne * (k - 1) + mesh.ntri * ((k - 1) * (k - 2)) // 2


def nlocaldofs(fe: FE) -> int:
    if not isinstance(fe, FE_Lagrange):
        return fe.nlocaldofs()
    return (fe.k + 1) * (fe.k + 2) // 2


def shape(fe: FE_Lagrange, lam, return_d=False, return_H=False):
    """Evaluate all local shape functions at barycentric points ``lam (nq, 3)``.

    Returns ``val (nq, nld)`` and optionally the Cartesian gradients
    ``dval (nq, 2, nld)`` and Hessians ``H (nld, nq, 2, 2)``.
    """
    if not isinstance(fe, FE_Lagrange):
        return fe.shape(lam, return_d=return_d, return_H=return_H)
    lam = np.atleast_2d(np.asarray(lam, float))
    if lam.shape[1] != 3:
        lam = lam.T
    nq = lam.shape[0]
    nld = len(fe.basis)
    val = np.empty((nq, nld))
    for i, p in enumerate(fe.basis):
        val[:, i] = p(lam)
    if not return_d:
        return val

    dval = np.empty((nq, 2, nld))
    dlam = [[p.diff(m) for m in range(3)] for p in fe.basis]
    for i in range(nld):
        d1, d2, d3 = (d(lam) for d in dlam[i])
        dval[:, 0, i] = d2 - d1
        dval[:, 1, i] = d3 - d1
    if not return_H:
        return val, dval

    K = np.array([[-1, -1], [1, 0], [0, 1]], float)
    H = np.empty((nld, nq, 2, 2))
    for i in range(nld):
        Hlam = np.empty((nq, 3, 3))
        for m in range(3):
            for n in range(3):
                Hlam[:, m, n] = dlam[i][m].diff(n)(lam)
        H[i] = np.einsum("mi,qmn,nj->qij", K, Hlam, K)
    return val, dval, H


def cell_dofs(fe: FE_Lagrange, mesh) -> np.ndarray:
    """Global dof indices per cell, ``(ntri, nld)`` int64 — the vectorized
    ``flat_dofmap`` (FE.jl:42-50, 136-143, 258-280).  All indices 0-based."""
    if not isinstance(fe, FE_Lagrange):
        return fe.cell_dofs(mesh)
    k = fe.k
    t = mesh.t  # (ntri, 3)
    if k == 1:
        return t.copy()
    c2e = mesh.cell_to_edge  # (ntri, 3)
    if k == 2:
        return np.concatenate([t, mesh.np + c2e], axis=1)
    # k == 3: two dofs per edge, orientation-dependent (FE.jl:258-280).
    ntri = mesh.ntri
    edofs = np.empty((ntri, 6), dtype=np.int64)
    for i in range(3):
        nxt = t[:, (i + 1) % 3]  # vertex after the opposite one
        first_v = mesh.e[c2e[:, i], 0]
        flip = (nxt != first_v).astype(np.int64)
        base = mesh.np + 2 * c2e[:, i]
        edofs[:, 2 * i] = base + flip
        edofs[:, 2 * i + 1] = base + 1 - flip
    cdof = (mesh.np + 2 * mesh.ne + np.arange(ntri))[:, None]
    return np.concatenate([t, edofs, cdof], axis=1)


def flat_dofmap(fe: FE_Lagrange, mesh, idx: int):
    """Per-cell dofmap in the reference's flat form (global_dofs, i, j, s)."""
    if not isinstance(fe, FE_Lagrange):
        return fe.flat_dofmap(mesh, idx)
    g = cell_dofs(fe, mesh)[idx]
    n = len(g)
    return g, np.arange(n), np.arange(n), np.ones(n)


def dofmap(fe: FE_Lagrange, mesh, idx: int):
    """Connectivity matrix C_K of cell ``idx`` (FE.jl:5-12)."""
    g, i, j, s = flat_dofmap(fe, mesh, idx)
    return sp.csr_matrix((s, (g[i], j)), shape=(ndofs(fe, mesh), nlocaldofs(fe)))


def dirichlet_constraints(fe: FE_Lagrange, mesh):
    """Selection matrix of boundary dofs (FE.jl:116-130, 235-252, 423-434)."""
    if not isinstance(fe, FE_Lagrange):
        return fe.dirichlet_constraints(mesh)
    be = mesh.be[:, 0]  # edge indices
    verts = np.unique(mesh.e[be, :2].ravel())
    cols = [verts]
    if fe.k == 2:
        cols.append(mesh.np + be)
    elif fe.k == 3:
        cols.append(mesh.np + 2 * be)
        cols.append(mesh.np + 2 * be + 1)
    j = np.concatenate(cols)
    i = np.arange(len(j))
    return sp.csr_matrix(
        (np.ones(len(j)), (i, j)), shape=(len(j), ndofs(fe, mesh))
    )


def local_dofs(fe: FE_Lagrange, f):
    """Local dofs of a function given in barycentric coordinates (point
    evaluation at the Lagrange nodes; custom elements apply their own
    functionals — with ``needs_derivatives`` the argument returns
    ``(val, dx, dy)``)."""
    if not isinstance(fe, FE_Lagrange):
        return fe.local_dofs(f)
    return f(fe.nodes)


def dof(fe: FE_Lagrange, mesh, i: int, f):
    """Evaluate global dof ``i`` (point evaluation) at Cartesian ``f``."""
    pos = global_dof_points(fe, mesh)[i]
    return f(*pos)


def global_dof_points(fe: FE_Lagrange, mesh) -> np.ndarray:
    """World coordinates of every global dof (Lagrange nodal points)."""
    pts = [mesh.p]
    if fe.k >= 2:
        v1 = mesh.p[mesh.e[:, 0]]
        v2 = mesh.p[mesh.e[:, 1]]
        if fe.k == 2:
            pts.append((v1 + v2) / 2)
        else:
            pts.append(v1 + (v2 - v1) / 3)
            pts.append(v1 + 2 * (v2 - v1) / 3)
            # interleave the two per-edge dofs
            a, b = pts.pop(-2), pts.pop(-1)
            inter = np.empty((2 * mesh.ne, mesh.p.shape[1]))
            inter[0::2] = a
            inter[1::2] = b
            pts.append(inter)
    if fe.k == 3:
        cells = mesh.p[mesh.t]
        pts.append(cells.mean(axis=1))
    return np.concatenate(pts, axis=0)
