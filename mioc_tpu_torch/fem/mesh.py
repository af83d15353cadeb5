"""Triangle meshes: construction, incidence, refinement, prolongation.

Counterpart of ``mioc_tpu.fem.mesh`` (the reference's ``julia_fem/mesh.jl``):
the same numpy code, kept in the port so that it imports nothing of the JAX
package.  Mesh building runs on the host at model construction; the device
sees only the assembled operators.  Index conventions are 0-based; "no
triangle" is −1 (the reference uses 1-based with 0).

Mesh generation (``init_mesh``): the reference shells out to Shewchuk's
Triangle (C) with quality+area flags (``mesh.jl:312-317``).  Here the native
C++ triangulator (``fem/native/triangle.cpp``, built with ``g++`` at first
use, :mod:`._native_triangle`) is used; without a C++ compiler a pure-Python
fallback (boundary-conforming point lattice + scipy Delaunay + outside-cell
filtering) covers the bundled convex/L-shaped/slit geometries, with a
warning: its mesh differs from the native one.

Structure:
  * :class:`Mesh` — vertices ``p (np, gd)``, triangles ``t (ntri, 3)``, edges
    ``e (ne, 4)`` = (v_lo, v_hi, tri_a, tri_b=−1 on boundary), boundary edges
    ``be (nbe, 2)`` = (edge index, segment marker), ``cell_to_edge`` with edge
    ``i`` opposite vertex ``i``, and per-cell affine maps ``B_K``, ``b_K``,
    ``B_K^{-T}`` (``mesh.jl:1-47, 235-263``).
  * uniform red refinement (``refine_all_cells``, ``mesh.jl:329-383``),
    newest-vertex bisection (``refine_adaptively``, ``mesh.jl:554-690``,
    iFEM-style), Lagrange prolongation (``mesh.jl:394-538``; specialized to
    nodal elements), analytic surface meshes (torus/Möbius/Klein,
    ``mesh.jl:692-846``), and ``sanity_check`` (``mesh.jl:894-939``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

__all__ = [
    "Mesh",
    "mesh_library",
    "init_mesh",
    "refine_all_cells",
    "refine_adaptively",
    "prolongation",
    "triangle_mesh",
    "torus_mesh",
    "moebius_mesh",
    "klein_bottle_mesh",
    "sanity_check",
]


@dataclass
class Mesh:
    geometry: np.ndarray
    p: np.ndarray            # (np, gd) vertex coordinates
    t: np.ndarray            # (ntri, 3) vertex indices
    e: np.ndarray            # (ne, 4) v_lo, v_hi, tri_a, tri_b (−1 = none)
    be: np.ndarray           # (nbe, 2) edge index, boundary marker
    cell_to_edge: np.ndarray  # (ntri, 3), edge i opposite vertex i
    affine_matrix: np.ndarray     # (ntri, gd, 2) B_K
    affine_vector: np.ndarray     # (ntri, gd) b_K
    affine_invmatrixT: np.ndarray  # (ntri, gd, 2) B_K^{-T}

    @property
    def np(self):
        return self.p.shape[0]

    @property
    def ne(self):
        return self.e.shape[0]

    @property
    def ntri(self):
        return self.t.shape[0]

    @property
    def gd(self):
        return self.p.shape[1]


def _build_edges(t, npts):
    """Edge table + cell_to_edge from the triangle list (mesh.jl:119-222),
    vectorized: occurrences keyed by sorted vertex pair, paired by sorting."""
    ntri = t.shape[0]
    # Occurrence j of triangle i: edges (v0,v1), (v1,v2), (v2,v0) — opposite
    # local vertices 2, 0, 1 respectively.
    pairs = np.stack(
        [t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]], axis=1
    ).reshape(-1, 2)  # (3*ntri, 2)
    tri_of = np.repeat(np.arange(ntri), 3)
    opp_of = np.tile(np.array([2, 0, 1]), ntri)

    lo = pairs.min(axis=1)
    hi = pairs.max(axis=1)
    key = lo.astype(np.int64) * npts + hi
    uniq, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    ne = len(uniq)

    e = np.full((ne, 4), -1, dtype=np.int64)
    e[:, 0] = uniq // npts
    e[:, 1] = uniq % npts
    # Scatter incident triangles: first occurrence → slot 2, second → slot 3.
    order = np.argsort(inv, kind="stable")
    inv_sorted = inv[order]
    first_mask = np.ones(len(order), bool)
    first_mask[1:] = inv_sorted[1:] != inv_sorted[:-1]
    e[inv_sorted[first_mask], 2] = tri_of[order[first_mask]]
    second = ~first_mask
    e[inv_sorted[second], 3] = tri_of[order[second]]

    cell_to_edge = np.empty((ntri, 3), dtype=np.int64)
    cell_to_edge[tri_of, opp_of] = inv
    return e, cell_to_edge


def _affine_maps(p, t):
    """Per-cell affine reference maps (mesh.jl:235-263)."""
    v1, v2, v3 = p[t[:, 0]], p[t[:, 1]], p[t[:, 2]]
    B = np.stack([v2 - v1, v3 - v1], axis=2)  # (ntri, gd, 2)
    gd = p.shape[1]
    if gd == 2:
        invT = np.linalg.inv(np.swapaxes(B, 1, 2))
    else:
        # B (BᵀB)^{-1} — the pseudo-inverse transpose for surface meshes.
        BtB = np.einsum("nij,nik->njk", B, B)
        invT = np.einsum("nij,njk->nik", B, np.linalg.inv(BtB))
    return B, v1.copy(), invT


def make_mesh(p, t, segments=None, markers=None, geometry=None,
              align_triangles=False) -> Mesh:
    """Assemble the full incidence structure from vertices + triangles
    (+ optional boundary segments with markers)."""
    p = np.asarray(p, dtype=np.float64)
    t = np.asarray(t, dtype=np.int64)
    if align_triangles:
        t = _align_triangles(p, t)
    e, c2e = _build_edges(t, p.shape[0])

    if segments is not None and len(segments):
        segments = np.asarray(segments, dtype=np.int64)
        markers = (
            np.asarray(markers, dtype=np.int64)
            if markers is not None
            else np.ones(len(segments), dtype=np.int64)
        )
        lo = segments.min(axis=1).astype(np.int64)
        hi = segments.max(axis=1)
        key = lo * p.shape[0] + hi
        ekey = e[:, 0] * p.shape[0] + e[:, 1]
        idx = np.searchsorted(ekey, key)
        bad = (idx >= len(ekey)) | (ekey[np.clip(idx, 0, len(ekey) - 1)] != key)
        if np.any(bad):
            b = int(np.nonzero(bad)[0][0])
            raise ValueError(
                f"Boundary segment {segments[b].tolist()} is not an edge of "
                "the triangulation."
            )
        be = np.stack([idx, markers], axis=1)
    else:
        # Derive: every edge with a single incident triangle, marker 1.
        bidx = np.nonzero(e[:, 3] < 0)[0]
        be = np.stack([bidx, np.ones(len(bidx), dtype=np.int64)], axis=1)

    B, b, invT = _affine_maps(p, t)
    return Mesh(
        geometry=np.asarray(geometry) if geometry is not None else np.zeros((0, 0)),
        p=p, t=t, e=e, be=be, cell_to_edge=c2e,
        affine_matrix=B, affine_vector=b, affine_invmatrixT=invT,
    )


def _align_triangles(p, t):
    """Longest edge first + counterclockwise (mesh.jl:70-117)."""
    t = t.copy()
    v1, v2, v3 = p[t[:, 0]], p[t[:, 1]], p[t[:, 2]]
    e1 = np.linalg.norm(v2 - v3, axis=1)
    e2 = np.linalg.norm(v3 - v1, axis=1)
    e3 = np.linalg.norm(v1 - v2, axis=1)
    if p.shape[1] == 2:
        o = (
            (v1[:, 1] + v2[:, 1]) * (v1[:, 0] - v2[:, 0])
            + (v2[:, 1] + v3[:, 1]) * (v2[:, 0] - v3[:, 0])
            + (v3[:, 1] + v1[:, 1]) * (v3[:, 0] - v1[:, 0])
        ) > 0
    else:
        o = np.ones(len(t), bool)
    first = np.where(
        (e1 >= e2) & (e1 >= e3), 0, np.where(e2 >= e3, 1, 2)
    )
    out = np.empty_like(t)
    for f in range(3):
        m = first == f
        a, b, c = f, (f + 1) % 3, (f + 2) % 3
        out[m & o] = t[np.ix_(np.nonzero(m & o)[0], [a, b, c])]
        out[m & ~o] = t[np.ix_(np.nonzero(m & ~o)[0], [a, c, b])]
    return out


# -- mesh generation ----------------------------------------------------------

_GEOMETRIES = {
    "squareg": [[-1, -1], [1, -1], [1, 1], [-1, 1]],
    "lshapeg": [[-1, -1], [1, -1], [1, 1], [0, 1], [0, 0], [-1, 0]],
    "regulartriangleg": [
        [np.cos(0), np.sin(0)],
        [np.cos(2 * np.pi / 3), np.sin(2 * np.pi / 3)],
        [np.cos(4 * np.pi / 3), np.sin(4 * np.pi / 3)],
    ],
    "unittriangle": [[0, 0], [1, 0], [0, 1]],
    "slitg": [[-1, -1], [1, -1], [1, 0], [0, 0], [1, 1e-2], [1, 1], [-1, 1]],
}


def mesh_library(geometry: str, hmax: float) -> Mesh:
    """Predefined geometries (mesh.jl:50-68): squareg, lshapeg,
    regulartriangleg, unittriangle, slitg."""
    if geometry not in _GEOMETRIES:
        raise ValueError(
            f"Geometry {geometry!r} not recognized; pass vertices to init_mesh."
        )
    return init_mesh(np.array(_GEOMETRIES[geometry], dtype=float), hmax)


def init_mesh(vertices: np.ndarray, maxarea: float) -> Mesh:
    """Quality-ish triangulation of the polygon with triangle areas ≤ maxarea
    (mesh.jl:296-327; reference uses Triangle's ``pa…Qq``).  Uses the native
    C++ triangulator when it builds, otherwise the Python fallback (a
    different mesh; :mod:`._native_triangle` warns once)."""
    vertices = np.asarray(vertices, dtype=np.float64)
    assert vertices.shape[1] == 2
    from . import _native_triangle

    out = _native_triangle.triangulate(vertices, maxarea)
    if out is not None:
        p, t, segments, markers = out
        return make_mesh(p, t, segments, markers, geometry=vertices)
    return _init_mesh_python(vertices, maxarea)


def _point_in_polygon(points, poly):
    """Even-odd rule point-in-polygon test, vectorized over points."""
    x, y = points[:, 0], points[:, 1]
    inside = np.zeros(len(points), dtype=bool)
    n = len(poly)
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        cond = (y1 > y) != (y2 > y)
        with np.errstate(divide="ignore", invalid="ignore"):
            xin = (x2 - x1) * (y - y1) / (y2 - y1) + x1
        inside ^= cond & (x < xin)
    return inside


def _seg_distance(points, a, b):
    """Distance of each point to the segment a→b."""
    ab = b - a
    t = np.clip(((points - a) @ ab) / max(ab @ ab, 1e-300), 0.0, 1.0)
    return np.linalg.norm(points - (a + t[:, None] * ab), axis=1)


def _init_mesh_python(vertices, maxarea):
    """Fallback generator: boundary-conforming lattice + Delaunay with
    iterative boundary-segment recovery (midpoint splitting) + filter.

    The recovery loop makes the fallback constrained in practice: any
    boundary subsegment missing from the Delaunay triangulation is split at
    its midpoint and the triangulation is rebuilt — narrow features like the
    slitg sliver are recovered instead of being triangulated across."""
    from scipy.spatial import Delaunay

    h = np.sqrt(2.0 * maxarea)
    nv = len(vertices)

    # Boundary points: polygon vertices + points spaced ≤ h on each segment;
    # subsegments tracked as (ia, ib, marker) point-index triples.
    pts = [np.asarray(v, float) for v in vertices]
    subsegs = []
    for i in range(nv):
        a, b = vertices[i], vertices[(i + 1) % nv]
        nseg = max(1, int(np.ceil(np.linalg.norm(b - a) / h)))
        prev = i
        for j in range(1, nseg):
            pts.append(a + (b - a) * j / nseg)
            subsegs.append((prev, len(pts) - 1, i + 1))
            prev = len(pts) - 1
        subsegs.append((prev, (i + 1) % nv, i + 1))
    bpts = np.asarray(pts)

    # Interior lattice (hex-offset rows for better quality), ≥ h/2 from the
    # boundary — both the sample points and the segment lines (narrow
    # features are closer to a segment's interior than to its samples).
    xmin, ymin = vertices.min(axis=0)
    xmax, ymax = vertices.max(axis=0)
    rows = []
    y = ymin + h * 0.6
    r = 0
    while y < ymax - h * 0.3:
        xs = np.arange(xmin + h * (0.6 + 0.5 * (r % 2)), xmax - h * 0.3, h)
        rows.append(np.stack([xs, np.full_like(xs, y)], axis=1))
        y += h * np.sqrt(3) / 2
        r += 1
    ipts = np.concatenate(rows) if rows else np.zeros((0, 2))
    if len(ipts):
        ipts = ipts[_point_in_polygon(ipts, vertices)]
    if len(ipts):
        dmin = np.full(len(ipts), np.inf)
        for i in range(nv):
            dmin = np.minimum(
                dmin, _seg_distance(ipts, vertices[i], vertices[(i + 1) % nv])
            )
        ipts = ipts[dmin > 0.5 * h]

    pts = list(bpts) + list(ipts)

    # Delaunay + segment recovery: split any boundary subsegment that is not
    # an edge of the triangulation at its midpoint and retriangulate.
    for _ in range(32):
        arr = np.asarray(pts)
        tri = Delaunay(arr)
        simp = tri.simplices
        ekeys = set()
        n_pts = len(pts)
        for (ea, eb) in ((0, 1), (1, 2), (2, 0)):
            lo = np.minimum(simp[:, ea], simp[:, eb])
            hi = np.maximum(simp[:, ea], simp[:, eb])
            ekeys.update((lo * n_pts + hi).tolist())
        missing = [
            s for s in subsegs
            if min(s[0], s[1]) * n_pts + max(s[0], s[1]) not in ekeys
        ]
        if not missing:
            break
        for (ia, ib, m) in missing:
            mid = 0.5 * (pts[ia] + pts[ib])
            pts.append(mid)
            subsegs.remove((ia, ib, m))
            subsegs.append((ia, len(pts) - 1, m))
            subsegs.append((len(pts) - 1, ib, m))
    else:
        raise RuntimeError("Boundary segment recovery did not converge.")

    pts = np.asarray(pts)
    t = simp.astype(np.int64)
    # Filter cells outside the (possibly non-convex) polygon & degenerate ones.
    centroids = pts[t].mean(axis=1)
    keep = _point_in_polygon(centroids, vertices)
    v1, v2, v3 = pts[t[:, 0]], pts[t[:, 1]], pts[t[:, 2]]
    d1, d2 = v2 - v1, v3 - v1
    area2 = np.abs(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])
    keep &= area2 > 1e-12 * max(1.0, area2.max())
    t = t[keep]

    segments = np.asarray([[ia, ib] for ia, ib, _ in subsegs])
    markers = np.asarray([m for _, _, m in subsegs])
    return make_mesh(pts, t, segments, markers, geometry=vertices)


# -- refinement ---------------------------------------------------------------

def refine_all_cells(mesh: Mesh) -> Mesh:
    """Uniform red refinement: one new vertex per edge, 4 children per cell
    in the reference's child ordering (mesh.jl:329-383)."""
    mid = (mesh.p[mesh.e[:, 0]] + mesh.p[mesh.e[:, 1]]) / 2.0
    newp = np.concatenate([mesh.p, mid])

    p1, p2, p3 = mesh.t[:, 0], mesh.t[:, 1], mesh.t[:, 2]
    p23 = mesh.np + mesh.cell_to_edge[:, 0]
    p31 = mesh.np + mesh.cell_to_edge[:, 1]
    p12 = mesh.np + mesh.cell_to_edge[:, 2]
    children = np.stack(
        [
            np.stack([p1, p12, p31], 1),
            np.stack([p2, p23, p12], 1),
            np.stack([p3, p31, p23], 1),
            np.stack([p12, p23, p31], 1),
        ],
        axis=1,
    ).reshape(-1, 3)

    bedges = mesh.be[:, 0]
    a = mesh.e[bedges, 0]
    b = mesh.e[bedges, 1]
    m = mesh.np + bedges
    segments = np.concatenate(
        [np.stack([a, m], 1), np.stack([m, b], 1)]
    )
    markers = np.concatenate([mesh.be[:, 1], mesh.be[:, 1]])
    return make_mesh(newp, children, segments, markers, geometry=mesh.geometry)


def refine_adaptively(mesh: Mesh, marker) -> Mesh:
    """Newest-vertex bisection of the marked cells (mesh.jl:554-690,
    iFEM-style): propagate markers until every cut cell's refinement edge
    (edge opposite vertex 0) is cut, then bisect."""
    marker = list(np.atleast_1d(np.asarray(marker, dtype=np.int64)))
    is_cut = np.zeros(mesh.ne, dtype=np.int64)  # 0 or 1-based cut number
    nce = 0
    while marker:
        nxt = []
        for idx in marker:
            edge = mesh.cell_to_edge[idx, 0]
            if is_cut[edge] == 0:
                nce += 1
                is_cut[edge] = nce
            t2 = mesh.e[edge, 3] if mesh.e[edge, 2] == idx else mesh.e[edge, 2]
            nxt.append(idx if t2 < 0 else t2)
        marker = [i for i in nxt if is_cut[mesh.cell_to_edge[i, 0]] == 0]

    mid_ids = mesh.np + is_cut - 1  # valid where is_cut > 0
    cut_edges = np.nonzero(is_cut)[0]
    order = np.argsort(is_cut[cut_edges])
    cut_sorted = cut_edges[order]
    newp = np.concatenate(
        [mesh.p, (mesh.p[mesh.e[cut_sorted, 0]] + mesh.p[mesh.e[cut_sorted, 1]]) / 2]
    )

    newt = []
    for i in range(mesh.ntri):
        ip1, ip2, ip3 = mesh.t[i]
        e1, e2, e3 = mesh.cell_to_edge[i]
        ie1 = mid_ids[e1] if is_cut[e1] else -1
        ie2 = mid_ids[e2] if is_cut[e2] else -1
        ie3 = mid_ids[e3] if is_cut[e3] else -1
        if ie1 >= 0:
            if ie2 >= 0:
                newt.append([ie2, ie1, ip3])
                newt.append([ie2, ip1, ie1])
            else:
                newt.append([ie1, ip3, ip1])
            if ie3 >= 0:
                newt.append([ie3, ie1, ip1])
                newt.append([ie3, ip2, ie1])
            else:
                newt.append([ie1, ip1, ip2])
        else:
            newt.append([ip1, ip2, ip3])
    newt = np.asarray(newt, dtype=np.int64)

    segs, marks = [], []
    for k in range(len(mesh.be)):
        edge, mk = mesh.be[k]
        a, b = mesh.e[edge, 0], mesh.e[edge, 1]
        if is_cut[edge]:
            m = mid_ids[edge]
            segs += [[a, m], [m, b]]
            marks += [mk, mk]
        else:
            segs.append([a, b])
            marks.append(mk)
    return make_mesh(
        newp, newt, np.asarray(segs), np.asarray(marks), geometry=mesh.geometry
    )


# -- prolongation -------------------------------------------------------------

def _barycentric(mesh: Mesh, idx: int, x):
    """Barycentric coordinates of world points ``x (n, gd)`` in cell idx."""
    B = mesh.affine_matrix[idx]
    b = mesh.affine_vector[idx]
    rhs = (np.atleast_2d(x) - b).T
    if mesh.gd == 2:
        lam23 = np.linalg.solve(B, rhs)
    else:
        lam23, *_ = np.linalg.lstsq(B, rhs, rcond=None)
    lam = np.empty((rhs.shape[1], 3))
    lam[:, 1:] = lam23.T
    lam[:, 0] = 1.0 - lam23.sum(axis=0)
    return lam


def transform_derivative(E, t_shape, lam):
    """World/fine-frame derivative transform for prolongation
    (mesh.jl:541-552): given ``t_shape(lam) -> (val, dval)`` with ``dval
    (nq, 2, nld)`` the gradients w.r.t. the COARSE reference frame, return
    ``(val, dx, dy)`` with the derivative planes ``(nq, nld)`` mapped through
    ``E = A_fᵀ B_c⁻ᵀ`` into the fine cell's reference frame (chain rule for
    the barycentric embedding; see :func:`prolongation`)."""
    val, dval = t_shape(lam)
    dx = E[0, 0] * dval[:, 0, :] + E[0, 1] * dval[:, 1, :]
    dy = E[1, 0] * dval[:, 0, :] + E[1, 1] * dval[:, 1, :]
    return val, dx, dy


def _local_dofmap(fe, mesh, idx, n):
    """Dense local dofmap matrix from ``flat_dofmap``'s (g, i, j, s) triplets
    (identity for Lagrange elements)."""
    from .fe import flat_dofmap

    g, i, j, s = flat_dofmap(fe, mesh, idx)
    D = np.zeros((n, n))
    np.add.at(D, (np.asarray(i), np.asarray(j)), np.asarray(s, float))
    return g, D


def _prolongation_general(mesh: Mesh, rmesh: Mesh, fe, rfe) -> sp.csr_matrix:
    """Element-generic prolongation (mesh.jl:394-538): apply the FINE
    element's local dof functionals (``local_dofs``) to the coarse basis
    composed with the cell embedding; derivative-consuming dofs
    (``rfe.needs_derivatives``) receive the E-transformed gradients via
    :func:`transform_derivative`; non-identity local dofmaps are solved out
    like the reference's ``rdofmap \\ rdof_to_shape'``."""
    from .fe import local_dofs, ndofs, nlocaldofs, shape

    nr, nc = ndofs(rfe, rmesh), ndofs(fe, mesh)
    nld_r, nld_c = nlocaldofs(rfe), nlocaldofs(fe)
    id_c = np.eye(nld_c)
    id_r = np.eye(nld_r)

    rows, cols, vals = [], [], []
    count = np.zeros(nr)
    cache = {}
    idx = 0  # parent walk: children are ordered by parent (mesh.jl:428-442)
    for i in range(rmesh.ntri):
        while idx < mesh.ntri:
            # C (3, 3): coarse barycentric coordinates of the fine vertices;
            # a fine-barycentric point λ maps to coarse barycentric λ @ C.
            C = _barycentric(mesh, idx, rmesh.p[rmesh.t[i]])
            if C.min() >= -1e-10:
                break
            idx += 1
        if idx >= mesh.ntri:
            raise RuntimeError(f"Did not find parent of fine cell {i}")

        if rfe.needs_derivatives:
            # ∂/∂ξ_fine = A_fᵀ B_c⁻ᵀ ∂/∂ξ_coarse  (mesh.jl:455-457).
            E = (
                rmesh.affine_matrix[i][:, :2].T
                @ mesh.affine_invmatrixT[idx][:, :2]
            )
            t_shape = lambda lam: transform_derivative(
                E, lambda l: shape(fe, l @ C, return_d=True), lam
            )
            key = (np.round(C, 8).tobytes(), np.round(E, 8).tobytes())
        else:
            t_shape = lambda lam: shape(fe, np.atleast_2d(lam) @ C)
            key = np.round(C, 8).tobytes()

        W = cache.get(key)
        if W is None:
            W = np.asarray(local_dofs(rfe, t_shape), float)  # (nld_r, nld_c)
            cache[key] = W

        rg, Dr = _local_dofmap(rfe, rmesh, i, nld_r)
        cg, Dc = _local_dofmap(fe, mesh, idx, nld_c)
        V = W
        if not np.array_equal(Dr, id_r):
            V = np.linalg.solve(Dr, V)
        if not np.array_equal(Dc, id_c):
            V = V @ Dc.T

        rr, cc = np.nonzero(np.abs(V) > 1e-14)
        rows.append(rg[rr])
        cols.append(cg[cc])
        vals.append(V[rr, cc])
        count[rg] += 1

    P = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nr, nc),
    )
    inv_count = np.zeros(nr)
    nzr = count > 0
    inv_count[nzr] = 1.0 / count[nzr]
    return sp.diags(inv_count) @ P


def prolongation(mesh: Mesh, rmesh: Mesh, fe, rfe=None) -> sp.csr_matrix:
    """Prolongation matrix P with ``P @ U`` the fine-mesh coefficients of the
    coarse FE function U (mesh.jl:394-538).  Lagrange (nodal) pairs take a
    vectorized fast path — each fine dof is a point evaluation, so
    ``P[r, c] = φ_c(x_r)`` on the parent cell; any other element pair goes
    through the generic functional-application path
    (:func:`_prolongation_general`, incl. derivative-dof transforms —
    mesh.jl:541-552).  Duplicate rows are averaged like the reference's
    ``coun`` normalization (mesh.jl:523-537)."""
    from .fe import FE_Lagrange, cell_dofs, ndofs, shape

    rfe = rfe or fe
    if not (isinstance(fe, FE_Lagrange) and isinstance(rfe, FE_Lagrange)):
        return _prolongation_general(mesh, rmesh, fe, rfe)
    rdofs_all = cell_dofs(rfe, rmesh)
    cdofs_all = cell_dofs(fe, mesh)
    nr, nc = ndofs(rfe, rmesh), ndofs(fe, mesh)

    rows, cols, vals = [], [], []
    count = np.zeros(nr)
    idx = 0  # parent walk: children are ordered by parent (mesh.jl:428-442)
    for i in range(rmesh.ntri):
        # Fine local node positions in world coordinates.
        lam_nodes = rfe.nodes  # (nld_r, 3)
        Xr = lam_nodes @ rmesh.p[rmesh.t[i]]  # (nld_r, gd)
        while idx < mesh.ntri:
            lam = _barycentric(mesh, idx, Xr)
            if lam.min() >= -1e-10:
                break
            idx += 1
        if idx >= mesh.ntri:
            raise RuntimeError(f"Did not find parent of fine cell {i}")
        V = shape(fe, lam)  # (nld_r, nld_c)
        rg, cg = rdofs_all[i], cdofs_all[idx]
        nz = np.abs(V) > 1e-14
        rr, cc = np.nonzero(nz)
        rows.append(rg[rr])
        cols.append(cg[cc])
        vals.append(V[rr, cc])
        count[rg] += 1

    P = sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nr, nc),
    )
    inv_count = np.zeros(nr)
    nzr = count > 0
    inv_count[nzr] = 1.0 / count[nzr]
    return sp.diags(inv_count) @ P


# -- analytic meshes (mesh.jl:692-846) ---------------------------------------

def triangle_mesh() -> Mesh:
    p = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    t = np.array([[0, 1, 2]])
    return make_mesh(p, t)


def torus_mesh(R, r, N=10, n=None) -> Mesh:
    n = n if n is not None else max(3, round(N * r / R))
    p = np.empty((N * n, 3))
    t = []
    for I in range(N):
        for i in range(n):
            phi, psi = 2 * np.pi * I / N, 2 * np.pi * i / n
            p[I * n + i] = [
                (r * np.cos(psi) + R) * np.sin(phi),
                (r * np.cos(psi) + R) * np.cos(phi),
                r * np.sin(psi),
            ]
            Ip1, ip1 = (I + 1) % N, (i + 1) % n
            t.append([I * n + i, Ip1 * n + i, Ip1 * n + ip1])
            t.append([I * n + i, I * n + ip1, Ip1 * n + ip1])
    return make_mesh(p, np.asarray(t), geometry=np.array([[R], [r]]))


def moebius_mesh(R, w, N, n=None) -> Mesh:
    n = n if n is not None else max(2, round(N * w / (2 * np.pi * R)))
    p = np.empty((N * (n + 1), 3))
    t = []
    for I in range(N):
        for i in range(n + 1):
            phi = 2 * np.pi * I / N
            v = -w / 2 + w * i / n
            p[I * (n + 1) + i] = [
                (R + v * np.cos(phi / 2)) * np.cos(phi),
                (R + v * np.cos(phi / 2)) * np.sin(phi),
                v * np.sin(phi / 2),
            ]
    for I in range(N):
        for i in range(n):
            a = I * (n + 1) + i
            if I < N - 1:
                t.append([a, (I + 1) * (n + 1) + i, (I + 1) * (n + 1) + i + 1])
                t.append([a, (I + 1) * (n + 1) + i + 1, a + 1])
            else:
                ii = n - 1 - i  # glue with a half twist
                t.append([a + 1, ii, ii + 1])
                t.append([a, ii + 1, a + 1])
    segs = []
    for I in range(N - 1):
        segs.append([I * (n + 1), (I + 1) * (n + 1)])
        segs.append([I * (n + 1) + n, (I + 1) * (n + 1) + n])
    segs.append([(N - 1) * (n + 1), n])
    segs.append([(N - 1) * (n + 1) + n, 0])
    return make_mesh(
        p, np.asarray(t), np.asarray(segs), np.ones(len(segs), dtype=np.int64),
        geometry=np.array([[R], [w]]),
    )


def klein_bottle_mesh(N, n=None) -> Mesh:
    """Immersed Klein bottle (parametrization after Franzoni; cf.
    mesh.jl:776-846)."""
    n = n if n is not None else 2 * max(1, round(N / 6))
    if n % 2:
        raise ValueError("n must be even")
    a, b, c, d, e, f, g = 20.0, 12.0, 5.5, 4.0, 1.5, 4.0, 3.8

    def h1(s):
        return b * np.exp(-e * (s - g) ** 2)

    def h2(s):
        return h1(s) - h1(0.0) - (h1(2 * np.pi) - h1(0.0)) * s / (2 * np.pi)

    def gamma(s):
        return np.array([a * (1 - np.cos(s)), h2(s), 0.0])

    def gammap(s):
        h1p = lambda t: h1(t) * 2 * e * (g - t)
        h2p = h1p(s) - (h1(2 * np.pi) - h1(0.0)) / (2 * np.pi)
        return np.array([a * np.sin(s), h2p, 0.0])

    def rad(s):
        hh = lambda t: np.arctan(e * np.sin(t + 1.5 * np.exp(-((t - 2.5) ** 2) / 2.5))) / np.arctan(e)
        return c + d * (hh(s) - (hh(2 * np.pi) - hh(0.0)) * (s - np.pi) / (2 * np.pi))

    k = np.array([0.0, 0.0, 1.0])
    p = np.empty((N * n, 3))
    t = []
    for I in range(N):
        s = 2 * np.pi * I / N
        T = gammap(s) / np.linalg.norm(gammap(s)) if s > 0 else np.array([1.0, 0.0, 0.0])
        M = np.cross(k, T)
        for i in range(n):
            th = 2 * np.pi * i / n
            p[I * n + i] = gamma(s) + rad(s) * (M * np.cos(th) + k * np.sin(th))
    for I in range(N):
        for i in range(n):
            ip1 = (i + 1) % n
            if I < N - 1:
                t.append([I * n + i, (I + 1) * n + i, (I + 1) * n + ip1])
                t.append([I * n + i, I * n + ip1, (I + 1) * n + ip1])
            else:
                shift = -(n // 2 - 1)
                ii = (n - i + shift) % n
                iim1 = (ii - 1) % n
                t.append([I * n + i, ii, iim1])
                t.append([I * n + i, I * n + ip1, iim1])
    return make_mesh(p, np.asarray(t))


# -- checks -------------------------------------------------------------------

def cell_areas(mesh: Mesh) -> np.ndarray:
    B = mesh.affine_matrix
    if mesh.gd == 2:
        return np.abs(B[:, 0, 0] * B[:, 1, 1] - B[:, 0, 1] * B[:, 1, 0]) / 2
    BtB = np.einsum("nij,nik->njk", B, B)
    return np.sqrt(np.linalg.det(BtB)) / 2


def sanity_check(mesh: Mesh, verbose=False):
    """Euler characteristic, edge-count identity, total area, circumference,
    and per-cell affine-determinant consistency (mesh.jl:894-939; the det
    check is mesh.jl:917-918).  Returns (euler, area, circumference)."""
    nbe = len(mesh.be)
    assert 2 * mesh.ne - nbe == 3 * mesh.ntri, "2·ne − nbe must equal 3·ntri"
    euler = mesh.np - mesh.ne + mesh.ntri
    # Per-cell consistency: the vertex-coordinate (shoelace) area of every
    # cell must equal |det B_K|/2 of its affine map (mesh.jl:917-918).
    v = mesh.p[mesh.t]  # (ntri, 3, gd)
    d1, d2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    if mesh.gd == 2:
        shoelace = 0.5 * np.abs(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])
    else:
        shoelace = 0.5 * np.linalg.norm(np.cross(d1, d2), axis=1)
    ca = cell_areas(mesh)
    assert np.allclose(shoelace, ca, rtol=1e-10, atol=1e-14), (
        "per-cell shoelace area must match |det B_K|/2 of the affine map"
    )
    area = float(ca.sum())
    v1 = mesh.p[mesh.e[mesh.be[:, 0], 0]]
    v2 = mesh.p[mesh.e[mesh.be[:, 0], 1]]
    circ = float(np.linalg.norm(v2 - v1, axis=1).sum())
    if verbose:
        print(f"Euler characteristic: {euler}")
        print(f"Area: {area:.15f}")
        print(f"Circumference: {circ:.15f}")
    return euler, area, circ
