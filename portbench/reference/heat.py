"""The heat problem (upstream ``example_heat.jl``; arXiv:2411.06856 §6.2).

    ∂_t y − α Δy = f₁(x) u₁(t) + f₂(x) u₂(t)   on Ω × [T0, T1],  Ω = [−1, 1]²,
    ∂y/∂n + κ y = κ T_out on ∂Ω,   y(T0) = temp0,
    f(u) = ∫ ½ ‖y − tempT‖²_{L²(Ω)} + γ (u₁ + u₂) dt,

with Gaussian sources ``f_m = c2_m exp(−c1_m |x − x_m|²)``.  Everything is
derived here again from the configuration: the mesh (the coarse
triangulation, red-refined), quadratic Lagrange elements, the mass,
stiffness and Robin matrices and the load columns with the configuration's
quadrature rules, then implicit Euler ``y_k = S⁻¹ (y_{k−1} + τ M⁻¹F
u_{k−1})`` with ``S = I + τ M⁻¹A``, and the trapezoid rule in time (the
control cost of step k taken at ``u_{min(k, nt−1)}``).  The gradient is
the exact derivative of that discrete ``f``, divided by τ.
"""

from __future__ import annotations

import numpy as np

from .levels import admissible_levels

# Symmetric rules on the unit triangle (barycentric points, weights summing
# to the triangle's area 1/2), by exactness order.
AREA_RULES = {
    3: ([(1 / 3, 1 / 3, 1 / 3)] + [(0.5, 0.0, 0.5), (0.5, 0.5, 0.0), (0.0, 0.5, 0.5)]
        + [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)],
        [9 / 40] + [1 / 15] * 3 + [1 / 40] * 3),
}
# Edge rules: positions along the edge in [0, 1] and weights summing to 1.
EDGE_RULES = {1: ([0.5], [1.0])}


def refine(p, t):
    """Red refinement: a new vertex at every edge midpoint, four children
    per triangle."""
    mids = {}
    pts = [tuple(x) for x in p]

    def mid(a, b):
        key = (min(a, b), max(a, b))
        if key not in mids:
            mids[key] = len(pts)
            pts.append(tuple((np.asarray(p[a]) + np.asarray(p[b])) / 2.0))
        return mids[key]

    out = []
    for a, b, c in t:
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        out += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
    return np.asarray(pts, dtype=np.float64), np.asarray(out, dtype=np.int64)


def p2_space(p, t):
    """Quadratic Lagrange dofs: the vertices, then one per edge.  Returns
    the per-triangle dofs ``(ntri, 6)`` (vertices, then the midpoints of the
    edges opposite them), the number of dofs, and the boundary edges as
    ``(vertex a, vertex b, midpoint dof)``."""
    edges, count = {}, {}
    for tri in t:
        for a, b in ((tri[1], tri[2]), (tri[0], tri[2]), (tri[0], tri[1])):
            key = (min(a, b), max(a, b))
            if key not in edges:
                edges[key] = len(p) + len(edges)
            count[key] = count.get(key, 0) + 1
    dofs = np.asarray([[tri[0], tri[1], tri[2],
                        edges[(min(tri[1], tri[2]), max(tri[1], tri[2]))],
                        edges[(min(tri[0], tri[2]), max(tri[0], tri[2]))],
                        edges[(min(tri[0], tri[1]), max(tri[0], tri[1]))]] for tri in t])
    bdry = [(a, b, d) for (a, b), d in edges.items() if count[(a, b)] == 1]
    return dofs, len(p) + len(edges), bdry


def p2_basis(lam):
    """Values ``(nq, 6)`` of the P2 basis at barycentric points ``(nq, 3)``
    and their derivatives ``(nq, 6, 3)`` by the barycentric coordinates."""
    l0, l1, l2 = lam[:, 0], lam[:, 1], lam[:, 2]
    val = np.stack([l0 * (2 * l0 - 1), l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
                    4 * l1 * l2, 4 * l0 * l2, 4 * l0 * l1], axis=1)
    z = np.zeros_like(l0)
    d = np.stack([
        np.stack([4 * l0 - 1, z, z], 1), np.stack([z, 4 * l1 - 1, z], 1),
        np.stack([z, z, 4 * l2 - 1], 1), np.stack([z, 4 * l2, 4 * l1], 1),
        np.stack([4 * l2, z, 4 * l0], 1), np.stack([4 * l1, 4 * l0, z], 1)], axis=1)
    return val, d


class Model:
    def __init__(self, cfg: dict, dtype=np.float64):
        p = cfg["problem"]
        self.dtype = dtype
        self.nt = int(cfg["nt"])
        self.tau = (p["T1"] - p["T0"]) / self.nt
        self.levels = admissible_levels(cfg["levels"])
        self.gamma = float(p["gamma"])
        M, A, F, Y0 = self.assemble(p)
        self.N = M.shape[0]
        M_inv = np.linalg.inv(M)
        S = np.eye(self.N) + self.tau * (M_inv @ A)
        self.Sinv = np.linalg.inv(S).astype(dtype)
        self.MinvF = (M_inv @ F).astype(dtype)
        self.state0 = np.linalg.solve(M, Y0).astype(dtype)
        self.M = M.astype(dtype)
        self.yd = np.full(self.N, p["tempT"], dtype)
        w = np.ones(self.nt + 1, dtype)
        w[0] = w[-1] = 0.5
        self.w = w
        c = np.ones(self.nt, dtype)
        c[0] = 0.5
        c[-1] += 0.5
        self.c = c   # weight of u_k in the control cost's trapezoid sum

    @staticmethod
    def assemble(p):
        """Mass ``M``, stiffness plus Robin ``A``, load columns ``F (N, 2)``
        and the initial state's load ``Y0``, dense."""
        mesh = p["mesh"]
        pts = np.asarray(mesh["points"], dtype=np.float64)
        tri = np.asarray(mesh["triangles"], dtype=np.int64)
        for _ in range(mesh["refinements"]):
            pts, tri = refine(pts, tri)
        dofs, N, bdry = p2_space(pts, tri)
        lam, wq = (np.asarray(a, dtype=np.float64) for a in AREA_RULES[p["quad_order_area"]])
        val, dlam = p2_basis(lam)
        M, A = np.zeros((N, N)), np.zeros((N, N))
        F, Y0 = np.zeros((N, 2)), np.zeros(N)
        sources = [(np.asarray(x, float), c1, c2)
                   for x, c1, c2 in zip(p["x_sources"], p["c1"], p["c2"])]
        for tr, d in zip(tri, dofs):
            x = pts[tr]                                            # (3, 2)
            J = np.stack([x[1] - x[0], x[2] - x[0]], axis=1)       # (2, 2)
            det = abs(np.linalg.det(J))
            # ∇λ₁, ∇λ₂ are the rows of J⁻¹; ∇λ₀ = −∇λ₁ − ∇λ₂.
            Jinv = np.linalg.inv(J)
            glam = np.stack([-Jinv[0] - Jinv[1], Jinv[0], Jinv[1]])  # (3, 2)
            grads = dlam @ glam                                    # (nq, 6, 2)
            xq = lam @ x                                           # (nq, 2)
            A[np.ix_(d, d)] += p["alpha"] * det * np.einsum("q,qik,qjk->ij", wq, grads, grads)
            M[np.ix_(d, d)] += det * np.einsum("q,qi,qj->ij", wq, val, val)
            for m, (xm, c1, c2) in enumerate(sources):
                fq = c2 * np.exp(-c1 * ((xq - xm) ** 2).sum(axis=1))
                F[d, m] += det * np.einsum("q,q,qi->i", wq, fq, val)
            Y0[d] += det * p["temp0"] * np.einsum("q,qi->i", wq, val)
        s, we = (np.asarray(a, dtype=np.float64) for a in EDGE_RULES[p["quad_order_bdry"]])
        kappa, tout = p["kappa"], p["Tout"]
        for a, b, mdof in bdry:
            length = np.linalg.norm(pts[b] - pts[a])
            # The edge's three P2 functions at the edge points.
            phi = np.stack([(1 - s) * (1 - 2 * s), s * (2 * s - 1), 4 * s * (1 - s)], axis=1)
            e = [a, b, mdof]
            A[np.ix_(e, e)] += kappa * length * np.einsum("q,qi,qj->ij", we, phi, phi)
            F[e, :] += (kappa * tout * length * np.einsum("q,qi->i", we, phi))[:, None]
        return M, A, F, Y0

    def states(self, us):
        """``ys (R, nt+1, N)`` for every row of ``us (R, nt, 2)``."""
        us = np.asarray(us, self.dtype)
        R = us.shape[0]
        tau = self.dtype(self.tau)
        drive = tau * (us @ self.MinvF.T)                           # (R, nt, N)
        ys = np.empty((R, self.nt + 1, self.N), self.dtype)
        y = np.broadcast_to(self.state0, (R, self.N)).copy()
        ys[:, 0] = y
        SinvT = self.Sinv.T
        for k in range(self.nt):
            y = (y + drive[:, k]) @ SinvT
            ys[:, k + 1] = y
        return ys

    def value(self, us):
        us = np.asarray(us, self.dtype)
        ys = self.states(us)
        v = ys - self.yd
        g = 0.5 * np.einsum("rkn,rkn->rk", v, v @ self.M)
        g += self.gamma * us[:, np.minimum(np.arange(self.nt + 1), self.nt - 1)].sum(-1)
        return self.dtype(self.tau) * (g * self.w).sum(axis=-1)

    def gradient(self, us):
        """``∂f/∂u / τ``, ``(R, nt, 2)``."""
        us = np.asarray(us, self.dtype)
        ys = self.states(us)
        tau = self.dtype(self.tau)
        R, nt = us.shape[0], self.nt
        grad = np.empty((R, nt, 2), self.dtype)
        mu = tau * self.w[nt] * ((ys[:, nt] - self.yd) @ self.M)    # ∂f/∂y_nt
        for k in range(nt - 1, -1, -1):
            back = mu @ self.Sinv                                   # S⁻ᵀ μ_{k+1}
            # ∂f/∂u_k through y_{k+1} = S⁻¹(y_k + τ M⁻¹F u_k), plus the cost.
            grad[:, k] = back @ self.MinvF + self.gamma * self.c[k]
            mu = back + tau * self.w[k] * ((ys[:, k] - self.yd) @ self.M)
        return grad
