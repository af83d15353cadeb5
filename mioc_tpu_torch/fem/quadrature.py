"""Symmetric Gauss quadrature on the unit triangle and its edges.

Counterpart of ``mioc_tpu.fem.quadrature`` (the reference's
``julia_fem/quadrature_unit_triangle.jl``, pure rule tables): the same numpy
code, kept in the port so that it imports nothing of the JAX package.
Points are barycentric; rules are returned as ``(points (nq, 3), weights
(nq,))`` numpy arrays instead of per-point structs so shape-function
evaluation vectorizes over all quadrature points at once.

A rule of exactness order ``r`` integrates all polynomials of degree ≤ r
exactly (the JAX package's ``tests/test_fem.py`` verifies it by monomial
integration; ``tests/test_torch_fem.py`` holds the port's tables equal).
"""

from __future__ import annotations

import numpy as np

__all__ = ["quadrature_unit_triangle_area", "quadrature_unit_triangle_bdry"]


def _rule(rows):
    pts = np.array([r[:3] for r in rows], dtype=np.float64)
    w = np.array([r[3] for r in rows], dtype=np.float64)
    assert np.all(pts >= -1e-15) and np.allclose(pts.sum(1), 1.0)
    return pts, w


def quadrature_unit_triangle_area(exactness_order: int):
    """Area rules of exactness order 1-6 (quadrature_unit_triangle.jl:23-78)."""
    o = exactness_order
    if o == 1:
        return _rule([(1 / 3, 1 / 3, 1 / 3, 1 / 2)])
    if o == 2:
        return _rule(
            [(0.5, 0.0, 0.5, 1 / 6), (0.5, 0.5, 0.0, 1 / 6), (0.0, 0.5, 0.5, 1 / 6)]
        )
    if o == 3:
        return _rule(
            [(1 / 3, 1 / 3, 1 / 3, 9 / 40)]
            + [(0.5, 0.0, 0.5, 1 / 15), (0.5, 0.5, 0.0, 1 / 15), (0.0, 0.5, 0.5, 1 / 15)]
            + [(1, 0, 0, 1 / 40), (0, 1, 0, 1 / 40), (0, 0, 1, 1 / 40)]
        )
    if o == 4:
        a1, a2 = 0.445948490915965, 0.091576213509771
        w1, w2 = 0.223381589678010 / 2, 0.109951743655322 / 2
        rows = []
        for a, w in [(a1, w1), (a2, w2)]:
            rows += [(a, a, 1 - 2 * a, w), (a, 1 - 2 * a, a, w), (1 - 2 * a, a, a, w)]
        return _rule(rows)
    if o == 5:
        a1 = (6 - np.sqrt(15)) / 21
        a2 = (6 + np.sqrt(15)) / 21
        w1 = (155 - np.sqrt(15)) / 2400
        w2 = (155 + np.sqrt(15)) / 2400
        rows = [(1 / 3, 1 / 3, 1 / 3, 9 / 80)]
        for a, w in [(a1, w1), (a2, w2)]:
            rows += [(a, a, 1 - 2 * a, w), (a, 1 - 2 * a, a, w), (1 - 2 * a, a, a, w)]
        return _rule(rows)
    if o == 6:
        a1, a2 = 0.063089014491502, 0.249286745170910
        a, b = 0.310352451033785, 0.053145049844816
        w1, w2, w3 = (
            0.050844906370206 / 2,
            0.116786275726378 / 2,
            0.082851075618374 / 2,
        )
        rows = []
        for aa, w in [(a1, w1), (a2, w2)]:
            rows += [
                (aa, aa, 1 - 2 * aa, w),
                (aa, 1 - 2 * aa, aa, w),
                (1 - 2 * aa, aa, aa, w),
            ]
        c = 1 - a - b
        rows += [
            (a, b, c, w3), (a, c, b, w3), (b, a, c, w3),
            (b, c, a, w3), (c, a, b, w3), (c, b, a, w3),
        ]
        return _rule(rows)
    raise ValueError(f"Quadrature of exactness order {o} not implemented.")


def quadrature_unit_triangle_bdry(edge: int, exactness_order: int):
    """Edge rules (exactness 1/3/5) on edge 1, 2 or 3 of the unit triangle
    (quadrature_unit_triangle.jl:87-134; Ern & Guermond p.359).  Edge ``i`` is
    opposite vertex ``i``; the rule is tabulated for edge 3 (λ₃ = 0) and
    cyclically permuted for the others."""
    o = exactness_order
    if o == 1:
        l1 = np.array([0.5])
        w = np.array([1.0])
    elif o == 3:
        l1 = np.array([0.5 + 0.5 * np.sqrt(3) / 3, 0.5 - 0.5 * np.sqrt(3) / 3])
        w = np.array([0.5, 0.5])
    elif o == 5:
        l1 = np.array([0.5 + 0.5 * np.sqrt(3 / 5), 0.5, 0.5 - 0.5 * np.sqrt(3 / 5)])
        w = np.array([5 / 18, 8 / 18, 5 / 18])
    else:
        raise ValueError(f"Edge quadrature of exactness order {o} not implemented.")
    l2 = 1.0 - l1
    l3 = np.zeros_like(l1)
    if edge == 1:
        lam = np.stack([l3, l1, l2], axis=1)
    elif edge == 2:
        lam = np.stack([l2, l3, l1], axis=1)
    elif edge == 3:
        lam = np.stack([l1, l2, l3], axis=1)
    else:
        raise ValueError("edge must be 1, 2 or 3")
    return lam, w
