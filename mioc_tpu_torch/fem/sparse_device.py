"""Device sparse linear algebra for the PDE sweeps: ELL storage and CG.

Counterpart of ``mioc_tpu.fem.sparse_device``.  The dense PDE mode keeps a
dense ``S⁻¹`` (O(N²) memory); the matrix-free cg/mg modes instead solve
``K y = M y_prev + τ F u`` per implicit-Euler step with a fixed number of
preconditioned CG iterations, warm-started from the previous step.

* ELL (padded-row) storage: ``values (N, K)`` / ``cols (N, K)`` with rows
  padded by zero-weighted self-references (:func:`to_ell`, the JAX
  package's numpy code).  The matvec is one gather and one row sum.
* A fixed-iteration preconditioned CG whose updates are guarded
  (``where(pAp > 0, …)``, ``where(rz > 0, …)``): a row whose residual is
  exactly zero — a converged row, or a zero pad row of a fixed-width batch —
  stays a fixed point instead of turning into 0/0.

:func:`cg_solve_rows` is the K-row form the sweeps use: every reduction is a
row sum and every scalar a per-row broadcast, so row k's iterates depend on
row k alone; the rows go through in chunks of exactly
:data:`~mioc_tpu_torch.ops.rows.ROWS` rows (zero rows appended), so every
product and every row sum has one shape whatever the batch, and each row has
the bits of its single evaluation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rows import chunked

__all__ = ["to_ell", "ell_matvec", "cg_solve", "cg_solve_rows"]


def to_ell(mat, dtype=np.float64):
    """Convert a scipy sparse (or dense) matrix to padded ELL arrays.

    Returns numpy ``(values, cols)`` of shape ``(N, K)`` with ``K`` = max row
    nnz; padding entries have ``value 0`` and ``col = row`` (an inert
    gather).
    """
    import scipy.sparse as sp

    csr = sp.csr_matrix(mat)
    csr.sum_duplicates()
    N = csr.shape[0]
    row_nnz = np.diff(csr.indptr)
    K = max(1, int(row_nnz.max()))
    values = np.zeros((N, K), dtype=dtype)
    cols = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, K))
    for i in range(N):
        lo, hi = csr.indptr[i], csr.indptr[i + 1]
        values[i, : hi - lo] = csr.data[lo:hi]
        cols[i, : hi - lo] = csr.indices[lo:hi]
    return values, cols


def ell_matvec(values, cols, x):
    """``y = A @ x`` for ELL-format ``A`` (``values``, ``cols`` tensors on
    ``x``'s device; ``cols`` int64): a gather and a row sum.  ``x`` is one
    vector ``(ncols,)`` or rows ``(K, ncols)``, which give ``(K, N)``."""
    return (values * x[..., cols]).sum(-1)


def _guarded_div(num, den):
    """``num / den`` where ``den > 0``, else 0 (a zero row stays a fixed
    point)."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def cg_solve(matvec, b, x0, precond, iters: int):
    """Fixed-iteration preconditioned CG for an SPD ``matvec`` on one vector.

    ``precond`` is the Jacobi vector ``1/diag(A)`` or a callable ``r -> z``
    applying an SPD preconditioner (e.g. a multigrid V-cycle,
    :func:`~mioc_tpu_torch.fem.multigrid.mg_apply`).  Runs exactly ``iters``
    iterations; once the residual hits zero the guarded updates make further
    iterations no-ops."""
    apply_pc = precond if callable(precond) else (lambda r: precond * r)
    x = x0
    r = b - matvec(x)
    z = apply_pc(r)
    p = z
    rz = (r * z).sum()
    for _ in range(iters):
        Ap = matvec(p)
        alpha = _guarded_div(rz, (p * Ap).sum())
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_pc(r)
        rz_new = (r * z).sum()
        beta = _guarded_div(rz_new, rz)
        p = z + beta * p
        rz = rz_new
    return x


def _cg_rows(matvec_rows, b, x, apply_pc, iters):
    """The K-row CG on one chunk: row sums, per-row guarded scalars."""
    r = b - matvec_rows(x)
    z = apply_pc(r)
    p = z
    rz = (r * z).sum(-1)
    for _ in range(iters):
        Ap = matvec_rows(p)
        alpha = _guarded_div(rz, (p * Ap).sum(-1))[:, None]
        x = torch.addcmul(x, alpha, p)
        r = torch.addcmul(r, alpha, Ap, value=-1)
        z = apply_pc(r)
        rz_new = (r * z).sum(-1)
        beta = _guarded_div(rz_new, rz)[:, None]
        p = torch.addcmul(z, beta, p)
        rz = rz_new
    return x


def cg_solve_rows(matvec_rows, b, x0, precond_rows, iters: int):
    """K-row preconditioned CG: ``b``, ``x0 (K, N)``, each row an independent
    SPD solve through a shared K-RHS operator ``matvec_rows``.

    ``precond_rows`` is the Jacobi vector ``1/diag(A)`` (broadcast over
    rows) or a callable ``R (ROWS, N) -> Z (ROWS, N)`` (e.g.
    :func:`~mioc_tpu_torch.fem.multigrid.mg_apply_banded_rows`).  The rows go
    through in chunks of exactly :data:`~mioc_tpu_torch.ops.rows.ROWS`
    rows, the last one padded with zero rows (fixed points of the guarded
    updates), so ``matvec_rows`` and ``precond_rows`` always see ``(ROWS,
    N)`` and each row has the bits of its single solve."""
    apply_pc = (precond_rows if callable(precond_rows)
                else (lambda r: precond_rows * r))
    return chunked(lambda c: _cg_rows(matvec_rows, c[:, 0], c[:, 1], apply_pc, iters),
                   torch.stack([b, x0], 1))
