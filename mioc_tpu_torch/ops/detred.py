"""Batch-invariant reductions: balanced fold trees.

Counterpart of ``mioc_tpu.ops.detred``.  Every reduction is the fixed
pairwise fold of :func:`~mioc_tpu_torch.ops.tv.fold_sum` (pad the axis with
``+0.0`` to a power of two, halve by elementwise adds), the tree the JAX
package builds, so a row's bits depend on that row alone and never on the
batch shape in front of it, on the CPU and on the card.
"""

from __future__ import annotations

import torch

from .tv import fold_sum

__all__ = ["detsum", "detsum_all", "detdot", "detmatvec"]


def detsum(x, axis: int = -1):
    """Sum along ``axis`` by the fold tree of :func:`fold_sum`; the tree
    depends only on the axis length."""
    return fold_sum(torch.movedim(torch.as_tensor(x), axis, -1))


def detsum_all(x):
    """Full reduction with a fixed tree: flatten, then :func:`detsum`."""
    return fold_sum(torch.as_tensor(x).reshape(-1))


def detdot(a, b):
    """Batch-stable inner product of two vectors (the last axes)."""
    return fold_sum(a * b)


def detmatvec(A, x):
    """Batch-stable dense matvec ``A @ x``: row-wise products and the fold
    tree.  ``A (N, M)``, ``x (..., M)`` → ``(..., N)``."""
    return fold_sum(A * x[..., None, :])
