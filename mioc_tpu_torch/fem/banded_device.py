"""Block-banded sparse operators: the gather-free SpMV of the large-mesh PDE
sweeps.

Counterpart of ``mioc_tpu.fem.banded_device``.  The host side is the JAX
package's numpy/scipy code:

1. reorder the dofs once with reverse Cuthill-McKee (:func:`rcm_permutation`):
   an FEM matrix then has bandwidth O(√N), a handful of 128-wide block
   diagonals (the heat mesh at 8321 dofs: 7);
2. pack the matrix into dense ``blocks (R, D, rb, cb)`` (:func:`pack_banded`):
   block row ``r`` holds the block at block column ``r + offsets[d]``;
3. rectangular operators (multigrid P and R) use ``cb = rb·Nc/Nr`` so the
   block slope stays 1, and coarse orderings follow the fine one
   (:func:`aligned_coarse_permutation`).

On the device the packing is laid out once, at build time, in the layout the
product reads (:func:`device_blocks`): ``(R, D'·cb, rb)``, the blocks
transposed and every offset of the contiguous range ``min … max`` present
(``D'``; zeros where the packing has no block).  A vector lives in a zero-
padded buffer (:class:`Layout`), so the D' column blocks that block row r
reads are one contiguous window of it and the windows of all block rows are
one strided view: the product is one ``torch.bmm`` of ``(R, rows, D'·cb)``
windows against the blocks, written into the output buffer in place.  No
operand is copied per application (the JAX package measured 578 against
~290 ms per sweep where its layout made XLA copy the 30 MB operator on every
application, ``mioc_tpu/fem/banded_device.py:140-146``).

Row bits.  cuBLAS (and the CPU BLAS) choose their algorithm by shape, so
every product here runs at one row width: :func:`banded_matvec_rows` feeds
its rows through in chunks of :data:`~mioc_tpu_torch.ops.rows.ROWS`, zero
rows appended, and :func:`banded_matvec` is a chunk of one row.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.rows import chunked

__all__ = ["BandedSpec", "Layout", "pack_banded", "rcm_permutation",
           "aligned_coarse_permutation", "device_blocks", "layout_for", "pad", "unpad",
           "banded_apply", "banded_matvec", "banded_matvec_rows"]


class BandedSpec(NamedTuple):
    """Static description of a block-banded packing."""

    nrows: int
    ncols: int
    rb: int          # row-block size
    cb: int          # col-block size
    offsets: tuple   # block-diagonal offsets d: block (r, r + d)
    R: int           # number of row blocks
    C: int           # number of col blocks


class Layout(NamedTuple):
    """A vector of ``n`` entries inside a zero buffer of ``total`` entries,
    starting at ``front``: every product that reads or writes it finds its
    window in range."""

    n: int
    front: int
    total: int


def rcm_permutation(mat) -> np.ndarray:
    """Reverse Cuthill-McKee ordering (perm[i] = old index at new position)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(sp.csr_matrix(mat),
                                            symmetric_mode=True))


def aligned_coarse_permutation(P_finerows_permuted) -> np.ndarray:
    """Order coarse dofs by the mean (already-permuted) fine-row index of
    their prolongation column — keeps P banded AND gives the coarse level a
    bandwidth-minimizing order consistent with the fine one."""
    coo = P_finerows_permuted.tocoo()
    Nc = P_finerows_permuted.shape[1]
    sums = np.zeros(Nc)
    cnts = np.zeros(Nc)
    np.add.at(sums, coo.col, coo.row)
    np.add.at(cnts, coo.col, 1)
    return np.argsort(sums / np.maximum(cnts, 1), kind="stable")


def pack_banded(mat, rb: int = 128, cb: int | None = None, dtype=np.float64):
    """Pack a (reordered) scipy sparse matrix into block-banded form.

    Returns ``(spec, blocks)`` with ``blocks`` a numpy ``(R, D, rb, cb)``
    array, the JAX package's packing (whose ``dtype`` defaults to float32;
    the port's to float64, its default everywhere).  ``cb`` defaults to
    ``rb`` scaled by the aspect ratio, rounded to a multiple of 8.
    """
    import scipy.sparse as sp

    coo = sp.coo_matrix(mat)
    coo.sum_duplicates()
    Nr, Nc = coo.shape
    if cb is None:
        cb = rb if Nc == Nr else max(8, int(round(rb * Nc / Nr / 8)) * 8)
    R = -(-Nr // rb)
    C = -(-Nc // cb)
    br = coo.row // rb
    bc = coo.col // cb
    offs = np.unique(bc - br)
    off_index = {int(d): k for k, d in enumerate(offs)}
    blocks = np.zeros((R, len(offs), rb, cb), dtype=dtype)
    k = np.fromiter((off_index[int(d)] for d in bc - br), dtype=np.int64,
                    count=len(bc))
    blocks[br, k, coo.row % rb, coo.col % cb] += coo.data
    spec = BandedSpec(Nr, Nc, rb, cb, tuple(int(d) for d in offs), R, C)
    return spec, blocks


def _extent(spec: BandedSpec):
    """``(lo, hi)``: block columns read before and after a block row's own."""
    return -min(spec.offsets), max(spec.offsets)


def device_blocks(spec: BandedSpec, blocks, *, device, dtype) -> torch.Tensor:
    """The packing in the layout :func:`banded_apply` reads: ``(R, D'·cb,
    rb)`` with ``D' = max(offsets) − min(offsets) + 1``, entry ``[r, d·cb +
    j, i]`` = ``blocks[r, offset min+d, i, j]`` (0 where there is none)."""
    lo, hi = _extent(spec)
    full = np.zeros((spec.R, lo + hi + 1, spec.rb, spec.cb), dtype=np.float64)
    for k, d in enumerate(spec.offsets):
        full[:, d + lo] = blocks[:, k]
    full = full.transpose(0, 1, 3, 2).reshape(spec.R, (lo + hi + 1) * spec.cb, spec.rb)
    return torch.as_tensor(np.ascontiguousarray(full), device=device).to(dtype)


def read_extent(spec: BandedSpec):
    """``(before, span)``: the entries a product with ``spec`` reads before
    its input vector's first entry, and the span of all its windows from
    there."""
    lo, hi = _extent(spec)
    return lo * spec.cb, (spec.R + lo + hi) * spec.cb


def layout_for(n: int, readers=(), writers=()) -> Layout:
    """The smallest :class:`Layout` of an ``n``-entry vector that the
    products ``readers`` (specs whose input it is) and ``writers`` (specs
    whose output it is) can all use in place."""
    front = max([read_extent(s)[0] for s in readers], default=0)
    total = max([front + n]
                + [front - before + span for before, span in map(read_extent, readers)]
                + [front + s.R * s.rb for s in writers])
    return Layout(n, front, total)


def pad(rows, layout: Layout, width: int | None = None):
    """``rows (..., n, layout.n)`` in a zero buffer ``(..., width, layout.total)``
    (``width`` defaults to n; rows past n are zero)."""
    X = rows.new_zeros(rows.shape[:-2] + (width or rows.shape[-2], layout.total))
    X[..., :rows.shape[-2], layout.front:layout.front + layout.n] = rows
    return X


def unpad(X, layout: Layout):
    """The entries of the vectors in ``X (..., layout.total)``."""
    return X[..., layout.front:layout.front + layout.n]


def banded_apply(spec: BandedSpec, blocks, X, src: Layout, dst: Layout):
    """``Y = X @ Aᵀ`` on padded buffers: ``X (w, src.total)`` holds w rows in
    layout ``src``; returns ``Y (w, dst.total)``, zero outside ``dst``'s
    entries.  One ``torch.bmm`` of strided windows of ``X`` against
    ``blocks`` (:func:`device_blocks`), written into ``Y`` in place."""
    lo, hi = _extent(spec)
    w = X.shape[0]
    width = (lo + hi + 1) * spec.cb
    start = src.front - lo * spec.cb
    if start < 0 or start + (spec.R - 1) * spec.cb + width > src.total:
        raise ValueError(f"layout {src} cannot hold the windows of {spec}")
    if dst.front + spec.R * spec.rb > dst.total:
        raise ValueError(f"layout {dst} cannot hold the rows of {spec}")
    X = X.contiguous()
    win = X.as_strided((spec.R, w, width), (spec.cb, src.total, 1),
                       X.storage_offset() + start)
    Y = X.new_zeros((w, dst.total))
    out = Y.as_strided((spec.R, w, spec.rb), (spec.rb, dst.total, 1), dst.front)
    torch.bmm(win, blocks, out=out)
    return Y


def _layouts(spec: BandedSpec):
    return layout_for(spec.ncols, readers=[spec]), layout_for(spec.nrows, writers=[spec])


def banded_matvec_rows(spec: BandedSpec, blocks, xs):
    """K-RHS form ``Y = xs @ Aᵀ``: ``xs (K, ncols) → (K, nrows)``, in chunks
    of ``ROWS`` rows (zero rows appended), so every product has one shape
    and each row the bits of its single application."""
    src, dst = _layouts(spec)
    return chunked(lambda rows: unpad(banded_apply(spec, blocks, pad(rows, src), src, dst), dst),
                   xs)


def banded_matvec(spec: BandedSpec, blocks, x):
    """``y = A @ x`` for block-banded ``A``: one row of
    :func:`banded_matvec_rows`."""
    return banded_matvec_rows(spec, blocks, x[None])[0]
