"""Matrix products whose rows have the same bits in every batch.

A library product (``torch.matmul``: cuBLAS on the card, the BLAS on the
CPU) picks its algorithm, and with it the split and order of each dot
product, by the shapes it is given.  The device TRM decides on rows of
batched evaluations (trial waves, starts) that must have the bits of the
single evaluation of that row.  So every product of an objective's rows runs
at ONE shape: :func:`chunked` feeds the rows through in chunks of exactly
``rows`` rows, the last chunk padded with zeros, and a single evaluation is
a padded chunk.  Within a chunk, a row's result does not depend on the other
rows (each output element is one dot product of one input row).
"""

from __future__ import annotations

import torch

__all__ = ["ROWS", "chunked"]

ROWS = 16  # rows per matrix product of the objectives' batched evaluations


def chunked(fn, X, rows: int = ROWS):
    """``fn`` over ``X (S, ...)`` in chunks of exactly ``rows`` rows (the last
    one zero-padded), so every call of ``fn`` has one shape; returns the S
    rows of the results, concatenated."""
    S = X.shape[0]
    out = []
    for s0 in range(0, S, rows):
        chunk = X[s0:s0 + rows]
        n = chunk.shape[0]
        if n < rows:
            chunk = torch.cat([chunk, chunk.new_zeros((rows - n, *chunk.shape[1:]))])
        out.append(fn(chunk.contiguous())[:n])
    return out[0] if len(out) == 1 else torch.cat(out)
