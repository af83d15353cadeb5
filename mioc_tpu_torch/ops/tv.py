"""Total-variation functional for piecewise-constant vector-valued controls.

Reference: ``TV_p`` at ``HelpFunctions.jl:251-273``; counterpart of
``mioc_tpu.ops.tv``.  Controls are time-major: ``u`` has shape ``(nt, M)``.

The row-wise forms (:func:`tv_rows`, :func:`iv_rows`) serve the device TRM,
whose decisions compare quantities of a single trial against the same
quantities of a batched trial wave.  Their sums are :func:`fold_sum`: a fixed
pairwise fold of elementwise adds, so each row's bits depend on that row
alone and never on how many rows the call holds.  A ``torch.sum`` over the
rows would not do: PyTorch's CUDA reduction chooses its split by the shape.
"""

from __future__ import annotations

import math

import torch

__all__ = ["tv_p", "tv_rows", "iv_rows", "fold_sum"]


def tv_p(u, p) -> torch.Tensor:
    """``TV_p(u) = Σ_i ‖u_i − u_{i−1}‖_p`` over the time axis, as a 0-d tensor
    on ``u``'s device.

    ``p = inf`` uses the honest per-jump max norm (the reference computes this
    correctly here, ``HelpFunctions.jl:255-258``, even though its DP jump cost
    for ``p = inf`` does not).  ``u is None`` (no integer control) returns 0
    like the ``Nothing`` overload (``HelpFunctions.jl:271-273``).
    """
    if u is None:
        return torch.tensor(0.0, dtype=torch.float64)
    p = _check_p(p)
    d = (u[1:] - u[:-1]).abs()  # (nt-1, M)
    if p == math.inf:
        return d.amax(dim=-1).sum()
    return ((d**p).sum(dim=-1) ** (1.0 / p)).sum()


def _check_p(p) -> float:
    p = float(p)
    if not (p > 0) and p != math.inf:
        raise ValueError("Only positive p (or inf) are accepted.")
    return p


def fold_sum(x):
    """Sum over the last axis by a fixed pairwise fold: the axis is padded
    with zeros to a power of two and halved by elementwise adds
    (``⌈log₂ n⌉`` small ops).  Row ``r`` of the result has the same bits for
    any batch shape in front of it, on the CPU and on the card."""
    n = x.shape[-1]
    if n == 0:
        return x.new_zeros(x.shape[:-1])
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def tv_rows(us, p):
    """Row-wise TV of a batch of controls ``us (..., nt, M) → (...)``; the
    counterpart of ``mioc_tpu.ops.tv._tv_rows``, summed with
    :func:`fold_sum`."""
    p = _check_p(p)
    d = (us[..., 1:, :] - us[..., :-1, :]).abs()  # (..., nt-1, M)
    if p == math.inf:
        per_jump = d.amax(dim=-1)
    else:
        per_jump = fold_sum(d**p) ** (1.0 / p)
    return fold_sum(per_jump)


def iv_rows(grad, u_old, us):
    """Row-wise inner products ``Σ grad·(u_old − us[k])``: ``grad`` and
    ``u_old`` are ``(..., nt, M)``, ``us`` is ``(..., K, nt, M)``, the result
    ``(..., K)``.  The counterpart of ``_iv_rows`` in
    ``mioc_tpu.solvers.trm_device``, summed with :func:`fold_sum`."""
    prod = grad.unsqueeze(-3) * (u_old.unsqueeze(-3) - us)  # (..., K, nt, M)
    return fold_sum(prod.flatten(-2))
