"""Random admissible starting controls.

Re-design of ``rand_func`` / ``rand_func_cont`` / ``rand_func_int``
(``HelpFunctions.jl:136-225``).  Default randomness uses
numpy ``default_rng``; pass ``julia_stream=True`` to draw from a bit-exact
replica of the reference's seeded ``MersenneTwister`` stream
(``utils/julia_rng.py`` — golden-verified dSFMT-19937), which reproduces the
reference's random integer starts bit-for-bit and its continuous starts up
to convolution rounding.  Arrays are time-major ``(nt, nx)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .julia_rng import JuliaMersenneTwister

__all__ = ["rand_func", "rand_func_cont", "rand_func_int"]


def rand_func(obj, *, seed: Optional[int] = None, jumps: Optional[int] = None,
              sigma: float = 100.0, julia_stream: bool = False) -> np.ndarray:
    """Random admissible control: Gaussian-smoothed noise for the continuous
    block, random piecewise-constant admissible levels for the integer block
    (``HelpFunctions.jl:136-148``).

    With ``julia_stream=True``, ``seed`` is interpreted as the reference's
    ``rng`` argument and each block replicates the reference's draws from a
    fresh ``MersenneTwister(seed)`` (the reference re-seeds per block with
    the same value, ``HelpFunctions.jl:141-146``)."""
    if julia_stream:
        if seed is None:
            raise ValueError("julia_stream=True requires an explicit seed")
        x0 = np.zeros((obj.nt, obj.nx))
        if obj.nu > 0:
            x0[:, : obj.nu] = rand_func_cont(obj, seed=seed, sigma=sigma,
                                             julia_stream=True)
        if obj.nv > 0:
            x0[:, obj.nu :] = rand_func_int(obj, seed=seed, jumps=jumps,
                                            julia_stream=True)
        return x0
    rng = np.random.default_rng(seed)
    x0 = np.zeros((obj.nt, obj.nx))
    if obj.nu > 0:
        x0[:, : obj.nu] = rand_func_cont(obj, rng=rng, sigma=sigma)
    if obj.nv > 0:
        x0[:, obj.nu :] = rand_func_int(obj, rng=rng, jumps=jumps)
    return x0


def rand_func_cont(obj, *, seed=None, rng=None, sigma: float = 100.0,
                   julia_stream: bool = False) -> np.ndarray:
    """Admissible continuous control from Gaussian-convolved noise, normalized
    into ``[umin, umax]`` and clipped pointwise (``HelpFunctions.jl:158-193``).

    Requires ``obj.umin``/``obj.umax`` of shape ``(nt, nu)``.

    With ``julia_stream=True`` the noise ``ξ`` is bit-identical to the
    reference's ``randn(MersenneTwister(seed), Float64, (nu, nt))``
    (column-major fill through MersenneTwister's bulk array path); the
    smoothed control then matches the reference up to convolution rounding
    (the reference's ``DSP.conv`` is FFT-based).
    """
    nt, nu = obj.nt, obj.nu
    umin = np.broadcast_to(np.asarray(obj.umin, float), (nt, nu))
    umax = np.broadcast_to(np.asarray(obj.umax, float), (nt, nu))

    if julia_stream:
        if seed is None:
            raise ValueError("julia_stream=True requires an explicit seed")
        r = JuliaMersenneTwister(seed)
        # Julia fills the (nu, nt) matrix column-major: element (i, j) sits
        # at linear index (j-1)*nu + i.
        xi = r.randn_array(nu * nt).reshape(nt, nu).T
    else:
        rng = rng if rng is not None else np.random.default_rng(seed)
        xi = rng.standard_normal((nu, nt))
    i = np.arange(1, nt + 1)
    kernel = np.exp(-((i - nt / 2.0) ** 2) / (2.0 * sigma**2))
    kernel /= kernel.sum()

    u0 = np.empty((nu, nt))
    for j in range(nu):
        full = np.convolve(xi[j], kernel)
        start = (len(full) - nt) // 2
        u0[j] = full[start : start + nt]

    lo = umin.min(axis=0)  # (nu,)
    hi = umax.max(axis=0)
    span = u0.max(axis=1, keepdims=True) - u0.min(axis=1, keepdims=True)
    # Degenerate smoothing (large sigma / tiny nt) can flatten a row to a
    # constant; normalize those to the bound-interval midpoint instead of 0/0.
    flat = span <= 0.0
    norm = (u0 - u0.min(axis=1, keepdims=True)) / np.where(flat, 1.0, span)
    norm = np.where(flat, 0.5, norm)
    u0 = lo[:, None] + (hi - lo)[:, None] * norm
    return np.clip(u0.T, umin, umax)


def rand_func_int(obj, *, seed=None, rng=None, jumps: Optional[int] = None,
                  julia_stream: bool = False) -> np.ndarray:
    """Random piecewise-constant admissible integer control with ``jumps``
    uniformly-drawn switch times (``HelpFunctions.jl:204-225``).

    With ``julia_stream=True`` the result is bit-identical to the
    reference's ``rand_func_int(obj; rng=seed, jumps=jumps)``: ordered
    switch times via StatsBase's Algorithm-A sampler, then ``jumps+1``
    admissible combinations drawn lazily in the reference's order (one
    before the loop, one at each boundary crossing) — the combination
    index sampler and our level enumeration both follow Julia's
    column-major ``collect(obj.iterator)`` order."""
    nt = obj.nt
    if jumps is None:
        jumps = nt // 10
    adm = obj.admissible
    if julia_stream:
        if seed is None:
            raise ValueError("julia_stream=True requires an explicit seed")
        r = JuliaMersenneTwister(seed)
        # Julia samples switch times from 2:nt (1-based step indices).
        t = np.asarray(r.sample_ordered(range(2, nt + 1), jumps), dtype=int)
        seg_combos = np.asarray([r.rand_index(adm.L) for _ in range(jumps + 1)])
        # Step i (1-based) belongs to segment #(boundaries ≤ i).
        seg_of_step = np.searchsorted(t, np.arange(1, nt + 1), side="right")
        return adm.levels[seg_combos[seg_of_step]]
    rng = rng if rng is not None else np.random.default_rng(seed)
    # Switch boundaries: Julia samples from 2…nt (1-based), i.e. 1…nt-1 here.
    t = np.sort(rng.choice(np.arange(1, nt), size=jumps, replace=False))
    seg_combos = rng.integers(0, adm.L, size=jumps + 1)
    seg_of_step = np.searchsorted(t, np.arange(nt), side="right")
    return adm.levels[seg_combos[seg_of_step]]
