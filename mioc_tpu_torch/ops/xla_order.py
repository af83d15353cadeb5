"""Arithmetic in the order the JAX package's compiled CPU code takes.

XLA's CPU backend contracts a multiply feeding an add into one fused
multiply-add (``fma(a, b, c) = RN(a·b + c)``, one rounding), and splits a
long sum into windows of 32.  A port that rounds each product apart, or sums
in another order, differs from the JAX package in the last bits, which is
harmless for most solves but not for one that amplifies rounding: the mixed
solver's projected-gradient steps turn a one-ulp difference in f or ∇f into
different iterates within a few rounds.  So a model that must give the JAX
package's iterates bit for bit computes its sweeps with these helpers:

* :func:`fma`: the correctly rounded ``a·b + c``, on any device.  PyTorch has
  no fused multiply-add operator; ``torch.addcmul(c, a, b)`` compiles to one
  on the CPU builds and on CUDA (the compilers contract ``c + a·b``), but
  nothing promises it.  :func:`addcmul_fuses` checks it once per device on
  inputs where the fused and the unfused results differ, against
  :func:`fma_exact`, an error-free emulation (Dekker's product, Knuth's
  two-sum and a sum rounded to odd, Boldo and Melquiond 2008) that is exact
  on any device, with about 35 elementwise operations.  :func:`fma` takes
  ``addcmul`` where the check passed, else the emulation: the same bits
  either way.
* :func:`const_dot`: a dot with a small constant vector written as
  ``c₀u₀ + c₁u₁ + …``, which XLA contracts as ``fma(c₂, u₂, fma(c₀, u₀,
  c₁u₁))`` and on (a coefficient ±1 is no product there: ``u₀ − u₁·…``
  contracts the next product instead);
* :func:`sqrt`: the correctly rounded square root, as XLA's CPU code and
  CUDA compute it.  PyTorch's CPU ``torch.sqrt`` of float64 is not: it
  takes MKL's vector math, which misses the nearest double for ~0.7% of
  inputs (``sqrt(2.0)`` among them).  :func:`sqrt_rounds` checks each device
  once; where it fails, :func:`sqrt` corrects ``torch.sqrt`` by one ulp with
  Tuckerman's test in exact fused multiply-adds.
* :func:`vdot`: XLA's dot of two vectors (``jnp.vdot``), a fused
  multiply-add chain from 0 in index order, read back as a Python float
  (held against the JAX package's for lengths 37 … 5000; shorter dots are
  unrolled and associated otherwise);
* :func:`window_sum`: XLA's tree reduction of the last axis: while it is
  longer than 32 it is padded with zeros to a multiple of 32 (half the pad in
  front, rounded down), each window of 32 is summed from 0 in order, and the
  window sums are reduced the same way; the last ≤ 32 values are summed in
  order.

All work on tensors of any batch shape, row by row.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fma", "fma_exact", "addcmul_fuses", "window_sum", "const_dot", "vdot",
           "sqrt", "sqrt_rounds"]

_SPLIT = 134217729.0  # 2**27 + 1: Veltkamp's splitting constant for float64


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma_exact(a, b, c):
    """``RN(a·b + c)`` for float64 tensors (broadcast), by error-free
    transformations and a sum rounded to odd; exact on any device barring
    overflow of ``a·2^27`` and underflow of the product's error term."""
    a, b, c = torch.broadcast_tensors(*(torch.as_tensor(v, dtype=torch.float64)
                                        if not isinstance(v, torch.Tensor) else v
                                        for v in (a, b, c)))
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = al * bl - (((p - ah * bh) - al * bh) - ah * bl)  # a·b = p + e exactly
    th, tl = _two_sum(c, p)
    v, w = _two_sum(tl, e)
    # v rounded to odd: if v + w is inexact and v's last bit is even, step to
    # the odd neighbour on w's side.
    even = (v.view(torch.int64) & 1) == 0
    odd = torch.nextafter(v, torch.copysign(torch.full_like(v, torch.inf), w))
    v = torch.where((w != 0) & even, odd, v)
    return th + v


def _probe_inputs():
    """Float64 triples where ``RN(a·b + c)`` differs from ``RN(RN(a·b) + c)``."""
    rng = np.random.default_rng(20260917)
    a = rng.normal(size=4096)
    b = rng.normal(size=4096) * 1e-2
    c = rng.normal(size=4096)
    return a, b, c


_FUSES: dict = {}


def addcmul_fuses(device) -> bool:
    """Whether ``torch.addcmul(c, a, b)`` is a fused multiply-add on
    ``device`` (checked once per device against :func:`fma_exact`, on a
    contiguous run, a strided view and a 0-d operand, where fusing changes
    the result)."""
    dev = torch.device(device)
    key = (dev.type, dev.index)
    if key not in _FUSES:
        a, b, c = (torch.as_tensor(v, device=dev) for v in _probe_inputs())
        want = fma_exact(a, b, c)
        differs = bool((want != c + a * b).any())
        ok = differs and torch.equal(torch.addcmul(c, a, b), want)
        ok = ok and torch.equal(torch.addcmul(c[::2], a[::2], b[::2]), want[::2])
        s = b[7]
        ok = ok and torch.equal(torch.addcmul(c, a, s), fma_exact(a, s, c))
        _FUSES[key] = bool(ok)
    return _FUSES[key]


def fma(a, b, c):
    """``RN(a·b + c)`` elementwise (tensors on one device, ``b`` may be a 0-d
    tensor): for float64 ``torch.addcmul`` where :func:`addcmul_fuses`, else
    :func:`fma_exact`; for float32 the float64 sum ``a·b + c`` (the product
    is exact there) rounded to float32."""
    if c.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    if addcmul_fuses(c.device):
        return torch.addcmul(c, a, b)
    return fma_exact(a, b, c)


def window_sum(x, window: int = 32):
    """Sum over the last axis in XLA's CPU order (see the module docstring)."""
    while x.shape[-1] > window:
        n = x.shape[-1]
        pad = -n % window
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-1], -1, window)
        acc = torch.zeros_like(x[..., 0])
        for j in range(window):
            acc = acc + x[..., j]
        x = acc
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def const_dot(u, v):
    """``Σ_m v_m·u[..., m]`` for a constant vector ``v`` (Python floats),
    rounded as XLA's CPU code rounds the JAX package's unrolled
    ``0 + v₀u₀ + v₁u₁ + …``: ``acc = fma(v₀, u₀, v₁u₁)``, then ``acc =
    fma(v_m, u_m, acc)`` for m ≥ 2 (a single term is one product).  A
    coefficient ±1 multiplies nothing there (``1·u → u``, ``−1·u → −u``), so
    its term is added as it stands and the product beside it is the one
    fused: ``−u₀ + 0.75u₁`` is ``fma(0.75, u₁, −u₀)``."""
    v = [float(c) for c in np.asarray(v).ravel()]

    def term(m):  # (factor or None, operand)
        if abs(v[m]) == 1.0:
            return None, u[..., m] if v[m] > 0 else -u[..., m]
        return torch.tensor(v[m], dtype=u.dtype, device=u.device), u[..., m]

    def rounded(t):
        return t[1] if t[0] is None else t[0] * t[1]

    if len(v) == 1:
        return rounded(term(0)) if abs(v[0]) == 1.0 else v[0] * u[..., 0]
    t0, t1 = term(0), term(1)
    if t0[0] is not None:
        acc = fma(t0[1], t0[0], rounded(t1))
    elif t1[0] is not None:
        acc = fma(t1[1], t1[0], t0[1])
    else:
        acc = t0[1] + t1[1]
    for m in range(2, len(v)):
        c, x = term(m)
        acc = acc + x if c is None else fma(x, c, acc)
    return acc


def _sqrt_tuckerman(x):
    """``torch.sqrt(x)`` moved to the nearest double: ``s`` is ``RN(√x)``
    iff ``s·s⁻ < x ≤ s·s⁺`` (Tuckerman's test, ``s⁻``/``s⁺`` the neighbours
    of ``s``), with the products compared exactly by :func:`fma`."""
    s = torch.sqrt(x)
    lo = torch.nextafter(s, torch.zeros_like(s))
    hi = torch.nextafter(s, torch.full_like(s, torch.inf))
    below = (fma(s, lo, -x) >= 0) & (s > 0)  # x ≤ s·s⁻: s is one ulp too large
    above = fma(s, hi, -x) < 0  # x > s·s⁺: s is one ulp too small
    return torch.where(below, lo, torch.where(above, hi, s))


def _sqrt_probe():
    rng = np.random.default_rng(20261017)
    x = np.concatenate([[2.0, 3.0, 0.5, 1e-300, 1e300], rng.random(65536) * 4.0,
                        np.exp(rng.normal(size=8192) * 50)])
    return x, np.sqrt(x)  # numpy's is the hardware's: correctly rounded


_SQRT_RN: dict = {}


def sqrt_rounds(device) -> bool:
    """Whether ``torch.sqrt`` of float64 is correctly rounded on ``device``
    (checked once per device against numpy's on inputs where MKL's is
    not)."""
    dev = torch.device(device)
    key = (dev.type, dev.index)
    if key not in _SQRT_RN:
        x, want = _sqrt_probe()
        got = torch.sqrt(torch.as_tensor(x, device=dev)).cpu().numpy()
        _SQRT_RN[key] = bool(np.array_equal(got, want))
    return _SQRT_RN[key]


def sqrt(x):
    """``RN(√x)`` elementwise: ``torch.sqrt`` where :func:`sqrt_rounds`,
    else ``torch.sqrt`` corrected by Tuckerman's test (exact on any device
    for inputs in the normal range; the same bits either way).  float32
    takes ``torch.sqrt``."""
    if x.dtype != torch.float64 or sqrt_rounds(x.device):
        return torch.sqrt(x)
    return _sqrt_tuckerman(x)


def vdot(a, b) -> float:
    """``Σ a_i·b_i`` over the flattened tensors as ``acc = fma(a_i, b_i,
    acc)`` from ``acc = 0``, in index order, on the host (the value is read
    back anyway, and the chain is one dependent operation per element)."""
    a = a.detach().reshape(-1).to("cpu", torch.float64)
    b = b.detach().reshape(-1).to("cpu", torch.float64)
    acc = torch.zeros((), dtype=torch.float64)
    for ai, bi in zip(a, b):
        acc = fma(ai, bi, acc)
    return float(acc)
