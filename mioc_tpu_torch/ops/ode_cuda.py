"""Wrappers of the Lotka–Volterra sweep kernels (``csrc/ode_lvm.cu``).

* :func:`lvm_forward` — the forward Euler sweep and its trapezoid cost, one
  thread per row;
* :func:`lvm_adjoint` — the discrete adjoint and the gradient rows, one
  thread per row.

They replace no TPU kernel: they are the card's path of
:class:`~mioc_tpu_torch.models.fishing.LVMObj`'s ``_forward_batch`` and
``_adjoint_batch``, one launch a sweep, with the bits of the plain PyTorch
sweeps (``_forward_batch_torch``, ``_adjoint_batch_torch``) in float64
and in float32 alike.  The host side lives here: :func:`window_plan` gives
the kernel the order of :func:`~mioc_tpu_torch.ops.xla_order.window_sum`,
and :func:`rule_table` the adjoint scan's rule letters.  Each wrapper takes
CUDA tensors of one dtype, float64 or float32, and launches that dtype's
instance of the kernel: it checks device, dtype, shape and layout,
allocates the outputs with ``torch.empty`` and launches through
:mod:`._kernels`, which takes the current stream, raises if the launch
failed and counts the launch in the wrapper's ``launches`` attribute.
"""

from __future__ import annotations

import torch

from . import _kernels
from ._kernels import D, I, P

__all__ = ["lvm_forward", "lvm_adjoint", "window_plan", "rule_table", "WINDOW",
           "MAX_LEVELS", "COLUMNS"]

WINDOW = 32  # xla_order.window_sum's window
MAX_LEVELS = 4  # levels of windows the kernel streams (csrc/ode_lvm.cu kMaxLevels)
COLUMNS = 3  # control columns of a gradient row: the three fishing modes (kM)
RULES = "45"  # the adjoint's rule letters (models/fishing.py::_ADJ)
RULE_ALIGN = 16  # bytes of rule letters the adjoint kernel copies at once (kChunk)

# The C entries' argument types (csrc/ode_lvm.cu, mioc_lvm_{forward,adjoint}_{f64,f32}),
# the stream last.
_FORWARD_ARGS = (P,) * 4 + (I,) * 2 + (D,) * 5 + (I,) * (1 + MAX_LEVELS) + (P,)
_ADJOINT_ARGS = (P,) * 8 + (I,) * 2 + (D,) * 8 + (P,)
_KERNELS = "the LVM sweep kernels"


def window_plan(n: int) -> tuple:
    """The leading pad of each level of windows that
    :func:`~mioc_tpu_torch.ops.xla_order.window_sum` makes of ``n`` values,
    in order: while a level is longer than :data:`WINDOW` it is padded to a
    multiple of it with half the pad in front (rounded down), and its window
    sums are the next level; the last (≤ 32 values) is summed in order.
    The pads are zeros and add nothing, so the kernel only starts a level's
    count that far into its first window."""
    offs = []
    while n > WINDOW:
        pad = -n % WINDOW
        offs.append(pad // 2)
        n = (n + pad) // WINDOW
    return tuple(offs)


def rule_table(rules: str, device) -> torch.Tensor:
    """The adjoint scan's rule letters (``'4'`` or ``'5'``, one a step in
    scan order, :meth:`~mioc_tpu_torch.objectives.ode.ODEObjective.adjoint_rules`)
    as a uint8 tensor of their character codes on ``device``, whose storage
    runs on to a multiple of :data:`RULE_ALIGN` bytes (the kernel copies the
    letters of :data:`RULE_ALIGN` steps at once)."""
    if set(rules) - set(RULES):
        raise ValueError(f"rule letters must be in {RULES!r}, got {sorted(set(rules))}")
    padded = rules.encode() + RULES[0].encode() * (-len(rules) % RULE_ALIGN)
    return torch.tensor(list(padded), dtype=torch.uint8, device=device)[:len(rules)]


def _check_rules(rules, nt, device):
    """The adjoint kernel copies :data:`RULE_ALIGN` letters at once: the
    table must be uint8 ``(nt - 1,)`` on ``device``, aligned, with its
    storage padded as :func:`rule_table` pads it."""
    n = nt - 1
    if rules.dtype != torch.uint8 or tuple(rules.shape) != (n,) or rules.device != device:
        raise ValueError(f"rules: {rules.dtype} {tuple(rules.shape)} on {rules.device}, "
                         f"expected uint8 ({n},) on {device}")
    room = rules.untyped_storage().nbytes() - rules.storage_offset()
    if rules.data_ptr() % RULE_ALIGN or room < n + -n % RULE_ALIGN:
        raise ValueError(f"rules must be {RULE_ALIGN}-byte aligned with storage to a multiple "
                         f"of {RULE_ALIGN} bytes (ode_cuda.rule_table makes them so)")


def _check(name, t, shape, dtype):
    """Device, dtype and shape of one argument; the wrappers make it
    contiguous themselves."""
    _kernels.check(name, t, dtype, shape, contiguous=False, kernels=_KERNELS)


def _dense(name, t):
    """``t`` contiguous; it must be aligned to a pair of its elements (the
    kernels read (y₀, y₁) and (a, c) as one double2 or float2)."""
    t = t.contiguous()
    if t.data_ptr() % (2 * t.element_size()):
        raise ValueError(f"{name} must be {2 * t.element_size()}-byte aligned")
    return t


def lvm_forward(A, state0, alpha, beta, gamma, delta, tau):
    """The forward sweep of every row: ``A (nt, S, 2)`` the couplings ``(a,
    c)`` of each step, time-major, and ``state0 (2,)``, float64 or float32
    on the card.  Returns ``(f (S,), ys (nt, S, 2))`` in that dtype with
    ``ys[k, s] = y_{k+1}`` of row ``s``, as ``LVMObj._forward_batch_torch``
    does, bit for bit."""
    nt, S = A.shape[:2]
    sfx, dtype = _kernels.suffix(A, _KERNELS), A.dtype
    _check("A", A, (nt, S, 2), dtype)
    _check("state0", state0, (2,), dtype)
    if nt < 1 or S < 1:
        raise ValueError(f"the forward sweep takes nt ≥ 1 and S ≥ 1 rows, got {(nt, S)}")
    offs = window_plan(nt + 1)
    if len(offs) > MAX_LEVELS:
        raise ValueError(f"nt={nt}: more than {MAX_LEVELS} levels of windows")
    A, state0 = _dense("A", A), state0.contiguous()
    ys = torch.empty_like(A)
    f = torch.empty(S, dtype=dtype, device=A.device)
    _kernels.launch(lvm_forward, "lvm_forward",
                    ("ode_lvm", f"mioc_lvm_forward_{sfx}", _FORWARD_ARGS), A.device,
                    A.data_ptr(), state0.data_ptr(), ys.data_ptr(), f.data_ptr(), nt, S, alpha,
                    -beta, -gamma, delta, tau, len(offs),
                    *(offs + (0,) * (MAX_LEVELS - len(offs))))
    return f, ys


lvm_forward.launches = 0


def lvm_adjoint(A, ys, rules, state0, v1, v2, alpha, beta, gamma, delta, c1, c2, tau):
    """The adjoint sweep of every row and its gradient: ``A, ys (nt, S, 2)``
    time-major, ``rules`` the uint8 table of :func:`rule_table` (``nt − 1``
    letters), ``state0 (2,)``, ``v1, v2 (3,)``, float64 or float32 on the
    card.  Returns ``(df (S, nt, 3), lam (S, nt, 2))`` in that dtype, as
    ``LVMObj._adjoint_batch_torch`` does, bit for bit."""
    nt, S = A.shape[:2]
    sfx, dtype = _kernels.suffix(A, _KERNELS), A.dtype
    _check("A", A, (nt, S, 2), dtype)
    _check("ys", ys, (nt, S, 2), dtype)
    _check("state0", state0, (2,), dtype)
    _check("v1", v1, (COLUMNS,), dtype)
    _check("v2", v2, (COLUMNS,), dtype)
    if nt < 1 or S < 1:
        raise ValueError(f"the adjoint sweep takes nt ≥ 1 and S ≥ 1 rows, got {(nt, S)}")
    _check_rules(rules, nt, A.device)
    A, ys = _dense("A", A), _dense("ys", ys)
    state0, v1, v2 = state0.contiguous(), v1.contiguous(), v2.contiguous()
    lam = torch.empty((S, nt, 2), dtype=dtype, device=A.device)
    df = torch.empty((S, nt, COLUMNS), dtype=dtype, device=A.device)
    _kernels.launch(lvm_adjoint, "lvm_adjoint",
                    ("ode_lvm", f"mioc_lvm_adjoint_{sfx}", _ADJOINT_ARGS), A.device,
                    A.data_ptr(), ys.data_ptr(), rules.data_ptr(), state0.data_ptr(),
                    v1.data_ptr(), v2.data_ptr(), lam.data_ptr(), df.data_ptr(), nt, S, alpha,
                    -beta, -gamma, delta, tau, -0.5 * tau, c1, c2)
    return df, lam


lvm_adjoint.launches = 0
