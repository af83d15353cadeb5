"""Temporal (sequence-axis) parallelization of the Bellman DP — banded form.

Counterpart of ``mioc_tpu.parallel.temporal`` (one device).  The backward
value recursion is a chain of min-plus (tropical) linear operators over the
state ``s = (budget b, combination l)``:

    Φ_i = T_i ⊗ Φ_{i+1},    (T ⊗ v)[s] = min_{s'} T[s, s'] + v[s']

and ⊗ is associative, so the sweep splits over time.  A composition of steps
depends only on ``(l, d, j)`` with ``d = b − b'`` the budget spent (budget
shift invariance), and a composition of ``K`` steps spends at most
``min(B, K·smax)`` (bandedness), so a chunk operator is a small ``(L, W, L)``
band, ``W = min(B, K·smax) + 1``.

Two-level schedule, ``K = ⌈√(nt−1)⌉`` steps per chunk (capped at ``nt−1``)
and ``C`` chunks, identity steps padded in front:

1. chunk operators ``G_c[l, d, j]``, each a ``K``-step fold, all chunks at
   once along a leading chunk axis (the JAX package's ``vmap``);
2. boundary sweep: ``C`` sequential banded op ⊗ vector applications from the
   terminal layer;
3. interior recovery, all chunks at once again: the suffix value tables
   ``phis (nt, B+1, L)``.

This is tensor code on the tables' device, not a kernel: the JAX version is
XLA, not Pallas.  Every value is an add of two numbers or a min, in the JAX
package's composition order (in :func:`_chunk_op` the running min over
``m``, then the shift, then ``stage_i + …``; in :func:`_apply_op` the min
over ``j`` and then over ``d``), so at float64 the tables equal the JAX
package's bit for bit, on the CPU and on the card.
:func:`temporal_tables_sharded` partitions the chunk axis over a mesh axis:
each rank composes and recovers only its own chunks, the small operator
band and the recovered tables are all-gathered, so every rank returns the
same tables, bit-equal to :func:`temporal_tables`'.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.bellman import max_budget_use, stage_tables

__all__ = ["temporal_tables", "temporal_tables_sharded", "temporal_backtrack",
           "temporal_dp_solve"]


def _shift_d(arr, shifts, smax: int, axis: int):
    """``out[..., d, ...] = arr[..., d − shift, ...]``, +inf where ``d <
    shift`` or ``shift > smax``; ``shifts`` broadcasts against ``arr`` with
    the shifted axis of size 1.  A gather: data movement only."""
    W = arr.shape[axis]
    shape = [1] * arr.ndim
    shape[axis] = W
    d = torch.arange(W, device=arr.device).reshape(shape)
    src = (d - shifts).expand(arr.shape)
    ok = (src >= 0) & (shifts <= smax)
    inf = torch.tensor(math.inf, dtype=arr.dtype, device=arr.device)
    return torch.where(ok, torch.gather(arr, axis, src.clamp(min=0)), inf)


def _identity_op(C: int, L: int, W: int, dtype, device):
    """``C`` banded identity operators: 0 on (l = j, d = 0), +inf elsewhere."""
    G = torch.full((C, L, W, L), math.inf, dtype=dtype, device=device)
    idx = torch.arange(L, device=device)
    G[:, idx, 0, idx] = 0.0
    return G


def _chunk_op(st, bt, ok, jump, smax: int, W: int):
    """Compose every chunk's ``K`` per-step operators into a banded ``G[c, l,
    d, j]``: ``st``/``bt`` ``(C, K, L)``, ``ok (C, K)``; a sequential fold
    over the steps, last step first, with the chunks along the leading axis."""
    C, K, L = st.shape
    G = _identity_op(C, L, W, st.dtype, st.device)
    for k in range(K - 1, -1, -1):
        # tmp[c, l, d, j] = min_m jump[l, m] + G[c, m, d, j]  (running min over m).
        acc = jump[None, :, 0, None, None] + G[:, 0][:, None]
        for m in range(1, L):
            acc = torch.minimum(acc, jump[None, :, m, None, None] + G[:, m][:, None])
        out = _shift_d(acc, bt[:, k][:, :, None, None], smax, axis=2)
        out = st[:, k][:, :, None, None] + out
        G = torch.where(ok[:, k][:, None, None, None], out, G)
    return G


def _apply_op(G, phi, W: int, b_ax):
    """Banded op ⊗ vector: ``out[b, l] = min_{d ≤ b, j} G[l, d, j] + phi[b − d, j]``."""
    L = G.shape[0]
    phipad = torch.cat([torch.full((W - 1, L), math.inf, dtype=phi.dtype,
                                   device=phi.device), phi])
    idx = (W - 1) + b_ax[None, :] - torch.arange(W, device=phi.device)[:, None]  # (W, B+1)
    windows = phipad[idx]  # (W, B+1, L)
    acc = None
    for j in range(L):
        term = G[:, :, j][:, :, None] + windows[:, :, j][None]  # (L, W, B+1)
        acc = term if acc is None else torch.minimum(acc, term)
    return acc.amin(dim=1).T  # (B+1, L)


def _recover(phi_end, st, bt, ok, jump, smax: int):
    """All interior suffix tables of every chunk from its end-boundary value:
    ``phi_end (C, B+1, L)`` give ``(C, K, B+1, L)``, Φ at the padded
    positions ``cK … (c+1)K − 1``."""
    C, K, L = st.shape
    phi = phi_end
    out = [None] * K
    for k in range(K - 1, -1, -1):
        tmp = torch.amin(jump[None, None, :, :] + phi[:, :, None, :], dim=3)  # (C, B+1, L)
        new = st[:, k][:, None, :] + _shift_d(tmp, bt[:, k][:, None, :], smax, axis=1)
        phi = torch.where(ok[:, k][:, None, None], new, phi)
        out[k] = phi
    return torch.stack(out, dim=1)


class _Chunks(NamedTuple):
    """The two-level schedule's operator data: ``st``/``bt`` ``(C, K, L)``,
    ``valid (C, K)`` (identity steps in front), the terminal layer ``phi_T
    (B+1, L)``, the band width ``W`` and the count ``pad`` of identity
    steps."""

    st: torch.Tensor
    bt: torch.Tensor
    valid: torch.Tensor
    phi_T: torch.Tensor
    jump: torch.Tensor
    b_ax: torch.Tensor
    smax: int
    W: int
    pad: int


def _chunks(stage, btilde, jump_cost, B: int, smax, chunk, D: int = 1):
    """Lay the steps out in ``C`` chunks of ``K`` (``C`` rounded up to a
    multiple of ``D``); ``None`` when there is no step (``nt = 1``), where
    the tables are ``phi_T[None]``."""
    nt, L = stage.shape
    if smax is None:
        smax = B
    smax = min(smax, B)
    ns = nt - 1
    K = chunk or max(1, int(math.ceil(math.sqrt(ns))))
    K = min(K, ns) if ns else 1
    C = -(-ns // K) if ns else 0
    C = -(-C // D) * D  # chunks divisible by the mesh axis
    pad = C * K - ns
    W = min(B, K * smax) + 1

    dtype, dev = stage.dtype, stage.device
    btilde = btilde.to(torch.int64)
    # Terminal layer Φ_{nt-1}[b, l] (exact-budget seed, HelpFunctions.jl:29-43).
    b_ax = torch.arange(B + 1, device=dev)
    inf = torch.tensor(math.inf, dtype=dtype, device=dev)
    phi_T = torch.where(b_ax[:, None] == btilde[-1][None, :], stage[-1][None, :], inf)
    # Padded per-step operator data; identity steps (valid=False) in front.
    st = torch.cat([torch.zeros((pad, L), dtype=dtype, device=dev), stage[:-1]])
    bt = torch.cat([torch.zeros((pad, L), dtype=torch.int64, device=dev), btilde[:-1]])
    valid = torch.cat([torch.zeros(pad, dtype=torch.bool, device=dev),
                       torch.ones(ns, dtype=torch.bool, device=dev)])
    return _Chunks(st.reshape(C, K, L), bt.reshape(C, K, L), valid.reshape(C, K), phi_T,
                   jump_cost.to(dtype), b_ax, smax, W, pad)


def _boundary(Gs, ch: _Chunks):
    """The boundary sweep, ``C`` sequential banded op ⊗ vector applications
    from the terminal layer: ``Psis_next[c]`` is Φ at the padded position
    ``(c+1)·K``, where chunk ``c``'s recovery starts (``Ψ_C = φ_T``)."""
    C = Gs.shape[0]
    Psis = [None] * C
    phi = ch.phi_T
    for c in range(C - 1, -1, -1):
        phi = _apply_op(Gs[c], phi, ch.W, ch.b_ax)
        Psis[c] = phi
    return torch.stack(Psis[1:] + [ch.phi_T])


def _assemble(interior, ch: _Chunks):
    """The suffix tables ``(nt, B+1, L)`` from the recovered chunks."""
    C, K, B1, L = interior.shape
    return torch.cat([interior.reshape(C * K, B1, L)[ch.pad:], ch.phi_T[None]])


def temporal_tables(stage, btilde, jump_cost, B: int, smax: int = None,
                    chunk: int = None):
    """All suffix value tables ``phis (nt, B+1, L)`` via the banded two-level
    temporal parallelization, on ``stage``'s device.  ``smax`` is the
    per-step budget-use bound (:func:`~mioc_tpu_torch.ops.bellman.max_budget_use`;
    defaults to ``B``); ``chunk`` is the chunk length ``K`` (default
    ``⌈√(nt−1)⌉``)."""
    ch = _chunks(stage, btilde, jump_cost, B, smax, chunk)
    if ch.st.shape[0] == 0:
        return ch.phi_T[None]
    # 1. chunk operators (all chunks at once).
    Gs = _chunk_op(ch.st, ch.bt, ch.valid, ch.jump, ch.smax, ch.W)  # (C, L, W, L)
    # 2. boundary sweep.
    Psis_next = _boundary(Gs, ch)
    # 3. interior recovery (all chunks at once).
    return _assemble(_recover(Psis_next, ch.st, ch.bt, ch.valid, ch.jump, ch.smax), ch)


def temporal_tables_sharded(stage, btilde, jump_cost, B: int, smax: int, mesh,
                            axis: str = "batch", chunk: int = None):
    """Time-axis (sequence-parallel) sharding of the banded temporal DP over
    the ranks of ``mesh``'s ``axis`` (every one of them must call it):

    * each rank composes the chunk operators of the chunks it owns (step 1,
      the dominant O(ns·L²·W) work, in parallel over the ranks);
    * the boundary sweep (step 2, the O(C) sequential critical path) runs
      replicated on an ``all_gather`` of the small ``(C, L, W, L)`` band;
    * each rank recovers only its own chunks (step 3), and a last
      ``all_gather`` gives every rank the whole tables.

    Returns the tables of :func:`temporal_tables`, bit for bit (the chunk
    count is rounded up to a multiple of the axis size with identity steps,
    which change no value), for :func:`temporal_backtrack` as they are."""
    D = mesh.shape[axis]
    ch = _chunks(stage, btilde, jump_cost, B, smax, chunk, D)
    C, K, L = ch.st.shape
    if C == 0:
        return ch.phi_T[None]
    Cd = C // D
    own = slice(mesh.coord(axis) * Cd, (mesh.coord(axis) + 1) * Cd)
    st, bt, ok = ch.st[own], ch.bt[own], ch.valid[own]
    Gs = mesh.all_gather(_chunk_op(st, bt, ok, ch.jump, ch.smax, ch.W), axis)
    Psis_next = _boundary(Gs.reshape(C, L, ch.W, L), ch)
    interior = _recover(Psis_next[own], st, bt, ok, ch.jump, ch.smax)
    return _assemble(mesh.all_gather(interior, axis).reshape(C, K, B + 1, L), ch)


def temporal_backtrack(phis, btilde, jump_cost, levels, B_new):
    """Path extraction from the suffix value tables, with the JAX package's
    tie-breaks: the seed is the first minimum of ``phis[0]`` masked to ``b ≤
    B_new`` with ``b`` fastest within ``l``, then each step takes the first
    minimal successor ``j`` of ``jump[l, j] + Φ_{i+1}[b − b̃_i[l], j]``.
    ``B_new`` is an int or a 0-d tensor, so trust-region halvings reuse the
    same ``phis``.  Returns ``(u (nt, M), level_idx (nt,) int32)``.  The
    chase is a loop over the steps in tensor ops on ``phis``' device, with
    no read back to the host; a budget below 0 (from an all-+inf seed)
    indexes as the JAX scan does (:func:`~mioc_tpu_torch.ops.bellman.budget_index`)."""
    nt, B1, L = phis.shape
    dev = phis.device
    b = torch.arange(B1, device=dev)
    cap = torch.as_tensor(B_new, device=dev)
    masked = torch.where(b[:, None] <= cap, phis[0], torch.tensor(math.inf, dtype=phis.dtype,
                                                                  device=dev))
    flat = torch.argmin(masked.T.reshape(-1))  # b fastest within l
    l, bb = flat // B1, flat % B1
    btilde = btilde.to(torch.int64)
    jump = jump_cost.to(phis.dtype)
    ls = [l]
    # The budget index of ops.bellman.budget_index: below 0 counts from the end.
    for i in range(nt - 1):
        bb = bb - btilde[i, l]
        b_idx = torch.where(bb < 0, bb + B1, bb).clamp(0, B1 - 1)
        l = torch.argmin(jump[l] + phis[i + 1, b_idx])
        ls.append(l)
    level_idx = torch.stack(ls).to(torch.int32)
    levels = torch.as_tensor(levels, dtype=phis.dtype, device=dev)
    return levels[level_idx.long()], level_idx


def temporal_dp_solve(grad, u_old, levels, jump_cost, tau, B: int, chunk: int = None):
    """Solve the trust-region subproblem via the banded temporal DP.

    Same semantics as :func:`mioc_tpu_torch.ops.bellman.dp_solve`; returns
    ``(u, level_idx, phis)`` with ``phis (nt, B+1, L)`` the suffix value
    tables (reusable by :func:`temporal_backtrack` at smaller budgets)."""
    levels_np = (levels.detach().cpu().numpy() if isinstance(levels, torch.Tensor)
                 else np.asarray(levels))
    smax = max_budget_use(levels_np)
    stage, btilde = stage_tables(grad, u_old, levels_np, tau)
    phis = temporal_tables(stage, btilde, jump_cost, B, smax, chunk)
    u, level_idx = temporal_backtrack(phis, btilde, jump_cost, levels_np, B)
    return u, level_idx, phis

