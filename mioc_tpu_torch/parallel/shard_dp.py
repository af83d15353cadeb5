"""Level-axis sharding of the Bellman contraction (tensor-parallel DP).

Counterpart of ``mioc_tpu.parallel.shard_dp``.  Each backward step of the DP
is a min-plus contraction over the successor axis ``j``, O(L²·B) work.  The
``level`` axis of a :class:`~.device_mesh.Mesh` partitions ``j``: rank ``d``
owns the ``jump_cost`` columns and the Φ rows ``j ∈ [d·Ld, (d+1)·Ld)``,
computes its local ``(min, argmin)`` over them, and the full reduction is an
``all_gather`` of the ``D`` partial pairs and a min over the shards.

``L`` not divisible by the level-axis size is handled by inert padding (+inf
stage and jump, budget use ``B+1``): a padded row's Φ is +inf at every
budget and its budget use puts every chase budget below 0, so no chase
selects it, and the padded tables go unchanged to the chases
(:func:`~mioc_tpu_torch.ops.bellman.backtrack` and its batched and
trial-wave forms, with the padded ``btilde``).

Tie-breaking is the unsharded build's (first minimal global ``j``): the
partial argmins carry global ``j`` and the combine takes the first minimal
shard (``torch.argmin`` returns the first).  Every value is one add or a
min, in the unsharded build's order (``stage + shifted value``), so the
tables equal :func:`~mioc_tpu_torch.ops.bellman.build_tables`' bit for bit,
on the CPU and on the card, non-finite stages (a diverged sweep's gradient)
included; with finite stages they are the JAX body's too.

This is tensor code on the tables' device, not a kernel: the JAX body is
XLA, not Pallas.  A build makes ``nt−1`` collectives, one per step (the
value and index planes packed into one tensor: an index below 2²⁴ is exact
in either float type).  ``U`` takes the port's element type
(:func:`~mioc_tpu_torch.ops.bellman.u_dtype` of the padded ``Lp``; the JAX
package's is int32), so the chase kernels take the padded tables as they
are.  A leading start axis ``(S, nt, Lp)`` is allowed: the S starts of a
device loop share one collective per step (the JAX package gets this by
``vmap`` over ``shard_map``).
"""

from __future__ import annotations

import math

import torch

from ..ops.bellman import u_dtype

__all__ = ["build_tables_sharded", "dp_body", "pad_level_axis", "jump_block"]


def pad_level_axis(stage, btilde, jump_cost, D: int, B: int):
    """Pad the level axis to a multiple of ``D`` with inert rows and columns
    (+inf stage and jump, budget use ``B+1`` so the rows never seed); returns
    ``(stage, btilde, jump_cost, L)`` with ``L`` the unpadded count."""
    L = stage.shape[-1]
    Lp = -(-L // D) * D
    if Lp == L:
        return stage, btilde, jump_cost, L
    pad = Lp - L
    stage_p = torch.cat([stage, stage.new_full(stage.shape[:-1] + (pad,), math.inf)], -1)
    btilde_p = torch.cat([btilde, btilde.new_full(btilde.shape[:-1] + (pad,), B + 1)], -1)
    return stage_p, btilde_p, _pad_jump(jump_cost, Lp), L


def _pad_jump(jump_cost, Lp: int):
    L = jump_cost.shape[0]
    if Lp == L:
        return jump_cost
    jump_p = jump_cost.new_full((Lp, Lp), math.inf)
    jump_p[:L, :L] = jump_cost
    return jump_p


def jump_block(jump_cost, mesh):
    """This rank's block of successor columns of the jump table padded for
    ``mesh``'s ``level`` axis: ``(Lp, Lp/D)``, contiguous."""
    D = mesh.shape["level"]
    L = jump_cost.shape[0]
    Lp = -(-L // D) * D
    Ld = Lp // D
    d = mesh.coord("level")
    return _pad_jump(jump_cost, Lp)[:, d * Ld:(d + 1) * Ld].contiguous()


def dp_body(stage_s, btilde_s, jump_block, B: int, mesh, axis: str = "level"):
    """The per-rank DP sweep: ``jump_block (Lp, Lp/D)`` holds this rank's
    successor columns, ``stage_s``/``btilde_s`` are replicated ``(nt, Lp)``
    or ``(S, nt, Lp)``.  Every rank of ``mesh``'s ``axis`` group must call
    it.  Returns the full (replicated) padded tables ``(U, phi0)``:
    ``U (nt-1, Lp, B+1)`` and ``phi0 (Lp, B+1)``, with the start axis in
    front where the inputs have one."""
    single = stage_s.dim() == 2
    if single:
        stage_s, btilde_s = stage_s[None], btilde_s[None]
    S, nt, Lp = stage_s.shape
    Ld = jump_block.shape[1]
    j_base = mesh.coord(axis) * Ld
    dev, dtype = stage_s.device, stage_s.dtype
    inf = torch.tensor(math.inf, dtype=dtype, device=dev)
    b_grid = torch.arange(B + 1, device=dev)
    btilde_s = btilde_s.to(torch.int64)

    phi = torch.where(b_grid == btilde_s[:, -1, :, None],
                      stage_s[:, -1, :, None], inf)  # (S, Lp, B+1) replicated
    U = torch.empty((S, max(nt - 1, 0), Lp, B + 1), dtype=u_dtype(Lp), device=dev)
    # Where each step's budget shift lands inside [0, B], for every step at once.
    ok = b_grid >= btilde_s[:, :-1, :, None]  # (S, nt-1, Lp, B+1)
    part = torch.empty((2, S, Lp, B + 1), dtype=dtype, device=dev)
    for i in range(nt - 2, -1, -1):
        # This rank's block of Φ rows: the j-range it contracts over.
        tot = phi[:, None, j_base:j_base + Ld, :] + jump_block[None, :, :, None]
        val_loc, arg_loc = torch.min(tot, dim=2)  # first minimal local j
        part[0] = val_loc
        torch.add(arg_loc, j_base, out=part[1])  # global j, exact in the float type
        parts = mesh.all_gather(part, axis)  # (D, 2, S, Lp, B+1)
        # Cross-rank min with first-minimal-global-j tie-breaking: the first
        # minimal shard, both planes picked by one gather.
        pick = torch.argmin(parts[:, 0], dim=0, keepdim=True)
        picked = torch.gather(parts, 0, pick[:, None].expand(1, 2, S, Lp, B + 1))[0]
        # The budget shift out[l, b] = picked[l, b − b̃_i[l]] as one gather of
        # both planes; +inf / 0 where b < b̃.
        src = (b_grid - btilde_s[:, i, :, None]).clamp_(min=0)
        shifted = torch.gather(picked, 3, src.expand(2, S, Lp, B + 1))
        # stage + shifted value, the unsharded build's order (the JAX body's
        # where(ok, stage + value, inf) differs where a stage is not finite).
        phi = stage_s[:, i, :, None] + torch.where(ok[:, i], shifted[0], inf)
        U[:, i] = torch.where(ok[:, i], shifted[1], 0)
    if single:
        return U[0], phi[0]
    return U, phi


def build_tables_sharded(stage, btilde, jump_cost, B: int, smax: int, mesh):
    """Sharded equivalent of :func:`mioc_tpu_torch.ops.bellman.build_tables`
    (and, with a leading start axis, of ``build_tables_batched``).

    ``jump_cost`` is partitioned over its columns (successor ``j``) on the
    mesh's ``level`` axis.  Returns the full (replicated) ``(U, phi0)`` on
    every rank, padded on the level axis when ``L`` does not divide the axis
    size; chase them with the padded ``btilde`` of :func:`pad_level_axis`.
    ``smax`` is taken for the unsharded signature: the budget shift already
    gives +inf where ``b̃ > B``, and ``b̃ ≤ smax`` holds for admissible
    ``u_old``."""
    stage, btilde, _, _ = pad_level_axis(stage, btilde, jump_cost, mesh.shape["level"], B)
    return dp_body(stage, btilde, jump_block(jump_cost, mesh), B, mesh)
