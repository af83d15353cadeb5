"""Geometric multigrid V-cycle preconditioner for the sparse PDE sweeps.

Counterpart of ``mioc_tpu.fem.multigrid``, the large-mesh scale-out path:
plain Jacobi-CG on ``K = M + τA`` needs O(1/h) iterations, a V-cycle over the
uniform-refinement mesh hierarchy makes the count h-independent.

The levels are built on the host once, with the JAX package's numpy/scipy
code (:func:`build_mg_ops`, :func:`build_mg_banded` return its structure in
numpy arrays):

* level operators by Galerkin coarsening ``K_c = Pᵀ K_f P`` with the nodal
  :func:`~mioc_tpu_torch.fem.mesh.prolongation` between consecutive meshes;
* every level's K, P and R = Pᵀ in ELL (:mod:`.sparse_device`) or block-
  banded (:mod:`.banded_device`) form, the banded coarse orderings derived
  from the fine RCM order;
* damped-Jacobi smoothing, ν sweeps pre and post (symmetric, so the cycle is
  an SPD preconditioner for CG);
* the coarsest level solved by a precomputed dense inverse.

:func:`mg_device` and :func:`mg_banded_device` move them to the device (the
banded blocks in the layout their product reads, every level's vectors in a
zero-padded :class:`~mioc_tpu_torch.fem.banded_device.Layout`).  The rows
forms keep each row's arithmetic its own: smoothing is elementwise, every
product runs at the fixed width of its caller (``ROWS`` rows for the
public functions), and the coarse solve is ``b @ coarse_inv.T`` at that
width.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.rows import chunked
from .banded_device import banded_apply, device_blocks, layout_for, pad, unpad
from .sparse_device import ell_matvec, to_ell

__all__ = ["mesh_prolongations", "build_mg_ops", "mg_device", "mg_apply", "build_mg_banded",
           "mg_banded_device", "ell_levels", "banded_levels", "mg_apply_banded", "mg_apply_banded_rows",
           "MGLevel", "vcycle"]


class MGLevel(NamedTuple):
    """One level of a V-cycle on the device: ``K`` maps this level's rows to
    this level's, ``R`` to the next coarser level's, ``P`` back; ``dinv`` is
    ``1/diag(K)`` in this level's layout."""

    K: Callable
    R: Callable
    P: Callable
    dinv: torch.Tensor


def vcycle(levels, coarse, b, *, omega: float = 0.6, nu: int = 2, wdinv=None):
    """One V(ν,ν) cycle ``z ≈ K⁻¹ b`` from a zero guess over ``levels``
    (:class:`MGLevel`, fine first), ``coarse`` the coarsest solve.
    ``wdinv``, when given, holds each level's ``omega · dinv``."""
    wds = wdinv if wdinv is not None else [omega * L.dinv for L in levels]

    def cycle(l, b):
        if l == len(levels):
            return coarse(b)
        L, wd = levels[l], wds[l]
        # Pre-smooth: ν damped-Jacobi sweeps from zero.
        x = wd * b
        for _ in range(nu - 1):
            x = torch.addcmul(x, wd, b - L.K(x))
        # Coarse-grid correction.
        r = b - L.K(x)
        ec = cycle(l + 1, L.R(r))
        x = x + L.P(ec)
        # Post-smooth (same ν: keeps the cycle symmetric ⇒ SPD for CG).
        for _ in range(nu):
            x = torch.addcmul(x, wd, b - L.K(x))
        return x

    return cycle(0, b)


def mesh_prolongations(meshes, fe):
    """The nodal prolongations of a hierarchy ``meshes`` (coarse → fine),
    finest first: element l maps level l+1 (coarser) to level l."""
    from .mesh import prolongation

    return [prolongation(meshes[i - 1], meshes[i], fe) for i in range(len(meshes) - 1, 0, -1)]


def build_mg_ops(meshes, fe, K_fine, dtype=np.float64, *, prolongations=None):
    """ELL level operators (numpy) for :func:`mg_device`: ``{"levels": ({Kv,
    Kc, dinv, Pv, Pc, Rv, Rc}, …), "coarse_inv"}``, the JAX package's
    structure.  ``meshes`` is the hierarchy coarse → fine; ``K_fine`` the
    SPD system matrix on the finest mesh.  ``prolongations``
    (:func:`mesh_prolongations`' list) may stand in for ``meshes``/``fe``."""
    import scipy.sparse as sp

    if prolongations is None:
        prolongations = mesh_prolongations(meshes, fe)
    Ks = [sp.csr_matrix(K_fine)]
    Ps = []  # Ps[l]: level-(l+1)-coarse -> level-l-fine prolongation
    for P in prolongations:
        P = sp.csr_matrix(P)
        Ps.append(P)
        Ks.append(sp.csr_matrix(P.T @ Ks[-1] @ P))

    levels = []
    for K, P in zip(Ks[:-1], Ps):
        Kv, Kc = to_ell(K, dtype)
        Pv, Pc = to_ell(P, dtype)
        Rv, Rc = to_ell(P.T.tocsr(), dtype)
        levels.append({"Kv": Kv, "Kc": Kc, "dinv": np.asarray(1.0 / K.diagonal(), dtype=dtype),
                       "Pv": Pv, "Pc": Pc, "Rv": Rv, "Rc": Rc})
    coarse_inv = np.asarray(np.linalg.inv(Ks[-1].toarray()), dtype=dtype)
    return {"levels": tuple(levels), "coarse_inv": coarse_inv}


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)


def mg_device(ops, *, device, dtype):
    """:func:`build_mg_ops`'s arrays as tensors on ``device`` (values in
    ``dtype``, column indices int64).  A prolongation's pad entries (value
    0, column = its own row) may point past the coarse level; they are
    clamped to its last entry, as the JAX package's gather clamps them."""
    sizes = [len(L["dinv"]) for L in ops["levels"]] + [ops["coarse_inv"].shape[0]]
    levels = []
    for l, L in enumerate(ops["levels"]):
        L = dict(L, Pc=np.minimum(L["Pc"], sizes[l + 1] - 1))
        levels.append({k: _tensor(v, device, dtype) for k, v in L.items()})
    return {"levels": tuple(levels), "coarse_inv": _tensor(ops["coarse_inv"], device, dtype)}


def ell_levels(ops):
    """The :class:`MGLevel` list of :func:`mg_device`'s ELL levels (rows of
    any width, or one vector)."""

    def mv(v, c):
        return lambda x: ell_matvec(v, c, x)

    return [MGLevel(mv(L["Kv"], L["Kc"]), mv(L["Rv"], L["Rc"]), mv(L["Pv"], L["Pc"]),
                    L["dinv"]) for L in ops["levels"]]


def mg_apply(ops, b, *, omega: float = 0.6, nu: int = 2):
    """One V(ν,ν) cycle with the ELL levels of :func:`mg_device`: ``b``
    one vector ``(N,)`` or rows ``(K, N)``."""
    ciT = ops["coarse_inv"].T
    return vcycle(ell_levels(ops), lambda r: r @ ciT, b, omega=omega, nu=nu)


def build_mg_banded(meshes, fe, K_fine, perm_fine, dtype=np.float64, *, prolongations=None):
    """Block-banded levels (numpy), the JAX package's ``(static, ops)``:
    ``static`` the per-level specs ``{Kspec, Pspec, Rspec}``, ``ops`` the
    blocks ``{"levels": ({Kblk, dinv, Pblk, Rblk}, …), "coarse_inv"}``.

    ``K_fine`` is the finest-level SPD matrix in the ORIGINAL dof order;
    ``perm_fine`` its RCM permutation (the caller keeps its whole sweep in
    this permuted space).  The JAX package's ``dtype`` defaults to float32;
    the port's to float64, its default everywhere.  ``prolongations``
    (:func:`mesh_prolongations`' list) may stand in for ``meshes``/``fe``.
    """
    import scipy.sparse as sp

    from .banded_device import aligned_coarse_permutation, pack_banded

    if prolongations is None:
        prolongations = mesh_prolongations(meshes, fe)
    Kp = sp.csr_matrix(K_fine)[perm_fine][:, perm_fine]
    static, levels = [], []
    for l, P in enumerate(prolongations):
        P = sp.csr_matrix(P)
        if l == 0:
            P = P[perm_fine]
        else:
            P = P[perm_prev]
        perm_prev = aligned_coarse_permutation(P)
        Pp = sp.csr_matrix(P[:, perm_prev])
        Kspec, Kblk = pack_banded(Kp, dtype=dtype)
        Pspec, Pblk = pack_banded(Pp, dtype=dtype)
        Rspec, Rblk = pack_banded(sp.csr_matrix(Pp.T), dtype=dtype)
        static.append({"Kspec": Kspec, "Pspec": Pspec, "Rspec": Rspec})
        levels.append({"Kblk": Kblk, "dinv": np.asarray(1.0 / Kp.diagonal(), dtype=dtype),
                       "Pblk": Pblk, "Rblk": Rblk})
        Kp = sp.csr_matrix(Pp.T @ Kp @ Pp)
    ops = {"levels": tuple(levels),
           "coarse_inv": np.asarray(np.linalg.inv(Kp.toarray()), dtype=dtype)}
    return tuple(static), ops


def mg_banded_device(static, ops, *, device, dtype, fine_readers=(), fine_writers=()):
    """:func:`build_mg_banded`'s levels on ``device``: ``{"levels": ({Kblk,
    Pblk, Rblk, dinv}, …), "coarse_inv", "layouts"}`` with the blocks in the
    layout their product reads (:func:`~.banded_device.device_blocks`) and
    ``layouts[l]`` the zero-padded layout of level l's vectors, ``dinv`` in
    it.  ``fine_readers``/``fine_writers`` are further specs that read or
    write the finest level's vectors in place (the PDE sweep's K and M)."""
    nlev = len(static)
    sizes = [static[0]["Kspec"].nrows] + [S["Rspec"].nrows for S in static]
    layouts = []
    for l in range(nlev + 1):
        readers, writers = [], []
        if l < nlev:
            readers += [static[l]["Kspec"], static[l]["Rspec"]]
            writers += [static[l]["Kspec"], static[l]["Pspec"]]
        if l > 0:
            readers.append(static[l - 1]["Pspec"])
            writers.append(static[l - 1]["Rspec"])
        if l == 0:
            readers += list(fine_readers)
            writers += list(fine_writers)
        layouts.append(layout_for(sizes[l], readers, writers))
    levels = []
    for S, L, lay in zip(static, ops["levels"], layouts):
        dinv = np.zeros(lay.total)
        dinv[lay.front:lay.front + lay.n] = L["dinv"]
        levels.append({k: device_blocks(S[k.replace("blk", "spec")], L[k], device=device,
                                        dtype=dtype) for k in ("Kblk", "Pblk", "Rblk")}
                      | {"dinv": _tensor(dinv, device, dtype)})
    return {"levels": tuple(levels), "coarse_inv": _tensor(ops["coarse_inv"], device, dtype),
            "layouts": tuple(layouts)}


def banded_levels(static, ops):
    """The :class:`MGLevel` list and the coarse solve of
    :func:`mg_banded_device`'s levels, on padded buffers of each level's
    layout (rows of any fixed width)."""
    lays = ops["layouts"]
    levels = []
    for l, (S, L) in enumerate(zip(static, ops["levels"])):
        here, down = lays[l], lays[l + 1]

        def mk(spec, blk, src, dst):
            return lambda X: banded_apply(spec, blk, X, src, dst)

        levels.append(MGLevel(mk(S["Kspec"], L["Kblk"], here, here),
                              mk(S["Rspec"], L["Rblk"], here, down),
                              mk(S["Pspec"], L["Pblk"], down, here), L["dinv"]))
    coarse_lay, ciT = lays[-1], ops["coarse_inv"].T.contiguous()
    lo, hi = coarse_lay.front, coarse_lay.front + coarse_lay.n

    def coarse(X):
        Y = torch.zeros_like(X)
        Y[:, lo:hi] = X[:, lo:hi] @ ciT
        return Y

    return levels, coarse


def mg_apply_banded_rows(static, ops, b, *, omega: float = 0.6, nu: int = 2):
    """K-row V(ν,ν) cycle ``b (K, N) → (K, N)`` with :func:`mg_banded_device`'s
    levels: the rows go through in chunks of ``ROWS`` rows (zero rows
    appended), so every product has one shape and each row the bits of its
    single cycle."""
    levels, coarse = banded_levels(static, ops)
    fine = ops["layouts"][0]
    return chunked(lambda rows: unpad(vcycle(levels, coarse, pad(rows, fine), omega=omega,
                                             nu=nu), fine), b)


def mg_apply_banded(static, ops, b, *, omega: float = 0.6, nu: int = 2):
    """V(ν,ν) cycle on one vector: one row of :func:`mg_apply_banded_rows`."""
    return mg_apply_banded_rows(static, ops, b[None], omega=omega, nu=nu)[0]
