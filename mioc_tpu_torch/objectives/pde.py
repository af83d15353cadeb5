"""Parabolic PDE-constrained objectives: implicit Euler + discrete adjoint.

Counterpart of ``mioc_tpu.objectives.pde`` (the reference's
``PDEObjective.jl``), dense mode.  The problem is

    min  ∫∫_Ω G(u, y) dA dt + ∫ G_t(u) dt
    s.t. ∂y/∂t + 𝒜 y = Σ_i f_i(x) u_i(t),   y(T0) = state0,  Robin boundary

semidiscretized by FEM into ``M ẏ + A y = F u`` and stepped by implicit
Euler.  The dense inverse ``S⁻¹ = (I + τM⁻¹A)⁻¹`` is computed once on the
host, with the JAX package's scipy/numpy calls, so the operators carry its
bits before they go to the device.  Each sweep step is then one matrix
product on the card:

  state:     y_k = S⁻¹ (y_{k−1} + τ (M⁻¹F) u_{k−1})
  adjoint:   λ_j = S⁻ᵀ (λ_{j+1} + τ w_{j+1} G_y(y_{j+1})),  λ_nt = 0,
             w = trapezoid weights (the exact discrete adjoint)
  gradient:  df_j = (M⁻¹F)ᵀ λ_j + c_j G_u(u_j),  c = ½, 1, …, 1, 1.5

and f is the trapezoid ``τ·(½ g_0 + Σ_{k=1}^{nt-1} g_k + ½ g_nt)`` with
``g_k = G(y_k, u_{min(k, nt-1)}) + G_t(u_{min(k, nt-1)})``.

``compat_skip_first_gu`` and ``compat_adjoint`` reproduce the reference's
inexact recursion (``PDEObjective.jl:159-197``) as the JAX package does: set
the attribute, then call :meth:`~PDEObjective._build`.

Rows.  The sweeps run over a batch of R rows (trial controls, starts) at
once: ``_forward_batch(xs (R, nt, nx)) → (f (R,), ys (nt+1, R, N))`` with
``ys`` time-major, and ``_adjoint_batch(xs, ys) → (df (R, nt, nx), lam (R,
nt, N))``.  Every row must have the bits of the single evaluation of that row
(the speculative trial wave and the multistart decide on them), and a library
product splits its sums by shape.  So every product has a fixed shape
(:func:`~mioc_tpu_torch.ops.rows.chunked`): the sweep steps ``(rows, N)·S⁻ᵀ``
and ``(rows, N)·S⁻¹`` in chunks of :data:`~mioc_tpu_torch.ops.rows.ROWS`
rows, the cost products over all ``(nt+1)·R`` state rows in chunks of
:data:`COST_ROWS`, and every sum is a :func:`~mioc_tpu_torch.ops.tv.fold_sum`.
A single evaluation is a batch of one row.  (The JAX package reaches the same
end on the TPU by evaluating a single forward as a duplicated 2-row batch,
``mioc_tpu/objectives/pde.py:506-509``.)  On the card (float64 or float32, an
N that :func:`~mioc_tpu_torch.ops.pde_cuda.dense_fits` takes) a dense sweep is
instead one launch of the sweep kernel (``csrc/pde_dense.cu``) over exactly
the rows passed: its dot products run in an order fixed by N alone, so each
row again has its single evaluation's bits.

Sparse modes.  ``mode="cg"``/``"mg"`` solve ``K y_k = M y_{k−1} + τ F
u_{k−1}`` (``K = M + τA``) per step with ``cg_iters`` preconditioned CG
iterations warm-started from the previous step (Jacobi for ``"cg"``, a
multigrid V-cycle for ``"mg"``), and the adjoint ``λ_j = M K⁻¹ (λ_{j+1} +
drive)`` the same way: the large-mesh path, with ``K`` and ``M`` in ELL
(``fmt="ell"``) or RCM-permuted block-banded (``fmt="banded"``) form
(:mod:`mioc_tpu_torch.fem.sparse_device`, :mod:`~mioc_tpu_torch.fem.
banded_device`, :mod:`~mioc_tpu_torch.fem.multigrid`).  Each step runs on
chunks of exactly :data:`~mioc_tpu_torch.ops.rows.ROWS` rows in a zero-
padded buffer (pad rows are zero, fixed points of the guarded CG), every
product at that width and every CG reduction a row sum of that shape, so
each row again has the bits of its single evaluation.  With ``"banded"``
the sweeps run in the permuted dof order: ``state0``, ``F``, ``M⁻¹F``, the
states and the adjoint are permuted, and :meth:`PDEObjective.unpermute_dofs`
maps back (``dof_perm`` holds the permutation).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, vmap

from .._device import resolve_device, resolve_dtype
from ..fem import banded_device
from ..fem.sparse_device import cg_solve_rows
from ..ops import pde_cuda
from ..ops.rows import ROWS, chunked
from ..ops.tv import fold_sum
from ..utils import trace
from .base import LazyObjective, sweep_span

__all__ = ["PDEObjective", "COST_ROWS"]

# Rows per product of the cost terms (tracking cost, its gradient, the
# gradient's (M⁻¹F)ᵀλ): they run over all (nt+1)·R states at once, so a wide
# fixed chunk keeps their launches few.
COST_ROWS = 512

def _numpy_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _pad_rows(t):
    """``t (nt, R, N)`` with zero rows appended on axis 1 up to a multiple of
    ROWS, so every sweep product has ROWS rows."""
    R = t.shape[1]
    pad = -R % ROWS
    return torch.cat([t, t.new_zeros((t.shape[0], pad, t.shape[2]))], dim=1) if pad else t


class _SparseEngine:
    """The cg/mg sweep operators on zero-padded row buffers ``(ROWS,
    layout.total)`` (:class:`~mioc_tpu_torch.fem.banded_device.Layout`; the
    identity layout for ELL): ``K``, ``M`` and the preconditioner ``pc`` (a
    vector or a callable) map such buffers to such buffers, ``F (nx,
    layout.total)`` holds the load columns."""

    def __init__(self, layout, K, M, pc, F, iters):
        self.layout, self.K, self.M, self.pc, self.F = layout, K, M, pc, F
        self.iters = int(iters)

    def pad(self, rows, width: int = ROWS):
        """``rows (..., n ≤ width, N)`` in a zero ``(..., width, total)`` buffer."""
        return banded_device.pad(rows, self.layout, width)

    def unpad(self, X):
        return banded_device.unpad(X, self.layout)

    def solve(self, b, x0):
        """``cg_iters`` preconditioned CG iterations on ``K x = b`` from ``x0``."""
        return cg_solve_rows(self.K, b, x0, self.pc, self.iters)

    def drive(self, u):
        """``F u`` for the rows of ``u (ROWS, nx)``, unrolled over nx."""
        acc = u[:, 0:1] * self.F[0]
        for j in range(1, self.F.shape[0]):
            acc = torch.addcmul(acc, u[:, j:j + 1], self.F[j])
        return acc

    def mass_rows(self, v):
        """``M v`` for every row of ``v (n, N)``, in chunks of ROWS rows."""
        return chunked(lambda rows: self.unpad(self.M(self.pad(rows))), v, ROWS)


class PDEObjective(LazyObjective):
    """Abstract parabolic PDE objective.

    A subclass assembles ``M`` (mass), ``A`` (stiffness + Robin), ``F`` (N,
    nx) load columns and ``state0`` (N,) on the host (numpy/scipy), then calls
    :meth:`setup_operators`.  It implements the cost hooks ``G(y, u, i)``
    (area running cost, scalar) and ``G_t(u, i)`` (control running cost),
    and may give ``Gy`` and ``Gu`` (default: ``torch.func.grad``).  The
    sweeps call the row forms :meth:`_G_rows`, :meth:`_Gy_rows` and
    :meth:`_Gu_rows`, which default to ``torch.func.vmap`` of those hooks; a
    subclass whose row forms give every row the bits of its single
    evaluation sets ``_batched_sweeps_bitexact`` (``HeatObj`` does).

    ``device=None`` means ``"cuda"`` (raises without CUDA; pass ``"cpu"``);
    ``dtype=None`` means float64.
    """

    compat_skip_first_gu: bool = False
    # The reference's full (inexact) gradient, for parity testing: the
    # adjoint drives with Gy at the CURRENT state and unit weight
    # (PDEObjective.jl:167-169) and Gu is added with unit weight on columns
    # 1 … nt−1 only (:192-197).  Set on the instance, then call _build().
    compat_adjoint: bool = False

    # The trial-wave chase of a single device solve (trm_device wave_chase):
    # the JAX package measured the trials chase faster at heat nt=500.
    _wave_chase_default = "trials"

    # Dense mode until setup_operators installs a sparse engine.
    solver_mode = "dense"
    sparse_format = "ell"
    dof_perm = None
    _dof_iperm = None
    _engine = None
    _sweep_layer = "pde_sweep"

    def __init__(self, *, T0, T1, nt, nu=0, V=None, admissible=None,
                 device=None, dtype=None):
        super().__init__()
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.T0, self.T1, self.nt = float(T0), float(T1), int(nt)
        self.tau = (self.T1 - self.T0) / self.nt
        self.V = V
        self.admissible = admissible
        self.nu = int(nu)
        self.nv = len(V) if V is not None else 0
        self.x = torch.zeros((self.nt, self.nx), dtype=self.dtype, device=self.device)
        self.state = None    # (nt+1, N): y_0 … y_nt
        self.adjoint = None  # (nt, N): λ_0 … λ_{nt-1}

    # -- operator precompute ---------------------------------------------------
    def setup_operators(self, M, A, F, state0, *, mode: str = "dense",
                        cg_iters: int = 40, mg_meshes=None, mg_fe=None,
                        fmt: str = "ell", matmul_precision: str = "highest",
                        dof_perm=None, mg_prolongations=None):
        """Precompute the sweep operators on the host
        (``mioc_tpu/objectives/pde.py:100-220``'s calls) and move them to the
        objective's device and dtype.

        ``mode="dense"``: the dense inverse ``S⁻¹ = (I + τM⁻¹A)⁻¹`` and
        ``M⁻¹F``.  ``mode="cg"``/``"mg"``: ``K = M + τA`` and ``M`` in the
        sparse format ``fmt`` (``"ell"`` or ``"banded"``), with
        ``cg_iters`` CG iterations per step; ``"mg"`` preconditions with a
        V-cycle over ``mg_meshes`` (coarse → fine, the finest the assembly
        mesh) with FE ``mg_fe``, or over ``mg_prolongations`` (finest
        first, :func:`~mioc_tpu_torch.fem.multigrid.mesh_prolongations`).
        ``dof_perm``, with ``"banded"``, replaces the RCM permutation the
        engine would compute.

        ``matmul_precision`` is accepted as the JAX package accepts it
        (``"highest"``, ``"float32"``; there it sets the TPU matrix unit's
        pass count).  Here every product is a full product in the
        objective's dtype whatever its value, as long as the process keeps
        PyTorch's default of TF32 off (the port never turns it on)."""
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        self.matmul_precision = str(matmul_precision)
        if mode not in ("dense", "cg", "mg"):
            raise ValueError(f"unknown operator mode {mode!r}")
        if mode == "mg" and mg_prolongations is None and (mg_meshes is None or mg_fe is None):
            raise ValueError("mode='mg' needs mg_meshes (coarse→fine) and mg_fe")
        if mode != "dense" and fmt not in ("ell", "banded"):
            raise ValueError(f"unknown sparse format {fmt!r}")
        N = F.shape[0]
        self.Nglobal_dofs = N
        self.solver_mode = mode
        self.cg_iters = int(cg_iters)
        Mc = sp.csc_matrix(M)
        solve_M = spla.factorized(Mc)
        M_invF = np.column_stack(
            [solve_M(np.asarray(F[:, j]).ravel()) for j in range(F.shape[1])]
        )
        self.M = Mc
        self.A = A
        self.F = np.asarray(F)
        if mode == "dense":
            A_d = A.toarray() if sp.issparse(A) else np.asarray(A)
            M_invA = np.column_stack([solve_M(A_d[:, j]) for j in range(N)])
            S = np.eye(N) + self.tau * M_invA
            self.M_invA = np.asarray(M_invA, dtype=_numpy_dtype(self.dtype))
            self.install_operators(np.linalg.inv(S), M_invF, state0)
            return
        self.sparse_format = fmt
        K = (Mc + self.tau * sp.csc_matrix(A)).tocsr()
        if mode == "mg" and mg_prolongations is None:
            from ..fem.multigrid import mesh_prolongations

            mg_prolongations = mesh_prolongations(mg_meshes, mg_fe)
        self._install_sparse(K, sp.csr_matrix(Mc), self.F, M_invF, np.asarray(state0),
                             mg_prolongations if mode == "mg" else None, dof_perm)

    def _install_sparse(self, K, M, F, M_invF, state0, prolongations, perm):
        """The cg/mg engine on ``K``, ``M`` (scipy, assembly order), ``F``,
        ``M⁻¹F``, ``state0`` and, for ``"mg"``, the level prolongations."""
        from ..fem import banded_device as bd
        from ..fem import multigrid as mg
        from ..fem.sparse_device import ell_matvec, to_ell

        dev, dt = self.device, self.dtype
        N = K.shape[0]

        def tensor(a):
            return torch.as_tensor(np.array(a, dtype=np.float64), device=dev).to(dt)

        if self.sparse_format == "banded":
            if perm is None:
                perm = bd.rcm_permutation(K)
            self.dof_perm = np.asarray(perm)
            self._dof_iperm = np.argsort(self.dof_perm)
            Kp, Mp = K[perm][:, perm], M[perm][:, perm]
            self._Kspec, Kblk = bd.pack_banded(Kp)
            self._Mspec, Mblk = bd.pack_banded(Mp)
            self._Kblk_host, self._Mblk_host = Kblk, Mblk
            dinv = 1.0 / Kp.diagonal()
            F, M_invF, state0 = F[perm], M_invF[perm], state0[perm]
            specs = (self._Kspec, self._Mspec)
            if prolongations is not None:
                self._mg_static, self._mg_host = mg.build_mg_banded(
                    None, None, K, perm, prolongations=prolongations)
                self._mg_ops = mg.mg_banded_device(self._mg_static, self._mg_host, device=dev,
                                                   dtype=dt, fine_readers=specs,
                                                   fine_writers=specs)
                layout = self._mg_ops["layouts"][0]
            else:
                layout = bd.layout_for(N, specs, specs)
            Kdev = bd.device_blocks(self._Kspec, Kblk, device=dev, dtype=dt)
            Mdev = bd.device_blocks(self._Mspec, Mblk, device=dev, dtype=dt)
            Kspec, Mspec = self._Kspec, self._Mspec
            apply_K = lambda X: bd.banded_apply(Kspec, Kdev, X, layout, layout)  # noqa: E731
            apply_M = lambda X: bd.banded_apply(Mspec, Mdev, X, layout, layout)  # noqa: E731
            self._Kdev, self._Mdev = Kdev, Mdev
        else:
            self.dof_perm = self._dof_iperm = None
            layout = bd.Layout(N, 0, N)
            Kv, Kc = to_ell(K)
            Mv, Mc = to_ell(M)
            self._Kv, self._Kc = tensor(Kv), torch.as_tensor(Kc.astype(np.int64), device=dev)
            self._Mv, self._Mc = tensor(Mv), torch.as_tensor(Mc.astype(np.int64), device=dev)
            dinv = 1.0 / K.diagonal()
            apply_K = lambda X: ell_matvec(self._Kv, self._Kc, X)  # noqa: E731
            apply_M = lambda X: ell_matvec(self._Mv, self._Mc, X)  # noqa: E731
            if prolongations is not None:
                self._mg_host = mg.build_mg_ops(None, None, K, prolongations=prolongations)
                self._mg_ops = mg.mg_device(self._mg_host, device=dev, dtype=dt)

        def padded(v):
            out = np.zeros(v.shape[:-1] + (layout.total,))
            out[..., layout.front:layout.front + N] = v
            return tensor(out)

        self._dinv = tensor(dinv)
        if self.solver_mode == "mg":
            if self.sparse_format == "banded":
                levels, coarse = mg.banded_levels(self._mg_static, self._mg_ops)
            else:
                levels = mg.ell_levels(self._mg_ops)
                ciT = self._mg_ops["coarse_inv"].T.contiguous()
                coarse = lambda r: r @ ciT  # noqa: E731
            wdinv = [0.6 * L.dinv for L in levels]  # the JAX package's ω = 0.6, ν = 2
            pc = lambda R: mg.vcycle(levels, coarse, R, wdinv=wdinv)  # noqa: E731
        else:
            pc = padded(dinv)
        self._engine = _SparseEngine(layout, apply_K, apply_M, pc, padded(np.asarray(F).T),
                                     self.cg_iters)
        self.M_invF = tensor(M_invF)
        self._MFT = self.M_invF.T.contiguous()
        self.state0 = tensor(state0)
        self._build()

    def install_operators(self, Sinv, M_invF, state0):
        """Put the sweep operators ``Sinv (N, N)``, ``M_invF (N, nx)`` and
        ``state0 (N,)`` (numpy arrays) on the device in the objective's dtype,
        then :meth:`_build`."""
        def dev(a):
            return torch.as_tensor(np.array(a, dtype=np.float64),
                                   device=self.device).to(self.dtype)

        self._engine = None
        self.Sinv = dev(Sinv)
        self.M_invF = dev(M_invF)
        self.state0 = dev(state0)
        self.Nglobal_dofs = N = self.Sinv.shape[0]
        if self.Sinv.shape != (N, N) or self.M_invF.shape != (N, self.nx) \
                or self.state0.shape != (N,):
            raise ValueError(f"operators of mismatched shapes: Sinv {tuple(self.Sinv.shape)}, "
                             f"M_invF {tuple(self.M_invF.shape)}, state0 "
                             f"{tuple(self.state0.shape)}")
        # Row products: the state step is rows @ S⁻ᵀ, the adjoint step
        # rows @ S⁻¹ (= (S⁻ᵀ λ)ᵀ), the control drive rows @ (M⁻¹F)ᵀ.
        self._SinvT = self.Sinv.T.contiguous()
        self._MFT = self.M_invF.T.contiguous()  # (nx, N)
        self._build()

    def _build(self):
        """The sweeps' coefficient vectors from the flags: trapezoid weights,
        the adjoint's drive weights and the Gu weight per control column
        (``mioc_tpu/objectives/pde.py:557-585``).  Call after changing
        ``compat_skip_first_gu`` or ``compat_adjoint``."""
        nt, dev, dt = self.nt, self.device, self.dtype
        w = torch.ones(nt + 1, dtype=dt, device=dev)
        w[0] = w[nt] = 0.5
        self._trap_w = w
        self._u_idx = torch.clamp(torch.arange(nt + 1, device=dev), max=nt - 1)
        if self.compat_adjoint:
            # Gy at the current state y_j, unit weight (PDEObjective.jl:159-172);
            # Gu with unit weight on columns 1 … nt−1 (:190-197).
            self._adj_w = torch.ones(nt, dtype=dt, device=dev)
            self._adj_u = torch.arange(nt, device=dev)
            cj = torch.ones(nt, dtype=dt, device=dev)
            cj[0] = 0.0
        else:
            # Exact discrete adjoint: step j takes y_{j+1}, u_{min(j+1, nt-1)}
            # and the trapezoid weight w_{j+1}.
            self._adj_w = w[1:].clone()
            self._adj_u = self._u_idx[1:].clone()
            cj = torch.ones(nt, dtype=dt, device=dev)
            cj[0] = 0.5
            cj[-1] = 1.5
            if self.compat_skip_first_gu:
                cj[0] = 0.0  # reference (PDEObjective.jl:192-197)
        self._cj = cj[:, None]

    # The JAX package's sweep-speed switch for the trial wave: on where the
    # batched rows are bit-exact (dense mode).
    @property
    def _speculative_multistart(self):
        return bool(getattr(self, "_batched_sweeps_bitexact", False))

    def unpermute_dofs(self, arr):
        """Map a dof-indexed array (last axis; numpy or a tensor) from the
        banded engine's RCM order back to the assembly order (the identity
        in the other modes)."""
        if self.dof_perm is None:
            return arr
        if isinstance(arr, torch.Tensor):
            return arr[..., torch.as_tensor(self._dof_iperm, device=arr.device)]
        return np.asarray(arr)[..., self._dof_iperm]

    # -- user cost hooks -------------------------------------------------------
    def G(self, y, u, i):
        raise NotImplementedError

    def G_t(self, u, i):
        raise NotImplementedError

    def Gy(self, y, u, i):
        return grad(lambda yy: self.G(yy, u, i))(y)

    def Gu(self, u, i):
        return grad(lambda uu: self.G_t(uu, i))(u)

    # Row forms ``(n, N), (n, nx), (n,)`` → ``(n,)`` / ``(n, N)`` /
    # ``(n, nx)``: vmap of the hooks unless a subclass overrides them.
    def _G_rows(self, ys, uu, t_idx):
        return vmap(lambda y, u_, t_: self.G(y, u_, t_) + self.G_t(u_, t_))(ys, uu, t_idx)

    def _Gy_rows(self, ys, uu, t_idx):
        return vmap(self.Gy)(ys, uu, t_idx)

    def _Gu_rows(self, uu, t_idx):
        return vmap(self.Gu)(uu, t_idx)

    # -- sweeps ----------------------------------------------------------------
    def _drive(self, xs_tm):
        """``τ·(M⁻¹F)u`` for every step and row of ``xs_tm (nt, R, nx)``: the
        nx-term product unrolled in a fixed order (elementwise, so each row's
        bits are its own)."""
        acc = xs_tm[..., 0:1] * self._MFT[0]
        for j in range(1, self.nx):
            acc = acc + xs_tm[..., j:j + 1] * self._MFT[j]
        return self.tau * acc

    def _dense_kernel(self) -> bool:
        """Whether the dense sweeps run as one launch of the sweep kernel
        (:func:`~mioc_tpu_torch.ops.pde_cuda.dense_fits`: a CUDA device,
        float64 or float32, an N the kernel holds); else :meth:`_sweep`."""
        return pde_cuda.dense_fits(self.Nglobal_dofs, self.dtype, self.device)

    def _dense(self, v_end, drive, op, reverse):
        """The dense sweep of ``drive (nt, R, N)`` with ``v_end`` an ``(N,)``
        row or None (0): all ``(nt+1, R, N)`` iterates (:meth:`_sweep`), by
        the kernel where it serves."""
        if self._dense_kernel():
            trace.annotate(path="kernel")
            return pde_cuda.dense_sweep(v_end, drive.contiguous(), op, reverse)
        R = drive.shape[1]
        return self._sweep(0.0 if v_end is None else v_end, _pad_rows(drive), op,
                           reverse)[:, :R]

    def _sweep(self, v_end, drive, op, reverse):
        """The sweep recursion over ``drive (nt, Rp, N)`` (Rp a multiple of
        ROWS): forward ``v_{k+1} = (v_k + drive[k]) @ op`` from ``v_0 =
        v_end``, or reverse ``v_k = (v_{k+1} + drive[k]) @ op`` from ``v_nt =
        v_end``.  Returns all ``(nt+1, Rp, N)`` iterates; each product is on
        ROWS rows.  The plain version of the sweep kernel
        (:mod:`~mioc_tpu_torch.ops.pde_cuda`), and the path wherever that
        does not serve."""
        nt, Rp, N = drive.shape
        out = drive.new_empty((nt + 1, Rp, N))
        if reverse:
            steps, end = [(k, k + 1, k) for k in range(nt - 1, -1, -1)], nt
        else:
            steps, end = [(k + 1, k, k) for k in range(nt)], 0
        out[end] = v_end
        for dst, src, k in steps:
            a = out[src] + drive[k]
            for r0 in range(0, Rp, ROWS):
                torch.matmul(a[r0:r0 + ROWS], op, out=out[dst, r0:r0 + ROWS])
        return out

    def _cg_forward(self, xs_tm):
        """The sparse state sweep ``xs_tm (nt, R, nx) → ys (nt+1, R, N)``:
        per chunk of ROWS rows (pad rows zero) and step, ``y ← K⁻¹(M y + τ F
        u)`` by CG warm-started at ``y`` (``mioc_tpu/objectives/pde.py:
        626-629``)."""
        E, nt, N = self._engine, self.nt, self.Nglobal_dofs
        R = xs_tm.shape[1]
        ys = xs_tm.new_empty((nt + 1, R, N))
        ys[0] = self.state0
        for s0 in range(0, R, ROWS):
            u = xs_tm[:, s0:s0 + ROWS]
            n = u.shape[1]
            u = torch.nn.functional.pad(u, (0, 0, 0, ROWS - n))
            y = E.pad(self.state0.expand(n, N))
            for k in range(nt):
                y = E.solve(E.M(y) + self.tau * E.drive(u[k]), y)
                ys[k + 1, s0:s0 + n] = E.unpad(y)[:n]
        return ys

    def _cg_adjoint(self, drive):
        """The sparse adjoint sweep ``drive (nt, R, N) → lam (nt, R, N)``: per
        chunk of ROWS rows and step j = nt−1 … 0, ``t ← K⁻¹(λ + drive_j)`` by
        CG warm-started at the previous ``t``, then ``λ ← M t`` (``S⁻ᵀ v = M
        K⁻¹ v``, ``mioc_tpu/objectives/pde.py:729-742``)."""
        E, nt = self._engine, self.nt
        R = drive.shape[1]
        lam_tm = torch.empty_like(drive)
        for s0 in range(0, R, ROWS):
            d = E.pad(drive[:, s0:s0 + ROWS])                       # (nt, ROWS, total)
            n = min(ROWS, R - s0)
            lam = t = torch.zeros_like(d[0])
            for j in range(nt - 1, -1, -1):
                t = E.solve(lam + d[j], t)
                lam = E.M(t)
                lam_tm[j, s0:s0 + n] = E.unpad(lam)[:n]
        return lam_tm

    @sweep_span("f")
    def _forward_batch(self, xs):
        """``xs (R, nt, nx) → (f (R,), ys (nt+1, R, N))``, ``ys[k] = y_k``:
        time-major with the rows on axis 1, the JAX package's layout."""
        nt, N = self.nt, self.Nglobal_dofs
        R = xs.shape[0]
        xs_tm = xs.transpose(0, 1)                                  # (nt, R, nx)
        if self._engine is None:
            ys = self._dense(self.state0, self._drive(xs_tm), self._SinvT, False)  # (nt+1, R, N)
        else:
            ys = self._cg_forward(xs_tm)
        uu = xs_tm[self._u_idx]                                     # (nt+1, R, nx)
        t_idx = torch.arange(nt + 1, device=xs.device).repeat_interleave(R)
        g = self._G_rows(ys.reshape((nt + 1) * R, N), uu.reshape((nt + 1) * R, -1), t_idx)
        g = g.view(nt + 1, R).T
        return self.tau * fold_sum(self._trap_w * g), ys

    @sweep_span("df")
    def _adjoint_batch(self, xs, ys):
        """``(xs (R, nt, nx), ys (nt+1, R, N)) → (df (R, nt, nx), lam (R, nt,
        N))``, ``lam[:, j] = λ_j``."""
        nt, N = self.nt, self.Nglobal_dofs
        R = xs.shape[0]
        xs_tm = xs.transpose(0, 1)                                  # (nt, R, nx)
        src = ys[:-1] if self.compat_adjoint else ys[1:]            # (nt, R, N)
        k_src = torch.arange(nt, device=xs.device) + (0 if self.compat_adjoint else 1)
        gy = self._Gy_rows(src.reshape(nt * R, N),
                           xs_tm[self._adj_u].reshape(nt * R, -1),
                           k_src.repeat_interleave(R)).view(nt, R, N)
        drive = (self.tau * self._adj_w)[:, None, None] * gy
        if self._engine is None:
            lam_tm = self._dense(None, drive, self.Sinv, True)[:nt]  # (nt, R, N)
        else:
            lam_tm = self._cg_adjoint(drive)
        lam = lam_tm.transpose(0, 1)                                # (R, nt, N)
        df = chunked(lambda rows: rows @ self.M_invF,
                     lam_tm.reshape(nt * R, N), COST_ROWS).view(nt, R, -1)
        gu = self._Gu_rows(xs_tm.reshape(nt * R, -1),
                           torch.arange(nt, device=xs.device).repeat_interleave(R))
        df = df + self._cj[:, None] * gu.view(nt, R, -1)
        return df.transpose(0, 1).contiguous(), lam

    def _forward_batch_with(self, xs):
        """The JAX package's name for :meth:`_forward_batch`."""
        return self._forward_batch(xs)

    def _rows_swept(self, rows: int) -> int:
        if self._engine is None and self._dense_kernel():
            return rows  # the kernel computes exactly the rows passed
        return rows + (-rows % ROWS)  # every product runs on chunks of ROWS rows

    def _sweep_steps(self, rows: int) -> int:
        # The sparse engines step each chunk of ROWS rows through the steps
        # in turn; the dense sweep steps all chunks together.
        return self.nt * (1 if self._engine is None else -(-rows // ROWS))

    def _forward(self, x):
        """``x (nt, nx) → (f, ys (nt+1, N))``."""
        f, ys = self._forward_batch(x[None])
        return f[0], ys[:, 0]

    def _adjoint(self, x, ys):
        """``(x, ys (nt+1, N)) → (df (nt, nx), lam (nt, N))``."""
        df, lam = self._adjoint_batch(x[None], ys[:, None])
        return df[0], lam[0]

    # -- protocol hooks --------------------------------------------------------
    def eval_f_impl(self, x, cache: bool):
        return self._forward(x)

    def eval_f_(self):
        f = super().eval_f_()
        self.state = self._aux
        return f

    def eval_df_impl(self):
        df, lam = self._adjoint(self.x, self._aux)
        self.adjoint = lam
        return df
