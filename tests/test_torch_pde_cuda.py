"""The dense PDE sweep kernel (``csrc/pde_dense.cu``, ``ops/pde_cuda.py``).

On the CPU: the wrapper's refusals, the rule of ``dense_fits``, and that the
CPU sweeps and the sparse ``cg``/``mg`` sweeps never reach the kernel while
the dense sweeps on a device where it fits hand it the unpadded rows.  On
the card (marked ``cuda``; this file imports neither JAX nor ``mioc_tpu``)::

    python -m pytest --noconftest -m cuda tests/test_torch_pde_cuda.py -q

the kernel against the plain sweep (``PDEObjective._sweep``) at heat's
N = 545, nt = 500, every row bit-equal to its single evaluation and to
itself at another place in the batch, ``HeatObj``'s f and ∇f against the
benchmark's plain NumPy reference within the judge's heat limits, and one
launch per sweep.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mioc_tpu_torch.models.heat import (  # noqa: E402
    HeatObj,
    construct_mesh,
    construct_mesh_hierarchy,
)
from mioc_tpu_torch.objectives import pde  # noqa: E402
from mioc_tpu_torch.ops import pde_cuda  # noqa: E402
from mioc_tpu_torch.ops.rows import ROWS  # noqa: E402

HEAT_N = 545
HEAT_NT = 500


# ------------------------------------------------------------ CPU


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wrapper_refuses_cpu_tensors(dtype):
    drive = torch.zeros((3, 2, 8), dtype=dtype)
    with pytest.raises(ValueError, match="CUDA"):
        pde_cuda.dense_sweep(None, drive, torch.zeros((8, 8), dtype=dtype), False)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.int32])
def test_wrapper_refuses_other_dtypes(dtype):
    drive = torch.zeros((3, 2, 8), dtype=dtype)
    with pytest.raises(TypeError, match="float64 or float32"):
        pde_cuda.dense_sweep(None, drive, torch.zeros((8, 8), dtype=dtype), False)


@pytest.mark.parametrize("shape", [(3, 8), (1, 3, 2, 8)])
def test_wrapper_refuses_other_ranks(shape):
    with pytest.raises(ValueError, match=r"\(nt, R, N\)"):
        pde_cuda.dense_sweep(None, torch.zeros(shape), torch.zeros((8, 8)), False)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("device", ["cuda", "cuda:0", torch.device("cuda", 1)])
def test_dense_fits_heat_on_a_card(dtype, device):
    assert pde_cuda.dense_fits(HEAT_N, dtype, device)


@pytest.mark.parametrize("N,dtype,device", [
    (HEAT_N, torch.float64, "cpu"),
    (HEAT_N, torch.float32, torch.device("cpu")),
    (HEAT_N, torch.float16, "cuda"),
    (HEAT_N, torch.bfloat16, "cuda"),
    (561, torch.float64, "cuda"),  # 15 spans of 40 terms > 14
    (561, torch.float32, "cuda"),
    (8321, torch.float64, "cuda"),  # the large-mesh heat
    (0, torch.float64, "cuda"),
])
def test_dense_fits_refuses(N, dtype, device):
    assert not pde_cuda.dense_fits(N, dtype, device)


def test_dense_fits_every_n_up_to_the_design_limit():
    """Every N from 1 to 560 fits in both dtypes (the spans' rule binds
    before the shared memory), and the shared memory of a 14-row group stays
    within a block's at each."""
    for N in range(1, 561):
        for dtype, size in ((torch.float64, 8), (torch.float32, 4)):
            assert pde_cuda.dense_fits(N, dtype, "cuda"), (N, dtype)
            assert pde_cuda.smem_bytes(N, size, pde_cuda.MAX_ROWS) <= pde_cuda.MAX_SMEM
    assert pde_cuda.smem_bytes(HEAT_N, 8, pde_cuda.MAX_ROWS) == 181_888


def _raise(*args, **kwargs):
    raise AssertionError("the sweep kernel was reached")


def _controls(obj, rows, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 6, size=(rows, obj.nt, obj.nx)).astype(float),
                           dtype=obj.dtype, device=obj.device)


@pytest.fixture(scope="module")
def dense_cpu():
    return HeatObj(nt=12, mesh=construct_mesh(refinements=1), device="cpu")


@pytest.mark.parametrize("rows", [1, 3, 17])
def test_cpu_dense_sweeps_never_reach_the_kernel(monkeypatch, dense_cpu, rows):
    monkeypatch.setattr(pde_cuda, "dense_sweep", _raise)
    xs = _controls(dense_cpu, rows, rows)
    f, ys = dense_cpu._forward_batch(xs)
    dense_cpu._adjoint_batch(xs, ys)
    assert not dense_cpu._dense_kernel()
    assert dense_cpu._rows_swept(rows) == rows + (-rows % ROWS)


@pytest.mark.parametrize("solver,fmt", [("cg", "ell"), ("mg", "ell"), ("mg", "banded")])
def test_sparse_sweeps_never_reach_the_kernel(monkeypatch, solver, fmt):
    """Even where the kernel would take the shape, the cg/mg engines run
    their own sweeps."""
    obj = HeatObj(nt=6, mesh_hierarchy=construct_mesh_hierarchy(refinements=1), solver=solver,
                  sparse_format=fmt, cg_iters=4, device="cpu")
    monkeypatch.setattr(pde_cuda, "dense_fits", lambda *a: True)
    monkeypatch.setattr(pde_cuda, "dense_sweep", _raise)
    xs = _controls(obj, 2, 7)
    f, ys = obj._forward_batch(xs)
    obj._adjoint_batch(xs, ys)
    assert obj._rows_swept(2) == ROWS


@pytest.mark.parametrize("rows", [1, 5, 17])
def test_dense_sweeps_hand_the_kernel_the_unpadded_rows(monkeypatch, dense_cpu, rows):
    """Where the kernel serves, each sweep is one call with the rows passed
    (no padding to ROWS), contiguous, v_end the state0 row forward and None
    (0) in reverse; with the plain sweep standing in for the kernel the
    results are those of the CPU path, bit for bit."""
    calls = []

    def fake(v_end, drive, op, reverse):
        calls.append((None if v_end is None else v_end.clone(), tuple(drive.shape),
                      drive.is_contiguous(), op is (dense_cpu.Sinv if reverse else
                                                   dense_cpu._SinvT), reverse))
        R = drive.shape[1]
        return dense_cpu._sweep(0.0 if v_end is None else v_end, pde._pad_rows(drive), op,
                                reverse)[:, :R]

    xs = _controls(dense_cpu, rows, 100 + rows)
    f_ref, ys_ref = dense_cpu._forward_batch(xs)
    df_ref, lam_ref = dense_cpu._adjoint_batch(xs, ys_ref)
    monkeypatch.setattr(pde_cuda, "dense_fits", lambda *a: True)
    monkeypatch.setattr(pde_cuda, "dense_sweep", fake)
    f, ys = dense_cpu._forward_batch(xs)
    df, lam = dense_cpu._adjoint_batch(xs, ys)
    shape = (dense_cpu.nt, rows, dense_cpu.Nglobal_dofs)
    assert [c[1:] for c in calls] == [(shape, True, True, False), (shape, True, True, True)]
    assert torch.equal(calls[0][0], dense_cpu.state0) and calls[1][0] is None
    assert dense_cpu._rows_swept(rows) == rows
    for a, b in ((f, f_ref), (ys, ys_ref), (df, df_ref), (lam, lam_ref)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the card

ROW_COUNTS = (1, 8, 16, 17, 64, 72)


@pytest.fixture(scope="module")
def heat_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from mioc_tpu_torch.utils.init import rand_func

    out = {}
    for dtype in (torch.float64, torch.float32):
        obj = HeatObj(nt=HEAT_NT, device="cuda", dtype=dtype)
        assert obj.Nglobal_dofs == HEAT_N
        X = torch.as_tensor(np.stack([rand_func(obj, seed=s) for s in range(max(ROW_COUNTS))]),
                            dtype=dtype, device="cuda")
        rng = np.random.default_rng(19)
        adrive = torch.as_tensor(rng.normal(size=(HEAT_NT, max(ROW_COUNTS), HEAT_N)) * 1e-3,
                                 dtype=dtype, device="cuda")
        out[dtype] = (obj, X, obj._drive(X.transpose(0, 1)).contiguous(), adrive)
    return out


def _sweep_case(heat_card, dtype, reverse, R):
    obj, _, drive, adrive = heat_card[dtype]
    if reverse:
        return None, adrive[:, :R].contiguous(), obj.Sinv
    return obj.state0, drive[:, :R].contiguous(), obj._SinvT


@pytest.mark.cuda
@pytest.mark.parametrize("R", ROW_COUNTS)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype,tol", [
    (torch.float64, 1e-13),
    # float32: the kernel's and cuBLAS's sums of 545 terms differ by rounding,
    # ~1e-6 of the largest iterate over 500 steps (measured 7.8e-7 … 9.9e-7).
    (torch.float32, 1e-5),
])
def test_kernel_matches_the_plain_sweep(heat_card, dtype, tol, reverse, R):
    obj = heat_card[dtype][0]
    v_end, drive, op = _sweep_case(heat_card, dtype, reverse, R)
    out = pde_cuda.dense_sweep(v_end, drive, op, reverse)
    plain = obj._sweep(0.0 if v_end is None else v_end, pde._pad_rows(drive), op, reverse)
    plain = plain[:, :R]
    assert out.shape == plain.shape and out.dtype == dtype
    err = float((out.double() - plain.double()).abs().max() / plain.double().abs().max())
    assert err <= tol, err


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_rows_have_their_single_bits(heat_card, dtype, reverse):
    """Each row of a 72-row sweep is bit-equal to that row swept alone, and
    to itself in the batch reversed and in batches of the other row counts
    (other groups, other rows a group)."""
    R = max(ROW_COUNTS)
    v_end, drive, op = _sweep_case(heat_card, dtype, reverse, R)
    out = pde_cuda.dense_sweep(v_end, drive, op, reverse)
    flipped = pde_cuda.dense_sweep(v_end, drive.flip(1).contiguous(), op, reverse)
    assert torch.equal(out, flipped.flip(1))
    for r in range(R):
        one = pde_cuda.dense_sweep(v_end, drive[:, r:r + 1].contiguous(), op, reverse)
        assert torch.equal(one[:, 0], out[:, r]), r
    for n in ROW_COUNTS:
        part = pde_cuda.dense_sweep(v_end, drive[:, R - n:].contiguous(), op, reverse)
        assert torch.equal(part, out[:, R - n:]), n


@pytest.mark.cuda
@pytest.mark.parametrize("cell,rows", [("heat.device", 8), ("heat.multistart8", 64)])
def test_heat_f_and_df_against_the_reference(heat_card, cell, rows):
    """``HeatObj``'s batched f and ∇f on the kernel against the benchmark's
    plain NumPy reference, within the judge's limits of the heat cells."""
    from portbench import harness

    cell_spec, cfg, _ = harness.load_cell(cell)
    ref = harness.reference_model(cfg)
    obj, X, _, _ = heat_card[torch.float64]
    n0 = pde_cuda.dense_sweep.launches
    f, ys = obj._forward_batch(X[:rows])
    df, _ = obj._adjoint_batch(X[:rows], ys)
    assert pde_cuda.dense_sweep.launches - n0 == 2
    us = X[:rows].cpu().numpy()
    f_ref, g_ref = ref.value(us), ref.gradient(us)
    f_rel = np.abs(f.cpu().numpy() - f_ref) / np.abs(f_ref)
    df_rel = [np.abs(df[r].cpu().numpy() - g_ref[r]).max() / np.abs(g_ref[r]).max()
              for r in range(rows)]
    assert f_rel.max() <= cell_spec["limits"]["f_rel"], f_rel.max()
    assert max(df_rel) <= cell_spec["limits"]["df_rel"], max(df_rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_one_launch_per_sweep(heat_card, dtype):
    from mioc_tpu_torch.utils import trace

    obj, X, _, _ = heat_card[dtype]
    for rows in (1, 8, 64):
        n0 = pde_cuda.dense_sweep.launches
        trace.take()
        trace.enable()
        try:
            f, ys = obj._forward_batch(X[:rows])
            obj._adjoint_batch(X[:rows], ys)
        finally:
            trace.disable()
        spans = [sp for sp in trace.take() if sp.name.startswith("pde_sweep.")]
        assert pde_cuda.dense_sweep.launches - n0 == 2 == len(spans)
        assert all(sp.attrs["rows_swept"] == sp.attrs["rows"] == rows for sp in spans)
