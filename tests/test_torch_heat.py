"""Port vs JAX package: the dense parabolic PDE objective and the heat problem.

Both packages build ``HeatObj`` on meshes from the same triangulator (the
FEM arrays are equal, test_torch_fem.py), so the host-computed sweep
operators S⁻¹, M⁻¹F, the mass matrix and state0 are EQUAL.  The sweeps then
run in XLA and in torch, whose 145-term dot products sum in other orders:
f agrees to rtol 1e-12 and ∇f to 1e-11 of its largest entry at float64
(measured on the CPU: f within 2e-16 relative, ∇f within 1e-15 of its max
norm, states within 1e-14 absolute).  Within the port every row of a
batched forward or adjoint has the bits of the single evaluation of that
row.  The solves (host loop, device loop speculative and sequential, a
3-start multistart, the CLI) take the JAX package's decisions: iterations,
inner steps, evaluation counts and accepted controls equal, J to rtol 1e-12.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from mioc_tpu import cli as jcli  # noqa: E402
from mioc_tpu.models import heat as jheat  # noqa: E402
from mioc_tpu.solvers import trm as jtrm  # noqa: E402
from mioc_tpu.solvers import trm_device as jdev  # noqa: E402
from mioc_tpu.utils.init import rand_func  # noqa: E402
from mioc_tpu_torch import cli, interop  # noqa: E402
from mioc_tpu_torch.models import heat as theat  # noqa: E402
from mioc_tpu_torch.models import registry  # noqa: E402
from mioc_tpu_torch.ops import bellman as tb  # noqa: E402
from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve  # noqa: E402
from mioc_tpu_torch.solvers.trm_device import (  # noqa: E402
    multistart_solve_device, trm_solve_device)
from test_torch_fem import load_jax_triangulator  # noqa: E402

PRESET = dict(beta=1e-3, delta0=2.0, p=2)
INTS = ("converged", "iterations", "inner_steps", "f_evals", "df_evals", "dp_builds")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_triangulator():
    """Both packages' meshes from the native triangulator (test_torch_fem.py)."""
    load_jax_triangulator()


_PAIRS = {}


def _pair(refinements, nt):
    """JAX and port HeatObj at ``refinements`` of the default mesh."""
    key = (refinements, nt)
    if key not in _PAIRS:
        _PAIRS[key] = (
            jheat.HeatObj(nt=nt, mesh=jheat.construct_mesh(refinements=refinements)),
            theat.HeatObj(nt=nt, mesh=theat.construct_mesh(refinements=refinements),
                          device="cpu"))
    return _PAIRS[key]


def _controls(obj, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 6, size=(n, obj.nt, 2)).astype(float)


@pytest.mark.parametrize("refinements,N", [(1, 41), (2, 145)])
def test_operators_equal_jax(refinements, N):
    j, t = _pair(refinements, 40)
    assert t.Nglobal_dofs == j.Nglobal_dofs == N
    assert t.tau == j.tau and t.admissible.L == j.admissible.L == 36
    for name in ("Sinv", "M_invF", "state0", "_Mj", "yd"):
        assert np.array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name))), name
    assert np.array_equal(t.M_invA, j.M_invA)


@pytest.mark.parametrize("refinements", [1, 2])
def test_f_states_and_gradient_match_jax(refinements):
    j, t = _pair(refinements, 40)
    for x in _controls(t, 3, refinements):
        j.x = jnp.asarray(x)
        fj = j.eval_f_()
        j.eval_df_()
        t.x = torch.as_tensor(x)
        ft = t.eval_f_()
        t.eval_df_()
        np.testing.assert_allclose(ft, fj, rtol=1e-12)
        dj = np.asarray(j.df)
        np.testing.assert_allclose(t.df.numpy(), dj, rtol=0, atol=1e-11 * np.abs(dj).max())
        ys, lam = np.asarray(j.state), np.asarray(j.adjoint)
        assert t.state.shape == ys.shape and t.adjoint.shape == lam.shape
        np.testing.assert_allclose(t.state.numpy(), ys, rtol=0, atol=1e-12 * np.abs(ys).max())
        np.testing.assert_allclose(t.adjoint.numpy(), lam, rtol=0,
                                   atol=1e-12 * np.abs(lam).max())
        np.testing.assert_allclose(t.eval_f(x), j.eval_f(x), rtol=1e-12)


def test_fd_gradient():
    """Exact discrete adjoint: the forward difference agrees to O(t)
    (tests/test_heat.py's check)."""
    _, t = _pair(2, 40)
    u = np.ones((t.nt, 2))
    t.x = torch.as_tensor(u)
    f0 = t.eval_f_()
    t.eval_df_()
    h = np.random.default_rng(0).normal(size=u.shape)
    dfh = t.tau * float((t.df.numpy() * h).sum())
    fd = (t.eval_f(u + 1e-6 * h) - f0) / 1e-6
    assert abs(fd - dfh) / abs(dfh) < 1e-5


def test_compat_skip_first_gu():
    _, t = _pair(2, 40)
    t.x = torch.ones((t.nt, 2), dtype=torch.float64)
    t.eval_f_()
    t.eval_df_()
    df_exact = t.df.numpy().copy()
    t.compat_skip_first_gu = True
    t._build()
    t.df_valid = False
    t.eval_df_()
    df_compat = t.df.numpy().copy()
    t.compat_skip_first_gu = False
    t._build()
    # Differs only in the first row, by exactly c_0·Gu = ½γ.
    np.testing.assert_allclose(df_exact[1:], df_compat[1:], rtol=1e-12)
    np.testing.assert_allclose(df_exact[0] - df_compat[0], 0.5 * t.gamma)


@pytest.mark.parametrize("flag", ["compat_adjoint", "compat_skip_first_gu"])
def test_compat_gradients_match_jax(flag):
    j, t = _pair(1, 40)
    x = _controls(t, 1, 7)[0]
    try:
        for o in (j, t):
            setattr(o, flag, True)
            o._build()
        j.x = jnp.asarray(x)
        j.eval_f_()
        j.df_valid = False
        j.eval_df_()
        t.x = torch.as_tensor(x)
        t.eval_f_()
        t.eval_df_()
        dj = np.asarray(j.df)
        np.testing.assert_allclose(t.df.numpy(), dj, rtol=0, atol=1e-11 * np.abs(dj).max())
    finally:
        for o in (j, t):
            setattr(o, flag, False)
            o._build()


@pytest.mark.parametrize("rows", [1, 2, 9, 17, 40])
def test_batched_rows_bit_equal_single(rows):
    """Every row of a batched forward and adjoint has the single
    evaluation's bits (fixed-shape product chunks, fold sums)."""
    _, t = _pair(2, 24)
    xs = torch.as_tensor(_controls(t, rows, rows))
    f, ys = t._forward_batch(xs)
    df, lam = t._adjoint_batch(xs, ys)
    assert f.shape == (rows,) and ys.shape == (t.nt + 1, rows, t.Nglobal_dofs)
    assert df.shape == (rows, t.nt, 2) and lam.shape == (rows, t.nt, t.Nglobal_dofs)
    for r in range(rows):
        f1, y1 = t._forward(xs[r])
        d1, l1 = t._adjoint(xs[r], y1)
        assert torch.equal(f1, f[r]) and torch.equal(y1, ys[:, r])
        assert torch.equal(d1, df[r]) and torch.equal(l1, lam[r])


def _scalars(j):
    return {k: np.asarray(getattr(j, k)) for k in interop.PROBLEM_PARAMS["heat"]}


def test_interop_carries_a_jax_heat_across():
    j, _ = _pair(2, 40)
    params = {k: np.asarray(getattr(j, k)) for k in
              interop.PROBLEM_PARAMS["heat"] + interop.HEAT_OPERATORS}
    t = interop.objective_from_params("heat", params, device="cpu")
    assert t.mesh is None and t.Nglobal_dofs == 145 and t.tau == j.tau
    for x in _controls(t, 2, 3):
        np.testing.assert_allclose(t.eval_f(x), j.eval_f(x), rtol=1e-12)
    with pytest.raises(KeyError, match="give all"):
        interop.objective_from_params("heat", {**_scalars(j), "Sinv": params["Sinv"]},
                                      device="cpu")


def test_default_heat_and_registry():
    """The registry's heat is the default mesh (N = 545 with the native
    triangulator) with the JAX preset; its operators equal the JAX
    package's."""
    t = registry.build("heat", nt=20, device="cpu")
    j = jheat.HeatObj(nt=20)
    assert isinstance(t, theat.HeatObj) and registry.get("heat").preset == PRESET
    assert t.Nglobal_dofs == j.Nglobal_dofs
    assert np.array_equal(t.Sinv.numpy(), np.asarray(j.Sinv))
    t2 = interop.objective_from_params("heat", _scalars(j), device="cpu")
    assert np.array_equal(t2.M_invF.numpy(), np.asarray(j.M_invF))


def test_sparse_modes_settings_and_errors():
    """The cg/mg modes construct (the JAX package's errors for a bad
    request), build no N×N array, and set the wave's switch by engine:
    on for dense and banded, off for ELL (mioc_tpu/models/heat.py:163-187)."""
    mesh = theat.construct_mesh(refinements=1)
    with pytest.raises(ValueError, match="refinement chain"):
        theat.HeatObj(nt=10, mesh=mesh, solver="mg", device="cpu")
    with pytest.raises(ValueError, match="unknown sparse format"):
        theat.HeatObj(nt=10, mesh=mesh, solver="cg", sparse_format="csr", device="cpu")
    with pytest.raises(ValueError, match="unknown operator mode"):
        theat.HeatObj(nt=10, mesh=mesh, solver="lu", device="cpu")
    for solver, fmt, exact in (("dense", "ell", True), ("cg", "ell", False),
                               ("cg", "banded", True), ("mg", "ell", False),
                               ("mg", "banded", True)):
        kw = dict(mesh_hierarchy=theat.construct_mesh_hierarchy(refinements=1)) \
            if solver == "mg" else dict(mesh=mesh)
        t = theat.HeatObj(nt=10, solver=solver, sparse_format=fmt, device="cpu", **kw)
        assert t._batched_sweeps_bitexact is exact and t._speculative_multistart is exact
        assert (t.dof_perm is not None) == (solver != "dense" and fmt == "banded")
        if solver != "dense":
            assert t._Mj is None and not hasattr(t, "Sinv")
            N = t.Nglobal_dofs
            assert all(tuple(a.shape) != (N, N) for a in vars(t).values()
                       if isinstance(a, torch.Tensor))
    # solver="mg" with no mesh takes the default hierarchy (N = 545).
    assert theat.HeatObj(nt=4, solver="mg", device="cpu").Nglobal_dofs == 545


def test_heat_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        theat.HeatObj(nt=10, mesh=theat.construct_mesh(refinements=1))


@pytest.mark.parametrize("solver,fmt", [("cg", "ell"), ("mg", "banded")])
def test_sparse_heat_defaults_to_cuda(monkeypatch, solver, fmt):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        theat.HeatObj(nt=10, mesh_hierarchy=theat.construct_mesh_hierarchy(refinements=1),
                      solver=solver, sparse_format=fmt)


# -- the sparse large-mesh engines -------------------------------------------
# The JAX package's cases (tests/test_heat.py:86-137): the twice-refined mesh
# (N = 145, two 128-row blocks on the banded engine), Jacobi-CG with 80
# iterations, mg-CG with 10 over the three-mesh hierarchy.  Measured on the
# CPU against the JAX package at the same mode: f within 3e-15 relative,
# ∇f within 8e-15 of its max, states within 4e-15 of theirs.
SPARSE_MODES = [("cg", "ell"), ("cg", "banded"), ("mg", "ell"), ("mg", "banded")]
_SPARSE = {}


def _sparse_pair(solver, fmt, nt=30):
    key = (solver, fmt, nt)
    if key not in _SPARSE:
        kw = dict(solver=solver, sparse_format=fmt, cg_iters=80 if solver == "cg" else 10)
        if solver == "mg":
            j = jheat.HeatObj(nt=nt, mesh_hierarchy=jheat.construct_mesh_hierarchy(
                refinements=2), **kw)
            t = theat.HeatObj(nt=nt, mesh_hierarchy=theat.construct_mesh_hierarchy(
                refinements=2), device="cpu", **kw)
        else:
            j = jheat.HeatObj(nt=nt, mesh=jheat.construct_mesh(refinements=2), **kw)
            t = theat.HeatObj(nt=nt, mesh=theat.construct_mesh(refinements=2), device="cpu",
                              **kw)
        _SPARSE[key] = (j, t)
    return _SPARSE[key]


@pytest.mark.parametrize("solver,fmt", SPARSE_MODES)
def test_sparse_operators_equal_jax(solver, fmt):
    j, t = _sparse_pair(solver, fmt)
    assert t.Nglobal_dofs == j.Nglobal_dofs == 145 and t.tau == j.tau
    for name in ("M_invF", "state0"):
        assert np.array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name))), name
    assert np.array_equal(t._dinv.numpy(), np.asarray(j._dinv))
    if fmt == "banded":
        assert np.array_equal(t.dof_perm, j.dof_perm)
        assert t._Kspec == j._Kspec and t._Mspec == j._Mspec
        assert np.array_equal(t._Kblk_host, np.asarray(j._Kblk))
        assert np.array_equal(t._Mblk_host, np.asarray(j._Mblk))
    else:
        for name in ("_Kv", "_Kc", "_Mv", "_Mc"):
            assert np.array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name))), name
    if solver == "mg":
        for L, jL in zip(t._mg_host["levels"], j._mg_ops["levels"]):
            for k in jL:
                assert np.array_equal(L[k], np.asarray(jL[k])), k


@pytest.mark.parametrize("solver,fmt", SPARSE_MODES)
def test_sparse_f_states_and_gradient_match_jax(solver, fmt):
    """f, ∇f, the states and the adjoint against the JAX package at the same
    mode (f rtol 1e-12, the rest 1e-11 of their max) and f and ∇f against
    the port's dense mode (rtol 1e-10 and 1e-8, tests/test_heat.py's)."""
    j, t = _sparse_pair(solver, fmt)
    _, dense = _pair(2, 30)
    for x in _controls(t, 2, 11):
        j.x = jnp.asarray(x)
        fj = j.eval_f_()
        j.eval_df_()
        t.x = torch.as_tensor(x)
        ft = t.eval_f_()
        t.eval_df_()
        np.testing.assert_allclose(ft, fj, rtol=1e-12)
        dj = np.asarray(j.df)
        np.testing.assert_allclose(t.df.numpy(), dj, rtol=0, atol=1e-11 * np.abs(dj).max())
        ys = j.unpermute_dofs(np.asarray(j.state))
        np.testing.assert_allclose(t.unpermute_dofs(t.state).numpy(), ys, rtol=0,
                                   atol=1e-11 * np.abs(ys).max())
        lam = j.unpermute_dofs(np.asarray(j.adjoint))
        np.testing.assert_allclose(t.unpermute_dofs(t.adjoint).numpy(), lam, rtol=0,
                                   atol=1e-11 * np.abs(lam).max())
        dense.x = torch.as_tensor(x)
        np.testing.assert_allclose(ft, dense.eval_f_(), rtol=1e-10)
        dense.eval_df_()
        np.testing.assert_allclose(t.df.numpy(), dense.df.numpy(), rtol=1e-8)


def test_sparse_fd_gradient():
    """mg-CG on the banded engine: the adjoint stays consistent with the
    (inexactly solved) forward (tests/test_heat.py:107)."""
    _, t = _sparse_pair("mg", "banded")
    rng = np.random.default_rng(2)
    x = rng.integers(0, 6, size=(t.nt, 2)).astype(float)
    t.x = torch.as_tensor(x)
    f0 = t.eval_f_()
    t.eval_df_()
    h = rng.normal(size=x.shape)
    dfh = t.tau * float((t.df.numpy() * h).sum())
    fd = (t.eval_f(x + 1e-6 * h) - f0) / 1e-6
    assert abs(fd - dfh) / abs(dfh) < 1e-5


def test_unpermute_dofs_round_trip():
    _, t = _sparse_pair("mg", "banded")
    perm = t.dof_perm
    y = np.random.default_rng(3).normal(size=(3, t.Nglobal_dofs))
    assert np.array_equal(t.unpermute_dofs(y[:, perm]), y)
    assert torch.equal(t.unpermute_dofs(torch.as_tensor(y[:, perm])), torch.as_tensor(y))
    _, ell = _sparse_pair("mg", "ell")
    assert ell.unpermute_dofs(y) is y
    # The permuted state0 is the assembly-order one, permuted.
    _, dense = _pair(2, 30)
    assert np.array_equal(t.unpermute_dofs(t.state0.numpy()), dense.state0.numpy())


@pytest.mark.parametrize("rows", [1, 2, 9, 17])
def test_banded_rows_bit_equal_single(rows):
    """Every row of a batched forward and adjoint on the banded mg engine
    has the single evaluation's bits (16-row chunks, row sums of one
    shape)."""
    _, t = _sparse_pair("mg", "banded", nt=8)
    xs = torch.as_tensor(_controls(t, rows, 40 + rows))
    f, ys = t._forward_batch(xs)
    df, lam = t._adjoint_batch(xs, ys)
    assert f.shape == (rows,) and ys.shape == (t.nt + 1, rows, t.Nglobal_dofs)
    for r in range(rows):
        f1, y1 = t._forward(xs[r])
        d1, l1 = t._adjoint(xs[r], y1)
        assert torch.equal(f1, f[r]) and torch.equal(y1, ys[:, r])
        assert torch.equal(d1, df[r]) and torch.equal(l1, lam[r])


@pytest.fixture(scope="module")
def banded_solves():
    """The banded mg engine (N = 145, nt=20, mg-CG 8): the JAX package's
    host solve from seed 0, the port's host solve and its device solves,
    speculative and sequential."""
    kw = dict(solver="mg", cg_iters=8, sparse_format="banded")
    jo = jheat.HeatObj(nt=20, mesh_hierarchy=jheat.construct_mesh_hierarchy(refinements=2),
                       **kw)
    to = theat.HeatObj(nt=20, mesh_hierarchy=theat.construct_mesh_hierarchy(refinements=2),
                       device="cpu", **kw)
    out = {"jax": jtrm.trm_solve(jo, jtrm.TRMParameters(**PRESET), seed=0),
           "host": trm_solve(to, TRMParameters(**PRESET), seed=0)}
    for spec in (True, False):
        out[spec] = trm_solve_device(to, TRMParameters(**PRESET), seed=0, speculative=spec)
    return out


def test_banded_host_solve_matches_jax(banded_solves):
    rt, rj = banded_solves["host"], banded_solves["jax"]
    assert rt.converged
    _same_result(rt, rj)


@pytest.mark.parametrize("speculative", [True, False], ids=["speculative", "sequential"])
def test_banded_device_solve_takes_the_host_decisions(banded_solves, speculative):
    """The device loop takes the host loop's decisions (one ∇f fewer), and
    the speculative wave (8 rows: one chunk) equals the sequential loop
    field for field."""
    r, host = banded_solves[speculative], banded_solves["host"]
    assert bool(r.converged) and int(r.iterations) == host.iterations
    assert int(r.inner_steps) == host.inner_steps and int(r.df_evals) == host.df_evals - 1
    np.testing.assert_array_equal(r.u, host.u)
    np.testing.assert_allclose(float(r.J), host.J, rtol=1e-12)
    if speculative:
        _same_result(r, banded_solves[False])
        assert float(r.J) == float(banded_solves[False].J)


@pytest.mark.parametrize("fmt", ["ell", "banded"])
def test_interop_carries_a_sparse_jax_heat_across(fmt):
    """The JAX HeatObj's host operators (and its prolongations) build the
    port's engine with no assembly of its own; both compute the same f."""
    from mioc_tpu.fem import prolongation as jprolongation

    j, _ = _sparse_pair("mg", fmt)
    hier = j._mesh_hierarchy
    params = {k: getattr(j, k) for k in interop.PROBLEM_PARAMS["heat"]
              + interop.HEAT_SPARSE_OPERATORS + interop.HEAT_ENGINE}
    params["prolongations"] = [jprolongation(hier[i - 1], hier[i], j.fe)
                               for i in range(len(hier) - 1, 0, -1)]
    if fmt == "banded":
        params["dof_perm"] = j.dof_perm
    t = interop.objective_from_params("heat", params, device="cpu")
    assert t.mesh is None and t.solver_mode == "mg" and t.sparse_format == fmt
    assert np.array_equal(t.state0.numpy(), np.asarray(j.state0))
    for x in _controls(t, 2, 5):
        np.testing.assert_allclose(t.eval_f(x), j.eval_f(x), rtol=1e-12)
    with pytest.raises(KeyError, match="missing sparse heat operators"):
        interop.objective_from_params("heat", {**_scalars(j), "solver_mode": "mg"},
                                      device="cpu")


def _same_result(rt, rj, fields=INTS):
    for field in fields:
        assert np.asarray(getattr(rt, field)).tolist() == \
            np.asarray(getattr(rj, field)).tolist(), field
    np.testing.assert_array_equal(np.asarray(rt.u), np.asarray(rj.u))
    np.testing.assert_array_equal(np.asarray(rt.x_final), np.asarray(rj.x_final))
    for field in ("J", "f", "tv"):
        np.testing.assert_allclose(np.asarray(getattr(rt, field), dtype=float),
                                   np.asarray(getattr(rj, field), dtype=float),
                                   rtol=1e-12, err_msg=field)


def test_host_solve_matches_jax():
    mesh_j, mesh_t = jheat.construct_mesh(refinements=2), theat.construct_mesh(refinements=2)
    rj = jtrm.trm_solve(jheat.HeatObj(nt=40, mesh=mesh_j), jtrm.TRMParameters(**PRESET),
                        seed=0)
    calls = tb.build_tables_plain.calls, tb.backtrack_plain.calls
    rt = trm_solve(theat.HeatObj(nt=40, mesh=mesh_t, device="cpu"), TRMParameters(**PRESET),
                   seed=0)
    assert rt.converged and rj.converged
    _same_result(rt, rj)
    assert (tb.build_tables_plain.calls - calls[0], tb.backtrack_plain.calls - calls[1]) == (
        rt.dp_builds, rt.inner_steps)


@pytest.fixture(scope="module")
def device_solves():
    """tests/test_trm_device.py's heat case: nt=24 on the once-refined mesh,
    x0 = rand_func(seed=3); the JAX package's speculative and sequential
    device solves and the port's."""
    mj, mt = jheat.construct_mesh(refinements=1), theat.construct_mesh(refinements=1)
    jo, to = jheat.HeatObj(nt=24, mesh=mj), theat.HeatObj(nt=24, mesh=mt, device="cpu")
    x0 = rand_func(jo, seed=3)
    out = {}
    for spec in (True, False):
        out["jax", spec] = jdev.trm_solve_device(jo, jtrm.TRMParameters(**PRESET), x0=x0,
                                                 speculative=spec)
        out["port", spec] = trm_solve_device(to, TRMParameters(**PRESET), x0=x0,
                                             speculative=spec)
    return out


@pytest.mark.parametrize("speculative", [True, False], ids=["speculative", "sequential"])
def test_device_solve_matches_jax(device_solves, speculative):
    rt, rj = device_solves["port", speculative], device_solves["jax", speculative]
    assert bool(rt.converged)
    _same_result(rt, rj)


def test_speculative_equals_sequential(device_solves):
    """The trial wave (8 rows: a padded chunk, its ys a slice of the
    padded buffer) takes the sequential loop's decisions, field for field."""
    spec, seq = device_solves["port", True], device_solves["port", False]
    _same_result(spec, seq)
    for field in ("J", "f", "tv"):
        assert np.asarray(getattr(spec, field)) == np.asarray(getattr(seq, field)), field


def test_multistart_matches_jax():
    mj, mt = jheat.construct_mesh(refinements=1), theat.construct_mesh(refinements=1)
    jo, to = jheat.HeatObj(nt=24, mesh=mj), theat.HeatObj(nt=24, mesh=mt, device="cpu")
    x0s = np.stack([rand_func(jo, seed=s) for s in range(3)])
    rj = jdev.multistart_solve_device(jo, jtrm.TRMParameters(**PRESET), x0s)
    spec = multistart_solve_device(to, TRMParameters(**PRESET), x0s)
    seq = multistart_solve_device(to, TRMParameters(**PRESET), x0s, speculative=False)
    assert to._speculative_multistart and bool(np.all(spec.converged))
    _same_result(spec, rj)
    _same_result(seq, spec)
    single = trm_solve_device(to, TRMParameters(**PRESET), x0=x0s[1])
    assert int(single.iterations) == int(spec.iterations[1])
    assert float(single.J) == float(spec.J[1])
    np.testing.assert_array_equal(single.u, spec.u[1])


def _json_line(out):
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def test_cli_heat_matches_jax(capsys):
    argv = ["heat", "--n", "24", "--no-plot", "--no-log", "--seed", "0"]
    assert jcli.main(argv) == 0
    want = _json_line(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = _json_line(capsys.readouterr().out)
    for key in ("problem", "n", "iterations", "f_evals", "df_evals", "converged"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["J"], want["J"], rtol=1e-12)
