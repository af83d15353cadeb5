"""Port vs JAX package: the mixed fishing model, the mixed solver, the mixed
CLI, the XLA-order arithmetic they rest on, and the NaN trap.

``LVMMixedObj`` rounds as the JAX package's compiled CPU sweeps do
(``mioc_tpu_torch.ops.xla_order``), so on the CPU at float64 its states, f
and ∇f equal the JAX package's bit for bit, and ``mixed_solve`` — whose
projected-gradient steps amplify any one-ulp difference — gives the JAX
package's rounds, sweep counts, iterates and history.  The tolerances stated
by the tests (f to rtol 1e-12, ∇f to 1e-11 of its max norm, history and
``c`` to 1e-10) are what the solves must meet; the model's claim is bit
equality, held too.
"""

import json
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from mioc_tpu import cli as jcli  # noqa: E402
from mioc_tpu.models import LVMObj as JaxLVM  # noqa: E402
from mioc_tpu.models.mixed_fishing import LVMMixedObj as JaxMixed  # noqa: E402
from mioc_tpu.solvers import mixed as jmixed  # noqa: E402
from mioc_tpu.solvers import trm as jtrm  # noqa: E402
from mioc_tpu.utils.init import rand_func as jrand_func  # noqa: E402
from mioc_tpu_torch import cli, interop  # noqa: E402
from mioc_tpu_torch.models import LVMMixedObj, LVMObj, registry  # noqa: E402
from mioc_tpu_torch.ops import xla_order  # noqa: E402
from mioc_tpu_torch.solvers import mixed as tmixed  # noqa: E402
from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve  # noqa: E402
from mioc_tpu_torch.utils import checks  # noqa: E402
from mioc_tpu_torch.utils.checks import assert_admissible  # noqa: E402
from mioc_tpu_torch.utils.init import rand_func  # noqa: E402

PRESET = dict(beta=1e-4, delta0=2.0, p=np.inf)  # the registry's "mixed"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    return np.asarray(a, dtype=np.float64).view(np.int64)


def _count(obj):
    """Count the objective's forward and adjoint sweeps (wraps them)."""
    n = {"f": 0, "df": 0}
    fwd, adj = obj._forward, obj._adjoint

    def forward(*a):
        n["f"] += 1
        return fwd(*a)

    def adjoint(*a):
        n["df"] += 1
        return adj(*a)

    obj._forward, obj._adjoint = forward, adjoint
    return n


def _start(nt, seed, c_seed=None):
    x = jrand_func(JaxMixed(nt=nt), seed=seed)
    if c_seed is not None:
        x[:, 0] = np.random.default_rng(c_seed).random(nt) * 0.3
    return x


# -- the model ----------------------------------------------------------------

def test_defaults_registry_and_interop():
    j, t = JaxMixed(), LVMMixedObj(device="cpu")
    assert (t.nt, t.nu, t.nv, t.T0, t.T1) == (j.nt, j.nu, j.nv, j.T0, j.T1) == (600, 1, 3, 0.0, 12.0)
    assert t.V == j.V and t.tau == j.tau and (t.cmax, t.rho) == (j.cmax, j.rho)
    np.testing.assert_array_equal(t.admissible.levels, j.admissible.levels)
    np.testing.assert_array_equal(t.umin, j.umin)
    np.testing.assert_array_equal(t.umax, j.umax)
    assert registry.get("mixed").preset == PRESET
    obj = registry.build("mixed", 48, device="cpu")
    assert isinstance(obj, LVMMixedObj) and obj.nt == 48
    j = JaxMixed(nt=64, cmax=0.2, rho=0.1)
    params = {k: np.asarray(getattr(j, k)) for k in interop.PROBLEM_PARAMS["mixed"]}
    t = interop.objective_from_params("mixed", params, device="cpu")
    x = _start(64, 3, c_seed=3)
    t.x = t.as_control(x)
    j.x = jnp.asarray(x)
    assert t.eval_f_() == j.eval_f_()
    assert (t.cmax, t.rho) == (0.2, 0.1)


@pytest.mark.parametrize("nt,seed", [(240, 0), (48, 2), (1024, 3), (32, 4), (57, 7)])
def test_f_and_df_match_jax(nt, seed):
    x = _start(nt, seed, c_seed=seed)
    j, t = JaxMixed(nt=nt), LVMMixedObj(nt=nt, device="cpu")
    j.x, t.x = jnp.asarray(x), t.as_control(x)
    fj, ft = j.eval_f_(), t.eval_f_()
    j.eval_df_()
    t.eval_df_()
    dj, dt = np.asarray(j.df), t.df.numpy()
    np.testing.assert_allclose(ft, fj, rtol=1e-12)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-11 * np.abs(dj).max())
    # The model's claim: the JAX package's bits (states, adjoints, f, ∇f).
    assert ft == fj
    np.testing.assert_array_equal(_bits(t.state.numpy()), _bits(j.state))
    np.testing.assert_array_equal(_bits(t.adjoint.numpy()), _bits(j.adjoint))
    np.testing.assert_array_equal(_bits(dt), _bits(dj))


def test_Fu_Gu_match_jacfwd():
    j, t = JaxMixed(nt=100), LVMMixedObj(nt=100, device="cpu")
    rng = np.random.default_rng(11)
    for _ in range(3):
        y = rng.normal(size=2) + 1.0
        u = np.r_[rng.random() * 0.3, np.eye(3)[rng.integers(3)]]
        for name in ("Fu", "Gu", "Fy", "F", "G", "Gy"):
            want = np.asarray(getattr(j, name)(jnp.asarray(y), jnp.asarray(u), 3))
            got = getattr(t, name)(torch.tensor(y), torch.tensor(u), 3).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15, err_msg=name)


@pytest.mark.parametrize("rows", [1, 5, 16])
def test_batched_rows_equal_single_sweeps(rows):
    t = LVMMixedObj(nt=120, device="cpu")
    X = torch.as_tensor(np.stack([_start(120, s, c_seed=s) for s in range(rows)]))
    f, ys = t._forward_batch(X)
    df, lam = t._adjoint_batch(X, ys)
    for s in range(rows):
        f1, ys1 = t._forward(X[s])
        df1, lam1 = t._adjoint(X[s], ys1)
        assert torch.equal(f[s], f1)
        assert torch.equal(ys[:, s], ys1)
        assert torch.equal(df[s], df1) and torch.equal(lam[s], lam1)


def test_mixed_starts_equal_jax():
    for nt, seed in ((240, 0), (512, 77)):
        j, t = JaxMixed(nt=nt), LVMMixedObj(nt=nt, device="cpu")
        np.testing.assert_array_equal(rand_func(t, seed=seed), jrand_func(j, seed=seed))
        np.testing.assert_array_equal(rand_func(t, seed=seed, julia_stream=True),
                                      jrand_func(j, seed=seed, julia_stream=True))


# -- the XLA-order arithmetic ---------------------------------------------------

def test_fma_exact_is_correctly_rounded():
    rng = np.random.default_rng(5)
    a = np.r_[rng.normal(size=600), rng.normal(size=200) * 1e6, [0.0, -0.0, 1.0]]
    b = np.r_[rng.normal(size=600) * 1e-2, rng.normal(size=200) * 1e-9, [3.0, 2.0, 0.0]]
    c = np.r_[rng.normal(size=600), rng.normal(size=200), [1.5, 0.25, -2.0]]
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)])
    A, Bt, C = (torch.tensor(v) for v in (a, b, c))
    assert (want != c + a * b).sum() > 5  # the inputs tell fused from unfused
    np.testing.assert_array_equal(_bits(xla_order.fma_exact(A, Bt, C).numpy()), _bits(want))
    np.testing.assert_array_equal(xla_order.fma(A, Bt, C).numpy(), want)
    s = torch.tensor(0.05, dtype=torch.float64)
    np.testing.assert_array_equal(
        xla_order.fma(A, s, C).numpy(),
        [float(Fraction(x) * Fraction(0.05) + Fraction(z)) for x, z in zip(a, c)])
    assert isinstance(xla_order.addcmul_fuses("cpu"), bool)


@pytest.mark.parametrize("n", [37, 360, 1000, 3072])
def test_vdot_is_jnp_vdots_order(n):
    rng = np.random.default_rng(n)
    a, b = rng.normal(size=(2, n))
    want = float(jax.jit(jnp.vdot)(jnp.asarray(a), jnp.asarray(b)))
    assert xla_order.vdot(torch.tensor(a), torch.tensor(b)) == want
    assert xla_order.vdot(torch.tensor(a).reshape(-1, 1), torch.tensor(b)) == want


def test_const_dot_is_xlas_contraction():
    """The JAX fishing model's unrolled dot with constant couplings, jitted,
    against the port's on relaxed controls."""
    from mioc_tpu.objectives.ode import const_dot as jax_const_dot

    u = np.random.default_rng(1).random((400, 3))
    for v in ((0.2, 0.4, 0.01), (0.1, 0.2, 0.1), (0.3, 0.7)):
        uu = u[:, :len(v)]
        want = np.asarray(jax.jit(jax.vmap(lambda r: jax_const_dot(r, np.asarray(v))))(
            jnp.asarray(uu)))
        got = xla_order.const_dot(torch.tensor(uu), v).numpy()
        np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("n", [1, 7, 32, 33, 49, 64, 97, 241, 1025, 1100])
def test_window_sum_is_xlas_order(n):
    """The JAX package's jitted sum on the CPU (two rows, as its sweeps
    reduce) has the bits of ``window_sum`` at every length."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(2, n)) * np.exp(rng.normal(size=(2, n)) * 3)
    want = np.asarray(jax.jit(lambda v: jnp.sum(v, axis=1))(jnp.asarray(x)))
    got = xla_order.window_sum(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


# -- the mixed solver -------------------------------------------------------------

def _solve_both(nt, rounds, seed=0):
    j, t = JaxMixed(nt=nt), LVMMixedObj(nt=nt, device="cpu")
    nj, nt_ = _count(j), _count(t)
    rj = jmixed.mixed_solve(j, jmixed.MixedParameters(
        trm=jtrm.TRMParameters(**PRESET), rounds=rounds), seed=seed)
    rt = tmixed.mixed_solve(t, tmixed.MixedParameters(
        trm=TRMParameters(**PRESET), rounds=rounds), seed=seed)
    return (j, rj, nj), (t, rt, nt_)


@pytest.fixture(scope="module")
def solved240():
    """The JAX test's configuration (tests/test_mixed.py): nt=240, 6 rounds."""
    return _solve_both(240, 6)


@pytest.fixture(scope="module")
def solved48():
    return _solve_both(48, 20)


@pytest.mark.parametrize("case", ["solved240", "solved48"])
def test_mixed_solve_matches_jax(case, request):
    (j, rj, nj), (t, rt, nt_) = request.getfixturevalue(case)
    assert (rt.rounds, rt.converged, len(rt.history)) == (rj.rounds, rj.converged,
                                                          len(rj.history))
    np.testing.assert_allclose(rt.history, rj.history, rtol=1e-10)
    np.testing.assert_array_equal(rt.x[:, 1:], np.asarray(rj.x)[:, 1:])
    np.testing.assert_allclose(rt.x[:, 0], np.asarray(rj.x)[:, 0], rtol=0, atol=1e-10)
    assert nt_ == nj
    np.testing.assert_allclose(rt.J, rj.J, rtol=1e-12)
    assert isinstance(rt.J, float) and all(isinstance(h, float) for h in rt.history)
    # Bit for bit, as the model's rounding promises.
    assert rt.history == list(rj.history)
    np.testing.assert_array_equal(rt.x, np.asarray(rj.x))
    assert t.f == j.f and torch.equal(t.x, torch.as_tensor(np.array(j.x)))


def test_mixed_solve_monotone_and_feasible(solved240):
    _, (t, res, _) = solved240
    hist = np.asarray(res.history)
    assert np.all(np.diff(hist) <= 1e-9)
    c = res.x[:, 0]
    assert np.all(c >= -1e-12) and np.all(c <= t.cmax + 1e-12)
    assert_admissible(res.x[:, 1:], t.admissible)


def test_mixed_beats_integer_only(solved240):
    _, (_, res, _) = solved240
    view = tmixed._IntegerBlockView(LVMMixedObj(nt=240, device="cpu"), np.zeros((240, 1)))
    assert (view.device.type, view.dtype, view.nu, view.nv) == ("cpu", torch.float64, 0, 3)
    res0 = trm_solve(view, TRMParameters(**PRESET), seed=0)
    jview = jmixed._IntegerBlockView(JaxMixed(nt=240), np.zeros((240, 1)))
    jres0 = jtrm.trm_solve(jview, jtrm.TRMParameters(**PRESET), seed=0)
    assert res0.J == jres0.J and res0.iterations == jres0.iterations
    assert res.J <= res0.J + 1e-9


def test_mixed_rejects_pure_problems():
    with pytest.raises(ValueError):
        tmixed.mixed_solve(LVMObj(nt=50, device="cpu"), tmixed.MixedParameters())
    with pytest.raises(ValueError):
        jmixed.mixed_solve(JaxLVM(nt=50), jmixed.MixedParameters())


def test_mixed_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LVMMixedObj(nt=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["mixed", "--n", "16", "--no-plot", "--no-log"])


# -- the CLI ----------------------------------------------------------------------

def _json_line(out):
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def test_cli_mixed_prints_the_jax_result(capsys):
    argv = ["mixed", "--n", "48", "--seed", "0", "--no-plot", "--no-log"]
    assert jcli.main(argv) == 0
    want = _json_line(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    got = _json_line(tout)
    assert set(got) == set(want) == {"problem", "n", "J", "rounds", "converged", "wall_s"}
    assert (got["problem"], got["n"], got["rounds"], got["converged"]) == (
        want["problem"], want["n"], want["rounds"], want["converged"])
    np.testing.assert_allclose(got["J"], want["J"], rtol=1e-12)
    lines = tout.splitlines()
    assert lines[0].endswith(" seconds") and lines[1] == f"Objective Value: J = {got['J']}"


def test_cli_mixed_without_no_plot_raises_before_solving(capsys, monkeypatch, tmp_path):
    """Once refused; the mixed CLI now plots after solving, as the JAX CLI
    does: the same ``.dat`` exports, byte for byte (the continuous and the
    integer controls and the normalized gradient), and a ``results.png``."""
    argv = ["mixed", "--n", "32", "--seed", "0", "--no-log"]
    for name, main, extra in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(argv + extra) == 0
        assert "plot saved to results.png" in capsys.readouterr().out
        assert (tmp_path / name / "results.png").stat().st_size > 0
    dats = sorted(p.name for p in (tmp_path / "jax" / "data_files").iterdir())
    assert dats == sorted(p.name for p in (tmp_path / "port" / "data_files").iterdir())
    assert "u(1).dat" in dats and "v(1).dat" in dats
    for d in dats:
        assert ((tmp_path / "port" / "data_files" / d).read_bytes()
                == (tmp_path / "jax" / "data_files" / d).read_bytes()), d


# -- the NaN trap --------------------------------------------------------------

@pytest.fixture
def nan_checks():
    checks.enable_nan_checks()
    yield
    checks.enable_nan_checks(False)


def test_nan_checks_trap_objective_values(nan_checks):
    t = LVMMixedObj(nt=40, device="cpu")
    x = _start(40, 0, c_seed=0)
    x[5, 0] = np.nan
    t.x = t.as_control(x)
    with pytest.raises(FloatingPointError, match="NaN in f"):
        t.eval_f_()
    with pytest.raises(FloatingPointError, match="NaN in f"):
        t.eval_f(x)
    with pytest.raises(FloatingPointError):
        tmixed.mixed_solve(LVMMixedObj(nt=40, device="cpu"), tmixed.MixedParameters(rounds=1),
                           x0=x)
    with pytest.raises(FloatingPointError, match="NaN"):
        checks.check_nan(torch.tensor([1.0, np.nan]), "a tensor")
    assert checks.check_nan(np.inf, "inf") == np.inf  # +inf is not a NaN


def test_nan_checks_leave_infinite_trials_and_are_off_by_default():
    t = LVMMixedObj(nt=40, device="cpu")
    x = _start(40, 0, c_seed=0)
    x[5, 0] = np.nan
    t.x = t.as_control(x)
    assert np.isnan(t.eval_f_())  # off: no trap

    class Overflowing(LVMObj):
        """Fishing whose first trial overflows to +inf."""

        calls = 0

        def eval_f_impl(self, x, cache):
            Overflowing.calls += 1
            f, ys = super().eval_f_impl(x, cache)
            return (f + np.inf if Overflowing.calls == 2 else f), ys

    par = TRMParameters(beta=1e-3, delta0=1.0, maxiter=3)
    ref = trm_solve(LVMObj(nt=60, device="cpu"), par, seed=0)
    checks.enable_nan_checks()
    try:
        res = trm_solve(Overflowing(nt=60, device="cpu"), par, seed=0)
    finally:
        checks.enable_nan_checks(False)
    # The +inf trial is a rejected step: one more inner step than without it.
    assert res.inner_steps == ref.inner_steps + 1 and np.isfinite(res.J)
