"""Port vs JAX package: the banded temporal DP and the host loop's
``dp_backend="temporal"`` route.

The same seeded inputs go through ``mioc_tpu.parallel.temporal`` and
``mioc_tpu_torch.parallel.temporal`` on the CPU at float64.  The tables are
built from adds and mins in the same composition order, so they must be
BIT-equal; the chases equal at the full budget and every halving cap.
Against the port's plain DP (``ops.bellman.dp_solve``) Φ0 agrees to rtol
1e-10 (another composition of the same sums) and the paths are equal.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from mioc_tpu.models import LVMObj as JaxLVM  # noqa: E402
from mioc_tpu.ops import bellman as jb  # noqa: E402
from mioc_tpu.parallel import temporal as jt  # noqa: E402
from mioc_tpu.solvers import trm as jtrm  # noqa: E402
from mioc_tpu.utils.init import rand_func  # noqa: E402
from mioc_tpu_torch import cli  # noqa: E402
from mioc_tpu_torch.models import LVMObj  # noqa: E402
from mioc_tpu_torch.ops import bellman as tb  # noqa: E402
from mioc_tpu_torch.ops.levels import (  # noqa: E402
    bounded_sum_levels,
    jump_cost_table,
    product_levels,
)
from mioc_tpu_torch.parallel import temporal as tt  # noqa: E402
from mioc_tpu_torch.parallel import temporal_dp_solve  # noqa: E402
from mioc_tpu_torch.solvers.trm import TRMParameters, dp_route, trm_solve  # noqa: E402
from mioc_tpu_torch.solvers.trm_device import trm_solve_device  # noqa: E402
from mioc_tpu_torch.utils import checks  # noqa: E402

SOS1 = lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1)  # noqa: E731
HEAT = lambda: product_levels([list(range(6))] * 2)  # noqa: E731

# name: (level set, nt, B, p, beta, tau)
SHAPES = {
    "small": (SOS1, 37, 9, 1, 0.05, 0.1),
    "fishing": (SOS1, 1024, 170, np.inf, 1e-4, 12.0 / 1024),
    "heat200": (HEAT, 200, 40, 2, 1e-3, 0.05),
    "seq16": (SOS1, 16, 6, 1, 0.1, 0.1),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    return np.asarray(a, dtype=np.float64).view(np.int64)


def _inputs(name, seed=0):
    levels_fn, nt, B, p, beta, tau = SHAPES[name]
    adm = levels_fn()
    rng = np.random.default_rng(seed)
    grad = rng.normal(size=(nt, adm.M))
    u_old = adm.levels[rng.integers(0, adm.L, size=nt)]
    jump = jump_cost_table(adm.levels, p, beta=beta)
    return adm, grad, u_old, jump, B, tau


def _tables_both(name, chunk=None, seed=0):
    adm, grad, u_old, jump, B, tau = _inputs(name, seed)
    smax = tb.max_budget_use(adm.levels)
    st, bt = jb.stage_tables(jnp.asarray(grad), jnp.asarray(u_old), jnp.asarray(adm.levels), tau)
    pj = np.asarray(jt.temporal_tables(st, bt, jnp.asarray(jump), B, smax, chunk))
    st_t, bt_t = torch.as_tensor(np.array(st)), torch.as_tensor(np.array(bt))
    pt = tt.temporal_tables(st_t, bt_t, torch.as_tensor(jump), B, smax, chunk)
    return adm, jump, B, bt, bt_t, pj, pt


@pytest.mark.parametrize("name,chunk", [("small", None), ("small", 1), ("small", 5),
                                        ("small", 36), ("small", 64), ("fishing", None),
                                        ("heat200", None), ("seq16", None), ("seq16", 3)])
def test_tables_bit_equal_jax(name, chunk):
    adm, jump, B, bt, bt_t, pj, pt = _tables_both(name, chunk)
    assert pt.shape == pj.shape == (SHAPES[name][1], B + 1, adm.L)
    np.testing.assert_array_equal(_bits(pt.numpy()), _bits(pj))
    caps = sorted({B, B // 2, B // 4, B // 8, 1, 0, -1}, reverse=True)
    for cap in caps:
        uj, ij = jt.temporal_backtrack(jnp.asarray(pj), bt, jnp.asarray(jump),
                                       jnp.asarray(adm.levels), jnp.int32(cap))
        ut, it = tt.temporal_backtrack(pt, bt_t, torch.as_tensor(jump), adm.levels, cap)
        assert it.dtype == torch.int32
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij), err_msg=f"cap {cap}")
        np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
        it0, _ = tt.temporal_backtrack(pt, bt_t, torch.as_tensor(jump), adm.levels,
                                       torch.tensor(cap, dtype=torch.int32))
        assert torch.equal(it0, ut)


def test_chunk_is_a_schedule_knob_only():
    """Any chunk length gives the same tables up to the association of the
    sums (tests/test_parallel.py:226-235, rtol 1e-12)."""
    ref = _tables_both("small")[-1].numpy()
    for K in (1, 2, 5, 36, 64):
        np.testing.assert_allclose(_tables_both("small", K)[-1].numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("name", ["seq16", "fishing", "heat200"])
def test_dp_solve_matches_the_plain_dp(name):
    """tests/test_parallel.py:85-100 and :196-236: Φ0 to rtol 1e-10, paths
    equal at the full budget and the halving caps."""
    adm, grad, u_old, jump, B, tau = _inputs(name, seed=3)
    g, u, J = (torch.as_tensor(a) for a in (grad, u_old, jump))
    u_s, i_s, (U, phi0, btilde) = tb.dp_solve(g, u, adm.levels, J, tau, B)
    u_t, i_t, phis = temporal_dp_solve(g, u, adm.levels, J, tau, B)
    u_l, i_l, _ = temporal_dp_solve(g, u, torch.as_tensor(adm.levels), J, tau, B)
    np.testing.assert_allclose(phis[0].T.numpy(), phi0.numpy(), rtol=1e-10)
    assert torch.equal(i_t, i_s) and torch.equal(u_t, u_s) and torch.equal(i_l, i_t)
    for cap in (B // 2, B // 4, 0):
        _, i_sc = tb.backtrack(U, phi0, btilde, adm.levels, cap)
        _, i_tc = tt.temporal_backtrack(phis, btilde, J, adm.levels, cap)
        assert torch.equal(i_tc, i_sc), cap


def _solve_pair(nt, par_kw, seed):
    x0 = rand_func(JaxLVM(nt=nt), seed=seed)
    ra = trm_solve(LVMObj(nt=nt, device="cpu"), TRMParameters(**par_kw), x0=x0)
    rb = trm_solve(LVMObj(nt=nt, device="cpu"),
                   TRMParameters(dp_backend="temporal", **par_kw), x0=x0)
    return x0, ra, rb


def test_trm_temporal_route_equals_the_default():
    """tests/test_trm.py:139-151: fishing nt=120, Δ⁰ = 0.3 — the same
    solve, and the JAX package's temporal solve."""
    par_kw = dict(beta=1e-3, p=1, delta0=0.3)
    calls = tb.build_tables_plain.calls
    x0, ra, rb = _solve_pair(120, par_kw, 5)
    assert tb.build_tables_plain.calls - calls == ra.dp_builds  # rb built no plain table
    np.testing.assert_allclose(rb.J, ra.J, rtol=1e-10)
    np.testing.assert_array_equal(rb.u, ra.u)
    assert (rb.iterations, rb.inner_steps, rb.f_evals, rb.df_evals, rb.dp_builds) == (
        ra.iterations, ra.inner_steps, ra.f_evals, ra.df_evals, ra.dp_builds)
    assert rb.J == ra.J and np.array_equal(rb.x_final, ra.x_final)
    rj = jtrm.trm_solve(JaxLVM(nt=120), jtrm.TRMParameters(dp_backend="temporal", **par_kw),
                        x0=x0)
    np.testing.assert_allclose(rb.J, rj.J, rtol=1e-12)
    np.testing.assert_array_equal(rb.u, np.asarray(rj.u))
    assert (rb.iterations, rb.inner_steps) == (rj.iterations, rj.inner_steps)


def test_trm_temporal_route_at_the_fishing_preset():
    """The preset's budget (Δ⁰ = 2, p = ∞) at nt = 256: iterations, inner
    steps and u equal to the default route, J to rtol 1e-10."""
    x0, ra, rb = _solve_pair(256, dict(beta=1e-4, delta0=2.0, p=np.inf), 0)
    assert (rb.iterations, rb.inner_steps) == (ra.iterations, ra.inner_steps)
    np.testing.assert_array_equal(rb.u, ra.u)
    np.testing.assert_allclose(rb.J, ra.J, rtol=1e-10)


def test_device_loop_temporal_runs_the_ordinary_route():
    par = TRMParameters(beta=1e-3, p=1, delta0=0.3)
    x0 = rand_func(JaxLVM(nt=80), seed=2)
    ra = trm_solve_device(LVMObj(nt=80, device="cpu"), par, x0=x0)
    rb = trm_solve_device(LVMObj(nt=80, device="cpu"),
                          TRMParameters(beta=1e-3, p=1, delta0=0.3, dp_backend="temporal"),
                          x0=x0)
    rc = trm_solve_device(LVMObj(nt=80, device="cpu"), par, x0=x0, dp_backend="temporal")
    for r in (rb, rc):
        for field in ra._fields:
            np.testing.assert_array_equal(np.asarray(getattr(r, field)),
                                          np.asarray(getattr(ra, field)), err_msg=field)


def test_dp_route_takes_temporal_on_both_devices():
    for dev in (torch.device("cpu"), torch.device("cuda")):
        assert dp_route("temporal", None, dev) == "temporal"
        assert dp_route("temporal", False, dev) == "temporal"
    for dev in (torch.device("cpu"), torch.device("cuda")):
        assert dp_route("sharded", None, dev) == "sharded"


def _json_line(out):
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def test_cli_temporal_prints_the_default_result(capsys):
    base = ["fishing", "--n", "64", "--seed", "0", "--no-plot", "--no-log", "--device", "cpu"]
    lines = []
    for extra in ([], ["--dp-backend", "temporal"]):
        assert cli.main(base + extra) == 0
        lines.append(_json_line(capsys.readouterr().out))
    for key in ("J", "iterations", "f_evals", "df_evals", "converged"):
        assert lines[1][key] == lines[0][key], key


def test_nan_checks_trap_the_tables():
    """With the NaN trap on, a NaN in the stage costs reaches the tables and
    the temporal route's build raises; the kernel route checks phi0."""
    class NanGradient(LVMObj):
        def eval_df_impl(self):
            df = super().eval_df_impl()
            df[3, 1] = np.nan
            return df

    checks.enable_nan_checks()
    try:
        for backend in ("temporal", None):
            obj = NanGradient(nt=40, device="cpu")
            obj.eval_df_impl = NanGradient.eval_df_impl.__get__(obj)
            with pytest.raises(FloatingPointError, match="NaN"):
                trm_solve(obj, TRMParameters(dp_backend=backend), seed=0)
    finally:
        checks.enable_nan_checks(False)
