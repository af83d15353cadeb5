"""Port vs JAX package: TV functional and the fishing ODE objective.

f and ∇f agree with ``mioc_tpu`` to rounding at float64 (rtol 1e-12); ∇f
is compared with an absolute floor of 1e-12 times its largest entry
besides: an entry that passes near zero carries the rounding of the large
terms it cancels.  Since the fishing sweeps round as XLA's CPU code does
(fused multiply-adds, windowed sums: ``ops/xla_order.py``), at the default
parameters f, ∇f, the states and the adjoints are also held bit-equal to
the JAX package's, for admissible and relaxed controls.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from mioc_tpu.models import LVMObj as JaxLVM  # noqa: E402
from mioc_tpu.ops.tv import tv_p as jax_tv  # noqa: E402
from mioc_tpu.utils.init import rand_func  # noqa: E402
from mioc_tpu_torch import interop  # noqa: E402
from mioc_tpu_torch.models import LVMObj  # noqa: E402
from mioc_tpu_torch.objectives.ode import ODEObjective  # noqa: E402
from mioc_tpu_torch.ops.tv import tv_p  # noqa: E402

RTOL = 1e-12


@pytest.mark.parametrize("p", [1, 2, np.inf])
@pytest.mark.parametrize("kind", ["levels", "normal"])
def test_tv_p_matches_jax(p, kind):
    rng = np.random.default_rng(4)
    if kind == "levels":
        u = np.eye(3)[rng.integers(0, 3, size=300)]
    else:
        u = rng.normal(size=(300, 2))
    np.testing.assert_allclose(float(tv_p(torch.as_tensor(u), p)),
                               float(jax_tv(jnp.asarray(u), p)), rtol=RTOL)


def test_tv_p_edge_cases():
    assert float(tv_p(None, 1)) == 0.0
    assert float(tv_p(torch.ones((1, 3), dtype=torch.float64), np.inf)) == 0.0
    with pytest.raises(ValueError):
        tv_p(torch.ones((4, 2)), 0)


def _params(obj):
    return {k: np.asarray(getattr(obj, k)) for k in interop.LVM_PARAMS}


def _f_df(obj, x):
    obj.x = obj.as_control(x) if hasattr(obj, "as_control") else jnp.asarray(x)
    f = obj.eval_f_()
    obj.eval_df_()
    return f, np.asarray(obj.df)


@pytest.mark.parametrize("nt,seed", [(64, 0), (300, 1), (1024, 2)])
def test_fishing_f_df_match_jax(nt, seed):
    j = JaxLVM(nt=nt)
    t = LVMObj(nt=nt, device="cpu")
    x = rand_func(j, seed=seed)
    fj, dfj = _f_df(j, x)
    ft, dft = _f_df(t, x)
    np.testing.assert_allclose(ft, fj, rtol=RTOL)
    np.testing.assert_allclose(dft, dfj, rtol=RTOL, atol=RTOL * np.abs(dfj).max())
    np.testing.assert_allclose(t.state.numpy(), np.asarray(j.state), rtol=RTOL)
    np.testing.assert_allclose(t.adjoint.numpy(), np.asarray(j.adjoint), rtol=RTOL)
    assert (t.f_evals, t.df_evals) == (j.f_evals, j.df_evals) == (1, 1)


@pytest.mark.parametrize("nt", [32, 48, 64, 120, 240, 256, 300, 1024, 1200])
def test_fishing_sweeps_have_the_jax_bits(nt):
    j, t = JaxLVM(nt=nt), LVMObj(nt=nt, device="cpu")
    for seed in range(3):
        x = (rand_func(j, seed=seed) if seed != 1
             else np.random.default_rng(nt).random((nt, 3)))  # a relaxed control
        fj, dfj = _f_df(j, x)
        ft, dft = _f_df(t, x)
        assert ft == fj
        for a, b in ((dft, dfj), (t.state.numpy(), j.state), (t.adjoint.numpy(), j.adjoint)):
            np.testing.assert_array_equal(np.asarray(a).view(np.int64),
                                          np.asarray(b).view(np.int64))


def test_fishing_carried_across_nondefault_params():
    j = JaxLVM(nt=200, alpha=1.1, beta=0.9, gamma=1.05, delta=0.95, c1=0.8,
               c2=1.2, v1=(0.3, 0.1, 0.05), v2=(0.05, 0.25, 0.15),
               state0=(0.6, 0.8))
    t = interop.lvm_from_params(_params(j), device="cpu")
    assert (t.nt, t.T0, t.T1, t.tau) == (j.nt, j.T0, j.T1, j.tau)
    np.testing.assert_array_equal(t.v1, j.v1)
    adm = interop.admissible_from_arrays(j.admissible.V, j.admissible.indices,
                                         j.admissible.levels)
    np.testing.assert_array_equal(adm.levels, t.admissible.levels)
    np.testing.assert_array_equal(adm.indices, t.admissible.indices)
    x = rand_func(j, seed=7)
    fj, dfj = _f_df(j, x)
    ft, dft = _f_df(t, x)
    np.testing.assert_allclose(ft, fj, rtol=RTOL)
    np.testing.assert_allclose(dft, dfj, rtol=RTOL, atol=RTOL * np.abs(dfj).max())


def test_interop_requires_every_parameter():
    p = _params(JaxLVM(nt=10))
    del p["c2"]
    with pytest.raises(KeyError):
        interop.lvm_from_params(p, device="cpu")


def test_gradient_finite_differences():
    """τ·∇f is the exact derivative of the discrete f (∇f is the reference's
    gradient density): central differences along a random direction agree."""
    obj = LVMObj(nt=200, device="cpu")
    x = torch.as_tensor(rand_func(obj, seed=3))
    _, df = _f_df(obj, x)
    d = torch.as_tensor(np.random.default_rng(0).normal(size=x.shape))
    h = 1e-5
    fd = (obj.eval_f(x + h * d) - obj.eval_f(x - h * d)) / (2 * h)
    np.testing.assert_allclose(fd, obj.tau * float((torch.as_tensor(df) * d).sum()),
                               rtol=1e-7)


class _AutodiffLVM(LVMObj):
    """Fishing with only F and G: the Jacobians, Fyᵀλ, the per-step hooks
    and the sweeps that call them fall back to ODEObjective's torch.func
    defaults (LVMObj's own sweeps round as XLA's CPU code)."""

    _forward_batch = ODEObjective._forward_batch
    _adjoint_batch = ODEObjective._adjoint_batch
    Fy = ODEObjective.Fy
    FyT_lam = ODEObjective.FyT_lam
    Fu = ODEObjective.Fu
    Gy = ODEObjective.Gy
    Gu = ODEObjective.Gu
    step_terms = ODEObjective.step_terms
    F_step = ODEObjective.F_step
    FyT_lam_step = ODEObjective.FyT_lam_step
    G_rows = ODEObjective.G_rows
    Gy_rows = ODEObjective.Gy_rows
    df_rows = ODEObjective.df_rows


def test_autodiff_defaults_match_hand_written():
    x = rand_func(LVMObj(nt=150, device="cpu"), seed=4)
    fa, dfa = _f_df(_AutodiffLVM(nt=150, device="cpu"), x)
    fh, dfh = _f_df(LVMObj(nt=150, device="cpu"), x)
    np.testing.assert_allclose(fa, fh, rtol=RTOL)
    np.testing.assert_allclose(dfa, dfh, rtol=RTOL, atol=RTOL * np.abs(dfh).max())
    obj = LVMObj(nt=10, device="cpu")
    y, u = torch.tensor([0.4, 1.3], dtype=torch.float64), obj.x[3] + 1.0
    auto = _AutodiffLVM(nt=10, device="cpu")
    for name in ("Fy", "Fu", "Gy", "Gu"):
        np.testing.assert_allclose(getattr(auto, name)(y, u, 3).numpy(),
                                   getattr(obj, name)(y, u, 3).numpy(), rtol=1e-14)


def test_forward_batch_rows_equal_single():
    obj = LVMObj(nt=80, device="cpu")
    xs = torch.stack([torch.as_tensor(rand_func(obj, seed=s)) for s in range(3)])
    fvals, ys = obj._forward_batch_with(xs)
    assert fvals.shape == (3,) and ys.shape == (80, 3, 2)
    for k in range(3):
        f, y = obj._forward(xs[k])
        assert float(fvals[k]) == float(f)
        assert torch.equal(ys[:, k], y)


def test_time_helpers_and_float32():
    obj = LVMObj(nt=120, device="cpu", dtype=torch.float32)
    assert obj.x.dtype == torch.float32 and obj.state0.dtype == torch.float32
    assert obj.t2i(obj.i2t(17)) == 17
    np.testing.assert_allclose(obj.trange()[-1], 12.0)
    assert len(obj.trange0()) == 121
    j = JaxLVM(nt=120, dtype=jnp.float32)
    x = rand_func(j, seed=1).astype(np.float32)
    fj, _ = _f_df(j, x)
    ft, _ = _f_df(obj, x)
    np.testing.assert_allclose(ft, fj, rtol=1e-5)
