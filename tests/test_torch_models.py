"""Port vs JAX package: the double-tank, Van der Pol, Fuller and convolution
objectives.

Both packages evaluate the same problems (the port's built from the JAX
objects' parameters through ``interop.objective_from_params``) at the same
seeded controls.  f agrees to rtol 1e-12 at float64; ∇f to rtol 1e-12 with
an absolute floor of 1e-12 times its largest entry (an entry that passes
near zero carries the rounding of the large terms it cancels, as for
fishing in test_torch_tv_ode.py).  Within the port, every row of a batched
evaluation has the bits of the single evaluation of that row, NaN rows
included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import mioc_tpu.models as jm  # noqa: E402
from mioc_tpu.utils.init import rand_func  # noqa: E402
from mioc_tpu_torch import interop  # noqa: E402
from mioc_tpu_torch import models as tm  # noqa: E402

RTOL = 1e-12

CASES = {
    "doubletank": ("DTMObj", dict(nt=200)),
    "vanderpol": ("VPOObj", dict(nt=400)),
    "fuller": ("FullerObj", dict(nt=300)),
    "fuller-terminal": ("FullerObj", dict(nt=300, terminal_weight=50.0)),
    "convolution": ("ConvObj", dict(nt=256)),
}
PROBLEM = {"doubletank": "doubletank", "vanderpol": "vanderpol", "fuller": "fuller",
           "fuller-terminal": "fuller", "convolution": "convolution"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(case):
    cls, kw = CASES[case]
    j = getattr(jm, cls)(**kw)
    params = {k: np.asarray(getattr(j, k)) for k in interop.PROBLEM_PARAMS[PROBLEM[case]]}
    t = interop.objective_from_params(PROBLEM[case], params, device="cpu")
    assert type(t).__name__ == cls
    return j, t


def _f_df(obj, x):
    obj.x = obj.as_control(x) if hasattr(obj, "as_control") else jnp.asarray(x)
    f = obj.eval_f_()
    obj.eval_df_()
    return f, np.asarray(obj.df)


def _close_df(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("case", list(CASES))
def test_f_df_match_jax(case):
    j, t = _pair(case)
    for seed in (0, 1):
        x = rand_func(j, seed=seed)
        fj, dj = _f_df(j, x)
        ft, dt = _f_df(t, x)
        assert np.isfinite(fj)
        np.testing.assert_allclose(ft, fj, rtol=RTOL)
        assert dt.shape == dj.shape == (t.nt, t.nx)
        _close_df(dt, dj)


def _bits(a):
    return a.view(torch.int64)


@pytest.mark.parametrize("case", list(CASES))
def test_batched_rows_bit_equal_single(case):
    """Rows of 1-, 9- and 32-row batches have the single evaluation's bits
    (f, the state cache and ∇f): the speculative wave and the multistart
    decide on them."""
    _, t = _pair(case)
    X = torch.as_tensor(np.stack([rand_func(t, seed=s) for s in range(32)]))
    singles = [t._forward_batch(X[s:s + 1]) for s in range(32)]
    f1 = torch.stack([f[0] for f, _ in singles])
    d1 = torch.stack([t._adjoint_batch(X[s:s + 1], ys)[0][0]
                      for s, (_, ys) in enumerate(singles)])
    for S in (1, 9, 32):
        f, ys = t._forward_batch(X[:S])
        assert torch.equal(_bits(f), _bits(f1[:S])), S
        if ys is not None:
            ys1 = torch.stack([y[:, 0] for _, y in singles[:S]], dim=1)
            assert torch.equal(_bits(ys), _bits(ys1)), S
        d, _ = t._adjoint_batch(X[:S], ys)
        assert torch.equal(_bits(d), _bits(d1[:S])), S


@pytest.mark.parametrize("cls", ["LVMObj", "VPOObj", "DTMObj"])
def test_user_facing_fd_jacobian_checkers(cls):
    """test_Fy/test_Fu (ODEObjective.jl:186-241): the hand-written
    Jacobians pass the forward-difference sweep, as in
    tests/test_objectives.py, and the port draws the JAX package's point."""
    t = getattr(tm, cls)(nt=64, device="cpu")
    j = getattr(jm, cls)(nt=64)
    for name in ("test_Fy", "test_Fu"):
        errs = getattr(t, name)(seed=0)
        assert errs.min() < 1e-6 and np.all(np.isfinite(errs))
        np.testing.assert_allclose(errs, getattr(j, name)(seed=0), rtol=1e-6, atol=1e-12)


def test_fd_checker_catches_wrong_jacobian():
    class BadDTM(tm.DTMObj):
        def Fy(self, y, u, i):
            return super().Fy(y, u, i) + 0.5

    assert BadDTM(nt=64, device="cpu").test_Fy(seed=0).min() > 1e-3


def test_doubletank_samples_inside_its_domain():
    """The double tank's FD point keeps y > 0 (its sqrt dynamics), and it is
    the JAX package's point."""
    t, j = tm.DTMObj(nt=64, device="cpu"), jm.DTMObj(nt=64)
    yt, ut, it = t.sample_point(np.random.default_rng(5))
    yj, uj, ij = j.sample_point(np.random.default_rng(5))
    assert bool((yt > 0).all()) and it == ij
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))


def test_conv_operators_equal_through_interop():
    """The JAX ConvObj's operators, handed over as numpy arrays, equal the
    port's own build bit for bit; installed, they give the same f."""
    j = jm.ConvObj(nt=256)
    own = tm.ConvObj(nt=256, device="cpu")
    params = {k: np.asarray(getattr(j, k)) for k in
              interop.PROBLEM_PARAMS["convolution"] + interop.CONV_OPERATORS}
    carried = interop.objective_from_params("convolution", params, device="cpu")
    for name in interop.CONV_OPERATORS:
        a, b = getattr(carried, name), getattr(own, name)
        assert a.dtype == b.dtype == torch.float64 and a.shape == b.shape
        assert torch.equal(a, b), name
    x = rand_func(j, seed=2)
    assert carried.eval_f(x) == own.eval_f(x)
    with pytest.raises(KeyError):
        interop.objective_from_params("convolution", {"nt": 8, "omega0": 1.0, "K": 0},
                                      device="cpu")


def test_vanderpol_blow_up_is_a_value_not_an_error():
    """Explicit Euler on the unstable ODE overflows on a coarse grid: f is
    non-finite and nothing raises (the TRM rejects such trials)."""
    obj = tm.VPOObj(nt=20, device="cpu")
    for mode in range(3):
        x = np.zeros((20, 3))
        x[:, mode] = 1.0
        assert not np.isfinite(obj.eval_f(x))
        obj.x = obj.as_control(x)
        obj.eval_fdf_()
        assert obj.df.shape == (20, 3)


def test_fuller_terminal_mask_is_a_select_on_the_time_index():
    t = tm.FullerObj(nt=100, terminal_weight=50.0, device="cpu")
    idx = torch.arange(100)
    mask = t._terminal_mask(idx)
    assert mask.dtype == torch.float64 and float(mask.sum()) == 5.0
    assert [t._terminal_mask(i) for i in (94, 95)] == [0.0, 1.0]
    assert torch.equal(mask, torch.tensor([t._terminal_mask(i) for i in range(100)],
                                          dtype=torch.float64))


def test_models_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in ("DTMObj", "VPOObj", "FullerObj", "ConvObj"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(tm, cls)(nt=16)


def test_gauss_legendre5_matches_jax():
    """The quadrature fallback for K integrates a polynomial of degree ≤ 9
    exactly, as the JAX package's does."""
    from mioc_tpu.models.convolution import gauss_legendre5 as jgl5
    from mioc_tpu_torch.models.convolution import gauss_legendre5

    def poly(t):
        return 3 * t ** 9 - t ** 4 + 2.0

    assert gauss_legendre5(poly, -0.5, 1.5) == jgl5(poly, -0.5, 1.5)
    np.testing.assert_allclose(gauss_legendre5(poly, -1.0, 1.0), 4.0 - 0.4, rtol=1e-12)
