"""Port vs JAX package: the continuous optimizers (steepest descent and
nonlinear CG with Armijo and strong-Wolfe line searches).

The same starts go through ``mioc_tpu.solvers.continuous`` and its port on
the CPU at float64.  Iteration and evaluation counts must be equal and the
iterates agree to 1e-12.  Near convergence a line search compares
differences at the level of f's rounding, so two objectives that round
apart can take different steps there: the optimizers are held against each
other on one objective's values (the JAX quadratic's, carried into the
port's protocol), and the port's own quadratic, whose products are PyTorch
matmuls, is held to the same counts where the JAX package's constants do
not sit at that level (the Wolfe searches).  On the fishing relaxation the
port's sweeps and inner products have the JAX package's bits, so even the
JAX package's failing Wolfe search at nt = 1024 is reproduced.
"""

import sys
import traceback


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from mioc_tpu.models import LVMObj as JaxLVM  # noqa: E402
from mioc_tpu.objectives.base import LazyObjective as JaxLazy  # noqa: E402
from mioc_tpu.solvers import continuous as jc  # noqa: E402
from mioc_tpu_torch import solvers  # noqa: E402
from mioc_tpu_torch.models import LVMObj  # noqa: E402
from mioc_tpu_torch.objectives.base import LazyObjective  # noqa: E402
from mioc_tpu_torch.solvers import continuous as tc  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quadratic_data(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n), rng.normal(size=n)


class JaxQuadratic(JaxLazy):
    """½ xᵀ Q x − bᵀx on a (nt, 1) variable (tests/test_aux.py's Quadratic)."""

    def __init__(self, n=12, seed=0):
        super().__init__()
        Q, b = _quadratic_data(n, seed)
        self.Q, self.b = jnp.asarray(Q), jnp.asarray(b)
        self.nt, self.nu, self.nv = n, 1, 0
        self.T0, self.T1, self.tau = 0.0, 1.0, 1.0 / n
        self.x = jnp.zeros((n, 1))

    def eval_f_impl(self, x, cache):
        v = x[:, 0]
        return 0.5 * v @ (self.Q @ v) - self.b @ v, None

    def eval_df_impl(self):
        return (self.Q @ self.x[:, 0] - self.b)[:, None]


class Quadratic(LazyObjective):
    """The port's counterpart of :class:`JaxQuadratic`."""

    def __init__(self, n=12, seed=0, device="cpu"):
        super().__init__()
        self.device, self.dtype = torch.device(device), torch.float64
        Q, b = _quadratic_data(n, seed)
        self.Q, self.b = self.as_control(Q), self.as_control(b)
        self.nt, self.nu, self.nv = n, 1, 0
        self.T0, self.T1, self.tau = 0.0, 1.0, 1.0 / n
        self.x = self.as_control(np.zeros((n, 1)))

    def eval_f_impl(self, x, cache):
        v = x[:, 0]
        return 0.5 * v @ (self.Q @ v) - self.b @ v, None

    def eval_df_impl(self):
        return (self.Q @ self.x[:, 0] - self.b)[:, None]

    def exact(self):
        return np.linalg.solve(self.Q.numpy(), self.b.numpy())


class JaxValuedQuadratic(LazyObjective):
    """The port's protocol on the JAX quadratic's values: f and ∇f are the
    JAX package's, carried across as float64 tensors."""

    def __init__(self, n=12, seed=0):
        super().__init__()
        self.device, self.dtype = torch.device("cpu"), torch.float64
        self._jax = JaxQuadratic(n, seed)
        self.nt, self.nu, self.nv = n, 1, 0
        self.T0, self.T1, self.tau = 0.0, 1.0, 1.0 / n
        self.x = self.as_control(np.zeros((n, 1)))

    def eval_f_impl(self, x, cache):
        f, _ = self._jax.eval_f_impl(jnp.asarray(x.numpy()), cache)
        return torch.tensor(float(f), dtype=torch.float64), None

    def eval_df_impl(self):
        self._jax.x = jnp.asarray(self.x.numpy())
        return torch.as_tensor(np.array(self._jax.eval_df_impl()))


def _track(opt, obj):
    """Record the iterate after every step of ``opt`` (and the start)."""
    xs = []
    update = opt.update_gradient

    def record(o):
        xs.append(np.array(o.x).copy() if not isinstance(o.x, torch.Tensor)
                  else o.x.cpu().numpy().copy())
        update(o)

    opt.update_gradient = record
    return xs


def _optimizers(mod):
    return {"sd-armijo": mod.SteepestDescent(ls=mod.ArmijoLS(lsi=mod.LSInitialLastInc())),
            "ncg-wolfe": mod.NonlinCG(ls=mod.WolfeLS()),
            "sd-wolfe": mod.SteepestDescent(ls=mod.WolfeLS())}


@pytest.mark.parametrize("name", ["sd-armijo", "ncg-wolfe", "sd-wolfe"])
def test_optimizers_on_the_quadratic_match_jax(name):
    """On the same objective values, every iterate, step policy and count."""
    (oj, jobj), (ot, tobj) = ((_optimizers(jc)[name], JaxQuadratic()),
                              (_optimizers(tc)[name], JaxValuedQuadratic()))
    oj.maxiter = ot.maxiter = 500
    xj, xt = _track(oj, jobj), _track(ot, tobj)
    fj = jc.opt_optimize(oj, jobj, np.zeros((12, 1)))
    ft = tc.opt_optimize(ot, tobj, np.zeros((12, 1)))
    assert (ot.iter, tobj.f_evals, tobj.df_evals) == (oj.iter, jobj.f_evals, jobj.df_evals)
    assert len(xt) == len(xj) == ot.iter + 1
    for a, b in zip(xt, xj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ft, fj, rtol=1e-12)
    np.testing.assert_allclose(tobj.x[:, 0].numpy(), Quadratic().exact(), atol=1e-5)
    if name == "sd-armijo":  # LSInitialLastInc carries its step across iterations
        assert ot.ls.lsi.alpha0 == oj.ls.lsi.alpha0 != 1.0


@pytest.mark.parametrize("name", ["ncg-wolfe", "sd-wolfe"])
def test_wolfe_optimizers_on_the_ports_quadratic(name):
    """The port's own quadratic (the chip check's): the JAX package's
    counts, iterates to 1e-12."""
    (oj, jobj), (ot, tobj) = ((_optimizers(jc)[name], JaxQuadratic()),
                              (_optimizers(tc)[name], Quadratic()))
    oj.maxiter = ot.maxiter = 500
    xj, xt = _track(oj, jobj), _track(ot, tobj)
    jc.opt_optimize(oj, jobj, np.zeros((12, 1)))
    tc.opt_optimize(ot, tobj, np.zeros((12, 1)))
    assert (ot.iter, tobj.f_evals, tobj.df_evals) == (oj.iter, jobj.f_evals, jobj.df_evals)
    for a, b in zip(xt, xj):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tobj.x[:, 0].numpy(), tobj.exact(), atol=1e-5)


def test_armijo_rejects_ascent_direction():
    obj = Quadratic()
    obj.x = obj.as_control(np.ones((12, 1)))
    obj.eval_fdf_()
    with pytest.raises(ValueError, match="descent"):
        tc.ArmijoLS().apply(obj, obj.df)
    with pytest.raises(ValueError, match="descent"):
        tc.WolfeLS().apply(obj, obj.df)


def test_last_inc_policy_carries_its_step():
    lsi = tc.LSInitialLastInc()
    assert lsi() == 1.0
    lsi.set_last_alpha(0.25)
    assert lsi() == 0.5
    static = tc.LSInitialStatic(alpha0=0.3)
    static.set_last_alpha(5.0)
    assert static() == 0.3


@pytest.mark.parametrize("nt", [120])
def test_steepest_descent_armijo_on_relaxed_fishing(nt):
    """tests/test_aux.py:258-276: SD-Armijo on the fishing relaxation."""
    x0 = np.full((nt, 3), 0.5)
    jobj, tobj = JaxLVM(nt=nt), LVMObj(nt=nt, device="cpu")
    fj = jc.opt_optimize(jc.SteepestDescent(ls=jc.ArmijoLS(sigma=1e-3), maxiter=8), jobj, x0)
    ft = tc.opt_optimize(tc.SteepestDescent(ls=tc.ArmijoLS(sigma=1e-3), maxiter=8), tobj, x0)
    np.testing.assert_allclose(ft, fj, rtol=1e-12)
    assert (tobj.f_evals, tobj.df_evals) == (jobj.f_evals, jobj.df_evals)
    tobj.x = tobj.as_control(x0)
    assert ft < tobj.eval_f_() and tobj.f_evals > 1


def test_nonlinear_cg_wolfe_on_relaxed_fishing():
    """At nt = 120 NonlinCG(WolfeLS(), maxiter=8) completes in both packages
    with the same f and counts (35 f and 35 ∇f evaluations)."""
    x0 = np.full((120, 3), 0.5)
    jobj, tobj = JaxLVM(nt=120), LVMObj(nt=120, device="cpu")
    fj = jc.opt_optimize(jc.NonlinCG(ls=jc.WolfeLS(), maxiter=8), jobj, x0)
    ft = tc.opt_optimize(tc.NonlinCG(ls=tc.WolfeLS(), maxiter=8), tobj, x0)
    np.testing.assert_allclose(ft, fj, rtol=1e-12)
    assert (tobj.f_evals, tobj.df_evals) == (jobj.f_evals, jobj.df_evals) == (35, 35)


def test_nonlinear_cg_wolfe_raises_like_jax_at_nt_1024():
    """At nt = 1024 the JAX package's Wolfe phase 2 fails ``a <= t <= b``
    after 32 f∇f evaluations (the ODE gradient is a density, so the Wolfe
    constants do not fit it).  Phase 2 interpolates values that differ at
    the level of f's rounding there, so the port reproduces it only with
    the JAX package's bits: the fishing sweeps' (``models/fishing.py``) and
    ``jnp.vdot``'s (``ops/xla_order.vdot``).  It fails the same assertion
    after the same evaluations."""
    x0 = np.full((1024, 3), 0.5)
    frames = []
    for mod, obj in ((jc, JaxLVM(nt=1024)), (tc, LVMObj(nt=1024, device="cpu"))):
        try:
            mod.opt_optimize(mod.NonlinCG(ls=mod.WolfeLS(), maxiter=8), obj, x0)
        except AssertionError:
            frames.append((traceback.extract_tb(sys.exc_info()[2])[-1], obj.f_evals))
        else:
            pytest.fail(f"{mod.__name__}: no AssertionError")
    (fj, nj), (ft, nt_) = frames
    assert fj.name == ft.name == "apply"
    assert fj.line == ft.line == "assert a <= t <= b"
    assert nt_ == nj == 32


def test_lazy_exports():
    for name in ("SteepestDescent", "NonlinCG", "ArmijoLS", "WolfeLS", "opt_optimize",
                 "LSInitialStatic", "LSInitialLastInc"):
        assert getattr(solvers, name) is getattr(tc, name)
    with pytest.raises(AttributeError):
        solvers.NoSuchOptimizer
