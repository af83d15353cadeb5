"""Port vs JAX package: the ODE sweeps' bits under every ``sweep_unroll``.

The bundled ODE models round as the JAX package's compiled CPU sweeps do
(``mioc_tpu_torch/ops/xla_order.py``); where a step's rounding depends on
its place in the unrolled ``lax.scan``, the port reads ``sweep_unroll``
(``objectives/ode.py::scan_rules``).  On the CPU at float64 the states, f,
∇f and the adjoints equal the JAX package's bit for bit for the double
tank, Van der Pol and Fuller at nt ∈ {32, 48, 57, 240, 1024} and unroll ∈
{1, 2, 4, 8}, and for fishing and mixed fishing at unroll 1, 2 and 4 (unroll
8, their default, is held in ``test_torch_tv_ode.py`` and
``test_torch_mixed.py``).  Van der Pol overflows on the coarse grids for
some controls: there NaN stands where the JAX package has NaN (the sign bit
of a NaN is not compared) and every other entry is bit-equal.  Also: the
known scan-remainder cases, where the bits differ, with their tolerance;
the scan-unroll keywords of ``ODEObjective`` and ``build_tables``, batched
rows bit-equal to single rows, and the correctly rounded square root.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import mioc_tpu.models as jm  # noqa: E402
from mioc_tpu.ops import bellman as jbellman  # noqa: E402
from mioc_tpu.utils.init import rand_func  # noqa: E402
from mioc_tpu_torch import interop  # noqa: E402
from mioc_tpu_torch import models as tm  # noqa: E402
from mioc_tpu_torch.objectives.ode import ODEObjective, scan_rules  # noqa: E402
from mioc_tpu_torch.ops import bellman as tbellman  # noqa: E402
from mioc_tpu_torch.ops import xla_order  # noqa: E402

NTS = (32, 48, 57, 240, 1024)
UNROLLS = (1, 2, 4, 8)
# Scan lengths nt − 1 of every remainder modulo 8, and so modulo 4 and 2.
REMAINDER_NTS = tuple(range(33, 41))
# (model, nt, unroll) where a remainder rounds a carried λ otherwise
# (test_scan_remainder_cases_agree_to_rounding).
REMAINDER_EXCEPTIONS = {("LVMObj", 39, 8), ("LVMMixedObj", 40, 4), ("VPOObj", 39, 8)}
MODELS = ("DTMObj", "VPOObj", "FullerObj")
# The registry names of the models (interop.PROBLEM_PARAMS).
NAMES = {"DTMObj": "doubletank", "VPOObj": "vanderpol", "FullerObj": "fuller",
         "LVMMixedObj": "mixed"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    """int64 view with every NaN the same: NaN's sign bit and payload are
    not part of the claim."""
    a = np.array(a, dtype=np.float64)
    b = a.view(np.int64).copy()
    b[np.isnan(a)] = 0x7FF8000000000000
    return b


def _controls(obj, nt):
    """Two random admissible controls and, for the integer-only models, a
    relaxed one."""
    xs = [rand_func(obj, seed=0), rand_func(obj, seed=2)]
    if obj.nu == 0:
        xs.append(np.random.default_rng(nt).random((nt, obj.nx)))
    return xs


def _model(pkg, cls, nt, unroll, **kw):
    """``cls`` of ``pkg`` at ``unroll``; ``"FullerT"`` is Fuller with the
    soft terminal condition (``terminal_weight=50``)."""
    if cls == "FullerT":
        cls, kw = "FullerObj", {**kw, "terminal_weight": 50.0}
    obj = getattr(pkg, cls)(nt=nt, **kw)
    obj.sweep_unroll = unroll
    obj._build()
    return obj


def _jax(cls, nt, unroll):
    return _model(jm, cls, nt, unroll)


def _port(cls, nt, unroll):
    return _model(tm, cls, nt, unroll, device="cpu")


def _eval(obj, x):
    obj.x = obj.as_control(x) if hasattr(obj, "as_control") else jnp.asarray(x)
    f = obj.eval_f_()
    obj.eval_df_()
    state = obj.state.numpy() if isinstance(obj.state, torch.Tensor) else obj.state
    adjoint = obj.adjoint.numpy() if isinstance(obj.adjoint, torch.Tensor) else obj.adjoint
    return f, np.asarray(obj.df), np.asarray(state), np.asarray(adjoint)


def _assert_same_bits(cls, nt, unroll):
    j, t = _jax(cls, nt, unroll), _port(cls, nt, unroll)
    assert t.sweep_unroll == j.sweep_unroll == unroll
    for x in _controls(j, nt):
        for a, b, what in zip(_eval(t, x), _eval(j, x), ("f", "df", "state", "adjoint")):
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{cls} {what}")


@pytest.mark.parametrize("unroll", UNROLLS)
@pytest.mark.parametrize("nt", NTS)
@pytest.mark.parametrize("cls", MODELS)
def test_sweeps_have_the_jax_bits(cls, nt, unroll):
    _assert_same_bits(cls, nt, unroll)


@pytest.mark.parametrize("unroll", (1, 2, 4))
@pytest.mark.parametrize("nt", NTS)
@pytest.mark.parametrize("cls", ("LVMObj", "LVMMixedObj"))
def test_fishing_sweeps_have_the_jax_bits_at_other_unrolls(cls, nt, unroll):
    _assert_same_bits(cls, nt, unroll)


def _assert_agree_to_rounding(got, want):
    """f equal; the states, λ and ∇f to rtol 1e-12 (beside an absolute
    1e-12 of their largest entry), in at most 6 entries not bit-equal."""
    assert _bits(got[0]) == _bits(want[0])
    for a, b in zip(got[1:], want[1:]):
        scale = np.max(np.abs(b), initial=0.0, where=np.isfinite(b))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * scale)
        assert int((_bits(a) != _bits(b)).sum()) <= 6


@pytest.mark.parametrize("unroll", UNROLLS)
@pytest.mark.parametrize("nt", REMAINDER_NTS)
@pytest.mark.parametrize("cls", MODELS + ("LVMObj", "LVMMixedObj", "FullerT"))
def test_every_scan_remainder_has_the_jax_bits(cls, nt, unroll):
    """nt = 33 … 40: every remainder of the adjoint scan at every unroll.
    In the known exceptions (``REMAINDER_EXCEPTIONS``, the models'
    docstrings) some control differs, and every control agrees to
    rounding."""
    if (cls, nt, unroll) not in REMAINDER_EXCEPTIONS:
        _assert_same_bits(cls, nt, unroll)
        return
    j, t = _jax(cls, nt, unroll), _port(cls, nt, unroll)
    evals = [(_eval(t, x), _eval(j, x)) for x in _controls(j, nt)]
    for got, want in evals:
        _assert_agree_to_rounding(got, want)
    assert any((_bits(a) != _bits(b)).any()
               for got, want in evals for a, b in zip(got, want))


@pytest.mark.parametrize("nt,unroll", [(33, 32), (40, 64)])
@pytest.mark.parametrize("cls", MODELS + ("LVMObj", "LVMMixedObj", "FullerT"))
def test_straight_code_scans_have_the_jax_bits(cls, nt, unroll):
    """An unroll ≥ nt − 1 leaves no loop: the scan is straight code, the
    same program for every such unroll, with its own rules
    (``"straight"``)."""
    _assert_same_bits(cls, nt, unroll)


@pytest.mark.parametrize("cls,nt,seed", [("LVMObj", 39, 0), ("LVMMixedObj", 40, 2),
                                         ("DTMObj", 200, 1), ("VPOObj", 32, 4)])
def test_scan_remainder_cases_agree_to_rounding(cls, nt, seed):
    """The known cases where the port's bits differ from the JAX package's
    (the models' docstrings): the steps left after the scan's last trip run
    as straight code that XLA fuses with its neighbours.  f is equal; the
    states, λ and ∇f agree to rtol 1e-12 (beside an absolute 1e-12 of their
    largest entry), in a few entries of the first steps only.  Mixed
    fishing's case is at unroll 4, the others at 8."""
    unroll = 4 if cls == "LVMMixedObj" else 8
    j, t = _jax(cls, nt, unroll), _port(cls, nt, unroll)
    x = rand_func(j, seed=seed)
    got, want = _eval(t, x), _eval(j, x)
    assert any((_bits(a) != _bits(b)).any() for a, b in zip(got, want))
    _assert_agree_to_rounding(got, want)


@pytest.mark.parametrize("nt", (5, 7))
@pytest.mark.parametrize("cls", MODELS + ("LVMObj", "LVMMixedObj", "FullerT"))
def test_short_grids_build_and_agree_to_rounding(cls, nt):
    """Below nt = 32 no bits are claimed (the models' docstrings): at the
    default unroll the scans are straight code (``scan_unroll() ≥ nt − 1``),
    which every model takes; f and ∇f are finite and agree with the JAX
    package's to rtol 1e-12."""
    j, t = _jax(cls, nt, 8), _port(cls, nt, 8)
    assert (t.sweep_unroll, t.scan_unroll()) == (8, nt)
    for seed in (0, 2):
        x = rand_func(j, seed=seed)
        got, want = _eval(t, x), _eval(j, x)
        assert np.isfinite(got[0]) and np.all(np.isfinite(got[1]))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * np.abs(b).max())


@pytest.mark.parametrize("cls", MODELS + ("LVMObj", "LVMMixedObj"))
def test_batched_rows_equal_single_rows(cls):
    """``_batched_sweeps_bitexact``: every row of a batch has the bits of
    its single sweep, at any batch size and unroll."""
    nt = 57
    for unroll in (2, 8):
        t = _port(cls, nt, unroll)
        assert t._batched_sweeps_bitexact
        X = torch.as_tensor(np.stack([rand_func(t, seed=s) for s in range(5)]))
        f, ys = t._forward_batch(X[[0, 3, 1, 4, 2, 0]])
        df, lam = t._adjoint_batch(X[[0, 3, 1, 4, 2, 0]], ys)
        for r, s in enumerate((0, 3, 1, 4, 2, 0)):
            f1, y1 = t._forward(X[s])
            d1, l1 = t._adjoint(X[s], y1)
            for a, b in ((f[r], f1), (ys[:, r], y1), (df[r], d1), (lam[r], l1)):
                np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))


# -- the scan-unroll keywords --------------------------------------------------

class _Decay(ODEObjective):
    """A generic one-state model (torch.func Jacobians, generic sweeps)."""

    nx = 1

    def __init__(self, nt=20, **kw):
        super().__init__(T0=0.0, T1=1.0, nt=nt, state0=[1.0], device="cpu", **kw)

    def F(self, y, u, i):
        return -y * (1.0 + u)

    def G(self, y, u, i):
        return (y * y).sum() + (u * u).sum()


def test_ode_objective_takes_sweep_unroll_at_the_jax_position():
    assert _Decay().sweep_unroll == 8
    assert _Decay(dtype=torch.float64, sweep_unroll=3).sweep_unroll == 3
    # Stored as given, clamped to 1 … nt where the sweeps read it (as JAX).
    t = _Decay(nt=5, sweep_unroll=16)
    assert (t.sweep_unroll, t.scan_unroll()) == (16, 5)
    t = _Decay(sweep_unroll=0)
    assert (t.sweep_unroll, t.scan_unroll()) == (0, 1)
    # The generic sweeps' values do not depend on it.
    x = torch.as_tensor(np.random.default_rng(0).random((20, 1)))
    f1, ys1 = _Decay(sweep_unroll=1)._forward(x)
    f8, ys8 = _Decay(sweep_unroll=8)._forward(x)
    assert torch.equal(f1, f8) and torch.equal(ys1, ys8)


@pytest.mark.parametrize("cls", MODELS + ("LVMObj", "LVMMixedObj"))
def test_default_unroll_gives_the_unroll_8_bits(cls):
    """The default is the JAX package's (8), and an object switched to 2 and
    back to 8 gives the default's bits."""
    t = getattr(tm, cls)(nt=240, device="cpu")
    assert t.sweep_unroll == 8
    x = torch.as_tensor(rand_func(t, seed=4))
    f, ys = t._forward(x)
    df, _ = t._adjoint(x, ys)
    t.sweep_unroll = 2
    t._build()
    t.sweep_unroll = 8
    t._build()
    f2, ys2 = t._forward(x)
    df2, _ = t._adjoint(x, ys2)
    for a, b in ((f, f2), (ys, ys2), (df, df2)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b.numpy()))


@pytest.mark.parametrize("cls", ("DTMObj", "VPOObj", "LVMObj", "LVMMixedObj"))
@pytest.mark.parametrize("unroll", (3, 5, 16))
def test_unsupported_unroll_raises(cls, unroll):
    t = getattr(tm, cls)(nt=64, device="cpu")
    t.sweep_unroll = unroll
    with pytest.raises(ValueError, match=f"sweep_unroll={unroll}"):
        t._build()


def test_fuller_reproduces_any_unroll():
    """No Fuller step's rounding depends on its place in the scan."""
    _assert_same_bits("FullerObj", 57, 3)


@pytest.mark.parametrize("nt", NTS)
def test_fuller_terminal_weight_has_the_jax_bits(nt):
    """The soft terminal condition: G's masked term and G_y's masked
    product round as XLA's (the latter by its place in the scan), at every
    unroll the tests hold; another unroll is refused."""
    for unroll in UNROLLS:
        j, t = _jax("FullerT", nt, unroll), _port("FullerT", nt, unroll)
        for seed in (0, 1):
            x = rand_func(j, seed=seed)
            for a, b in zip(_eval(t, x), _eval(j, x)):
                np.testing.assert_array_equal(_bits(a), _bits(b))
    t.sweep_unroll = 3
    with pytest.raises(ValueError, match="sweep_unroll=3"):
        t._build()


@pytest.mark.parametrize("cls", MODELS + ("LVMMixedObj", "LVMObj"))
def test_interop_carries_sweep_unroll(cls):
    j = _jax(cls, 48, 2)
    params = {k: getattr(j, k) for k in interop.PROBLEM_PARAMS[NAMES.get(cls, "fishing")]}
    params["sweep_unroll"] = j.sweep_unroll
    if cls == "LVMObj":
        t = interop.lvm_from_params(params, device="cpu")
    else:
        t = interop.objective_from_params(NAMES[cls], params, device="cpu")
    assert t.sweep_unroll == 2
    x = rand_func(j, seed=1)
    for a, b in zip(_eval(t, x), _eval(j, x)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_build_tables_takes_unroll_at_the_jax_position():
    rng = np.random.default_rng(3)
    nt, L, B = 30, 4, 6
    stage = rng.random((nt, L))
    btilde = rng.integers(0, 2, size=(nt, L)).astype(np.float64)
    jump = rng.integers(0, 3, size=(L, L)).astype(np.float64)
    np.fill_diagonal(jump, 0)
    args = [torch.as_tensor(a) for a in (stage, btilde, jump)]
    U4, phi4 = tbellman.build_tables(*args, B, None, 4)
    for unroll in (1, 2, 8):
        U, phi = tbellman.build_tables(*args, B, None, unroll)
        assert torch.equal(U, U4) and torch.equal(phi, phi4)
        Uj, phij = jbellman.build_tables(jnp.asarray(stage), jnp.asarray(btilde),
                                         jnp.asarray(jump), B, None, unroll)
        np.testing.assert_array_equal(U.numpy(), np.asarray(Uj))
        np.testing.assert_array_equal(phi.numpy(), np.asarray(phij))


# -- the helpers ---------------------------------------------------------------

def test_scan_rules_follow_the_jax_split():
    table = {8: {"body": "ab" * 4, 3: "xyz", "rest": "r"},
             "straight": {2: "st", "rest": "s"}}
    assert scan_rules(table, 19, 8) == "ab" * 8 + "xyz"
    assert scan_rules(table, 21, 8) == "ab" * 8 + "rrrrr"
    # One trip or none: no loop, the same straight code for every unroll.
    assert scan_rules(table, 8, 8) == "ssssssss"
    assert scan_rules(table, 3, 8) == "sss"
    assert scan_rules(table, 2, 8) == scan_rules(table, 2, 5) == "st"
    table["straight"]["last"] = "l"
    assert scan_rules(table, 5, 64) == "ssssl"
    with pytest.raises(KeyError):
        scan_rules(table, 19, 4)


def test_sqrt_is_correctly_rounded():
    """PyTorch's CPU sqrt of float64 misses the nearest double for some
    inputs (``sqrt(2.0)``); ``xla_order.sqrt`` does not."""
    rng = np.random.default_rng(11)
    x = np.concatenate([[2.0, 0.0, -0.0, np.inf, 1e-300, 1e300],
                        rng.random(200000) * 4.0, np.exp(rng.normal(size=50000) * 40)])
    np.testing.assert_array_equal(xla_order.sqrt(torch.as_tensor(x)).numpy().view(np.int64),
                                  np.sqrt(x).view(np.int64))
    assert float(xla_order.sqrt(torch.tensor(2.0, dtype=torch.float64))) == 2.0 ** 0.5
    xla_order._SQRT_RN.pop(("cpu", None), None)
    assert xla_order.sqrt_rounds("cpu") == bool(np.array_equal(
        torch.sqrt(torch.as_tensor(x)).numpy(), np.sqrt(x)))


def test_const_dot_skips_unit_coefficients():
    u = torch.as_tensor(np.random.default_rng(2).random((500, 3)))
    c = torch.tensor
    want = xla_order.fma_exact(u[:, 2], c(-2.0, dtype=torch.float64),
                               xla_order.fma_exact(u[:, 1], c(0.75, dtype=torch.float64),
                                                   -u[:, 0]))
    assert torch.equal(xla_order.const_dot(u, [-1.0, 0.75, -2.0]), want)
    assert torch.equal(xla_order.const_dot(u, [1.0, -1.0, 0.5]),
                       xla_order.fma_exact(u[:, 2], c(0.5, dtype=torch.float64),
                                           u[:, 0] - u[:, 1]))
