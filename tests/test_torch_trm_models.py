"""Port vs JAX package: the host TRM on the double-tank, Van der Pol, Fuller
and convolution problems, and the device TRM on convolution.

Host solves run on the CPU from the same seed with the presets of
tests/test_trm.py.  Integer outputs (iterations, inner steps, evaluation
counts, DP builds, accepted and final controls) must be equal; J, f and tv
are equal for the double tank, Van der Pol and Fuller, whose sweeps round as
the JAX package's (test_torch_ode_bits.py), and agree to rtol 1e-12 at
float64 for convolution, whose dense products round otherwise.  The device TRM on the convolution problem (an
objective without a state) gives the same trajectory with the speculative
trial wave as with the sequential inner loop, field for field.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mioc_tpu.models as jm  # noqa: E402
from mioc_tpu.solvers import trm as jtrm  # noqa: E402
from mioc_tpu.utils.init import rand_func  # noqa: E402
from mioc_tpu_torch import models as tm  # noqa: E402
from mioc_tpu_torch.ops import bellman as tb  # noqa: E402
from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve  # noqa: E402
from mioc_tpu_torch.solvers.trm_device import trm_solve_device  # noqa: E402

CASES = {
    "convolution": ("ConvObj", 256, dict(beta=1e-4, delta0=0.125, p=1)),
    "doubletank": ("DTMObj", 200, dict(beta=1e-5, delta0=2.0, p=np.inf)),
    "vanderpol": ("VPOObj", 512, dict(beta=0.1, delta0=1.0, p=np.inf)),
    "fuller": ("FullerObj", 500, dict(beta=1e-4, delta0=0.1, p=1)),
}
INTS = ("converged", "iterations", "inner_steps", "f_evals", "df_evals", "dp_builds")
FLOATS = ("J", "f", "tv")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CASES))
def test_host_solve_matches_jax(name):
    cls, nt, par = CASES[name]
    rj = jtrm.trm_solve(getattr(jm, cls)(nt=nt), jtrm.TRMParameters(**par), seed=0)
    calls = tb.build_tables_plain.calls, tb.backtrack_plain.calls
    rt = trm_solve(getattr(tm, cls)(nt=nt, device="cpu"), TRMParameters(**par), seed=0)
    assert rt.converged and rj.converged
    for field in INTS:
        assert getattr(rt, field) == getattr(rj, field), field
    np.testing.assert_array_equal(rt.u, np.asarray(rj.u))
    np.testing.assert_array_equal(rt.x_final, np.asarray(rj.x_final))
    for field in FLOATS:
        if name == "convolution":
            np.testing.assert_allclose(getattr(rt, field), getattr(rj, field), rtol=1e-12,
                                       err_msg=field)
        else:
            assert getattr(rt, field) == float(getattr(rj, field)), field
    assert (tb.build_tables_plain.calls - calls[0], tb.backtrack_plain.calls - calls[1]) == (
        rt.dp_builds, rt.inner_steps)


def test_conv_device_solve_speculative_equals_sequential():
    """As tests/test_trm_device.py holds for the JAX package: the wave's
    batched evaluations have the single evaluation's bits, so the trajectory
    is the sequential loop's, field for field; and it is the host loop's."""
    par = TRMParameters(**CASES["convolution"][2])
    x0 = rand_func(jm.ConvObj(nt=256), seed=3)
    seq = trm_solve_device(tm.ConvObj(nt=256, device="cpu"), par, x0=x0, speculative=False)
    spec = trm_solve_device(tm.ConvObj(nt=256, device="cpu"), par, x0=x0)
    assert bool(spec.converged)
    np.testing.assert_array_equal(spec.u, seq.u)
    np.testing.assert_array_equal(spec.x_final, seq.x_final)
    for field in INTS + FLOATS:
        assert getattr(spec, field) == getattr(seq, field), field
    host = trm_solve(tm.ConvObj(nt=256, device="cpu"), par, x0=x0)
    np.testing.assert_array_equal(spec.u, host.u)
    assert (int(spec.iterations), int(spec.inner_steps)) == (host.iterations,
                                                             host.inner_steps)
    np.testing.assert_allclose(float(spec.J), host.J, rtol=1e-12)
