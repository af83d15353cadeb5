"""Port vs JAX package: the batched multistart on the large-mesh heat engines.

``multistart_solve_device`` on ``HeatObj(solver="mg")`` with the banded
engine (speculative and sequential) and the ELL engine (sequential: its
batched rows are not bit-stable, ``_batched_sweeps_bitexact = False``), at
the multigrid hierarchies refined once and twice (N = 41 and 145 P2 dofs),
nt = 20, mg-CG 8, three starts from ``rand_func`` seeds 0–2, the heat
preset.  Per start the port takes the JAX package's decisions: iterations,
inner steps, f and ∇f evaluations and the accepted control ``u`` equal, J
to rtol 1e-12 (the sparse products round otherwise in the last bits,
test_torch_sparse.py); on banded the speculative wave equals the sequential
loop field for field; and a start equals its own single
``trm_solve_device`` (start 2, the longest; a single solve of each start
would double the file's time).  The same
path at 8321 dofs runs on the card in ``chip_smoke.py`` (``heat_large``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mioc_tpu.models import heat as jheat  # noqa: E402
from mioc_tpu.solvers import trm as jtrm  # noqa: E402
from mioc_tpu.solvers import trm_device as jdev  # noqa: E402
from mioc_tpu.utils.init import rand_func  # noqa: E402
from mioc_tpu_torch.models import heat as theat  # noqa: E402
from mioc_tpu_torch.solvers.trm import TRMParameters  # noqa: E402
from mioc_tpu_torch.solvers.trm_device import (  # noqa: E402
    DeviceTRMResult, multistart_solve_device, trm_solve_device)
from test_torch_fem import load_jax_triangulator  # noqa: E402

PRESET = dict(beta=1e-3, delta0=2.0, p=2)
FIELDS = ("iterations", "inner_steps", "f_evals", "df_evals")
CASES = [("banded", 1), ("banded", 2), ("ell", 1), ("ell", 2)]
_RUNS = {}


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


def _runs(fmt, refinements):
    """The JAX package's multistart and the port's, sequential and (banded)
    speculative, with the port's objective and the starts."""
    key = (fmt, refinements)
    if key not in _RUNS:
        kw = dict(solver="mg", cg_iters=8, sparse_format=fmt)
        jo = jheat.HeatObj(nt=20, mesh_hierarchy=jheat.construct_mesh_hierarchy(
            refinements=refinements), **kw)
        to = theat.HeatObj(nt=20, mesh_hierarchy=theat.construct_mesh_hierarchy(
            refinements=refinements), device="cpu", **kw)
        x0s = np.stack([rand_func(jo, seed=s) for s in range(3)])
        out = {"obj": to, "x0s": x0s,
               "jax": jdev.multistart_solve_device(jo, jtrm.TRMParameters(**PRESET), x0s,
                                                   speculative=False),
               False: multistart_solve_device(to, TRMParameters(**PRESET), x0s,
                                              speculative=False)}
        if fmt == "banded":
            out[True] = multistart_solve_device(to, TRMParameters(**PRESET), x0s,
                                                speculative=True)
        _RUNS[key] = out
    return _RUNS[key]


@pytest.mark.parametrize("fmt,refinements", CASES)
def test_multistart_takes_the_jax_decisions(fmt, refinements):
    r = _runs(fmt, refinements)
    rt, rj = r[False], r["jax"]
    assert rt.J.shape == (3,) and bool(np.all(rt.converged == np.asarray(rj.converged)))
    for field in FIELDS:
        assert np.asarray(getattr(rt, field)).tolist() == \
            np.asarray(getattr(rj, field)).tolist(), field
    np.testing.assert_array_equal(rt.u, np.asarray(rj.u))
    np.testing.assert_allclose(np.asarray(rt.J), np.asarray(rj.J), rtol=1e-12)


@pytest.mark.parametrize("refinements", [1, 2])
def test_banded_speculative_equals_sequential(refinements):
    r = _runs("banded", refinements)
    assert r["obj"]._speculative_multistart
    for field in DeviceTRMResult._fields:
        np.testing.assert_array_equal(np.asarray(getattr(r[True], field)),
                                      np.asarray(getattr(r[False], field)), err_msg=field)


@pytest.mark.parametrize("fmt,refinements", CASES)
def test_a_start_equals_its_single_solve(fmt, refinements):
    r = _runs(fmt, refinements)
    ms, s = r[False], 2
    one = trm_solve_device(r["obj"], TRMParameters(**PRESET), x0=r["x0s"][s],
                           speculative=False)
    for field in FIELDS:
        assert int(getattr(one, field)) == int(np.asarray(getattr(ms, field))[s]), field
    np.testing.assert_array_equal(one.u, ms.u[s])
    assert float(one.J) == float(ms.J[s])
