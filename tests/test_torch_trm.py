"""Port vs JAX package: the host-driven TRM, iteration by iteration.

Both solves run on the CPU from the same x0; the port takes its plain DP
there.  Integer outputs (inner steps, evaluation counts, accepted controls)
must be equal; floats agree to rtol 1e-12 (f carries the last-bit
differences of its sums, see test_torch_tv_ode.py).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mioc_tpu.models import LVMObj as JaxLVM  # noqa: E402
from mioc_tpu.solvers import trm as jtrm  # noqa: E402
from mioc_tpu.utils.init import rand_func  # noqa: E402
from mioc_tpu_torch.models import LVMObj  # noqa: E402
from mioc_tpu_torch.ops import bellman as tb  # noqa: E402
from mioc_tpu_torch.solvers.trm import TRM, TRMParameters, trm_solve  # noqa: E402

GOLDEN_FISHING = 0.9398946251530471  # README.md:45-50 of the reference
PRESET = dict(beta=1e-4, delta0=2.0, p=np.inf)  # fishing preset (registry.py)


def _lines(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.parametrize("nt,params,seed", [(256, PRESET, 0), (300, {}, 1)])
def test_per_iteration_parity(tmp_path, nt, params, seed):
    x0 = rand_func(JaxLVM(nt=nt), seed=seed)
    pj, pt = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    rj = jtrm.trm_solve(JaxLVM(nt=nt), jtrm.TRMParameters(metrics_path=pj, **params),
                        x0=x0)
    rt = trm_solve(LVMObj(nt=nt, device="cpu"),
                   TRMParameters(metrics_path=pt, **params), x0=x0)
    lj, lt = _lines(pj), _lines(pt)
    assert len(lt) == len(lj) == rj.iterations == rt.iterations
    for a, b in zip(lj, lt):
        assert b["iteration"] == a["iteration"]
        for key in ("inner", "f_evals", "df_evals"):
            assert b[key] == a[key], (key, a, b)
        for key in ("J", "f", "tv", "pred", "ared"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-12, err_msg=key)
        assert set(b) == set(a)
    assert rt.converged == rj.converged
    assert (rt.inner_steps, rt.dp_builds, rt.f_evals, rt.df_evals) == (
        rj.inner_steps, rj.dp_builds, rj.f_evals, rj.df_evals)
    np.testing.assert_array_equal(rt.u, np.asarray(rj.u))
    np.testing.assert_array_equal(rt.x_final, np.asarray(rj.x_final))
    np.testing.assert_allclose(rt.J, rj.J, rtol=1e-12)
    np.testing.assert_allclose(rt.tv, rj.tv, rtol=1e-12)


def test_fishing_golden():
    """Default fishing solve (nt=1200) lands at or below the reference's
    published objective; from seed 0 the JAX package reaches
    J = 0.9398471719820233 in 50 iterations on the CPU at float64."""
    calls = tb.build_tables_plain.calls
    res = trm_solve(LVMObj(device="cpu"), TRMParameters(), seed=0)
    assert res.converged
    assert 0.93 <= res.J <= GOLDEN_FISHING + 2e-4
    np.testing.assert_allclose(res.J, 0.9398471719820233, rtol=1e-12)
    assert res.iterations == 50
    assert tb.build_tables_plain.calls - calls == res.dp_builds == res.iterations
    assert set(res.timings) == {"dp", "backtrack", "f", "df"}


def test_checkpoint_write_and_resume(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    r1 = trm_solve(LVMObj(nt=100, device="cpu"),
                   TRMParameters(checkpoint_path=path, maxiter=3), seed=0)
    from mioc_tpu_torch.utils.io import load_checkpoint

    ck = load_checkpoint(path)
    assert ck["u"].shape == (100, 3)
    assert int(ck["iteration"]) == r1.iterations == 3
    r2 = trm_solve(LVMObj(nt=100, device="cpu"), TRMParameters(resume_from=path))
    assert r2.converged
    assert r2.J <= r1.J + 1e-12


def test_default_device_without_cuda_raises(monkeypatch):
    """Omitting ``device`` means the card; without CUDA that raises and
    says to pass device='cpu' — it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LVMObj(nt=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LVMObj(nt=10, device="cuda")


@pytest.mark.parametrize("par", [dict(dp_backend="scan"), dict(dp_backend="pallas"),
                                 dict(use_pallas=False), dict(use_pallas=True),
                                 dict(use_pallas=False, dp_backend="pallas")],
                         ids=["scan", "pallas", "use_pallas-False", "use_pallas-True",
                              "backend-first"])
def test_jax_dp_spellings_are_taken(par):
    """The JAX package's DP spellings (``dp_backend="scan"|"pallas"``,
    ``use_pallas``) solve on the CPU, every one to the default route's
    result: the plain versions there either way."""
    kw = dict(beta=1e-4, delta0=2.0, p=np.inf)
    ref = trm_solve(LVMObj(nt=48, device="cpu"), TRMParameters(**kw), seed=0)
    got = trm_solve(LVMObj(nt=48, device="cpu"), TRMParameters(**kw, **par), seed=0)
    assert (got.iterations, got.inner_steps, got.J) == (ref.iterations, ref.inner_steps,
                                                        ref.J)
    np.testing.assert_array_equal(got.u, ref.u)
    assert list(TRMParameters.__dataclass_fields__).index("use_pallas") == list(
        jtrm.TRMParameters.__dataclass_fields__).index("use_pallas")


def test_dp_route_rule():
    """``pallas``, True or neither: the device's route; ``scan`` or False:
    the plain versions, refused for the card; ``dp_backend`` first."""
    from mioc_tpu_torch.solvers.trm import dp_route

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for backend, use, want in ((None, None, "pallas"), (None, True, "pallas"),
                               ("pallas", None, "pallas"), ("pallas", False, "pallas"),
                               (None, False, "scan"), ("scan", True, "scan")):
        assert dp_route(backend, use, cpu) == want
        if want == "pallas":
            assert dp_route(backend, use, cuda) == want
        else:
            with pytest.raises(ValueError, match="plain versions"):
                dp_route(backend, use, cuda)
    with pytest.raises(ValueError, match="Unknown dp_backend"):
        dp_route("nope", None, cpu)


@pytest.mark.parametrize("backend", ["sharded"])
def test_unported_backends_raise(backend):
    """``"sharded"`` once raised; it runs now, by default in a world of one
    with every rank on the level axis, and its solve is the scan route's;
    an unknown name still raises."""
    from mioc_tpu_torch.parallel import make_device_mesh

    par = dict(beta=1e-4, delta0=2.0, p=np.inf)
    ref = trm_solve(LVMObj(nt=20, device="cpu"), TRMParameters(**par, dp_backend="scan"), seed=3)
    mesh = make_device_mesh(batch=1, level=1, device_type="cpu")
    for kw in (dict(dp_backend=backend), dict(dp_backend=backend, mesh=mesh)):
        got = trm_solve(LVMObj(nt=20, device="cpu"), TRMParameters(**par, **kw), seed=3)
        assert (got.J, got.iterations, got.inner_steps, got.dp_builds) == (
            ref.J, ref.iterations, ref.inner_steps, ref.dp_builds)
        np.testing.assert_array_equal(got.u, ref.u)
        np.testing.assert_array_equal(got.x_final, ref.x_final)
    with pytest.raises(ValueError):
        trm_solve(LVMObj(nt=20, device="cpu"), TRMParameters(dp_backend="nope"))


def test_trm_float_api_debug_checks_and_metrics(tmp_path):
    path = str(tmp_path / "m.jsonl")
    J = TRM(LVMObj(nt=200, device="cpu"),
            TRMParameters(debug_checks=True, metrics_path=path), seed=0)
    assert isinstance(J, float) and 0.9 < J < 1.5
    assert {"iteration", "J", "f_evals", "dp_s", "f_s", "df_s"} <= set(_lines(path)[0])


def test_trm_rejects_bad_objectives():
    obj = LVMObj(nt=20, device="cpu")
    obj.admissible = None
    with pytest.raises(ValueError):
        trm_solve(obj, TRMParameters())
    with pytest.raises(AssertionError):
        trm_solve(LVMObj(nt=20, device="cpu"), TRMParameters(),
                  x0=np.full((20, 3), 0.5))


def test_profile_dir_writes_trace(tmp_path):
    res = trm_solve(LVMObj(nt=40, device="cpu"),
                    TRMParameters(profile_dir=str(tmp_path), maxiter=1), seed=0)
    assert res.iterations == 1
    assert (tmp_path / "trm_trace.json").stat().st_size > 0
