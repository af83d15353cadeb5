"""Port vs JAX package: the device-resident TRM, its speculative trial wave,
batched multistart and the batched TRM step, on the CPU.

Both packages solve the same fishing problems from the same numpy starts.
Integer outputs (accepted and candidate controls, convergence, iteration and
evaluation counts, DP builds) must be equal; J, f and tv agree to rtol 1e-12
at float64 (the port's sums are fixed pairwise folds, the JAX package's are
XLA's, so the last bits differ).  The port against itself (segmenting,
unrolling, the two wave chases, float32) must be bit-identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mioc_tpu.models import LVMObj as JaxLVM  # noqa: E402
from mioc_tpu.parallel import batch as jbatch  # noqa: E402
from mioc_tpu.solvers import trm as jtrm  # noqa: E402
from mioc_tpu.solvers import trm_device as jdev  # noqa: E402
from mioc_tpu.utils.init import rand_func  # noqa: E402
from mioc_tpu_torch.models import LVMObj  # noqa: E402
from mioc_tpu_torch.ops import bellman as tb  # noqa: E402
from mioc_tpu_torch.parallel import make_ode_trm_step, multistart_solve  # noqa: E402
from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve  # noqa: E402
from mioc_tpu_torch.solvers.trm_device import (  # noqa: E402
    make_device_trm,
    multistart_solve_device,
    trm_solve_device,
)

INTS = ("converged", "iterations", "inner_steps", "f_evals", "df_evals", "dp_builds")
FLOATS = ("J", "f", "tv")
PARAMS = {
    "p1": dict(beta=1e-3, p=1, delta0=1.0),
    "pinf": dict(beta=1e-4, p=np.inf, delta0=2.0),
}
PINF = PARAMS["pinf"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensor ops gain nothing from threads, and torch's thread pool
    competes with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _obj(nt, **kw):
    return LVMObj(nt=nt, device="cpu", **kw)


def _starts(nt, n):
    return np.stack([rand_func(JaxLVM(nt=nt), seed=s) for s in range(n)])


def assert_same(a, b, rtol=1e-12):
    """Field-wise equality of two device-TRM results (numpy or JAX)."""
    np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))
    np.testing.assert_array_equal(np.asarray(a.x_final), np.asarray(b.x_final))
    for name in INTS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)), err_msg=name)
    for name in FLOATS:
        np.testing.assert_allclose(np.asarray(getattr(a, name), np.float64),
                                   np.asarray(getattr(b, name), np.float64),
                                   rtol=rtol, atol=0, err_msg=name)


@pytest.fixture(scope="module")
def single_x0():
    return rand_func(JaxLVM(nt=240), seed=7)


@pytest.fixture(scope="module")
def jax_single(single_x0):
    """JAX device solves of the nt=240 fishing problem, per (params, wave)."""
    return {(name, spec): jdev.trm_solve_device(
        JaxLVM(nt=240), jtrm.TRMParameters(**kw), x0=single_x0, speculative=spec)
        for name, kw in PARAMS.items() for spec in (False, True)}


@pytest.fixture(scope="module")
def port_single(single_x0):
    return {(name, spec): trm_solve_device(_obj(240), TRMParameters(**kw),
                                           x0=single_x0, speculative=spec)
            for name, kw in PARAMS.items() for spec in (False, True)}


@pytest.fixture(scope="module")
def multi_x0s():
    return _starts(160, 4)


@pytest.fixture(scope="module")
def jax_multi(multi_x0s):
    return {spec: jdev.multistart_solve_device(
        JaxLVM(nt=160), jtrm.TRMParameters(**PINF), multi_x0s, speculative=spec)
        for spec in (False, True)}


@pytest.fixture(scope="module")
def port_multi(multi_x0s):
    return {spec: multistart_solve_device(_obj(160), TRMParameters(**PINF),
                                          multi_x0s, speculative=spec)
            for spec in (False, True)}


@pytest.mark.parametrize("spec", [False, True], ids=["sequential", "speculative"])
@pytest.mark.parametrize("name", list(PARAMS))
def test_device_solve_matches_jax(jax_single, port_single, name, spec):
    res = port_single[(name, spec)]
    assert res.u.shape == (240, 3) and bool(res.converged)
    assert_same(res, jax_single[(name, spec)])


@pytest.mark.parametrize("name", list(PARAMS))
def test_device_solve_matches_host_solve(port_single, single_x0, name):
    host = trm_solve(_obj(240), TRMParameters(**PARAMS[name]), x0=single_x0)
    dev = port_single[(name, True)]
    np.testing.assert_array_equal(dev.u, host.u)
    np.testing.assert_array_equal(dev.x_final, host.x_final)
    assert bool(dev.converged) == host.converged
    assert (int(dev.iterations), int(dev.inner_steps), int(dev.f_evals),
            int(dev.dp_builds)) == (host.iterations, host.inner_steps, host.f_evals,
                                    host.dp_builds)
    # The host loop computes one more gradient, after the loop.
    assert int(dev.df_evals) == host.df_evals - 1
    np.testing.assert_allclose(float(dev.J), host.J, rtol=1e-12)


def test_speculative_equals_sequential(port_single):
    for name in PARAMS:
        assert_same(port_single[(name, True)], port_single[(name, False)], rtol=0)


def test_speculative_equals_sequential_f32(single_x0):
    par = TRMParameters(**PINF)
    seq = trm_solve_device(_obj(240, dtype=torch.float32), par, x0=single_x0,
                           speculative=False)
    spec = trm_solve_device(_obj(240, dtype=torch.float32), par, x0=single_x0,
                            speculative=True)
    assert spec.J.dtype == np.float32
    assert_same(spec, seq, rtol=0)


def test_dp_routes_and_counts(single_x0):
    """Sequential inner steps chase one table set per step; the "vmap" wave
    chases K copies with the batched chase; "trials" with the trial chase."""
    par = TRMParameters(**PINF)
    counters = (tb.build_tables_plain, tb.backtrack_plain, tb.backtrack_batched_plain,
                tb.backtrack_trials_plain)
    runs = {}
    for spec, wave in ((False, "vmap"), (True, "vmap"), (True, "trials")):
        before = [f.calls for f in counters]
        run = make_device_trm(_obj(240), par, speculative=spec, wave_chase=wave)
        x0s = torch.as_tensor(single_x0[None])
        res = run.finalize(run(x0s, False))
        calls = [f.calls - b for f, b in zip(counters, before)]
        it, inner = int(res.iterations[0]), int(res.inner_steps[0])
        expect = {False: [it, inner, 0, 0], "vmap": [it, 0, it, 0],
                  "trials": [it, 0, 0, it]}[wave if spec else False]
        assert calls == expect, (spec, wave, calls)
        runs[(spec, wave)] = res
    for field in runs[(False, "vmap")]._fields:
        for key in ((True, "vmap"), (True, "trials")):
            assert torch.equal(getattr(runs[key], field),
                               getattr(runs[(False, "vmap")], field)), field
    assert run.K == 7  # δ₀ = 2, Δt = 0.05: caps 40, 20, 10, 5, 2, 1, 0


@pytest.mark.parametrize("chunk", [3, "auto"])
def test_outer_chunk_is_exact(single_x0, port_single, chunk):
    one = trm_solve_device(_obj(240), TRMParameters(**PINF), x0=single_x0,
                           outer_chunk=None)
    seg = trm_solve_device(_obj(240), TRMParameters(**PINF), x0=single_x0,
                           outer_chunk=chunk)
    assert_same(seg, one, rtol=0)
    assert_same(one, port_single[("pinf", True)], rtol=0)


@pytest.mark.parametrize("ou,iu,spec", [(2, 2, False), (4, 1, False), (3, 1, True)])
def test_unroll_is_exact(single_x0, port_single, ou, iu, spec):
    r = trm_solve_device(_obj(240), TRMParameters(**PINF), x0=single_x0,
                         speculative=spec, outer_unroll=ou, inner_unroll=iu)
    assert_same(r, port_single[("pinf", False)], rtol=0)


def test_checkpoint_and_resume(tmp_path):
    from mioc_tpu_torch.utils.io import load_checkpoint

    ck = str(tmp_path / "dev_ck.npz")
    res = trm_solve_device(_obj(160), TRMParameters(**PINF, checkpoint_path=ck),
                           seed=0, outer_chunk=4)
    snap = load_checkpoint(ck)
    assert int(snap["iteration"]) == int(res.iterations)
    np.testing.assert_array_equal(snap["u"], res.u)
    res2 = trm_solve_device(_obj(160), TRMParameters(**PINF, resume_from=ck))
    assert bool(res2.converged) and int(res2.iterations) <= 2


def test_progress_reports_the_iteration_front(port_multi, multi_x0s):
    fronts = []
    seg = multistart_solve_device(_obj(160), TRMParameters(**PINF), multi_x0s,
                                  outer_chunk=5, progress=lambda it, s: fronts.append(it))
    assert fronts == sorted(fronts) and fronts[-1] == int(np.max(seg.iterations))
    assert_same(seg, port_multi[False], rtol=0)


@pytest.mark.parametrize("spec", [False, True], ids=["sequential", "speculative"])
def test_multistart_matches_jax(jax_multi, port_multi, spec):
    res = port_multi[spec]
    assert res.u.shape == (4, 160, 3) and np.all(res.converged)
    assert_same(res, jax_multi[spec])


def test_multistart_speculative_equals_sequential_and_singles(port_multi, multi_x0s):
    assert_same(port_multi[True], port_multi[False], rtol=0)
    par = TRMParameters(**PINF)
    for s in (0, 3):
        one = trm_solve_device(_obj(160), par, x0=multi_x0s[s], speculative=False)
        for name in DEVICE_FIELDS:
            np.testing.assert_array_equal(getattr(port_multi[False], name)[s],
                                          getattr(one, name), err_msg=name)


DEVICE_FIELDS = ("u", "x_final", "J", "f", "tv") + INTS


def test_multistart_counts_batched_calls(multi_x0s):
    par = TRMParameters(**PINF)
    counters = (tb.build_tables_batched_plain, tb.backtrack_batched_plain,
                tb.backtrack_trials_plain, tb.build_tables_plain, tb.backtrack_plain)
    before = [f.calls for f in counters]
    res = multistart_solve_device(_obj(160), par, multi_x0s, speculative=True)
    calls = [f.calls - b for f, b in zip(counters, before)]
    assert calls == [int(res.iterations.max()), 0, int(res.iterations.max()), 0, 0]


@pytest.mark.parametrize("ou,iu", [(2, 2), (3, 1)])
def test_multistart_unroll_is_exact(port_multi, multi_x0s, ou, iu):
    m = multistart_solve_device(_obj(160), TRMParameters(**PINF), multi_x0s,
                                outer_unroll=ou, inner_unroll=iu)
    assert_same(m, port_multi[False], rtol=0)


def test_multistart_vmap_wave_equals_trials(port_multi, multi_x0s):
    """The S > 1 wave chases S table sets of K caps each under either
    name, one trial-wave chase per outer iteration and no copy."""
    counters = (tb.backtrack_batched_plain, tb.backtrack_trials_plain)
    before = [f.calls for f in counters]
    run = make_device_trm(_obj(160), TRMParameters(**PINF), speculative=True,
                          wave_chase="vmap")
    res = run.finalize(run(torch.as_tensor(multi_x0s), True))
    calls = [f.calls - b for f, b in zip(counters, before)]
    assert calls == [0, int(res.iterations.max())]
    np.testing.assert_array_equal(res.u.numpy(), port_multi[True].u)
    np.testing.assert_array_equal(res.inner_steps.numpy(), port_multi[True].inner_steps)


def test_wave_of_sets_equals_the_copied_tables():
    """The S > 1 wave's chase of S table sets with K caps each equals the
    batched chase of the S·K materialised copies that the wave used to
    build, row for row."""
    rng = np.random.default_rng(4)
    S, K, nt, B = 3, 5, 60, 12
    levels = np.eye(3)
    grad = torch.as_tensor(rng.normal(size=(S, nt, 3)))
    u_old = torch.as_tensor(levels[rng.integers(0, 3, size=(S, nt))])
    jump = torch.as_tensor(np.where(np.eye(3) > 0, 0.0, 1e-2))
    stage, bt = tb.stage_tables(grad, u_old, levels, 0.05)
    U, phi0 = tb.build_tables_batched(stage, bt, jump, B, 2)
    caps = torch.tensor([B, B // 2, 3, 0, -1], dtype=torch.int32)
    u_sets, idx_sets = tb.backtrack_trials(U, phi0, bt, levels, caps.expand(S, K))
    copies = [t[:, None].expand(S, K, *t.shape[1:]).reshape(S * K, *t.shape[1:])
              for t in (U, phi0, bt)]
    u_copy, idx_copy = tb.backtrack_batched(*copies, levels, caps.repeat(S))
    assert torch.equal(idx_sets.reshape(S * K, nt), idx_copy)
    assert torch.equal(u_sets.reshape(S * K, nt, 3), u_copy)


def test_ode_trm_step_matches_jax():
    nt = 120
    xs = _starts(nt, 3)
    j = jbatch.make_ode_trm_step(JaxLVM(nt=nt), beta=1e-4, p=np.inf, delta0=2.0)(xs)
    t = make_ode_trm_step(_obj(nt), beta=1e-4, p=np.inf, delta0=2.0)(xs)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-12)
    np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]), rtol=1e-12)


def test_multistart_solve_matches_jax():
    nt = 100
    par = dict(beta=1e-4, p=np.inf, delta0=2.0)
    bj, rj = jbatch.multistart_solve(lambda: JaxLVM(nt=nt), 2,
                                     jtrm.TRMParameters(**par), seed=3)
    bt, rt = multistart_solve(lambda: _obj(nt), 2, TRMParameters(**par), seed=3)
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a.u, np.asarray(b.u))
        assert (a.iterations, a.inner_steps) == (b.iterations, b.inner_steps)
        np.testing.assert_allclose(a.J, b.J, rtol=1e-12)
    np.testing.assert_allclose(bt.J, bj.J, rtol=1e-12)


def test_entry_points_take_the_jax_argument_order(single_x0, port_single, port_multi,
                                                  multi_x0s):
    """``use_pallas`` sits where the JAX package has it: third in
    ``make_device_trm``, after ``seed`` in ``trm_solve_device``, after
    ``mesh`` in ``multistart_solve_device``.  Each entry point called with
    the JAX package's positional order gives the keyword call's result."""
    par = TRMParameters(**PINF)
    run = make_device_trm(_obj(240), par, True, 3, True)
    pos = run.finalize(run(torch.as_tensor(single_x0[None]), False))
    run = make_device_trm(_obj(240), par, use_pallas=True, outer_chunk=3, speculative=True)
    kw = run.finalize(run(torch.as_tensor(single_x0[None]), False))
    for field in kw._fields:
        assert torch.equal(getattr(pos, field), getattr(kw, field)), field
    fronts = []
    one = trm_solve_device(_obj(240), par, single_x0, None, True, 3,
                           lambda it, s: fronts.append(it), True)
    assert fronts and fronts[-1] == int(one.iterations)
    assert_same(one, port_single[("pinf", True)], rtol=0)
    fronts = []
    many = multistart_solve_device(_obj(160), par, multi_x0s, None, False, 5,
                                   lambda it, s: fronts.append(it))
    assert fronts and fronts[-1] == int(np.max(many.iterations))
    assert_same(many, port_multi[False], rtol=0)


def test_unported_backends_raise():
    """The sharded route and meshes once raised; in a world of one (a 1x1
    mesh) they run now and give the ordinary route's results bit for bit:
    both spellings of ``dp_backend="sharded"``, a multistart on a mesh (its
    starts split over a batch axis of 1) and the step on a mesh."""
    from mioc_tpu_torch.parallel import make_device_mesh

    mesh = make_device_mesh(batch=1, level=1, device_type="cpu")
    ref = trm_solve_device(_obj(20), TRMParameters(**PINF), seed=0)
    for got in (trm_solve_device(_obj(20), TRMParameters(**PINF, dp_backend="sharded"), seed=0),
                trm_solve_device(_obj(20), TRMParameters(**PINF), seed=0, dp_backend="sharded",
                                 mesh=mesh)):
        assert_same(got, ref, rtol=0)
    x0s = _starts(20, 2)
    many = multistart_solve_device(_obj(20), TRMParameters(**PINF), x0s)
    for kw in (dict(mesh=mesh), dict(mesh=mesh, dp_backend="sharded")):
        assert_same(multistart_solve_device(_obj(20), TRMParameters(**PINF), x0s, **kw),
                    many, rtol=0)
    obj = _obj(20)
    u = torch.as_tensor(x0s)
    want = make_ode_trm_step(obj, **PINF)(u)
    got = make_ode_trm_step(obj, **PINF, mesh=mesh)(u)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())  # NaN where b has NaN


def test_entry_points_default_to_cuda():
    """Objectives default to the card; without CUDA that raises, so no
    device solve runs on the CPU by accident."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LVMObj(nt=20)


def test_profile_dir_writes_trace(tmp_path):
    res = trm_solve_device(_obj(40), TRMParameters(**PINF, profile_dir=str(tmp_path)),
                           seed=0, outer_chunk=None)
    assert bool(res.converged)
    assert (tmp_path / "trm_device_trace.json").stat().st_size > 0
