"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture, which skips
without a CUDA device.  This file imports neither JAX nor ``mioc_tpu``, so on
a machine with a card and no JAX it runs without the repo's conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

The shapes here cover what ``chip_smoke.py`` does not: the int32 U route
(L > 127), nt = 1, S = 1 and Kt = 1, budgets past B and of 0, tables
expanded along the start axis, the wrappers' refusals and the solves'
launch counters at a small size (fishing and heat), and the heat sweeps' rows
bit-equal to single evaluations on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mioc_tpu_torch.ops import bellman as tb  # noqa: E402
from mioc_tpu_torch.ops.levels import (  # noqa: E402
    bounded_sum_levels,
    jump_cost_table,
    product_levels,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tables(adm, nt, B, dtype, dev, seed=0, p=1, beta=0.05, tau=0.05):
    rng = np.random.default_rng(seed)
    grad = torch.as_tensor(rng.normal(size=(nt, adm.M)), dtype=dtype, device=dev)
    u_old = torch.as_tensor(adm.levels[rng.integers(0, adm.L, size=nt)],
                            dtype=dtype, device=dev)
    jump = torch.as_tensor(jump_cost_table(adm.levels, p, beta=beta), dtype=dtype,
                           device=dev)
    stage, btilde = tb.stage_tables(grad, u_old, adm.levels, tau)
    return stage, btilde, jump, tb.max_budget_use(adm.levels)


CASES = [
    ("sos1", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 1, 6),
    ("sos1", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 300, 40),
    ("multi", lambda: product_levels([[-2, -1, 0, 1, 2]]), 257, 3),
    ("L130", lambda: product_levels([list(range(13)), list(range(10))]), 40, 30),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,levels,nt,B", CASES)
def test_kernels_bit_equal_plain(cuda_device, name, levels, nt, B, dtype):
    from mioc_tpu_torch.ops.backtrack_cuda import chase
    from mioc_tpu_torch.ops.bellman_cuda import dp_build

    adm = levels()
    stage, btilde, jump, smax = _tables(adm, nt, B, dtype, cuda_device)
    U_k, phi_k = dp_build(stage, btilde, jump, B, smax)
    U_p, phi_p = tb.build_tables_plain(stage, btilde, jump, B, smax)
    assert U_k.dtype == tb.u_dtype(adm.L) and U_k.shape == (nt - 1, adm.L, B + 1)
    assert torch.equal(U_k, U_p)
    assert torch.equal(phi_k, phi_p)
    for bn in (B + 5, B, B // 2, 1, 0):
        assert torch.equal(chase(U_k, phi_k, btilde, bn),
                           tb.backtrack_plain(U_k, phi_k, btilde, bn))


def test_wrappers_route_cuda_tensors_to_kernels(cuda_device):
    from mioc_tpu_torch.ops.backtrack_cuda import chase
    from mioc_tpu_torch.ops.bellman_cuda import dp_build

    adm = bounded_sum_levels([[0, 1]] * 3, 1, 1)
    stage, btilde, jump, smax = _tables(adm, 50, 9, torch.float64, cuda_device)
    n_b, n_c, n_p = dp_build.launches, chase.launches, tb.build_tables_plain.calls
    U, phi0 = tb.build_tables(stage, btilde, jump, 9, smax)
    u, idx = tb.backtrack(U, phi0, btilde, adm.levels, 9)
    assert (dp_build.launches, chase.launches) == (n_b + 1, n_c + 1)
    assert tb.build_tables_plain.calls == n_p
    assert u.device.type == "cuda" and u.shape == (50, 3)


SINGLE_BUILDS = [
    # name, levels, nt, B, cluster: the three cells' shapes (heat500, conv,
    # fishing), large heat and heat at B = 30 (16 CTAs of 3 and of 2 budgets
    # under a halo of 10) and heat at nt = 1024.
    ("heat500", lambda: product_levels([list(range(6))] * 2), 500, 100, True),
    ("heat200", lambda: product_levels([list(range(6))] * 2), 200, 40, True),
    ("heat-B30", lambda: product_levels([list(range(6))] * 2), 60, 30, True),
    ("heat1024", lambda: product_levels([list(range(6))] * 2), 1024, 204, True),
    ("conv", lambda: product_levels([[-2, -1, 0, 1, 2]]), 2048, 128, False),
    ("fishing", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 1024, 170, False),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,levels,nt,B,cluster", SINGLE_BUILDS)
def test_single_build_under_its_plan_bit_equal(cuda_device, name, levels, nt, B, cluster,
                                               dtype):
    """B1 (``dp_build``) under the plan it takes: a cluster of C > 1 CTAs at
    heat scale, one block at the conv and fishing shapes.  U and phi0 are
    bit-equal to the plain build and to the one-block launch (C = 1
    forced through the batched entry at S = 1); ``dp_build.cluster_launches``
    advances by one for a cluster launch only; the ``dp.build`` span names
    the CTAs."""
    from mioc_tpu_torch.ops import bellman_cuda as bc
    from mioc_tpu_torch.utils import trace

    adm = levels()
    stage, btilde, jump, smax = _tables(adm, nt, B, dtype, cuda_device, p=2, beta=1e-3)
    plan = bc.cluster_build_plan(1, nt, adm.L, B, stage.element_size(), smax)
    assert (plan.C > 1) == cluster
    if cluster:
        assert plan.H == min(smax, B) and plan.width == -(-(B + 1) // plan.C)
    U_p, phi_p = tb.build_tables_plain(stage, btilde, jump, B, smax)
    n_b, n_c = bc.dp_build.launches, bc.dp_build.cluster_launches
    trace.take()
    trace.enable()
    try:
        U_k, phi_k = tb.build_tables(stage, btilde, jump, B, smax)
    finally:
        trace.disable()
    (span,) = [s for s in trace.take() if s.name == "dp.build"]
    assert span.attrs == {"ctas": plan.C}
    assert bc.dp_build.launches - n_b == 1
    assert bc.dp_build.cluster_launches - n_c == int(cluster)
    U_1, phi_1 = bc.dp_build_batched(stage[None], btilde[None], jump, B, smax, clusters=1)
    assert bc.dp_build.cluster_launches - n_c == int(cluster)
    for U, phi in ((U_k, phi_k), (U_1[0], phi_1[0])):
        assert torch.equal(U, U_p)
        assert torch.equal(phi.view(torch.int8), phi_p.view(torch.int8))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    from mioc_tpu_torch.ops.backtrack_cuda import chase
    from mioc_tpu_torch.ops.bellman_cuda import dp_build

    adm = product_levels([list(range(6))] * 2)
    stage, btilde, jump, smax = _tables(adm, 20, 12, torch.float64, cuda_device)
    with pytest.raises(TypeError):
        dp_build(stage, btilde.long(), jump, 12, smax)
    with pytest.raises(ValueError, match="contiguous"):
        dp_build(stage.t().contiguous().t(), btilde, jump, 12, smax)
    with pytest.raises(ValueError, match="shared memory"):
        dp_build(stage, btilde, jump, 7000, smax)  # 2·36·(10+438)·8 B > a 16-CTA slice
    U, phi0 = dp_build(stage, btilde, jump, 12, smax)
    with pytest.raises(ValueError, match="shapes"):
        chase(U[:-1].contiguous(), phi0, btilde, 12)


def test_small_solve_counts_launches(cuda_device):
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.ops.backtrack_cuda import chase
    from mioc_tpu_torch.ops.bellman_cuda import dp_build
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve

    par = TRMParameters(beta=1e-4, delta0=2.0, p=np.inf)
    n_b, n_c = dp_build.launches, chase.launches
    res = trm_solve(LVMObj(nt=128, device=cuda_device), par, seed=0)
    assert dp_build.launches - n_b == res.dp_builds
    assert chase.launches - n_c == res.inner_steps
    ref = trm_solve(LVMObj(nt=128, device="cpu"), par, seed=0)
    assert (ref.iterations, ref.inner_steps) == (res.iterations, res.inner_steps)
    np.testing.assert_array_equal(ref.u, res.u)
    np.testing.assert_allclose(res.J, ref.J, rtol=1e-12)


def test_host_loop_timers_fit_in_the_wall(cuda_device):
    """The host loop's timers each end in a synchronise, so they time the
    card's work and not its enqueue: together they fit in the solve's wall,
    and the gradient's device time is in ``df``."""
    import time

    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve

    par = TRMParameters(beta=1e-4, delta0=2.0, p=np.inf)
    trm_solve(LVMObj(nt=128, device=cuda_device), par, seed=0)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trm_solve(LVMObj(nt=128, device=cuda_device), par, seed=0)
    wall = time.perf_counter() - t0
    assert set(res.timings) == {"dp", "backtrack", "f", "df"}
    assert res.timings["df"] > 0
    assert sum(res.timings.values()) <= wall


# ------------------------------------------------------------ batched kernels


def _batched_tables(adm, S, nt, B, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    grad = torch.as_tensor(rng.normal(size=(S, nt, adm.M)), dtype=dtype, device=dev)
    u_old = torch.as_tensor(adm.levels[rng.integers(0, adm.L, size=(S, nt))],
                            dtype=dtype, device=dev)
    jump = torch.as_tensor(jump_cost_table(adm.levels, 1, beta=0.05), dtype=dtype,
                           device=dev)
    stage, btilde = tb.stage_tables(grad, u_old, adm.levels, 0.05)
    return stage, btilde, jump, tb.max_budget_use(adm.levels)


BATCHED_CASES = [
    ("sos1-S1", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 1, 300, 40),
    ("sos1", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 5, 257, 17),
    ("L130", lambda: product_levels([list(range(13)), list(range(10))]), 3, 40, 30),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,levels,S,nt,B", BATCHED_CASES)
def test_batched_kernels_bit_equal_plain(cuda_device, name, levels, S, nt, B, dtype):
    from mioc_tpu_torch.ops.backtrack_cuda import chase_batched, chase_trials
    from mioc_tpu_torch.ops.bellman_cuda import dp_build_batched

    adm = levels()
    stage, btilde, jump, smax = _batched_tables(adm, S, nt, B, dtype, cuda_device)
    U_k, phi_k = dp_build_batched(stage, btilde, jump, B, smax)
    U_p, phi_p = tb.build_tables_batched_plain(stage, btilde, jump, B, smax)
    assert U_k.dtype == tb.u_dtype(adm.L) and U_k.shape == (S, nt - 1, adm.L, B + 1)
    assert torch.equal(U_k, U_p) and torch.equal(phi_k, phi_p)
    # Caps per start, past B and 0 included; Kt = 1 and Kt = 6 trial waves.
    caps = torch.tensor([B + 5, 0, B, B // 2, 1][:S], dtype=torch.int32,
                        device=cuda_device)
    assert torch.equal(chase_batched(U_k, phi_k, btilde, caps),
                       tb.backtrack_batched_plain(U_k, phi_k, btilde, caps.cpu()))
    for row in ([B], [B + 7, B, B // 2, B // 4, 1, 0]):
        trials = torch.tensor([row] * S, dtype=torch.int32, device=cuda_device)
        assert torch.equal(chase_trials(U_k, phi_k, btilde, trials),
                           tb.backtrack_trials_plain(U_k, phi_k, btilde, trials.cpu()))


def test_batched_chase_reads_expanded_tables(cuda_device):
    """Tables expanded along the start axis (stride 0) are read in place."""
    from mioc_tpu_torch.ops.backtrack_cuda import chase, chase_batched

    adm = bounded_sum_levels([[0, 1]] * 3, 1, 1)
    stage, btilde, jump, smax = _tables(adm, 200, 20, torch.float64, cuda_device)
    U, phi0 = tb.build_tables(stage, btilde, jump, 20, smax)
    K = 7
    caps = torch.tensor([20, 10, 5, 2, 1, 0, 25], dtype=torch.int32, device=cuda_device)
    out = chase_batched(U.expand(K, -1, -1, -1), phi0.expand(K, -1, -1),
                        btilde.expand(K, -1, -1), caps)
    for k in range(K):
        assert torch.equal(out[k], chase(U, phi0, btilde, caps[k]))
        assert torch.equal(out[k], chase(U, phi0, btilde, int(caps[k])))


def test_batched_wrappers_refuse(cuda_device):
    from mioc_tpu_torch.ops.backtrack_cuda import chase_batched, chase_trials
    from mioc_tpu_torch.ops.bellman_cuda import dp_build_batched

    adm = product_levels([list(range(6))] * 2)
    stage, btilde, jump, smax = _batched_tables(adm, 2, 20, 12, torch.float64,
                                                cuda_device)
    # One block per start cannot hold 2·36·501 float64 Φ entries; the plan's
    # cluster of budget slices can.
    with pytest.raises(ValueError, match="shared memory"):
        dp_build_batched(stage, btilde, jump, 500, smax, clusters=1)
    U5, phi5 = dp_build_batched(stage, btilde, jump, 500, smax)
    U5p, phi5p = tb.build_tables_batched_plain(stage, btilde, jump, 500, smax)
    assert torch.equal(U5, U5p) and torch.equal(phi5, phi5p)
    with pytest.raises(TypeError):
        dp_build_batched(stage, btilde.long(), jump, 12, smax)
    U, phi0 = dp_build_batched(stage, btilde, jump, 12, smax)
    with pytest.raises(ValueError, match="at most|1 to 128"):
        chase_trials(U, phi0, btilde, torch.zeros((2, 129), dtype=torch.int32,
                                                  device=cuda_device))
    strided = torch.zeros((2, 19, 36, 26), dtype=U.dtype, device=cuda_device)[..., :13]
    with pytest.raises(ValueError, match="contiguous per start"):
        chase_batched(strided, phi0, btilde, 3)


def test_small_multistart_counts_launches(cuda_device):
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.ops.backtrack_cuda import chase, chase_batched, chase_trials
    from mioc_tpu_torch.ops.bellman_cuda import dp_build, dp_build_batched
    from mioc_tpu_torch.solvers.trm import TRMParameters
    from mioc_tpu_torch.solvers.trm_device import multistart_solve_device, trm_solve_device
    from mioc_tpu_torch.utils.init import rand_func

    par = TRMParameters(beta=1e-4, delta0=2.0, p=np.inf)
    obj = LVMObj(nt=128, device=cuda_device)
    x0s = np.stack([rand_func(obj, seed=s) for s in range(3)])
    kernels = (dp_build, chase, dp_build_batched, chase_batched, chase_trials)
    n0 = [k.launches for k in kernels]
    seq = multistart_solve_device(obj, par, x0s)
    n1 = [k.launches for k in kernels]
    spec = multistart_solve_device(obj, par, x0s, speculative=True)
    n2 = [k.launches for k in kernels]
    it = int(seq.iterations.max())
    assert [b - a for a, b in zip(n0, n1)][:3] == [0, 0, it]
    assert n1[3] - n0[3] >= it and n1[4] == n0[4]
    assert [b - a for a, b in zip(n1, n2)] == [0, 0, it, 0, it]
    for name in ("u", "x_final", "iterations", "inner_steps", "f_evals", "df_evals"):
        np.testing.assert_array_equal(getattr(spec, name), getattr(seq, name))
    one = trm_solve_device(LVMObj(nt=128, device=cuda_device), par, x0=x0s[1])
    n3 = [k.launches for k in kernels]
    assert n3[0] - n2[0] == int(one.iterations) and n3[3] - n2[3] == int(one.iterations)
    np.testing.assert_array_equal(one.u, seq.u[1])
    ref = multistart_solve_device(LVMObj(nt=128, device="cpu"), par, x0s)
    np.testing.assert_array_equal(ref.u, seq.u)
    np.testing.assert_array_equal(ref.inner_steps, seq.inner_steps)
    np.testing.assert_allclose(ref.J, seq.J, rtol=1e-12)


# ------------------------------------------------------------ heat


def _heat(nt, refinements, device):
    from mioc_tpu_torch.models.heat import HeatObj, construct_mesh

    return HeatObj(nt=nt, mesh=construct_mesh(refinements=refinements), device=device)


@pytest.mark.parametrize("rows", [1, 2, 9, 17, 40])
def test_heat_rows_bit_equal_single_on_card(cuda_device, rows):
    """Every row of a batched heat forward and adjoint on the card has the
    single evaluation's bits (fixed-shape product chunks, fold sums)."""
    obj = _heat(24, 2, cuda_device)
    rng = np.random.default_rng(rows)
    xs = torch.as_tensor(rng.integers(0, 6, size=(rows, 24, 2)).astype(float),
                         device=cuda_device)
    f, ys = obj._forward_batch(xs)
    df, lam = obj._adjoint_batch(xs, ys)
    for r in range(rows):
        f1, y1 = obj._forward(xs[r])
        d1, l1 = obj._adjoint(xs[r], y1)
        assert torch.equal(f1, f[r]) and torch.equal(y1, ys[:, r])
        assert torch.equal(d1, df[r]) and torch.equal(l1, lam[r])


def test_heat_host_solve_on_card_equals_cpu(cuda_device):
    from mioc_tpu_torch.ops.backtrack_cuda import chase
    from mioc_tpu_torch.ops.bellman_cuda import dp_build
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve

    par = TRMParameters(beta=1e-3, delta0=2.0, p=2)
    n_b, n_c = dp_build.launches, chase.launches
    res = trm_solve(_heat(40, 2, cuda_device), par, seed=0)
    assert (dp_build.launches - n_b, chase.launches - n_c) == (res.dp_builds, res.inner_steps)
    ref = trm_solve(_heat(40, 2, "cpu"), par, seed=0)
    assert (res.iterations, res.inner_steps, res.f_evals) == (
        ref.iterations, ref.inner_steps, ref.f_evals)
    np.testing.assert_array_equal(res.u, ref.u)
    np.testing.assert_allclose(res.J, ref.J, rtol=1e-12)


def test_heat_device_loop_and_multistart_count_launches(cuda_device):
    """The device loop chases its wave with chase_trials (the PDE default);
    the multistart builds with dp_build_batched and chases with
    chase_batched (sequential) or chase_trials (speculative, the PDE
    default); speculative equals sequential, and start s the single solve."""
    from mioc_tpu_torch.ops.backtrack_cuda import chase, chase_batched, chase_trials
    from mioc_tpu_torch.ops.bellman_cuda import dp_build, dp_build_batched
    from mioc_tpu_torch.solvers.trm import TRMParameters
    from mioc_tpu_torch.solvers.trm_device import multistart_solve_device, trm_solve_device
    from mioc_tpu_torch.utils.init import rand_func

    par = TRMParameters(beta=1e-3, delta0=2.0, p=2)
    obj = _heat(24, 1, cuda_device)
    x0s = np.stack([rand_func(obj, seed=s) for s in range(3)])
    kernels = (dp_build, chase, dp_build_batched, chase_batched, chase_trials)
    n0 = [k.launches for k in kernels]
    one = trm_solve_device(obj, par, x0=x0s[1])
    n1 = [k.launches for k in kernels]
    it = int(one.iterations)
    assert [b - a for a, b in zip(n0, n1)] == [it, 0, 0, 0, it]
    spec = multistart_solve_device(obj, par, x0s)
    n2 = [k.launches for k in kernels]
    seq = multistart_solve_device(obj, par, x0s, speculative=False)
    n3 = [k.launches for k in kernels]
    its = int(seq.iterations.max())
    assert [b - a for a, b in zip(n1, n2)] == [0, 0, its, 0, its]
    assert [b - a for a, b in zip(n2, n3)][:3] == [0, 0, its] and n3[4] == n2[4]
    assert n3[3] - n2[3] >= its
    for name in spec._fields:
        np.testing.assert_array_equal(getattr(spec, name), getattr(seq, name))
    np.testing.assert_array_equal(one.u, seq.u[1])
    assert float(one.J) == float(seq.J[1])
    ref = multistart_solve_device(_heat(24, 1, "cpu"), par, x0s)
    np.testing.assert_array_equal(ref.u, seq.u)
    np.testing.assert_array_equal(ref.inner_steps, seq.inner_steps)
    np.testing.assert_allclose(ref.J, seq.J, rtol=1e-12)


def _banded_heat(nt, device):
    from mioc_tpu_torch.models.heat import HeatObj, construct_mesh_hierarchy

    return HeatObj(nt=nt, mesh_hierarchy=construct_mesh_hierarchy(refinements=2),
                   solver="mg", cg_iters=8, sparse_format="banded", device=device)


@pytest.mark.parametrize("rows", [1, 2, 9, 17])
def test_banded_heat_rows_bit_equal_single_on_card(cuda_device, rows):
    """The banded mg engine on the card: every row of a batched forward and
    adjoint has the single evaluation's bits (16-row products, row sums of
    one shape)."""
    obj = _banded_heat(12, cuda_device)
    rng = np.random.default_rng(rows)
    xs = torch.as_tensor(rng.integers(0, 6, size=(rows, 12, 2)).astype(float),
                         device=cuda_device)
    f, ys = obj._forward_batch(xs)
    df, lam = obj._adjoint_batch(xs, ys)
    for r in range(rows):
        f1, y1 = obj._forward(xs[r])
        d1, l1 = obj._adjoint(xs[r], y1)
        assert torch.equal(f1, f[r]) and torch.equal(y1, ys[:, r])
        assert torch.equal(d1, df[r]) and torch.equal(l1, lam[r])


def test_banded_heat_solves_on_card_equal_cpu(cuda_device):
    """The banded mg engine's host solve on the card takes the CPU solve's
    decisions; its device loop, speculative and sequential, the same."""
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve
    from mioc_tpu_torch.solvers.trm_device import trm_solve_device

    par = TRMParameters(beta=1e-3, delta0=2.0, p=2)
    res = trm_solve(_banded_heat(20, cuda_device), par, seed=0)
    ref = trm_solve(_banded_heat(20, "cpu"), par, seed=0)
    assert (res.iterations, res.inner_steps, res.f_evals) == (
        ref.iterations, ref.inner_steps, ref.f_evals)
    np.testing.assert_array_equal(res.u, ref.u)
    np.testing.assert_allclose(res.J, ref.J, rtol=1e-12)
    obj = _banded_heat(20, cuda_device)
    spec = trm_solve_device(obj, par, seed=0)
    seq = trm_solve_device(obj, par, seed=0, speculative=False)
    for name in spec._fields:
        np.testing.assert_array_equal(getattr(spec, name), getattr(seq, name))
    np.testing.assert_array_equal(spec.u, res.u)


# ------------------------------------------------------------ chase_vec


VEC_CASES = CASES + [
    ("nt2", lambda: product_levels([[-2, -1, 0, 1, 2]]), 2, 4),
    ("heat", lambda: product_levels([list(range(6))] * 2), 1000, 204),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,levels,nt,B", VEC_CASES)
def test_chase_vec_equals_plain(cuda_device, name, levels, nt, B, dtype):
    """The cluster chase equals the plain chase: int8 and int32 U (L130),
    sub-chunk edges (nt-1 not a multiple of the slices or of 32), the maps in
    device memory in rounds (heat), int and device-tensor caps, a cap past B
    and a cap of 0."""
    from mioc_tpu_torch.ops.backtrack_cuda import chase_vec

    adm = levels()
    stage, btilde, jump, smax = _tables(adm, nt, B, dtype, cuda_device)
    U, phi0 = tb.build_tables_plain(stage, btilde, jump, B, smax)
    for cap in (B + 5, B, B // 2, 1, 0):
        want = tb.backtrack_plain(U, phi0, btilde, cap)
        assert torch.equal(chase_vec(U, phi0, btilde, cap), want), cap
        dev_cap = torch.tensor(cap, dtype=torch.int32, device=cuda_device)
        assert torch.equal(chase_vec(U, phi0, btilde, dev_cap), want), cap


def test_mioc_chase_vec_routes_backtrack(cuda_device, monkeypatch):
    """Under MIOC_CHASE=vec the single chase launches chase_vec, not chase;
    unset or "scalar" launches chase; anything else raises."""
    from mioc_tpu_torch.ops.backtrack_cuda import chase, chase_vec

    adm = product_levels([[-2, -1, 0, 1, 2]])
    stage, btilde, jump, smax = _tables(adm, 300, 20, torch.float64, cuda_device)
    U, phi0 = tb.build_tables(stage, btilde, jump, 20, smax)
    runs = {}
    for variant in (None, "scalar", "vec"):
        if variant is None:
            monkeypatch.delenv("MIOC_CHASE", raising=False)
        else:
            monkeypatch.setenv("MIOC_CHASE", variant)
        n_c, n_v = chase.launches, chase_vec.launches
        runs[variant] = tb.backtrack(U, phi0, btilde, adm.levels, 10)[1]
        want = (0, 1) if variant == "vec" else (1, 0)
        assert (chase.launches - n_c, chase_vec.launches - n_v) == want, variant
    assert torch.equal(runs["vec"], runs[None]) and torch.equal(runs["scalar"], runs[None])
    monkeypatch.setenv("MIOC_CHASE", "vector")
    with pytest.raises(ValueError, match="MIOC_CHASE"):
        tb.backtrack(U, phi0, btilde, adm.levels, 10)


def test_conv_rows_bit_equal_on_card(cuda_device):
    """ConvObj's batched f and ∇f rows have the single evaluation's bits."""
    from mioc_tpu_torch.models import ConvObj
    from mioc_tpu_torch.utils.init import rand_func

    obj = ConvObj(nt=300, device=cuda_device)
    X = torch.as_tensor(np.stack([rand_func(obj, seed=s) for s in range(20)]),
                        device=cuda_device)
    f1 = torch.stack([obj._forward_batch(X[s:s + 1])[0][0] for s in range(20)])
    d1 = torch.stack([obj._adjoint_batch(X[s:s + 1], None)[0][0] for s in range(20)])
    for S in (1, 9, 20):
        assert torch.equal(obj._forward_batch(X[:S])[0].view(torch.int64),
                           f1[:S].view(torch.int64))
        assert torch.equal(obj._adjoint_batch(X[:S], None)[0].view(torch.int64),
                           d1[:S].view(torch.int64))


# ------------------------------------------------- redesigned build and chase


def _nonadmissible_first_row(adm, nt, B, dtype, dev, seed=0):
    """Tables whose u_old row 0 lies more than smax from every level in each
    component: every b̃[0, l] exceeds smax, so phi0 is +inf everywhere, the
    seed is (0, 0) and the walk's budget falls below -(B+1)."""
    rng = np.random.default_rng(seed)
    smax = tb.max_budget_use(adm.levels)
    grad = torch.as_tensor(rng.normal(size=(nt, adm.M)), dtype=dtype, device=dev)
    u_old = torch.as_tensor(adm.levels[rng.integers(0, adm.L, size=nt)], dtype=dtype,
                            device=dev)
    u_old[0] = float(np.abs(adm.levels).max() + smax + 1)
    jump = torch.as_tensor(jump_cost_table(adm.levels, 1, beta=0.05), dtype=dtype,
                           device=dev)
    stage, btilde = tb.stage_tables(grad, u_old, adm.levels, 0.05)
    return stage, btilde, jump, smax


def _all_chases_equal_plain(U, phi0, btilde, caps, dev):
    from mioc_tpu_torch.ops.backtrack_cuda import (chase, chase_batched, chase_trials,
                                                   chase_vec)

    for cap in caps:
        want = tb.backtrack_plain(U, phi0, btilde, cap)
        dev_cap = torch.tensor(cap, dtype=torch.int32, device=dev)
        assert torch.equal(chase(U, phi0, btilde, cap), want), cap
        assert torch.equal(chase(U, phi0, btilde, dev_cap), want), cap
        assert torch.equal(chase_vec(U, phi0, btilde, cap), want), cap
        caps_t = torch.tensor([cap, cap], dtype=torch.int32, device=dev)
        assert torch.equal(chase_batched(U.expand(2, -1, -1, -1), phi0.expand(2, -1, -1),
                                         btilde.expand(2, -1, -1), caps_t),
                           want.expand(2, -1)), cap
        assert torch.equal(chase_trials(U[None].contiguous(), phi0[None].contiguous(),
                                        btilde[None].contiguous(), caps_t[None]),
                           want.expand(1, 2, -1)), cap


@pytest.mark.parametrize("name,levels,nt,B", CASES + [
    ("heat", lambda: product_levels([list(range(6))] * 2), 300, 204)])
def test_infeasible_cap_all_chases_equal_plain(cuda_device, name, levels, nt, B):
    """A cap of -1 masks every seed: the seed is (0, 0) and the walk leaves
    [0, B]; all four chase kernels follow the plain walk's index rule."""
    adm = levels()
    stage, btilde, jump, smax = _tables(adm, nt, B, torch.float64, cuda_device)
    U, phi0 = tb.build_tables(stage, btilde, jump, B, smax)
    _all_chases_equal_plain(U, phi0, btilde, (-1, -7), cuda_device)


@pytest.mark.parametrize("name,levels,nt,B", CASES)
def test_infinite_seed_all_chases_equal_plain(cuda_device, name, levels, nt, B):
    adm = levels()
    stage, btilde, jump, smax = _nonadmissible_first_row(adm, nt, B, torch.float64,
                                                         cuda_device)
    U, phi0 = tb.build_tables(stage, btilde, jump, B, smax)
    assert not torch.isfinite(phi0).any()
    _all_chases_equal_plain(U, phi0, btilde, (B, B // 2, 0), cuda_device)


BUILD_EDGES = [
    # name, levels, nt, B: nt 1 and 2, L = 1, B = 0, rows read in place (L ≤ 2
    # at the largest B the first kernel took, B = None), the jump table through the read-only cache (L = 36 at
    # B = 384), a multi-chunk ring (heat scale), the int32 U route.
    ("nt1", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 1, 9),
    ("nt2", lambda: product_levels([[-2, -1, 0, 1, 2]]), 2, 4),
    ("L1", lambda: product_levels([[0]]), 50, 7),
    ("B0", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 60, 0),
    ("L1-edge", lambda: product_levels([[0]]), 5, None),
    ("L2-edge", lambda: product_levels([[0, 1]]), 5, None),
    ("L36-jump-global", lambda: product_levels([list(range(6))] * 2), 60, 384),
    ("heat-ring", lambda: product_levels([list(range(6))] * 2), 500, 204),
    ("L130", lambda: product_levels([list(range(13)), list(range(10))]), 25, 30),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,levels,nt,B", BUILD_EDGES)
def test_build_edges_bit_equal_plain(cuda_device, name, levels, nt, B, dtype):
    from mioc_tpu_torch.ops.bellman_cuda import build_plan, dp_build, dp_build_batched

    adm = levels()
    item = 8 if dtype == torch.float64 else 4
    if B is None:  # the largest B with (2·L·(B+1) + L²)·item ≤ 232448
        B = (232448 // item - adm.L ** 2) // (2 * adm.L) - 1
    stage, btilde, jump, smax = _tables(adm, nt, B, dtype, cuda_device)
    if name.endswith("-edge"):
        assert build_plan(nt, adm.L, B, item).R == 0
    U_k, phi_k = dp_build(stage, btilde, jump, B, smax)
    U_p, phi_p = tb.build_tables_plain(stage, btilde, jump, B, smax)
    assert torch.equal(U_k, U_p) and torch.equal(phi_k, phi_p)
    Ub, phib = dp_build_batched(stage[None].expand(2, -1, -1).contiguous(),
                                btilde[None].expand(2, -1, -1).contiguous(), jump, B, smax)
    assert torch.equal(Ub[1], U_p) and torch.equal(phib[1], phi_p)


CHASE_EDGES = [
    # name, levels, nt, B: nt 1 and 2 (one chunk), chunks of one step, nt-1
    # not a multiple of T, L = 1, B = 0, planes read in place (int32 U of
    # 209 kB), more chunks (149) than the card holds blocks at once.
    ("nt1", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 1, 9),
    ("nt2", lambda: product_levels([[-2, -1, 0, 1, 2]]), 2, 4),
    ("one-step-chunks", lambda: product_levels([[-2, -1, 0, 1, 2]]), 30, 6),
    ("ragged", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 1000, 40),
    ("L1", lambda: product_levels([[0]]), 70, 5),
    ("B0", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 70, 0),
    ("in-place", lambda: product_levels([list(range(13)), list(range(10))]), 12, 400),
    ("many-chunks", lambda: product_levels([list(range(6))] * 2), 4000, 204),
]


@pytest.mark.parametrize("name,levels,nt,B", CHASE_EDGES)
def test_chase_edges_equal_plain(cuda_device, name, levels, nt, B):
    from mioc_tpu_torch.ops.backtrack_cuda import chase, chase_plan

    adm = levels()
    stage, btilde, jump, smax = _tables(adm, nt, B, torch.float64, cuda_device)
    # The plain build: "in-place" is larger than one build block takes.
    U, phi0 = tb.build_tables_plain(stage, btilde, jump, B, smax)
    plan = chase_plan(nt, adm.L, B, U.element_size())
    assert plan.staged == (name not in ("in-place", "nt1"))
    for cap in (B + 5, B, B // 2, B // 4, 0, -1):
        want = tb.backtrack_plain(U, phi0, btilde, cap)
        assert torch.equal(chase(U, phi0, btilde, cap), want), cap


# ------------------------------------- redesigned batched chase and vec chase

CHIP_SHAPES = [
    # name, levels, nt, B, trial caps: chip_smoke.py's three kernel shapes
    ("fishing", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 1024, 170,
     [170, 85, 42, 21, 10, 5, 2, 1, 0]),
    ("conv", lambda: product_levels([[-2, -1, 0, 1, 2]]), 2048, 128,
     [128 >> k for k in range(8)] + [0]),
    ("heat", lambda: product_levels([list(range(6))] * 2), 1024, 204,
     [204 >> k for k in range(8)] + [0]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,levels,nt,B,wave", CHIP_SHAPES)
def test_redesigned_chases_at_chip_shapes(cuda_device, name, levels, nt, B, wave, dtype):
    """chase_batched over 8 table sets (G = R) and on the stride-0 wave of
    one set (G = 1, K caps), and chase_vec at every cap of the wave, equal
    to the plain walk."""
    from mioc_tpu_torch.ops.backtrack_cuda import chase_batched, chase_vec

    adm = levels()
    S = 8
    stage, btilde, jump, smax = _batched_tables(adm, S, nt, B, dtype, cuda_device, seed=3)
    U, phi0 = tb.build_tables_batched_plain(stage, btilde, jump, B, smax)
    caps = torch.tensor([wave[s % len(wave)] for s in range(S)], dtype=torch.int32,
                        device=cuda_device)
    assert torch.equal(chase_batched(U, phi0, btilde, caps),
                       tb.backtrack_batched_plain(U, phi0, btilde, caps.cpu()))
    K = len(wave)
    ks = torch.tensor(wave, dtype=torch.int32, device=cuda_device)
    got = chase_batched(U[0].expand(K, -1, -1, -1), phi0[0].expand(K, -1, -1),
                        btilde[0].expand(K, -1, -1), ks)
    for k, cap in enumerate(wave):
        want = tb.backtrack_plain(U[0], phi0[0], btilde[0], cap)
        assert torch.equal(got[k], want), cap
        assert torch.equal(chase_vec(U[0], phi0[0], btilde[0], cap), want), cap


def test_batched_chase_one_start_and_many_rows(cuda_device):
    """S = 1, and the 288 rows of a 32-start wave of 9 caps materialised (G =
    R = 288, more rows than the grid has blocks), against the plain walk."""
    from mioc_tpu_torch.ops.backtrack_cuda import chase_batched, chase_plan

    adm = bounded_sum_levels([[0, 1]] * 3, 1, 1)
    stage, btilde, jump, smax = _batched_tables(adm, 32, 400, 60, torch.float64,
                                                cuda_device, seed=5)
    U, phi0 = tb.build_tables_batched_plain(stage, btilde, jump, 60, smax)
    one = torch.tensor([37], dtype=torch.int32, device=cuda_device)
    assert torch.equal(chase_batched(U[:1], phi0[:1], btilde[:1], one),
                       tb.backtrack_batched_plain(U[:1], phi0[:1], btilde[:1], [37]))
    K = 9
    caps = torch.tensor([60 >> k for k in range(8)] + [0], dtype=torch.int32,
                        device=cuda_device).repeat(32)
    tables = [t[:, None].expand(32, K, *t.shape[1:]).reshape(32 * K, *t.shape[1:])
              for t in (U, phi0, btilde)]
    assert chase_plan(400, 3, 60, 1, sets=288, rows=288).C >= 1
    assert torch.equal(chase_batched(*tables, caps),
                       tb.backtrack_batched_plain(*tables, caps.cpu()))


@pytest.mark.parametrize("far", [False, True])
def test_batched_chase_strides_and_sentinels(cuda_device, far):
    """Caps -1 and past B, +inf seeds (far), stride 0 on U and b̃ together
    (one set of maps) and on phi0 alone (a set per row)."""
    from mioc_tpu_torch.ops.backtrack_cuda import chase_batched

    adm = product_levels([[-2, -1, 0, 1, 2]])
    make = _nonadmissible_first_row if far else _tables
    stage, btilde, jump, smax = make(adm, 300, 20, torch.float64, cuda_device)
    U, phi0 = tb.build_tables(stage, btilde, jump, 20, smax)
    caps = torch.tensor([20, -1, 26, 0, 7, -3], dtype=torch.int32, device=cuda_device)
    want = torch.stack([tb.backtrack_plain(U, phi0, btilde, int(c)) for c in caps])
    S = len(caps)
    shared = chase_batched(U.expand(S, -1, -1, -1), phi0.expand(S, -1, -1),
                           btilde.expand(S, -1, -1), caps)
    phi_only = chase_batched(U.expand(S, -1, -1, -1).contiguous(), phi0.expand(S, -1, -1),
                             btilde.expand(S, -1, -1).contiguous(), caps)
    assert torch.equal(shared, want) and torch.equal(phi_only, want)


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("subchunk_steps", [5, 16, 256])
def test_chase_vec_cluster_sizes(cuda_device, monkeypatch, cluster, subchunk_steps):
    """Each cluster size, with many sub-chunks (as many as fit), 8 and one
    per slice, at the conv shape, equal to the plain walk (caps B, B/2, 0,
    -1)."""
    from mioc_tpu_torch.ops import backtrack_cuda as kc

    monkeypatch.setattr(kc, "VEC_CLUSTERS", (cluster,))
    monkeypatch.setattr(kc, "VEC_SUBCHUNK_STEPS", subchunk_steps)
    adm = product_levels([[-2, -1, 0, 1, 2]])
    stage, btilde, jump, smax = _tables(adm, 2048, 128, torch.float64, cuda_device)
    U, phi0 = tb.build_tables(stage, btilde, jump, 128, smax)
    for cap in (128, 64, 0, -1):
        assert torch.equal(kc.chase_vec(U, phi0, btilde, cap),
                           tb.backtrack_plain(U, phi0, btilde, cap)), cap


@pytest.mark.parametrize("name,levels,nt,B", CHASE_EDGES)
def test_redesigned_chases_edges_equal_plain(cuda_device, name, levels, nt, B):
    """The edge shapes for chase_vec and for chase_batched with one set of
    maps (stride 0) and with a set per row."""
    from mioc_tpu_torch.ops.backtrack_cuda import chase_batched, chase_vec

    adm = levels()
    stage, btilde, jump, smax = _tables(adm, nt, B, torch.float64, cuda_device)
    U, phi0 = tb.build_tables_plain(stage, btilde, jump, B, smax)
    caps = (B + 5, B, B // 2, B // 4, 0, -1)
    want = torch.stack([tb.backtrack_plain(U, phi0, btilde, c) for c in caps])
    caps_t = torch.tensor(caps, dtype=torch.int32, device=cuda_device)
    S = len(caps)
    expanded = (U.expand(S, -1, -1, -1), phi0.expand(S, -1, -1), btilde.expand(S, -1, -1))
    assert torch.equal(chase_batched(*expanded, caps_t), want)
    assert torch.equal(chase_batched(*(t.contiguous() for t in expanded), caps_t), want)
    for k, cap in enumerate(caps):
        assert torch.equal(chase_vec(U, phi0, btilde, cap), want[k]), cap


# ------------------------ redesigned trial-wave chase and cluster batched build


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("name,levels,S,nt,B", [
    ("sos1", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 5, 300, 40),
    ("multi", lambda: product_levels([[-2, -1, 0, 1, 2]]), 3, 257, 17),
    ("L130", lambda: product_levels([list(range(13)), list(range(10))]), 2, 40, 30),
    ("heat", lambda: product_levels([list(range(6))] * 2), 3, 1000, 204),
])
def test_chase_trials_mixed_caps_equal_plain(cuda_device, name, levels, S, nt, B, far):
    """The trial wave over S sets of Kt caps, with -1, 0, B and caps past B
    mixed in each set in another order, so that rows of other sets and other
    sentinels share one launch; with ``far`` every set's phi0 is +inf."""
    from mioc_tpu_torch.ops.backtrack_cuda import chase_trials

    adm = levels()
    make = _nonadmissible_first_row if far else _tables
    tabs = [make(adm, nt, B, torch.float64, cuda_device, seed=k) for k in range(S)]
    stage = torch.stack([t[0] for t in tabs])
    btilde = torch.stack([t[1] for t in tabs])
    U, phi0 = tb.build_tables_batched(stage, btilde, tabs[0][2], B, tabs[0][3])
    rng = np.random.default_rng(S + nt)
    base = [-1, 0, B, B + 3, B // 2, 1, -4, B // 3, 2]
    caps = torch.tensor(np.array([rng.permutation(base) for _ in range(S)]),
                        dtype=torch.int32, device=cuda_device)
    got = chase_trials(U, phi0, btilde, caps)
    assert torch.equal(got, tb.backtrack_trials_plain(U, phi0, btilde, caps.cpu()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,levels,S,nt,B", [
    ("sos1", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 3, 300, 40),
    ("multi", lambda: product_levels([[-2, -1, 0, 1, 2]]), 2, 257, 17),
    ("heat", lambda: product_levels([list(range(6))] * 2), 2, 300, 204),
])
def test_cluster_build_every_size_bit_equal_plain(cuda_device, name, levels, S, nt, B,
                                                  dtype):
    """The batched build at every cluster size the plan takes (1 … 16, the
    card permitting), uneven slices, halos wider than a slice (heat at 16
    CTAs: width 13, halo 10; multi at 16: width 2, halo 4), bit-equal to the
    plain build."""
    from mioc_tpu_torch.ops.bellman_cuda import cluster_build_plan, dp_build_batched

    adm = levels()
    stage, btilde, jump, smax = _batched_tables(adm, S, nt, B, dtype, cuda_device)
    U_p, phi_p = tb.build_tables_batched_plain(stage, btilde, jump, B, smax)
    item = stage.element_size()
    for C in range(1, min(16, B + 1) + 1):
        plan = cluster_build_plan(S, nt, adm.L, B, item, smax, clusters=C)
        assert plan.C == C
        U_k, phi_k = dp_build_batched(stage, btilde, jump, B, smax, clusters=C)
        assert torch.equal(U_k, U_p), C
        assert torch.equal(phi_k, phi_p), C


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name,levels,nt,B", BUILD_EDGES)
def test_cluster_build_edges_bit_equal_plain(cuda_device, name, levels, nt, B, dtype):
    """The build edge shapes at C = 1 and at the largest C the plan takes
    (16, or B+1 where smaller), bit-equal to the plain build."""
    from mioc_tpu_torch.ops.bellman_cuda import dp_build_batched

    adm = levels()
    item = 8 if dtype == torch.float64 else 4
    if B is None:
        B = (232448 // item - adm.L ** 2) // (2 * adm.L) - 1
    stage, btilde, jump, smax = _batched_tables(adm, 2, nt, B, dtype, cuda_device, seed=9)
    U_p, phi_p = tb.build_tables_batched_plain(stage, btilde, jump, B, smax)
    for C in sorted({1, min(16, B + 1)}):
        U_k, phi_k = dp_build_batched(stage, btilde, jump, B, smax, clusters=C)
        assert torch.equal(U_k, U_p) and torch.equal(phi_k, phi_p), C


def test_new_kernels_raise_on_a_refused_launch(cuda_device, monkeypatch):
    """A plan the C entry refuses raises RuntimeError from the wrapper, with
    no plain version called: no fallback."""
    from mioc_tpu_torch.ops import backtrack_cuda as kc
    from mioc_tpu_torch.ops import bellman_cuda as bc

    adm = product_levels([list(range(6))] * 2)
    stage, btilde, jump, smax = _batched_tables(adm, 2, 60, 30, torch.float64, cuda_device)
    U, phi0 = bc.dp_build_batched(stage, btilde, jump, 30, smax)
    calls = (tb.build_tables_batched_plain.calls, tb.backtrack_trials_plain.calls)
    good = bc.cluster_build_plan(2, 60, 36, 30, 8, smax, clusters=4)
    monkeypatch.setattr(bc, "cluster_build_plan", lambda *a, **k: good._replace(tpl=1, K=1))
    with pytest.raises(RuntimeError, match="dp_build_batched launch failed"):
        bc.dp_build_batched(stage, btilde, jump, 30, smax)
    plan = kc.chase_plan(60, 36, 30, 1, sets=2, rows=4)
    monkeypatch.setattr(kc, "chase_plan", lambda *a, **k: plan._replace(C=1, T=1))
    with pytest.raises(RuntimeError, match="chase_trials launch failed"):
        kc.chase_trials(U, phi0, btilde, torch.zeros((2, 2), dtype=torch.int32,
                                                     device=cuda_device))
    assert (tb.build_tables_batched_plain.calls, tb.backtrack_trials_plain.calls) == calls


# ------------------------------------------- temporal DP, mixed solve, fma


@pytest.mark.parametrize("name,levels,nt,B", [
    ("sos1", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 300, 40),
    ("heat", lambda: product_levels([list(range(6))] * 2), 60, 20),
])
def test_temporal_tables_bit_equal_cpu(cuda_device, name, levels, nt, B):
    """The temporal DP's tables on the card have the CPU's bits, and its
    chase the CPU's levels at every halving cap."""
    from mioc_tpu_torch.parallel import temporal as tt

    adm = levels()
    stage, btilde, jump, smax = _tables(adm, nt, B, torch.float64, cuda_device, seed=5)
    phis = tt.temporal_tables(stage, btilde, jump, B, smax)
    ref = tt.temporal_tables(stage.cpu(), btilde.cpu(), jump.cpu(), B, smax)
    assert phis.device.type == "cuda"
    assert torch.equal(phis.cpu().view(torch.int64), ref.view(torch.int64))
    for cap in (B, B // 2, B // 4, 0, -1):
        _, i_k = tt.temporal_backtrack(phis, btilde, jump, adm.levels, cap)
        _, i_c = tt.temporal_backtrack(ref, btilde.cpu(), jump.cpu(), adm.levels, cap)
        assert i_k.device.type == "cuda" and torch.equal(i_k.cpu(), i_c), cap


def test_fma_on_the_card_is_exact(cuda_device):
    from mioc_tpu_torch.ops import xla_order

    rng = np.random.default_rng(3)
    a, b, c = (torch.as_tensor(rng.normal(size=4099) * s, device=cuda_device)
               for s in (1.0, 1e-2, 1.0))
    want = xla_order.fma_exact(a.cpu(), b.cpu(), c.cpu())
    assert torch.equal(xla_order.fma_exact(a, b, c).cpu(), want)
    assert torch.equal(xla_order.fma(a, b, c).cpu(), want)
    assert torch.equal(xla_order.window_sum(a.reshape(1, -1)).cpu(),
                       xla_order.window_sum(a.cpu().reshape(1, -1)))


def test_small_mixed_solve_equals_cpu(cuda_device):
    """mixed_solve at nt=48, 2 rounds: the card's rounds, history and
    control equal the CPU's bit for bit, through dp_build and chase."""
    from mioc_tpu_torch.models import LVMMixedObj
    from mioc_tpu_torch.ops.backtrack_cuda import chase
    from mioc_tpu_torch.ops.bellman_cuda import dp_build
    from mioc_tpu_torch.solvers.mixed import MixedParameters, mixed_solve
    from mioc_tpu_torch.solvers.trm import TRMParameters

    par = MixedParameters(trm=TRMParameters(beta=1e-4, delta0=2.0, p=np.inf), rounds=2)
    n_b, n_c = dp_build.launches, chase.launches
    res = mixed_solve(LVMMixedObj(nt=48, device=cuda_device), par, seed=0)
    assert dp_build.launches > n_b and chase.launches > n_c
    ref = mixed_solve(LVMMixedObj(nt=48, device="cpu"), par, seed=0)
    assert (res.rounds, res.converged) == (ref.rounds, ref.converged)
    assert res.history == ref.history
    np.testing.assert_array_equal(res.x, ref.x)


def test_temporal_route_solve_on_the_card(cuda_device):
    from mioc_tpu_torch.models import LVMObj
    from mioc_tpu_torch.ops.backtrack_cuda import chase
    from mioc_tpu_torch.ops.bellman_cuda import dp_build
    from mioc_tpu_torch.solvers.trm import TRMParameters, trm_solve

    par = TRMParameters(beta=1e-3, p=1, delta0=0.3, dp_backend="temporal")
    n_b, n_c = dp_build.launches, chase.launches
    res = trm_solve(LVMObj(nt=120, device=cuda_device), par, seed=5)
    assert (dp_build.launches, chase.launches) == (n_b, n_c)
    ref = trm_solve(LVMObj(nt=120, device="cpu"), par, seed=5)
    assert (res.iterations, res.inner_steps) == (ref.iterations, ref.inner_steps)
    np.testing.assert_array_equal(res.u, ref.u)
    np.testing.assert_allclose(res.J, ref.J, rtol=1e-12)


@pytest.mark.parametrize("name,levels,nt,B,D", [
    ("fishing", lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1), 1024, 170, 4),
    ("heat", lambda: product_levels([list(range(6))] * 2), 200, 40, 8),
])
def test_padded_table_chases_on_the_card(cuda_device, name, levels, nt, B, D):
    """The level-sharded build's padded tables (L = 3 → 4, 36 → 40; here the
    plain build of the padded inputs, which is what a sharded build returns)
    chased on the card by ``chase``, ``chase_batched`` and ``chase_trials``:
    the plain walk's indices, and the unpadded tables' (no padded row is
    ever selected)."""
    from mioc_tpu_torch.ops.backtrack_cuda import chase, chase_batched, chase_trials
    from mioc_tpu_torch.parallel.shard_dp import pad_level_axis

    adm = levels()
    stage, btilde, jump, smax = _tables(adm, nt, B, torch.float64, torch.device("cpu"))
    stage_p, btilde_p, jump_p, L = pad_level_axis(stage, btilde, jump, D, B)
    assert stage_p.shape[1] == -(-L // D) * D > L
    U, phi0 = (t.to(cuda_device) for t in tb.build_tables_plain(stage_p, btilde_p, jump_p, B, smax))
    bt = btilde_p.to(cuda_device)
    Uk, phik = tb.build_tables(stage.to(cuda_device), btilde.to(cuda_device),
                               jump.to(cuda_device), B, smax)
    caps = [B, B // 2, B // 4, 1, 0, -1]
    for cap in caps:
        want = tb.backtrack_plain(U.cpu(), phi0.cpu(), bt.cpu(), cap)
        assert torch.equal(chase(U, phi0, bt, cap).cpu(), want), cap
        assert torch.equal(chase(Uk, phik, btilde.to(cuda_device), cap).cpu(), want), cap
    S = 3
    Us, phis, bts = (t[None].expand(S, *t.shape).contiguous() for t in (U, phi0, bt))
    per = torch.tensor(caps[:S], dtype=torch.int32, device=cuda_device)
    got = chase_batched(Us, phis, bts, per).cpu()
    for s in range(S):
        assert torch.equal(got[s], tb.backtrack_plain(U.cpu(), phi0.cpu(), bt.cpu(), caps[s]))
    trials = torch.tensor([caps, caps[::-1], caps], dtype=torch.int32, device=cuda_device)
    got = chase_trials(Us, phis, bts, trials).cpu()
    for s in range(S):
        for k, cap in enumerate(trials[s].tolist()):
            assert torch.equal(got[s, k], tb.backtrack_plain(U.cpu(), phi0.cpu(), bt.cpu(), cap))


def test_two_rank_gloo_world_on_the_card(cuda_device, tmp_path):
    """Two ranks share ``cuda:0`` over gloo (NCCL refuses two ranks on one
    GPU): the level-sharded fishing tables equal ``dp_build``'s bit for bit
    and chase to its paths (``test_torch_parallel.run_world``)."""
    from test_torch_parallel import run_world

    runs = run_world(2, tmp_path, ["cuda_tables"])["cuda_tables"]
    for r in runs:
        np.testing.assert_array_equal(r["U"], runs[0]["U"])
        np.testing.assert_array_equal(r["U"], r["Uk"])
        np.testing.assert_array_equal(r["phi"].view(np.int64), r["phik"].view(np.int64))
        np.testing.assert_array_equal(r["idx"], r["idxk"])


def test_sqrt_on_the_card_is_correctly_rounded(cuda_device):
    from mioc_tpu_torch.ops import xla_order

    rng = np.random.default_rng(5)
    x = np.concatenate([[2.0, 3.0, 0.5], rng.random(100000) * 4.0,
                        np.exp(rng.normal(size=20000) * 40)])
    got = xla_order.sqrt(torch.as_tensor(x, device=cuda_device)).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.int64), np.sqrt(x).view(np.int64))


@pytest.mark.parametrize("unroll", [1, 8])
@pytest.mark.parametrize("cls", ["DTMObj", "VPOObj", "FullerObj", "LVMObj", "LVMMixedObj"])
def test_ode_sweeps_on_the_card_equal_the_cpu(cuda_device, cls, unroll):
    """The ODE sweeps round as the JAX package's CPU sweeps on either
    device: states, f, ∇f and adjoints on the card bit-equal to the CPU's
    (NaN where the CPU has NaN), at a scan remainder (nt=57)."""
    from mioc_tpu_torch import models
    from mioc_tpu_torch.utils.init import rand_func

    def bits(t):
        a = t.detach().cpu().numpy().astype(np.float64)
        b = a.view(np.int64).copy()
        b[np.isnan(a)] = 0x7FF8000000000000
        return b

    out = {}
    for dev in ("cpu", cuda_device):
        obj = getattr(models, cls)(nt=57, device=dev)
        obj.sweep_unroll = unroll
        obj._build()
        X = torch.as_tensor(np.stack([rand_func(obj, seed=s) for s in range(3)]),
                            dtype=obj.dtype, device=obj.device)
        f, ys = obj._forward_batch(X)
        df, lam = obj._adjoint_batch(X, ys)
        out[str(dev)] = [bits(t) for t in (f, ys, df, lam)]
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        np.testing.assert_array_equal(a, b)


def test_fuller_terminal_weight_on_the_card_equals_the_cpu(cuda_device):
    """Fuller's soft terminal condition (G_y's masked weights a tensor on
    the card): states, f, ∇f and adjoints bit-equal to the CPU's."""
    from mioc_tpu_torch import models
    from mioc_tpu_torch.utils.init import rand_func

    out = {}
    for dev in ("cpu", cuda_device):
        obj = models.FullerObj(nt=240, terminal_weight=50.0, device=dev)
        X = torch.as_tensor(np.stack([rand_func(obj, seed=s) for s in range(3)]),
                            dtype=obj.dtype, device=obj.device)
        f, ys = obj._forward_batch(X)
        df, lam = obj._adjoint_batch(X, ys)
        out[str(dev)] = [t.cpu().numpy() for t in (f, ys, df, lam)]
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        np.testing.assert_array_equal(a.view(np.int64), b.view(np.int64))


def _lvm_controls(obj, rows, kind, seed):
    """``rows`` controls of one ``kind``: binary (``rand_func``), relaxed
    (uniform in [0, 1]), or relaxed with a NaN at one step of every row."""
    from mioc_tpu_torch.utils.init import rand_func

    rng = np.random.default_rng(seed)
    if kind == "binary":
        X = np.stack([rand_func(obj, seed=seed + r) for r in range(rows)])
    else:
        X = rng.random((rows, obj.nt, obj.nx))
        if kind == "nan":
            X[np.arange(rows), rng.integers(0, obj.nt, rows), rng.integers(0, obj.nx, rows)] = np.nan
    return torch.as_tensor(X, dtype=obj.dtype, device=obj.device)


def _bits(t):
    """int64 view with every NaN the same (its sign and payload are not part
    of the claim)."""
    a = t.detach().cpu().numpy().astype(np.float64)
    b = a.view(np.int64).copy()
    b[np.isnan(a)] = 0x7FF8000000000000
    return b


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rows", [1, 32, 288])
@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
@pytest.mark.parametrize("nt", [8, 39, 57, 1024, 1200])
def test_lvm_sweep_kernels_bit_equal_the_torch_path(cuda_device, nt, unroll, rows, dtype):
    """On the card, in float64 and in float32, ``LVMObj``'s sweeps are one
    launch each of ``csrc/ode_lvm.cu``, and give the bits of the plain
    PyTorch sweeps on the card: f, the states, ∇f and λ, for binary and
    relaxed controls and rows holding a NaN."""
    from mioc_tpu_torch import models
    from mioc_tpu_torch.ops import ode_cuda

    obj = models.LVMObj(nt=nt, device=cuda_device, dtype=dtype)
    obj.sweep_unroll = unroll
    obj._build()
    for i, kind in enumerate(("binary", "relaxed", "nan")):
        X = _lvm_controls(obj, rows, kind, seed=100 * nt + 10 * unroll + i)
        n_f, n_a = ode_cuda.lvm_forward.launches, ode_cuda.lvm_adjoint.launches
        f, ys = obj._forward_batch(X)
        assert (ode_cuda.lvm_forward.launches, ode_cuda.lvm_adjoint.launches) == (n_f + 1, n_a)
        f_t, ys_t = obj._forward_batch_torch(X)
        df, lam = obj._adjoint_batch(X, ys_t)
        assert (ode_cuda.lvm_forward.launches, ode_cuda.lvm_adjoint.launches) == (n_f + 1,
                                                                                   n_a + 1)
        df_t, lam_t = obj._adjoint_batch_torch(X, ys_t)
        torch.cuda.synchronize()
        assert f.shape == (rows,) and ys.shape == (nt, rows, 2)
        assert f.dtype == ys.dtype == df.dtype == lam.dtype == dtype
        assert df.shape == (rows, nt, 3) and lam.shape == (rows, nt, 2)
        for name, a, b in (("f", f, f_t), ("ys", ys, ys_t), ("df", df, df_t),
                           ("lam", lam, lam_t)):
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{kind} {name}")
        if kind == "nan":
            assert torch.isnan(f).all()
        else:
            assert torch.isfinite(df).all()


def test_lvm_sweeps_launch_once_per_evaluation(cuda_device):
    """Through the objective's protocol (``eval_f_``, ``eval_df_``) an
    evaluation on the card, in float64 and in float32, is one forward and
    one adjoint launch."""
    from mioc_tpu_torch import models
    from mioc_tpu_torch.ops import ode_cuda
    from mioc_tpu_torch.utils.init import rand_func

    for dtype in (torch.float64, torch.float32):
        obj = models.LVMObj(nt=120, device=cuda_device, dtype=dtype)
        obj.x = obj.as_control(rand_func(obj, seed=3))
        n_f, n_a = ode_cuda.lvm_forward.launches, ode_cuda.lvm_adjoint.launches
        obj.eval_f_()
        obj.eval_df_()
        assert (ode_cuda.lvm_forward.launches - n_f,
                ode_cuda.lvm_adjoint.launches - n_a) == (1, 1), dtype
