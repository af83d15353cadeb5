"""Port vs JAX package: the Bellman DP (plain PyTorch version on the CPU).

* The plain build equals ``mioc_tpu.ops.bellman.build_tables`` (XLA scan) bit
  for bit at float64, and the Pallas kernel ``build_tables_pallas`` (interpret
  mode, which always computes in float32) bit for bit at float32.
* The plain chase equals the JAX ``backtrack`` and ``backtrack_pallas``.
* Ports of the DP-vs-brute-force tests of tests/test_bellman.py.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``; they cannot run here.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from mioc_tpu.ops import bellman as jb  # noqa: E402
from mioc_tpu.ops.backtrack_pallas import backtrack_pallas  # noqa: E402
from mioc_tpu.ops.bellman_pallas import build_tables_pallas  # noqa: E402
from mioc_tpu.ops.levels import (  # noqa: E402
    bounded_sum_levels,
    jump_cost_table,
    product_levels,
)
from mioc_tpu_torch import interop  # noqa: E402
from mioc_tpu_torch.ops import bellman as tb  # noqa: E402

SETS = {
    3: lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1),
    5: lambda: product_levels([[-2, -1, 0, 1, 2]]),
    36: lambda: product_levels([list(range(6))] * 2),
}


def _instance(L, nt, B, seed, p=1, beta=0.05, tau=0.05):
    """Same inputs for both packages: numpy grad/u_old/jump from a seed."""
    s = SETS[L]()
    rng = np.random.default_rng(seed)
    grad = rng.normal(size=(nt, s.M))
    u_old = s.levels[rng.integers(0, s.L, size=nt)]
    jump = jump_cost_table(s.levels, p=p, beta=beta)
    smax = jb.max_budget_use(s.levels)
    return s, grad, u_old, jump, smax, tau


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("L", [3, 5, 36])
def test_stage_tables_match(L):
    s, grad, u_old, _, _, tau = _instance(L, 40, 10, seed=L)
    st_j, bt_j = jb.stage_tables(jnp.asarray(grad), jnp.asarray(u_old),
                                 jnp.asarray(s.levels), tau)
    st_t, bt_t = tb.stage_tables(_t(grad), _t(u_old), s.levels, tau)
    np.testing.assert_allclose(st_t.numpy(), np.asarray(st_j), rtol=1e-15, atol=0)
    np.testing.assert_array_equal(bt_t.numpy(), np.asarray(bt_j))
    assert bt_t.dtype == torch.int32


@pytest.mark.parametrize("L,nt,B", [(3, 120, 17), (5, 90, 16), (36, 30, 12),
                                    (3, 1, 4), (5, 2, 0)])
def test_plain_build_bit_equal_scan_f64(L, nt, B):
    """Same stage/b̃ arrays into both builds; U and phi0 equal bit for bit."""
    s, grad, u_old, jump, smax, tau = _instance(L, nt, B, seed=nt + L)
    st, bt = jb.stage_tables(jnp.asarray(grad), jnp.asarray(u_old),
                             jnp.asarray(s.levels), tau)
    U_j, phi_j = jb.build_tables(st, bt, jnp.asarray(jump), B, smax)
    U_t, phi_t = tb.build_tables(_t(st), _t(bt), _t(jump), B, smax)
    assert U_t.shape == (nt - 1, L, B + 1) and phi_t.shape == (L, B + 1)
    assert U_t.dtype == tb.u_dtype(L) and phi_t.dtype == torch.float64
    np.testing.assert_array_equal(U_t.numpy(), np.asarray(U_j))
    np.testing.assert_array_equal(phi_t.numpy(), np.asarray(phi_j))


@pytest.mark.parametrize("L,nt,B", [(3, 70, 17), (5, 50, 16), (36, 12, 12)])
def test_plain_build_bit_equal_pallas_f32(L, nt, B):
    """At float32 the plain build equals the TPU kernel (interpret mode) on
    the unpadded region — the plain version holds the TPU kernel's own
    semantics, so the CUDA kernel held against it holds them too."""
    s, grad, u_old, jump, smax, tau = _instance(L, nt, B, seed=3 * L, p=2)
    st, bt = jb.stage_tables(jnp.asarray(grad), jnp.asarray(u_old),
                             jnp.asarray(s.levels), tau)
    U_p, phi_p = build_tables_pallas(st, bt, jnp.asarray(jump), B, smax,
                                     interpret=True)
    U_t, phi_t = tb.build_tables(_t(st, torch.float32), _t(bt),
                                 _t(jump, torch.float32), B, smax)
    np.testing.assert_array_equal(U_t.numpy(), np.asarray(U_p)[:, :L, : B + 1])
    np.testing.assert_array_equal(phi_t.numpy(), np.asarray(phi_p)[:L, : B + 1])


@pytest.mark.parametrize("nt", [129, 256, 300])
def test_backtrack_matches_scan_and_pallas(nt):
    """The plain chase equals the JAX scan chase and the Pallas chase
    kernel (interpret) for full, small and zero budgets."""
    s, grad, u_old, jump, smax, tau = _instance(3, nt, 17, seed=5)
    B = 17
    levels = jnp.asarray(s.levels)
    st, bt = jb.stage_tables(jnp.asarray(grad), jnp.asarray(u_old), levels, tau)
    U_j, phi_j = jb.build_tables(st, bt, jnp.asarray(jump), B, smax)
    U_p, phi_p = build_tables_pallas(st, bt, jnp.asarray(jump), B, smax,
                                     interpret=True)
    U_t, phi_t = tb.build_tables(_t(st), _t(bt), _t(jump), B, smax)
    for Bn in (B, 5, 0):
        u_j, i_j = jb.backtrack(U_j, phi_j, bt, levels, jnp.int32(Bn))
        _, i_p = backtrack_pallas(U_p, phi_p, bt, levels, jnp.int32(Bn),
                                  interpret=True)
        u_t, i_t = tb.backtrack(U_t, phi_t, _t(bt), s.levels, Bn)
        assert i_t.dtype == torch.int32 and u_t.shape == (nt, 3)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
        np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))


@pytest.mark.parametrize("L,nt,B", [(3, 200, 23), (36, 20, 12)])
def test_pallas_tables_carried_across_chase_equal(L, nt, B):
    """Tables built by the TPU kernel, carried across with ``interop`` into
    the port's exact layout and chased by the port, give the JAX chase."""
    s, grad, u_old, jump, smax, tau = _instance(L, nt, B, seed=11, p=np.inf,
                                                beta=1e-3)
    levels = jnp.asarray(s.levels)
    st, bt = jb.stage_tables(jnp.asarray(grad), jnp.asarray(u_old), levels, tau)
    U_p, phi_p = build_tables_pallas(st, bt, jnp.asarray(jump), B, smax,
                                     interpret=True, raw_u=True)
    U_t, phi_t = interop.tables_from_pallas(U_p, phi_p, nt=nt, L=L, B=B,
                                            device="cpu")
    assert U_t.shape == (nt - 1, L, B + 1) and U_t.is_contiguous()
    for Bn in (B, B // 2, 1, 0):
        _, i_p = backtrack_pallas(U_p, phi_p, bt, levels, jnp.int32(Bn),
                                  interpret=True)
        _, i_t = tb.backtrack(U_t, phi_t, _t(bt), s.levels, Bn)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))


def test_interop_rejects_small_tables():
    with pytest.raises(ValueError):
        interop.tables_from_pallas(np.zeros((3, 8, 128), np.int8),
                                   np.zeros((8, 128), np.float32),
                                   nt=10, L=3, B=5, device="cpu")


# ------------------------------------------------------ brute-force ports

def brute_force(stage, btilde, jump, B):
    """Min path cost over all level sequences with total budget ≤ B."""
    nt, L = stage.shape
    best = np.inf
    for path in itertools.product(range(L), repeat=nt):
        b = sum(btilde[i, path[i]] for i in range(nt))
        if b > B:
            continue
        c = sum(stage[i, path[i]] for i in range(nt))
        c += sum(jump[path[i], path[i + 1]] for i in range(nt - 1))
        best = min(best, c)
    return best


def path_cost(stage, btilde, jump, idx):
    nt = stage.shape[0]
    c = sum(stage[i, idx[i]] for i in range(nt))
    c += sum(jump[idx[i], idx[i + 1]] for i in range(nt - 1))
    b = sum(btilde[i, idx[i]] for i in range(nt))
    return c, b


def _check_brute(s, grad, u_old, jump, tau, B):
    u, idx, (U, phi0, bt) = tb.dp_solve(_t(grad), _t(u_old), s.levels, _t(jump),
                                        tau, B)
    stage, btilde = tb.stage_tables(_t(grad), _t(u_old), s.levels, tau)
    stage, btilde = stage.numpy(), btilde.numpy()
    ref = brute_force(stage, btilde, jump, B)
    got, used = path_cost(stage, btilde, jump, idx.numpy())
    assert used <= B
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_array_equal(u.numpy(), s.levels[idx.numpy()])
    return U, phi0, stage, btilde


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("p", [1, 2, np.inf])
def test_dp_matches_brute_force_sos1(seed, p):
    rng = np.random.default_rng(seed)
    s = bounded_sum_levels([[0, 1]] * 3, 1, 1)
    nt, B = 6, 4
    grad = rng.normal(size=(nt, s.M))
    u_old = s.levels[rng.integers(0, s.L, size=nt)]
    _check_brute(s, grad, u_old, jump_cost_table(s.levels, p=p, beta=0.37), 0.1, B)


@pytest.mark.parametrize("seed", [0, 5])
def test_dp_matches_brute_force_multilevel(seed):
    rng = np.random.default_rng(seed)
    s = product_levels([[-2, -1, 0, 1, 2]])
    nt, B = 5, 6
    grad = rng.normal(size=(nt, s.M))
    u_old = s.levels[rng.integers(0, s.L, size=nt)]
    _check_brute(s, grad, u_old, jump_cost_table(s.levels, p=1, beta=0.11), 0.05, B)


def test_budget_halving_reuses_tables():
    """A smaller budget re-chased on the SAME tables is optimal for that
    budget (multi-trust.jl:108-110 reuse)."""
    rng = np.random.default_rng(7)
    s = bounded_sum_levels([[0, 1]] * 3, 1, 1)
    nt, B, tau = 8, 6, 0.1
    grad = rng.normal(size=(nt, s.M))
    u_old = s.levels[rng.integers(0, s.L, size=nt)]
    jump = jump_cost_table(s.levels, p=2, beta=0.2)
    U, phi0, stage, btilde = _check_brute(s, grad, u_old, jump, tau, B)
    calls = tb.build_tables_plain.calls
    for B_new in [4, 2, 1, 0]:
        _, idx = tb.backtrack(U, phi0, _t(btilde), s.levels, B_new)
        got, used = path_cost(stage, btilde, jump, idx.numpy())
        assert used <= B_new
        np.testing.assert_allclose(got, brute_force(stage, btilde, jump, B_new),
                                   rtol=1e-12)
    assert tb.build_tables_plain.calls == calls  # no rebuild


def test_zero_budget_returns_u_old():
    rng = np.random.default_rng(3)
    s = bounded_sum_levels([[0, 1]] * 3, 1, 1)
    nt = 10
    grad = rng.normal(size=(nt, s.M))
    u_old = s.levels[rng.integers(0, s.L, size=nt)]
    u, _, _ = tb.dp_solve(_t(grad), _t(u_old), s.levels,
                          _t(jump_cost_table(s.levels, p=1, beta=0.5)), 0.1, 0)
    np.testing.assert_array_equal(u.numpy(), u_old)


def test_huge_budget_equals_unconstrained_viterbi():
    rng = np.random.default_rng(11)
    s = product_levels([[-2, -1, 0, 1, 2]])
    nt, tau = 12, 0.1
    grad = rng.normal(size=(nt, 1))
    u_old = s.levels[rng.integers(0, 5, size=nt)]
    jump = jump_cost_table(s.levels, p=1, beta=0.25)
    stage = tb.stage_tables(_t(grad), _t(u_old), s.levels, tau)[0].numpy()
    phi = stage[-1].copy()
    for i in range(nt - 2, -1, -1):
        phi = stage[i] + (jump + phi[None, :]).min(axis=1)
    B = nt * tb.max_budget_use(s.levels)
    _, idx, _ = tb.dp_solve(_t(grad), _t(u_old), s.levels, _t(jump), tau, B)
    idx = idx.numpy()
    got = sum(stage[i, idx[i]] for i in range(nt)) + sum(
        jump[idx[i], idx[i + 1]] for i in range(nt - 1))
    np.testing.assert_allclose(got, phi.min(), rtol=1e-12)


def test_u_dtype_switches_at_127():
    assert tb.u_dtype(127) == torch.int8 and tb.u_dtype(128) == torch.int32


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """A tensor that is neither on the CPU nor on the card goes to the CUDA
    wrapper, which raises instead of falling back to the plain version."""
    st = torch.zeros((4, 3), device="meta", dtype=torch.float64)
    bt = torch.zeros((4, 3), device="meta", dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tb.build_tables(st, bt, torch.zeros((3, 3), device="meta",
                                            dtype=torch.float64), 2, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tb.backtrack(torch.zeros((3, 3, 3), device="meta", dtype=torch.int8),
                     torch.zeros((3, 3), device="meta", dtype=torch.float64),
                     bt, np.eye(3), 2)
