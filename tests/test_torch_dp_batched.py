"""Port vs JAX package: the batched DP, the row-wise decision sums and the
batched ODE sweeps (plain PyTorch versions on the CPU).

* The plain batched build equals the TPU kernel ``build_tables_pallas_batched``
  (interpret mode, float32) on the unpadded region, and ``jax.vmap`` of the
  scan build at float64, bit for bit; start ``s`` equals the single build.
* The plain batched chase equals ``_backtrack_batched_impl`` (interpret) at a
  cap per start; the plain trial chase equals ``jax.vmap`` of
  ``backtrack_pallas_trials`` (interpret); both equal the single chase.
* ``stage_tables``, ``tv_rows``, ``iv_rows`` and the batched sweeps give
  every row the bits of the single call, whatever the batch size.
* A numpy model of ``csrc/dp_build_batched.cu``'s cluster form (budget
  slices per CTA, the halo pushed into the receiver's next Φ, one barrier
  per step, each entry read written in that step or poisoned) for C ∈ {1,
  2, 3, 16}, held bit for bit against the plain batched build and the JAX
  package's scan and Pallas builds; ``bellman_cuda.batched_build_plan``; and
  the single-start build's plan and launch, the card's answers stubbed.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from mioc_tpu.models import LVMObj as JaxLVM  # noqa: E402
from mioc_tpu.ops import bellman as jb  # noqa: E402
from mioc_tpu.ops.backtrack_pallas import (  # noqa: E402
    _backtrack_batched_impl,
    backtrack_pallas_trials,
)
from mioc_tpu.ops.bellman_pallas import build_tables_pallas_batched  # noqa: E402
from mioc_tpu.ops.levels import (  # noqa: E402
    bounded_sum_levels,
    jump_cost_table,
    product_levels,
)
from mioc_tpu.utils.init import rand_func  # noqa: E402
from mioc_tpu_torch import interop  # noqa: E402
from mioc_tpu_torch.models import LVMObj  # noqa: E402
from mioc_tpu_torch.ops import bellman as tb  # noqa: E402
from mioc_tpu_torch.ops import bellman_cuda as bc  # noqa: E402
from mioc_tpu_torch.ops.tv import fold_sum, iv_rows, tv_rows  # noqa: E402

SETS = {
    3: lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1),
    5: lambda: product_levels([[-2, -1, 0, 1, 2]]),
    36: lambda: product_levels([list(range(6))] * 2),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Tiny tensor ops gain nothing from threads, and torch's thread pool
    competes with the other test processes for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _instance(L, S, nt, seed, p=1, beta=0.05, tau=0.05):
    """S starts' stage tables from seeded numpy gradients and admissible
    u_old rows, computed by the JAX package; the shared jump table."""
    s = SETS[L]()
    rng = np.random.default_rng(seed)
    grad = rng.normal(size=(S, nt, s.M))
    u_old = s.levels[rng.integers(0, s.L, size=(S, nt))]
    st, bt = jax.vmap(lambda g, u: jb.stage_tables(g, u, jnp.asarray(s.levels),
                                                   tau))(grad, u_old)
    jump = jump_cost_table(s.levels, p=p, beta=beta)
    return s, np.asarray(st), np.asarray(bt), jump, jb.max_budget_use(s.levels)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


@pytest.mark.parametrize("L,S,nt,B", [(3, 3, 60, 17), (5, 2, 40, 16), (36, 2, 12, 12)])
def test_batched_build_bit_equal_vmap_scan_f64(L, S, nt, B):
    s, st, bt, jump, smax = _instance(L, S, nt, seed=L + nt)
    U_j, phi_j = jax.vmap(lambda a, b: jb.build_tables(a, b, jnp.asarray(jump), B,
                                                       smax))(st, bt)
    U_t, phi_t = tb.build_tables_batched(_t(st), _t(bt), _t(jump), B, smax)
    assert U_t.shape == (S, nt - 1, L, B + 1) and U_t.dtype == tb.u_dtype(L)
    np.testing.assert_array_equal(U_t.numpy(), np.asarray(U_j))
    np.testing.assert_array_equal(phi_t.numpy(), np.asarray(phi_j))
    for k in range(S):  # start k has the bits of the single build
        U_1, phi_1 = tb.build_tables_plain(_t(st[k]), _t(bt[k]), _t(jump), B, smax)
        assert torch.equal(U_t[k], U_1) and torch.equal(phi_t[k], phi_1)


@pytest.mark.parametrize("L,S,nt,B", [(3, 3, 70, 17), (36, 2, 12, 12)])
def test_batched_build_bit_equal_pallas_f32(L, S, nt, B):
    s, st, bt, jump, smax = _instance(L, S, nt, seed=3 * L, p=2)
    U_p, phi_p = build_tables_pallas_batched(jnp.asarray(st, jnp.float32), bt,
                                             jnp.asarray(jump, jnp.float32), B,
                                             smax, interpret=True, raw_u=True)
    U_c, phi_c = interop.tables_from_pallas(U_p, phi_p, nt=nt, L=L, B=B, device="cpu")
    U_t, phi_t = tb.build_tables_batched(_t(st, torch.float32), _t(bt),
                                         _t(jump, torch.float32), B, smax)
    assert U_c.shape == U_t.shape and phi_c.shape == phi_t.shape
    assert torch.equal(U_t, U_c) and torch.equal(phi_t, phi_c)


def _pallas_tables(L, S, nt, B, seed):
    s, st, bt, jump, smax = _instance(L, S, nt, seed=seed, p=np.inf, beta=1e-3)
    U_p, phi_p = build_tables_pallas_batched(jnp.asarray(st, jnp.float32), bt,
                                             jnp.asarray(jump, jnp.float32), B,
                                             smax, interpret=True)
    U_t, phi_t = interop.tables_from_pallas(U_p, phi_p, nt=nt, L=L, B=B, device="cpu")
    return s, bt, U_p, phi_p, U_t, phi_t


@pytest.mark.parametrize("L,S,nt,B", [(3, 4, 140, 23), (36, 3, 12, 12)])
def test_batched_chase_equals_pallas_and_single(L, S, nt, B):
    s, bt, U_p, phi_p, U_t, phi_t = _pallas_tables(L, S, nt, B, seed=L + 1)
    caps = np.array([B, B // 2, 0, 1][:S], np.int32)
    levels = jnp.asarray(s.levels)
    _, i_p = _backtrack_batched_impl(U_p, phi_p, bt, levels, jnp.asarray(caps),
                                     interpret=True)
    u_t, i_t = tb.backtrack_batched(U_t, phi_t, _t(bt), s.levels, _t(caps))
    assert i_t.dtype == torch.int32 and u_t.shape == (S, nt, s.M)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    for k in range(S):
        i_1 = tb.backtrack_plain(U_t[k], phi_t[k], _t(bt[k]), int(caps[k]))
        assert torch.equal(i_t[k], i_1)
    # A cap past B masks nothing (the Pallas tables' padded budget lanes hold
    # values past B, so this is held against the compact-table chase only).
    _, i_big = tb.backtrack_batched(U_t, phi_t, _t(bt), s.levels, B + 3)
    assert torch.equal(i_big, tb.backtrack_batched(U_t, phi_t, _t(bt), s.levels, B)[1])
    # A shared cap, and tables expanded along the start axis (stride 0).
    _, i_s = tb.backtrack_batched(U_t[:1].expand(S, -1, -1, -1), phi_t[:1].expand(
        S, -1, -1), _t(bt[:1]).expand(S, -1, -1), s.levels, _t(caps))
    for k in range(S):
        assert torch.equal(i_s[k], tb.backtrack_plain(U_t[0], phi_t[0], _t(bt[0]),
                                                      int(caps[k])))


@pytest.mark.parametrize("L,S,nt,B", [(3, 3, 140, 23), (36, 2, 12, 12)])
def test_trial_chase_equals_pallas_and_single(L, S, nt, B):
    s, bt, U_p, phi_p, U_t, phi_t = _pallas_tables(L, S, nt, B, seed=2 * L)
    trials = np.array([[B, B // 2, B // 4, 1, 0]] * S, np.int32)
    trials[-1] = trials[-1][::-1]
    levels = jnp.asarray(s.levels)
    _, i_p = jax.vmap(lambda U, p, b, c: backtrack_pallas_trials(
        U, p, b, levels, c, interpret=True))(U_p, phi_p, jnp.asarray(bt), trials)
    u_t, i_t = tb.backtrack_trials(U_t, phi_t, _t(bt), s.levels, _t(trials))
    assert i_t.shape == (S, trials.shape[1], nt) and u_t.shape == (*i_t.shape, s.M)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    # A cap past B masks nothing (held against the compact-table chase).
    trials = np.concatenate([trials, np.full((S, 1), B + 9, np.int32)], axis=1)
    _, i_t = tb.backtrack_trials(U_t, phi_t, _t(bt), s.levels, _t(trials))
    assert torch.equal(i_t[:, -1], tb.backtrack_batched(U_t, phi_t, _t(bt), s.levels,
                                                        B)[1])
    for k in range(S):
        for t, cap in enumerate(trials[k]):
            assert torch.equal(i_t[k, t], tb.backtrack_plain(U_t[k], phi_t[k],
                                                             _t(bt[k]), int(cap)))


def test_plain_batched_forms_count_calls():
    s, st, bt, jump, smax = _instance(3, 2, 10, seed=0)
    n = (tb.build_tables_batched_plain.calls, tb.backtrack_batched_plain.calls,
         tb.backtrack_trials_plain.calls)
    U, phi = tb.build_tables_batched(_t(st), _t(bt), _t(jump), 4, smax)
    tb.backtrack_batched(U, phi, _t(bt), s.levels, 4)
    tb.backtrack_trials(U, phi, _t(bt), s.levels, _t([[4, 0], [1, 2]]))
    assert (tb.build_tables_batched_plain.calls, tb.backtrack_batched_plain.calls,
            tb.backtrack_trials_plain.calls) == (n[0] + 1, n[1] + 1, n[2] + 1)


def test_batched_wrappers_refuse_non_cuda_tensors():
    st = torch.zeros((2, 4, 3), device="meta", dtype=torch.float64)
    bt = torch.zeros((2, 4, 3), device="meta", dtype=torch.int32)
    U = torch.zeros((2, 3, 3, 3), device="meta", dtype=torch.int8)
    phi = torch.zeros((2, 3, 3), device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tb.build_tables_batched(st, bt, torch.zeros((3, 3), device="meta",
                                                    dtype=torch.float64), 2, 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tb.backtrack_batched(U, phi, bt, np.eye(3), 2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tb.backtrack_trials(U, phi, bt, np.eye(3), [[2], [1]])


def test_interop_takes_batched_tables():
    U = np.arange(2 * 5 * 8 * 128).reshape(2, 5, 8, 128).astype(np.int32)
    phi = np.ones((2, 8, 128), np.float32)
    U_t, phi_t = interop.tables_from_pallas(U, phi, nt=4, L=3, B=6, device="cpu")
    assert U_t.shape == (2, 3, 3, 7) and phi_t.shape == (2, 3, 7)
    np.testing.assert_array_equal(U_t.numpy(), U[:, :3, :3, :7])
    with pytest.raises(ValueError):
        interop.tables_from_pallas(U, phi[0], nt=4, L=3, B=6, device="cpu")


# ---------------------------------------------- per-row bits, any batch size


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [3, 36])
def test_stage_tables_rows_bit_equal_single(L, dtype):
    s = SETS[L]()
    rng = np.random.default_rng(L)
    grad = _t(rng.normal(size=(4, 30, s.M)), dtype)
    u_old = _t(s.levels[rng.integers(0, s.L, size=(4, 30))], dtype)
    st, bt = tb.stage_tables(grad, u_old, s.levels, 0.05)
    for k in range(4):
        st1, bt1 = tb.stage_tables(grad[k], u_old[k], s.levels, 0.05)
        assert torch.equal(st[k], st1) and torch.equal(bt[k], bt1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("p", [1, 2, np.inf])
def test_tv_iv_rows_bit_equal_for_any_batch(p, dtype):
    s = SETS[3]()
    rng = np.random.default_rng(5)
    nt = 97
    us = _t(s.levels[rng.integers(0, s.L, size=(36, nt))], dtype)
    grad = _t(rng.normal(size=(nt, s.M)), dtype)
    u_old = us[0]
    one = [tv_rows(us[k:k + 1], p)[0] for k in range(36)]
    iv_one = [iv_rows(grad, u_old, us[k:k + 1])[0] for k in range(36)]
    for K in (1, 2, 9, 36):
        tv = tv_rows(us[:K], p)
        iv = iv_rows(grad, u_old, us[:K])
        assert tv.shape == iv.shape == (K,)
        for k in range(K):
            assert torch.equal(tv[k], one[k]) and torch.equal(iv[k], iv_one[k])
    # Against the JAX package's row-wise TV, to rounding.
    from mioc_tpu.ops.tv import _tv_rows

    np.testing.assert_allclose(tv_rows(us[:9], p).double().numpy(),
                               np.asarray(_tv_rows(jnp.asarray(us[:9].numpy()),
                                                   float(p))), rtol=1e-6)
    # A start axis in front: (S, K, nt, M) rows.
    both = iv_rows(torch.stack([grad, grad]), torch.stack([u_old, u_old]),
                   torch.stack([us[:9], us[9:18]]))
    assert torch.equal(both[1, 3], iv_one[12])


def test_fold_sum_is_a_sum():
    x = torch.arange(1.0, 101.0, dtype=torch.float64).reshape(4, 25)
    np.testing.assert_array_equal(fold_sum(x).numpy(), x.sum(1).numpy())
    assert fold_sum(torch.zeros(3, 0)).shape == (3,)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_sweeps_rows_bit_equal_single(dtype):
    nt = 120
    obj = LVMObj(nt=nt, device="cpu", dtype=dtype)
    xs = _t(np.stack([rand_func(JaxLVM(nt=nt), seed=s) for s in range(5)]), dtype)
    f, ys = obj._forward_batch(xs)
    assert f.shape == (5,) and ys.shape == (nt, 5, 2)
    df, lam = obj._adjoint_batch(xs, ys)
    assert df.shape == (5, nt, 3) and lam.shape == (5, nt, 2)
    for k in range(5):
        f1, ys1 = obj._forward(xs[k])
        df1, lam1 = obj._adjoint(xs[k], ys1)
        assert torch.equal(f[k], f1) and torch.equal(ys[:, k], ys1)
        assert torch.equal(df[k], df1) and torch.equal(lam[k], lam1)
    f3, _ = obj._forward_batch_with(xs[:3])
    assert torch.equal(f3, f[:3])


def test_batched_forward_matches_jax():
    nt = 150
    xs = np.stack([rand_func(JaxLVM(nt=nt), seed=s) for s in range(4)])
    jobj = JaxLVM(nt=nt)
    f_j, ys_j = jobj._forward_batch_with(jnp.asarray(xs), None)
    f_t, ys_t = LVMObj(nt=nt, device="cpu")._forward_batch_with(_t(xs))
    assert ys_t.shape == np.asarray(ys_j).shape == (nt, 4, 2)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-12)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-12)


# --------------------------------------- model of the budget-split cluster build


def cluster_build_model(stage, btilde, jump, B, smax, plan):
    """numpy model of one start of ``csrc/dp_build.cuh``'s cluster form under
    ``plan`` (a ``BatchedBuildPlan``; C = 1 is one block per start).

    CTA k owns budgets [lo_k, lo_{k+1}), lo_k = ⌊k(B+1)/C⌋, and keeps Φ in
    two flat buffers of L rows of RW = H + ⌈(B+1)/C⌉ entries, budget b at
    l·RW + b + H - lo_k (the H halo budgets below lo_k first).  Its threads
    own (l, lo_k + b0 + k·tpl), k < K.  Each step every CTA reads only its
    own current buffer, writes its slice into its next buffer and pushes each
    value whose budget lies in a higher CTA's halo into that CTA's next
    buffer; then (the barrier) the buffers swap.  Every next buffer is
    poisoned with NaN before the step, so an entry that the step did not
    write cannot pass for Φ_i."""
    stage, btilde, jump = (np.asarray(a) for a in (stage, btilde, jump))
    nt, L = stage.shape
    B1 = B + 1
    C, H, tpl, K = plan.C, plan.H, plan.tpl, plan.K
    smax = min(smax, B)
    RW = H + -(-B1 // C) if C > 1 else B1
    lo = [k * B1 // C for k in range(C + 1)]
    assert all(lo[k] < lo[k + 1] for k in range(C))  # no slice is empty
    INF = stage.dtype.type(np.inf)
    threads = [(t // tpl, t % tpl) for t in range(L * tpl)]

    def outputs(k):
        for l, b0 in threads:
            for j in range(K):
                b = lo[k] + b0 + j * tpl
                if b >= lo[k + 1]:
                    break
                yield l, b

    for k in range(C):  # every output of the slice, once
        assert sorted(outputs(k)) == [(l, b) for l in range(L)
                                      for b in range(lo[k], lo[k + 1])]
    at = [lambda l, b, k=k: l * RW + b + H - lo[k] for k in range(C)]
    bufs = [[np.full(L * RW, np.nan, stage.dtype) for _ in range(2)] for _ in range(C)]
    for k in range(C):  # terminal layer: the slice and the halo
        for l in range(L):
            for b in range(max(0, lo[k] - H), lo[k + 1]):
                bufs[k][0][at[k](l, b)] = stage[-1, l] if b == btilde[-1, l] else INF
    U = np.zeros((max(nt - 1, 0), L, B1), np.int64)
    cur = 0
    for i in range(nt - 2, -1, -1):
        for k in range(C):
            bufs[k][1 - cur][:] = np.nan
        for k in range(C):
            src, dst = bufs[k][cur], bufs[k][1 - cur]
            for l, b in outputs(k):
                sh = btilde[i, l]
                val, arg = INF, 0
                if sh <= smax and b >= sh:
                    col = at[k](0, b - sh)
                    val = src[col] + jump[l, 0]
                    for j in range(1, L):
                        cand = src[col + j * RW] + jump[l, j]
                        if cand < val:
                            val, arg = cand, j
                v = stage[i, l] + val
                dst[at[k](l, b)] = v
                U[i, l, b] = arg
                k2 = k + 1  # the halo push
                while k2 < C and b >= lo[k2] - H:
                    bufs[k2][1 - cur][at[k2](l, b)] = v
                    k2 += 1
        cur = 1 - cur
    phi0 = np.empty((L, B1), stage.dtype)
    for k in range(C):
        for l, b in outputs(k):
            phi0[l, b] = bufs[k][cur][at[k](l, b)]
    return U, phi0


CLUSTER_BUILDS = [
    # L, S, nt, B, C, outputs per thread: slices wider than the halo and
    # narrower (heat: smax = 10 against width 1 at C = 16, so a value is
    # pushed into ten CTAs' halos), uneven slices (C = 3), several outputs
    # per thread (tpl 2), nt 1 and 2, L = 1, B = 0.
    (3, 2, 30, 17, 2, None), (3, 2, 30, 17, 3, None), (3, 2, 30, 17, 16, None),
    (5, 2, 20, 16, 3, 2), (5, 1, 20, 16, 16, None), (36, 2, 5, 15, 16, None),
    (36, 1, 5, 15, 3, 2), (3, 2, 1, 17, 16, None), (5, 2, 2, 16, 16, None),
    (1, 2, 20, 17, 16, None), (3, 2, 20, 0, 1, None), (36, 2, 6, 15, 1, None),
]


def _model_plan(S, nt, L, B, item, smax, C, tpl):
    plan = bc.batched_build_plan(S, nt, L, B, item, smax, clusters=C)
    if tpl is not None:
        plan = plan._replace(tpl=tpl, K=-(-plan.width // tpl))
    return plan


@pytest.mark.parametrize("L,S,nt,B,C,tpl", CLUSTER_BUILDS)
def test_cluster_build_model_bit_equal_plain_and_jax_scan(L, S, nt, B, C, tpl):
    """float64: each start's U and phi0 from the cluster schedule equal the
    plain batched build's and ``jax.vmap`` of the scan build's, bit for
    bit."""
    if L == 1:
        s = product_levels([[0]])
        rng = np.random.default_rng(nt)
        st = rng.normal(size=(S, nt, 1))
        bt = np.zeros((S, nt, 1), np.int32)
        jump, smax = np.zeros((1, 1)), 0
    else:
        s, st, bt, jump, smax = _instance(L, S, nt, seed=L + nt + B, p=2)
    U_p, phi_p = tb.build_tables_batched_plain(_t(st), _t(bt), _t(jump), B, smax)
    U_j, phi_j = jax.vmap(lambda a, b: jb.build_tables(a, b, jnp.asarray(jump), B,
                                                       smax))(st, bt)
    plan = _model_plan(S, nt, L, B, 8, smax, C, tpl)
    assert (plan.C, plan.H) == (C, min(smax, B) if C > 1 else 0)
    for k in range(S):
        U_m, phi_m = cluster_build_model(st[k], bt[k], jump, B, smax, plan)
        np.testing.assert_array_equal(U_m, U_p[k].numpy())
        np.testing.assert_array_equal(U_m, np.asarray(U_j[k]))
        assert np.array_equal(phi_m.view(np.int64), phi_p[k].numpy().view(np.int64))
        assert np.array_equal(phi_m.view(np.int64), np.asarray(phi_j[k]).view(np.int64))


@pytest.mark.parametrize("L,S,nt,B,C", [(3, 2, 40, 17, 16), (3, 2, 40, 17, 3),
                                        (36, 2, 6, 15, 16), (36, 2, 6, 15, 2)])
def test_cluster_build_model_bit_equal_pallas_f32(L, S, nt, B, C):
    """float32: the cluster schedule against the TPU kernel
    ``_dp_kernel_batched`` in interpret mode and the plain build."""
    s, st, bt, jump, smax = _instance(L, S, nt, seed=5 * L, p=2)
    st32, jump32 = st.astype(np.float32), jump.astype(np.float32)
    U_p, phi_p = build_tables_pallas_batched(jnp.asarray(st32), bt, jnp.asarray(jump32), B,
                                             smax, interpret=True, raw_u=True)
    U_c, phi_c = interop.tables_from_pallas(U_p, phi_p, nt=nt, L=L, B=B, device="cpu")
    U_t, phi_t = tb.build_tables_batched_plain(_t(st32), _t(bt), _t(jump32), B, smax)
    plan = bc.batched_build_plan(S, nt, L, B, 4, smax, clusters=C)
    for k in range(S):
        U_m, phi_m = cluster_build_model(st32[k], bt[k], jump32, B, smax, plan)
        assert phi_m.dtype == np.float32
        np.testing.assert_array_equal(U_m, U_c[k].numpy())
        np.testing.assert_array_equal(U_m, U_t[k].numpy())
        assert np.array_equal(phi_m.view(np.int32), phi_c[k].numpy().view(np.int32))
        assert np.array_equal(phi_m.view(np.int32), phi_t[k].numpy().view(np.int32))


@pytest.mark.parametrize("S,nt,L,B,C", [
    (32, 1024, 3, 170, 1), (8, 2048, 5, 128, 1), (8, 1024, 36, 204, 16),
    (1, 1024, 36, 204, 16), (32, 1024, 36, 204, 4), (16, 1024, 36, 204, 8),
    (10, 1024, 36, 204, 13), (66, 1024, 36, 204, 2), (67, 1024, 36, 204, 1),
    (8, 2, 36, 204, 16), (8, 20, 182, 0, 1), (4, 60, 36, 25, 16), (4, 60, 36, 24, 1)])
def test_batched_build_plan_rule(S, nt, L, B, C):
    """One block per start below CLUSTER_MIN_RELAX relaxations a step
    (fishing, conv); above it the largest C ≤ min(16, B+1) with S·C ≤ 132
    CTAs, or 1 where not even C = 2 fits (heat scale); C = 1 is build_plan's
    plan as it is."""
    smax = {3: 2, 5: 4, 36: 10, 182: 0}[L]
    plan = bc.batched_build_plan(S, nt, L, B, 8, smax)
    assert plan.C == C
    if C == 1:
        assert plan[3:] == tuple(bc.build_plan(nt, L, B, 8)) and plan.H == 0
        assert plan.width == B + 1
        return
    width = -(-(B + 1) // C)
    assert (plan.width, plan.H) == (width, min(smax, B))
    assert plan.tpl * plan.K >= width and plan.threads <= bc.MAX_THREADS
    assert plan.threads == -(-L * plan.tpl // 32) * 32 + 32
    assert plan.smem == bc.smem_bytes(nt, L, B, 8, plan.R, plan.jsmem, plan.H + width)
    assert plan.smem <= bc.MAX_SMEM_BYTES


@pytest.mark.parametrize("nt,L,B,smax", [(1024, 3, 170, 2), (2048, 5, 128, 4),
                                         (1024, 36, 204, 10), (1, 3, 9, 2), (2, 5, 4, 4),
                                         (300, 1, 7, 0), (300, 3, 0, 2), (5, 2, 7262, 1)])
@pytest.mark.parametrize("item", [4, 8])
def test_batched_build_plan_takes_every_cluster_size(nt, L, B, smax, item):
    """Every C from 1 to min(16, B+1) can be forced, each a plan that fits
    one block; above that the plan refuses.  The edge shapes included: nt 1
    and 2, L = 1, B = 0 (C = 1 only), the largest B one float64 block took
    for L = 2 (rows in place at C = 1, staged rows in a cluster)."""
    for C in range(1, min(bc.MAX_CLUSTER, B + 1) + 1):
        plan = bc.batched_build_plan(3, nt, L, B, item, smax, clusters=C)
        assert plan.C == C and plan.smem <= bc.MAX_SMEM_BYTES
        assert plan.tpl * plan.K >= plan.width and plan.threads <= bc.MAX_THREADS
        if C > 1 and nt > 1:
            assert plan.R > 0
    with pytest.raises(ValueError, match="CTAs per start"):
        bc.batched_build_plan(3, nt, L, B, item, smax, clusters=min(16, B + 1) + 1)


@pytest.fixture
def card(monkeypatch):
    """The card's two host-side answers stubbed: ``_kernels.device_index``
    names card 0, and the occupancy query holds one cluster of up to
    ``card.most`` CTAs (default 16); ``card.queries`` counts the queries.
    The plan cache is empty before and after."""
    from mioc_tpu_torch.ops import _kernels

    class Card:
        most = 16
        queries = 0

        def held(self, index, spec, *args):
            self.queries += 1
            return int(args[9] <= self.most)  # args[9]: the plan's C

    stub = Card()
    monkeypatch.setattr(_kernels, "device_index", lambda device=None: 0)
    monkeypatch.setattr(_kernels, "clusters_held", stub.held)
    bc._cluster_build_plan.cache_clear()
    yield stub
    bc._cluster_build_plan.cache_clear()


# name, nt, L, B, smax: the single-start shapes of the three configurations,
# large heat (nt 200, B 40) and heat at nt 1024.
SINGLE_SHAPES = {
    "heat500": (500, 36, 100, 10), "heat200": (200, 36, 40, 10),
    "heat1024": (1024, 36, 204, 10), "conv": (2048, 5, 128, 4),
    "fishing": (1024, 3, 170, 2), "heat-B60": (500, 36, 60, 10),
    "heat-B30": (300, 36, 30, 10),
}


@pytest.mark.parametrize("name,most,C,width", [
    ("heat500", 16, 16, 7), ("heat200", 16, 16, 3), ("heat1024", 16, 16, 13),
    ("heat-B60", 16, 16, 4), ("heat-B30", 16, 16, 2),
    ("conv", 16, 1, 129), ("fishing", 16, 1, 171),
    ("heat500", 12, 12, 9), ("heat500", 1, 1, 101)])
def test_single_build_plan(card, name, most, C, width):
    """The plan B1 takes (``cluster_build_plan`` at S = 1): at heat scale 16
    CTAs of ⌈(B+1)/16⌉ budgets, also where a slice is narrower than the
    halo of smax = 10 (large heat: 3), lowered to what the card holds (12,
    or one block where it holds none); conv and fishing one block, as
    ``build_plan`` plans it, with no occupancy query."""
    nt, L, B, smax = SINGLE_SHAPES[name]
    card.most = most
    plan = bc.cluster_build_plan(1, nt, L, B, 8, smax)
    assert (plan.C, plan.width) == (C, width)
    if C == 1:
        assert plan.H == 0 and plan[3:] == tuple(bc.build_plan(nt, L, B, 8))
        assert card.queries == (0 if L * L * (B + 1) < bc.CLUSTER_MIN_RELAX else 15)
    else:
        assert plan == bc.batched_build_plan(1, nt, L, B, 8, smax, clusters=C)
        assert plan.H == smax
        assert plan.smem <= bc.MAX_SMEM_BYTES


@pytest.mark.parametrize("S,C", [(1, 16), (2, 16), (8, 16), (9, 14)])
def test_one_start_takes_the_rule_of_every_start_count(S, C):
    """At large heat (nt 200, B 40, smax 10) one start takes what S starts
    take where S·16 CTAs fit the card's SMs: 16 CTAs of 3 budgets under a
    halo of 10; one rule, with no branch of its own for S = 1."""
    assert bc.batched_build_plan(S, 200, 36, 40, 8, 10).C == C


@pytest.mark.parametrize("name", ["heat500", "heat200", "conv", "fishing"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_single_build_is_one_launch_of_the_batched_entry(card, monkeypatch, name, dtype):
    """One ``dp_build`` call is one launch, of the batched entry at S = 1
    under the single-start plan, counted on ``dp_build``; it never calls
    ``bellman_cuda.dp_build_batched`` (the benchmark's spans wrap both
    names, so a nested call would record one build twice).  A cluster launch
    also advances ``dp_build.cluster_launches``, and the open ``dp.build``
    span records the launch's CTAs.  The launch and the tensor checks are
    stubbed: CPU tensors stand in for the card's."""
    from mioc_tpu_torch.utils import trace
    from mioc_tpu_torch.ops import _kernels

    nt, L, B, smax = SINGLE_SHAPES[name]
    launches = []
    monkeypatch.setattr(_kernels, "check", lambda *a, **k: None)
    monkeypatch.setattr(_kernels, "launch", lambda *a: launches.append(a))

    def nested(*a, **k):
        raise AssertionError("dp_build called dp_build_batched")

    monkeypatch.setattr(bc, "dp_build_batched", nested)
    stage = torch.zeros((nt, L), dtype=dtype)
    btilde = torch.zeros((nt, L), dtype=torch.int32)
    n_c = bc.dp_build.cluster_launches
    trace.take()
    trace.enable()
    try:
        with trace.span("dp.build"):
            U, phi0 = bc.dp_build(stage, btilde, torch.zeros((L, L), dtype=dtype), B, smax)
    finally:
        trace.disable()
    (span,) = trace.take()
    assert U.shape == (nt - 1, L, B + 1) and U.dtype == tb.u_dtype(L)
    assert phi0.shape == (L, B + 1) and phi0.dtype == dtype
    plan = bc.cluster_build_plan(1, nt, L, B, stage.element_size(), smax)
    ((wrapper, label, spec, device, *args),) = launches
    assert (wrapper, label, spec, device) == (bc.dp_build, "dp_build", bc._BATCHED, stage.device)
    assert args[5:] == [1, nt, L, B, smax, plan.R, int(plan.jsmem), plan.tpl, plan.K, plan.C,
                        plan.H, stage.element_size(), U.element_size()]
    assert [args[i] for i in (0, 1, 3, 4)] == [stage.data_ptr(), btilde.data_ptr(),
                                               U.data_ptr(), phi0.data_ptr()]
    assert bc.dp_build.cluster_launches - n_c == int(plan.C > 1)
    assert (plan.C > 1) == name.startswith("heat")
    assert span.attrs == {"ctas": plan.C}
