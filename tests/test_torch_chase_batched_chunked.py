"""The redesigned batched, trial-wave and vec chases, on the CPU.

* A numpy model of ``csrc/chase_chunked.cuh`` over G table sets and R rows,
  row r on set r / (R/G) (``chase_batched.cu``: G = 1 or G = R;
  ``chase_trials.cu``: G = S sets of Kt rows): state maps per (set, chunk)
  with a sentinel, a chain per row with its serial tail, the re-walk of
  each (set, chunk) for the rows of that set still on it.  Held against
  ``bellman.backtrack_batched_plain`` / ``backtrack_trials_plain`` and the
  JAX package's chases: the scan ``backtrack`` vmapped over the rows (every
  case, the index rule for a budget below 0 included) and
  ``_backtrack_batched_impl`` / ``backtrack_pallas_trials`` in interpret
  mode (Pallas-built tables, float32).
* A numpy model of ``csrc/chase_vec.cu``'s cluster schedule: slices per CTA,
  sub-chunks, rounds when the table does not fit, planes in place when one
  does not, the chain with its entry states and sentinel, and the warp
  walkers' lane-collected stores.  Held against ``backtrack_plain`` and the
  JAX package's ``_bt_kernel_vec`` in interpret mode.
* The plan helpers at the chip shapes and the edge shapes
  (``backtrack_cuda.chase_plan`` with sets and rows, the trial wave's
  ``sets=S, rows=S·Kt`` included, ``vec_plan``) and the table-set rule of
  the batched wrapper (``table_sets``).

The CUDA kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import mioc_tpu.ops.backtrack_pallas as bp  # noqa: E402
from mioc_tpu.ops import bellman as jb  # noqa: E402
from mioc_tpu.ops.bellman_pallas import (  # noqa: E402
    build_tables_pallas,
    build_tables_pallas_batched,
)
from mioc_tpu.ops.levels import (  # noqa: E402
    bounded_sum_levels,
    jump_cost_table,
    product_levels,
)
from mioc_tpu_torch import interop  # noqa: E402
from mioc_tpu_torch.ops import backtrack_cuda as kc  # noqa: E402
from mioc_tpu_torch.ops import bellman as tb  # noqa: E402

SETS = {
    "L1": lambda: product_levels([[0]]),
    "sos1": lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1),
    "multi": lambda: product_levels([[-2, -1, 0, 1, 2]]),
    "heat": lambda: product_levels([list(range(6))] * 2),
}


def _sets_of_tables(name, S, nt, B, seed, far=False):
    """S table sets from seeded numpy inputs, built by the JAX scan build at
    float64 and checked equal to the port's plain build; with ``far`` the
    last set's u_old row 0 lies more than smax from every level, so its phi0
    is all +inf.  Returns ``(levels, U (S, nt-1, L, B+1), phi0 (S, L, B+1),
    btilde (S, nt, L))`` as numpy arrays."""
    s = SETS[name]()
    rng = np.random.default_rng(seed)
    smax = jb.max_budget_use(s.levels)
    jump = jump_cost_table(s.levels, p=1, beta=0.05)
    Us, phis, bts = [], [], []
    for k in range(S):
        grad = rng.normal(size=(nt, s.M))
        u_old = s.levels[rng.integers(0, s.L, size=nt)].astype(float)
        if far and k == S - 1:
            u_old[0] = np.abs(s.levels).max() + smax + 1
        st, bt = jb.stage_tables(jnp.asarray(grad), jnp.asarray(u_old),
                                 jnp.asarray(s.levels), 0.05)
        U, phi = jb.build_tables(st, bt, jnp.asarray(jump), B, smax)
        U_t, phi_t = tb.build_tables(torch.as_tensor(np.array(st)),
                                     torch.as_tensor(np.array(bt)), torch.as_tensor(jump),
                                     B, smax)
        assert np.array_equal(U_t.numpy(), np.asarray(U))
        assert np.array_equal(phi_t.numpy(), np.asarray(phi))
        Us.append(np.asarray(U))
        phis.append(np.asarray(phi))
        bts.append(np.asarray(bt))
    return s, np.stack(Us), np.stack(phis), np.stack(bts)


def _seed(phi0, cap):
    """The masked flat argmin with ties to the smallest flat index."""
    B1 = phi0.shape[-1]
    masked = np.where(np.arange(B1) <= cap, phi0, np.inf)
    return int(np.argmin(masked.reshape(-1)))


def _maps(U, btilde, k0, kn):
    """Every state's exit after steps k0 … k0+kn-1, or -1 where its budget
    falls below 0 on the way (lookups at the budget itself, which is ≥ 0)."""
    L, B1 = U.shape[1:]
    l, b = np.divmod(np.arange(L * B1), B1)
    alive = np.ones(L * B1, dtype=bool)
    for k in range(k0, k0 + kn):
        nl = U[k, l, np.where(alive, b, 0)].astype(np.int64)
        nb = b - btilde[k, l]
        l = np.where(alive, nl, l)
        b = np.where(alive, nb, b)
        alive &= b >= 0
    return np.where(alive, l * B1 + b, -1)


def _tail(U, btilde, out, k0, s):
    """The serial walk from state s at step k0 to the end, under the index
    rule (``bellman.budget_index``)."""
    B1 = U.shape[-1]
    l, b = divmod(s, B1)
    out[k0] = l
    for k in range(k0, btilde.shape[0] - 1):
        nl = int(U[k, l, tb.budget_index(b, B1 - 1)])
        b -= int(btilde[k, l])
        l = nl
        out[k + 1] = l


def _rewalk(U, btilde, s, k0, kn):
    B1 = U.shape[-1]
    l, b = divmod(s, B1)
    idx = []
    for k in range(k0, k0 + kn):
        nl = int(U[k, l, b])
        assert 0 <= b < B1  # before the first bad chunk the budget stays in range
        b -= int(btilde[k, l])
        l = nl
        idx.append(l)
    return idx


# -------------------------------------------------- model of the batched chase


def batched_chase_model(U, phi0, btilde, caps, T, G, pr=1):
    """numpy model of ``csrc/chase_chunked.cuh`` over G table sets and R =
    len(caps) rows: ``U (G, nt-1, L, B+1)``, ``btilde (G, nt, L)`` (set g),
    ``phi0 (R/pr, L, B+1)`` (row r reads plane r / pr), row r on set g(r) =
    r / (R/G), so set g holds rows g·(R/G) … (g+1)·(R/G)-1.

    A: per task (g, c), the chunk's state maps E[g, c].
    B: per row, the seed, the chain over E[g(r)], entry[r, c], and at a
       sentinel the serial tail from that chunk's entry; first_bad[r].
    C: per task (g, c), last first, a re-walk for every row of set g whose
       first_bad lies beyond c.
    """
    R = len(caps)
    assert R % G == 0
    RG = R // G
    nt = btilde.shape[1]
    steps = nt - 1
    C = -(-steps // T) if steps > 0 else 0
    E = {(g, c): _maps(U[g], btilde[g], c * T, min(T, steps - c * T))
         for g in range(G) for c in range(C)}
    out = np.zeros((R, nt), dtype=np.int32)
    entry = np.zeros((R, C), dtype=np.int64)
    first_bad = np.full(R, C)
    for r in range(R):
        g = r // RG
        s = _seed(phi0[r // pr], caps[r])
        out[r, 0] = s // U.shape[-1]
        for c in range(C):
            entry[r, c] = s
            if E[g, c][s] < 0:
                first_bad[r] = c
                _tail(U[g], btilde[g], out[r], c * T, s)
                break
            s = int(E[g, c][s])
    for t in reversed(range(G * C)):
        g, c = divmod(t, C)
        for r in range(g * RG, (g + 1) * RG):
            if first_bad[r] > c:
                kn = min(T, steps - c * T)
                out[r, c * T + 1:c * T + kn + 1] = _rewalk(U[g], btilde[g], entry[r, c],
                                                            c * T, kn)
    return out, first_bad


def _jax_rows(levels, U, phi0, btilde, caps):
    """The JAX scan chase of each row, vmapped (rows carry their tables)."""
    fn = jax.vmap(lambda u, p, b, c: jb.backtrack(u, p, b, jnp.asarray(levels), c)[1])
    return np.asarray(fn(jnp.asarray(U), jnp.asarray(phi0), jnp.asarray(btilde),
                         jnp.asarray(caps, jnp.int32)))


BATCHED_CASES = [
    # name, S table sets, nt, B, T: one chunk, ragged chunks, one-step chunks,
    # L = 1, B = 0, the fishing plan's T at G = 32, heat.
    ("sos1", 3, 2, 5, 4),
    ("sos1", 3, 90, 14, 7),
    ("multi", 2, 40, 12, 1),
    ("L1", 2, 30, 4, 6),
    ("sos1", 2, 50, 0, 9),
    ("sos1", 4, 300, 30, 128),
    ("heat", 2, 25, 12, 5),
]


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("name,S,nt,B,T", BATCHED_CASES)
def test_batched_model_one_set_per_row(name, S, nt, B, T, far):
    """G = R = S: row r on set r at its own cap (past B, -1 and 0 among
    them); with ``far`` the last set's seed is +inf."""
    s, U, phi0, bt = _sets_of_tables(name, S, nt, B, seed=nt + B, far=far)
    caps = np.array([B + 3, -1, B // 2, 0][:S] + [B] * max(0, S - 4), np.int32)
    got, _ = batched_chase_model(U, phi0, bt, caps, T, G=S)
    plain = tb.backtrack_batched_plain(torch.as_tensor(U), torch.as_tensor(phi0),
                                       torch.as_tensor(bt), torch.as_tensor(caps))
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, _jax_rows(s.levels, U, phi0, bt, caps))


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("name,S,nt,B,T", BATCHED_CASES)
def test_batched_model_one_set_for_the_wave(name, S, nt, B, T, far):
    """G = 1: the K caps of a trial wave (B, B/2, …, 0, and -1, B+4) against
    one table set read at stride 0, phi0 included."""
    s, U, phi0, bt = _sets_of_tables(name, 1, nt, B, seed=3 * nt + B, far=far)
    caps = np.array(sorted({B >> k for k in range(8)} | {0, -1, B + 4}, reverse=True),
                    np.int32)
    K = len(caps)
    got, _ = batched_chase_model(U, np.repeat(phi0, K, 0), bt, caps, T, G=1)
    exp = [torch.as_tensor(a).expand(K, *a.shape[1:]) for a in (U, phi0, bt)]
    plain = tb.backtrack_batched_plain(*exp, torch.as_tensor(caps))
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(
        got, _jax_rows(s.levels, *(np.repeat(a, K, 0) for a in (U, phi0, bt)), caps))


def test_batched_model_sentinel_mid_chain():
    """Synthetic tables on which the walk from the infeasible seed (cap -1:
    every entry masked, seed (0, 0)) keeps its budget at 0 for 35 steps, then
    falls below 0: the sentinel is met in the chain's fifth chunk, not its
    first, and rows at other caps, on the same maps, are not disturbed."""
    rng = np.random.default_rng(11)
    nt, L, B, T = 60, 3, 6, 8
    U = rng.integers(0, L, size=(1, nt - 1, L, B + 1)).astype(np.int8)
    bt = rng.integers(0, 3, size=(1, nt, L)).astype(np.int32)
    bt[0, :35] = 0
    bt[0, 35:] = np.maximum(bt[0, 35:], 1)
    phi0 = rng.normal(size=(1, L, B + 1))
    caps = np.array([-1, B, 3, -1], np.int32)
    K = len(caps)
    got, first_bad = batched_chase_model(U, np.repeat(phi0, K, 0), bt, caps, T, G=1)
    assert first_bad[0] == 35 // T and first_bad[3] == 35 // T
    exp = [torch.as_tensor(a).expand(K, *a.shape[1:]) for a in (U, phi0, bt)]
    plain = tb.backtrack_batched_plain(*exp, torch.as_tensor(caps))
    np.testing.assert_array_equal(got, plain.numpy())
    levels = np.arange(L, dtype=float)[:, None]
    np.testing.assert_array_equal(
        got, _jax_rows(levels, *(np.repeat(a, K, 0) for a in (U, phi0, bt)), caps))


@pytest.mark.parametrize("L,S,nt,B,T", [(3, 3, 140, 23, 16), (36, 2, 12, 12, 5)])
def test_batched_model_equals_pallas_batched_kernel(L, S, nt, B, T):
    """The TPU kernel ``_bt_kernel_batched`` in interpret mode on
    Pallas-built tables (float32), caps ≤ B, against the model on the same
    tables carried across with ``interop.tables_from_pallas``."""
    s = {3: SETS["sos1"], 36: SETS["heat"]}[L]()
    rng = np.random.default_rng(L + nt)
    grad = rng.normal(size=(S, nt, s.M))
    u_old = s.levels[rng.integers(0, s.L, size=(S, nt))]
    st, bt = jax.vmap(lambda g, u: jb.stage_tables(g, u, jnp.asarray(s.levels),
                                                   0.05))(grad, u_old)
    jump = jump_cost_table(s.levels, p=np.inf, beta=1e-3)
    U_p, phi_p = build_tables_pallas_batched(jnp.asarray(st, jnp.float32), bt,
                                             jnp.asarray(jump, jnp.float32), B,
                                             jb.max_budget_use(s.levels), interpret=True)
    U_t, phi_t = interop.tables_from_pallas(U_p, phi_p, nt=nt, L=L, B=B, device="cpu")
    caps = np.array([B, B // 2, 0][:S], np.int32)
    _, i_p = bp._backtrack_batched_impl(U_p, phi_p, bt, jnp.asarray(s.levels),
                                        jnp.asarray(caps), interpret=True)
    got, _ = batched_chase_model(U_t.numpy(), phi_t.numpy(), np.asarray(bt), caps, T, G=S)
    np.testing.assert_array_equal(got, np.asarray(i_p))


# ------------------------------------------------- the trial wave (G = S sets)

TRIAL_CASES = [
    # name, S table sets, Kt caps per set, nt, B, T: the batched cases' shapes
    # (one chunk, ragged chunks, one-step chunks, L = 1, B = 0, the fishing
    # plan's T, heat) with several caps per set.
    ("sos1", 3, 4, 2, 5, 4),
    ("sos1", 3, 6, 90, 14, 7),
    ("multi", 2, 5, 40, 12, 1),
    ("L1", 2, 3, 30, 4, 6),
    ("sos1", 2, 4, 50, 0, 9),
    ("sos1", 4, 9, 300, 30, 128),
    ("heat", 2, 4, 25, 12, 5),
]


def _trial_caps(B, S, Kt, seed):
    """Kt caps per set with -1, 0, B and past B in every set, the rest drawn
    from [-2, B+3], each set's in another order: rows of other sets and of
    other sentinels side by side."""
    rng = np.random.default_rng(seed)
    caps = np.empty((S, Kt), np.int32)
    for g in range(S):
        row = [-1, 0, B, B + 1 + g][:Kt]
        row += list(rng.integers(-2, B + 4, size=Kt - len(row)))
        caps[g] = rng.permutation(row)
    return caps


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("name,S,Kt,nt,B,T", TRIAL_CASES)
def test_trials_model_equals_plain_and_jax(name, S, Kt, nt, B, T, far):
    """G = S sets of Kt rows (R = S·Kt), phi0 of row r is set r / Kt's:
    the trial-wave chase, equal to the plain trial chase and to the JAX
    scan chase of each row; with ``far`` the last set's seed is +inf."""
    s, U, phi0, bt = _sets_of_tables(name, S, nt, B, seed=5 * nt + B, far=far)
    caps = _trial_caps(B, S, Kt, seed=nt)
    got, _ = batched_chase_model(U, phi0, bt, caps.reshape(-1), T, G=S, pr=Kt)
    plain = tb.backtrack_trials_plain(torch.as_tensor(U), torch.as_tensor(phi0),
                                      torch.as_tensor(bt), torch.as_tensor(caps))
    np.testing.assert_array_equal(got.reshape(S, Kt, nt), plain.numpy())
    rows = [np.repeat(a, Kt, 0) for a in (U, phi0, bt)]
    np.testing.assert_array_equal(got, _jax_rows(s.levels, *rows, caps.reshape(-1)))


def test_trials_model_sentinel_mid_chain():
    """The synthetic tables of the batched test as two sets of four caps:
    in each set the rows at cap -1 meet the sentinel in their fifth chunk;
    the other rows of the set, on the same maps, are not disturbed."""
    rng = np.random.default_rng(11)
    nt, L, B, T, S = 60, 3, 6, 8, 2
    U = rng.integers(0, L, size=(S, nt - 1, L, B + 1)).astype(np.int8)
    bt = rng.integers(0, 3, size=(S, nt, L)).astype(np.int32)
    bt[:, :35] = 0
    bt[:, 35:] = np.maximum(bt[:, 35:], 1)
    phi0 = rng.normal(size=(S, L, B + 1))
    caps = np.array([[-1, B, 3, -1], [2, -1, B + 2, 0]], np.int32)
    got, first_bad = batched_chase_model(U, phi0, bt, caps.reshape(-1), T, G=S, pr=4)
    assert [first_bad[r] for r in (0, 3, 5)] == [35 // T] * 3
    plain = tb.backtrack_trials_plain(torch.as_tensor(U), torch.as_tensor(phi0),
                                      torch.as_tensor(bt), torch.as_tensor(caps))
    np.testing.assert_array_equal(got.reshape(S, 4, nt), plain.numpy())
    levels = np.arange(L, dtype=float)[:, None]
    rows = [np.repeat(a, 4, 0) for a in (U, phi0, bt)]
    np.testing.assert_array_equal(got, _jax_rows(levels, *rows, caps.reshape(-1)))


@pytest.mark.parametrize("L,S,nt,B,T", [(3, 3, 140, 23, 16), (36, 2, 12, 12, 5)])
def test_trials_model_equals_pallas_trials_kernel(L, S, nt, B, T):
    """The TPU kernel ``_bt_kernel_trials`` in interpret mode
    (``backtrack_pallas_trials`` under ``jax.vmap``) on Pallas-built tables
    (float32) against the model on the same tables: caps 0, B and between
    per set, in another order in each set.  Cap -1 and caps past B are held
    against the plain and the scan chase only (``test_trials_model_equals_
    plain_and_jax``): where a walk leaves [0, B] the Pallas kernel reads the
    padded tables' budget lanes, and the port follows the scan chase."""
    s = {3: SETS["sos1"], 36: SETS["heat"]}[L]()
    rng = np.random.default_rng(L + nt + 1)
    grad = rng.normal(size=(S, nt, s.M))
    u_old = s.levels[rng.integers(0, s.L, size=(S, nt))]
    st, bt = jax.vmap(lambda g, u: jb.stage_tables(g, u, jnp.asarray(s.levels),
                                                   0.05))(grad, u_old)
    jump = jump_cost_table(s.levels, p=np.inf, beta=1e-3)
    U_p, phi_p = build_tables_pallas_batched(jnp.asarray(st, jnp.float32), bt,
                                             jnp.asarray(jump, jnp.float32), B,
                                             jb.max_budget_use(s.levels), interpret=True)
    U_t, phi_t = interop.tables_from_pallas(U_p, phi_p, nt=nt, L=L, B=B, device="cpu")
    caps = np.array([rng.permutation([B // 4, 0, B, B // 2, 1]) for _ in range(S)],
                    np.int32)
    levels = jnp.asarray(s.levels)
    _, i_p = jax.vmap(lambda U, p, b, c: bp.backtrack_pallas_trials(
        U, p, b, levels, c, interpret=True))(U_p, phi_p, jnp.asarray(bt), caps)
    got, _ = batched_chase_model(U_t.numpy(), phi_t.numpy(), np.asarray(bt),
                                 caps.reshape(-1), T, G=S, pr=caps.shape[1])
    np.testing.assert_array_equal(got.reshape(caps.shape + (nt,)), np.asarray(i_p))


# ------------------------------------------------ model of the cluster chase


def cluster_chase_model(U, phi0, btilde, cap, plan):
    """numpy model of ``csrc/chase_vec.cu`` under ``plan`` (a ``VecPlan``):
    slice j = q·N + i of CTA i in round q, Ts steps, W sub-chunks of Tw
    steps.

    1: the maps of every sub-chunk of every slice, and each slice's map, the
       sub-chunks' composed (in shared memory or in device memory: the same
       numbers);
    2: the chain over the slices in time order (passed from owner to owner
       in the kernel), each slice's entry state; at a sentinel the serial
       tail from that slice's entry and bad = j;
    3: per CTA, rounds last first, each slice before bad: a warp per
       sub-chunk takes the slice's entry through the earlier sub-chunks'
       maps and re-walks it, lane p mod 32 holding index p, stored at each
       32-index boundary and at the sub-chunk's end, lanes outside the
       sub-chunk masked.
    """
    N, Q, Ts, W, Tw = plan.N, plan.Q, plan.Ts, plan.W, plan.Tw
    nt = btilde.shape[0]
    steps = nt - 1
    B1 = U.shape[-1]
    assert N * Q * Ts >= steps and W * Tw >= Ts
    assert plan.maps_in_smem or W == 1

    def sub(j, w):
        k0 = j * Ts + w * Tw
        return k0, min(Tw, (j + 1) * Ts - k0, steps - k0)

    maps, slice_maps = {}, {}
    for j in range(N * Q):
        if j * Ts >= steps:
            break
        x = np.arange(U.shape[1] * B1)
        for w in range(W):
            k0, kn = sub(j, w)
            if kn <= 0:
                break
            maps[j, w] = _maps(U, btilde, k0, kn)
            x = np.where(x < 0, -1, maps[j, w][np.maximum(x, 0)])
        slice_maps[j] = x
    out = np.full(nt, -7, dtype=np.int32)  # every index must be written
    s = _seed(phi0, cap)
    out[0] = s // B1
    entry, bad = {}, np.iinfo(np.int32).max
    j = 0
    while j * Ts < steps:
        entry[j] = s
        if slice_maps[j][s] < 0:
            bad = j
            _tail(U, btilde, out, j * Ts, s)
            break
        s = int(slice_maps[j][s])
        j += 1
    for rank in range(N):
        for q in reversed(range(Q)):
            j = q * N + rank
            if j * Ts >= steps or j >= bad:
                continue
            for w in range(W):
                k0, kn = sub(j, w)
                if kn <= 0:
                    continue
                s = entry[j]
                for u in range(w):
                    s = int(maps[j, u][s])
                idx = _rewalk(U, btilde, s, k0, kn)
                mine = np.zeros(32, dtype=np.int64)
                for kk in range(kn):
                    p = k0 + kk + 1
                    mine[p & 31] = idx[kk]
                    if (p & 31) == 31 or kk == kn - 1:
                        for lane in range(32):
                            i = (p & ~31) + lane
                            if k0 < i <= p:
                                out[i] = mine[lane]
    return out


VEC_CASES = [
    # name, nt, B, cluster, steps per sub-chunk, shared-memory budget (None:
    # the module's): the fit mode at 8 and 16 CTAs with one sub-chunk, with
    # several (a ragged last one, an empty one), empty slices (steps < N),
    # rounds (a budget below the table), planes in place (a budget below one
    # plane), nt 1 and 2, L = 1, B = 0.
    ("sos1", 200, 30, 8, 4, None),
    ("multi", 300, 12, 16, 7, None),
    ("sos1", 70, 9, 16, 16, None),
    ("sos1", 145, 9, 16, 3, None),
    ("multi", 9, 5, 16, 2, None),
    ("heat", 40, 12, 8, 2, 4 * 468 * 2 + 200),
    ("sos1", 260, 20, 8, 2, 2000),
    ("multi", 50, 12, 16, 2, 100),
    ("sos1", 1, 5, 8, 2, None),
    ("multi", 2, 4, 16, 2, None),
    ("L1", 40, 4, 8, 1, None),
    ("sos1", 60, 0, 8, 3, None),
]


def _vec_plan(monkeypatch, nt, L, B, cluster, subchunk_steps, budget):
    if budget is not None:
        monkeypatch.setattr(kc, "CHASE_SMEM_BYTES", budget)
    return kc.vec_plan(nt, L, B, 1, cluster, subchunk_steps)


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("name,nt,B,cluster,subchunk_steps,budget", VEC_CASES)
def test_cluster_model_equals_plain_and_jax(monkeypatch, name, nt, B, cluster,
                                            subchunk_steps, budget, far):
    s, U, phi0, bt = _sets_of_tables(name, 1, nt, B, seed=nt + 5 * B, far=far)
    U, phi0, bt = U[0], phi0[0], bt[0]
    plan = _vec_plan(monkeypatch, nt, s.L, B, cluster, subchunk_steps, budget)
    mode = ("none" if nt == 1 else "fit" if plan.maps_in_smem else
            "rounds" if plan.staged else "in place")
    assert mode == ("none" if nt == 1 else "rounds" if budget and budget > 1000 else
                    "in place" if budget else "fit")
    for cap in sorted({B + 2, B, B // 2, 0, -1}, reverse=True):
        want = tb.backtrack_plain(torch.as_tensor(U), torch.as_tensor(phi0),
                                  torch.as_tensor(bt), cap).numpy()
        np.testing.assert_array_equal(cluster_chase_model(U, phi0, bt, cap, plan), want)
        np.testing.assert_array_equal(want, _jax_rows(s.levels, U[None], phi0[None],
                                                      bt[None], [cap])[0])


def test_cluster_model_sentinel_mid_chain(monkeypatch):
    """The synthetic mid-chain sentinel of the batched test, at 8 CTAs of 2
    sub-chunks: the chain meets it in CTA 4's slice, which and whose
    successors re-walk nothing."""
    rng = np.random.default_rng(11)
    nt, L, B = 60, 3, 6
    U = rng.integers(0, L, size=(nt - 1, L, B + 1)).astype(np.int8)
    bt = rng.integers(0, 3, size=(nt, L)).astype(np.int32)
    bt[:35] = 0
    bt[35:] = np.maximum(bt[35:], 1)
    phi0 = rng.normal(size=(L, B + 1))
    plan = kc.vec_plan(nt, L, B, 1, 8, 4)
    assert (plan.Ts, plan.W, plan.Tw) == (8, 2, 4)
    for cap in (-1, 3):
        want = tb.backtrack_plain(torch.as_tensor(U), torch.as_tensor(phi0),
                                  torch.as_tensor(bt), cap).numpy()
        np.testing.assert_array_equal(cluster_chase_model(U, phi0, bt, cap, plan), want)


@pytest.mark.parametrize("cluster,subchunk_steps", [(8, 5), (16, 16), (16, 3)])
def test_cluster_model_equals_tpu_vec_kernel(monkeypatch, cluster, subchunk_steps):
    """``_bt_kernel_vec`` in interpret mode on Pallas-built tables (levels
    −2…2, nt=200, B=17, the JAX tests' vec case) against the model."""
    monkeypatch.setattr(bp, "_CHASE_VEC", True)
    rng = np.random.default_rng(3)
    s = product_levels([[-2, -1, 0, 1, 2]])
    nt, B = 200, 17
    levels = jnp.asarray(s.levels)
    jump = jnp.asarray(jump_cost_table(s.levels, p=1, beta=1e-3))
    smax = jb.max_budget_use(s.levels)
    grad = jnp.asarray(rng.normal(size=(nt, 1)))
    u_old = jnp.asarray(s.levels[rng.integers(0, s.L, size=nt)])
    stage, btilde = jb.stage_tables(grad, u_old, levels, 0.1)
    U_p, phi_p = build_tables_pallas(stage, btilde, jump, B, smax, interpret=True)
    U_t, phi_t = interop.tables_from_pallas(U_p, phi_p, nt=nt, L=s.L, B=B, device="cpu")
    plan = kc.vec_plan(nt, s.L, B, 1, cluster, subchunk_steps)
    for cap in (B, 7, 0):
        _, i_v = bp._backtrack_impl(U_p, phi_p, btilde, levels, jnp.int32(cap),
                                    interpret=True)
        got = cluster_chase_model(U_t.numpy(), phi_t.numpy(), np.asarray(btilde), cap, plan)
        np.testing.assert_array_equal(got, np.asarray(i_v))


# ------------------------------------------------------------ plan helpers


@pytest.mark.parametrize("sets,C,T", [(1, 32, 32), (8, 32, 32), (32, 8, 128),
                                      (288, 3, 390)])
def test_chase_plan_sets_fishing(sets, C, T):
    """At fishing: 32 chunks for one set (the single chase, the wave) and
    for 8; 8 chunks of 128 steps for 32 sets (256 tasks); at 288 sets one
    chunk would not fit shared memory, so 3 chunks of 390 steps."""
    plan = kc.chase_plan(1024, 3, 170, 1, sets=sets, rows=sets)
    assert (plan.C, plan.T, plan.staged) == (C, T, True)
    assert plan.smem <= kc.CHASE_SMEM_BYTES
    assert plan.scratch == sets * C * 3 * 171 + sets * C + sets


@pytest.mark.parametrize("nt,L,B,S,C,T", [
    (1024, 3, 170, 32, 8, 128), (2048, 5, 128, 8, 32, 64), (1024, 36, 204, 8, 38, 27),
    (1, 3, 9, 32, 0, 1), (2, 5, 4, 8, 1, 1), (300, 1, 7, 8, 30, 10), (300, 3, 0, 32, 8, 38)])
def test_chase_plan_trial_wave(nt, L, B, S, C, T):
    """The trial wave's plan, ``sets=S, rows=S·Kt`` (Kt = 9), at the chip
    shapes (fishing S=32, conv and heat scale S=8) and the edge shapes: the
    chunks of the batched chase over S sets (the rows do not change them),
    scratch for one set of maps per start and each row's entries."""
    Kt = 9
    plan = kc.chase_plan(nt, L, B, 1, sets=S, rows=S * Kt)
    assert (plan.C, plan.T) == (C, T)
    assert plan[:4] == kc.chase_plan(nt, L, B, 1, sets=S, rows=S)[:4]
    assert plan.scratch == S * C * L * (B + 1) + S * Kt * C + S * Kt


@pytest.mark.parametrize("nt", [1, 2, 100, 1024, 100000])
@pytest.mark.parametrize("L,B,ub", [(1, 0, 1), (5, 128, 1), (36, 204, 1), (130, 400, 4)])
@pytest.mark.parametrize("sets,rows", [(1, 9), (32, 32), (288, 288), (32, 288), (8, 1024)])
def test_chase_plan_takes_every_batch(nt, L, B, ub, sets, rows):
    """No shape or batch is refused: C·T covers the steps, about CHASE_TASKS
    tasks where the sets allow, the scratch of G·C·P + R·C + R."""
    plan = kc.chase_plan(nt, L, B, ub, sets=sets, rows=rows)
    steps = nt - 1
    assert plan.C * plan.T >= steps and (plan.C - 1) * plan.T < max(steps, 1)
    target = max(1, min(kc.CHASE_CHUNKS, -(-kc.CHASE_TASKS // sets)))
    assert plan.T <= max(1, -(-steps // target))
    assert plan.scratch == sets * plan.C * L * (B + 1) + rows * plan.C + rows
    if plan.staged:
        assert plan.smem <= kc.CHASE_SMEM_BYTES


def test_vec_plan_the_chip_shapes():
    """Fishing and conv fit the cluster at 8 and 16 CTAs (the maps in shared
    memory, sub-chunks of 16 steps); at conv with 8 CTAs twelve sub-chunk
    maps are all that fit beside 256 planes; heat scale takes rounds with
    the maps in device memory."""
    for cluster, nt, L, B, W, Tw in ((8, 1024, 3, 170, 8, 16), (16, 1024, 3, 170, 4, 16),
                                     (8, 2048, 5, 128, 12, 22), (16, 2048, 5, 128, 8, 16)):
        p = kc.vec_plan(nt, L, B, 1, cluster)
        assert (p.Q, p.staged, p.maps_in_smem, p.scratch) == (1, True, True, 0)
        assert (p.Ts, p.W, p.Tw) == (-(-(nt - 1) // cluster), W, Tw)
    for cluster in (8, 16):
        heat = kc.vec_plan(1024, 36, 204, 1, cluster)
        assert heat.staged and not heat.maps_in_smem and heat.W == 1
        assert (heat.Q, heat.Ts) == {8: (5, 26), 16: (3, 22)}[cluster]
        assert heat.scratch == cluster * heat.Q * 36 * 205
    # conv at 8 CTAs: 256 planes of 645 B, 12 sub-chunk maps and the slice map.
    assert kc.vec_plan(2048, 5, 128, 1, 8).smem == (165136 + 256 * 5 * 4 + 12 * 645 * 4
                                                    + 645 * 4 + 4)
    assert kc.vec_plan(2048, 5, 128, 1, 8, subchunk_steps=256).W == 1


VEC_PLAN_SHAPES = [
    # nt, L, B, u_bytes: the three chip shapes, nt 1 and 2, L = 1, B = 0,
    # int32 planes in place, long heat, a large-plane edge.
    (1024, 3, 170, 1), (2048, 5, 128, 1), (1024, 36, 204, 1), (1, 3, 9, 1),
    (2, 5, 4, 1), (300, 1, 7, 1), (300, 3, 0, 1), (12, 130, 400, 4), (4000, 36, 204, 1),
    (50, 241, 2000, 4),
]


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("nt,L,B,ub", VEC_PLAN_SHAPES)
def test_vec_plan_takes_every_shape(nt, L, B, ub, cluster):
    """No shape is refused: the slices cover the steps, the sub-chunks their
    slice, a staged layout fits the budget, the layout's bytes are those of
    ``vec_layout`` in the source, and the maps go to device memory exactly
    where they leave shared memory."""
    p = kc.vec_plan(nt, L, B, ub, cluster)
    steps, P, plane = nt - 1, L * (B + 1), L * (B + 1) * ub
    assert p.N == cluster and p.N * p.Q * p.Ts >= steps and p.W * p.Tw >= p.Ts
    if steps > 0:
        assert (p.Q - 1) * p.N * p.Ts < steps  # no round is empty
    staged = -(-(p.Ts * plane + 16) // 16) * 16 + 4 * p.Ts * L if p.staged else 0
    maps = 4 * p.W * P + (4 * P if p.W > 1 else 0) if p.maps_in_smem else 0
    assert p.smem == staged + maps + 4 * p.Q
    assert p.smem <= kc.CHASE_SMEM_BYTES and 1 <= p.W <= 32
    assert p.maps_in_smem or p.W == 1
    assert p.scratch == (0 if p.maps_in_smem or steps <= 0 else p.N * p.Q * P)
    if not p.staged and steps > 0:
        assert plane + 16 + 4 * L > kc.CHASE_SMEM_BYTES - 64


def test_table_sets_rule():
    """One set of maps where U and b̃ both have stride 0, whatever phi0's;
    a set per start otherwise (stride 0 on phi0 alone, or on one of U and
    b̃)."""
    U = torch.zeros((5, 3, 4), dtype=torch.int8)
    phi0 = torch.zeros((3, 4))
    bt = torch.zeros((6, 3), dtype=torch.int32)
    S = 4
    exp = [t.expand(S, *t.shape) for t in (U, phi0, bt)]
    full = [t.contiguous() for t in exp]
    assert kc.table_sets(exp[0], exp[1], exp[2]) == (0, 0, 0, 1)
    assert kc.table_sets(exp[0], full[1], exp[2]) == (12, 0, 0, 1)
    assert kc.table_sets(full[0], exp[1], full[2]) == (0, 18, 60, S)
    assert kc.table_sets(exp[0], exp[1], full[2]) == (0, 18, 0, S)
    with pytest.raises(ValueError, match="contiguous per start"):
        kc.table_sets(full[0][..., :2], full[1], full[2])
