"""The redesigned build and chase kernels' algorithms, on the CPU.

* The chases' index rule for a budget below 0: the JAX scan chase
  (``mioc_tpu.ops.bellman.backtrack``) indexes ``U_k[l, b]`` with a traced
  ``b``, so a negative budget counts from the end and is then clamped.  The
  port's plain walk follows it (``bellman.budget_index``); the tables here
  have a +inf seed, where the walk's budget falls below 0 and below -(B+1).
* A numpy model of ``csrc/chase.cu``'s three phases (state maps per chunk
  with a sentinel, the dependent walk over the chunks with the serial tail,
  the re-walk of each chunk), held equal to ``backtrack_plain`` and to the
  JAX ``backtrack`` on the same tables.
* A numpy model of ``csrc/dp_build.cuh``'s schedule (ring chunks of R rows
  filled a chunk ahead, fixed outputs per thread), held bit-equal to
  ``build_tables_plain``.
* The wrappers' sizing helpers: every ``(L, B, dtype)`` the first build
  kernel took is still taken (``bellman_cuda.build_plan``), and no chase
  shape is refused (``backtrack_cuda.chase_plan``).

The CUDA kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from mioc_tpu.ops import bellman as jb  # noqa: E402
from mioc_tpu.ops.levels import (  # noqa: E402
    bounded_sum_levels,
    jump_cost_table,
    product_levels,
)
from mioc_tpu_torch.ops import bellman as tb  # noqa: E402
from mioc_tpu_torch.ops.backtrack_cuda import (  # noqa: E402
    CHASE_CHUNKS,
    CHASE_SMEM_BYTES,
    chase_plan,
)
from mioc_tpu_torch.ops.bellman_cuda import (  # noqa: E402
    MAX_SMEM_BYTES,
    MAX_THREADS,
    build_plan,
    smem_bytes,
)

SETS = {
    "L1": lambda: product_levels([[0]]),
    "sos1": lambda: bounded_sum_levels([[0, 1]] * 3, 1, 1),
    "multi": lambda: product_levels([[-2, -1, 0, 1, 2]]),
    "heat": lambda: product_levels([list(range(6))] * 2),
}


def _tables(name, nt, B, seed, inf_seed=False):
    """Inputs from a seeded numpy generator, built by both packages' scan
    paths at float64; returns ``(levels, JAX tables, port tables)``.  With
    ``inf_seed`` u_old's row 0 lies more than smax from every level in each
    component: every b̃[0, l] exceeds smax, so phi0 is +inf (the seed is
    (0, 0) at every cap) while the later planes of U are those of a valid
    table, where the index rule decides which entry the walk reads."""
    s = SETS[name]()
    rng = np.random.default_rng(seed)
    grad = rng.normal(size=(nt, s.M))
    u_old = s.levels[rng.integers(0, s.L, size=nt)].astype(float)
    smax = jb.max_budget_use(s.levels)
    if inf_seed:
        u_old[0] = np.abs(s.levels).max() + smax + 1
    jump = jump_cost_table(s.levels, p=1, beta=0.05)
    st, bt = jb.stage_tables(jnp.asarray(grad), jnp.asarray(u_old),
                             jnp.asarray(s.levels), 0.05)
    U_j, phi_j = jb.build_tables(st, bt, jnp.asarray(jump), B, smax)
    port = tuple(torch.as_tensor(np.array(a)) for a in (U_j, phi_j, bt))
    U_t, phi_t = tb.build_tables(torch.as_tensor(np.array(st)), port[2],
                                 torch.as_tensor(jump), B, smax)
    assert torch.equal(U_t, port[0]) and torch.equal(phi_t, port[1])
    return s, (U_j, phi_j, bt), port


def _jax_chase(s, tables, cap):
    U_j, phi_j, bt = tables
    return np.asarray(jb.backtrack(U_j, phi_j, bt, jnp.asarray(s.levels),
                                   jnp.int32(cap))[1])


def _budgets(U, phi0, btilde, cap):
    """The budgets b after each step of the plain walk (for asserting which
    case a table exercises)."""
    B1 = phi0.shape[1]
    masked = np.where(np.arange(B1) <= cap, phi0, np.inf)
    flat = int(np.argmin(masked.reshape(-1)))
    l, b = divmod(flat, B1)
    out = []
    for k in range(U.shape[0]):
        nl = int(U[k, l, tb.budget_index(b, B1 - 1)])
        b -= int(btilde[k, l])
        l = nl
        out.append(b)
    return np.array(out)


# ------------------------------------------------------ the index-rule fault


@pytest.mark.parametrize("name,nt,B,below", [
    ("sos1", 12, 25, False), ("sos1", 60, 6, True), ("multi", 80, 12, False),
    ("multi", 80, 3, True), ("heat", 30, 120, False), ("heat", 30, 12, True)])
def test_plain_walk_follows_jax_index_rule_from_infinite_seed(name, nt, B, below):
    """phi0 all +inf: the seed is (0, 0) and the budget falls below 0 —
    within [-(B+1), -1], where the index counts from the end, or below
    -(B+1), where it clamps to 0; the plain walk equals the JAX scan chase at
    every cap."""
    s, jt, (U, phi0, bt) = _tables(name, nt, B, seed=7, inf_seed=True)
    assert not torch.isfinite(phi0).any()
    for cap in (B, B // 2, 0, -1):
        b = _budgets(U.numpy(), phi0.numpy(), bt.numpy(), cap)
        assert b[0] < 0 and bool((b < -(B + 1)).any()) == below
        got = tb.backtrack(U, phi0, bt, s.levels, cap)[1]
        np.testing.assert_array_equal(got.numpy(), _jax_chase(s, jt, cap))


@pytest.mark.parametrize("name,nt,B", [("sos1", 120, 9), ("multi", 90, 16)])
def test_plain_walk_follows_jax_index_rule_at_negative_cap(name, nt, B):
    """A cap below 0 masks every seed of a valid table: the same rule."""
    s, jt, (U, phi0, bt) = _tables(name, nt, B, seed=3)
    for cap in (-1, -5):
        got = tb.backtrack(U, phi0, bt, s.levels, cap)[1]
        np.testing.assert_array_equal(got.numpy(), _jax_chase(s, jt, cap))


def test_budget_index_rule():
    """Negative budgets count from the end, then clamp to [0, B]: the
    traced-index rule of jnp indexing."""
    b = np.array([-9, -5, -4, -1, 0, 2, 3, 7])
    np.testing.assert_array_equal(tb.budget_index(b, 3), [0, 0, 0, 3, 0, 2, 3, 3])
    lookup = jax.jit(lambda i: jnp.arange(4)[i])
    for v in b:
        assert int(lookup(jnp.int32(v))) == tb.budget_index(v, 3)


def test_batched_and_trial_plain_chases_follow_the_rule():
    s, jt, (U, phi0, bt) = _tables("sos1", 50, 8, seed=1, inf_seed=True)
    want = [_jax_chase(s, jt, c) for c in (8, 4, 0)]
    got_b = tb.backtrack_batched_plain(U.expand(3, -1, -1, -1), phi0.expand(3, -1, -1),
                                       bt.expand(3, -1, -1), torch.tensor([8, 4, 0]))
    got_t = tb.backtrack_trials_plain(U[None], phi0[None], bt[None],
                                      torch.tensor([[8, 4, 0]]))
    for k in range(3):
        np.testing.assert_array_equal(got_b[k].numpy(), want[k])
        np.testing.assert_array_equal(got_t[0, k].numpy(), want[k])


# ------------------------------------------------- model of the chunked chase


def chunked_chase_model(U, phi0, btilde, cap, T):
    """numpy model of ``csrc/chase.cu``: C chunks of T steps.

    A: for every chunk c and state s = l·(B+1) + b, walk the chunk's steps;
       the exit state, or -1 where the budget fell below 0 inside the chunk.
    B: the masked first-index seed, then s_{c+1} = E[c, s_c]; at a sentinel,
       the serial walk (reference index rule) from that chunk's entry state
       to the end.
    C: every chunk before the sentinel re-walks from its entry state.
    """
    U = np.asarray(U)
    btilde = np.asarray(btilde)
    L, B1 = phi0.shape
    P = L * B1
    nt = btilde.shape[0]
    steps = nt - 1
    C = -(-steps // T) if steps > 0 else 0
    E = np.empty((C, P), dtype=np.int64)
    for c in range(C):  # phase A, all states at once
        l, b = np.divmod(np.arange(P), B1)
        alive = np.ones(P, dtype=bool)
        for k in range(c * T, min((c + 1) * T, steps)):
            nl = U[k, l, np.where(alive, b, 0)].astype(np.int64)
            nb = b - btilde[k, l]
            l = np.where(alive, nl, l)
            b = np.where(alive, nb, b)
            alive &= b >= 0
        E[c] = np.where(alive, l * B1 + b, -1)
    out = np.empty(nt, dtype=np.int32)
    masked = np.where(np.arange(B1) <= cap, np.asarray(phi0), np.inf)
    s = int(np.argmin(masked.reshape(-1)))  # phase B
    out[0] = s // B1
    entry, bad = [], C
    for c in range(C):
        entry.append(s)
        if E[c, s] < 0:
            bad = c
            l, b = divmod(s, B1)
            for k in range(c * T, steps):  # the serial tail
                nl = int(U[k, l, tb.budget_index(b, B1 - 1)])
                b -= int(btilde[k, l])
                l = nl
                out[k + 1] = l
            break
        s = int(E[c, s])
    for c in range(bad):  # phase C
        l, b = divmod(entry[c], B1)
        for k in range(c * T, min((c + 1) * T, steps)):
            nl = int(U[k, l, b])
            b -= int(btilde[k, l])
            l = nl
            out[k + 1] = l
    return out


MODEL_CASES = [
    # name, nt, B, T: nt 1 and 2, C = 1, nt-1 not a multiple of T, L = 1,
    # B = 0, the chip shapes' T (32 at fishing), several chunks.
    ("sos1", 1, 5, 4),
    ("sos1", 2, 5, 4),
    ("multi", 40, 12, 64),
    ("multi", 40, 12, 7),
    ("L1", 30, 4, 5),
    ("sos1", 50, 0, 6),
    ("sos1", 200, 30, 32),
    ("heat", 45, 12, 4),
]


@pytest.mark.parametrize("far", [False, True])
@pytest.mark.parametrize("name,nt,B,T", MODEL_CASES)
def test_chunked_chase_model_equals_plain_and_jax(name, nt, B, T, far):
    s, jt, (U, phi0, bt) = _tables(name, nt, B, seed=nt + B, inf_seed=far)
    for cap in sorted({B, B // 2, B // 4, 0, -1}, reverse=True):
        want = tb.backtrack_plain(U, phi0, bt, cap).numpy()
        np.testing.assert_array_equal(chunked_chase_model(U, phi0, bt, cap, T), want)
        np.testing.assert_array_equal(want, _jax_chase(s, jt, cap))


@pytest.mark.parametrize("seed", range(6))
def test_chunked_chase_model_random_tables(seed):
    """Seeded random tables and chunkings; the sentinel is hit off the path
    (states whose budget runs out), never on a path from a finite seed."""
    rng = np.random.default_rng(100 + seed)
    name = ["sos1", "multi", "heat"][seed % 3]
    nt = int(rng.integers(2, 120))
    B = int(rng.integers(0, 25))
    T = int(rng.integers(1, nt + 3))
    s, jt, (U, phi0, bt) = _tables(name, nt, B, seed=seed)
    for cap in (B, B // 2, B // 4, 0):
        want = tb.backtrack_plain(U, phi0, bt, cap).numpy()
        np.testing.assert_array_equal(chunked_chase_model(U, phi0, bt, cap, T), want)
        np.testing.assert_array_equal(want, _jax_chase(s, jt, cap))


def test_chase_plan_the_chip_shapes():
    """About CHASE_CHUNKS chunks at fishing and conv; heat's 27-plane chunks
    fit the shared-memory budget; all staged."""
    for nt, L, B, C, T in ((1024, 3, 170, 32, 32), (2048, 5, 128, 32, 64),
                           (1024, 36, 204, 38, 27)):
        plan = chase_plan(nt, L, B, 1)
        assert (plan.C, plan.T, plan.staged) == (C, T, True)
        assert plan.scratch == C * L * (B + 1) + C + 1
        assert plan.smem <= CHASE_SMEM_BYTES


@pytest.mark.parametrize("nt", [1, 2, 3, 100, 1024, 100000])
@pytest.mark.parametrize("L,B,ub", [(1, 0, 1), (3, 170, 1), (36, 204, 1), (130, 30, 4),
                                    (130, 400, 4), (241, 2000, 4)])
def test_chase_plan_takes_every_shape(nt, L, B, ub):
    """No shape is refused: C·T covers the steps, T ≤ the target's chunk
    length, a staged chunk fits its budget, planes too large for one chunk
    are read in place."""
    plan = chase_plan(nt, L, B, ub)
    steps = nt - 1
    assert plan.C * plan.T >= steps and (plan.C - 1) * plan.T < max(steps, 1)
    assert plan.T <= max(1, -(-steps // CHASE_CHUNKS))
    plane = L * (B + 1) * ub
    if plan.staged:
        assert plan.smem == -(-(plan.T * plane + 16) // 16) * 16 + 4 * plan.T * L
        assert plan.smem <= CHASE_SMEM_BYTES
    elif steps > 0:
        assert plane + 32 + 4 * L > CHASE_SMEM_BYTES and plan.smem == 0


# ------------------------------------------------- model of the build schedule


def build_schedule_model(stage, btilde, jump, B, smax, plan):
    """numpy model of ``csrc/dp_build.cuh``'s schedule: the ring chunks of R
    rows (chunk 0 staged before the sweep, chunk q+1 staged while chunk q
    runs, in the other buffer) and the fixed outputs per thread (thread t:
    l = t // tpl, b = t % tpl + k·tpl).  Reads stage and b̃ only from the
    ring, as the kernel's compute threads do."""
    stage, btilde, jump = (np.asarray(a) for a in (stage, btilde, jump))
    nt, L = stage.shape
    B1 = B + 1
    steps = nt - 1
    R = plan.R
    smax = min(smax, B)
    threads = [(t // plan.tpl, t % plan.tpl) for t in range(L * plan.tpl)]
    cover = sorted(l * B1 + b0 + k * plan.tpl for l, b0 in threads for k in range(plan.K)
                   if b0 + k * plan.tpl <= B)
    assert cover == list(range(L * B1))  # every output once
    cur = np.full((L, B1), np.inf)
    for l in range(L):
        if btilde[-1, l] <= B:
            cur[l, btilde[-1, l]] = stage[-1, l]
    U = np.zeros((max(steps, 0), L, B1), dtype=np.int64)
    rows = R if R > 0 else steps
    nch = (-(-steps // R) if R > 0 else 1) if steps > 0 else 0
    ring = [None, None]

    def fill(buf, lo, hi):
        ring[buf] = (stage[lo:hi + 1].copy(), btilde[lo:hi + 1].copy())

    if nch and R > 0:
        fill(0, max(0, steps - R), steps - 1)
    for q in range(nch):
        hi = steps - 1 - q * rows
        lo = max(0, hi - rows + 1)
        st_rows, bt_rows = ring[q & 1] if R > 0 else (stage[lo:], btilde[lo:])
        if R > 0 and q + 1 < nch:
            fill((q + 1) & 1, max(0, lo - R), lo - 1)
        for r in range(hi - lo, -1, -1):
            nxt = np.empty_like(cur)
            for l, b0 in threads:
                st_l, sh = st_rows[r, l], bt_rows[r, l]
                for k in range(plan.K):
                    b = b0 + k * plan.tpl
                    if b > B:
                        break
                    val, arg = np.inf, 0
                    if sh <= smax and b >= sh:
                        val = cur[0, b - sh] + jump[l, 0]
                        for j in range(1, L):
                            cand = cur[j, b - sh] + jump[l, j]
                            if cand < val:
                                val, arg = cand, j
                    nxt[l, b] = st_l + val
                    U[lo + r, l, b] = arg
            cur = nxt
    return U, cur


@pytest.mark.parametrize("name,nt,B,R", [
    ("sos1", 1, 4, None), ("sos1", 2, 3, None), ("sos1", 40, 9, None),
    ("multi", 30, 12, 7), ("multi", 30, 12, 29), ("L1", 25, 6, 4), ("sos1", 25, 0, 3),
    ("heat", 9, 8, 2), ("multi", 12, 5, 0)])
def test_build_schedule_model_bit_equal_plain(name, nt, B, R):
    """The ring's chunk bookkeeping (all rows at once, several chunks, a
    ragged last chunk, rows in place) and the fixed outputs give the plain
    build's U and phi0 bit for bit."""
    s = SETS[name]()
    rng = np.random.default_rng(nt * 7 + B)
    grad = torch.as_tensor(rng.normal(size=(nt, s.M)))
    u_old = torch.as_tensor(s.levels[rng.integers(0, s.L, size=nt)])
    jump = torch.as_tensor(jump_cost_table(s.levels, p=2, beta=0.05))
    smax = tb.max_budget_use(s.levels)
    stage, bt = tb.stage_tables(grad, u_old, s.levels, 0.05)
    plan = build_plan(nt, s.L, B, 8)
    if R is not None:
        plan = plan._replace(R=R)
    U_m, phi_m = build_schedule_model(stage, bt, jump, B, smax, plan)
    U_p, phi_p = tb.build_tables_plain(stage, bt, jump, B, smax)
    np.testing.assert_array_equal(U_m, U_p.numpy())
    assert np.array_equal(phi_m.view(np.int64), phi_p.numpy().view(np.int64))


def _first_kernel_accepts(L, B, item):
    return (2 * L * (B + 1) + L * L) * item <= MAX_SMEM_BYTES


@pytest.mark.parametrize("item", [4, 8])
def test_build_plan_accepts_what_the_first_kernel_took(item):
    """Every L the first build kernel took, at its largest B and a spread
    below it, at nt 1, 2 and 1024: a plan that fits one block."""
    for L in range(1, 242):
        top = (MAX_SMEM_BYTES // item - L * L) // (2 * L) - 1
        if top < 0:
            assert not _first_kernel_accepts(L, 0, item)
            continue
        assert _first_kernel_accepts(L, top, item)
        assert not _first_kernel_accepts(L, top + 1, item)
        for B in {0, top // 3, top // 2, top - 1, top} - {-1}:
            for nt in (1, 2, 1024):
                plan = build_plan(nt, L, B, item)
                assert plan.smem == smem_bytes(nt, L, B, item, plan.R, plan.jsmem)
                assert plan.smem <= MAX_SMEM_BYTES
                assert plan.threads <= MAX_THREADS
                assert plan.tpl * plan.K >= B + 1
                assert plan.threads == -(-L * plan.tpl // 32) * 32 + 32
                assert plan.jsmem <= (L > 8)
                if nt > 1 and plan.R == 0:  # rows in place: only L ≤ 2 at the edge
                    assert L <= 2 and B == top


def test_build_plan_the_chip_shapes():
    """Fishing and conv stage all their rows at once, one output per thread;
    heat scale rings chunks of rows in two buffers, with the jump table in
    shared memory."""
    fishing = build_plan(1024, 3, 170, 8)
    conv = build_plan(2048, 5, 128, 8)
    heat = build_plan(1024, 36, 204, 8)
    assert fishing.R == 1023 and conv.R == 2047
    assert not fishing.jsmem and not conv.jsmem
    assert (fishing.K, conv.K) == (1, 1)
    assert 0 < heat.R < 1023 and heat.jsmem
    assert heat.smem == (2 * 36 * 205 + 36 * 36) * 8 + 2 * heat.R * 36 * 12
    # float64 beyond one block: a level combination per half-warp.
    assert (heat.tpl, heat.K) == (16, 13) and (fishing.tpl, conv.tpl) == (171, 129)
    assert build_plan(1024, 36, 204, 4)[2:4] == (26, 8)
    with pytest.raises(ValueError, match="shared memory"):
        build_plan(20, 36, 500, 8)
    # Φ fits, two ring rows do not, and the first kernel refused it too.
    assert not _first_kernel_accepts(3, 4841, 8)
    with pytest.raises(ValueError, match="ring rows"):
        build_plan(1024, 3, 4841, 8)
    assert build_plan(1, 3, 4841, 8).R == 0  # no sweep step: nothing to stage
