"""Port vs JAX package: the large-mesh PDE engines.

ELL storage and CG (``fem/sparse_device.py``), the block-banded operators
(``fem/banded_device.py``) and the multigrid V-cycle (``fem/multigrid.py``).
The host side is the JAX package's numpy/scipy code, so its arrays are
EQUAL: ELL values and columns, the RCM and aligned coarse permutations,
packed blocks, every level's K/P/R and the coarse inverse.  The device side
sums in other orders than XLA: products, CG solves and V-cycles agree with
the JAX package's to 1e-13 relative at float64 (measured on the CPU: ≤ 3e-15
for the products, ≤ 4e-15 for the solves).  Within the port, every row of a
rows form has the bits of that row alone (1, 2, 9 and 17 rows: one chunk,
two, a padded last chunk), and zero rows stay zero through the guarded CG.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402
from mioc_tpu.fem import banded_device as jbd  # noqa: E402
from mioc_tpu.fem import multigrid as jmg  # noqa: E402
from mioc_tpu.fem import sparse_device as jsd  # noqa: E402
from mioc_tpu.models import heat as jheat  # noqa: E402
from mioc_tpu_torch.fem import banded_device as bd  # noqa: E402
from mioc_tpu_torch.fem import multigrid as mg  # noqa: E402
from mioc_tpu_torch.fem import sparse_device as sd  # noqa: E402
from mioc_tpu_torch.fem import FE_Lagrange  # noqa: E402
from mioc_tpu_torch.models import heat as theat  # noqa: E402
from test_torch_fem import load_jax_triangulator  # noqa: E402

ROWS = (1, 2, 9, 17)
RTOL = 1e-13
CPU = torch.device("cpu")
F64 = torch.float64


@pytest.fixture(scope="module", autouse=True)
def _jax_triangulator():
    """Both packages' meshes from the native triangulator (test_torch_fem.py)."""
    load_jax_triangulator()


@pytest.fixture(scope="module")
def heat_K():
    """The heat problem's K = M + τA on the twice-refined mesh (N = 145) and
    the three-mesh hierarchy, from the port's assembly (equal to the JAX
    package's, test_torch_fem.py)."""
    hier = theat.construct_mesh_hierarchy(refinements=2)
    obj = theat.HeatObj(nt=20, mesh=hier[-1], device="cpu")
    K = (obj.M + obj.tau * sp.csc_matrix(obj.A)).tocsr()
    return K, hier, jheat.construct_mesh_hierarchy(refinements=2)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _banded_random(rng, n, band):
    diags = [rng.normal(size=n - abs(d)) for d in range(-band, band + 1)]
    return sp.diags(diags, list(range(-band, band + 1))).tocsr()


def _tall(rng, nr=300, nc=75):
    """A prolongation-like tall banded matrix (tests/test_heat.py:162)."""
    rows, cols, vals = [], [], []
    for i in range(nr):
        for j in range(max(0, i // 4 - 2), min(nc, i // 4 + 3)):
            rows.append(i)
            cols.append(j)
            vals.append(rng.normal())
    return sp.csr_matrix((vals, (rows, cols)), shape=(nr, nc))


def _spd(rng, n=160):
    B = _banded_random(rng, n, 3)
    return (B.T @ B + 10.0 * sp.eye(n)).tocsr()


# -- host arrays: equal ------------------------------------------------------

def test_to_ell_equal(heat_K):
    K = heat_K[0]
    for mat in (K, _tall(np.random.default_rng(0))):
        v, c = sd.to_ell(mat)
        jv, jc = jsd.to_ell(mat)
        assert v.dtype == jv.dtype and c.dtype == jc.dtype
        assert np.array_equal(v, jv) and np.array_equal(c, jc)


def test_permutations_and_packing_equal(heat_K):
    K = heat_K[0]
    perm = bd.rcm_permutation(K)
    assert np.array_equal(perm, jbd.rcm_permutation(K))
    Kp = K[perm][:, perm]
    for rb in (16, 128):
        spec, blk = bd.pack_banded(Kp, rb=rb)
        jspec, jblk = jbd.pack_banded(Kp, rb=rb, dtype=np.float64)
        assert tuple(spec) == tuple(jspec) and np.array_equal(blk, jblk)
    P = sp.csr_matrix(_tall(np.random.default_rng(1)))
    assert np.array_equal(bd.aligned_coarse_permutation(P), jbd.aligned_coarse_permutation(P))
    spec, blk = bd.pack_banded(P, rb=16)
    jspec, jblk = jbd.pack_banded(P, rb=16, dtype=np.float64)
    assert tuple(spec) == tuple(jspec) and np.array_equal(blk, jblk)


def test_mg_levels_equal(heat_K):
    K, hier, jhier = heat_K
    fe = FE_Lagrange(2)
    from mioc_tpu.fem import FE_Lagrange as jFE

    ops = mg.build_mg_ops(hier, fe, K)
    jops = jmg.build_mg_ops(jhier, jFE(2), K)
    assert len(ops["levels"]) == len(jops["levels"]) == 2
    for L, jL in zip(ops["levels"], jops["levels"]):
        for k in ("Kv", "Kc", "dinv", "Pv", "Pc", "Rv", "Rc"):
            assert np.array_equal(L[k], np.asarray(jL[k])), k
    assert np.array_equal(ops["coarse_inv"], np.asarray(jops["coarse_inv"]))
    perm = bd.rcm_permutation(K)
    static, bops = mg.build_mg_banded(hier, fe, K, perm)
    jstatic, jbops = jmg.build_mg_banded(jhier, jFE(2), K, perm, np.float64)
    assert [{k: tuple(v) for k, v in S.items()} for S in static] == \
        [{k: tuple(v) for k, v in S.items()} for S in jstatic]
    for L, jL in zip(bops["levels"], jbops["levels"]):
        for k in ("Kblk", "dinv", "Pblk", "Rblk"):
            assert np.array_equal(L[k], np.asarray(jL[k])), k
    assert np.array_equal(bops["coarse_inv"], np.asarray(jbops["coarse_inv"]))
    # The prolongations may stand in for the meshes.
    Ps = mg.mesh_prolongations(hier, fe)
    static2, bops2 = mg.build_mg_banded(None, None, K, perm, prolongations=Ps)
    assert static2 == static and all(np.array_equal(a["Kblk"], b["Kblk"]) for a, b in
                                     zip(bops2["levels"], bops["levels"]))


# -- products against the JAX package ----------------------------------------

def test_ell_matvec_matches_jax(heat_K):
    K = heat_K[0]
    v, c = sd.to_ell(K)
    x = np.random.default_rng(2).normal(size=K.shape[1])
    got = sd.ell_matvec(_t(v), torch.as_tensor(c.astype(np.int64)), _t(x))
    _close(got, np.asarray(jsd.ell_matvec(jnp.asarray(v), jnp.asarray(c), jnp.asarray(x))))
    _close(got, K @ x)


@pytest.mark.parametrize("which", ["square", "rectangular"])
def test_banded_matvec_matches_jax(which):
    rng = np.random.default_rng(5)
    if which == "square":
        A = _banded_random(rng, 200, 5)
        perm = bd.rcm_permutation(A)
        A = A[perm][:, perm]
    else:
        A = _tall(rng)
    spec, blk = bd.pack_banded(A, rb=16)
    dblk = bd.device_blocks(spec, blk, device=CPU, dtype=F64)
    x = rng.normal(size=A.shape[1])
    got = bd.banded_matvec(spec, dblk, _t(x))
    _close(got, np.asarray(jbd.banded_matvec(spec, jnp.asarray(blk), jnp.asarray(x))))
    _close(got, A @ x)


def test_banded_layout_checks():
    A = _banded_random(np.random.default_rng(6), 64, 2)
    spec, blk = bd.pack_banded(A, rb=16)
    dblk = bd.device_blocks(spec, blk, device=CPU, dtype=F64)
    assert tuple(dblk.shape) == (4, 3 * 16, 16)
    good = bd.layout_for(64, [spec], [spec])
    assert good.front == 16 and good.total == 96
    X = torch.zeros(2, good.total, dtype=F64)
    with pytest.raises(ValueError, match="cannot hold the windows"):
        bd.banded_apply(spec, dblk, X, bd.Layout(64, 0, good.total), good)
    with pytest.raises(ValueError, match="cannot hold the rows"):
        bd.banded_apply(spec, dblk, X, good, bd.Layout(64, 40, good.total))


def test_cg_solve_matches_jax():
    rng = np.random.default_rng(7)
    A = _spd(rng)
    spec, blk = bd.pack_banded(A, rb=16)
    dblk = bd.device_blocks(spec, blk, device=CPU, dtype=F64)
    dinv = 1.0 / A.diagonal()
    b = rng.normal(size=A.shape[0])
    x = sd.cg_solve(lambda v: bd.banded_matvec(spec, dblk, v), _t(b), torch.zeros_like(_t(b)),
                    _t(dinv), 60)
    jx = jsd.cg_solve(lambda v: jbd.banded_matvec(spec, jnp.asarray(blk), v), jnp.asarray(b),
                      jnp.zeros(len(b)), jnp.asarray(dinv), 60)
    _close(x, np.asarray(jx))
    assert np.linalg.norm(b - A @ x.numpy()) / np.linalg.norm(b) < 1e-10
    rows = sd.cg_solve_rows(lambda V: bd.banded_matvec_rows(spec, dblk, V), _t(b)[None],
                            torch.zeros(1, len(b), dtype=F64), _t(dinv), 60)
    jrows = jsd.cg_solve_rows(lambda V: jbd.banded_matvec_rows(spec, jnp.asarray(blk), V),
                              jnp.asarray(b)[None], jnp.zeros((1, len(b))), jnp.asarray(dinv), 60)
    _close(rows, np.asarray(jrows))


def test_mg_apply_matches_jax(heat_K):
    K, hier, jhier = heat_K
    from mioc_tpu.fem import FE_Lagrange as jFE

    fe, jfe = FE_Lagrange(2), jFE(2)
    b = np.random.default_rng(8).normal(size=K.shape[0])
    ops = mg.mg_device(mg.build_mg_ops(hier, fe, K), device=CPU, dtype=F64)
    jops = jmg.build_mg_ops(jhier, jfe, K)
    _close(mg.mg_apply(ops, _t(b)), np.asarray(jmg.mg_apply(jops, jnp.asarray(b))))
    perm = bd.rcm_permutation(K)
    static, host = mg.build_mg_banded(hier, fe, K, perm)
    dev = mg.mg_banded_device(static, host, device=CPU, dtype=F64)
    jstatic, jops = jmg.build_mg_banded(jhier, jfe, K, perm, np.float64)
    _close(mg.mg_apply_banded(static, dev, _t(b[perm])),
           np.asarray(jmg.mg_apply_banded(jstatic, jops, jnp.asarray(b[perm]))))
    _close(mg.mg_apply_banded_rows(static, dev, _t(b[perm])[None]),
           np.asarray(jmg.mg_apply_banded_rows(jstatic, jops, jnp.asarray(b[perm])[None])))


# -- rows: each row has its single form's bits -------------------------------

@pytest.fixture(scope="module")
def banded_case(heat_K):
    K, hier, _ = heat_K
    perm = bd.rcm_permutation(K)
    Kp = K[perm][:, perm]
    spec, blk = bd.pack_banded(Kp)
    static, host = mg.build_mg_banded(hier, FE_Lagrange(2), K, perm)
    P = sp.csr_matrix(_tall(np.random.default_rng(9)))
    pspec, pblk = bd.pack_banded(P, rb=16)
    return {"K": (spec, bd.device_blocks(spec, blk, device=CPU, dtype=F64)),
            "P": (pspec, bd.device_blocks(pspec, pblk, device=CPU, dtype=F64)),
            "mg": (static, mg.mg_banded_device(static, host, device=CPU, dtype=F64)),
            "dinv": _t(1.0 / Kp.diagonal()), "N": K.shape[0]}


@pytest.mark.parametrize("rows", ROWS)
def test_banded_matvec_rows_bit_equal_single(banded_case, rows):
    rng = np.random.default_rng(rows)
    for spec, dblk in (banded_case["K"], banded_case["P"]):
        xs = _t(rng.normal(size=(rows, spec.ncols)))
        ys = bd.banded_matvec_rows(spec, dblk, xs)
        assert ys.shape == (rows, spec.nrows)
        for r in range(rows):
            assert torch.equal(ys[r], bd.banded_matvec(spec, dblk, xs[r]))


@pytest.mark.parametrize("rows", ROWS)
def test_cg_solve_rows_bit_equal_single(banded_case, rows):
    spec, dblk = banded_case["K"]
    static, dev = banded_case["mg"]
    bs = _t(np.random.default_rng(10 + rows).normal(size=(rows, banded_case["N"])))
    x0 = torch.zeros_like(bs)
    mvr = lambda V: bd.banded_matvec_rows(spec, dblk, V)  # noqa: E731
    for pc in (banded_case["dinv"], lambda R: mg.mg_apply_banded_rows(static, dev, R)):
        xs = sd.cg_solve_rows(mvr, bs, x0, pc, 8)
        for r in range(rows):
            assert torch.equal(xs[r], sd.cg_solve_rows(mvr, bs[r:r + 1], x0[r:r + 1], pc, 8)[0])


@pytest.mark.parametrize("rows", ROWS)
def test_mg_apply_banded_rows_bit_equal_single(banded_case, rows):
    static, dev = banded_case["mg"]
    bs = _t(np.random.default_rng(20 + rows).normal(size=(rows, banded_case["N"])))
    zs = mg.mg_apply_banded_rows(static, dev, bs)
    for r in range(rows):
        assert torch.equal(zs[r], mg.mg_apply_banded(static, dev, bs[r]))


def test_cg_zero_rows_stay_fixed_points(banded_case):
    """Zero rows (a fixed-width batch's pad rows) through the guarded CG:
    zero, not 0/0 = NaN; a real row beside them is unchanged."""
    spec, dblk = banded_case["K"]
    static, dev = banded_case["mg"]
    mvr = lambda V: bd.banded_matvec_rows(spec, dblk, V)  # noqa: E731
    b = _t(np.random.default_rng(30).normal(size=(3, banded_case["N"])))
    b[1] = 0.0
    for pc in (banded_case["dinv"], lambda R: mg.mg_apply_banded_rows(static, dev, R)):
        xs = sd.cg_solve_rows(mvr, b, torch.zeros_like(b), pc, 12)
        assert torch.isfinite(xs).all() and torch.equal(xs[1], torch.zeros_like(xs[1]))
        x = sd.cg_solve(lambda v: bd.banded_matvec(spec, dblk, v), torch.zeros_like(b[0]),
                        torch.zeros_like(b[0]), banded_case["dinv"], 12)
        assert torch.equal(x, torch.zeros_like(x))
