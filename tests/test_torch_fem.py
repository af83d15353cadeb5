"""Port vs JAX package: the FEM toolkit and the batch-invariant reductions.

The port keeps its own copy of the JAX package's numpy FEM code and of the
native triangulator's source, so the same inputs give the same arrays:
quadrature tables, meshes (vertices, triangles, edges, boundary markers,
affine maps), refinements, prolongations, dofmaps and assembled matrices
are EQUAL, not close.  Every mesh here comes from the same triangulator in
both packages (asserted: the native one wherever a C++ compiler is on the
machine).  ``detred``'s fold trees give the JAX package's bits.

The JAX package's loader links its library in place
(``mioc_tpu/native/libmioc_triangle.so``), so under pytest-xdist a worker
whose ``ctypes.CDLL`` lands while another worker is still linking it gets
``OSError``, and the loader keeps ``None`` for the rest of that process: its
meshes would come from the Python generator.  :func:`load_jax_triangulator`
(a module-scoped autouse fixture here, in ``test_torch_heat.py`` and in
``test_torch_sparse.py``) waits for the library instead.
"""

import ctypes
import pathlib
import shutil
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import mioc_tpu.fem as jf  # noqa: E402
from mioc_tpu.fem import _native_triangle as jnative  # noqa: E402
from mioc_tpu.fem.fe import global_dof_points  # noqa: E402
from mioc_tpu.ops import detred as jdet  # noqa: E402
import mioc_tpu_torch.fem as tf  # noqa: E402
from mioc_tpu_torch.fem import _native_triangle as tnative  # noqa: E402
from mioc_tpu_torch.ops import detred as tdet  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESH_FIELDS = ("p", "t", "e", "be", "cell_to_edge", "affine_matrix", "affine_vector",
               "affine_invmatrixT")


def load_jax_triangulator(timeout=120.0, pause=0.5):
    """The JAX package's native triangulator, loaded: where its loader gave
    ``None`` while a C++ compiler is on PATH, clear its latch, wait
    ``pause`` seconds and load again, for up to ``timeout`` seconds.  A
    finished link is newer than its source, so a retry only loads it, and a
    loaded mapping survives another worker's relink.  Asserts that the
    library loaded wherever a compiler is on PATH."""
    lib = jnative._load()
    compiler = shutil.which("g++") or shutil.which("clang++")
    deadline = time.monotonic() + timeout
    while lib is None and compiler and time.monotonic() < deadline:
        time.sleep(pause)
        jnative._TRIED, jnative._LIB = False, None
        lib = jnative._load()
    assert lib is not None or compiler is None, \
        f"the JAX package's triangulator did not load within {timeout} s"
    return lib


@pytest.fixture(scope="module", autouse=True)
def _jax_triangulator():
    load_jax_triangulator()


def _same_mesh(a, b):
    for f in MESH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert np.array_equal(np.asarray(a.geometry), np.asarray(b.geometry))


def _same_sparse(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    assert a.shape == b.shape
    assert np.array_equal(a.indptr, b.indptr) and np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data, b.data)


def test_triangulator_source_is_the_jax_packages():
    port = ROOT / "mioc_tpu_torch" / "fem" / "native" / "triangle.cpp"
    assert port.read_bytes() == (ROOT / "mioc_tpu" / "native" / "triangle.cpp").read_bytes()


def test_both_packages_use_the_same_triangulator():
    """The port's library is built into its own build directory; whether the
    native triangulator is used is the same in both packages."""
    assert tnative.available() == (jnative._load() is not None)
    if tnative.available():
        assert tnative._target().parent == ROOT / "mioc_tpu_torch" / "_build"


def test_missing_compiler_warns_once_and_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    poly = np.array([[-1.0, -1], [1, -1], [1, 1], [-1, 1]])
    with pytest.warns(RuntimeWarning, match="no C.. compiler"):
        assert tnative.triangulate(poly, 1.0) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tnative.triangulate(poly, 1.0) is None
        mesh = tf.init_mesh(poly, 1.0)  # the Python generator, as the JAX package
    _same_mesh(mesh, jf.mesh._init_mesh_python(poly, 1.0))


def test_jax_triangulator_load_retries_after_a_failed_load(monkeypatch):
    """A first ``CDLL`` that raises ``OSError`` (a worker loading while
    another links) still ends with the native library and equal meshes."""
    real, calls = ctypes.CDLL, []

    def flaky(path, *args, **kwargs):
        calls.append(path)
        if len(calls) == 1:
            raise OSError(f"{path}: file too short")
        return real(path, *args, **kwargs)

    monkeypatch.setattr(jnative, "_TRIED", False)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative.ctypes, "CDLL", flaky)
    lib = load_jax_triangulator(timeout=30.0, pause=0.01)
    if shutil.which("g++") or shutil.which("clang++"):
        assert lib is not None and len(calls) >= 2
        assert tnative.available()
    _same_mesh(tf.mesh_library("squareg", 0.5), jf.mesh_library("squareg", 0.5))


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6])
def test_area_quadrature_equal(order):
    for a, b in zip(tf.quadrature_unit_triangle_area(order),
                    jf.quadrature_unit_triangle_area(order)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("edge", [1, 2, 3])
@pytest.mark.parametrize("order", [1, 3, 5])
def test_bdry_quadrature_equal(edge, order):
    for a, b in zip(tf.quadrature_unit_triangle_bdry(edge, order),
                    jf.quadrature_unit_triangle_bdry(edge, order)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("geometry", ["squareg", "lshapeg", "regulartriangleg",
                                      "unittriangle"])
@pytest.mark.parametrize("hmax", [0.5, 0.1])
def test_mesh_library_equal(geometry, hmax):
    _same_mesh(tf.mesh_library(geometry, hmax), jf.mesh_library(geometry, hmax))


def test_refinements_equal():
    t, j = tf.mesh_library("squareg", 0.4), jf.mesh_library("squareg", 0.4)
    tr, jr = tf.refine_all_cells(t), jf.refine_all_cells(j)
    _same_mesh(tr, jr)
    marked = np.arange(t.ntri // 2)
    ta, ja = tf.refine_adaptively(t, marked), jf.refine_adaptively(j, marked)
    _same_mesh(ta, ja)
    for k in (1, 2, 3):
        _same_sparse(tf.prolongation(t, tr, tf.FE_Lagrange(k)),
                     jf.prolongation(j, jr, jf.FE_Lagrange(k)))
    _same_sparse(tf.prolongation(t, ta, tf.FE_Lagrange(1)),
                 jf.prolongation(j, ja, jf.FE_Lagrange(1)))
    tt, jt = tf.triangle_mesh(), jf.triangle_mesh()
    _same_sparse(tf.prolongation(tt, tf.refine_all_cells(tt), tf.FE_Lagrange(3),
                                 tf.FE_Lagrange(1)),
                 jf.prolongation(jt, jf.refine_all_cells(jt), jf.FE_Lagrange(3),
                                 jf.FE_Lagrange(1)))


@pytest.mark.parametrize("make", [
    lambda fem: fem.torus_mesh(3.0, 1.0, 24, 8),
    lambda fem: fem.moebius_mesh(3.0, 1.0, 30),
    lambda fem: fem.klein_bottle_mesh(36),
], ids=["torus", "moebius", "klein"])
def test_surface_meshes_equal(make):
    t, j = make(tf), make(jf)
    _same_mesh(t, j)
    assert tf.sanity_check(t) == jf.sanity_check(j)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_dofmaps_and_ndofs_equal(k):
    t, j = tf.mesh_library("squareg", 0.3), jf.mesh_library("squareg", 0.3)
    tfe, jfe = tf.FE_Lagrange(k), jf.FE_Lagrange(k)
    assert tf.ndofs(tfe, t) == jf.ndofs(jfe, j)
    assert tf.nlocaldofs(tfe) == jf.nlocaldofs(jfe) and tf.name(tfe) == jf.name(jfe)
    assert np.array_equal(tf.cell_dofs(tfe, t), jf.cell_dofs(jfe, j))
    for idx in (0, t.ntri // 2, t.ntri - 1):
        _same_sparse(tf.dofmap(tfe, t, idx), jf.dofmap(jfe, j, idx))
        for a, b in zip(tf.flat_dofmap(tfe, t, idx), jf.flat_dofmap(jfe, j, idx)):
            assert np.array_equal(a, b)
    _same_sparse(tf.dirichlet_constraints(tfe, t), jf.dirichlet_constraints(jfe, j))
    lam = np.array([[0.2, 0.3, 0.5], [1.0, 0.0, 0.0]])
    for a, b in zip(tf.shape(tfe, lam, return_d=True, return_H=True),
                    jf.shape(jfe, lam, return_d=True, return_H=True)):
        assert np.array_equal(a, b)
    assert np.array_equal(tf.fe.global_dof_points(tfe, t), global_dof_points(jfe, j))


@pytest.mark.parametrize("k", [1, 2, 3])
def test_assembly_equal(k):
    """M, A (stiffness), Q (Robin), F and Y0 as the heat problem assembles
    them, with function coefficients, plus advection: equal arrays."""
    t, j = tf.mesh_library("squareg", 0.3), jf.mesh_library("squareg", 0.3)
    tfe, jfe = tf.FE_Lagrange(k), jf.FE_Lagrange(k)
    quad = tf.quadrature_unit_triangle_area(3)
    coeffs = [
        (lambda x: np.eye(2), None, None, None),
        (None, None, 1.0, None),
        (None, None, None, lambda x: 20.0 * np.exp(-10.0 * ((x - 0.3) ** 2).sum(axis=0))),
        (None, None, None, lambda x: np.full(x.shape[1], 10.0)),
        (None, np.array([1.0, -0.5]), lambda x: 1.0 + x[0] ** 2, 1.0),
    ]
    for h in coeffs:
        (Ta, Tf), (Ja, Jf) = (tf.area_integrator(t, tfe, quad, *h),
                              jf.area_integrator(j, jfe, quad, *h))
        _same_sparse(Ta, Ja)
        assert np.array_equal(Tf, Jf)
    for h in ((0.12, None), (None, 0.12 * 3.0), (lambda x: 1.0 + x[1], lambda x: x[0])):
        (Tq, Tg), (Jq, Jg) = (tf.bdry_integrator(t, tfe, 1, *h),
                              jf.bdry_integrator(j, jfe, 1, *h))
        _same_sparse(Tq, Jq)
        assert np.array_equal(Tg, Jg)
    lam = np.array([[0.2, 0.3, 0.5]])
    assert np.array_equal(tf.affine_transformation(t, lam, 3),
                          jf.affine_transformation(j, lam, 3))


@pytest.mark.parametrize("dirichlet", [False, True])
def test_fem_solve_equal(dirichlet):
    (tm, tu), (jm, ju) = (tf.simple_test_FEM(hmax=0.2, dirichlet=dirichlet),
                          jf.simple_test_FEM(hmax=0.2, dirichlet=dirichlet))
    _same_mesh(tm, jm)
    assert np.array_equal(tu, ju)


def test_fem_benchmark_runs():
    out = tf.fem_benchmark(refs=2, verbose=False)
    assert set(out) == set(jf.fem_benchmark(refs=2, verbose=False))


def test_visualization_is_not_ported(monkeypatch, tmp_path):
    """Once refused; the port's ``visualize=True`` and
    ``plot_shape_functions`` now write what the JAX package's write: the
    same VTK and PVD bytes, and the PNG surface plot."""
    for name, fem in (("jax", jf), ("port", tf)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        fem.simple_test_FEM(hmax=0.5, visualize=True)
        fem.plot_shape_functions(fem.FE_Lagrange(1), refs=1)
        assert (tmp_path / name / "Solution-Lagrange_3.png").stat().st_size > 0
    files = sorted(p.name for p in (tmp_path / "jax").iterdir() if p.suffix in (".vtk", ".pvd"))
    assert "Solution-Lagrange_3.vtk" in files and any(f.endswith(".pvd") for f in files)
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir()
                           if p.suffix in (".vtk", ".pvd"))
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_exports_equal():
    assert sorted(tf.__all__) == sorted(jf.__all__)


@pytest.mark.parametrize("n", [1, 5, 545, 1024])
def test_detred_equal_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n))
    A = rng.standard_normal((7, n))
    tx, tA = torch.from_numpy(x), torch.from_numpy(A)
    assert np.array_equal(tdet.detsum(tx).numpy(), np.asarray(jdet.detsum(jnp.asarray(x))))
    assert np.array_equal(tdet.detsum(tx.T, axis=0).numpy(),
                          np.asarray(jdet.detsum(jnp.asarray(x.T), axis=0)))
    assert np.array_equal(tdet.detsum_all(tx).numpy(), np.asarray(jdet.detsum_all(x)))
    assert np.array_equal(tdet.detdot(tx[0], tx[1]).numpy(),
                          np.asarray(jdet.detdot(jnp.asarray(x[0]), jnp.asarray(x[1]))))
    assert np.array_equal(tdet.detmatvec(tA, tx[0]).numpy(),
                          np.asarray(jdet.detmatvec(jnp.asarray(A), jnp.asarray(x[0]))))
    # A row's bits do not depend on the batch in front of it.
    batched = tdet.detmatvec(tA, tx)
    for r in range(3):
        assert torch.equal(batched[r], tdet.detmatvec(tA, tx[r]))
