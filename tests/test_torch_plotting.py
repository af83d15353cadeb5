"""Port vs JAX package: plotting and VTK output (``utils/plotting.py``,
``utils/vtk.py``), each test in its own ``tmp_path``.

The VTK and PVD writers write the same bytes for the same mesh and data;
``plot_results`` writes its image and ``.dat`` exports byte-equal to the JAX
package's on the same objective (fishing and mixed fishing, whose sweeps
have the JAX package's bits); ``animate_solution`` writes a GIF or an MP4;
``simple_test_FEM(visualize=True)`` writes its VTK (the JAX package's bytes)
and PNG.  The JAX counterparts are in ``tests/test_aux.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from mioc_tpu import fem as jfem  # noqa: E402
from mioc_tpu.models import LVMObj as JaxLVM  # noqa: E402
from mioc_tpu.models.mixed_fishing import LVMMixedObj as JaxMixed  # noqa: E402
from mioc_tpu.utils import plotting as jplot  # noqa: E402
from mioc_tpu.utils import vtk as jvtk  # noqa: E402
from mioc_tpu.utils.init import rand_func as jrand_func  # noqa: E402
from mioc_tpu_torch import fem as tfem  # noqa: E402
from mioc_tpu_torch.models import LVMMixedObj, LVMObj  # noqa: E402
from mioc_tpu_torch.utils import plotting as tplot  # noqa: E402
from mioc_tpu_torch.utils import vtk as tvtk  # noqa: E402


@pytest.fixture
def in_tmp(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
    return tmp_path


def _fields(mesh):
    rng = np.random.default_rng(0)
    return (rng.normal(size=mesh.np), rng.normal(size=mesh.ntri), rng.normal(size=(3, mesh.np)))


def _same_tree(root):
    files = sorted(p.relative_to(root / "jax") for p in (root / "jax").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(root / "port") for p in (root / "port").rglob("*")
                           if p.is_file())
    return files


def test_write_vtk_and_pvd_same_bytes(in_tmp):
    mesh = tfem.mesh_library("squareg", 0.5)
    u, c, v = _fields(mesh)
    for name, vtk in (("jax", jvtk), ("port", tvtk)):
        d = in_tmp / name
        vtk.write_vtk(str(d / "t1"), mesh, [("u", u), ("c", c), ("v", v)])
        vtk.write_vtk(str(d / "t2"), mesh, ("v", v))
        vtk.write_vtk(str(d / "t3"), mesh, u)
        vtk.write_vtk(str(d / "t4.vtk"), mesh)
        with vtk.PVDCollection(str(d / "series")) as pvd:
            vtk.pvd_append(pvd, 0.0, mesh, u)
            vtk.pvd_append(pvd, 0.1, mesh, [("u", u), ("c", c)])
    files = _same_tree(in_tmp)
    assert len(files) == 7
    for f in files:
        assert (in_tmp / "port" / f).read_bytes() == (in_tmp / "jax" / f).read_bytes(), f


def _plot_both(in_tmp, jobj, tobj):
    for name, plot, obj in (("jax", jplot, jobj), ("port", tplot, tobj)):
        d = in_tmp / name
        out = plot.plot_results(obj, filename=str(d / "r.png"), data_dir=str(d / "dat"))
        assert out == str(d / "r.png") and (d / "r.png").stat().st_size > 0
    files = [f for f in _same_tree(in_tmp) if f.suffix == ".dat"]
    for f in files:
        assert (in_tmp / "port" / f).read_bytes() == (in_tmp / "jax" / f).read_bytes(), f
    return {f.name for f in files}


def test_plot_results_fishing_same_dat_files(in_tmp):
    jobj, tobj = JaxLVM(nt=50), LVMObj(nt=50, device="cpu")
    x = np.full((50, 3), 0.5)
    jobj.x, tobj.x = jnp.asarray(x), tobj.as_control(x)
    jobj.eval_fdf_()
    tobj.eval_fdf_()
    names = _plot_both(in_tmp, jobj, tobj)
    assert {"v(1).dat", "nabla_f_v(3).dat", "y(1).dat", "y(2).dat"} <= names


def test_plot_results_mixed_same_dat_files(in_tmp):
    jobj, tobj = JaxMixed(nt=48), LVMMixedObj(nt=48, device="cpu")
    x = jrand_func(jobj, seed=1)
    x[:, 0] = np.random.default_rng(1).random(48) * 0.3
    jobj.x, tobj.x = jnp.asarray(x), tobj.as_control(x)
    jobj.eval_fdf_()
    tobj.eval_fdf_()
    names = _plot_both(in_tmp, jobj, tobj)
    assert {"u(1).dat", "nabla_f_u(1).dat", "v(1).dat", "y(2).dat"} <= names


def test_animate_solution_writes_a_movie(in_tmp):
    mesh = tfem.mesh_library("squareg", 0.5)
    state = torch.as_tensor(np.random.default_rng(0).random((6, mesh.np)))  # time-major
    v = np.random.default_rng(1).integers(0, 5, size=(5, 2)).astype(float)
    out = tplot.animate_solution(mesh, state, 0.1, str(in_tmp / "anim"), v=v, fps=2,
                                 max_frames=3)
    assert out in (str(in_tmp / "anim.mp4"), str(in_tmp / "anim.gif"))
    assert (in_tmp / out).stat().st_size > 0


def test_plot_solution_and_fem_visualize(in_tmp):
    for name, fem in (("jax", jfem), ("port", tfem)):
        prefix = str(in_tmp / name / "Solution")
        fem.simple_test_FEM(hmax=0.5, visualize=True, out_prefix=prefix)
    for f in ("Solution-Lagrange_3.vtk", "Solution-Lagrange_3.png"):
        assert (in_tmp / "port" / f).stat().st_size > 0
    assert ((in_tmp / "port" / "Solution-Lagrange_3.vtk").read_bytes()
            == (in_tmp / "jax" / "Solution-Lagrange_3.vtk").read_bytes())
    mesh = tfem.mesh_library("squareg", 0.5)
    out = tplot.plot_solution(mesh, torch.as_tensor(_fields(mesh)[0]), "u",
                              str(in_tmp / "port" / "s.png"))
    assert (in_tmp / "port" / "s.png").stat().st_size > 0 and out.endswith("s.png")
