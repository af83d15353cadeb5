"""The port stands alone: no JAX, no ``mioc_tpu``.

An AST walk over every module of ``mioc_tpu_torch/`` and over
``chip_smoke.py`` and ``chip_multicard.py`` finds no import of ``jax``,
``jaxlib`` or ``mioc_tpu``; importing every module of the port in a fresh interpreter leaves ``jax``
out of ``sys.modules``.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "mioc_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_multicard.py"]
FORBIDDEN = ("jax", "jaxlib", "mioc_tpu")


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_modules_found():
    names = {p.relative_to(PORT).as_posix() for p in FILES if PORT in p.parents}
    assert {"ops/bellman.py", "ops/bellman_cuda.py", "ops/backtrack_cuda.py",
            "solvers/trm.py", "solvers/trm_device.py", "parallel/__init__.py",
            "parallel/batch.py", "interop.py", "cli.py", "models/registry.py",
            "models/convolution.py", "models/doubletank.py", "models/vanderpol.py",
            "models/fuller.py", "utils/io.py", "fem/__init__.py", "fem/quadrature.py",
            "fem/_native_triangle.py", "fem/mesh.py", "fem/fe.py", "fem/assembly.py",
            "fem/solve.py", "ops/detred.py", "ops/rows.py", "objectives/pde.py",
            "models/heat.py", "fem/sparse_device.py", "fem/banded_device.py",
            "fem/multigrid.py", "models/mixed_fishing.py", "solvers/continuous.py",
            "solvers/mixed.py", "parallel/temporal.py", "ops/xla_order.py",
            "parallel/device_mesh.py", "parallel/multihost.py", "parallel/shard_dp.py",
            "utils/plotting.py", "utils/vtk.py"} <= names
    assert (ROOT / "chip_smoke.py").exists()


def test_every_kernel_has_its_source():
    """Each kernel library the port builds has its CUDA source in csrc/, and
    every source there is built: a kernel of the paths, or a probe."""
    from mioc_tpu_torch.ops import _kernels

    assert not set(_kernels.SOURCES) & set(_kernels.PROBES)
    assert set(_kernels.SOURCES) | set(_kernels.PROBES) == {
        p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert {"dp_build", "chase", "dp_build_batched", "chase_batched",
            "chase_trials", "chase_vec"} <= set(_kernels.SOURCES)


def test_importing_the_port_loads_no_jax():
    mods = [".".join(("mioc_tpu_torch",) + p.relative_to(PORT).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'mioc_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
