"""The port stands alone: no JAX, no ``mioc_tpu``.

An AST walk over every module of ``mioc_tpu_torch/`` and over
``chip_smoke.py`` and ``chip_multicard.py`` finds no import of ``jax``,
``jaxlib`` or ``mioc_tpu``; importing every module of the port in a fresh interpreter leaves ``jax``
out of ``sys.modules``.

The kernels' launch layer: only ``ops/_kernels.py`` binds a C entry, takes
a stream, enters a device context or queries occupancy, and every kernel
entry refuses CPU tensors before any library is loaded.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

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
    assert {"chase", "dp_build_batched", "chase_batched", "chase_trials",
            "chase_vec"} <= set(_kernels.SOURCES)


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


# ------------------------------------------------- the kernels' launch layer

WRAPPERS = ("bellman_cuda", "backtrack_cuda", "ode_cuda", "pde_cuda")
# What only the launch layer (ops/_kernels.py) writes.
LAUNCH_ONLY = ("torch.cuda.current_stream", "torch.cuda.device(", ".argtypes", ".restype")


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_leave_the_launch_to_the_launch_layer(name):
    """A wrapper names its C entries' argument types and calls
    ``_kernels``: it takes no stream, enters no device context, types no
    entry, imports no ``ctypes`` and nothing private of another wrapper."""
    ops = PORT / "ops"
    assert {p.stem for p in ops.glob("*_cuda.py")} == set(WRAPPERS)
    layer = (ops / "_kernels.py").read_text()
    assert all(n in layer for n in LAUNCH_ONLY)
    path = ops / f"{name}.py"
    text = path.read_text()
    assert not [n for n in LAUNCH_ONLY if n in text]
    assert "ctypes" not in set(_imported(path))
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.ImportFrom) and (node.module or "").endswith("_cuda"):
            assert not [a.name for a in node.names if a.name.startswith("_")], node.module


KERNEL_ENTRIES = ("dp_build", "dp_build_batched", "chase", "chase_vec", "chase_batched",
                  "chase_trials", "lvm_forward", "lvm_adjoint", "dense_sweep")


def _cpu_call(name):
    """``(wrapper, call)``: the kernel entry ``name`` on CPU tensors of
    shapes and dtypes it takes."""
    from mioc_tpu_torch.ops import backtrack_cuda, bellman_cuda, ode_cuda, pde_cuda

    nt, L, B, S = 6, 3, 4, 2

    def z(*shape, dtype=torch.float64):
        return torch.zeros(shape, dtype=dtype)

    U, phi0, bt = z(nt - 1, L, B + 1, dtype=torch.int8), z(L, B + 1), z(nt, L, dtype=torch.int32)
    Us, phis, bts = (t.expand(S, *t.shape).contiguous() for t in (U, phi0, bt))
    calls = {
        "dp_build": lambda f: f(z(nt, L), bt, z(L, L), B, B),
        "dp_build_batched": lambda f: f(z(S, nt, L), bts, z(L, L), B, B),
        "chase": lambda f: f(U, phi0, bt, B),
        "chase_vec": lambda f: f(U, phi0, bt, B),
        "chase_batched": lambda f: f(Us, phis, bts, B),
        "chase_trials": lambda f: f(Us, phis, bts, z(S, 2, dtype=torch.int32)),
        "lvm_forward": lambda f: f(z(nt, S, 2), z(2), 1.0, 1.0, 1.0, 1.0, 0.1),
        "lvm_adjoint": lambda f: f(z(nt, S, 2), z(nt, S, 2),
                                   ode_cuda.rule_table("4" * (nt - 1), "cpu"), z(2), z(3),
                                   z(3), 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.1),
        "dense_sweep": lambda f: f(None, z(nt, S, 8), z(8, 8), False),
    }
    module = next(m for m in (bellman_cuda, backtrack_cuda, ode_cuda, pde_cuda)
                  if name in m.__all__)
    wrapper = getattr(module, name)
    return wrapper, lambda: calls[name](wrapper)


@pytest.mark.parametrize("name", KERNEL_ENTRIES)
def test_kernel_entries_refuse_cpu_tensors_before_loading(name, monkeypatch):
    """Every kernel entry handed CPU tensors raises ``ValueError`` ("CUDA
    tensors") from its checks, before any library is loaded and with no
    launch counted."""
    from mioc_tpu_torch.ops import _kernels

    def refuse(lib_name):
        raise AssertionError(f"library {lib_name} loaded")

    monkeypatch.setattr(_kernels, "library", refuse)
    wrapper, call = _cpu_call(name)
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()
    assert wrapper.launches == before
