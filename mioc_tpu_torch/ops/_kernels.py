"""Build and load the port's CUDA kernels (``mioc_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Builds happen at
first use, never at import, into ``mioc_tpu_torch/_build/`` (git-ignored),
keyed by a hash of the source, the shared headers and the flags, so a
changed source rebuilds and an unchanged one loads at once.
:func:`build_all` starts one ``nvcc`` per source, all together, and waits
for them.  A missing ``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "PROBES", "NVCC_FLAGS", "build_all", "build_log", "library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("dp_build", "chase", "dp_build_batched", "chase_batched", "chase_trials",
           "chase_vec", "ode_lvm", "pde_dense")
# Sources that are no kernel of any path: the empty kernel with which
# profile_kernels.py times the host side of a launch.
PROBES = ("launch_probe",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put nvcc on PATH or set CUDA_HOME)")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    ``(target, tmp, process or None)``."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return target, tmp, proc


def _finish(name, target, tmp, proc) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing


def build_all(names=SOURCES) -> float:
    """Build every named kernel library (all nvcc processes at once); returns
    the seconds taken.  Already-built libraries are reused."""
    t0 = time.perf_counter()
    started = [(n, *_start(n)) for n in names]
    try:
        for n, target, tmp, proc in started:
            _finish(n, target, tmp, proc)
    finally:
        for _, _, _, proc in started:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the last build of ``name`` in this checkout, or '' if none."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""
