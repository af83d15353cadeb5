"""Build, load, bind and launch the port's CUDA kernels (``mioc_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Builds happen at
first use, never at import, into ``mioc_tpu_torch/_build/`` (git-ignored),
keyed by a hash of the source, the shared headers and the flags, so a
changed source rebuilds and an unchanged one loads at once.
:func:`build_all` starts one ``nvcc`` per source, all together, and waits
for them.  A missing ``nvcc`` or a failed build raises; nothing falls back.

This module is the one that knows how a kernel is called.  The wrappers
(``bellman_cuda``, ``backtrack_cuda``, ``ode_cuda``, ``pde_cuda``) keep their
plans, shape rules and the argument order of their C entries, named as
``(library, symbol, argument types)`` with the types :data:`P`, :data:`I`,
:data:`LL`, :data:`D`, and call:

* :func:`check` on every tensor argument, :func:`suffix` for the storage
  type of an entry with one instance per type;
* :func:`launch` for every launch: the current stream, a device switch only
  where needed, the error, the wrapper's ``launches`` count;
* :func:`clusters_held` for every ``cudaOccupancyMaxActiveClusters`` query,
  with :func:`device_index` naming the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["SOURCES", "PROBES", "NVCC_FLAGS", "build_all", "build_log", "library", "entry",
           "launch", "clusters_held", "device_index", "check", "suffix", "SUFFIX",
           "P", "I", "LL", "D"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("chase", "dp_build_batched", "chase_batched", "chase_trials", "chase_vec",
           "ode_lvm", "pde_dense")
# Sources that are no kernel of any path: the empty kernel with which
# profile_kernels.py times the host side of a launch.
PROBES = ("launch_probe",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The C entries' argument types: pointers (the stream last), int, long long, double.
P, I, LL, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# The symbol suffix of the entries that have one instance per storage type.
SUFFIX = {torch.float64: "f64", torch.float32: "f32"}

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


@functools.lru_cache(maxsize=None)
def entry(lib_name: str, symbol: str, argtypes: tuple):
    """The C entry point ``symbol`` of ``csrc/<lib_name>.cu``, typed once with
    ``argtypes`` and a ``c_int`` result, a cudaError_t value (the chases
    launch thousands of times in one solve)."""
    fn = getattr(library(lib_name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(wrapper, name: str, spec: tuple, device: torch.device, *args) -> None:
    """Launch the C entry ``spec = (library, symbol, argument types)`` with
    ``args`` and the current stream of the card ``device``, made the current
    device only where it is not already (the switch costs the host more than
    the launch).  A non-zero cudaError_t raises ``RuntimeError("<name> launch
    failed: CUDA error <n>")``; a launch advances ``wrapper.launches``.

    ``wrapper`` is the wrapper as its module names it at the call, so that
    a tracer that replaced the module's attribute counts the launch."""
    fn = entry(*spec)
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    wrapper.launches += 1


@functools.lru_cache(maxsize=1024)
def clusters_held(index: int, spec: tuple, *args) -> int:
    """How many clusters of one launch configuration the card ``index`` holds
    at once (0: it schedules none): the C entry ``spec = (library, symbol,
    argument types)``, a ``cudaOccupancyMaxActiveClusters`` query, called
    with ``args`` and the count's pointer.  Raises ``RuntimeError`` on a CUDA
    error; what a count means is the caller's rule."""
    count = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = entry(*spec)(*args, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"{spec[1]}: the cluster query failed: CUDA error {err}")
    return count.value


def device_index(device=None) -> int:
    """The index of the card ``device`` names (an int, a string or a
    ``torch.device``), or of the current card where it names none."""
    if isinstance(device, int):
        return device
    index = None if device is None else torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def check(name: str, t: torch.Tensor, dtype, shape: tuple = None, device=None,
          contiguous: bool = True, kernels: str = "the kernels") -> None:
    """Check the kernel argument ``t`` called ``name``: on the card ``device``,
    or on any CUDA device where that is None (``kernels`` names them in the
    error); of ``dtype``, one or a tuple; of ``shape`` where given;
    contiguous where asked.  Raises ``ValueError`` for the device, the shape
    and the layout, ``TypeError`` for the dtype."""
    if device is None:
        if t.device.type != "cuda":
            raise ValueError(f"{kernels} take CUDA tensors, got {name} on {t.device}")
    elif t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        want = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if shape is not None and t.shape != shape:
        raise ValueError(f"shapes: {name} {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def suffix(t: torch.Tensor, kernels: str) -> str:
    """The symbol suffix (:data:`SUFFIX`) of the instance of ``kernels`` for
    ``t``'s storage type; ``TypeError`` where they have none."""
    if t.dtype not in SUFFIX:
        raise TypeError(f"{kernels} take float64 or float32, got {t.dtype}")
    return SUFFIX[t.dtype]
