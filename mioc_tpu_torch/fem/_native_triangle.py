"""ctypes binding to the port's copy of the native C++ triangulator.

Counterpart of ``mioc_tpu.fem._native_triangle``.  ``fem/native/triangle.cpp``
is a byte-for-byte copy of the JAX package's ``mioc_tpu/native/triangle.cpp``
(constrained Delaunay triangulation of a polygon with Ruppert-style quality
refinement and a maximum-area constraint, the stand-in for Shewchuk's
Triangle).  At first use it is built with ``g++`` (or ``clang++``) into the
git-ignored ``mioc_tpu_torch/_build/``, keyed by a hash of the source and
the flags.

Without a C++ compiler, or when the build fails, :func:`triangulate` returns
``None`` and :func:`~.mesh.init_mesh` falls back to the Python generator, as
the JAX package does; that mesh differs from the native one (another N,
other results), so the port says so with one ``warnings.warn`` naming the
cause.  :func:`available` tells which triangulator a mesh came from.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np

__all__ = ["available", "triangulate"]

SOURCE = Path(__file__).resolve().parent / "native" / "triangle.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LIB = None
_TRIED = False


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libmioc_triangle_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> str:
    """Compile the triangulator into ``target``; returns '' on success, else
    why it could not be built."""
    gxx = shutil.which("g++") or shutil.which("clang++")
    if gxx is None:
        return "no C++ compiler (g++ or clang++) on PATH"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        out = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"{gxx} failed: {exc}"
    if out.returncode != 0:
        return f"{gxx} failed:\n{out.stderr}"
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing
    return ""


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    target = _target()
    why = "" if target.exists() else _build(target)
    if not why:
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as exc:
            why = f"loading {target.name} failed: {exc}"
        else:
            lib.mioc_triangulate.restype = ctypes.c_longlong
            lib.mioc_triangulate.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,   # polygon
                ctypes.c_double,                                  # max area
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,    # out pts
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,       # out tris
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,       # out segs+mark
            ]
            _LIB = lib
    if why:
        warnings.warn(
            f"the native triangulator is not available ({why}); meshes come "
            "from the Python generator and differ from the native ones",
            RuntimeWarning, stacklevel=3)
    return _LIB


def available() -> bool:
    """True when meshes come from the native triangulator (building it if
    needed)."""
    return _load() is not None


def triangulate(vertices: np.ndarray, maxarea: float):
    """``(p, t, segments, markers)`` of the polygon ``vertices (nv, 2)`` with
    triangle areas ≤ ``maxarea``, or ``None`` without the native library."""
    lib = _load()
    if lib is None:
        return None
    nv = len(vertices)
    poly = np.ascontiguousarray(vertices, dtype=np.float64)
    # Generous output capacity estimates.
    area_poly = 0.5 * abs(
        np.sum(
            poly[:, 0] * np.roll(poly[:, 1], -1) - np.roll(poly[:, 0], -1) * poly[:, 1]
        )
    )
    cap_t = max(64, int(12 * area_poly / maxarea) + 16 * nv)
    cap_p = cap_t + 2 * nv + 8
    pts = np.zeros((cap_p, 2), dtype=np.float64)
    tris = np.zeros((cap_t, 3), dtype=np.int32)
    segs = np.zeros((cap_t, 3), dtype=np.int32)  # v1, v2, marker
    n = lib.mioc_triangulate(
        poly.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nv,
        ctypes.c_double(maxarea),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap_p,
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), cap_t,
        segs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), cap_t,
    )
    if n <= 0:
        return None
    npts = n & 0xFFFFF
    ntri = (n >> 20) & 0xFFFFF
    nseg = (n >> 40) & 0xFFFFF
    return (
        pts[:npts].copy(),
        tris[:ntri].astype(np.int64),
        segs[:nseg, :2].astype(np.int64),
        segs[:nseg, 2].astype(np.int64),
    )
