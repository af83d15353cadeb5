"""Result IO: pgfplots ``.dat`` tables and solver checkpoints.

Counterpart of ``mioc_tpu.utils.io``.  The ``.dat`` format is that of the
reference's ``save_latex_format`` / ``import_from_latex_format``
(``HelpFunctions.jl:401-444``): a header line ``x    y`` then
whitespace-separated pairs, in a ``data_files/`` directory.  Checkpoints
(the reference has none) hold the TRM outer-loop state ``(u, Δ, iter, J,
TV)`` as an ``.npz``, making solves restartable.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "save_latex_format",
    "import_from_latex_format",
    "save_checkpoint",
    "load_checkpoint",
]


def save_latex_format(x, y, name, directory: str = "data_files"):
    """Write ``<directory>/<name>.dat`` in pgfplots format (x y pairs)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.dat")
    with open(path, "w") as fh:
        fh.write("x    y\n")
        for xi, yi in zip(np.asarray(x).ravel(), np.asarray(y).ravel()):
            fh.write(f"{xi} {yi}\n")
    return path


def import_from_latex_format(name, directory: str = "data_files"):
    """Read a pgfplots ``.dat`` file back into ``(x, y)`` float arrays."""
    path = os.path.join(directory, f"{name}.dat")
    xs, ys = [], []
    with open(path) as fh:
        for line in fh:
            cols = line.split()
            if len(cols) < 2:
                continue
            try:
                xi, yi = float(cols[0]), float(cols[1])
            except ValueError:
                if cols[0] == "x":  # header
                    continue
                raise ValueError(f"Could not parse line to float: {line!r}")
            xs.append(xi)
            ys.append(yi)
    return np.asarray(xs), np.asarray(ys)


def save_checkpoint(path, **arrays):
    np.savez(path, **arrays)


def load_checkpoint(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
