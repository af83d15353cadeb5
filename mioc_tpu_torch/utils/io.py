"""Solver checkpoints: the TRM outer-loop state ``(u, Δ, iter, J, TV)`` as an
``.npz``, making solves restartable (the checkpoint half of
``mioc_tpu.utils.io``; the reference has none)."""

from __future__ import annotations

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path, **arrays):
    np.savez(path, **arrays)


def load_checkpoint(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}
