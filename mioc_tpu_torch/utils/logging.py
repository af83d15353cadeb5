"""Iteration logging and structured metrics.

The reference prints a Printf table (``multi-trust.jl:86-90,136,143,155``);
we reproduce the same columns and add optional jsonl metrics (per-outer-
iteration counters and phase wall-clock) for observability.
"""

from __future__ import annotations

import json
from typing import Optional

__all__ = ["IterationLog"]


class IterationLog:
    def __init__(self, enabled: bool = False, metrics_path: Optional[str] = None):
        self.enabled = enabled
        self._fh = open(metrics_path, "a") if metrics_path else None

    def header(self):
        if self.enabled:
            print(" Iter |   k |   Dk   |      J      |   pred   |   ared   |       step")
            print("-" * 81)

    def row(self, iteration, k, delta, J, pred, ared, msg):
        if self.enabled:
            print(
                f"{iteration:5d} |{k:4d} | {delta:6.2f} | {J:.5e} | "
                f"{pred:8.4f} | {ared:8.4f} | {msg}"
            )

    def metrics(self, **kwargs):
        if self._fh is not None:
            self._fh.write(json.dumps(kwargs) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
