"""Bundled problems (this slice: Lotka–Volterra fishing)."""

from .fishing import LVMObj

__all__ = ["LVMObj"]
