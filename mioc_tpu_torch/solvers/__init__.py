"""The host-driven trust-region method."""

from .trm import TRM, TRMParameters, TRMResult, trm_solve

__all__ = ["TRM", "TRMParameters", "TRMResult", "trm_solve"]
