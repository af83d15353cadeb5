"""Bundled problems: Lotka–Volterra fishing, double tank, Van der Pol,
Fuller and convolution.  :mod:`.registry` names them, with their presets."""

from .convolution import ConvObj
from .doubletank import DTMObj
from .fishing import LVMObj
from .fuller import FullerObj
from .vanderpol import VPOObj

__all__ = ["ConvObj", "DTMObj", "FullerObj", "LVMObj", "VPOObj"]
