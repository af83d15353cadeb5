"""Bundled problems: Lotka–Volterra fishing (integer and mixed), double tank,
Van der Pol, Fuller, convolution and heat.  :mod:`.registry` names them, with their presets."""

from .convolution import ConvObj
from .doubletank import DTMObj
from .fishing import LVMObj
from .fuller import FullerObj
from .heat import HeatObj
from .mixed_fishing import LVMMixedObj
from .vanderpol import VPOObj

__all__ = ["ConvObj", "DTMObj", "FullerObj", "HeatObj", "LVMMixedObj", "LVMObj", "VPOObj"]
