"""Starting controls, the Julia RNG replica, logging, checks, ``.dat`` IO,
checkpoints, and the program's spans (:mod:`.trace`, imported as a module)."""

from .checks import assert_admissible, check_budget, enable_nan_checks
from .init import rand_func, rand_func_cont, rand_func_int
from .io import import_from_latex_format, load_checkpoint, save_checkpoint, save_latex_format
from .julia_rng import JuliaMersenneTwister
from .logging import IterationLog

__all__ = [
    "IterationLog",
    "JuliaMersenneTwister",
    "assert_admissible",
    "check_budget",
    "enable_nan_checks",
    "import_from_latex_format",
    "load_checkpoint",
    "rand_func",
    "rand_func_cont",
    "rand_func_int",
    "save_checkpoint",
    "save_latex_format",
]
