"""Starting controls, the Julia RNG replica, logging, checks and checkpoints."""

from .checks import assert_admissible, check_budget
from .init import rand_func, rand_func_cont, rand_func_int
from .io import load_checkpoint, save_checkpoint
from .julia_rng import JuliaMersenneTwister
from .logging import IterationLog

__all__ = [
    "IterationLog",
    "JuliaMersenneTwister",
    "assert_admissible",
    "check_budget",
    "load_checkpoint",
    "rand_func",
    "rand_func_cont",
    "rand_func_int",
    "save_checkpoint",
]
