"""Port vs JAX package: admissible sets, jump costs, random starts, Julia RNG.

The port keeps numpy copies of ``mioc_tpu.ops.levels``, ``utils/init.py`` and
``utils/julia_rng.py``; these hold the copies to the originals array for
array and re-check the published Julia golden draws against the copy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mioc_tpu.models import LVMObj as JaxLVM  # noqa: E402
from mioc_tpu.ops import levels as jlev  # noqa: E402
from mioc_tpu.utils import init as jinit  # noqa: E402
from mioc_tpu_torch.models import LVMObj  # noqa: E402
from mioc_tpu_torch.ops import levels as tlev  # noqa: E402
from mioc_tpu_torch.utils import init as tinit  # noqa: E402
from mioc_tpu_torch.utils.julia_rng import JuliaMersenneTwister  # noqa: E402

# The admissible sets of the bundled problems (fishing/vanderpol/doubletank
# SOS1, convolution, heat) plus a bounded-sum multilevel set.
SETS = [
    ("bounded", ([[0, 1]] * 3, 1, 1)),
    ("bounded", ([[0, 1]] * 2, 1, 1)),
    ("product", ([[-2, -1, 0, 1, 2]],)),
    ("product", ([list(range(6))] * 2,)),
    ("bounded", ([[0, 1, 2]] * 3, 1, 4)),
]


def _both(kind, args):
    fn = "bounded_sum_levels" if kind == "bounded" else "product_levels"
    return getattr(jlev, fn)(*args), getattr(tlev, fn)(*args)


@pytest.mark.parametrize("kind,args", SETS)
def test_admissible_sets_equal(kind, args):
    j, t = _both(kind, args)
    assert t.V == j.V
    np.testing.assert_array_equal(t.indices, j.indices)
    np.testing.assert_array_equal(t.levels, j.levels)
    assert t.indices.dtype == j.indices.dtype and t.levels.dtype == j.levels.dtype
    assert (t.L, t.M, len(t)) == (j.L, j.M, len(j))


@pytest.mark.parametrize("compat_pinf", [False, True])
@pytest.mark.parametrize("p", [1, 2, np.inf])
@pytest.mark.parametrize("kind,args", SETS[:4])
def test_jump_cost_table_equal(kind, args, p, compat_pinf):
    j, t = _both(kind, args)
    a = jlev.jump_cost_table(j.levels, p, beta=0.37, compat_pinf=compat_pinf)
    b = tlev.jump_cost_table(t.levels, p, beta=0.37, compat_pinf=compat_pinf)
    np.testing.assert_array_equal(a, b)


def test_jump_cost_rejects_nonpositive_p():
    with pytest.raises(ValueError):
        tlev.jump_cost_table(tlev.product_levels([[0, 1]]).levels, 0)


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("nt", [100, 1024])
def test_rand_func_same_start(seed, nt):
    """Both packages draw the same fishing start from the same seed (numpy
    default_rng), so solves can start from one x0."""
    a = jinit.rand_func(JaxLVM(nt=nt), seed=seed)
    b = tinit.rand_func(LVMObj(nt=nt, device="cpu"), seed=seed)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [5, 1234])
def test_rand_func_julia_stream_same_start(seed):
    a = jinit.rand_func(JaxLVM(nt=200), seed=seed, julia_stream=True)
    b = tinit.rand_func(LVMObj(nt=200, device="cpu"), seed=seed, julia_stream=True)
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        tinit.rand_func(LVMObj(nt=20, device="cpu"), julia_stream=True)


@pytest.mark.parametrize(
    "seed,golden",
    [
        (0, [0.8236475079774124, 0.9103565379264364, 0.16456579813368521]),
        (1234, [0.5908446386657102, 0.7667970365022592, 0.5662374165061859]),
        (42, [0.5331830160438613]),
    ],
)
def test_julia_golden_draws(seed, golden):
    """Published first draws of Julia's seeded MersenneTwister, to the bit
    (the same constants as tests/test_julia_rng.py)."""
    r = JuliaMersenneTwister(seed)
    assert [r.rand() for _ in golden] == golden


def test_julia_stream_arrays_equal():
    from mioc_tpu.utils.julia_rng import JuliaMersenneTwister as JaxMT

    for n in (382, 1024):
        np.testing.assert_array_equal(JuliaMersenneTwister(3).rand_array(n),
                                      JaxMT(3).rand_array(n))
        np.testing.assert_array_equal(JuliaMersenneTwister(9).randn_array(n),
                                      JaxMT(9).randn_array(n))
