"""The host side of the fishing sweep kernels (``mioc_tpu_torch/ops/ode_cuda.py``).

The kernels themselves run only on the card (``tests/test_torch_cuda.py``
holds them bit-equal to the plain sweeps there).  Here, on the CPU: the
window plan the wrapper hands the forward kernel reproduces
:func:`~mioc_tpu_torch.ops.xla_order.window_sum` when summed as the kernel
sums; the adjoint's rule table is ``adjoint_rules()`` letter for
letter, built on first use; the wrappers refuse what the kernels do not
take; and on the CPU the sweeps never reach the wrappers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mioc_tpu_torch.models import LVMObj  # noqa: E402
from mioc_tpu_torch.ops import ode_cuda  # noqa: E402
from mioc_tpu_torch.ops.xla_order import window_sum  # noqa: E402
from mioc_tpu_torch.utils.init import rand_func  # noqa: E402


def _stream_sum(values, offs):
    """``WindowSum`` in ``csrc/ode_lvm.cu``, value by value in Python
    floats: each level of windows starts ``offs[level]`` into its first
    window, pushes a full window's sum to the next level, and at the end its
    partial window; the last level sums in order."""
    levels = len(offs)
    acc = [0.0] * (levels + 1)
    pos = list(offs)

    def push(level, v):
        acc[level] += v
        if level < levels:
            pos[level] += 1
            if pos[level] == ode_cuda.WINDOW:
                w = acc[level]
                acc[level] = 0.0
                pos[level] = 0
                push(level + 1, w)

    for v in values:
        push(0, v)
    for level in range(levels):
        if pos[level]:
            push(level + 1, acc[level])
    return acc[levels]


def _kernel_sum(values, offs):
    """The forward kernel's trapezoid sum: level 0 window by window (the
    first starting ``offs[0]`` before term 0, or one window where the plan
    has no level), each from 0 in order; the window sums through
    :func:`_stream_sum` with the other levels' offsets."""
    off = offs[0] if offs else 0
    sums = []
    for n0 in range(-off, len(values), ode_cuda.WINDOW):
        acc = 0.0
        for v in values[max(n0, 0):n0 + ode_cuda.WINDOW]:
            acc += v
        sums.append(acc)
    return _stream_sum(sums, offs[1:]) if offs else sums[0]


NT_SPANS = [(lo, min(lo + 512, 4101)) for lo in range(1, 4101, 512)]


@pytest.mark.parametrize("lo,hi", NT_SPANS)
def test_window_plan_streams_window_sum(lo, hi):
    """For every nt from 1 to 4100, the nt + 1 trapezoid terms of a random
    row summed in the kernel's order under the plan equal ``window_sum``'s
    bits (values of mixed sign and magnitude, so another order rounds
    otherwise)."""
    rng = np.random.default_rng(lo)
    other_order = 0
    for nt in range(lo, hi):
        x = rng.standard_normal(nt + 1) * 10.0 ** rng.uniform(-6, 6, nt + 1)
        want = float(window_sum(torch.as_tensor(x)))
        got = _kernel_sum(x.tolist(), ode_cuda.window_plan(nt + 1))
        assert np.float64(got).view(np.int64) == np.float64(want).view(np.int64), nt
        other_order += float(sum(x.tolist())) != want
    if hi > 33:
        assert other_order > 0  # the order is what the test holds


def test_window_plan_levels():
    assert ode_cuda.window_plan(2) == ()
    assert ode_cuda.window_plan(32) == ()
    assert ode_cuda.window_plan(33) == (15,)
    assert ode_cuda.window_plan(1025) == (15, 15)  # nt = 1024
    assert ode_cuda.window_plan(1201) == (7, 13)  # nt = 1200
    assert len(ode_cuda.window_plan(32 ** 5)) == ode_cuda.MAX_LEVELS


NTS = (1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 57, 100,
       1024, 1025, 1200)


@pytest.mark.parametrize("unroll", [1, 2, 4, 8])
def test_rule_table_is_adjoint_rules_letter_for_letter(unroll):
    for nt in NTS:
        obj = LVMObj(nt=nt, device="cpu")
        obj.sweep_unroll = unroll
        obj._build()
        table = obj._rules_on_device(torch.device("cpu"))
        assert table.dtype == torch.uint8 and table.shape == (nt - 1,)
        assert table.untyped_storage().nbytes() == -(-(nt - 1) // 16) * 16
        assert bytes(table.tolist()).decode() == obj.adjoint_rules(), (nt, unroll)


def test_rule_table_follows_sweep_unroll():
    """The table is built on first use, not on construction, and a changed
    ``sweep_unroll`` (or ``nt``) without ``_build()`` rebuilds it, as the
    plain sweep reads the rules at every evaluation."""
    cpu = torch.device("cpu")
    obj = LVMObj(nt=57, device="cpu")
    assert obj._rule_table == (None, None)
    eight = bytes(obj._rules_on_device(cpu).tolist()).decode()
    assert obj._rules_on_device(cpu) is obj._rules_on_device(cpu)
    obj.sweep_unroll = 1
    one = bytes(obj._rules_on_device(cpu).tolist()).decode()
    assert one == obj.adjoint_rules() == "5" * 56 != eight


def test_rules_must_be_padded_for_the_kernel():
    """The adjoint kernel copies 16 letters at once: ``rule_table`` pads the
    storage, and a table without room past its end is refused."""
    table = ode_cuda.rule_table("45" * 10, "cpu")
    assert table.untyped_storage().nbytes() == 32
    ode_cuda._check_rules(table, 21, table.device)
    with pytest.raises(ValueError, match="expected uint8"):
        ode_cuda._check_rules(table, 20, table.device)
    bare = torch.tensor(list(b"4554455"), dtype=torch.uint8)
    with pytest.raises(ValueError, match="aligned"):
        ode_cuda._check_rules(bare, 8, bare.device)


def test_rule_table_refuses_other_letters():
    assert ode_cuda.rule_table("", "cpu").shape == (0,)
    with pytest.raises(ValueError, match="rule letters"):
        ode_cuda.rule_table("4456", "cpu")


def _refused(dtype, error, match):
    """Both wrappers on CPU tensors of ``dtype`` raise ``error`` and launch
    nothing."""
    A = torch.zeros(8, 2, 2, dtype=dtype)
    s0 = torch.zeros(2, dtype=dtype)
    v = torch.zeros(3, dtype=dtype)
    before = ode_cuda.lvm_forward.launches, ode_cuda.lvm_adjoint.launches
    with pytest.raises(error, match=match):
        ode_cuda.lvm_forward(A, s0, 1.0, 1.0, 1.0, 1.0, 0.1)
    with pytest.raises(error, match=match):
        ode_cuda.lvm_adjoint(A, A, ode_cuda.rule_table("4" * 7, "cpu"), s0, v, v,
                             1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.1)
    assert (ode_cuda.lvm_forward.launches, ode_cuda.lvm_adjoint.launches) == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wrappers_refuse_cpu_tensors(dtype):
    _refused(dtype, ValueError, "CUDA")


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_wrappers_refuse_other_dtypes(dtype):
    """The kernels have a float64 and a float32 instance only."""
    _refused(dtype, TypeError, "float64 or float32")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_sweeps_never_reach_the_kernels(monkeypatch, dtype):
    def refuse(*args, **kwargs):
        raise AssertionError("a sweep reached the CUDA wrapper")

    monkeypatch.setattr(ode_cuda, "lvm_forward", refuse)
    monkeypatch.setattr(ode_cuda, "lvm_adjoint", refuse)
    obj = LVMObj(nt=57, device="cpu", dtype=dtype)
    X = torch.as_tensor(np.stack([rand_func(obj, seed=s) for s in range(3)]),
                        dtype=obj.dtype)
    f, ys = obj._forward_batch(X)
    df, lam = obj._adjoint_batch(X, ys)
    f_t, ys_t = obj._forward_batch_torch(X)
    df_t, lam_t = obj._adjoint_batch_torch(X, ys_t)
    for a, b in zip((f, ys, df, lam), (f_t, ys_t, df_t, lam_t)):
        assert a.dtype == dtype and torch.equal(a, b)
    obj.x = X[0].clone()
    assert obj.eval_f_() == float(f_t[0])
    obj.eval_df_()
    assert torch.equal(obj.df, df_t[0])
    assert obj._rule_table == (None, None)  # only the kernel path builds the table
