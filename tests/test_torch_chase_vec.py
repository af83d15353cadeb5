"""Port vs JAX package: the lane-broadcast chase (``MIOC_CHASE=vec``).

The JAX package's ``_bt_kernel_vec`` runs in interpret mode on tables built
by the Pallas build; the port's :func:`~mioc_tpu_torch.ops.bellman.backtrack`
under ``MIOC_CHASE=vec`` takes the plain chase on the CPU (the plain version
of both single chases) on the same tables, carried across with
``interop.tables_from_pallas``.  The indices must be equal.  The CUDA kernel
``chase_vec`` is held against the plain chase on the card
(``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import mioc_tpu.ops.backtrack_pallas as bp  # noqa: E402
from mioc_tpu.ops.bellman import max_budget_use, stage_tables  # noqa: E402
from mioc_tpu.ops.bellman_pallas import build_tables_pallas  # noqa: E402
from mioc_tpu.ops.levels import jump_cost_table, product_levels  # noqa: E402
from mioc_tpu_torch import interop  # noqa: E402
from mioc_tpu_torch.ops import bellman as tb  # noqa: E402


def test_vec_chase_matches_jax_vec_kernel(monkeypatch):
    """tests/test_bellman.py's vec-chase case (levels −2…2, nt=200, B=17,
    caps B, 7, 0): the JAX vec kernel and the port's vec route agree."""
    monkeypatch.setattr(bp, "_CHASE_VEC", True)
    monkeypatch.setenv("MIOC_CHASE", "vec")
    rng = np.random.default_rng(3)
    s = product_levels([[-2, -1, 0, 1, 2]])
    nt, B, tau = 200, 17, 0.1
    levels = jnp.asarray(s.levels)
    jump = jnp.asarray(jump_cost_table(s.levels, p=1, beta=1e-3))
    smax = max_budget_use(s.levels)
    grad = jnp.asarray(rng.normal(size=(nt, 1)))
    u_old = jnp.asarray(s.levels[rng.integers(0, s.L, size=nt)])
    stage, btilde = stage_tables(grad, u_old, levels, tau)
    U_p, phi_p = build_tables_pallas(stage, btilde, jump, B, smax, interpret=True)
    U_t, phi_t = interop.tables_from_pallas(U_p, phi_p, nt=nt, L=s.L, B=B, device="cpu")
    bt_t = torch.as_tensor(np.asarray(btilde))
    for Bn in (B, 7, 0):
        _, i_v = bp._backtrack_impl(U_p, phi_p, btilde, levels, jnp.int32(Bn),
                                    interpret=True)
        u_t, i_t = tb.backtrack(U_t, phi_t, bt_t, s.levels, Bn)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_v))
        np.testing.assert_array_equal(u_t.numpy(), s.levels[np.asarray(i_v)])


@pytest.mark.parametrize("value,kernel", [(None, "chase"), ("scalar", "chase"),
                                          ("vec", "chase_vec")])
def test_mioc_chase_selects_the_kernel(monkeypatch, value, kernel):
    if value is None:
        monkeypatch.delenv("MIOC_CHASE", raising=False)
    else:
        monkeypatch.setenv("MIOC_CHASE", value)
    assert tb.chase_kernel_name() == kernel


@pytest.mark.parametrize("value", ["vector", "VEC", ""])
def test_mioc_chase_unknown_value_raises(monkeypatch, value):
    """A typo must not run the other kernel: it raises, on the CPU route too."""
    monkeypatch.setenv("MIOC_CHASE", value)
    with pytest.raises(ValueError, match="MIOC_CHASE"):
        tb.chase_kernel_name()
    s = product_levels([[-1, 0, 1]])
    U = torch.zeros((3, s.L, 3), dtype=torch.int8)
    phi0 = torch.zeros((s.L, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="MIOC_CHASE"):
        tb.backtrack(U, phi0, torch.zeros((4, s.L), dtype=torch.int32), s.levels, 2)


def test_mioc_chase_is_read_at_every_call(monkeypatch):
    """The variant follows the environment within one process."""
    monkeypatch.setenv("MIOC_CHASE", "vec")
    assert tb.chase_kernel_name() == "chase_vec"
    monkeypatch.setenv("MIOC_CHASE", "scalar")
    assert tb.chase_kernel_name() == "chase"
