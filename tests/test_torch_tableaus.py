"""The port's Butcher tableaus equal the reference's, entry for entry.

Mirrors ``tests/test_tableaus.py``: registry, aliases, groups, errors,
and the empirical convergence order of every tableau through the port's
``fixed_grid_solve`` (halving h divides the error of an order-p method by
about 2^p; the reference test's step counts and slack).
"""

import numpy as np
import pytest
import torch

from repro.core import tableaus as jt
from repro_torch.core import fixed_grid_solve
from repro_torch.core import tableaus as tt


@pytest.mark.parametrize("name", sorted(jt._REGISTRY))
def test_registry_entry_equals_reference(name):
    ref, port = jt.get_tableau(name), tt.get_tableau(name)
    # exact: both sides are the same Python float expressions
    assert port.name == ref.name
    assert port.a == ref.a
    assert port.b == ref.b
    assert port.c == ref.c
    assert port.b_err == ref.b_err
    assert port.b_mid == ref.b_mid
    assert port.order == ref.order
    assert port.fsal == ref.fsal
    assert port.adaptive == ref.adaptive
    assert port.stages == ref.stages
    port.validate()


def test_registry_keys_and_groups_equal_reference():
    assert set(tt._REGISTRY) == set(jt._REGISTRY)
    assert tt.FIXED_SOLVERS == jt.FIXED_SOLVERS
    assert tt.ADAPTIVE_SOLVERS == jt.ADAPTIVE_SOLVERS


def test_registry_aliases():
    assert tt.get_tableau("rk45") is tt.get_tableau("dopri5")
    assert tt.get_tableau("rk23") is tt.get_tableau("bosh3")
    assert tt.get_tableau("bogacki_shampine") is tt.get_tableau("bosh3")
    assert tt.get_tableau("heuneuler") is tt.get_tableau("heun_euler")
    assert tt.get_tableau("Heun-Euler") is tt.get_tableau("heun_euler")


def test_unknown_solver_error_enumerates_accepted_names():
    with pytest.raises(KeyError) as ei:
        tt.get_tableau("does_not_exist")
    for name in tt.FIXED_SOLVERS + tt.ADAPTIVE_SOLVERS:
        assert name in str(ei.value)


def test_validate_rejects_inconsistent_tableau():
    bad = tt.Tableau(name="bad", a=((), (0.7,)), b=(0.5, 0.5),
                     c=(0.0, 1.0), order=2)
    with pytest.raises(ValueError, match="row sums"):
        bad.validate()


def _solve_err(tab, steps):
    """Error of z' = z·cos(t), z(0)=1 (exact: exp(sin t)) at T=2, f32."""
    ys, _ = fixed_grid_solve(tab, lambda t, z: z * torch.cos(t),
                             torch.tensor(1.0), torch.tensor([0.0, 2.0]),
                             (), steps)
    return abs(float(ys[-1]) - float(np.exp(np.sin(2.0))))


@pytest.mark.parametrize("name,order", [
    ("euler", 1), ("midpoint", 2), ("rk2", 2), ("rk4", 4),
    ("heun_euler", 2), ("bosh3", 3), ("dopri5", 5),
])
def test_convergence_order(name, order):
    tab = tt.get_tableau(name)
    # step counts where the error is well above f32 noise
    n0 = {1: 64, 2: 16, 3: 8, 4: 4, 5: 2}[order]
    e1 = _solve_err(tab, n0)
    e2 = _solve_err(tab, 2 * n0)
    rate = np.log2(max(e1, 1e-12) / max(e2, 1e-12))
    assert rate > order - 0.7, (name, rate, order, e1, e2)


@pytest.mark.parametrize("name", tt.FIXED_SOLVERS)
def test_fixed_grid_equals_reference(name):
    """The port's fixed grid against the reference's on the same problem:
    the same steps at f32 rounding."""
    from repro.core import fixed_grid_solve as jfixed
    import jax.numpy as jnp
    ys_r, st_r = jfixed(jt.get_tableau(name), lambda t, z: z * jnp.cos(t),
                        jnp.float32(1.0), jnp.array([0.0, 1.0, 2.0]), (), 8)
    ys, st = fixed_grid_solve(tt.get_tableau(name),
                              lambda t, z: z * torch.cos(t),
                              torch.tensor(1.0),
                              torch.tensor([0.0, 1.0, 2.0]), (), 8)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_r), rtol=2e-6)
    for field in ("n_steps", "n_trials", "nfe", "status"):
        assert int(getattr(st, field)) == int(getattr(st_r, field)), field
