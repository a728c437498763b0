"""The port's Butcher tableaus equal the reference's, entry for entry.

Mirrors ``tests/test_tableaus.py`` (registry, aliases, groups, errors);
the convergence-order checks need fixed-grid solving, which is slice B.
"""

import pytest

from repro.core import tableaus as jt
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
