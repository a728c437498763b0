"""The solve-health property tests on the port, mirroring
``tests/test_solve_health_properties.py`` with a parametrised grid in
place of hypothesis (an optional dependency): a NaN injected at any time
inside the solve window is detected as ``SolveStatus.NONFINITE_STATE``
under every gradient method, the outputs stay finite, and the pre-fault
eval prefix is bitwise the unfaulted solve's (the guards do nothing until
the fault fires); batched, whichever row is poisoned at whatever time,
only that row's status flips and the others keep their bits. Each status
is also the reference's on the same inputs.

Grid: t_fault in {0.05, 0.3, 0.55, 0.8, 0.95} (the reference draws from
[0.26, 0.8]; the ends add a fault before the first eval time and one
after the last interior one) × the four methods, and × the poisoned row
b_fault in {0, 1, 2} for the batched case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faults import faulty_field as jfaulty
from repro.core import odeint as jodeint
from repro_torch.core import SolveStatus, odeint
from torch_faults import faulty_field

T_FAULTS = (0.05, 0.3, 0.55, 0.8, 0.95)
TS = np.linspace(0.0, 1.0, 5, dtype=np.float32)


def _decay(t, z):
    return -z


def _kw(method):
    kw = dict(rtol=1e-3, atol=1e-3, grad_method=method)
    if method != "mali":
        kw["solver"] = "dopri5"
    return kw


@pytest.mark.parametrize("method", ["aca", "adjoint", "naive", "mali"])
@pytest.mark.parametrize("t_fault", T_FAULTS)
def test_nan_at_any_time_detected(method, t_fault):
    z0 = torch.ones(4)
    kw = _kw(method)
    ts = torch.tensor(TS)
    ys_ok, _ = odeint(_decay, z0, ts, **kw)
    ys, st = odeint(faulty_field(_decay, "nan", t_ge=t_fault), z0, ts, **kw)
    assert int(st.status) == SolveStatus.NONFINITE_STATE
    assert bool(torch.isfinite(ys).all())
    n_pre = int((TS < t_fault).sum())
    assert torch.equal(ys[:n_pre], ys_ok[:n_pre])
    _, st_r = jodeint(jfaulty(lambda t, z: -z, "nan", t_ge=t_fault),
                      jnp.ones((4,)), jnp.asarray(TS), **kw)
    assert int(st.status) == int(st_r.status)


def _tag_field(t, z):
    return torch.stack([-z[0], 0.0 * z[1]])


@pytest.mark.parametrize("b_fault", [0, 1, 2])
@pytest.mark.parametrize("t_fault", T_FAULTS)
def test_batched_fault_isolation_any_element(t_fault, b_fault):
    """Whichever row is poisoned, at whatever time: only its status flips
    and the other rows stay bitwise the unfaulted batch's."""
    tag = float(b_fault)
    z0 = np.stack([np.array([1.0, float(b)], np.float32) for b in range(3)])
    fbad = faulty_field(_tag_field, "nan", t_ge=t_fault,
                        predicate=lambda t, z: torch.abs(z[1] - tag) < 0.5)
    kw = dict(rtol=1e-3, atol=1e-3, solver="dopri5", grad_method="aca",
              batch_axis=0)
    ts = torch.tensor(TS)
    ys_ok, _ = odeint(_tag_field, torch.tensor(z0), ts, **kw)
    ys, st = odeint(fbad, torch.tensor(z0), ts, **kw)
    for b in range(3):
        if b == b_fault:
            assert int(st.status[b]) == SolveStatus.NONFINITE_STATE
        else:
            assert int(st.status[b]) == SolveStatus.OK
            assert torch.equal(ys[:, b], ys_ok[:, b])
    assert bool(torch.isfinite(ys).all())
    _, st_r = jodeint(
        jfaulty(lambda t, z: jnp.stack([-z[0], 0.0 * z[1]]), "nan",
                t_ge=t_fault,
                predicate=lambda t, z: jnp.abs(z[1] - tag) < 0.5),
        jnp.asarray(z0), jnp.asarray(TS), **kw)
    assert st.status.tolist() == np.asarray(st_r.status).tolist()
