"""The port's counted memory orders the gradient methods as the
reference's measured model does (``tests/test_cost_crosscheck.py::
test_measured_model_orders_the_methods``): at dim 32, 64 steps and 8
segments, full-buffer ACA holds more than segmented ACA and more than
MALI.

The reference measures ``analyze_hlo``'s ``bytes_min`` of the compiled
value-and-grad; the port has no compiled program, so it measures the
peak bytes held (``OpCost.peak_bytes``: the storages an eager
value-and-grad makes, each freed when its last tensor dies), bytes held
rather than bytes moved. The reference's static residual model, the
other side of its two other tests, is not ported (the static analysis
is a later slice)."""

import pytest
import torch

from repro_torch.core import odeint
from repro_torch.launch.op_cost import OpCost

DIM, N_STEPS, K, N_EVAL = 32, 64, 8, 2

CONFIGS = {
    "aca-full": dict(grad_method="aca", max_steps=N_STEPS),
    "aca-seg": dict(grad_method="aca", max_steps=N_STEPS,
                    checkpoint_segments=K),
    "mali": dict(grad_method="mali", max_steps=N_STEPS),
}


def _held_bytes(kw) -> int:
    z0 = torch.ones(DIM, requires_grad=True)
    w = torch.ones(DIM, requires_grad=True)
    with OpCost() as c:
        ys, _ = odeint(lambda t, z, w: -(w * z), z0,
                       torch.linspace(0.0, 1.0, N_EVAL), (w,), **kw)
        torch.autograd.grad(torch.sum(ys), (z0, w))
    return c.peak_bytes


@pytest.fixture(scope="module")
def held():
    return {k: _held_bytes(kw) for k, kw in CONFIGS.items()}


def test_measured_model_orders_the_methods(held):
    assert held["aca-full"] > held["aca-seg"], held
    assert held["aca-full"] > held["mali"], held
