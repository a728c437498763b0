"""``repro_torch.examples.quickstart`` on the CPU against the reference's
``examples/quickstart.py``: the dz/dt = kz solve, dL/dz0 of each gradient
method against the analytic value, and the NODE block.

The reference's gradient of each method is computed here, with the
reference's ``odeint`` called as its quickstart calls it. Each method's
relative error against the analytic gradient is at most 2x the
reference's relative error on the same problem (on the CPU: aca 5.21e-4,
adjoint 4.37e-3, naive 8.93e-5, mali 7.87e-4). Where the port's accepted
step count equals the reference's, the gradient is also within 1e-4
relative of the reference's. MALI's controller takes other steps (2,976
against the reference's 3,102 at rtol 1e-5): its gradient is held within
2x the reference's own analytic error of the reference's gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.examples import quickstart

def _reference(method):
    from repro.core import odeint

    def f(t, z, k):
        return k * z

    def loss(z0):
        ys, st = odeint(f, z0, jnp.array([0.0, quickstart.T]),
                        (jnp.float32(quickstart.K),),
                        solver=None if method == "mali" else "dopri5",
                        grad_method=method,
                        max_steps=4096 if method == "mali" else 256,
                        rtol=1e-5, atol=1e-5)
        return (ys[-1] ** 2).sum(), st

    (_, st), g = jax.value_and_grad(loss, has_aux=True)(
        jnp.float32(quickstart.Z0))
    return float(g), int(st.n_steps)


@pytest.fixture(scope="module")
def port():
    return quickstart.run("cpu")


def test_solve_matches_the_closed_form(port):
    np.testing.assert_allclose(port["ys"], port["exact"], rtol=1e-4)
    assert port["n_steps"] > 0 and port["nfe"] > port["n_steps"]


@pytest.mark.parametrize("method", quickstart.METHODS)
def test_gradient_against_analytic_and_reference(port, method):
    got = port["grads"][method]
    g_ref, n_ref = _reference(method)
    analytic = port["analytic"]
    ref_err = abs(g_ref - analytic)
    assert got["rel_err"] <= 2 * ref_err / abs(analytic), (got, g_ref)
    if got["n_steps"] == n_ref:
        assert abs(got["grad"] - g_ref) <= 1e-4 * abs(g_ref), (got, g_ref)
    else:
        assert method == "mali", (method, got["n_steps"], n_ref)
        assert abs(got["grad"] - g_ref) <= 2 * ref_err, (got, g_ref)


def test_node_block(port):
    nb = port["node_block"]
    assert nb["in"] == nb["out"] == (4, 8)
    assert nb["params"] == 512 and nb["finite"]


def test_cli_prints_every_method(port, capsys, monkeypatch):
    monkeypatch.setattr(quickstart, "run", lambda device: port)
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for method in quickstart.METHODS:
        assert f"{method:8s} dL/dz0" in out
    assert "NODE block: in (4, 8) -> out (4, 8)" in out
