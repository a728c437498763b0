"""Measure how far the port and the JAX reference drift apart on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_parity_report.py

Prints one JSON line per measurement; the tolerances of the
``test_torch_*.py`` parity tests and the divergence notes in ROADMAP.md
(queue 3) cite these numbers:

* ``one_step``: the embedded error of one Dopri5 step of dz/dt = -2z
  from the reference's eager ``rk_step``, its jitted ``rk_step`` and the
  port's ``rk_step``.
* ``grids``: per problem of ``test_torch_solve.PROBLEMS``, at its own
  tolerance and at 1e-6, both stepper paths: the counters of both sides
  and the largest relative difference of the accepted h grids.
* ``nan_wall``: the counters of a Dopri5 solve that freezes at a NaN
  wall at t = 0.5.
* ``grads``: max |difference| / max |gradient| of the port's ACA
  gradients against ``jax.grad`` of the reference.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_solve as ts  # noqa: E402
from repro.core import odeint as jodeint  # noqa: E402
from repro.core import stepper as jstep  # noqa: E402
from repro.core.tableaus import DOPRI5  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import odeint as todeint  # noqa: E402
from repro_torch.core import stepper as tstep  # noqa: E402
from repro_torch.core.tableaus import DOPRI5 as TDOPRI5  # noqa: E402


def emit(obj):
    print(json.dumps(obj), flush=True)


def one_step():
    f = lambda t, z, k: k * z  # noqa: E731
    args = (jnp.float32(-2.0),)
    t, z, h = jnp.float32(0.04), jnp.float32(1.4), jnp.float32(0.13)
    eager = jstep.rk_step(DOPRI5, f, t, z, h, args)
    jitted = jax.jit(lambda t, z, h: jstep.rk_step(DOPRI5, f, t, z, h,
                                                   args))(t, z, h)
    port = tstep.rk_step(TDOPRI5, f, torch.tensor(0.04), torch.tensor(1.4),
                         torch.tensor(0.13), (torch.tensor(-2.0),))
    emit({"measure": "one_step", "err_eager": float(eager.err),
          "err_jitted": float(jitted.err), "err_port": float(port.err),
          "z_next_equal_eager_port":
              bool(np.float32(eager.z_next) == port.z_next.numpy())})


def grids():
    for name in sorted(ts.PROBLEMS):
        fj, ft, z0, a, tgrid, solver, tol0 = ts.PROBLEMS[name]
        for tol in sorted({tol0, 1e-6}):
            ts.PROBLEMS[name] = (fj, ft, z0, a, tgrid, solver, tol)
            for up in (False, True):
                (_, ck_j, st_j), (_, ck_t, st_t) = ts._solve_both(name, up)
                n = min(int(st_j.n_steps), ck_t.n)
                hj, ht = np.asarray(ck_j.h[:n]), ck_t.h[:n].numpy()
                emit({"measure": "grids", "problem": name, "tol": tol,
                      "use_pallas": up,
                      "ref": [int(v) for v in st_j[:3]],
                      "port": [int(v) for v in st_t[:3]],
                      "h_max_rel": float(np.max(np.abs(ht - hj) / hj))})
        ts.PROBLEMS[name] = (fj, ft, z0, a, tgrid, solver, tol0)


def nan_wall():
    def f_t(t, z):
        return torch.where(t > 0.5, torch.full_like(z, float("nan")), -z)

    def f_j(t, z):
        return jnp.where(t > 0.5, jnp.full_like(z, jnp.nan), -z)

    for tol in (1e-2, 1e-3, 1e-6):
        _, st_t = todeint(f_t, torch.ones(3), [0.0, 0.25, 1.0],
                          solver="dopri5", rtol=tol, atol=tol)
        _, st_j = jodeint(f_j, jnp.ones(3), jnp.array([0.0, 0.25, 1.0]),
                          solver="dopri5", rtol=tol, atol=tol)
        emit({"measure": "nan_wall", "tol": tol,
              "ref": [int(v) for v in st_j[:3]],
              "port": [int(v) for v in st_t[:3]]})


def grads():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((6, 6)) * 0.5).astype(np.float32)
    z0 = rng.standard_normal(6).astype(np.float32)
    tgrid = np.asarray([0.0, 0.4, 1.0], np.float32)
    for solver, tol in (("heun_euler", 1e-3), ("bosh3", 1e-3),
                        ("dopri5", 1e-4)):
        for up in (False, True):
            kw = dict(solver=solver, rtol=tol, atol=tol, max_steps=64,
                      use_pallas=up)

            def loss_j(z0, w):
                ys, _ = jodeint(lambda t, z, w: jnp.tanh(w @ z) * jnp.cos(t),
                                z0, jnp.asarray(tgrid), (w,), **kw)
                return jnp.sum(ys ** 2)

            gz, gw = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(z0),
                                                      jnp.asarray(w))
            zt = torch.tensor(z0, requires_grad=True)
            wt = torch.tensor(w, requires_grad=True)
            ys, _ = todeint(lambda t, z, w: torch.tanh(w @ z) * torch.cos(t),
                            zt, torch.tensor(tgrid), (wt,), **kw)
            torch.sum(ys ** 2).backward()
            rel = [float(np.abs(p - np.asarray(r)).max()
                         / np.abs(np.asarray(r)).max())
                   for p, r in ((zt.grad.numpy(), gz), (wt.grad.numpy(), gw))]
            elem = [float(np.max(np.abs(p - np.asarray(r))
                                 / np.abs(np.asarray(r))))
                    for p, r in ((zt.grad.numpy(), gz), (wt.grad.numpy(), gw))]
            emit({"measure": "grads", "solver": solver, "tol": tol,
                  "use_pallas": up, "max_rel_to_scale": max(rel),
                  "max_rel_per_element": max(elem)})


if __name__ == "__main__":
    jops.set_interpret(True)
    one_step()
    grids()
    nan_wall()
    grads()
