"""The reference's numbers that ``chip_smoke.py``'s ``paper_benchmarks``
phase holds the port's paper benchmarks to (its ``PAPER_ROW_NAMES`` and
``PAPER_REFERENCE`` tables).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_bench_reference.py

Prints, as Python dicts:

* ``PAPER_ROW_NAMES`` — the row names each reference benchmark
  (``benchmarks/bench_*.py``) emits in quick mode, from a quick run of
  each (the phase runs the port's in quick mode, with cut step counts);
* ``PAPER_REFERENCE`` — the deterministic rows on identical inputs: the
  van der Pol reverse errors; the conv-ODE reverse errors on the port's
  own generator-drawn kernel and image (OIHW/NCHW carried to HWIO/NHWC);
  ``method_costs``' accepted steps, trials and evaluations per variant on
  the port's weights; and ``table5_ode_mse/*``, the mass fit from
  ``log_m = 0`` at the phase's sizes (``chip_smoke.PAPER_CUTS``), with the
  MSE of the unfitted masses.

Needs JAX; runs on the CPU in a few minutes.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from benchmarks import (bench_classification, bench_method_costs,  # noqa: E402,E501
                        bench_reliability, bench_reverse_error,
                        bench_solver_robustness, bench_threebody,
                        bench_timeseries, common)
from repro.core import odeint  # noqa: E402
from repro.data.threebody import (simulate_three_body,  # noqa: E402
                                  three_body_rhs)
from repro.optim import adamw, constant  # noqa: E402
from repro.optim.adamw import apply_updates  # noqa: E402
from repro_torch.benchmarks import method_costs, reverse_error  # noqa: E402
from repro_torch.benchmarks.common import settings  # noqa: E402

MODULES = {
    "reverse_error": bench_reverse_error,
    "method_costs": bench_method_costs,
    "classification": bench_classification,
    "reliability": bench_reliability,
    "solver_robustness": bench_solver_robustness,
    "timeseries": bench_timeseries,
    "threebody": bench_threebody,
}


def row_names():
    names = {}
    for bench, mod in MODULES.items():
        common.ROWS.clear()
        mod.run(quick=True)
        names[bench] = sorted(r.split(",")[0] for r in common.ROWS
                              if not r.startswith("{"))
    return names


def reverse_rows():
    s = settings(reverse_error.SETTINGS, True,
                 chip_smoke.PAPER_CUTS["reverse_error"])
    out = {}
    for mu in s["mus"]:
        def vdp(t, z, mu):
            return jnp.stack([z[1], mu * (1 - z[0] ** 2) * z[1] - z[0]])

        out[f"fig4_vdp_reverse_relerr/mu={mu}"] = \
            bench_reverse_error.reverse_roundtrip_error(
                vdp, jnp.array([2.0, 0.0]), 5.0, (jnp.float32(mu),))
    kern, img = reverse_error.conv_inputs("cpu")
    kern = jnp.asarray(kern.numpy().transpose(2, 3, 1, 0))   # OIHW -> HWIO
    img = jnp.asarray(img.numpy().transpose(0, 2, 3, 1))     # NCHW -> NHWC

    def conv_ode(t, z, k):
        return jax.lax.conv_general_dilated(
            z, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    for t_end in s["t_ends"]:
        out[f"fig5_conv_reverse_relerr/T={t_end}"] = \
            bench_reverse_error.reverse_roundtrip_error(
                conv_ode, img, t_end, (kern,))
    return out


def method_cost_rows():
    s = settings(method_costs.SETTINGS, True,
                 chip_smoke.PAPER_CUTS["method_costs"])
    w1, w2, z0 = (jnp.asarray(x.numpy()) for x in method_costs.init("cpu"))
    out = {}
    for label, use_pallas in method_costs.VARIANTS:
        _, st = odeint(bench_method_costs._f, z0, jnp.array([0.0, 1.0]),
                       (w1, w2), solver="dopri5",
                       grad_method=label.split("_")[0], rtol=1e-5,
                       atol=1e-5, max_steps=s["max_steps"], max_trials=8,
                       use_pallas=use_pallas)
        out[label] = {"n_steps": int(st.n_steps),
                      "n_trials": int(st.n_trials), "nfe": int(st.nfe)}
    return out


def mass_fit_rows():
    cuts = chip_smoke.PAPER_CUTS["threebody"]
    n_half, fit_steps = cuts["n_pts"], cuts["fit_steps"]
    ts_all, rs, vs, _ = simulate_three_body(
        n_points=2 * n_half, t_max=2.0, masses=(1.0, 0.8, 1.2), rtol=1e-8,
        atol=1e-8)
    state0 = {"r": rs[0], "v": vs[0]}
    masses = lambda lm: (jnp.exp(lm),)  # noqa: E731
    ys = bench_threebody._traj(jnp.zeros(3), state0, ts_all, three_body_rhs,
                               "aca", masses)
    out = {"table5_ode_mse/unfitted": float(((ys["r"] - rs) ** 2).mean())}
    for gm in ("aca", "adjoint", "naive"):
        log_m = jnp.zeros(3)
        opt = adamw(constant(0.05))
        st = opt.init(log_m)

        @jax.jit
        def step(log_m, st, gm=gm):
            def loss(log_m):
                ys = bench_threebody._traj(log_m, state0, ts_all[:n_half],
                                           three_body_rhs, gm, masses)
                return ((ys["r"] - rs[:n_half]) ** 2).mean()

            l, g = jax.value_and_grad(loss)(log_m)
            up, st2 = opt.update(g, st, log_m)
            return apply_updates(log_m, up), st2, l

        for _ in range(fit_steps):
            log_m, st, _ = step(log_m, st)
        ys = bench_threebody._traj(log_m, state0, ts_all, three_body_rhs,
                                   "aca", masses)
        out[f"table5_ode_mse/{gm}"] = float(((ys["r"] - rs) ** 2).mean())
        out[f"masses/{gm}"] = [float(m) for m in np.exp(np.asarray(log_m))]
    return out


def main() -> None:
    ref = {"reverse_error": reverse_rows(),
           "method_costs": method_cost_rows(),
           "threebody": mass_fit_rows()}
    print("PAPER_REFERENCE = {")
    for bench, rows in ref.items():
        print(f"    {bench!r}: {{")
        for k, v in rows.items():
            v = f"{v:.6e}" if isinstance(v, float) else repr(v)
            print(f"        {k!r}: {v},")
        print("    },")
    print("}", flush=True)
    names = row_names()
    print("PAPER_ROW_NAMES = {")
    for bench, rows in names.items():
        print(f"    {bench!r}: (")
        for r in rows:
            print(f"        {r!r},")
        print("    ),")
    print("}")


if __name__ == "__main__":
    main()
