"""Trace Table 5's mass fit step by step on the card and on CPU tensors.

    PYTHONPATH=src python3 tests/torch_mass_fit_trace.py [--method aca]
        [--steps 60] [--n-pts 64] [--devices cuda,cpu]

For each device: the ground truth (``threebody.ground_truth``), then
``--steps`` AdamW steps of ``threebody``'s mass fit from log m = 0 with
``--method``, printing per step the loss, the masses, the gradient, the
forward solve's accepted steps and status; then the fitted masses' MSE
over [0, 2] yr, and max |ground truth(card) - ground truth(cpu)|. One
JSON line per step and per device. ``--truth-device cpu`` gives every
trace the CPU's ground truth, so the devices fit the same data.
``--gradients`` prints instead, at log m = 0, each method's gradient of
the loss beside the loss's central difference; ``--reference`` (CPU,
needs JAX) the reference's gradients beside the port's on the
reference's ground truth, and the gap between their trajectories.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.benchmarks import threebody as tb  # noqa: E402
from repro_torch.core import odeint  # noqa: E402
from repro_torch.optim import adamw, apply_updates, constant  # noqa: E402


def trace(dev, method, steps, n_pts, truth_device=None):
    ts, rs, vs, _ = tb.ground_truth(n_pts, truth_device or dev)
    ts, rs, vs = ts.to(dev), rs.to(dev), vs.to(dev)
    state0 = {"r": rs[0], "v": vs[0]}
    lm = torch.zeros(3, device=dev, requires_grad=True)
    opt = adamw(constant(0.05))
    st = opt.init(lm)
    for i in range(steps):
        ys, s = odeint(tb.mass_rhs, state0, ts[:n_pts], (lm,),
                       solver="dopri5", grad_method=method, rtol=1e-5,
                       atol=1e-5, max_steps=512)
        loss = ((ys["r"] - rs[:n_pts]) ** 2).mean()
        g, = torch.autograd.grad(loss, [lm])
        print(json.dumps({
            "device": str(dev), "step": i, "loss": float(loss.detach()),
            "masses": lm.detach().exp().tolist(), "grad": g.tolist(),
            "n_steps": int(s.n_steps), "n_trials": int(s.n_trials),
            "status": int(s.status)}), flush=True)
        up, st = opt.update(g, st, lm)
        lm = apply_updates(lm, up)
    with torch.no_grad():
        ys = tb.traj(tb.mass_rhs, state0, ts, (lm,), "aca")
        mse = float(((ys["r"] - rs) ** 2).mean())
    print(json.dumps({"device": str(dev), "mse": mse,
                      "masses": lm.detach().exp().tolist()}), flush=True)
    return rs.cpu()


def gradients(dev, n_pts, eps=1e-2):
    """At log m = 0: each method's gradient of the fit's loss beside the
    central difference of the loss (the Dopri5 1e-5 solve, step eps in
    log m)."""
    ts, rs, vs, _ = tb.ground_truth(n_pts, dev)
    state0 = {"r": rs[0], "v": vs[0]}

    def loss_of(lm, method):
        ys, _ = odeint(tb.mass_rhs, state0, ts[:n_pts], (lm,),
                       solver="dopri5", grad_method=method, rtol=1e-5,
                       atol=1e-5, max_steps=512)
        return ((ys["r"] - rs[:n_pts]) ** 2).mean()

    out = {}
    for method in ("aca", "adjoint", "naive"):
        lm = torch.zeros(3, device=dev, requires_grad=True)
        g, = torch.autograd.grad(loss_of(lm, method), [lm])
        out[method] = g.tolist()
    with torch.no_grad():
        out["central_difference"] = [
            (float(loss_of(e, "aca")) - float(loss_of(-e, "aca"))) / (2 * eps)
            for e in eps * torch.eye(3, device=dev)]
    print(json.dumps({"device": str(dev), "log_m": 0.0, **out}), flush=True)


def against_reference(n_pts):
    """On the CPU, at log m = 0 on the reference's ground truth: the
    reference's and the port's gradients per method and the largest gap
    between their fitted-interval trajectories (needs JAX)."""
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmarks import bench_threebody as jtb
    from repro.data.threebody import simulate_three_body, three_body_rhs

    ts, rs, vs, _ = simulate_three_body(n_points=2 * n_pts, t_max=2.0,
                                        masses=(1.0, 0.8, 1.2), rtol=1e-8,
                                        atol=1e-8)
    j_state = {"r": rs[0], "v": vs[0]}
    tts, trs, tvs = (torch.tensor(np.asarray(x)) for x in (ts, rs, vs))
    t_state = {"r": trs[0], "v": tvs[0]}
    out = {"n_pts": n_pts}
    for method in ("aca", "adjoint", "naive"):
        def loss_j(lm):
            ys = jtb._traj(lm, j_state, ts[:n_pts], three_body_rhs, method,
                           lambda m: (jnp.exp(m),))
            return ((ys["r"] - rs[:n_pts]) ** 2).mean(), ys["r"]

        import jax
        (_, yj), gj = jax.value_and_grad(loss_j, has_aux=True)(jnp.zeros(3))
        lm = torch.zeros(3, requires_grad=True)
        yt = tb.traj(tb.mass_rhs, t_state, tts[:n_pts], (lm,), method)["r"]
        gt, = torch.autograd.grad(((yt - trs[:n_pts]) ** 2).mean(), [lm])
        out[method] = {"reference": np.asarray(gj).tolist(),
                       "port": gt.tolist(),
                       "trajectory_gap": float(np.abs(
                           yt.detach().numpy() - np.asarray(yj)).max())}
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="aca")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--n-pts", type=int, default=64)
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--truth-device", default=None,
                    help="make the ground truth on this device for every "
                    "trace (default: each trace's own)")
    ap.add_argument("--gradients", action="store_true",
                    help="only compare the three methods' gradients with "
                    "the loss's central difference at log m = 0")
    ap.add_argument("--reference", action="store_true",
                    help="on the CPU: the reference's gradients and "
                    "trajectories beside the port's at log m = 0 (JAX)")
    args = ap.parse_args(argv)
    if args.reference:
        against_reference(args.n_pts)
        return 0
    if args.gradients:
        for d in args.devices.split(","):
            gradients(torch.device(d), args.n_pts)
        return 0
    truths = [trace(torch.device(d), args.method, args.steps, args.n_pts,
                    args.truth_device)
              for d in args.devices.split(",")]
    if len(truths) == 2:
        print(json.dumps({"truth_max_abs_diff": float(
            (truths[0] - truths[1]).abs().max())}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
