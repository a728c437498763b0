"""Three-body problem with physical knowledge (paper Sec. 4.4), on the port.

Fits the three unknown planet masses by back-propagating through the ODE
solver with ACA: the dynamics f ARE Newton's equations (Eq. 32); only 3
scalars are learned. Port of ``examples/three_body.py``.

    PYTHONPATH=src python -m repro_torch.examples.three_body [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import odeint
from repro_torch.data.threebody import simulate_three_body, three_body_rhs
from repro_torch.optim import adamw, apply_updates, constant

TRUE_MASSES = (1.0, 0.8, 1.2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args(argv)

    print("simulating ground truth (dopri5 @ rtol 1e-8)...")
    ts, rs, vs, m_true = simulate_three_body(
        n_points=128, t_max=2.0, masses=TRUE_MASSES, rtol=1e-8, atol=1e-8,
        device=args.device)
    n_train = 64                        # train on [0, 1] yr
    state0 = {"r": rs[0], "v": vs[0]}

    def rhs(t, state, log_m):
        return three_body_rhs(t, state, torch.exp(log_m))

    log_m = torch.zeros(3, device=rs.device, requires_grad=True)
    opt = adamw(constant(0.05))
    opt_state = opt.init(log_m)
    for i in range(args.steps):
        ys, _ = odeint(rhs, state0, ts[:n_train], (log_m,), solver="dopri5",
                       grad_method="aca", rtol=1e-5, atol=1e-5,
                       max_steps=512)
        loss = ((ys["r"] - rs[:n_train]) ** 2).mean()
        g, = torch.autograd.grad(loss, [log_m])
        updates, opt_state = opt.update(g, opt_state, log_m)
        log_m = apply_updates(log_m, updates)
        if i % 20 == 0:
            masses = np.round(np.exp(log_m.detach().cpu().numpy()), 4)
            print(f"step {i:4d} loss {float(loss.detach()):.3e} "
                  f"masses {masses}")

    with torch.no_grad():
        ys, _ = odeint(rhs, state0, ts, (log_m,), solver="dopri5",
                       grad_method="aca", rtol=1e-6, atol=1e-6,
                       max_steps=1024)
        mse = float(((ys["r"] - rs) ** 2).mean())
    masses = np.round(np.exp(log_m.detach().cpu().numpy()), 4)
    print(f"\nrecovered masses: {masses} (true: {m_true.cpu().numpy()})")
    print(f"trajectory MSE over [0, 2] yr (train was [0, 1]): {mse:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
