"""Quickstart on the port: solve an ODE, differentiate through it with ACA,
and compare the gradient methods (paper Eq. 27-29); then a NODE block.

Port of ``examples/quickstart.py``. Runs on the card unless asked for the
CPU::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import NodeConfig, node_block_apply, odeint

K, T, Z0 = -2.0, 3.0, 1.5
METHODS = ("aca", "adjoint", "naive", "mali")


def f(t, z, k):
    return k * z


def gradient(method: str, device: str):
    """(dL/dz0, accepted steps) of L = z(T)^2 under ``method``."""
    # mali integrates with the reversible ALF pair stepper (no RK
    # tableau): solver resolves to "alf", and its 2nd-order steps need a
    # larger accepted-step budget at this tolerance
    z0 = torch.tensor(Z0, dtype=torch.float32, device=device,
                      requires_grad=True)
    k = torch.tensor(K, dtype=torch.float32, device=device)
    ys, stats = odeint(f, z0, torch.tensor([0.0, T], device=device), (k,),
                       solver=None if method == "mali" else "dopri5",
                       grad_method=method,
                       max_steps=4096 if method == "mali" else 256,
                       rtol=1e-5, atol=1e-5)
    g, = torch.autograd.grad((ys[-1] ** 2).sum(), [z0])
    return float(g), int(stats.n_steps)


def run(device: str = "cuda", seed: int = 0) -> dict:
    """The quickstart's numbers: the solve, each method's gradient against
    the analytic one, and the NODE block's shapes."""
    ts = torch.linspace(0.0, T, 5, device=device)
    ys, stats = odeint(f, torch.tensor(Z0, device=device), ts,
                       (torch.tensor(K, device=device),), solver="dopri5",
                       grad_method="aca", rtol=1e-6, atol=1e-6)
    out = {"ys": ys.cpu().numpy(),
           "exact": Z0 * np.exp(K * ts.cpu().numpy()),
           "n_steps": int(stats.n_steps), "nfe": int(stats.nfe),
           "analytic": 2 * Z0 * np.exp(2 * K * T), "grads": {}}
    for method in METHODS:
        g, n = gradient(method, device)
        out["grads"][method] = {
            "grad": g, "n_steps": n,
            "rel_err": abs(g - out["analytic"]) / abs(out["analytic"])}

    # a NODE block: a continuous-depth layer (paper Eq. 30 -> 31)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    params = {"w1": (torch.randn(8, 32, generator=gen) * 0.3).to(device),
              "w2": (torch.randn(32, 8, generator=gen) * 0.3).to(device)}

    def block_fn(p, z, t):
        return torch.tanh(z @ p["w1"]) @ p["w2"]

    z = torch.randn(4, 8, generator=gen).to(device)
    zT = node_block_apply(block_fn, params, z,
                          NodeConfig(enabled=True, solver="heun_euler",
                                     grad_method="aca"))
    out["node_block"] = {"in": tuple(z.shape), "out": tuple(zT.shape),
                         "params": sum(p.numel() for p in params.values()),
                         "finite": bool(torch.isfinite(zT).all())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = run(args.device)
    print("z(t):", np.round(r["ys"], 5))
    print("exact:", np.round(r["exact"], 5))
    print(f"accepted steps: {r['n_steps']}, NFE: {r['nfe']}")
    print(f"\nanalytic dL/dz0 = {r['analytic']:.6e}   (L = z(T)^2)")
    for method, g in r["grads"].items():
        print(f"{method:8s} dL/dz0 = {g['grad']:.6e}   "
              f"rel err = {g['rel_err']:.2e}")
    nb = r["node_block"]
    print("\nNODE block: in", nb["in"], "-> out", nb["out"],
          "| param count unchanged:", nb["params"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
