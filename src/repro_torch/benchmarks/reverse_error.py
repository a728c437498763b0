"""Paper Fig. 4/5 — reverse-time trajectory mismatch, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.reverse_error \\
        [--full] [--device cuda|cpu]

Port of ``benchmarks/bench_reverse_error.py``, with its row names.
Integrate forward 0→T, then re-integrate T→0 from z(T) (what the adjoint
method does) and measure ‖z̄(0) − z(0)‖ / ‖z(0)‖. ACA's checkpoints
recover z(0) exactly by construction; the reverse solve drifts:

  * van der Pol (paper Fig. 4/9): a limit cycle, stiffer with mu;
  * a random conv-style linear ODE (paper Fig. 5): dz/dt = conv3x3(z) on
    an 8 × 8 image, ``F.conv2d`` in NCHW with an OIHW kernel (the
    reference's is NHWC/HWIO). The kernel and image are drawn from seeded
    CPU generators, then moved to the device.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

from repro_torch.core import odeint
from repro_torch.device import resolve_device

from .common import record, settings

SETTINGS = {True: dict(mus=(0.15, 4.0), t_ends=(1.0,)),
            False: dict(mus=(0.15, 1.0, 4.0, 8.0), t_ends=(0.5, 1.0, 2.0))}


def reverse_roundtrip_error(f, z0, t_end, args=(), tol=1e-5) -> float:
    """Relative ‖z̄(0) − z(0)‖ after a Dopri5 solve to ``t_end`` and back."""
    ts = torch.tensor([0.0, t_end], dtype=torch.float32,
                      device=pytree.tree_leaves(z0)[0].device)
    kw = dict(solver="dopri5", grad_method="aca", rtol=tol, atol=tol,
              max_steps=2048, max_trials=20)
    with torch.no_grad():
        ys, _ = odeint(f, z0, ts, args, **kw)
        z_end = pytree.tree_map(lambda y: y[-1], ys)

        # reverse-time IVP from z(T) (the adjoint's z̄ trajectory)
        def f_rev(s, z, *a):
            return pytree.tree_map(torch.neg, f(t_end - s, z, *a))

        ys_rev, _ = odeint(f_rev, z_end, ts, args, **kw)
        z0_rec = pytree.tree_map(lambda y: y[-1], ys_rev)
        num = torch.sqrt(sum(torch.sum((a - b) ** 2) for a, b in zip(
            pytree.tree_leaves(z0_rec), pytree.tree_leaves(z0))))
        den = torch.sqrt(sum(torch.sum(b ** 2)
                             for b in pytree.tree_leaves(z0)))
        return float(num / torch.clamp(den, min=1e-12))


def vdp(t, z, mu):
    return torch.stack([z[1], mu * (1 - z[0] ** 2) * z[1] - z[0]])


def conv_ode(t, z, k):
    return F.conv2d(z, k, padding=1)


def conv_inputs(device="cuda"):
    """(kernel (1, 1, 3, 3) OIHW × 0.5, image (1, 1, 8, 8) NCHW), drawn
    from CPU generators seeded 0 and 1."""
    dev = resolve_device(device)
    kern = torch.randn((1, 1, 3, 3),
                       generator=torch.Generator().manual_seed(0)) * 0.5
    img = torch.randn((1, 1, 8, 8), generator=torch.Generator().manual_seed(1))
    return kern.to(dev), img.to(dev)


def run(quick: bool = False, device="cuda", **cuts) -> Dict[str, float]:
    """Emit the Fig. 4/5 rows; returns {row name: relative error}."""
    s = settings(SETTINGS, quick, cuts)
    dev = resolve_device(device)
    out: Dict[str, float] = {}
    # van der Pol (Appendix D Eq. 81-82: mu = 0.15 is mild; the mismatch
    # explodes for stiffer mu)
    for mu in s["mus"]:
        err = reverse_roundtrip_error(
            vdp, torch.tensor([2.0, 0.0], device=dev), 5.0,
            (torch.tensor(mu, dtype=torch.float32, device=dev),))
        record(out, f"fig4_vdp_reverse_relerr/mu={mu}", err, ".3e",
               "adjoint z̄(0) drift; ACA=0 by construction")
    # conv ODE (Fig. 5): dz/dt = conv3x3(z)
    kern, img = conv_inputs(dev)
    for t_end in s["t_ends"]:
        err = reverse_roundtrip_error(conv_ode, img, t_end, (kern,))
        record(out, f"fig5_conv_reverse_relerr/T={t_end}", err, ".3e",
               "conv-ODE reconstruction drift")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run(quick=not a.full, device=a.device)
