"""Paper Fig. 6 — |gradient error| vs end time T for the toy problem
dz/dt = k z,  L = z(T)²,  dL/dz0 = 2 z0 e^{2kT}  (Eq. 27-29), on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.toy_gradient \\
        [--quick] [--device cuda|cpu] [--use-pallas]

All three methods use Dopri5 at rtol=atol=1e-5, as in the paper and the
reference's ``benchmarks/bench_toy_gradient.py``, whose row names this
prints (``name,value,derived``):

  * k < 0 — the forward decays, so the adjoint's reverse-time
    re-integration is unstable (Theorem 3.2's DΦ⁻¹ term amplifies the
    truncation error as e^{|k|T}): its error grows with T, while ACA and
    the naive method (both differentiate the forward discretization) stay
    at the tolerance floor;
  * k > 0 — the reverse solve is stable; every method sits at the floor.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, Tuple

import torch

from repro_torch.core import SolveStats, odeint

from .common import emit

Z0 = 1.5
METHODS = ("aca", "adjoint", "naive")


def toy_case(method: str, k: float, t_end: float, *, device="cuda",
             use_pallas: bool = False) -> Tuple[float, SolveStats]:
    """(relative gradient error against Eq. 29, the forward solve's
    stats) of one method at (k, T)."""
    z0 = torch.tensor(Z0, device=device, requires_grad=True)
    kk = torch.tensor(k, device=device)
    ys, stats = odeint(lambda t, z, c: c * z, z0, [0.0, t_end], (kk,),
                       solver="dopri5", grad_method=method, rtol=1e-5,
                       atol=1e-5, max_steps=512, use_pallas=use_pallas)
    (ys[-1] ** 2).sum().backward()
    analytic = 2 * Z0 * math.exp(2 * k * t_end)
    return abs(float(z0.grad) - analytic) / abs(analytic), stats


def grad_rel_error(method: str, k: float, t_end: float, *, device="cuda",
                   use_pallas: bool = False) -> float:
    """Relative error of dL/dz0 against the analytic gradient (Eq. 29)."""
    return toy_case(method, k, t_end, device=device,
                    use_pallas=use_pallas)[0]


def run(quick: bool = False, device="cuda", use_pallas: bool = False
        ) -> Dict[Tuple[float, float], Dict[str, float]]:
    """Print the Fig. 6 rows and return {(k, T): {method: rel err}}."""
    ts = [1.0, 2.0, 4.0] if quick else [0.5, 1.0, 2.0, 3.0, 4.0]
    out = {}
    for k in (-2.0, 2.0):
        for t_end in ts:
            errs = {m: grad_rel_error(m, k, t_end, device=device,
                                      use_pallas=use_pallas)
                    for m in METHODS}
            for m, e in errs.items():
                emit(f"fig6_grad_relerr/k={k:+.0f}/{m}/T={t_end}",
                     f"{e:.3e}", "rel err vs Eq.29")
            rel = errs["adjoint"] / max(errs["aca"], 1e-12)
            emit(f"fig6_adjoint_over_aca/k={k:+.0f}/T={t_end}",
                 f"{rel:.2f}", "adjoint err / ACA err (>1 favors ACA)")
            out[(k, t_end)] = errs
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="T in {1, 2, 4} only")
    parser.add_argument("--device", default="cuda",
                        help="device of the solves (default: the card)")
    parser.add_argument("--use-pallas", action="store_true",
                        help="run the RK stages through kernels K1/K2")
    args = parser.parse_args(argv)
    run(args.quick, args.device, args.use_pallas)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
