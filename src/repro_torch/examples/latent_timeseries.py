"""Latent ODE on irregularly sampled time series (paper Sec. 4.3), on the
port.

A GRU encoder maps irregular (t_i, y_i) observations to a latent initial
state; the decoder integrates the latent dynamics through each sample's
own observation times in one ``odeint(..., batch_axis=0)`` with ACA
gradients (``repro_torch.benchmarks.timeseries``). After training, the
whole batch is decoded again by one dense-output solve through the union
of every sample's times, ``odeint(..., batch_axis=0,
interpolate_ts=True)`` over ``merged_time_grid``: the union's eval times
are read off each row's step interpolants instead of forcing a landing
on every one of them. Port of ``examples/latent_timeseries.py``.

    PYTHONPATH=src python -m repro_torch.examples.latent_timeseries \\
        [--device cpu] [--steps 200]
"""

import argparse
from typing import Tuple

import torch

from repro_torch.benchmarks.timeseries import (_f, gru_encode, init_params,
                                               mse)
from repro_torch.core import SolveStats, odeint
from repro_torch.data import irregular_series_batch, merged_time_grid
from repro_torch.optim import adamw, apply_updates, constant


def union_decode(p, d, rtol: float = 1e-4, use_pallas: bool = False
                 ) -> Tuple[torch.Tensor, SolveStats]:
    """ŷ (B, T, OBS) of every sample from ONE batched dense solve through
    the union of the samples' times, gathering sample b's own times as
    ``ys[idx[b], b]``; and the solve's stats."""
    grid = merged_time_grid(d["ts"])
    z0 = gru_encode(p, d["ts"], d["ys"])
    ys_u, stats = odeint(_f, z0, grid["t_union"], (p["f1"], p["f2"]),
                         solver="dopri5", rtol=rtol, atol=rtol,
                         max_steps=256, batch_axis=0, interpolate_ts=True,
                         use_pallas=use_pallas)
    rows = torch.arange(z0.shape[0], device=z0.device)
    return ys_u[grid["idx"], rows[:, None]] @ p["dec"], stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)

    data = irregular_series_batch(batch=32, n_obs=16, obs_dim=8, seed=0,
                                  device=args.device)
    test = irregular_series_batch(batch=8, n_obs=16, obs_dim=8, seed=123,
                                  device=args.device)
    p = init_params(torch.Generator().manual_seed(0), data["ts"].device)
    opt = adamw(constant(3e-3))
    st = opt.init(p)
    for i in range(args.steps):
        loss = mse(p, data, "aca")
        g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        up, st = opt.update(g, st, p)
        p = apply_updates(p, up)
        if i % 25 == 0:
            print(f"step {i:4d}  train mse {float(loss.detach()):.5f}")
    with torch.no_grad():
        print(f"\ntest interpolation MSE: {float(mse(p, test, 'aca')):.5f}")
        pred, stats = union_decode(p, test)
        n_union = merged_time_grid(test["ts"])["t_union"].shape[0]
        print(f"union-grid dense decode MSE: "
              f"{float(((pred - test['ys']) ** 2).mean()):.5f} "
              f"({n_union} union eval times, mean accepted steps/elt "
              f"{float(stats.n_steps.float().mean()):.1f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
