"""Paper Table 4 — latent ODE on irregularly sampled series (the Mujoco
stand-in): interpolation MSE for ACA, adjoint and naive, plus a GRU
baseline, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.timeseries \\
        [--full] [--device cuda|cpu]

Port of ``benchmarks/bench_timeseries.py``, with its row names. A GRU
encoder consumes the (y, Δt) pairs backwards to give z0; the decoder
integrates dz/dt = f(z) through each sample's own irregular observation
times and reads out ŷ(t_i). The reference vmaps a solo ``odeint`` over
the samples; here the encoder runs batched over the samples (a Python
loop over the observations in place of ``lax.scan``) and the decoder is
one ``odeint(..., batch_axis=0)`` over the (B, T) eval times, every
sample on its own adaptive grid. The three columns differ only in the
gradient method.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.core import odeint
from repro_torch.data import irregular_series_batch

from .common import fit, record, settings

OBS, LAT, HID = 8, 8, 32
N_OBS = 16
SETTINGS = {True: dict(batch=24, steps=120),
            False: dict(batch=48, steps=300)}


def init_params(generator: torch.Generator, device="cuda"
                ) -> Dict[str, torch.Tensor]:
    """N(0, 1) × 0.3 weights from ``generator`` (a CPU generator), in the
    reference's key order, moved to ``device`` as leaves that take a
    gradient."""
    shapes = {
        # GRU encoder
        "wz": (OBS + 1 + HID, HID), "wr": (OBS + 1 + HID, HID),
        "wh": (OBS + 1 + HID, HID), "enc_out": (HID, LAT),
        # latent dynamics
        "f1": (LAT, HID), "f2": (HID, LAT),
        # readout
        "dec": (LAT, OBS),
    }
    return {k: (torch.randn(s, generator=generator) * 0.3).to(device)
            .requires_grad_() for k, s in shapes.items()}


def gru_encode(p, ts, ys) -> torch.Tensor:
    """Backward-in-time GRU over (y, Δt), batched over samples: ts (B, T),
    ys (B, T, OBS) -> z0 (B, LAT)."""
    dts = torch.diff(ts, dim=1, append=ts[:, -1:])
    inputs = torch.cat([ys, dts[..., None]], dim=2).flip(1)
    h = ys.new_zeros((ys.shape[0], HID))
    for j in range(inputs.shape[1]):
        inp = inputs[:, j]
        x = torch.cat([inp, h], dim=1)
        z = torch.sigmoid(x @ p["wz"])
        r = torch.sigmoid(x @ p["wr"])
        hh = torch.tanh(torch.cat([inp, r * h], dim=1) @ p["wh"])
        h = (1 - z) * h + z * hh
    return h @ p["enc_out"]


def _f(t, z, f1, f2):
    return torch.tanh(z @ f1) @ f2


def decode(p, z0, ts, grad_method: str) -> torch.Tensor:
    """ŷ (B, T, OBS): every sample's latent solve through its own times."""
    ys, _ = odeint(_f, z0, ts, (p["f1"], p["f2"]), solver="dopri5",
                   grad_method=grad_method, rtol=1e-4, atol=1e-4,
                   max_steps=128, batch_axis=0)
    return ys.transpose(0, 1) @ p["dec"]


def mse(p, d, grad_method: str) -> torch.Tensor:
    """Mean over samples of each sample's mean squared error."""
    z0 = gru_encode(p, d["ts"], d["ys"])
    err = (decode(p, z0, d["ts"], grad_method) - d["ys"]) ** 2
    return err.mean(dim=(1, 2)).mean()


def rnn_mse(p, d) -> torch.Tensor:
    """The GRU-only baseline: y(t_i) read from the encoder state directly."""
    z0 = gru_encode(p, d["ts"], d["ys"])
    pred = (z0 @ p["dec"])[:, None, :].expand(d["ys"].shape)
    return ((pred - d["ys"]) ** 2).mean(dim=(1, 2)).mean()


def run(quick: bool = False, device="cuda", **cuts) -> Dict[str, float]:
    """Emit the Table 4 rows; returns {row name: test MSE}."""
    s = settings(SETTINGS, quick, cuts)
    data = irregular_series_batch(batch=s["batch"], n_obs=N_OBS,
                                  obs_dim=OBS, seed=0, device=device)
    test = irregular_series_batch(batch=16, n_obs=N_OBS, obs_dim=OBS,
                                  seed=99, device=device)
    dev = data["ts"].device
    out: Dict[str, float] = {}
    for gm in ("aca", "adjoint", "naive"):
        p, _ = fit(init_params(torch.Generator().manual_seed(0), dev),
                   s["steps"], 3e-3, lambda q: mse(q, data, gm))
        with torch.no_grad():
            test_mse = float(mse(p, test, "aca"))
        record(out, f"table4_latentode_mse/{gm}", test_mse, ".5f",
               f"irregular-series stand-in, {s['steps']} steps")

    p, _ = fit(init_params(torch.Generator().manual_seed(0), dev),
               s["steps"], 3e-3, lambda q: rnn_mse(q, data))
    with torch.no_grad():
        record(out, "table4_rnn_baseline_mse", float(rnn_mse(p, test)),
               ".5f", "GRU encoder + static readout")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run(quick=not a.full, device=a.device)
