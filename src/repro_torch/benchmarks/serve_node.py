"""Continuous-batching NODE serving against a static-batch baseline, on
the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_node \\
        [--quick] [--device cuda|cpu] [--use-pallas]

Port of ``benchmarks/bench_serve_node.py``, with its problem, trace, row
names and gates. One seeded heavy-traffic trace (Poisson arrivals of
mean gap 4.0, horizons 0.5/1.0/4.0 at 0.55/0.25/0.2, tolerances
1e-3/1e-4/1e-5 at 0.5/0.3/0.2 with atol = rtol·1e-2, z0 of size 8) is
served twice through ``NodeServeEngine`` on identical slots, chunk and
cost settings: ``static_batch=False`` (continuous: a finished slot is
refilled at the next chunk boundary), then ``True`` (a new wave only when
every slot is free). Latency is the engine's ``SimClock`` (a round costs
``chunk_overhead + trial_cost · max_row_trials``), so the rows measure
the scheduler, not the host. Each round is also timed on the host clock
(after a synchronize of ``device``): those times and each mode's drain
time come back from ``run`` as measurements, not gates.

Gates (``common.GateFailed``):
  * every request ends OK in both modes;
  * its final state lies within ``(n_chunks + 1) · (atol + rtol ·
    max(1, max|z_ref|))`` of a one-shot solo ``odeint`` (worst err/bound
    < 1);
  * continuous drains the trace no slower than static (throughput);
  * static p99 / continuous p99 >= 1.5.

``use_pallas=True`` runs every round's stage sums and per-row-tolerance
norms on kernels K3 and K5 (their plain versions on CPU tensors).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import odeint
from repro_torch.device import resolve_device
from repro_torch.serve import NodeEngineConfig, NodeRequest, NodeServeEngine

from .common import emit_json, gate, latency_summary, record, synchronize

DIM = 8
SLOTS = 4
CHUNK_DT = 0.5
ARRIVAL_MEAN = 4.0          # sim-time mean inter-arrival (heavy traffic)
HORIZONS = (0.5, 1.0, 4.0)  # heavy-tailed physical-time horizon mix
HORIZON_P = (0.55, 0.25, 0.2)
TOLS = (1e-3, 1e-4, 1e-5)
TOL_P = (0.5, 0.3, 0.2)
MIN_P99_RATIO = 1.5
W = 1.3


def field(t, z, w):
    return torch.tanh(w * z) - 0.1 * z * torch.sin(t)


def traffic(rng: np.random.Generator, n: int) -> List[Tuple[float,
                                                             NodeRequest]]:
    """The reference's seeded trace: (arrival, request) pairs, drawn in its
    order (a prefix of a longer trace is the shorter trace)."""
    t = 0.0
    out = []
    for _ in range(n):
        t += float(rng.exponential(ARRIVAL_MEAN))
        horizon = float(rng.choice(HORIZONS, p=HORIZON_P))
        rtol = float(rng.choice(TOLS, p=TOL_P))
        z0 = rng.normal(size=(DIM,)).astype(np.float32)
        out.append((t, NodeRequest(z0=z0, t0=0.0, t1=horizon, rtol=rtol,
                                   atol=rtol * 1e-2)))
    return out


def serve(trace, static: bool, device, use_pallas: bool = False,
          grad_method: str = "aca"):
    """Serve ``trace`` through one engine, one round at a time. Returns
    (engine, results ordered by id, host ms of each round, drain
    seconds)."""
    dev = resolve_device(device)
    eng = NodeServeEngine(
        field, DIM, (torch.tensor(W, device=dev),),
        NodeEngineConfig(slots=SLOTS, chunk_dt=CHUNK_DT,
                         static_batch=static, use_pallas=use_pallas,
                         grad_method=grad_method), device=dev)
    for arrival, req in trace:
        eng.submit(req, arrival=arrival)
    round_ms = []
    synchronize(dev)
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        more = eng.step()
        synchronize(dev)
        if not more:
            break
        round_ms.append(1e3 * (time.perf_counter() - t0))
    drain_s = time.perf_counter() - t_start
    results = [eng.results[k] for k in sorted(eng.results)]
    return eng, results, round_ms, drain_s


def parity_worst(trace, results, device) -> float:
    """The worst err/bound of the served final states against one-shot solo
    solves at each request's own tolerance (must stay < 1)."""
    dev = resolve_device(device)
    w = torch.tensor(W, device=dev)
    worst = 0.0
    by_id = {r.req_id: r for r in results}
    with torch.no_grad():
        for rid, (_, req) in enumerate(trace):
            r = by_id[rid]
            ys, _ = odeint(field, torch.from_numpy(req.z0).to(dev),
                           [req.t0, req.t1], (w,), rtol=req.rtol,
                           atol=req.atol)
            ref = ys[-1].cpu().numpy()
            err = float(np.abs(r.z_final - ref).max())
            bound = (r.n_chunks + 1) * (
                req.atol + req.rtol * max(1.0, float(np.abs(ref).max())))
            worst = max(worst, err / bound)
    return worst


def run(quick: bool = False, device="cuda",
        use_pallas: bool = False) -> Dict:
    """Emit the serve_node rows; returns {row: value} plus the host-clock
    measurements under ``host`` (ms a round and drain seconds per mode)
    and each mode's per-request ``n_trials`` under ``n_trials``."""
    n = 24 if quick else 40
    trace = traffic(np.random.default_rng(0), n)
    eng_c, res_c, ms_c, drain_c = serve(trace, False, device, use_pallas)
    eng_s, res_s, ms_s, drain_s = serve(trace, True, device, use_pallas)

    gate(all(r.ok for r in res_c), "continuous: a request did not end OK",
         [r.status for r in res_c])
    gate(all(r.ok for r in res_s), "static: a request did not end OK",
         [r.status for r in res_s])

    lat_c = latency_summary([r.latency for r in res_c])
    lat_s = latency_summary([r.latency for r in res_s])
    thr_c = n / eng_c.clock.now
    thr_s = n / eng_s.clock.now
    occ_c = sum(eng_c.occupancy_log) / max(1, len(eng_c.occupancy_log))
    occ_s = sum(eng_s.occupancy_log) / max(1, len(eng_s.occupancy_log))
    ratio = lat_s["p99"] / lat_c["p99"]
    worst = max(parity_worst(trace, res_c, device),
                parity_worst(trace, res_s, device))

    out: Dict = {}
    record(out, "serve_node/continuous_p50", lat_c["p50"], ".1f",
           "sim-time")
    record(out, "serve_node/continuous_p99", lat_c["p99"], ".1f",
           "sim-time")
    record(out, "serve_node/static_p50", lat_s["p50"], ".1f", "sim-time")
    record(out, "serve_node/static_p99", lat_s["p99"], ".1f", "sim-time")
    record(out, "serve_node/p99_ratio", ratio, ".2f",
           f"gate >= {MIN_P99_RATIO}")
    record(out, "serve_node/throughput_continuous", thr_c, ".4f",
           "req/sim-t")
    record(out, "serve_node/throughput_static", thr_s, ".4f", "req/sim-t")
    record(out, "serve_node/parity_worst", worst, ".3f",
           "err/bound, gate < 1")
    emit_json("serve_node", {
        "n_requests": n, "slots": SLOTS,
        "p50_continuous": lat_c["p50"], "p99_continuous": lat_c["p99"],
        "p50_static": lat_s["p50"], "p99_static": lat_s["p99"],
        "p99_ratio": ratio, "throughput_continuous": thr_c,
        "throughput_static": thr_s,
        "mean_occupancy_continuous": occ_c,
        "mean_occupancy_static": occ_s, "parity_worst": worst})
    out["host"] = {"continuous_round_ms": ms_c, "static_round_ms": ms_s,
                   "continuous_drain_s": drain_c, "static_drain_s": drain_s}
    out["n_trials"] = {"continuous": [r.n_trials for r in res_c],
                       "static": [r.n_trials for r in res_s]}

    gate(worst < 1.0, "served result beyond the chunked-parity bound: "
         "worst err/bound", worst)
    gate(thr_c >= thr_s * (1.0 - 1e-9), "continuous batching drained "
         "slower than static (req/sim-t)", thr_c, thr_s)
    gate(ratio >= MIN_P99_RATIO, f"continuous batching must cut p99 "
         f"latency by >= {MIN_P99_RATIO}x against static batching",
         ratio, lat_s["p99"], lat_c["p99"])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-pallas", action="store_true")
    a = ap.parse_args()
    run(quick=a.quick, device=a.device, use_pallas=a.use_pallas)
