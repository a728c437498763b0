"""Where one training step of the port's paper benchmarks spends its time.

    PYTHONPATH=src python3 tests/torch_bench_steps.py [--device cuda]
        [--steps N]

For classification (NODE, aca, the quick data), the time-series latent
ODE (aca, adjoint, naive; batch 48 × 16 observations) and the three-body
mass fit (aca) and NODE (aca) at 2 × 128 points: the median host time of
``--steps`` steps (each ending in a synchronize), then one step traced
with ``torch.profiler`` (its wall time, which the tracing stretches):
host time in the forward, the backward and
AdamW (``record_function`` spans), host time and count of the field's
evaluations (the benchmark's field wrapped in a span here), the host
reads (``aten::_local_scalar_dense``, and on a card the stream syncs and
copies: the solver's loop decisions and the
naive method's per-trial reads, each a device sync), and the device's
busy time (CUDA kernels; none on the CPU). Prints one JSON line per case.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402,E501

from repro_torch.benchmarks import classification as cls  # noqa: E402
from repro_torch.benchmarks import threebody as tb  # noqa: E402
from repro_torch.benchmarks import timeseries as tsr  # noqa: E402
from repro_torch.benchmarks.common import synchronize  # noqa: E402
from repro_torch.data import (irregular_series_batch,  # noqa: E402
                              spiral_classification)
from repro_torch.optim import adamw, apply_updates, constant  # noqa: E402


def spanned(fn, name):
    def g(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return g


def stepper(loss_of, params, lr):
    """One AdamW step of ``loss_of`` from ``params`` (a dict, or a
    tensor), with spans around its three parts."""
    opt = adamw(constant(lr))
    state = {"p": params, "st": opt.init(params)}

    def step():
        p = state["p"]
        leaves = [p] if isinstance(p, torch.Tensor) else list(p.values())
        with record_function("bench_forward"):
            loss = loss_of(p)
        with record_function("bench_backward"):
            g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        with record_function("bench_adamw"):
            g = g[0] if isinstance(p, torch.Tensor) else dict(zip(p, g))
            up, state["st"] = opt.update(g, state["st"], p)
            state["p"] = apply_updates(p, up)
    return step


def cases(device):
    x, y = spiral_classification(400, seed=0, device=device)
    p = cls.init_params(torch.Generator().manual_seed(0), device=device)
    yield "classification_node_aca", stepper(
        lambda q: cls.loss_fn(q, x, y, "node", "aca"), p, 3e-3)
    data = irregular_series_batch(batch=48, n_obs=16, obs_dim=tsr.OBS,
                                  seed=0, device=device)
    for gm in ("aca", "adjoint", "naive"):
        p = tsr.init_params(torch.Generator().manual_seed(0), device)
        yield f"timeseries_{gm}", stepper(
            lambda q, gm=gm: tsr.mse(q, data, gm), p, 3e-3)
    ts_all, rs, vs, _ = tb.ground_truth(128, device)
    state0 = {"r": rs[0], "v": vs[0]}
    log_m = torch.zeros(3, device=rs.device, requires_grad=True)
    yield "threebody_mass_aca", stepper(lambda lm: (
        (tb.traj(tb.mass_rhs, state0, ts_all[:128], (lm,), "aca")["r"]
         - rs[:128]) ** 2).mean(), log_m, 0.05)
    w = (torch.randn((90, 9), generator=torch.Generator().manual_seed(0))
         * 0.01).to(device).requires_grad_()
    yield "threebody_node_aca", stepper(lambda q: (
        (tb.traj(tb.node_rhs, state0, ts_all[:128], (q,), "aca")["r"]
         - rs[:128]) ** 2).mean(), w, 3e-3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    # the fields, each evaluation in a span
    cls._f = spanned(cls._f, "bench_field")
    tsr._f = spanned(tsr._f, "bench_field")
    tb.mass_rhs = spanned(tb.mass_rhs, "bench_field")
    tb.node_rhs = spanned(tb.node_rhs, "bench_field")
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    for name, step in cases(dev):
        step()                                   # warm-up
        synchronize(dev)
        times = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()
            synchronize(dev)
            times.append(1e3 * (time.perf_counter() - t0))
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step()
            synchronize(dev)
            traced_ms = 1e3 * (time.perf_counter() - t0)
        # host-side events only: on a card each span also has a device
        # range under the same name
        host = [e for e in prof.events() if e.device_type.name == "CPU"]

        def host_ms(key):
            return sum(e.cpu_time_total for e in host if e.name == key) / 1e3

        def count(key):
            return sum(1 for e in host if e.name == key)

        # device work: kernels and copies (the spans' device-side ranges
        # carry the spans' names and are not work)
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type.name == "CUDA"
                        and not e.key.startswith("bench_")) / 1e3
        print(json.dumps({
            "case": name, "device": str(dev),
            "step_ms_median": statistics.median(times), "step_ms": times,
            "traced": {
                "step_ms": traced_ms,
                "forward_ms": host_ms("bench_forward"),
                "backward_ms": host_ms("bench_backward"),
                "adamw_ms": host_ms("bench_adamw"),
                "field_ms": host_ms("bench_field"),
                "field_evals": count("bench_field"),
                "host_reads": count("aten::_local_scalar_dense"),
                "host_read_ms": host_ms("aten::_local_scalar_dense"),
                "stream_syncs": count("cudaStreamSynchronize"),
                "memcpy_calls": count("cudaMemcpyAsync"),
                "kernel_launches": count("cudaLaunchKernel"),
                "device_busy_ms": device_ms,
                "top_host_self_ms": {
                    e.key: e.self_cpu_time_total / 1e3 for e in sorted(
                        prof.key_averages(),
                        key=lambda e: -e.self_cpu_time_total)[:8]}}}),
              flush=True)
    if dev.type == "cuda":
        print(torch.cuda.get_device_name(dev), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
