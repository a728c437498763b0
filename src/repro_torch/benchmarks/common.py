"""Shared benchmark utilities of the port: CSV / JSON emission, timing.

Port of ``benchmarks/common.py``'s ``emit``, ``emit_json``, ``timed``,
``percentile`` and ``latency_summary``.
``emit`` prints the same ``name,value,derived`` rows; with
``BENCH_ARTIFACT_DIR`` set, every ``emit_json`` headline is also appended
to ``$BENCH_ARTIFACT_DIR/BENCH_<bench>.json`` (one JSON object a line).
``record`` keeps a row's unformatted value too, for the callers that
check the numbers (``run`` of each benchmark returns them); ``fit`` is
the benchmarks' AdamW training loop.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import time
from typing import Callable, Dict, Mapping, Tuple

import torch

from repro_torch.optim import adamw, apply_updates, constant

ROWS = []


def emit(name: str, value, derived: str = "") -> None:
    row = f"{name},{value},{derived}"
    ROWS.append(row)
    print(row, flush=True)


def record(out: Dict[str, float], name: str, value, fmt: str,
           derived: str = "") -> None:
    """``emit`` the row with ``value`` formatted by ``fmt`` and keep the
    value itself in ``out[name]``."""
    out[name] = value
    emit(name, format(value, fmt), derived)


def settings(table: Mapping[bool, Mapping], quick: bool,
             cuts: Mapping) -> Dict:
    """The run's sizes: ``table[quick]`` with ``cuts`` (keyword overrides of
    some of its entries) applied; an unknown key raises."""
    base = dict(table[quick])
    unknown = set(cuts) - set(base)
    if unknown:
        raise ValueError(f"unknown setting(s) {sorted(unknown)}; this "
                         f"benchmark takes {sorted(base)}")
    base.update(cuts)
    return base


def fit(p, steps: int, lr: float, loss_of: Callable):
    """``steps`` AdamW steps (constant ``lr``, the benchmarks' optimizer)
    on ``loss_of(p)``, ``p`` a tensor or a dict of tensors; returns (p,
    the last step's loss). A leaf the loss leaves unused gets a zero
    gradient, as ``jax.grad`` gives it."""
    opt = adamw(constant(lr))
    st = opt.init(p)
    loss = None
    for _ in range(steps):
        leaves = [p] if isinstance(p, torch.Tensor) else list(p.values())
        loss = loss_of(p)
        g = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
        g = g[0] if isinstance(p, torch.Tensor) else dict(zip(p, g))
        up, st = opt.update(g, st, p)
        p = apply_updates(p, up)
    return p, float(loss.detach())


class GateFailed(RuntimeError):
    """A benchmark's acceptance gate did not hold."""


def gate(ok: bool, *what) -> None:
    """Raise ``GateFailed`` naming ``what`` unless ``ok``."""
    if not ok:
        raise GateFailed(*what)


def saved_bytes(fn: Callable, inputs) -> Tuple[int, object]:
    """(bytes, fn()): the bytes of the distinct storages autograd saves for
    the backward while ``fn`` runs (every saved-tensor hook of every op and
    Function), the storages of ``inputs`` left out."""
    skip = {x.untyped_storage().data_ptr() for x in inputs}
    seen: Dict[int, int] = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            seen[st.data_ptr()] = st.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return sum(seen.values()), out


def emit_json(bench: str, metrics: Mapping) -> None:
    """Emit one headline JSON line in the shared schema:

        {"bench": <name>, "metrics": {<metric>: <number|string>, ...}}

    and append it to ``$BENCH_ARTIFACT_DIR/BENCH_<bench>.json`` where that
    variable names a directory."""
    line = json.dumps({"bench": bench, "metrics": dict(metrics)},
                      sort_keys=True)
    ROWS.append(line)
    print(line, flush=True)
    art_dir = os.environ.get("BENCH_ARTIFACT_DIR")
    if art_dir:
        path = pathlib.Path(art_dir)
        path.mkdir(parents=True, exist_ok=True)
        slug = re.sub(r"[^A-Za-z0-9_.-]+", "_", bench)
        with open(path / f"BENCH_{slug}.json", "a") as fh:
            fh.write(line + "\n")


def percentile(xs, q: float) -> float:
    """The q-th percentile (0 <= q <= 100) of a sample, linearly
    interpolated between order statistics (numpy's default); an empty
    sample raises rather than reporting 0."""
    xs = sorted(float(x) for x in xs)
    if not xs:
        raise ValueError("percentile of an empty sample")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q must be in [0, 100]; got {q}")
    if len(xs) == 1:
        return xs[0]
    pos = (q / 100.0) * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def latency_summary(latencies) -> dict:
    """p50, p99, mean and max of a latency sample, and its size ``n`` (the
    serving benchmarks' ``emit_json`` metrics)."""
    xs = [float(x) for x in latencies]
    if not xs:
        raise ValueError("latency_summary of an empty sample")
    return {"n": len(xs), "p50": percentile(xs, 50.0),
            "p99": percentile(xs, 99.0), "mean": sum(xs) / len(xs),
            "max": max(xs)}


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, *args, n: int = 3, warmup: int = 1,
          device="cuda") -> float:
    """Median wall time (seconds) of fn(*args), each call ending in a
    synchronize of ``device``."""
    for _ in range(warmup):
        fn(*args)
        synchronize(device)
    ts = []
    for _ in range(n):
        t0 = time.monotonic()
        fn(*args)
        synchronize(device)
        ts.append(time.monotonic() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def device_name(device) -> str:
    """The card's name for a CUDA device, else "CPU" (for ``derived``
    fields)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "CPU"
