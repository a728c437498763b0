"""Benchmark runner of the port — one function per paper table/figure.

    PYTHONPATH=src python -m repro_torch.benchmarks.run \\
        [--full] [--only NAME] [--device cuda|cpu]

Port of ``benchmarks/run.py`` for the paper's experiments (Fig. 4/5/6,
Tables 1-7), the gradient-method ablation on a NODE LM (``node_lm``), the
segmented-memory and dense-output benchmarks (``memory``,
``dense_eval``), the solve-health guards' cost gate
(``failure_overhead``), MALI's memory (``mali_memory``), the three
batched-solve strategies (``batched_solve``), continuous against
static batching of NODE requests (``serve_node``) and the rank scaling
of the sharded solve (``sharded_solve``: NCCL ranks, one a card, up to
the card count; gloo ranks with ``--device cpu``). Quick mode (the
reference's smaller sizes) is the default;
``--full`` uses the larger settings. Output: the reference's
``name,value,derived`` CSV rows, a ``bench_runtime_s/<name>`` row per
benchmark, and a non-zero exit naming the benchmarks that failed.
"""

from __future__ import annotations

import argparse
import time
import traceback

from . import (batched_solve, classification, dense_eval,
               failure_overhead, mali_memory, memory, method_costs, node_lm,
               reliability, reverse_error, serve_node, sharded_solve,
               solver_robustness, threebody, timeseries, toy_gradient)
from .common import emit

BENCHES = [
    ("toy_gradient (Fig.6)", toy_gradient.run),
    ("reverse_error (Fig.4/5)", reverse_error.run),
    ("method_costs (Table 1)", method_costs.run),
    ("classification (Table 2/Fig.7)", classification.run),
    ("reliability (Table 3)", reliability.run),
    ("solver_robustness (Tables 6/7)", solver_robustness.run),
    ("timeseries (Table 4)", timeseries.run),
    ("threebody (Table 5/Fig.8)", threebody.run),
    ("node_lm (beyond-paper: LM ablation)", node_lm.run),
    ("batched_solve (beyond-paper: batch_axis)", batched_solve.run),
    ("memory (beyond-paper: segmented ACA)", memory.run),
    ("dense_eval (beyond-paper: interpolate_ts)", dense_eval.run),
    ("mali_memory (beyond-paper: reversible MALI)", mali_memory.run),
    ("failure_overhead (solve-health guard gate)",
     failure_overhead.run),
    ("serve_node (beyond-paper: continuous batching)", serve_node.run),
    ("sharded_solve (beyond-paper: mesh=)", sharded_solve.run),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device of every benchmark (default: the card)")
    args = ap.parse_args(argv)

    failed = []
    for name, fn in BENCHES:
        if args.only and args.only not in name:
            continue
        print(f"# === {name} ===", flush=True)
        t0 = time.monotonic()
        try:
            fn(quick=not args.full, device=args.device)
            emit(f"bench_runtime_s/{name.split(' ')[0]}",
                 f"{time.monotonic() - t0:.1f}", "")
        except Exception:
            # per-bench isolation: one crashing bench reports and the
            # suite continues; the summary and exit code carry the failure
            failed.append(name)
            traceback.print_exc()
            emit(f"bench_failed/{name.split(' ')[0]}", "1", "")
    if failed:
        print(f"# {len(failed)} benchmark(s) failed: "
              + ", ".join(failed), flush=True)
        raise SystemExit(f"{len(failed)} benchmarks failed: "
                         + ", ".join(n.split(" ")[0] for n in failed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
