"""CLI for the port's run layer: ``python -m repro_torch.analysis``.

Runs the registered entry-point matrix (or a ``--configs`` subset) on the
chosen device (the card unless ``--device cpu``) and applies the four rule
passes. Exits nonzero on any finding not covered by the baseline file, as
``python -m repro.analysis`` does. ``--profile`` also prints each
config's residual bytes beside its budget and its loops' host reads
(``kind@depth=<iterations>it/<reads before the first>+<most in one>``).
"""

from __future__ import annotations

import argparse
import sys


def _print_profile(cfg, run) -> None:
    """One line of residual bytes and one of host reads: each loop kind's
    iterations, reads before its first iteration and most in one, and the
    reads and collectives outside loops."""
    from repro_torch.analysis.rules import profile

    p = profile(run)
    print(f"residual {cfg.name} {p['residual_bytes']} bytes "
          f"(budget {cfg.residual_budget_bytes()})")
    loops = {}
    for kind, depth, entry, reads in p["loops"]:
        n, e, m = loops.get((kind, depth), (0, 0, 0))
        loops[(kind, depth)] = (n + len(reads), max(e, entry),
                                max([m, *reads]))
    text = " ".join(f"{k}@{d}={n}it/{e}+{m}"
                    for (k, d), (n, e, m) in loops.items())
    print(f"reads {cfg.name} {text} outside={len(p['reads_outside'])} "
          f"collectives={len(p['collectives'])}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="run-time analysis over the port's solver entry-point "
        "matrix",
    )
    parser.add_argument(
        "--configs", "--config",
        default=None,
        help="comma-separated config names (default: the full matrix); "
        "see --list",
    )
    parser.add_argument(
        "--list", action="store_true", help="list registered config names and exit"
    )
    parser.add_argument(
        "--device", default="cuda", help="cpu or cuda (default: cuda)"
    )
    parser.add_argument(
        "--baseline",
        default=None,
        help="baseline/suppression JSON (default: the port's "
        "analysis/solver_lint_baseline.json)",
    )
    parser.add_argument(
        "--report", default=None, help="also write the findings report to this file"
    )
    parser.add_argument(
        "--profile", action="store_true",
        help="print each config's residual bytes beside its budget, and "
        "its loops' host reads",
    )
    parser.add_argument(
        "-v", "--verbose", action="store_true", help="show suppressed findings too"
    )
    args = parser.parse_args(argv)

    from repro_torch.analysis import (
        BASELINE_PATH,
        MATRIX,
        Report,
        config_names,
        get_config,
        load_baseline,
    )
    from repro_torch.analysis.rules import analyze_run, runs

    if args.list:
        print("\n".join(config_names()))
        return 0

    baseline = load_baseline(args.baseline or BASELINE_PATH)
    if args.configs:
        configs = [get_config(n.strip()) for n in args.configs.split(",") if n.strip()]
    else:
        configs = list(MATRIX)

    report = Report(baseline=baseline)
    for cfg, run in runs(configs, args.device):
        report.extend(analyze_run(run))
        print(f"analyzed {cfg.name} ({run.seconds:.1f}s)", file=sys.stderr)
        if args.profile:
            _print_profile(cfg, run)

    text = report.render(verbose=args.verbose)
    print(text)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
