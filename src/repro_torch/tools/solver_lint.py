"""AST lint CLI of the port: ``python -m repro_torch.tools.solver_lint
src/repro_torch``.

Runs the port's AST rules (bare-assert, host-read, collective-direct,
registry-drift; ``repro_torch.analysis.ast_lint``) over the given files or
directories and exits nonzero on any finding not covered by the baseline
file (by default the port's
``src/repro_torch/analysis/solver_lint_baseline.json``).
"""

from __future__ import annotations

import argparse

from repro_torch.analysis import BASELINE_PATH, Report, lint_paths, load_baseline

DEFAULT_BASELINE = BASELINE_PATH


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.solver_lint",
        description="the port's solver-stack AST lint",
    )
    parser.add_argument(
        "paths", nargs="*", default=["src/repro_torch"],
        help="files or directories (default: src/repro_torch)"
    )
    parser.add_argument(
        "--baseline",
        default=DEFAULT_BASELINE,
        help="baseline/suppression JSON ('' disables)",
    )
    parser.add_argument(
        "--root", default=".", help="root for repo-relative finding paths"
    )
    parser.add_argument(
        "--report", default=None, help="also write the findings report to this file"
    )
    parser.add_argument(
        "-v", "--verbose", action="store_true", help="show suppressed findings too"
    )
    parser.add_argument(
        "--stale-baseline-check",
        action="store_true",
        help="also fail if baseline entries no longer match anything",
    )
    args = parser.parse_args(argv)

    baseline = load_baseline(args.baseline) if args.baseline else ()
    report = Report(baseline=baseline)
    report.extend(lint_paths(args.paths or ["src/repro_torch"],
                             root=args.root))

    text = report.render(verbose=args.verbose)
    print(text)
    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            fh.write(text + "\n")

    ok = report.ok
    if args.stale_baseline_check:
        stale = report.stale_baseline()
        for entry in stale:
            print(f"stale baseline entry: {entry.rule} {entry.path} {entry.match!r}")
        ok = ok and not stale
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
