"""Validate the port's bench JSON artifacts against the schema of
``repro_torch.benchmarks.common.emit_json``.

Every ``BENCH_*.json`` file under the artifact directory (where a run with
``BENCH_ARTIFACT_DIR`` set appends them) must hold one JSON object per line
of the exact shape

    {"bench": <non-empty str>, "metrics": {<str>: <int|float|str>, ...}}

with a non-empty metrics mapping, finite numbers (no NaN/inf) and no
extra top-level keys:

    python -m repro_torch.tools.check_bench_schema [bench-artifacts]

Exits non-zero with one line per violation, and fails when the directory
holds no ``BENCH_*.json`` at all (an empty artifact upload would otherwise
look green).
"""

from __future__ import annotations

import json
import math
import pathlib
import sys


def check_line(where: str, line: str) -> list:
    errors = []
    try:
        obj = json.loads(line)
    except json.JSONDecodeError as e:
        return [f"{where}: not valid JSON ({e})"]
    if not isinstance(obj, dict) or set(obj) != {"bench", "metrics"}:
        return [f"{where}: top-level keys must be exactly "
                f"{{'bench', 'metrics'}}, got {sorted(obj)}"
                if isinstance(obj, dict) else f"{where}: not an object"]
    if not isinstance(obj["bench"], str) or not obj["bench"]:
        errors.append(f"{where}: 'bench' must be a non-empty string")
    metrics = obj["metrics"]
    if not isinstance(metrics, dict) or not metrics:
        return errors + [f"{where}: 'metrics' must be a non-empty object"]
    for key, val in metrics.items():
        if not isinstance(key, str) or not key:
            errors.append(f"{where}: metric name {key!r} is not a "
                          "non-empty string")
        # bools are ints in Python — exclude them explicitly
        if isinstance(val, bool) or not isinstance(val, (int, float, str)):
            errors.append(f"{where}: metric {key!r} has non-scalar value "
                          f"{val!r}")
        elif isinstance(val, float) and not math.isfinite(val):
            errors.append(f"{where}: metric {key!r} is not finite ({val})")
    return errors


def check_file(path: pathlib.Path) -> list:
    errors = []
    lines = [ln for ln in path.read_text().splitlines() if ln.strip()]
    if not lines:
        return [f"{path}: empty artifact file"]
    for lineno, line in enumerate(lines, 1):
        errors.extend(check_line(f"{path}:{lineno}", line))
    return errors


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    art_dir = pathlib.Path(argv[1] if len(argv) > 1 else "bench-artifacts")
    files = sorted(art_dir.glob("BENCH_*.json"))
    if not files:
        print(f"FAIL {art_dir}: no BENCH_*.json artifacts found")
        return 1
    errors = []
    for f in files:
        errors.extend(check_file(f))
    for e in errors:
        print(f"FAIL {e}")
    if errors:
        return 1
    print(f"bench schema OK ({len(files)} artifact files)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
