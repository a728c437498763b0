"""Rehearse chip_smoke.py's ``serve_dense_lms`` phase on the CPU at SMOKE
width.

    PYTHONPATH=src python3 tests/torch_dense_rehearsal.py

Runs the phase's code as chip_smoke.py holds it, with "cuda" -> "cpu",
each config's ``CONFIG`` -> its ``SMOKE``, ``DENSE_CALLS`` shrunk to 3 x
40 + 6 and 2 x 24 + 4, the ``torch.cuda`` memory calls stubbed,
``time_ms`` running its function once and returning 0 (a CPU time is no
card's), every config's bf16 logit bound set to ``LOGIT_BF16_RTOL`` (the
card's bounds are measured at full width) and ``check`` logging. On CPU
tensors the kernel wrappers run their plain versions and count no
launch, so the launch checks are the only ones that may fail here; it
exits 1 if any other does. About 10 s.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SUBS = (
    ('"cuda"', '"cpu"'),
    ('import_module(f"repro_torch.configs.{arch}").CONFIG',
     'import_module(f"repro_torch.configs.{arch}").SMOKE'),
    ('DENSE_CALLS = {"A": (4, 4096, 32), "B": (2, 1000, 16)}',
     'DENSE_CALLS = {"A": (3, 40, 6), "B": (2, 24, 4)}'),
)


def rehearse(patch=setattr) -> list:
    """Run the phase as the module docstring says; returns the failed
    checks' messages. ``patch(obj, name, value)`` stubs ``torch.cuda``
    (a test passes ``monkeypatch.setattr``)."""
    sys.path.insert(0, str(ROOT / "src"))
    src = (ROOT / "chip_smoke.py").read_text()
    for old, new in SUBS:
        if old not in src:
            raise RuntimeError(f"chip_smoke.py no longer holds {old!r}")
        src = src.replace(old, new)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        patch(torch.cuda, name, lambda *a, **k: None)
    for name in ("max_memory_allocated", "memory_allocated"):
        patch(torch.cuda, name, lambda *a, **k: 0)
    g = {"__name__": "chip_smoke_rehearsal",
         "__file__": str(ROOT / "chip_smoke.py")}
    exec(compile(src, "chip_smoke.py", "exec"), g)
    logged = []

    def check(cond, what):
        if not cond:
            logged.extend(what.split("; "))

    g["check"] = check
    g["time_ms"] = lambda torch, fn, iters=30, warmup=5, prep=None: (
        fn(), 0.0)[1]
    g["DENSE_LOGIT_BF16_RTOL"] = {a: g["LOGIT_BF16_RTOL"]
                                  for a in g["DENSE_ARCHS"]}
    g["phase_serve_dense_lms"](torch, 0)
    return logged


def main() -> int:
    logged = rehearse()
    other = [w for w in logged if "launches" not in w]
    print(f"rehearsal: {len(logged)} checks logged, "
          f"{len(logged) - len(other)} of them launch counts", flush=True)
    for w in other:
        print("FAILED:", w, flush=True)
    return 1 if other else 0


if __name__ == "__main__":
    sys.exit(main())
