"""Analysis of the port's solver stack (``solver-lint``).

The counterpart of ``repro.analysis``. Two layers prove the invariants the
runtime tests only sample:

* ``analysis/rules.py`` runs every registered entry-point configuration
  (``analysis/entry_points.py``, the reference's 37) on small tensors of a
  chosen device under a ``graph_walk.Recorder`` and checks residual
  budgets, collective placement, the dtype contract and the host reads per
  loop.
* ``analysis/ast_lint.py`` lints the port's source for bare asserts, host
  reads in the engine modules, direct collectives and registry drift.

Run ``python -m repro_torch.analysis [--device cpu|cuda]`` (the run layer)
and ``python -m repro_torch.tools.solver_lint src/repro_torch`` (the AST
layer); both honor the port's baseline file
``src/repro_torch/analysis/solver_lint_baseline.json``.
"""

import os

from .findings import BaselineEntry, Finding, Report, load_baseline
from .entry_points import MATRIX, SolveConfig, config_names, get_config
from .rules import analyze_config, analyze_matrix, static_residual_bytes
from .ast_lint import lint_file, lint_paths

#: the port's baseline: every suppressed finding with its justification
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "solver_lint_baseline.json")

__all__ = [
    "BASELINE_PATH",
    "BaselineEntry",
    "Finding",
    "Report",
    "load_baseline",
    "MATRIX",
    "SolveConfig",
    "config_names",
    "get_config",
    "analyze_config",
    "analyze_matrix",
    "static_residual_bytes",
    "lint_file",
    "lint_paths",
]
