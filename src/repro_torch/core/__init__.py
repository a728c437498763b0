"""repro_torch.core — the solver of the port.

Mirrors ``repro.core``: tableaus → controller → stepper → integrate →
odeint_{aca,adjoint,naive,mali} → api (with the solve-health policies and
the fallback ladder), plus the NODE block.
"""

from .api import (
    GRAD_METHODS,
    ON_FAILURE_POLICIES,
    DenseSolution,
    SolveFailedError,
    default_fallback_ladder,
    odeint,
    odeint_checked,
    odeint_dense,
    odeint_final,
    solve_with_fallback,
)
from .controller import ControllerConfig
from .integrate import (
    Checkpoints,
    MaliGrid,
    SolveStats,
    SolveStatus,
    adaptive_while_solve,
    batched_adaptive_while_solve,
    batched_mali_adaptive_solve,
    fixed_grid_solve,
    make_fixed_grid,
    mali_adaptive_solve,
    resolve_checkpoint_segments,
)
from .node_block import NodeConfig, node_block_apply
from .odeint_aca import odeint_aca, odeint_aca_batched, odeint_aca_fixed
from .odeint_adjoint import (
    odeint_adjoint,
    odeint_adjoint_batched,
    odeint_adjoint_fixed,
)
from .odeint_mali import odeint_mali, odeint_mali_batched
from .odeint_naive import (
    odeint_naive,
    odeint_naive_batched,
    odeint_naive_fixed,
)
from .stepper import ALF_ORDER, InterpCoeffs, alf_step, alf_step_inverse
from .tableaus import ADAPTIVE_SOLVERS, FIXED_SOLVERS, Tableau, get_tableau

__all__ = [
    "ADAPTIVE_SOLVERS",
    "ALF_ORDER",
    "Checkpoints",
    "ControllerConfig",
    "DenseSolution",
    "FIXED_SOLVERS",
    "GRAD_METHODS",
    "InterpCoeffs",
    "MaliGrid",
    "NodeConfig",
    "ON_FAILURE_POLICIES",
    "SolveFailedError",
    "SolveStats",
    "SolveStatus",
    "Tableau",
    "adaptive_while_solve",
    "alf_step",
    "alf_step_inverse",
    "batched_adaptive_while_solve",
    "batched_mali_adaptive_solve",
    "default_fallback_ladder",
    "fixed_grid_solve",
    "get_tableau",
    "make_fixed_grid",
    "mali_adaptive_solve",
    "node_block_apply",
    "odeint",
    "odeint_aca",
    "odeint_aca_batched",
    "odeint_aca_fixed",
    "odeint_adjoint",
    "odeint_adjoint_batched",
    "odeint_adjoint_fixed",
    "odeint_checked",
    "odeint_dense",
    "odeint_final",
    "odeint_mali",
    "odeint_mali_batched",
    "odeint_naive",
    "odeint_naive_batched",
    "odeint_naive_fixed",
    "resolve_checkpoint_segments",
    "solve_with_fallback",
]
