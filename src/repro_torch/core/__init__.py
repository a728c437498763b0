"""repro_torch.core — the solver of the port.

Mirrors ``repro.core``: tableaus → controller → stepper → integrate →
odeint_{aca,adjoint,naive} → api, plus the NODE block.
"""

from .api import (
    GRAD_METHODS,
    ON_FAILURE_POLICIES,
    DenseSolution,
    odeint,
    odeint_dense,
    odeint_final,
)
from .controller import ControllerConfig
from .integrate import (
    Checkpoints,
    SolveStats,
    SolveStatus,
    fixed_grid_solve,
    make_fixed_grid,
    resolve_checkpoint_segments,
)
from .node_block import NodeConfig, node_block_apply
from .odeint_aca import odeint_aca, odeint_aca_batched, odeint_aca_fixed
from .odeint_adjoint import (
    odeint_adjoint,
    odeint_adjoint_batched,
    odeint_adjoint_fixed,
)
from .odeint_naive import (
    odeint_naive,
    odeint_naive_batched,
    odeint_naive_fixed,
)
from .stepper import InterpCoeffs
from .tableaus import ADAPTIVE_SOLVERS, FIXED_SOLVERS, Tableau, get_tableau

__all__ = [
    "ADAPTIVE_SOLVERS",
    "Checkpoints",
    "ControllerConfig",
    "DenseSolution",
    "FIXED_SOLVERS",
    "GRAD_METHODS",
    "InterpCoeffs",
    "NodeConfig",
    "ON_FAILURE_POLICIES",
    "SolveStats",
    "SolveStatus",
    "Tableau",
    "fixed_grid_solve",
    "get_tableau",
    "make_fixed_grid",
    "node_block_apply",
    "odeint",
    "odeint_aca",
    "odeint_aca_batched",
    "odeint_aca_fixed",
    "odeint_adjoint",
    "odeint_adjoint_batched",
    "odeint_adjoint_fixed",
    "odeint_dense",
    "odeint_final",
    "odeint_naive",
    "odeint_naive_batched",
    "odeint_naive_fixed",
    "resolve_checkpoint_segments",
]
