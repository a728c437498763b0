"""repro_torch.core — the solver of the port (slice A: solo adaptive ACA).

Mirrors ``repro.core``: tableaus → controller → stepper → integrate →
odeint_aca → api, plus the NODE block.
"""

from .api import GRAD_METHODS, ON_FAILURE_POLICIES, odeint, odeint_final
from .controller import ControllerConfig
from .integrate import Checkpoints, SolveStats, SolveStatus
from .node_block import NodeConfig, node_block_apply
from .tableaus import ADAPTIVE_SOLVERS, FIXED_SOLVERS, Tableau, get_tableau

__all__ = [
    "ADAPTIVE_SOLVERS",
    "Checkpoints",
    "ControllerConfig",
    "FIXED_SOLVERS",
    "GRAD_METHODS",
    "NodeConfig",
    "ON_FAILURE_POLICIES",
    "SolveStats",
    "SolveStatus",
    "Tableau",
    "get_tableau",
    "node_block_apply",
    "odeint",
    "odeint_final",
]
