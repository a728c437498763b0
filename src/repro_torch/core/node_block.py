"""Continuous-depth (NODE) block: the paper's ResNet → NODE transformation.

Port of ``repro/core/node_block.py`` for the adaptive regime. A residual
block ``y = x + f(x, θ)`` becomes ``z(1) = z(0) + ∫₀¹ f(z(t), θ) dt`` with
the same parameters, solved with the configured solver and differentiated
with ACA. The parameters reach the solve as ``args``, so the ACA backward
returns their gradients.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .api import odeint_final
from .integrate import SolveStats


@dataclasses.dataclass(frozen=True)
class NodeConfig:
    """Solver/gradient configuration of one continuous-depth block.

    Defaults follow the paper's training setup (HeunEuler, ACA,
    rtol=atol=1e-2). The fields of later slices keep the reference's
    names and defaults; a non-default value raises in ``odeint`` (or
    here, for ``regime="fixed"``) naming the slice that brings it.
    """
    enabled: bool = False
    solver: str = "heun_euler"      # the paper trains with HeunEuler
    grad_method: str = "aca"
    rtol: float = 1e-2              # paper Appendix D: rtol=atol=1e-2
    atol: float = 1e-2
    max_steps: int = 32
    steps_per_interval: int = 4     # fixed-grid regime (slice B)
    regime: str = "adaptive"        # adaptive | fixed
    # integration window [t0, t1]; t0 > t1 runs the block in reverse time
    t0: float = 0.0
    t1: float = 1.0
    use_pallas: bool = False        # fused flat-state kernels K1/K2
    batch_axis: Optional[int] = None
    checkpoint_segments: Optional[Any] = None
    on_failure: str = "status"
    mesh: Optional[Any] = None
    shard_rules: Optional[Any] = None


def node_block_apply(
    block_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor,
                        torch.Tensor], torch.Tensor],
    params: Dict[str, torch.Tensor],
    z0: torch.Tensor,
    cfg: NodeConfig,
) -> torch.Tensor:
    """z(t1) = z(t0) + ∫ f(z, t; θ) dt with ACA gradients.

    ``block_fn(params, z, t) -> dz/dt`` must keep z's shape and dtype;
    ``params`` (e.g. ``dict(module.named_parameters())``) is passed to the
    solve as ``args``.
    """
    return node_block_solve(block_fn, params, z0, cfg)[0]


def node_block_solve(
    block_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor,
                        torch.Tensor], torch.Tensor],
    params: Dict[str, torch.Tensor],
    z0: torch.Tensor,
    cfg: NodeConfig,
) -> Tuple[torch.Tensor, SolveStats]:
    """``node_block_apply`` that also returns the solve's ``SolveStats``."""
    if cfg.regime == "fixed":
        raise ValueError(
            "NodeConfig(regime='fixed') is not ported yet: the fixed-grid "
            "regime comes with slice B (ROADMAP queue 1)")
    if cfg.regime != "adaptive":
        raise ValueError(
            f"NodeConfig.regime must be 'adaptive' or 'fixed'; got "
            f"{cfg.regime!r}")

    def f(t, z, p):
        return block_fn(p, z, t)

    return odeint_final(
        f, z0, cfg.t0, cfg.t1, (params,),
        solver=cfg.solver,
        grad_method=cfg.grad_method,
        rtol=cfg.rtol, atol=cfg.atol,
        max_steps=cfg.max_steps,
        use_pallas=cfg.use_pallas,
        batch_axis=cfg.batch_axis,
        checkpoint_segments=cfg.checkpoint_segments,
        on_failure=cfg.on_failure,
        mesh=cfg.mesh, shard_rules=cfg.shard_rules,
    )
