"""Continuous-depth (NODE) block: the paper's ResNet → NODE transformation.

Port of ``repro/core/node_block.py``. A residual block ``y = x + f(x, θ)``
becomes ``z(1) = z(0) + ∫₀¹ f(z(t), θ) dt`` with the same parameters,
solved with the configured solver — adaptive, or a fixed grid of
``steps_per_interval`` steps of the pair's advancing method — and
differentiated with ACA, the adjoint, the naive method or MALI (the ALF
pair integrator, adaptive only). The parameters reach the solve as
``args``, so the backward returns their gradients.
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
    rtol=atol=1e-2). ``regime="fixed"`` integrates ``steps_per_interval``
    uniform steps with the advancing method of ``solver``
    (``_fixed_solver_for``). ``grad_method="mali"`` integrates with the
    ALF pair stepper whatever ``solver`` says, and rejects the fixed
    regime. ``on_failure`` is one of ``odeint``'s policies. ``mesh`` (a
    ``DeviceMesh``, with ``batch_axis``) shards the block's batched solve
    over the mesh's data dims, and ``shard_rules`` overrides which dims
    those are (``odeint``'s sharded solve).
    """
    enabled: bool = False
    solver: str = "heun_euler"      # the paper trains with HeunEuler
    grad_method: str = "aca"
    rtol: float = 1e-2              # paper Appendix D: rtol=atol=1e-2
    atol: float = 1e-2
    max_steps: int = 32
    steps_per_interval: int = 4     # fixed-grid regime
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
    block_fn: Callable[[Dict[str, torch.Tensor], Any,
                        torch.Tensor], Any],
    params: Dict[str, torch.Tensor],
    z0: Any,
    cfg: NodeConfig,
) -> Any:
    """z(t1) = z(t0) + ∫ f(z, t; θ) dt with ACA, adjoint, naive or MALI
    gradients.

    ``block_fn(params, z, t) -> dz/dt`` must keep z's structure, shapes
    and dtype; ``params`` (e.g. ``dict(module.named_parameters())``) is
    passed to the solve as ``args``.
    """
    return node_block_solve(block_fn, params, z0, cfg)[0]


def node_block_solve(
    block_fn: Callable[[Dict[str, torch.Tensor], Any,
                        torch.Tensor], Any],
    params: Dict[str, torch.Tensor],
    z0: Any,
    cfg: NodeConfig,
    group: Optional[Any] = None,
) -> Tuple[Any, SolveStats]:
    """``node_block_apply`` that also returns the solve's ``SolveStats``.
    ``group`` (a ``distributed.regions.SolveGroup``) declares ``z0`` this
    rank's block of a state split over ranks (``odeint``'s ``group``): a
    NODE block on ``RunConfig.mesh``."""
    if cfg.regime not in ("adaptive", "fixed"):
        raise ValueError(
            f"NodeConfig.regime must be 'adaptive' or 'fixed'; got "
            f"{cfg.regime!r}")
    if cfg.grad_method == "mali" and cfg.regime == "fixed":
        raise ValueError(
            "NodeConfig(grad_method='mali', regime='fixed'): the "
            "reversible pair integrator is adaptive-only — use "
            "regime='adaptive', or a fixed RK grid with aca/adjoint/"
            "naive for static pod-scale schedules")

    def f(t, z, p):
        return block_fn(p, z, t)

    common = dict(grad_method=cfg.grad_method, use_pallas=cfg.use_pallas,
                  batch_axis=cfg.batch_axis,
                  # threaded so a segmented config on the fixed regime
                  # raises the api's error instead of being ignored
                  checkpoint_segments=cfg.checkpoint_segments,
                  on_failure=cfg.on_failure, mesh=cfg.mesh,
                  shard_rules=cfg.shard_rules)
    if group is not None:
        common["group"] = group
    if cfg.regime == "fixed":
        return odeint_final(f, z0, cfg.t0, cfg.t1, (params,),
                            solver=_fixed_solver_for(cfg.solver),
                            steps_per_interval=cfg.steps_per_interval,
                            **common)
    # mali pairs only with the ALF pair integrator: the RK solver name of
    # the config does not apply to it
    solver = "alf" if cfg.grad_method == "mali" else cfg.solver
    return odeint_final(f, z0, cfg.t0, cfg.t1, (params,), solver=solver,
                        rtol=cfg.rtol, atol=cfg.atol,
                        max_steps=cfg.max_steps, **common)


def _fixed_solver_for(name: str) -> str:
    """Map an adaptive pair to its advancing fixed-step method."""
    return {
        "heun_euler": "rk2",
        "heuneuler": "rk2",
        "bosh3": "rk2",
        "rk23": "rk2",
        "dopri5": "rk4",
        "rk45": "rk4",
    }.get(name.lower().replace("-", "_"), name)
