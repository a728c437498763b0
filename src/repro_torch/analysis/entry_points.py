"""Registered solver entry points for the port's analyzer.

The counterpart of ``repro/analysis/entry_points.py``, with its 37
configurations, names, shapes and residual budgets: 5 gradient setups
(aca full and segmented, adjoint, naive, mali) × {plain, pallas} ×
{solo, batched, mesh-sharded}, plus the documented ``on_failure="warn"``
site, the per-row tolerance (QoS) variants and the serving engine's
canonical chunk solve (``repro_torch.serve.node_engine.augment_field``).

The reference traces each configuration and never executes it; the port
**runs** it on small tensors of a chosen device, through the front door
a user calls (``repro_torch.core.odeint``), with z0 and w requiring
grad: the forward, whose outputs lead to the engine's
``autograd.Function`` node and its residuals, then ``sum(ys).backward()``,
where the backward sweeps' loops and the sharded solve's collectives run.
``pallas`` configurations take the kernel route (``use_pallas=True``):
on the card K1/K2 (solo) and K3/K4/K5 (batched) launch, on the CPU their
plain versions run. ``sharded`` configurations solve with
``mesh=shard_mesh()`` on a one-rank process group (gloo on the CPU, NCCL
on the card), which ``process_group`` starts when none is running.

Shapes keep the budget *discriminating*, as in the reference: the state
terms (``dim``-sized buffers) dominate the scalar grid and ``args``
bytes, so a rogue O(N·dim) buffer in MALI or segmented-ACA residuals
blows the gate rather than hiding in slack. The example arguments are
the reference's zeros, so every solve takes few steps; the buffers are
allocated at ``max_steps`` whatever the steps taken.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, replace
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .graph_walk import Recorder, ResidualInfo, engine_functions, residual_info


# ---------------------------------------------------------------------------
# configuration


@dataclass(frozen=True)
class SolveConfig:
    """One analyzable entry-point configuration."""

    name: str
    grad_method: str
    use_pallas: bool = False
    batched: bool = False
    sharded: bool = False
    segmented: bool = False
    on_failure: str = "status"
    #: per-row (batch,) rtol/atol tensors instead of scalars — the
    #: serving QoS path through the row-tol kernel K5
    row_tol: bool = False
    #: the serving engine's canonical chunk solve: the augmented
    #: [z, t_off, delta] field over s ∈ [0, 1] with explicit per-row h0
    serving: bool = False
    dim: int = 96
    batch: int = 8
    n_eval: int = 2
    max_steps: int = 64
    segments: int = 8

    def odeint_kwargs(self, device: str = "cpu") -> dict:
        kw: dict = dict(
            grad_method=self.grad_method,
            max_steps=self.max_steps,
            use_pallas=self.use_pallas,
            on_failure=self.on_failure,
        )
        if self.segmented:
            kw["checkpoint_segments"] = self.segments
        if self.batched:
            kw["batch_axis"] = 0
        if self.sharded:
            from repro_torch.distributed import shard_mesh

            kw["mesh"] = shard_mesh(torch.device(device).type)
        if self.row_tol:
            kw["rtol"] = torch.tensor(np.logspace(-3, -6, self.batch).astype(
                np.float32), device=device)
            kw["atol"] = torch.tensor(np.logspace(-5, -8, self.batch).astype(
                np.float32), device=device)
        if self.serving:
            kw["h0"] = torch.full((self.batch,), 0.05, dtype=torch.float32,
                                  device=device)
        return kw

    def example_args(self, device: str = "cpu"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        d = self.dim + 2 if self.serving else self.dim
        z_shape = (self.batch, d) if self.batched else (d,)
        z0 = torch.zeros(z_shape, dtype=torch.float32, device=device)
        w = torch.zeros((self.dim,), dtype=torch.float32, device=device)
        ts = torch.linspace(0.0, 1.0, self.n_eval, dtype=torch.float32,
                            device=device)
        return z0, w, ts

    def _solve_fn(self, device: str):
        from repro_torch.core.api import odeint

        kw = self.odeint_kwargs(device)

        def field_fn(t, z, w):
            return -(w * z)

        if self.serving:
            from repro_torch.serve.node_engine import augment_field

            field_fn = augment_field(field_fn)

        def solve(z0, w, ts):
            return odeint(field_fn, z0, ts, (w,), **kw)

        return solve

    def run(self, device: str = "cpu", backward: bool = True,
            inputs: Optional[Tuple[np.ndarray, np.ndarray]] = None
            ) -> "SolveRun":
        """Run the entry point under a ``Recorder``: the forward (z0 and w
        requiring grad), the engine nodes' residuals read before anything
        frees them, then (``backward``) ``sum(ys).backward()``.
        ``inputs`` = (z0, w) replaces the zero example values (same
        shapes, f32)."""
        z0, w, ts = self.example_args(device)
        if inputs is not None:
            z0, w = (torch.as_tensor(np.asarray(a, np.float32), device=device)
                     .reshape(x.shape) for a, x in zip(inputs, (z0, w)))
        z0.requires_grad_()
        w.requires_grad_()
        solve = self._solve_fn(device)
        t0 = time.perf_counter()
        with Recorder() as rec:
            ys, stats = solve(z0, w, ts)
            residuals = [residual_info(n) for n in engine_functions(ys)]
            if backward:
                ys.sum().backward()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        return SolveRun(self, residuals, rec, ys.detach(), stats,
                        (z0.grad, w.grad), time.perf_counter() - t0)

    def forward_run(self, device: str = "cpu") -> "SolveRun":
        """The forward alone: the engine node and its residuals visible."""
        return self.run(device, backward=False)

    # -- residual budget ----------------------------------------------------

    #: per-element dim-sized state slots each method may keep as residuals
    #: (the paper's memory claims, in slot units; the reference's table):
    #:   aca full       -> max_steps          (every accepted state)
    #:   aca segmented  -> 2 * K              (K z-snapshots + K k0-snapshots)
    #:   adjoint        -> n_eval             (only the outputs ys)
    #:   mali           -> 4                  (zT, vT, z0 + slack: O(1) in steps)
    #: naive has no engine-level Function (pure autograd tape) -> no budget.
    RESIDUAL_SLACK = 1.5
    GRID_BYTES_PER_STEP = 48  # scalar t/h/index grid allowance per accepted step

    def state_slots(self) -> Optional[int]:
        if self.grad_method == "aca":
            return 2 * self.segments if self.segmented else self.max_steps
        if self.grad_method == "adjoint":
            return self.n_eval
        if self.grad_method == "mali":
            return 4
        return None  # naive

    def residual_budget_bytes(self) -> Optional[int]:
        slots = self.state_slots()
        if slots is None:
            return None
        n_elem = self.batch if self.batched else 1
        state = slots * self.dim * 4  # f32
        grid = self.max_steps * self.GRID_BYTES_PER_STEP
        args_ts = self.dim * 4 + self.n_eval * 4 + 64
        return int(self.RESIDUAL_SLACK * n_elem * (state + grid) + args_ts + 4096)


@dataclass
class SolveRun:
    """One recorded run of a configuration."""

    config: SolveConfig
    residuals: List[ResidualInfo]
    recorder: Recorder
    ys: torch.Tensor
    stats: Any
    #: dL/dz0 and dL/dw of L = sum(ys) (None without the backward)
    grads: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]
    #: wall seconds of the run (the card synchronized at its end)
    seconds: float

    @property
    def residual_bytes(self) -> int:
        return sum(r.total_bytes for r in self.residuals)


@contextlib.contextmanager
def process_group(device: str = "cpu"):
    """A one-rank process group for the ``sharded`` configurations (gloo
    on the CPU, NCCL on the card), started here when none is running and
    destroyed on exit; an existing group is used as it is."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    from repro_torch.launch.mesh import free_port

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the matrix


def _base_configs() -> list:
    return [
        SolveConfig("aca-full", "aca"),
        SolveConfig("aca-seg", "aca", segmented=True),
        SolveConfig("adjoint", "adjoint"),
        SolveConfig("naive", "naive"),
        SolveConfig("mali", "mali"),
    ]


def build_matrix() -> list:
    """The full registered matrix (37 configs), in the reference's order."""
    out = []
    for base in _base_configs():
        for pallas in (False, True):
            tag = "-pallas" if pallas else ""
            solo = replace(base, name=f"{base.name}{tag}-solo", use_pallas=pallas)
            bat = replace(
                base, name=f"{base.name}{tag}-batched", use_pallas=pallas, batched=True
            )
            shd = replace(
                base,
                name=f"{base.name}{tag}-sharded",
                use_pallas=pallas,
                batched=True,
                sharded=True,
            )
            out.extend([solo, bat, shd])
    # the documented on_failure="warn" site: its one read of the status
    # lies outside every loop (the host-sync pass checks exactly this)
    out.append(SolveConfig("aca-full-warn", "aca", on_failure="warn"))
    # per-row tolerance (QoS) entry points: the serving stack's kernel
    # dispatch — the row-tol kernel K5, per-row error ratios and h0
    out.extend([
        SolveConfig("aca-full-rowtol-batched", "aca", batched=True,
                    row_tol=True),
        SolveConfig("aca-full-rowtol-pallas-batched", "aca",
                    use_pallas=True, batched=True, row_tol=True),
        SolveConfig("naive-rowtol-batched", "naive", batched=True,
                    row_tol=True),
        SolveConfig("mali-rowtol-batched", "mali", batched=True,
                    row_tol=True),
        # the serving engine's chunk solve: canonical s ∈ [0, 1] over
        # augmented [z, t_off, delta] rows, per-row tol + h0
        SolveConfig("serve-chunk", "aca", batched=True, row_tol=True,
                    serving=True),
        SolveConfig("serve-chunk-mali", "mali", batched=True,
                    row_tol=True, serving=True),
    ])
    return out


MATRIX = build_matrix()
_BY_NAME = {c.name: c for c in MATRIX}


def get_config(name: str) -> SolveConfig:
    if name not in _BY_NAME:
        raise KeyError(
            f"unknown analyzer config {name!r}; registered: {sorted(_BY_NAME)}"
        )
    return _BY_NAME[name]


def config_names() -> list:
    return [c.name for c in MATRIX]
