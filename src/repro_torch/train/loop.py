"""Fault-tolerant training loop.

Port of ``repro/train/loop.py``:

* ``build_train_step`` — one train step: microbatch gradient accumulation
  in f32, clipping by the global norm, optional int8 or top-k gradient
  compression (error feedback carried in the loop), the optimizer update
  (AdamW or SGD), and the skip-step guard: a non-finite loss or raw
  gradient norm holds the parameters, the optimizer state and the
  compression state (the step counter still advances) and counts the
  skip in ``metrics["skipped"]``;
* checkpoint/restart — ``CheckpointManager`` saves every ``ckpt_every``
  steps and a new loop resumes from the latest valid checkpoint; the
  step-indexed data pipeline makes a resume exact;
* straggler watch — an EMA of the step's wall time; a step slower than
  ``straggler_factor`` x the EMA calls the hook.

The reference jits one step and donates the state. The port runs the step
eagerly: gradients by ``torch.autograd.grad`` on fresh leaves of the
parameters, and the guard's selects are ``torch.where`` on the device,
with no read back to the host. On a mesh the parameters, gradients and
optimizer moments are DTensors (each gradient brought to its parameter's
placements); the loss and metrics are plain tensors, the same on every
rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.ckpt import CheckpointManager
from repro_torch.distributed.regions import is_dtensor, tree_context
from repro_torch.optim.adamw import Optimizer, apply_updates
from repro_torch.optim.grad_utils import (CompressionState,
                                          clip_by_global_norm,
                                          init_compression_state,
                                          int8_compress_decompress,
                                          topk_sparsify)

from .state import TrainState


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    microbatches: int = 1
    clip_norm: float = 1.0
    compression: str = "none"      # none | int8 | topk
    topk_frac: float = 0.01
    ckpt_every: int = 100
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10
    # skip-step guard: a non-finite loss or raw gradient norm (a poisoned
    # NODE solve, an overflow) holds params and optimizer state and counts
    # the skip in metrics instead of applying a NaN update
    skip_nonfinite: bool = True


def _split_microbatches(batch: Dict[str, torch.Tensor], m: int):
    def split(x):
        b = x.shape[0]
        if b % m != 0:
            raise ValueError(
                f"batch size {b} not divisible by {m} microbatches")
        return x.reshape((m, b // m) + tuple(x.shape[1:]))

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(m)]


def _grads_of(model, params, batch):
    """(loss, metrics, grads) of ``model.loss_fn`` at ``params``; the
    metrics detached, a leaf that the loss does not reach gets zeros."""
    leaves, spec = pytree.tree_flatten(params)
    live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
    with torch.enable_grad(), tree_context(params):
        loss, metrics = model.loss_fn(pytree.tree_unflatten(live, spec),
                                      batch)
        wrt = [p for p in live if p.requires_grad]
        got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
    grads = []
    for p in live:
        g = next(got) if p.requires_grad else None
        if g is None:
            g = torch.zeros_like(p)
        elif is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        grads.append(g)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, pytree.tree_unflatten(grads, spec)


def build_train_step(model, opt: Optimizer, cfg: TrainLoopConfig
                     ) -> Callable:
    """Returns train_step(state, batch, comp_state) -> (state, comp_state,
    metrics). ``model`` is anything with ``loss_fn(params, batch) ->
    (loss, metrics)``."""

    def step(state: TrainState, batch, comp_state: CompressionState):
        with tree_context(state.params):
            return _step(state, batch, comp_state)

    def _step(state: TrainState, batch, comp_state: CompressionState):
        comp_in = comp_state
        if cfg.microbatches > 1:
            gsum, lsum = None, None
            for mb in _split_microbatches(batch, cfg.microbatches):
                loss, _, grads = _grads_of(model, state.params, mb)
                g32 = pytree.tree_map(lambda g: g.float(), grads)
                gsum = g32 if gsum is None else pytree.tree_map(
                    torch.add, gsum, g32)
                lsum = loss if lsum is None else lsum + loss
            grads = pytree.tree_map(lambda g: g / cfg.microbatches, gsum)
            loss = lsum / cfg.microbatches
            metrics = {"ce_loss": loss}
        else:
            loss, metrics, grads = _grads_of(model, state.params, batch)

        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        if cfg.compression == "int8":
            grads, comp_state = int8_compress_decompress(grads, comp_state)
        elif cfg.compression == "topk":
            grads, comp_state = topk_sparsify(grads, cfg.topk_frac,
                                              comp_state)

        updates, opt_state = opt.update(grads, state.opt_state,
                                        state.params)
        params = apply_updates(state.params, updates)
        metrics = dict(metrics)
        if cfg.skip_nonfinite:
            # a non-finite loss or raw grad norm means this update is
            # garbage: hold params, optimizer and compression state (the
            # step counter still advances, so training cannot spin on one
            # poisoned batch) and surface the skip. clip_by_global_norm
            # zeroed the grads on a bad norm, so the update is finite
            # either way; the selects make the skip exact.
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)

            def sel(new, old):
                return pytree.tree_map(
                    lambda n, o: torch.where(ok, n, o), new, old)

            params = sel(params, state.params)
            opt_state = sel(opt_state, state.opt_state)
            comp_state = sel(comp_state, comp_in)
            metrics["skipped"] = (~ok).to(torch.int32)
        new_state = TrainState(step=state.step + 1, params=params,
                               opt_state=opt_state)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return new_state, comp_state, metrics

    return step


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class TrainLoop:
    """Drives ``train_step`` with checkpoint/restart and a straggler
    watch."""

    def __init__(self, model, opt: Optimizer, cfg: TrainLoopConfig,
                 state: TrainState,
                 straggler_cb: Optional[Callable[[int, float], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.model, self.opt, self.cfg = model, opt, cfg
        self.state = state
        self._clock = clock
        self.comp_state = init_compression_state(state.params) \
            if cfg.compression != "none" else CompressionState(error=())
        self._step_fn = build_train_step(model, opt, cfg)
        self.straggler_cb = straggler_cb
        self.skipped_steps = 0      # total non-finite updates skipped
        self._ema_dt: Optional[float] = None
        self.manager = None
        if cfg.ckpt_dir:
            self.manager = CheckpointManager(cfg.ckpt_dir, cfg.keep_ckpts)
            restored = self.manager.restore(self.state)
            if restored is not None:
                _, self.state = restored

    @property
    def step(self) -> int:
        return int(self.state.step)

    def run(self, batch_fn: Callable[[int], Dict[str, Any]], n_steps: int,
            log_cb: Optional[Callable[[int, Dict], None]] = None):
        """Run until the global step reaches ``n_steps`` (resume-aware)."""
        metrics = {}
        while self.step < n_steps:
            s = self.step
            batch = batch_fn(s)
            t0 = self._clock()
            self.state, self.comp_state, metrics = self._step_fn(
                self.state, batch, self.comp_state)
            _sync(metrics["loss"])
            dt = self._clock() - t0
            if "skipped" in metrics:
                self.skipped_steps += int(metrics["skipped"])

            # straggler watch: EMA of the step time, flag outliers
            if self._ema_dt is None:
                self._ema_dt = dt
            else:
                if dt > self.cfg.straggler_factor * self._ema_dt \
                        and self.straggler_cb is not None:
                    self.straggler_cb(s, dt / self._ema_dt)
                self._ema_dt = 0.9 * self._ema_dt + 0.1 * dt

            if self.manager and (s + 1) % self.cfg.ckpt_every == 0:
                self.manager.save(s + 1, self.state)

            if log_cb and (s + 1) % self.cfg.log_every == 0:
                log_cb(s + 1, {k: float(v) for k, v in metrics.items()})
        return metrics
