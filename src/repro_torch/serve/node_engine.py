"""Continuous-batching NODE inference engine with per-request QoS.

Port of ``repro/serve/node_engine.py``. Serving a Neural ODE is unlike
serving a static network: each request is a *solve*, its cost is
data-dependent (the adaptive controller decides how many trials it
needs), and requests arrive with different horizons and accuracy
demands.

``NodeServeEngine`` coalesces queued solve requests into one batched
adaptive solve (``odeint(..., batch_axis=0)``) and advances the live
batch in fixed *time chunks*:

* **Per-row tolerances**: each slot passes its request's ``(rtol,
  atol)`` as one row of the (S,) tolerance tensors, so every request is
  error-controlled by its own controller (kernel K5 on the fused path).
  Rows never interact: a request's trajectory is bit-identical to the
  same request served alone.
* **Per-row ``h0``**: the engine always passes an explicit (S,) initial
  stepsize (the per-row Hairer heuristic, or the request's own ``h0`` on
  its first chunk), so admission order cannot perturb a neighbour.
* **Per-row ``SolveStatus``**: a poisoned or budget-exhausted row
  freezes and reports its code while neighbours integrate on; the engine
  retires the slot per the request's ``on_failure`` policy and admits the
  next queued request at the chunk boundary (slot swap).

Every chunk is solved as the *canonical* problem ``s ∈ [0, 1]`` over an
augmented per-row state ``[z, t_off, delta]`` with field ``dz/ds = delta
· f(t_off + s·delta, z)``: rows at different physical times and horizons
share one static-shape solve, and an empty slot is ``delta = 0``.

Time is *simulated*: a deterministic ``SimClock`` charges each round
``chunk_overhead + trial_cost · max_b(n_trials_b)``. The scheduling is
host-side numpy, as in the reference; the solves run on ``device``.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from ..core.api import odeint
from ..core.controller import initial_stepsize
from ..core.integrate import SolveStatus
from ..core.tableaus import get_tableau
from ..device import resolve_device

__all__ = [
    "STATUS_DEADLINE_MISS",
    "NodeRequest",
    "RequestResult",
    "RequestQueue",
    "NodeEngineConfig",
    "NodeServeEngine",
    "SimClock",
    "augment_field",
    "augment_state",
]

#: Engine-level status for a request whose deadline elapsed while it
#: was still queued (it is dropped unsolved). Distinct from every
#: solver-level ``SolveStatus`` code.
STATUS_DEADLINE_MISS = 100

_ON_FAILURE = ("status", "retry")

#: Defaults for an empty (padding) slot: delta = 0 makes the field
#: vanish, a loose tolerance and h0 = 1 land the row in one accepted
#: trial, so padding never dominates the round's straggler cost.
_EMPTY_RTOL = 1e-3
_EMPTY_ATOL = 1e-3
_EMPTY_H0 = 1.0


# ------------------------------------------------------------- augmentation

def augment_state(z, t_off, delta) -> torch.Tensor:
    """Pack one per-sample canonical-chunk state ``[z, t_off, delta]``.

    ``z`` is the (dim,) physical state, ``t_off`` the chunk's physical
    start time, ``delta`` its physical duration (0 for an empty slot).
    Both scalars ride as extra state components with zero derivative.
    """
    z = torch.as_tensor(z)
    aux = torch.tensor([t_off, delta], dtype=z.dtype, device=z.device)
    return torch.cat([z, aux])


def augment_field(f: Callable) -> Callable:
    """Canonical-chunk field over the augmented state of ``augment_state``.

    ``fa(s, zaug, *args)`` computes ``dz/ds = delta · f(t_off + s·delta,
    z)`` and zeros for the two aux components. Per-sample: the engine
    batches it via ``odeint(..., batch_axis=0)``. The field is evaluated
    on empty slots too (``z = 0, t = 0``); NaN·0 is NaN, so a field
    undefined at the origin must guard.
    """
    def fa(s, zaug, *args):
        z, t_off, delta = zaug[:-2], zaug[-2], zaug[-1]
        dz = delta * f(t_off + s * delta, z, *args)
        return torch.cat([dz, torch.zeros(2, dtype=zaug.dtype,
                                          device=zaug.device)])
    return fa


# ------------------------------------------------------------ request model

@dataclass
class NodeRequest:
    """One NODE solve request: integrate ``z0`` from ``t0`` to ``t1``.

    ``rtol``/``atol`` are the request's QoS knob. ``h0`` (physical time)
    overrides the first chunk's initial stepsize. ``deadline`` is an
    absolute sim-time bound: a request still queued past it is dropped
    (``STATUS_DEADLINE_MISS``); one that completes late is delivered with
    ``deadline_missed=True``. ``on_failure``: ``"status"`` delivers the
    frozen state and code, ``"retry"`` re-enqueues the request once from
    the failed chunk's start state at ``retry_tol_factor``× looser
    tolerances.
    """
    z0: Any
    t0: float = 0.0
    t1: float = 1.0
    rtol: float = 1e-4
    atol: float = 1e-6
    h0: Optional[float] = None
    deadline: Optional[float] = None
    on_failure: str = "status"
    tag: Optional[str] = None

    def __post_init__(self):
        if self.on_failure not in _ON_FAILURE:
            raise ValueError(
                f"on_failure must be one of {_ON_FAILURE}; "
                f"got {self.on_failure!r}")
        if not float(self.t1) > float(self.t0):
            raise ValueError(
                f"NodeRequest needs t1 > t0; got t0={self.t0}, "
                f"t1={self.t1} (reverse-time serving is not supported)")
        if self.h0 is not None and not float(self.h0) > 0.0:
            raise ValueError(f"h0 must be positive; got {self.h0}")


@dataclass
class RequestResult:
    """Delivered outcome of one request.

    ``status`` is the solver's ``SolveStatus`` code (or
    ``STATUS_DEADLINE_MISS``); ``ok`` means status OK *and* the deadline
    (if any) met. ``z_final`` is the state at ``t1`` (frozen last-good
    state on failure; the admission state for a queue-expired drop).
    Sim-time stamps: ``t_arrival`` → ``t_admitted`` → ``t_finished``.
    """
    req_id: int
    tag: Optional[str]
    z_final: np.ndarray
    status: int
    ok: bool
    deadline_missed: bool
    t_arrival: float
    t_admitted: float
    t_finished: float
    n_chunks: int
    n_trials: int
    retried: bool

    @property
    def latency(self) -> float:
        return self.t_finished - self.t_arrival


class RequestQueue:
    """FIFO admission queue keyed by (arrival sim-time, submit order)."""

    def __init__(self):
        self._heap: List[Tuple[float, int, int, NodeRequest]] = []
        self._seq = itertools.count()

    def push(self, arrival: float, req: NodeRequest,
             req_id: Optional[int] = None) -> int:
        seq = next(self._seq)
        rid = seq if req_id is None else req_id
        heapq.heappush(self._heap, (float(arrival), seq, rid, req))
        return rid

    def pop_ready(self, now: float):
        """Pop the earliest request with ``arrival <= now`` (or None)."""
        if self._heap and self._heap[0][0] <= now:
            arrival, _, rid, req = heapq.heappop(self._heap)
            return arrival, rid, req
        return None

    def next_arrival(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)


@dataclass
class _Slot:
    """One live batch row: the request it serves and its chunk cursor."""
    index: int
    active: bool = False
    req_id: int = -1
    req: Optional[NodeRequest] = None
    z: Optional[np.ndarray] = None     # physical state at ``tau``
    tau: float = 0.0                   # physical time reached so far
    t_arrival: float = 0.0
    t_admitted: float = 0.0
    n_chunks: int = 0
    n_trials: int = 0
    retried: bool = False
    first_chunk: bool = True           # request h0 applies only here


# ---------------------------------------------------------------- sim clock

class SimClock:
    """Deterministic cost model for the coalesced solve loop: one round
    costs ``chunk_overhead + trial_cost · max_b(n_trials_b)``."""

    def __init__(self, trial_cost: float, chunk_overhead: float):
        self.trial_cost = float(trial_cost)
        self.chunk_overhead = float(chunk_overhead)
        self.now = 0.0

    def advance_round(self, max_trials: int) -> float:
        dt = self.chunk_overhead + self.trial_cost * int(max_trials)
        self.now += dt
        return dt

    def jump_to(self, t: float) -> None:
        self.now = max(self.now, float(t))


# ------------------------------------------------------------------- config

@dataclass(frozen=True)
class NodeEngineConfig:
    """Static engine shape + solver + cost-model knobs.

    ``slots`` and ``chunk_dt`` fix the solve's shapes: every round solves
    a (slots, dim+2) canonical batch regardless of occupancy.
    ``static_batch=True`` is the baseline scheduler: admit only when *all*
    slots are free. ``grad_method`` is ``"aca"``; ``"mali"`` comes with
    slice F and the other methods with slice B.
    """
    slots: int = 4
    chunk_dt: float = 0.5
    solver: Optional[str] = None
    grad_method: str = "aca"
    use_pallas: bool = False
    max_steps: int = 64
    max_trials: int = 12
    static_batch: bool = False
    trial_cost: float = 1.0
    chunk_overhead: float = 2.0
    retry_tol_factor: float = 100.0

    def __post_init__(self):
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1; got {self.slots}")
        if not self.chunk_dt > 0.0:
            raise ValueError(f"chunk_dt must be > 0; got {self.chunk_dt}")
        if self.retry_tol_factor < 1.0:
            raise ValueError("retry_tol_factor must be >= 1; got "
                             f"{self.retry_tol_factor}")
        if self.grad_method == "mali":
            raise ValueError(
                "NodeEngineConfig(grad_method='mali') is not ported yet: "
                "it comes with slice F (ROADMAP queue 1)")
        if self.grad_method != "aca":
            raise ValueError(
                f"NodeEngineConfig(grad_method={self.grad_method!r}) is not "
                "ported yet: the adjoint and naive methods come with "
                "slice B (ROADMAP queue 1)")


# ------------------------------------------------------------------- engine

class NodeServeEngine:
    """Continuous-batching solve server over one vector field.

    ``f(t, z, *args)`` is the per-sample field (tensors in, tensor out,
    vmap-safe); ``dim`` the state size; ``args`` tensors on ``device``
    (default the card; a missing card raises). ``submit()`` enqueues
    requests at explicit arrival sim-times; ``run()`` drains the queue and
    returns every ``RequestResult``; ``step()`` advances one coalescing
    round (admission → chunk solve → retire/swap).
    """

    def __init__(self, f: Callable, dim: int, args: Tuple = (),
                 config: Optional[NodeEngineConfig] = None, *,
                 device="cuda"):
        self.cfg = config or NodeEngineConfig()
        self.device = resolve_device(device)
        self.f = f
        self.dim = int(dim)
        self.args = args
        self.clock = SimClock(self.cfg.trial_cost, self.cfg.chunk_overhead)
        self.queue = RequestQueue()
        self.slots = [_Slot(i) for i in range(self.cfg.slots)]
        self.results: Dict[int, RequestResult] = {}
        self.round = 0
        #: admission trace: (round, slot_index, req_id) per admission.
        self.admission_log: List[Tuple[int, int, int]] = []
        #: per-round live-row counts (occupancy under the traffic).
        self.occupancy_log: List[int] = []
        #: per-round max_b n_trials_b (the round's straggler trials).
        self.trials_log: List[int] = []
        self._fa = augment_field(f)
        self._order = get_tableau(self.cfg.solver or "dopri5").order
        self._ts = torch.tensor([0.0, 1.0], dtype=torch.float32,
                                device=self.device)

    def reset(self) -> None:
        """Clear all scheduler state (queue, slots, clock, results, logs)."""
        self.clock = SimClock(self.cfg.trial_cost, self.cfg.chunk_overhead)
        self.queue = RequestQueue()
        self.slots = [_Slot(i) for i in range(self.cfg.slots)]
        self.results = {}
        self.round = 0
        self.admission_log = []
        self.occupancy_log = []
        self.trials_log = []

    # -------------------------------------------------------------- solves

    @torch.no_grad()
    def _solve(self, Z, rt, at, h0):
        """One chunk: the canonical batched solve over s ∈ [0, 1]."""
        ys, stats = odeint(
            self._fa, Z, self._ts, self.args,
            solver=self.cfg.solver,
            grad_method=self.cfg.grad_method,
            rtol=rt, atol=at, h0=h0,
            max_steps=self.cfg.max_steps,
            max_trials=self.cfg.max_trials,
            use_pallas=self.cfg.use_pallas,
            batch_axis=0, on_failure="status")
        return ys[-1], stats.status, stats.n_trials

    @torch.no_grad()
    def _hinit(self, Z, rt, at):
        """Per-row Hairer starting step over the whole batch; vmapped, so
        each row's h0 depends only on its own state and tolerance."""
        s0 = self._ts[0]
        return vmap(lambda zaug, r, a: initial_stepsize(
            self._fa, s0, zaug, self.args, self._order, r, a))(Z, rt, at)

    # ---------------------------------------------------------- submission

    def submit(self, req: NodeRequest, arrival: Optional[float] = None,
               req_id: Optional[int] = None) -> int:
        """Enqueue ``req`` at sim-time ``arrival`` (default: now)."""
        z0 = req.z0
        if isinstance(z0, torch.Tensor):
            z0 = z0.detach().cpu().numpy()
        z0 = np.asarray(z0, np.float32)
        if z0.shape != (self.dim,):
            raise ValueError(
                f"request z0 must have shape ({self.dim},); "
                f"got {z0.shape}")
        req = replace(req, z0=z0)
        t = self.clock.now if arrival is None else float(arrival)
        return self.queue.push(t, req, req_id)

    # ----------------------------------------------------------- scheduling

    def _record(self, req_id: int, req: NodeRequest, *, z_final, status,
                t_arrival, t_admitted, n_chunks, n_trials, retried):
        now = self.clock.now
        missed = req.deadline is not None and now > float(req.deadline)
        self.results[req_id] = RequestResult(
            req_id=req_id, tag=req.tag,
            z_final=np.asarray(z_final, np.float32),
            status=int(status),
            ok=(int(status) == SolveStatus.OK) and not missed,
            deadline_missed=missed,
            t_arrival=float(t_arrival), t_admitted=float(t_admitted),
            t_finished=now, n_chunks=int(n_chunks),
            n_trials=int(n_trials), retried=bool(retried))

    def _admit(self) -> None:
        """Fill free slots from the queue (continuous), or only when the
        whole batch is free (static baseline). Queue-expired requests are
        dropped here with ``STATUS_DEADLINE_MISS``."""
        if self.cfg.static_batch and any(s.active for s in self.slots):
            return
        for slot in self.slots:
            if slot.active:
                continue
            while True:
                item = self.queue.pop_ready(self.clock.now)
                if item is None:
                    break
                arrival, rid, req = item
                if (req.deadline is not None
                        and self.clock.now > float(req.deadline)):
                    self._record(
                        rid, req, z_final=req.z0,
                        status=STATUS_DEADLINE_MISS,
                        t_arrival=arrival, t_admitted=self.clock.now,
                        n_chunks=0, n_trials=0, retried=False)
                    continue
                slot.active = True
                slot.req_id = rid
                slot.req = req
                slot.z = np.asarray(req.z0, np.float32)
                slot.tau = float(req.t0)
                slot.t_arrival = arrival
                slot.t_admitted = self.clock.now
                slot.n_chunks = 0
                slot.n_trials = 0
                # a re-enqueued retry keeps its flag
                slot.retried = getattr(req, "_retried", False)
                slot.first_chunk = True
                self.admission_log.append((self.round, slot.index, rid))
                break

    def _build_batch(self):
        """Assemble the (S, dim+2) canonical chunk batch + row tols/h0 on
        the engine's device."""
        S, D = self.cfg.slots, self.dim
        Z = np.zeros((S, D + 2), np.float32)
        rt = np.full((S,), _EMPTY_RTOL, np.float32)
        at = np.full((S,), _EMPTY_ATOL, np.float32)
        h0 = np.full((S,), _EMPTY_H0, np.float32)
        deltas = np.zeros((S,), np.float64)
        need_hinit = []
        for slot in self.slots:
            if not slot.active:
                continue
            req = slot.req
            delta = min(self.cfg.chunk_dt, float(req.t1) - slot.tau)
            deltas[slot.index] = delta
            Z[slot.index, :D] = slot.z
            Z[slot.index, D] = np.float32(slot.tau)
            Z[slot.index, D + 1] = np.float32(delta)
            rt[slot.index] = np.float32(req.rtol)
            at[slot.index] = np.float32(req.atol)
            if slot.first_chunk and req.h0 is not None:
                # request h0 is physical time; the canonical solve runs
                # over s ∈ [0, 1], so scale by 1/delta (clipped to one
                # whole chunk)
                h0[slot.index] = np.float32(
                    min(float(req.h0) / delta, 1.0))
            else:
                need_hinit.append(slot.index)
        dev = self.device
        Z, rt, at = (torch.from_numpy(x).to(dev) for x in (Z, rt, at))
        h0 = torch.from_numpy(h0).to(dev)
        if need_hinit:
            idx = torch.tensor(need_hinit, device=dev)
            h0[idx] = self._hinit(Z, rt, at).to(torch.float32)[idx]
        return Z, rt, at, h0, deltas

    def _retire(self, slot: _Slot, z_end_row, status: int,
                deltas) -> None:
        """Apply the chunk outcome to one slot: advance, complete, or swap
        out per the request's failure policy."""
        req = slot.req
        D = self.dim
        if status != SolveStatus.OK:
            if req.on_failure == "retry" and not slot.retried:
                # re-enqueue once from the failed chunk's *start* state at
                # loosened tolerances; arrival stays the original so the
                # latency accounting charges the retry
                fac = self.cfg.retry_tol_factor
                retry = replace(
                    req, z0=np.asarray(slot.z, np.float32),
                    t0=slot.tau,
                    rtol=float(req.rtol) * fac,
                    atol=float(req.atol) * fac,
                    h0=None)
                retry._retried = True
                self.queue.push(slot.t_arrival, retry,
                                req_id=slot.req_id)
            else:
                self._record(
                    slot.req_id, req, z_final=z_end_row[:D],
                    status=status, t_arrival=slot.t_arrival,
                    t_admitted=slot.t_admitted,
                    n_chunks=slot.n_chunks, n_trials=slot.n_trials,
                    retried=slot.retried)
            slot.active = False
            slot.req = None
            return
        slot.z = np.asarray(z_end_row[:D], np.float32)
        slot.tau = slot.tau + float(deltas[slot.index])
        slot.first_chunk = False
        horizon = float(req.t1) - float(req.t0)
        if slot.tau >= float(req.t1) - 1e-9 * max(1.0, abs(horizon)):
            self._record(
                slot.req_id, req, z_final=slot.z,
                status=SolveStatus.OK, t_arrival=slot.t_arrival,
                t_admitted=slot.t_admitted,
                n_chunks=slot.n_chunks, n_trials=slot.n_trials,
                retried=slot.retried)
            slot.active = False
            slot.req = None

    def step(self) -> bool:
        """One coalescing round. Returns False when fully drained."""
        self._admit()
        if not any(s.active for s in self.slots):
            nxt = self.queue.next_arrival()
            if nxt is None:
                return False
            self.clock.jump_to(nxt)
            self._admit()
            if not any(s.active for s in self.slots):
                # the queue held only expired-deadline requests
                return len(self.queue) > 0
        Z, rt, at, h0, deltas = self._build_batch()
        z_end, status, trials = self._solve(Z, rt, at, h0)
        z_end = z_end.cpu().numpy().astype(np.float32)
        status = status.cpu().numpy()
        trials = trials.cpu().numpy()
        live = [s for s in self.slots if s.active]
        self.occupancy_log.append(len(live))
        self.trials_log.append(int(trials.max()))
        self.clock.advance_round(int(trials.max()))
        for slot in live:
            slot.n_chunks += 1
            slot.n_trials += int(trials[slot.index])
        self.round += 1
        for slot in live:
            self._retire(slot, z_end[slot.index],
                         int(status[slot.index]), deltas)
        return True

    def run(self, max_rounds: int = 100_000) -> List[RequestResult]:
        """Drain the queue; returns results ordered by ``req_id``."""
        for _ in range(max_rounds):
            if not self.step():
                break
        else:
            raise RuntimeError(
                f"engine did not drain within {max_rounds} rounds")
        return [self.results[k] for k in sorted(self.results)]
