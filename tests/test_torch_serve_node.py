"""The port's per-row tolerances and ``NodeServeEngine``, mirroring
``tests/test_serve_node.py`` (everything but MALI and the LM engine).

Everything runs on simulated time (``SimClock``) with seeded numpy
traffic, on the CPU (``device="cpu"``), where the kernels run their plain
versions.

* Per-row (B,) rtol/atol: the reference's named ValueErrors; equal
  tolerance rows ≡ the scalar solve and mixed rows ≡ uniform batches, bit
  for bit inside the port, on both stepper paths.
* The engine: augmentation, queue and clock, solo parity within the
  reference's ``_parity_bound``, the golden admission trace, QoS bitwise
  isolation, replay, deadlines, retry, static waves, failure isolation.
* Port engine against reference engine on one seeded trace: the same
  admission log, per-request ``n_trials`` and ``status``, and ``z_final``
  within 1e-5 relative (the reference's chunk solve is jitted, the port's
  eager: they round differently, ROADMAP queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import odeint as jodeint
from repro.serve import NodeEngineConfig as JEngineConfig
from repro.serve import NodeRequest as JRequest
from repro.serve import NodeServeEngine as JEngine
from repro_torch.core import SolveStatus
from repro_torch.core import odeint
from repro_torch.serve import (
    STATUS_DEADLINE_MISS,
    NodeEngineConfig,
    NodeRequest,
    NodeServeEngine,
    RequestQueue,
    SimClock,
    augment_field,
    augment_state,
)

DIM = 6
W = 1.3
ARGS = (torch.tensor(W),)


def field(t, z, w):
    return torch.tanh(w * z) - 0.1 * z * torch.sin(t)


def field_j(t, z, w):
    return jnp.tanh(w * z) - 0.1 * z * jnp.sin(t)


def faulty(f, t_ge):
    """``f`` returning NaN from time ``t_ge`` on (vmap-safe)."""
    def wrapped(t, z, *args):
        out = f(t, z, *args)
        return torch.where(t >= t_ge, torch.full_like(out, float("nan")),
                           out)
    return wrapped


def _z0(seed, n=1):
    z = np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)
    return z[0] if n == 1 else z


def _parity_bound(res, req, ref):
    """The reference's chunked-serving parity bound (docs/serving.md)."""
    return (res.n_chunks + 1) * (
        req.atol + req.rtol * max(1.0, float(np.abs(ref).max())))


def _engine(f=field, **cfg):
    return NodeServeEngine(f, DIM, ARGS, NodeEngineConfig(**cfg),
                           device="cpu")


@pytest.fixture(scope="module")
def _eng_default():
    return _engine(slots=4, chunk_dt=0.5)


@pytest.fixture
def eng(_eng_default):
    _eng_default.reset()
    return _eng_default


@pytest.fixture
def eng_static():
    return _engine(slots=2, chunk_dt=0.5, static_batch=True)


# ------------------------------------------------- per-row tolerance core

class TestRowTolerances:
    TS = [0.0, 0.8]

    def _batch(self, B=4, seed=0):
        return torch.tensor(_z0(seed, B))

    def test_rowtol_requires_batch_axis(self):
        with pytest.raises(ValueError, match="per-element"):
            odeint(field, self._batch()[0], self.TS, ARGS,
                   rtol=torch.full((4,), 1e-4))

    def test_rowtol_rank2_raises(self):
        with pytest.raises(ValueError, match="rank-1"):
            odeint(field, self._batch(), self.TS, ARGS,
                   rtol=torch.full((4, 1), 1e-4), batch_axis=0)

    def test_rowtol_wrong_length_raises(self):
        with pytest.raises(ValueError, match="one entry per batch row"):
            odeint(field, self._batch(), self.TS, ARGS,
                   rtol=torch.full((3,), 1e-4), batch_axis=0)

    def test_rowtol_fixed_solver_raises(self):
        # grad_method="aca": the port's naive method raises for its slice
        # first
        with pytest.raises(ValueError, match="adaptive"):
            odeint(field, self._batch(), self.TS, ARGS, solver="rk4",
                   rtol=torch.full((4,), 1e-4), batch_axis=0)

    def test_rowtol_mesh_raises(self):
        with pytest.raises(ValueError, match="mesh"):
            odeint(field, self._batch(), self.TS, ARGS,
                   rtol=torch.full((4,), 1e-4), batch_axis=0,
                   mesh=object())

    @pytest.mark.parametrize("use_pallas", [False, True],
                             ids=["pytree", "pallas"])
    def test_equal_rowtol_bitwise_matches_scalar(self, use_pallas):
        """(B,) tensors of one tolerance == the scalar solve, bit for bit:
        K5's form and K4's compute the same f32 arithmetic."""
        z = self._batch()
        kw = dict(use_pallas=use_pallas, batch_axis=0)
        ys_s, st_s = odeint(field, z, self.TS, ARGS, rtol=1e-4, atol=1e-6,
                            **kw)
        ys_r, st_r = odeint(field, z, self.TS, ARGS,
                            rtol=torch.full((4,), 1e-4),
                            atol=torch.full((4,), 1e-6), **kw)
        assert torch.equal(ys_s, ys_r)
        assert torch.equal(st_s.n_trials, st_r.n_trials)

    @pytest.mark.parametrize("use_pallas", [False, True],
                             ids=["pytree", "pallas"])
    def test_mixed_rowtol_rows_match_uniform_batches(self, use_pallas):
        """Row b of a mixed-tolerance batch is bit-identical to row b of the
        all-that-tolerance batch: rows never interact."""
        z = self._batch()
        tols = [1e-3, 1e-4, 1e-5, 1e-6]
        atols = [1e-5, 1e-6, 1e-7, 1e-8]
        kw = dict(use_pallas=use_pallas, batch_axis=0)
        ys_mix, st_mix = odeint(field, z, self.TS, ARGS,
                                rtol=torch.tensor(tols),
                                atol=torch.tensor(atols), **kw)
        trials = st_mix.n_trials.numpy()
        for b, (tol, atol) in enumerate(zip(tols, atols)):
            ys_u, st_u = odeint(field, z, self.TS, ARGS, rtol=tol, atol=atol,
                                **kw)
            assert torch.equal(ys_mix[:, b], ys_u[:, b]), (b, tol)
            assert trials[b] == int(st_u.n_trials[b])
        assert trials[0] < trials[-1]

    def test_mixed_rowtol_matches_reference(self):
        """The same mixed-tolerance batch through the reference: equal
        per-row trials, outputs within 1e-5."""
        z = _z0(0, 4)
        tols = np.asarray([1e-3, 1e-4, 1e-5, 1e-5], np.float32)
        ys_t, st_t = odeint(field, torch.tensor(z), self.TS, ARGS,
                            rtol=torch.tensor(tols), atol=1e-6, batch_axis=0)
        ys_j, st_j = jodeint(field_j, jnp.asarray(z),
                             jnp.asarray(self.TS, jnp.float32),
                             (jnp.float32(W),), rtol=jnp.asarray(tols),
                             atol=1e-6, batch_axis=0)
        np.testing.assert_array_equal(st_t.n_trials.numpy(),
                                      np.asarray(st_j.n_trials))
        np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j),
                                   rtol=1e-5, atol=1e-6)

    def test_rowtol_grad_finite(self):
        z = self._batch().requires_grad_()
        ys, _ = odeint(field, z, self.TS, ARGS,
                       rtol=torch.tensor([1e-3, 1e-4, 1e-5, 1e-6]),
                       atol=1e-7, batch_axis=0)
        torch.sum(ys[-1] ** 2).backward()
        assert torch.isfinite(z.grad).all()


# ------------------------------------------------- canonical augmentation

class TestAugmentation:
    def test_augment_state_layout(self):
        zaug = augment_state(torch.arange(3.0), 2.5, 0.5)
        assert zaug.shape == (5,)
        assert zaug.tolist() == [0, 1, 2, 2.5, 0.5]

    def test_augment_field_matches_physical_window(self):
        z0 = torch.tensor(_z0(3))
        t_off, delta = 1.2, 0.7
        ys, st = odeint(augment_field(field), augment_state(z0, t_off, delta),
                        [0.0, 1.0], ARGS, rtol=1e-6, atol=1e-8)
        ys_p, _ = odeint(field, z0, [t_off, t_off + delta], ARGS, rtol=1e-6,
                         atol=1e-8)
        assert int(st.status) == SolveStatus.OK
        np.testing.assert_allclose(ys[-1][:DIM].numpy(), ys_p[-1].numpy(),
                                   atol=1e-4)

    def test_augment_aux_components_exactly_constant(self):
        zaug = augment_state(torch.tensor(_z0(4)), 1.2, 0.7)
        ys, _ = odeint(augment_field(field), zaug, [0.0, 1.0], ARGS,
                       rtol=1e-4, atol=1e-6)
        out = ys[-1].numpy()
        assert out[DIM] == np.float32(1.2)
        assert out[DIM + 1] == np.float32(0.7)

    def test_empty_slot_is_identity(self):
        zaug = augment_state(torch.zeros(DIM), 0.0, 0.0)
        ys, st = odeint(augment_field(field), zaug, [0.0, 1.0], ARGS,
                        rtol=1e-3, atol=1e-3)
        assert torch.equal(ys[-1], torch.zeros(DIM + 2))
        assert int(st.status) == SolveStatus.OK


# ------------------------------------------------------ queue/clock/model

class TestQueueAndClock:
    def test_queue_fifo_within_arrival(self):
        q = RequestQueue()
        r = NodeRequest(z0=np.zeros(DIM, np.float32))
        ids = [q.push(1.0, r), q.push(1.0, r), q.push(0.5, r)]
        order = [q.pop_ready(10.0)[1] for _ in range(3)]
        assert order == [ids[2], ids[0], ids[1]]

    def test_queue_pop_ready_respects_arrival(self):
        q = RequestQueue()
        q.push(5.0, NodeRequest(z0=np.zeros(DIM, np.float32)))
        assert q.pop_ready(4.9) is None
        assert q.next_arrival() == 5.0
        assert q.pop_ready(5.0) is not None
        assert len(q) == 0

    def test_simclock_round_cost(self):
        c = SimClock(trial_cost=2.0, chunk_overhead=3.0)
        assert c.advance_round(5) == 13.0
        assert c.now == 13.0
        c.jump_to(10.0)
        assert c.now == 13.0
        c.jump_to(20.0)
        assert c.now == 20.0

    def test_request_validation(self):
        z = np.zeros(DIM, np.float32)
        with pytest.raises(ValueError, match="t1 > t0"):
            NodeRequest(z0=z, t0=1.0, t1=1.0)
        with pytest.raises(ValueError, match="on_failure"):
            NodeRequest(z0=z, on_failure="explode")
        with pytest.raises(ValueError, match="h0"):
            NodeRequest(z0=z, h0=0.0)

    def test_config_validation(self):
        with pytest.raises(ValueError, match="slots"):
            NodeEngineConfig(slots=0)
        with pytest.raises(ValueError, match="chunk_dt"):
            NodeEngineConfig(chunk_dt=0.0)
        with pytest.raises(ValueError, match="slice F"):
            NodeEngineConfig(grad_method="mali")
        with pytest.raises(ValueError, match="slice B"):
            NodeEngineConfig(grad_method="adjoint")

    def test_submit_shape_check(self, eng):
        with pytest.raises(ValueError, match="shape"):
            eng.submit(NodeRequest(z0=np.zeros(DIM + 1, np.float32)))

    def test_engine_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NodeServeEngine(field, DIM, ARGS)


# --------------------------------------------------------- engine serving

class TestEngineServing:
    def test_single_request_matches_solo_odeint(self, eng):
        req = NodeRequest(z0=_z0(10), t0=0.0, t1=1.3, rtol=1e-5, atol=1e-7)
        eng.submit(req, arrival=0.0)
        res = eng.run()
        assert len(res) == 1 and res[0].ok
        ys, _ = odeint(field, torch.tensor(req.z0), [0.0, 1.3], ARGS,
                       rtol=1e-5, atol=1e-7)
        ref = ys[-1].numpy()
        assert np.abs(res[0].z_final - ref).max() <= _parity_bound(
            res[0], req, ref)

    def test_drain_returns_every_request(self, eng):
        for i in range(7):
            eng.submit(NodeRequest(z0=_z0(i), t1=0.5 + 0.25 * i),
                       arrival=float(i))
        res = eng.run()
        assert [r.req_id for r in res] == list(range(7))
        assert all(r.ok for r in res)
        assert all(r.t_finished >= r.t_admitted >= r.t_arrival for r in res)

    def test_admission_log_pins_slot_swap_order(self, eng):
        """The reference's golden slot-swap trace."""
        for i, h in enumerate([0.5, 2.0, 0.5, 0.5, 0.5, 0.5]):
            eng.submit(NodeRequest(z0=_z0(i), t1=h), arrival=0.0)
        res = eng.run()
        assert all(r.ok for r in res)
        assert eng.admission_log[:4] == [(0, 0, 0), (0, 1, 1), (0, 2, 2),
                                         (0, 3, 3)]
        assert eng.admission_log[4:] == [(1, 0, 4), (1, 2, 5)]

    def test_qos_bitwise_isolation(self, eng):
        victim = NodeRequest(z0=_z0(20), t1=1.6, rtol=1e-3, atol=1e-5)
        eng.submit(victim, arrival=0.0)
        solo = eng.run()[0]
        eng.reset()
        eng.submit(victim, arrival=0.0)
        for j in range(3):
            eng.submit(NodeRequest(z0=_z0(21 + j), t1=2.0, rtol=1e-6,
                                   atol=1e-8), arrival=0.0)
        mixed = [r for r in eng.run() if r.req_id == 0][0]
        assert np.array_equal(solo.z_final, mixed.z_final)
        assert solo.n_trials == mixed.n_trials

    def test_deterministic_replay(self, eng):
        def trace(e):
            for i in range(6):
                e.submit(NodeRequest(z0=_z0(30 + i), t1=0.5 + 0.3 * i,
                                     rtol=10.0 ** -(3 + i % 3)),
                         arrival=1.7 * i)
            return e.run()
        a = trace(eng)
        log_a = list(eng.admission_log)
        eng.reset()
        b = trace(eng)
        assert log_a == eng.admission_log
        assert [r.latency for r in a] == [r.latency for r in b]
        assert all(np.array_equal(x.z_final, y.z_final) for x, y in zip(a, b))

    def test_continuous_beats_static_tail_latency(self, eng):
        eng2 = _engine(slots=4, chunk_dt=0.5, static_batch=True)
        reqs = [NodeRequest(z0=_z0(40), t1=4.0)] + [
            NodeRequest(z0=_z0(41 + i), t1=0.5) for i in range(7)]
        for e in (eng, eng2):
            for i, r in enumerate(reqs):
                e.submit(r, arrival=0.5 * i)
        lat_c = sorted(r.latency for r in eng.run())
        lat_s = sorted(r.latency for r in eng2.run())
        assert lat_c[-1] < lat_s[-1]
        assert sum(lat_c) < sum(lat_s)

    def test_static_mode_admits_only_full_waves(self, eng_static):
        for i in range(5):
            eng_static.submit(NodeRequest(z0=_z0(50 + i), t1=1.0),
                              arrival=0.0)
        res = eng_static.run()
        assert all(r.ok for r in res)
        rounds = [rd for (rd, _, _) in eng_static.admission_log]
        assert rounds[0] == rounds[1]
        assert rounds[2] == rounds[3]
        assert rounds[2] > rounds[1]
        assert max(eng_static.occupancy_log) <= 2

    def test_deadline_expired_in_queue_dropped(self):
        e = _engine(slots=1, chunk_dt=0.5)
        e.submit(NodeRequest(z0=_z0(60), t1=3.0, rtol=1e-6), arrival=0.0)
        e.submit(NodeRequest(z0=_z0(61), t1=1.0, deadline=5.0), arrival=0.0)
        res = e.run()
        assert res[0].ok
        assert res[1].status == STATUS_DEADLINE_MISS
        assert not res[1].ok and res[1].deadline_missed
        assert res[1].n_chunks == 0

    def test_deadline_late_completion_flagged(self, eng):
        eng.submit(NodeRequest(z0=_z0(62), t1=2.0, deadline=3.0),
                   arrival=0.0)
        r = eng.run()[0]
        assert r.status == SolveStatus.OK
        assert r.deadline_missed and not r.ok
        assert np.isfinite(r.z_final).all()

    def test_failure_isolated_to_faulty_request(self):
        """A NaN-poisoned request freezes with its own status while its
        batch-mates finish bitwise as in a run without it."""
        e1 = _engine(f=faulty(field, 10.2), slots=4, chunk_dt=0.5)
        e1.submit(NodeRequest(z0=_z0(70), t0=10.0, t1=11.0), arrival=0.0)
        for j in range(3):
            e1.submit(NodeRequest(z0=_z0(71 + j), t1=1.0), arrival=0.0)
        res = e1.run()
        assert res[0].status == SolveStatus.NONFINITE_STATE
        assert not res[0].ok and np.isfinite(res[0].z_final).all()
        e1.reset()
        for j in range(3):
            e1.submit(NodeRequest(z0=_z0(71 + j), t1=1.0), arrival=0.0)
        clean = e1.run()
        for j in range(3):
            assert np.array_equal(res[1 + j].z_final, clean[j].z_final)
            assert res[1 + j].ok

    def test_on_failure_retry_succeeds_at_loosened_tol(self):
        e = _engine(slots=2, retry_tol_factor=1e6)
        e.submit(NodeRequest(z0=_z0(80), t1=1.0, rtol=1e-12, atol=1e-14,
                             on_failure="retry"), arrival=0.0)
        r = e.run()[0]
        assert r.ok and r.retried and r.status == SolveStatus.OK

    def test_on_failure_retry_gives_up_after_one_retry(self):
        e = _engine(f=faulty(field, 0.0), slots=2)
        e.submit(NodeRequest(z0=_z0(81), t1=1.0, on_failure="retry"),
                 arrival=0.0)
        r = e.run()[0]
        assert r.retried and not r.ok
        assert r.status == SolveStatus.NONFINITE_STATE

    def test_all_requests_failing_still_drains(self):
        e = _engine(f=faulty(field, 0.0), slots=2)
        for i in range(4):
            e.submit(NodeRequest(z0=_z0(82 + i), t1=1.0), arrival=0.0)
        res = e.run()
        assert len(res) == 4
        assert all(not r.ok for r in res)
        assert all(np.isfinite(r.z_final).all() for r in res)

    def test_empty_engine_run_is_empty(self, eng):
        assert eng.run() == []

    def test_request_h0_changes_first_step(self, eng):
        eng.submit(NodeRequest(z0=_z0(90), t1=0.5, rtol=1e-4), arrival=0.0)
        r_auto = eng.run()[0]
        eng.reset()
        eng.submit(NodeRequest(z0=_z0(90), t1=0.5, rtol=1e-4, h0=1e-4),
                   arrival=0.0)
        r_tiny = eng.run()[0]
        assert r_auto.ok and r_tiny.ok
        assert r_tiny.n_trials > r_auto.n_trials

    def test_pallas_engine_serves(self):
        e = _engine(slots=2, use_pallas=True)
        e.submit(NodeRequest(z0=_z0(92), t1=1.0), arrival=0.0)
        r = e.run()[0]
        assert r.ok and np.isfinite(r.z_final).all()


# ------------------------------------------- port engine against reference

def _trace(seed=7, n=10):
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(2.0, n))
    out = []
    for i in range(n):
        out.append(dict(z0=rng.standard_normal(DIM).astype(np.float32),
                        t1=float(rng.choice([0.5, 1.0, 1.5])),
                        rtol=float(rng.choice([1e-3, 1e-4])),
                        atol=1e-6, arrival=float(arrivals[i])))
    return out


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["pytree", "pallas"])
def test_engine_matches_reference_engine(use_pallas):
    """One seeded trace through the reference engine and the port's: the
    same admission log, per-request trials and status, and z_final within
    1e-5 relative."""
    from repro.kernels import ops as jops
    trace = _trace()
    jops.set_interpret(True)
    try:
        je = JEngine(field_j, DIM, (jnp.float32(W),),
                     JEngineConfig(slots=3, chunk_dt=0.5,
                                   use_pallas=use_pallas))
        for r in trace:
            je.submit(JRequest(z0=r["z0"], t1=r["t1"], rtol=r["rtol"],
                               atol=r["atol"]), arrival=r["arrival"])
        res_j = je.run()
    finally:
        jops.set_interpret(None)
    te = _engine(slots=3, chunk_dt=0.5, use_pallas=use_pallas)
    for r in trace:
        te.submit(NodeRequest(z0=r["z0"], t1=r["t1"], rtol=r["rtol"],
                              atol=r["atol"]), arrival=r["arrival"])
    res_t = te.run()
    assert te.admission_log == je.admission_log
    assert [r.n_trials for r in res_t] == [r.n_trials for r in res_j]
    assert [r.status for r in res_t] == [r.status for r in res_j]
    for a, b in zip(res_t, res_j):
        assert np.abs(a.z_final - b.z_final).max() <= 1e-5 * max(
            1.0, np.abs(b.z_final).max())
