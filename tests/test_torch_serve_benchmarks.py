"""The port's serving benchmarks against the reference's:
``repro_torch.benchmarks.serve_node`` (continuous against static batching)
and ``batched_solve`` (per-sample, vmap-of-solo and lockstep solving), and
the latency statistics they report.

On CPU tensors the two NODE engines serve the reference's trace round for
round. One request of the quick trace (id 9, rtol 1e-5, horizon 4.0)
takes 21 trials in the port and 23 in the reference: its error estimate
sits at rounding level in one chunk (ROADMAP queue 3), so the sim-clock
rows of the whole trace differ by those trials. On the prefix before it,
where every request's trials agree, the rows are the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_batched_solve as jbatched
from benchmarks import bench_serve_node as jserve
from benchmarks import common as jcommon
from repro.core import odeint as jodeint
from repro_torch.benchmarks import batched_solve, common, serve_node

SERVE_ROWS = ["serve_node/continuous_p50", "serve_node/continuous_p99",
              "serve_node/static_p50", "serve_node/static_p99",
              "serve_node/p99_ratio", "serve_node/throughput_continuous",
              "serve_node/throughput_static", "serve_node/parity_worst"]

# the one request of the quick trace whose trial count is not the
# reference's: (id, port trials, reference trials)
ROUNDING_REQUEST = (9, 21, 23)


@pytest.mark.parametrize("n", [1, 2, 7, 24])
def test_latency_summary_is_the_reference(n):
    xs = np.random.default_rng(n).exponential(3.0, n).tolist()
    assert common.latency_summary(xs) == jcommon.latency_summary(xs)
    for q in (0.0, 37.5, 99.0, 100.0):
        assert common.percentile(xs, q) == jcommon.percentile(xs, q)
    with pytest.raises(ValueError):
        common.latency_summary([])


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "pallas"])
def test_serve_node_gates_on_cpu(use_pallas):
    out = serve_node.run(quick=True, device="cpu", use_pallas=use_pallas)
    assert [k for k in out if "/" in k] == SERVE_ROWS
    assert out["serve_node/p99_ratio"] >= serve_node.MIN_P99_RATIO
    assert out["serve_node/parity_worst"] < 1.0
    host = out["host"]
    assert len(host["continuous_round_ms"]) > 0
    assert host["static_drain_s"] > 0.0


@pytest.fixture(scope="module")
def quick_trace():
    return (jserve._traffic(np.random.default_rng(0), 24),
            serve_node.traffic(np.random.default_rng(0), 24))


def test_serve_node_trace_is_the_reference(quick_trace):
    jtrace, ttrace = quick_trace
    for (ja, jr), (ta, tr) in zip(jtrace, ttrace):
        assert (ja, jr.t0, jr.t1, jr.rtol, jr.atol) == \
            (ta, tr.t0, tr.t1, tr.rtol, tr.atol)
        assert np.array_equal(jr.z0, tr.z0)


@pytest.mark.parametrize("static", [False, True],
                         ids=["continuous", "static"])
def test_serve_node_rounds_match_reference_engine(static, quick_trace):
    jtrace, ttrace = quick_trace
    rid, port_trials, ref_trials = ROUNDING_REQUEST
    je, jres = jserve._serve(jtrace, static)
    te, tres, _, _ = serve_node.serve(ttrace, static, "cpu")
    assert te.admission_log == je.admission_log
    assert te.occupancy_log == je.occupancy_log
    assert [r.status for r in tres] == [r.status for r in jres]
    assert [r.n_chunks for r in tres] == [r.n_chunks for r in jres]
    got = [r.n_trials for r in tres]
    want = [r.n_trials for r in jres]
    assert (got[rid], want[rid]) == (port_trials, ref_trials)
    got[rid] = want[rid]
    assert got == want
    # the prefix before the rounding-level request: every trial count
    # agrees, so the sim-clock rows are the reference's
    jp, tp = jtrace[:rid], ttrace[:rid]
    je, jres = jserve._serve(jp, static)
    te, tres, _, _ = serve_node.serve(tp, static, "cpu")
    assert [r.n_trials for r in tres] == [r.n_trials for r in jres]
    assert te.clock.now == je.clock.now
    assert common.latency_summary([r.latency for r in tres]) == \
        jcommon.latency_summary([r.latency for r in jres])


def test_serve_node_trace_under_mali_matches_reference_engine(quick_trace):
    """MALI's engine on the quick trace: the reference's statuses, trials
    and sim clock; the three rtol-1e-5 requests whose first chunk needs
    more accepted ALF steps than the 64-slot grid holds end with
    CHECKPOINT_OVERFLOW in both."""
    from repro.serve import NodeEngineConfig as JEngineConfig
    from repro.serve import NodeServeEngine as JEngine
    from repro_torch.core import SolveStatus

    jtrace, ttrace = quick_trace
    je = JEngine(jserve._field, jserve.DIM, (jnp.float32(serve_node.W),),
                 JEngineConfig(slots=4, chunk_dt=0.5, grad_method="mali"))
    for arrival, req in jtrace:
        je.submit(req, arrival=arrival)
    jres = je.run()
    te, tres, _, _ = serve_node.serve(ttrace, False, "cpu",
                                      grad_method="mali")
    assert [r.status for r in tres] == [r.status for r in jres]
    assert [r.n_trials for r in tres] == [r.n_trials for r in jres]
    assert te.clock.now == je.clock.now
    over = [r.req_id for r in tres
            if r.status == SolveStatus.CHECKPOINT_OVERFLOW]
    assert over == [9, 19, 22]
    assert {ttrace[i][1].rtol for i in over} == {1e-5}


def test_batched_solve_on_cpu_matches_reference_steps():
    out = batched_solve.run(quick=True, device="cpu")
    steps = out["n_steps"]
    assert steps["per_sample"] == steps["vmap_solo"]
    assert len(set(steps["per_sample"])) > 1
    assert len(set(steps["lockstep"])) == 1
    for name in ("per_sample", "vmap_solo", "lockstep"):
        for row in ("fwd_s", "grad_s", "sample_evals"):
            assert f"batched_solve_{row}/{name}" in out
    # the reference's solves on the same numpy arrays
    w, z0 = batched_solve.inputs(8, 16)
    ts = np.array([0.0, 1.0], np.float32)
    kw = dict(solver="dopri5", rtol=1e-5, atol=1e-5, max_steps=128,
              grad_method="aca")
    _, st = jodeint(jbatched._f, z0, ts, (w,), batch_axis=0, **kw)
    assert np.asarray(st.n_steps).tolist() == steps["per_sample"]

    def fb(t, zb, w):
        import jax
        return jax.vmap(lambda z: jbatched._f(t, z, w))(zb)

    _, st_l = jodeint(fb, z0, ts, (w,), **kw)
    assert [int(st_l.n_steps)] == steps["lockstep"]


def test_batched_solve_inputs_are_seeded():
    w0, z0 = batched_solve.inputs(4, 6, seed=3)
    w1, z1 = batched_solve.inputs(4, 6, seed=3)
    assert np.array_equal(w0, w1) and np.array_equal(z0, z1)
    assert np.array_equal(z0[:, -1], np.linspace(0.0, 3.0, 4,
                                                 dtype=np.float32))
    assert torch.is_tensor(batched_solve.field(
        torch.tensor(0.0), torch.from_numpy(z0[0]), torch.from_numpy(w0)))
