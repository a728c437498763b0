"""The serving property test on the port, mirroring
``tests/test_serve_node_properties.py`` with a parametrised grid drawn once
from a numpy seed in place of hypothesis: random request mixes (gradient
method × tolerance × horizon) served by the continuous-batching engine.

On every case the port's engine and the reference's serve identical
requests, and the port is held to the reference request by request: the
same status, chunk count and trial count. Every request that ends OK lies
within the chunked-parity bound (docs/serving.md) of the port's one-shot
``batch_axis=0`` solve over its whole horizon, and of the reference's.

The grid holds the reference property's failing example: mali, one
request, seed 0, rtol 1e-5, horizon 0.4. The engine's solves keep a
64-slot grid (``max_steps=64``), and ALF is a second-order pair: at 1e-5
the first chunk needs more accepted steps than the grid holds, so the
request ends with ``CHECKPOINT_OVERFLOW`` after 64 trials, in the port as
in the reference. The configuration stays the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_serve_node as jref
from repro.core import odeint as jodeint
from repro.serve import NodeEngineConfig as JEngineConfig
from repro.serve import NodeRequest as JRequest
from repro.serve import NodeServeEngine as JEngine
from repro.serve import augment_field as jaugment_field
from repro_torch.core import SolveStatus, odeint
from repro_torch.serve import (
    NodeEngineConfig,
    NodeRequest,
    NodeServeEngine,
    augment_field,
    augment_state,
)
from test_torch_serve_node import ARGS, DIM, _parity_bound, _z0, field

MAX_REQ = 5
H_CHOICES = (0.4, 0.8, 1.3, 2.1)
TOL_CHOICES = (1e-3, 1e-4, 1e-5)
N_DRAWN = 6

# the reference property's failing example
FAILING = ("mali", (0,), ((1e-5, 0.4),))


def _draw_cases(seed: int = 25, n_cases: int = N_DRAWN):
    """(method, seeds, (tol, horizon) per request) for each case, drawn
    once, as the reference's hypothesis strategies draw them."""
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n_cases):
        method = str(rng.choice(["aca", "mali"]))
        n = int(rng.integers(1, MAX_REQ + 1))
        seeds = tuple(int(s) for s in rng.integers(0, 2 ** 16 + 1, n))
        mix = tuple((float(rng.choice(TOL_CHOICES)),
                     float(rng.choice(H_CHOICES))) for _ in range(n))
        cases.append((method, seeds, mix))
    return cases + [FAILING]


CASES = _draw_cases()


def _case_id(case):
    method, seeds, mix = case
    return f"{method}-n{len(seeds)}-" + "-".join(
        f"{tol:g}@{h:g}" for tol, h in mix)


@pytest.fixture(scope="module")
def engines():
    def cfg(method):
        return dict(slots=4, chunk_dt=0.5, grad_method=method)

    return {m: (NodeServeEngine(field, DIM, ARGS,
                                NodeEngineConfig(**cfg(m)), device="cpu"),
                JEngine(jref.field, DIM, jref.ARGS, JEngineConfig(**cfg(m))))
            for m in ("aca", "mali")}


@pytest.fixture(scope="module")
def ref_solves():
    """The one-shot vmap-of-solo solves, port and reference, over the
    padded (MAX_REQ, DIM + 2) canonical batch."""
    jfa = jaugment_field(jref.field)
    jts = jnp.asarray([0.0, 1.0], jnp.float32)

    @jax.jit
    def jsolve(Z, rt, at):
        ys, stats = jodeint(jfa, Z, jts, jref.ARGS, rtol=rt, atol=at,
                            batch_axis=0, max_steps=256)
        return ys[-1], stats.status

    fa = augment_field(field)

    def tsolve(Z, rt, at):
        with torch.no_grad():
            ys, stats = odeint(fa, torch.from_numpy(Z), [0.0, 1.0], ARGS,
                               rtol=torch.from_numpy(rt),
                               atol=torch.from_numpy(at), batch_axis=0,
                               max_steps=256)
        return ys[-1].numpy(), stats.status.numpy()

    def both(Z, rt, at):
        jy, jst = jsolve(jnp.asarray(Z), jnp.asarray(rt), jnp.asarray(at))
        return (tsolve(Z, rt, at), (np.asarray(jy), np.asarray(jst)))

    return both


def test_grid_holds_the_reference_failing_example():
    assert FAILING in CASES
    assert len(CASES) == N_DRAWN + 1


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_random_request_mix_matches_reference_engine(case, engines,
                                                     ref_solves):
    method, seeds, mix = case
    port, ref = engines[method]
    port.reset()
    ref.reset()
    reqs = []
    for i, ((tol, horizon), seed) in enumerate(zip(mix, seeds)):
        req = dict(z0=_z0(seed), t1=horizon, rtol=tol, atol=tol * 1e-2)
        reqs.append(NodeRequest(**req))
        port.submit(reqs[-1], arrival=0.3 * i)
        ref.submit(JRequest(**req), arrival=0.3 * i)
    res_t = {r.req_id: r for r in port.run()}
    res_j = {r.req_id: r for r in ref.run()}
    assert port.admission_log == ref.admission_log
    for i in range(len(reqs)):
        a, b = res_t[i], res_j[i]
        assert (a.status, a.n_chunks, a.n_trials) == \
            (b.status, b.n_chunks, b.n_trials), (i, reqs[i])

    if case == FAILING:
        # a 64-slot grid cannot hold ALF's second-order steps at 1e-5
        assert res_t[0].status == SolveStatus.CHECKPOINT_OVERFLOW
        assert res_t[0].n_trials == 64 and res_t[0].n_chunks == 1

    Z = np.zeros((MAX_REQ, DIM + 2), np.float32)
    rt = np.full((MAX_REQ,), 1e-3, np.float32)
    at = np.full((MAX_REQ,), 1e-3, np.float32)
    for i, req in enumerate(reqs):
        Z[i] = augment_state(torch.from_numpy(req.z0), req.t0,
                             req.t1 - req.t0).numpy()
        rt[i], at[i] = req.rtol, req.atol
    (ty, tst), (jy, jst) = ref_solves(Z, rt, at)
    assert (tst[:len(reqs)] == SolveStatus.OK).all()
    assert (jst[:len(reqs)] == SolveStatus.OK).all()
    for i, req in enumerate(reqs):
        if not res_t[i].ok:
            continue
        for one_shot in (ty, jy):
            err = np.abs(res_t[i].z_final - one_shot[i, :DIM]).max()
            assert err <= _parity_bound(res_t[i], req, one_shot[i, :DIM]), (
                i, req.rtol, req.t1, err)
