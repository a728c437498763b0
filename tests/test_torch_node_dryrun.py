"""The port's NODE dry run (``launch/node_dryrun.py``) against the
reference's golden test (``tests/test_node_dryrun.py``) and its solves.

The two cells of the reference's test — train with the adjoint and serve
with ACA, batch 16, dim 8 — run on 8 gloo ranks, spawned once for the
file (``tests/torch_node_dryrun_ranks.py``). Each report must carry the
keys of ``tests/golden/torch_node_dryrun_keys.json`` (the reference's
keys, plus the port's measured solve time, device, kernel and collective
counts) with finite counts and terms; a healthy solve (all rows OK,
trips >= 1, evaluations > 0) entered through a data-dependent trial loop
(``dynamic_whiles`` >= 1); never collective-bound; the adjoint train
cell's args cotangent crossing ranks in an all-reduce, the serve cell
with none. The trials each row took and the evaluations in all equal the
reference's mesh-less batched solve (``batch_axis=0``) of the same numpy
problem, as the per-row controllers make them; every rank reports the
same gathered stats.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
CELLS = (("train", "adjoint"), ("serve", "aca"))
WORLD, BATCH, DIM = 8, 16, 8


def _reference_stats(method):
    import jax.numpy as jnp

    from repro.core import odeint as jodeint
    from repro.launch.node_dryrun import _field as jfield
    from repro_torch.launch.node_dryrun import node_problem

    z0, ts, w = node_problem(BATCH, DIM)
    _, st = jodeint(jfield, jnp.asarray(z0), jnp.asarray(ts),
                    (jnp.asarray(w),), grad_method=method, solver="dopri5",
                    rtol=1e-4, atol=1e-4, max_steps=512, batch_axis=0)
    return np.asarray(st.n_trials), np.asarray(st.nfe)


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    out = tmp_path_factory.mktemp("node_dryrun_ranks")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_node_dryrun_ranks.py"),
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        reference = {m: _reference_stats(m) for _, m in CELLS}
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    errs = "".join(p.read_text() for p in sorted(out.glob("*.err")))
    assert proc.returncode == 0, (stdout[-2000:], stderr[-4000:], errs)
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    return ranks, reference


def _finite(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool) \
        and x == x and abs(x) != float("inf")


def test_node_dryrun_reports_match_golden(reports):
    ranks, _ = reports
    train, serve = ranks[0]
    with open(ROOT / "tests" / "golden" / "torch_node_dryrun_keys.json") \
            as fh:
        golden = json.load(fh)
    for rep in (train, serve):
        for k in golden["report"]:
            assert k in rep, (rep["cell"], k)
        for k in golden["measured"]:
            assert k in rep["measured"], (rep["cell"], k)
        for k in golden["hlo_static"]:
            assert _finite(rep["hlo_static"][k]), (rep["cell"], k)
        for k in golden["roofline_finite"]:
            assert _finite(rep["roofline"][k]), (rep["cell"], k)
        assert rep["n_devices"] == WORLD
        assert rep["measured"]["all_ok"] is True
        assert rep["measured"]["while_trips_straggler"] >= 1
        assert rep["measured"]["nfe_total"] > 0
        assert rep["hlo_static"]["dynamic_whiles"] >= 1
        assert 0 < rep["hlo_static"]["flops_body_once"] \
            < rep["roofline"]["flops_per_device"]
        assert rep["collective_bound"] is False
    assert train["roofline"]["coll_by_kind"].get("all-reduce", 0) > 0, \
        train["roofline"]["coll_by_kind"]
    assert serve["roofline"]["coll_by_kind"].get("all-reduce", 0) == 0, \
        serve["roofline"]["coll_by_kind"]


@pytest.mark.parametrize("cell", range(len(CELLS)))
def test_measured_trials_and_nfe_equal_reference(reports, cell):
    ranks, reference = reports
    trials, nfe = reference[CELLS[cell][1]]
    for r in range(WORLD):
        m = ranks[r][cell]["measured"]
        assert m["trials_per_element_min"] == int(trials.min()), r
        assert m["trials_per_element_max"] == int(trials.max()), r
        assert m["nfe_total"] == int(nfe.sum()), r
        assert m == {**ranks[0][cell]["measured"],
                     "solve_ms": m["solve_ms"]}
    # the straggler's trips: the most trials a row of any shard took
    per_shard = trials.reshape(WORLD, BATCH // WORLD).max(axis=1)
    assert ranks[0][cell]["measured"]["while_trips_straggler"] \
        == int(per_shard.max())
