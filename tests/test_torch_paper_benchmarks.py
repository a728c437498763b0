"""The port's paper benchmarks (``repro_torch.benchmarks``) against the
reference's (``benchmarks/bench_*.py``) at tiny settings, on the CPU.

The reference's parameters reach the port through
``convert.tree_from_jax``; data are the reference's numpy-drawn arrays.
Bounds (each max |difference| / max |value| per tensor unless stated):

* classification (Table 2), forward and gradients for node (aca, adjoint,
  naive; HeunEuler at 1e-2, far above f32 rounding: the same grids) and
  discrete: logits and gradients 1e-5, loss 1e-6 absolute; three AdamW
  steps: the last loss 1e-6 and every parameter 1e-6 absolute (CPU runs
  agree to 1.2e-7 and 9e-8);
* solver robustness (Tables 6/7): the logits of the trained-solver read
  with every test-time solver within 1e-5, the predictions equal;
* reliability (Table 3): ``icc1`` and the pairwise agreement of a fixed
  matrix and prediction set, 1e-12;
* ``method_costs`` (Table 1) on the port's weights: accepted steps for
  every variant, trials and evaluations for aca, adjoint and aca_pallas,
  equal to the reference's; the naive row as ROADMAP queue 3 records it
  (the reference reports its whole budget, max_steps × max_trials ×
  stages; the port the trials it took × stages, within that budget);
* reverse error (Fig. 4/5): each row within a factor 2 of the
  reference's, either way (the reverse solve's drift is a difference of
  nearly equal trajectories, so the grids' rounding moves it: 7% apart on
  the CPU at mu = 0.15);
* every port benchmark, run at a tiny setting, emits exactly the
  reference's quick-mode row names (``chip_smoke.PAPER_ROW_NAMES``,
  written down by ``tests/torch_bench_reference.py``), every value
  finite.
"""

import functools
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from benchmarks import bench_classification as jc  # noqa: E402
from benchmarks import bench_method_costs as jmc  # noqa: E402
from benchmarks import bench_reliability as jrel  # noqa: E402
from benchmarks import bench_reverse_error as jre  # noqa: E402
from repro.core import odeint as jodeint  # noqa: E402
from repro.data import spiral_classification as jspiral  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.optim.adamw import apply_updates as japply  # noqa: E402
from repro_torch.benchmarks import (classification, method_costs,  # noqa: E402,E501
                                    reliability, reverse_error,
                                    solver_robustness, threebody,
                                    timeseries)
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.convert import tree_from_jax  # noqa: E402

CASES = (("node", "aca"), ("node", "adjoint"), ("node", "naive"),
         ("discrete", "aca"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _spiral():
    x, y = jspiral(60, seed=0)
    return x, y


def _port_params(pj):
    pt = tree_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    return {k: v.requires_grad_() for k, v in pt.items()}


def _port_xy():
    x, y = _spiral()
    return torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y)).long()


def _ref_loss(mode, gm):
    x, y = _spiral()

    def loss(p):
        lg = jc.forward(p, x, mode=mode, grad_method=gm)
        ll = jax.nn.log_softmax(lg)
        return -jnp.take_along_axis(ll, y[:, None], 1).mean(), lg

    return loss


@pytest.mark.parametrize("mode,gm", CASES)
def test_classification_forward_and_gradients(mode, gm):
    pj = jc.init_params(jax.random.PRNGKey(0))
    (lj, lgj), gj = jax.value_and_grad(_ref_loss(mode, gm),
                                       has_aux=True)(pj)
    pt = _port_params(pj)
    xt, yt = _port_xy()
    lt = classification.loss_fn(pt, xt, yt, mode, gm)
    gt = torch.autograd.grad(lt, list(pt.values()))
    with torch.no_grad():
        lgt = classification.forward(pt, xt, mode=mode, grad_method=gm)
    assert _rel(lgt.numpy(), lgj) <= 1e-5
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6
    for k, g in zip(pt, gt):
        assert _rel(g.numpy(), gj[k]) <= 1e-5, k


@pytest.mark.parametrize("mode,gm", CASES)
def test_classification_three_training_steps(mode, gm):
    x, y = _spiral()
    pj = jc.init_params(jax.random.PRNGKey(0))
    pt = _port_params(pj)
    opt = jadamw(jconstant(3e-3))
    st = opt.init(pj)
    loss = jax.jit(jax.value_and_grad(lambda p: _ref_loss(mode, gm)(p)[0]))
    for _ in range(3):
        lj, g = loss(pj)
        up, st = opt.update(g, st, pj)
        pj = japply(pj, up)
    xt, yt = _port_xy()
    pt, lt = classification.fit(pt, 3, xt, yt, mode, gm)
    assert abs(lt - float(lj)) <= 1e-6
    for k in pt:
        assert np.abs(pt[k].detach().numpy() - np.asarray(pj[k])).max() \
            <= 1e-6, k


def test_solver_robustness_predictions():
    """The untrained model read with every test-time solver of Tables 6/7
    (and the training solver): the same logits and predictions."""
    x, _ = _spiral()
    pj = jc.init_params(jax.random.PRNGKey(0))
    pt = _port_params(pj)
    xt, _ = _port_xy()
    reads = [dict(solver="heun_euler")]
    reads += [dict(solver=s, steps=n) for s, n in solver_robustness.FIXED]
    reads += [dict(solver=s) for s in solver_robustness.ADAPTIVE]
    for kw in reads:
        lgj = np.asarray(jc.forward(pj, x, mode="node", **kw))
        with torch.no_grad():
            lgt = classification.forward(pt, xt, mode="node", **kw).numpy()
        assert _rel(lgt, lgj) <= 1e-5, kw
        np.testing.assert_array_equal(lgt.argmax(-1), lgj.argmax(-1))


def test_icc1_and_pairwise_agreement():
    rng = np.random.default_rng(3)
    mat = (rng.uniform(size=(40, 5)) < 0.7).astype(float)
    assert abs(reliability.icc1(mat) - jrel.icc1(mat)) <= 1e-12
    for m in (np.ones((6, 3)), np.eye(4)[:, :2]):
        assert abs(reliability.icc1(m) - jrel.icc1(m)) <= 1e-12
    preds = [rng.integers(0, 3, 50) for _ in range(4)]
    ref = np.mean([(preds[i] == preds[j]).mean()
                   for i in range(4) for j in range(i + 1, 4)])
    assert abs(reliability.pairwise_agreement(preds) - ref) <= 1e-12


def test_method_costs_counts_match_the_reference():
    w1, w2, z0 = method_costs.init("cpu")
    wj = [jnp.asarray(x.numpy()) for x in (w1, w2, z0)]
    max_steps = method_costs.SETTINGS[True]["max_steps"]
    for label, use_pallas in method_costs.VARIANTS:
        _, st_j = jodeint(jmc._f, wj[2], jnp.array([0.0, 1.0]),
                          (wj[0], wj[1]), solver="dopri5",
                          grad_method=label.split("_")[0], rtol=1e-5,
                          atol=1e-5, max_steps=max_steps, max_trials=8,
                          use_pallas=use_pallas)
        _, _, _, st_t = method_costs.value_and_grad(label, w1, w2, z0,
                                                    max_steps)
        assert int(st_t.n_steps) == int(st_j.n_steps), label
        if label == "naive":
            # ROADMAP queue 3: the reference scans its whole budget
            assert int(st_j.nfe) == max_steps * 8 * 7
            assert int(st_t.nfe) == int(st_t.n_trials) * 7
            assert int(st_t.n_trials) < int(st_j.n_trials)
        else:
            assert int(st_t.n_trials) == int(st_j.n_trials), label
            assert int(st_t.nfe) == int(st_j.nfe), label


def test_method_costs_residual_bytes_order():
    """The count the Table 1 row reports: the naive tape above ACA's
    checkpoint buffer above the adjoint's outputs."""
    w1, w2, z0 = method_costs.init("cpu")
    b = {label: method_costs.residual_bytes(label, w1, w2, z0, 32)
         for label, _ in method_costs.VARIANTS}
    slot = z0.numel() * 4
    assert b["adjoint"] == 2 * slot                  # ys (t0, t1)
    assert b["aca"] >= 32 * slot                     # the 32-slot buffer
    assert b["aca_pallas"] == b["aca"]
    assert b["naive"] > b["aca"]


def test_reverse_error_rows_within_a_factor_two():
    kern, img = reverse_error.conv_inputs("cpu")
    for mu in (0.15, 4.0):
        def vdp_j(t, z, mu):
            return jnp.stack([z[1], mu * (1 - z[0] ** 2) * z[1] - z[0]])

        ref = jre.reverse_roundtrip_error(vdp_j, jnp.array([2.0, 0.0]), 5.0,
                                          (jnp.float32(mu),))
        got = reverse_error.reverse_roundtrip_error(
            reverse_error.vdp, torch.tensor([2.0, 0.0]), 5.0,
            (torch.tensor(mu),))
        assert ref / 2 <= got <= 2 * ref, (mu, got, ref)

    def conv_j(t, z, k):
        return jax.lax.conv_general_dilated(
            z, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    ref = jre.reverse_roundtrip_error(
        conv_j, jnp.asarray(img.numpy().transpose(0, 2, 3, 1)), 1.0,
        (jnp.asarray(kern.numpy().transpose(2, 3, 1, 0)),))
    got = reverse_error.reverse_roundtrip_error(reverse_error.conv_ode, img,
                                                1.0, (kern,))
    assert ref / 2 <= got <= 2 * ref, (got, ref)


# tiny settings of every benchmark: rows and finiteness only
TINY = {
    "reverse_error": (reverse_error, {}),
    "method_costs": (method_costs, {"max_steps": 16}),
    "classification": (classification, {"n_train": 30, "n_test": 30,
                                        "steps": 1}),
    "reliability": (reliability, {"n_runs": 2, "steps": 1, "n_train": 30}),
    "solver_robustness": (solver_robustness, {"n_train": 30, "n_test": 30,
                                              "steps": 1}),
    "timeseries": (timeseries, {"batch": 2, "steps": 1}),
    "threebody": (threebody, {"n_pts": 8, "fit_steps": 1}),
}


@pytest.mark.parametrize("bench", sorted(TINY))
def test_benchmark_emits_the_reference_rows(bench):
    mod, cuts = TINY[bench]
    tcommon.ROWS.clear()
    out = mod.run(quick=True, device="cpu", **cuts)
    names = sorted(r.split(",")[0] for r in tcommon.ROWS
                   if not r.startswith("{"))
    assert names == sorted(out) == sorted(chip_smoke.PAPER_ROW_NAMES[bench])
    assert all(math.isfinite(v) for v in out.values())


def test_settings_reject_an_unknown_cut():
    with pytest.raises(ValueError, match="unknown setting"):
        classification.run(quick=True, device="cpu", step=3)
