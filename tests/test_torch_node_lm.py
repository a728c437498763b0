"""NODE mode inside the port's LM stack against the reference, mirroring
the NODE tests of ``tests/test_models_consistency.py``:
``test_node_mode_trains`` (four regime × gradient-method cases, here with
every parameter's gradient held against ``jax.grad`` of the reference's
``loss_fn``), ``test_node_mode_run_config_use_pallas_reaches_solver``,
``test_node_mode_param_count_unchanged`` and
``test_node_fixed_aca_equals_naive_gradient``.

Same config (the reference test's ``dense-gqa``: 3 layers, d_model 64,
GQA 4/2 heads), same ``tiny_batch``, the reference's weights carried over
with ``tree_from_jax``; f32. Tolerances:

* loss against the reference's: 1e-5 relative;
* gradients against ``jax.grad``: max |difference| over max |reference|
  within 1e-4 for every parameter leaf (the same discrete solution;
  fields summed in other orders, and the adaptive case's grid taken by
  the same accept/reject decisions);
* ``use_pallas`` on the CPU (K1/K2's plain versions on the fused
  flat-state path) against the pytree path: the loss bitwise and the
  gradients within rtol 1e-5, atol 1e-6 (the reference's bound);
* fixed-grid ACA against the naive method: rtol 1e-3, atol 1e-5 (the
  reference's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_batch
from repro.core import NodeConfig as JNodeConfig
from repro.models import ModelConfig as JModelConfig
from repro.models import RunConfig as JRunConfig
from repro.models import build_model as jbuild_model
from repro_torch.convert import tree_from_jax
from repro_torch.core.node_block import NodeConfig
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig, RunConfig
from repro_torch.models.lm import build_model

CFG_KW = dict(name="t", family="dense", n_layers=3, d_model=64, vocab=128,
              n_heads=4, n_kv_heads=2, d_ff=128, qkv_bias=True)
CFG = ModelConfig(**CFG_KW)
GRAD_TOL = 1e-4

_REF = {}


def _reference(node_kw):
    """The reference's params, batch, loss and jax.grad (once per case)."""
    key = tuple(sorted(node_kw.items()))
    if key not in _REF:
        jcfg = JModelConfig(**CFG_KW)
        jm = jbuild_model(jcfg, JRunConfig(compute_dtype=jnp.float32,
                                           node=JNodeConfig(**node_kw)))
        params = jm.init(jax.random.PRNGKey(1))
        batch = tiny_batch(jcfg)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            jm.loss_fn, has_aux=True))(params, batch)
        _REF[key] = dict(params=jax.tree.map(np.asarray, params),
                         batch={k: np.asarray(v) for k, v in batch.items()},
                         loss=float(loss),
                         grads=jax.tree.map(np.asarray, grads))
    return _REF[key]


def _port_grads(ref, node_kw, **run):
    m = build_model(CFG, RunConfig(compute_dtype=torch.float32,
                                   node=NodeConfig(**node_kw), **run))
    m.node_stats = []
    params = tree_from_jax(ref["params"], "cpu")
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v.copy()) for k, v in ref["batch"].items()}
    loss, _ = m.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), torch.utils._pytree.tree_unflatten(
        list(grads), spec), m.node_stats)


def _grad_err(got, want) -> float:
    worst = 0.0
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = torch.utils._pytree.tree_leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        assert tuple(g.shape) == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        worst = max(worst, float(np.abs(g.numpy() - w).max()) / scale)
    return worst


@pytest.mark.parametrize("regime,gm", [("fixed", "aca"),
                                       ("adaptive", "aca"),
                                       ("fixed", "adjoint"),
                                       ("fixed", "naive")])
def test_node_mode_trains(regime, gm):
    node_kw = dict(enabled=True, regime=regime, grad_method=gm,
                   steps_per_interval=2, max_steps=16)
    ref = _reference(node_kw)
    loss, grads, stats = _port_grads(ref, node_kw)
    assert bool(torch.isfinite(loss))
    assert abs(float(loss) - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert all(bool(torch.isfinite(g).all())
               for g in torch.utils._pytree.tree_leaves(grads))
    assert _grad_err(grads, ref["grads"]) <= GRAD_TOL
    # one solve per block, on the grid the regime says
    assert [(k, i) for k, i, _ in stats] == [("u0_attn", i)
                                             for i in range(3)]
    for _, _, st in stats:
        if regime == "fixed":
            assert int(st.n_steps) == 2
        else:
            assert int(st.n_steps) >= 1 and int(st.n_trials) >= \
                int(st.n_steps)


def test_node_mode_run_config_use_pallas_reaches_solver():
    """RunConfig.use_pallas flows into every NODE block's odeint: the
    fused flat-state path (K1/K2's plain versions on CPU tensors, no
    launch) gives the pytree path's loss exactly and its gradients to f32
    tolerance."""
    node_kw = dict(enabled=True, regime="adaptive", grad_method="aca",
                   max_steps=16)
    ref = _reference(node_kw)
    ops.reset_launches()
    out = {up: _port_grads(ref, node_kw, use_pallas=up)
           for up in (False, True)}
    assert all(v == 0 for v in ops.launch_counts().values())
    assert float(out[False][0]) == float(out[True][0])
    for a, b in zip(torch.utils._pytree.tree_leaves(out[False][1]),
                    torch.utils._pytree.tree_leaves(out[True][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    for (_, _, a), (_, _, b) in zip(out[False][2], out[True][2]):
        assert int(a.n_steps) == int(b.n_steps)
        assert int(a.n_trials) == int(b.n_trials)
    assert _grad_err(out[True][1], ref["grads"]) <= GRAD_TOL


def test_node_mode_param_count_unchanged():
    """Eq. 30 -> 31: the NODE transform keeps the parameter count."""
    m_disc = build_model(CFG, RunConfig())
    m_node = build_model(CFG, RunConfig(
        node=NodeConfig(enabled=True, regime="fixed")))
    assert m_disc.n_params() == m_node.n_params()
    assert m_node.n_params() == jbuild_model(
        JModelConfig(**CFG_KW), JRunConfig()).n_params()


def test_node_fixed_aca_equals_naive_gradient():
    """Fixed-grid NODE: ACA and naive differentiate the same discrete
    solution, so the model gradients nearly agree."""
    grads = {}
    for gm in ("aca", "naive"):
        node_kw = dict(enabled=True, regime="fixed", grad_method=gm,
                       steps_per_interval=2)
        grads[gm] = _port_grads(_reference(node_kw), node_kw)[1]
    for a, b in zip(torch.utils._pytree.tree_leaves(grads["aca"]),
                    torch.utils._pytree.tree_leaves(grads["naive"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3,
                                   atol=1e-5)


def test_node_mode_batch_axis_solves_each_row():
    """``batch_axis=0``: each sequence of the batch is its own ODE on its
    own grid (the batched engine, K3's plain version under
    use_pallas); with a fixed grid every row takes the solo solve's
    discrete steps, so loss and gradients match the solo solve's."""
    node_kw = dict(enabled=True, regime="fixed", grad_method="aca",
                   steps_per_interval=2)
    ref = _reference(node_kw)
    solo = _port_grads(ref, node_kw)
    rows = _port_grads(ref, dict(node_kw, batch_axis=0), use_pallas=True)
    assert abs(float(rows[0]) - float(solo[0])) <= 1e-6 * abs(float(solo[0]))
    assert _grad_err(rows[1], jax.tree.map(
        lambda t: t.numpy(), solo[1])) <= 1e-5
    assert all(tuple(st.n_steps.shape) == (2,) for _, _, st in rows[2])


def test_node_lm_benchmark_rows():
    """``benchmarks/node_lm.py`` emits the reference's rows
    (``benchmarks/bench_node_lm.py``); ACA and naive differentiate the
    same discrete solution, so their loss curves agree to 1e-3."""
    from repro_torch.benchmarks import node_lm
    out = node_lm.run(quick=True, device="cpu", steps=3)
    assert sorted(out) == sorted(
        [f"nodelm_final_loss/{m}" for m in
         ("aca", "adjoint", "naive", "discrete")]
        + ["nodelm_curve_dist/aca_vs_naive",
           "nodelm_curve_dist/aca_vs_adjoint"])
    assert all(np.isfinite(v) for v in out.values())
    assert out["nodelm_curve_dist/aca_vs_naive"] <= 1e-3
