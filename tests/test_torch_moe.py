"""The port's MoE block (``repro_torch.models.moe``) against the
reference's single-shard ``repro.models.moe`` on the same numpy inputs
and weights (f32).

Tolerances, as max |difference| / max |reference|:

* ``moe_apply``'s y: 1e-5 — the same f32 products; the port sums each
  token's ≤ k expert outputs in ascending expert order, the reference
  scatter-adds them (observed ~1e-7);
* the aux loss and the gates: 1e-6 relative (the same f32 softmax and
  means, summed in other orders);
* the router's expert ids: equal, ties included (both take the lower
  expert id first).

The dropping case runs at capacity_factor 0.5, where C = ceil(T·k/E·0.5)
is half the mean load, so some tokens lose experts; the test checks that
some do before holding y against the reference.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_moe_16b as jds
from repro.configs import qwen3_moe_235b_a22b as jq3
from repro.models import RunConfig as JRunConfig
from repro.models import moe as jmoe
from repro.models.common import init_params as jinit
from repro_torch.convert import tree_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig, RunConfig

TOL = 1e-5


def _rel(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)
    b = np.asarray(b, dtype=np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _case(jcfg, seed=0, b=2, s=16, **over):
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    p = jinit(jmoe.moe_defs(jcfg, jnp.float32), jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, tree_from_jax(jax.tree.map(np.asarray, p), "cpu"), x


@pytest.mark.parametrize("name,jcfg", [("deepseek-shared", jds.SMOKE),
                                       ("qwen3-no-shared", jq3.SMOKE)])
@pytest.mark.parametrize("seed", [0, 1])
def test_moe_apply_matches_reference(name, jcfg, seed):
    jcfg, tcfg, p, tp, x = _case(jcfg, seed)
    assert ("shared" in tp) == bool(jcfg.n_shared_experts)
    yj, auxj = jmoe.moe_apply(p, jnp.asarray(x), jcfg,
                              JRunConfig(compute_dtype=jnp.float32))
    yt, auxt = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg,
                              RunConfig(compute_dtype=torch.float32))
    assert yt.dtype == torch.float32 and tuple(yt.shape) == x.shape
    assert _rel(yt, yj) <= TOL
    assert abs(float(auxt) - float(auxj)) <= 1e-6 * abs(float(auxj))


def test_capacity_overflow_drops_tokens_as_the_reference():
    jcfg, tcfg, p, tp, x = _case(jds.SMOKE, 3, capacity_factor=0.5,
                                 n_shared_experts=0)
    t = x.shape[0] * x.shape[1]
    c = tmoe._capacity(t, tcfg)
    assert c == jmoe._capacity(t, jcfg) == 4          # 32 · 2 / 8 · 0.5
    ids, _, _ = tmoe._route(torch.from_numpy(x), tp["router"], tcfg)
    load = torch.bincount(ids.reshape(-1), minlength=tcfg.n_experts)
    assert int(load.max()) > c, "no expert overflows: nothing is dropped"
    yj, _ = jmoe.moe_apply(p, jnp.asarray(x), jcfg,
                           JRunConfig(compute_dtype=jnp.float32))
    yt, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg,
                           RunConfig(compute_dtype=torch.float32))
    assert _rel(yt, yj) <= TOL
    # the same tokens lost every expert on both sides (rows of zeros)
    zj = np.abs(np.asarray(yj)).reshape(t, -1).max(-1) == 0
    zt = yt.abs().reshape(t, -1).amax(-1).numpy() == 0
    np.testing.assert_array_equal(zt, zj)
    # a capacity that holds every token changes the dropped ones only
    yfull, _ = tmoe.moe_apply(tp, torch.from_numpy(x), dataclasses.replace(
        tcfg, capacity_factor=4.0), RunConfig(compute_dtype=torch.float32))
    assert not torch.equal(yfull, yt)


@pytest.mark.parametrize("jcfg", [jds.SMOKE, jq3.SMOKE])
def test_route_ids_and_gates_match_reference(jcfg):
    jcfg, tcfg, p, tp, x = _case(jcfg, 5)
    ij, gj, pj = jmoe._route(jnp.asarray(x), p["router"], jcfg)
    it, gt, pt = tmoe._route(torch.from_numpy(x), tp["router"], tcfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert _rel(gt, gj) <= 1e-6 and _rel(pt, pj) <= 1e-6
    np.testing.assert_allclose(gt.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_route_breaks_ties_to_the_lower_expert():
    """A zero router gives every expert the same probability: both sides
    pick experts 0..k-1, in order."""
    jcfg, tcfg, p, tp, x = _case(jds.SMOKE, 0)
    zero = np.zeros((jcfg.d_model, jcfg.n_experts), np.float32)
    ij, gj, _ = jmoe._route(jnp.asarray(x), jnp.asarray(zero), jcfg)
    it, gt, _ = tmoe._route(torch.from_numpy(x), torch.from_numpy(zero),
                            tcfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert (it == torch.arange(jcfg.top_k)).all()
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(7)
    e, k = 8, 2
    logits = rng.standard_normal((3, 10, e)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = np.argsort(-probs, axis=-1)[..., :k].astype(np.int32)
    want = float(jmoe.aux_load_balance_loss(jnp.asarray(ids),
                                            jnp.asarray(probs), e))
    got = float(tmoe.aux_load_balance_loss(
        torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(probs), e))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_moe_block_raises_for_a_mesh():
    """The expert-parallel dispatch (slice I2) takes a mesh with named
    dims whose ``model`` dim divides the experts; it raises for others."""
    _, tcfg, _, tp, x = _case(jds.SMOKE, 0)
    with pytest.raises(ValueError, match="named dimensions"):
        tmoe.moe_apply(tp, torch.from_numpy(x), tcfg,
                       RunConfig(compute_dtype=torch.float32, mesh=object()))
    three = types.SimpleNamespace(mesh_dim_names=("model",), shape=(3,))
    with pytest.raises(ValueError, match=f"n_experts={tcfg.n_experts} not "
                       "divisible by the mesh's model dim 3"):
        tmoe.moe_apply(tp, torch.from_numpy(x), tcfg,
                       RunConfig(compute_dtype=torch.float32, mesh=three))


def test_combine_is_the_same_bits_every_call():
    _, tcfg, _, tp, x = _case(jds.SMOKE, 2)
    rc = RunConfig(compute_dtype=torch.float32)
    y1, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg, rc)
    y2, _ = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg, rc)
    assert torch.equal(y1, y2)
