"""The node18_cifar NODE block of the port against the reference.

``SMOKE`` block weights come from the reference's ``init_params`` and
reach the port through ``convert.params_from_jax``. Both sides solve the
block as an ODE with ``NODE_TRAIN``'s HeunEuler at rtol=atol=1e-2,
``use_pallas=True`` (interpret mode on the reference side), f32 compute,
the full checkpoint buffer, on x of shape (2, 16, 64) made with numpy.

The accepted step counts must be equal. z(1) and the ACA gradients (x
and every parameter) are held to max |difference| / max |value| <= 1e-5:
the two sides run the same algorithm and differ in the summation order
of the matmuls and the softmax.

The per-sample form (``NodeConfig(batch_axis=0)``) is held the same way
against the reference's ``node_block_apply`` with ``batch_axis=0`` on x of
shape (3, 16, 64), per-row step counts equal: each sample (16, 64) is its
own ODE, its field the block on a batch of one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import node18_cifar as jcfg
from repro.core import odeint_final as jodeint_final
from repro.core.node_block import node_block_apply as jnode_block_apply
from repro.kernels import ops as jops
from repro.models.common import init_params
from repro.models.config import RunConfig as JRun
from repro.models.transformer import _branch_fn, block_defs
from repro_torch.configs import node18_cifar as tcfg
from repro_torch.convert import params_from_jax
from repro_torch.models.config import RunConfig as TRun
from repro_torch.models.transformer import (
    TransformerBlock,
    full_buffer,
    node_block,
)

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _interpret_kernels():
    jops.set_interpret(True)
    yield
    jops.set_interpret(None)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def cases():
    cfg = jcfg.SMOKE
    ncfg = dataclasses.replace(jcfg.NODE_TRAIN, checkpoint_segments=None)
    rcfg = JRun(compute_dtype=jnp.float32, node=ncfg)
    params = init_params(block_defs(cfg, "attn", jnp.float32),
                         jax.random.PRNGKey(0))
    x = np.random.default_rng(0).standard_normal((2, 16, 64)).astype(
        np.float32)

    def loss(p, x):
        zT, st = jodeint_final(
            lambda t, z, pp: _branch_fn(pp, z, cfg, rcfg, "attn", None),
            x, ncfg.t0, ncfg.t1, (p,), solver=ncfg.solver,
            grad_method="aca", rtol=ncfg.rtol, atol=ncfg.atol,
            max_steps=ncfg.max_steps, use_pallas=ncfg.use_pallas)
        return jnp.mean(zT ** 2), (zT, st)

    (_, (zj, stj)), (gpj, gxj) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    blk = TransformerBlock(
        tcfg.SMOKE,
        TRun(compute_dtype=torch.float32, node=full_buffer(tcfg.NODE_TRAIN)),
        device="cpu")
    blk.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                        device="cpu"))
    xt = torch.tensor(x, requires_grad=True)
    zt, stt = node_block(blk, xt)
    torch.mean(zt ** 2).backward()
    return dict(zj=np.asarray(zj), stj=stj, gpj=_flat(gpj),
                gxj=np.asarray(gxj), zt=zt.detach().numpy(), stt=stt,
                gxt=xt.grad.numpy(),
                gpt={n: p.grad.numpy() for n, p in blk.named_parameters()},
                params=_flat(params), blk=blk)


def test_parameter_names_are_the_reference_keys(cases):
    names = {n for n, _ in cases["blk"].named_parameters()}
    assert names == set(cases["params"])
    for n, p in cases["blk"].named_parameters():
        assert tuple(p.shape) == cases["params"][n].shape


def test_forward_matches_reference(cases):
    stt, stj = cases["stt"], cases["stj"]
    assert int(stt.n_steps) == int(stj.n_steps) > 1
    assert int(stt.n_trials) == int(stj.n_trials)
    assert int(stt.nfe) == int(stj.nfe)
    assert int(stt.status) == int(stj.status) == 0
    assert _rel(cases["zt"], cases["zj"]) <= TOL


def test_input_gradient_matches_reference(cases):
    assert _rel(cases["gxt"], cases["gxj"]) <= TOL


@pytest.mark.parametrize("name", ["norm1.w", "mixer.wq", "mixer.wk",
                                  "mixer.wv", "mixer.wo", "norm2.w",
                                  "ffn.w_in", "ffn.w_gate", "ffn.w_out"])
def test_parameter_gradient_matches_reference(cases, name):
    assert _rel(cases["gpt"][name], cases["gpj"][name]) <= TOL


def test_block_apply_matches_reference(cases):
    """One plain block application (no solve)."""
    cfg = jcfg.SMOKE
    rcfg = JRun(compute_dtype=jnp.float32)
    x = np.random.default_rng(1).standard_normal((2, 16, 64)).astype(
        np.float32)
    params = jax.tree.map(jnp.asarray, _nest(cases["params"]))
    yj = _branch_fn(params, jnp.asarray(x), cfg, rcfg, "attn", None) + x
    with torch.no_grad():
        yt = cases["blk"](torch.tensor(x))
    assert _rel(yt.numpy(), np.asarray(yj)) <= TOL


def _nest(flat):
    out = {}
    for k, v in flat.items():
        d = out
        parts = k.split(".")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def test_fixed_regime_and_unported_kinds_raise(cases):
    from repro_torch.core.node_block import NodeConfig, node_block_apply
    # the fixed regime runs: rk2 (HeunEuler's advancing method) on 4 steps
    # of dz/dt = -z
    zT = node_block_apply(lambda p, z, t: -z, {}, torch.ones(2),
                          NodeConfig(regime="fixed"))
    np.testing.assert_allclose(zT.numpy(), [(1 - 0.25 + 0.25 ** 2 / 2) ** 4]
                               * 2, rtol=1e-6)
    # mali runs (the ALF pair stepper, whatever the config's solver) and
    # rejects the fixed regime, as the reference's block does
    zT = node_block_apply(lambda p, z, t: -z, {}, torch.ones(2),
                          NodeConfig(grad_method="mali"))
    np.testing.assert_allclose(zT.numpy(), [np.exp(-1.0)] * 2, rtol=1e-2)
    with pytest.raises(ValueError, match="fixed"):
        node_block_apply(lambda p, z, t: -z, {}, torch.ones(2),
                         NodeConfig(grad_method="mali", regime="fixed"))
    with pytest.raises(ValueError, match="slice G"):
        TransformerBlock(dataclasses.replace(tcfg.SMOKE, family="moe"),
                         TRun(), device="cpu")
    # NODE_TRAIN as published (segmented ACA, "auto") runs: gradients
    # bitwise the full buffer's, and the reference's within TOL
    blk = cases["blk"]
    blk.zero_grad(set_to_none=True)
    x = torch.tensor(np.random.default_rng(0).standard_normal(
        (2, 16, 64)).astype(np.float32), requires_grad=True)
    zt, st = node_block(blk, x, tcfg.NODE_TRAIN)
    torch.mean(zt ** 2).backward()
    assert int(st.n_steps) == int(cases["stt"].n_steps)
    assert np.array_equal(zt.detach().numpy(), cases["zt"])
    assert np.array_equal(x.grad.numpy(), cases["gxt"])
    for n, p in blk.named_parameters():
        assert np.array_equal(p.grad.numpy(), cases["gpt"][n]), n
        assert _rel(p.grad.numpy(), cases["gpj"][n]) <= TOL, n


# ------------------------------------------------ per-sample (batch_axis=0)

@pytest.fixture(scope="module")
def batched_cases(cases):
    cfg = jcfg.SMOKE
    ncfg = dataclasses.replace(jcfg.NODE_TRAIN, checkpoint_segments=None,
                               batch_axis=0)
    rcfg = JRun(compute_dtype=jnp.float32, node=ncfg)
    params = jax.tree.map(jnp.asarray, _nest(cases["params"]))
    x = np.random.default_rng(2).standard_normal((3, 16, 64)).astype(
        np.float32)

    def block_fn(pp, z, t):
        return _branch_fn(pp, z[None], cfg, rcfg, "attn", None)[0]

    def loss(p, x):
        zT = jnode_block_apply(block_fn, p, x, ncfg)
        return jnp.mean(zT ** 2), zT

    (_, zj), (gpj, gxj) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    _, stj = jodeint_final(
        lambda t, z, pp: block_fn(pp, z, t), jnp.asarray(x), ncfg.t0,
        ncfg.t1, (params,), solver=ncfg.solver, grad_method="aca",
        rtol=ncfg.rtol, atol=ncfg.atol, max_steps=ncfg.max_steps,
        use_pallas=ncfg.use_pallas, batch_axis=0)

    blk = cases["blk"]
    blk.zero_grad(set_to_none=True)
    tncfg = dataclasses.replace(full_buffer(tcfg.NODE_TRAIN), batch_axis=0)
    xt = torch.tensor(x, requires_grad=True)
    zt, stt = node_block(blk, xt, tncfg)
    torch.mean(zt ** 2).backward()
    out = dict(zj=np.asarray(zj), stj=stj, gpj=_flat(gpj),
               gxj=np.asarray(gxj), zt=zt.detach().numpy(), stt=stt,
               gxt=xt.grad.numpy(),
               gpt={n: p.grad.numpy() for n, p in blk.named_parameters()})
    blk.zero_grad(set_to_none=True)
    return out


def test_batched_forward_matches_reference(batched_cases):
    stt, stj = batched_cases["stt"], batched_cases["stj"]
    for field in ("n_steps", "n_trials", "nfe", "status"):
        np.testing.assert_array_equal(getattr(stt, field).numpy(),
                                      np.asarray(getattr(stj, field)),
                                      err_msg=field)
    assert stt.n_steps.shape == (3,) and int(stt.n_steps.min()) > 1
    assert _rel(batched_cases["zt"], batched_cases["zj"]) <= TOL


def test_batched_input_gradient_matches_reference(batched_cases):
    assert _rel(batched_cases["gxt"], batched_cases["gxj"]) <= TOL


@pytest.mark.parametrize("name", ["norm1.w", "mixer.wq", "mixer.wk",
                                  "mixer.wv", "mixer.wo", "norm2.w",
                                  "ffn.w_in", "ffn.w_gate", "ffn.w_out"])
def test_batched_parameter_gradient_matches_reference(batched_cases, name):
    assert _rel(batched_cases["gpt"][name], batched_cases["gpj"][name]) \
        <= TOL
