"""Prefill -> decode against the train-mode forward on the port, and
against the reference's prefill and decode, mirroring
``tests/test_models_consistency.py::test_prefill_decode_matches_forward``
(with an MoE case), plus the ``embeds`` route of the two frontend-stub
archs and their synthetic batches.

The reference's ``init`` draws the weights and ``convert.tree_from_jax``
carries them over; the reference runs jitted. Tolerances, as max
|difference| / max |reference|: 1e-5 against the reference's logits (the
same f32 algorithm, summed in other orders); 1e-4 for the port's prefill
-> decode against its own forward, the reference test's bound. The MoE
case runs at capacity_factor 2.0 = n_experts / top_k, where C = T: no
token is dropped in prefill, decode or forward, so the three route the
same tokens to the same experts (the dropping case is held against the
reference's ``moe_apply`` in ``test_torch_moe.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import ModelConfig as JModelConfig
from repro.models import RunConfig as JRunConfig
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import tree_from_jax
from repro_torch.models.config import ModelConfig, RunConfig
from repro_torch.models.lm import build_model

TOL = 1e-5
OWN_TOL = 1e-4


def _rel(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --------------------------------------------- prefill -> decode vs forward

CONFIGS = {
    "dense-gqa": dict(
        name="t", family="dense", n_layers=3, d_model=64, vocab=128,
        n_heads=4, n_kv_heads=2, d_ff=128, qkv_bias=True),
    "dense-parallel-tied": dict(
        name="t", family="dense", n_layers=2, d_model=64, vocab=128,
        n_heads=4, n_kv_heads=2, d_ff=128, parallel_block=True,
        tie_embeddings=True, norm="layernorm"),
    "moe-shared": dict(
        name="t", family="moe", n_layers=2, d_model=64, vocab=128,
        n_heads=4, n_kv_heads=2, d_ff=96, n_experts=4, n_shared_experts=1,
        top_k=2, d_expert=48, capacity_factor=2.0),
}
S, NEW = 16, 3


def _prefill_decode(model, params, batches, s):
    """(prefill's last logits, each decode step's) along ``batches``: a
    function of the slice [a, b) of the sequence -> that slice's batch."""
    with torch.no_grad():
        last, caches = model.prefill(params, batches(0, s))
        steps = []
        for j in range(NEW):
            lg, caches = model.decode_step(params, batches(s + j, s + j + 1),
                                           caches, s + j)
            steps.append(lg)
    return last, steps


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_decode_matches_forward(name):
    jcfg = JModelConfig(**CONFIGS[name])
    jm = jbuild_model(jcfg, JRunConfig(compute_dtype=jnp.float32,
                                       max_seq=S + NEW + 4))
    jparams = jm.init(jax.random.PRNGKey(1))
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (2, S + NEW),
                                         0, jcfg.vocab, jnp.int32))
    jlast, jc = jax.jit(jm.prefill)(jparams,
                                    {"tokens": jnp.asarray(toks[:, :S])})
    jsteps = []
    decode = jax.jit(jm.decode_step)
    for j in range(NEW):
        lg, jc = decode(
            jparams, {"tokens": jnp.asarray(toks[:, S + j:S + j + 1])}, jc,
            jnp.asarray(S + j, jnp.int32))
        jsteps.append(np.asarray(lg))

    m = build_model(ModelConfig(**CONFIGS[name]), RunConfig(compute_dtype=torch.float32,
                                               max_seq=S + NEW + 4))
    params = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tt = torch.from_numpy(toks.copy())
    with torch.no_grad():
        full, _, _ = m.forward(params, {"tokens": tt}, mode="train")
    last, steps = _prefill_decode(
        m, params, lambda a, b: {"tokens": tt[:, a:b]}, S)
    assert _rel(last, full[:, S - 1]) <= OWN_TOL
    assert _rel(last, jlast) <= TOL
    for j in range(NEW):
        assert _rel(steps[j], full[:, S + j]) <= OWN_TOL, (name, j)
        assert _rel(steps[j], jsteps[j]) <= TOL, (name, j)


@pytest.mark.parametrize("arch", ["llava_next_34b", "musicgen_medium"])
def test_embeds_route_matches_reference(arch):
    """The frontend-stub archs take ``embeds`` (B,S,D) in forward, prefill
    and decode (one (B,1,D) frame a step), and have no embedding table."""
    jcfg = jget_smoke(arch)
    jm = jbuild_model(jcfg, JRunConfig(compute_dtype=jnp.float32,
                                       max_seq=S + NEW + 4))
    jparams = jm.init(jax.random.PRNGKey(2))
    emb = np.random.default_rng(3).standard_normal(
        (2, S + NEW, jcfg.d_model)).astype(np.float32) * 0.02
    jfull, _, _ = jax.jit(jm.forward)(jparams, {"embeds": jnp.asarray(emb)})
    jlast, jc = jax.jit(jm.prefill)(jparams,
                                    {"embeds": jnp.asarray(emb[:, :S])})
    jsteps = []
    decode = jax.jit(jm.decode_step)
    for j in range(NEW):
        lg, jc = decode(
            jparams, {"embeds": jnp.asarray(emb[:, S + j:S + j + 1])}, jc,
            jnp.asarray(S + j, jnp.int32))
        jsteps.append(np.asarray(lg))

    m = build_model(get_smoke_config(arch), RunConfig(
        compute_dtype=torch.float32, max_seq=S + NEW + 4))
    assert "embed" not in m.defs and "lm_head" in m.defs
    params = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    te = torch.from_numpy(emb)
    with torch.no_grad():
        full, _, _ = m.forward(params, {"embeds": te})
    assert _rel(full, jfull) <= TOL
    last, steps = _prefill_decode(
        m, params, lambda a, b: {"embeds": te[:, a:b]}, S)
    assert _rel(last, jlast) <= TOL
    assert _rel(last, full[:, S - 1]) <= OWN_TOL
    for j in range(NEW):
        assert _rel(steps[j], jsteps[j]) <= TOL, j
        assert _rel(steps[j], full[:, S + j]) <= OWN_TOL, j


def test_frontend_batches():
    from repro.models.frontends import frontend_batch_abstract as jabstract
    from repro_torch.models.frontends import (frontend_batch_abstract,
                                              frontend_batch_synthetic)
    cfg = get_smoke_config("musicgen_medium")
    want = {k: (v.shape, str(np.dtype(v.dtype)))
            for k, v in jabstract(jget_smoke("musicgen_medium"), 2, 8).items()}
    got = {k: (shape, str(dt)[6:])
           for k, (shape, dt) in frontend_batch_abstract(cfg, 2, 8).items()}
    assert got == want
    b = frontend_batch_synthetic(cfg, 2, 8, seed=4, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == {
        k: (shape, dt) for k, (shape, dt) in frontend_batch_abstract(
            cfg, 2, 8).items()}
    assert 0.005 < float(b["embeds"].float().std()) < 0.05
    assert torch.equal(b["embeds"], frontend_batch_synthetic(
        cfg, 2, 8, seed=4, device="cpu")["embeds"])
    m = build_model(cfg, RunConfig(compute_dtype=torch.float32))
    with torch.no_grad():
        loss, aux = m.loss_fn(m.init(device="cpu"), b)
    assert bool(torch.isfinite(loss)) and float(aux["tokens"]) == 16.0
