"""Every architecture of the registry on the port against the reference,
mirroring ``tests/test_arch_smoke.py``: the SMOKE configs' forward and one
train step (the reference's jitted), the published dims, the MoE configs,
parameter counts and the shape plan. Prefill and decode, with an MoE
case, and the ``embeds`` route are in ``test_torch_lm_consistency.py``.

The reference's ``init`` draws the weights and ``convert.tree_from_jax``
(``train_state_from_jax`` for a train state) carries them over; batches
come from the reference's ``tiny_batch`` (bf16 ``embeds`` for the
frontend archs are carried as their exact f32 values). Tolerances, as
max |difference| / max |reference|:

* train-mode logits, prefill and decode logits against the reference's:
  1e-5 (the same f32 algorithm, summed in other orders);
* one AdamW step (``build_train_step``, lr 1e-3): the loss and the raw
  gradient norm within 1e-5, every parameter within 1e-4 of the
  reference's absolute, a tenth of the step's size lr. The first AdamW
  step moves a weight by lr·g/(|g| + eps): where |g| >> eps that is
  ±lr whatever the rounding, but for a gradient near eps (1e-8) a
  difference of 1e-9 in g moves the step by ~lr/40 (observed 2.3e-5 on
  one of command_r_35b's 20,480 lm_head weights). A wrong update rule
  (sign, moments, decay) moves weights by ~lr, ten times the bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_batch
from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import RunConfig as JRunConfig
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import constant as jconstant
from repro.optim.grad_utils import CompressionState as JComp
from repro.train.loop import TrainLoopConfig as JLoopConfig
from repro.train.loop import build_train_step as jbuild_step
from repro.train.state import make_train_state as jmake_state
from repro_torch.configs import (ARCHS, LONG_CONTEXT_ARCHS, SHAPES,
                                 get_config, get_smoke_config, shape_plan)
from repro_torch.convert import train_state_from_jax, tree_from_jax
from repro_torch.models.config import RunConfig
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw, constant
from repro_torch.optim.grad_utils import CompressionState
from repro_torch.train.loop import TrainLoopConfig, build_train_step

TOL = 1e-5
STEP_ATOL = 1e-4


def _rel(a, b) -> float:
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _batch_to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32)).to(
                torch.bfloat16) if k == "embeds"
            else torch.from_numpy(np.array(np.asarray(v), copy=True))
            for k, v in batch.items()}


def test_registry_matches_the_reference():
    assert ARCHS == JARCHS
    for arch in ARCHS:
        for port, ref in ((get_config(arch), jget_config(arch)),
                          (get_smoke_config(arch), jget_smoke(arch))):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert SHAPES == {"train_4k": (4096, 256, "train"),
                      "prefill_32k": (32768, 32, "prefill"),
                      "decode_32k": (32768, 128, "decode"),
                      "long_500k": (524288, 1, "decode")}
    assert LONG_CONTEXT_ARCHS == ("recurrentgemma_9b", "mamba2_2_7b")
    with pytest.raises(KeyError):
        get_config("no_such_arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_and_train_step(arch):
    jcfg = jget_smoke(arch)
    cfg = get_smoke_config(arch)
    jm = jbuild_model(jcfg, JRunConfig(compute_dtype=jnp.float32))
    m = build_model(cfg, RunConfig(compute_dtype=torch.float32))
    jbatch = tiny_batch(jcfg, B=2, S=16)
    batch = _batch_to_torch(jbatch)

    jparams = jm.init(jax.random.PRNGKey(0))
    want, _, jaux = jax.jit(lambda p, b: jm.forward(p, b, mode="train"))(
        jparams, jbatch)
    params = tree_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    with torch.no_grad():
        logits, _, aux = m.forward(params, batch, mode="train")
    assert tuple(logits.shape) == (2, 16, cfg.vocab)
    assert bool(torch.isfinite(logits).all()), arch
    assert _rel(logits, want) <= TOL, arch
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(abs(float(jaux)), 1)

    jopt = jadamw(jconstant(1e-3))
    jstate = jmake_state(jm, jopt, jax.random.PRNGKey(1))
    jstate2, _, jmetrics = jax.jit(jbuild_step(jm, jopt, JLoopConfig()))(
        jstate, jbatch, JComp(error=()))
    opt = adamw(constant(1e-3))
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    state2, _, metrics = build_train_step(m, opt, TrainLoopConfig())(
        state, batch, CompressionState(error=()))
    assert bool(torch.isfinite(metrics["loss"]))
    assert int(state2.step) == 1 and int(metrics["skipped"]) == 0
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= \
        TOL * abs(float(jmetrics["loss"]))
    assert abs(float(metrics["grad_norm"]) - float(jmetrics["grad_norm"])) \
        <= TOL * abs(float(jmetrics["grad_norm"]))
    # parameters moved, and as the reference's did
    moved = any(bool((a != b).any()) for a, b in zip(
        jax.tree.leaves(state.params), jax.tree.leaves(state2.params)))
    assert moved, arch
    for got, ref in zip(jax.tree.leaves(state2.params),
                        jax.tree.leaves(jstate2.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=STEP_ATOL, err_msg=arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_dims_match_assignment(arch):
    cfg = get_config(arch)
    expected = {
        "qwen1_5_32b": (64, 5120, 40, 40, 27392, 152064),
        "qwen2_72b": (80, 8192, 64, 8, 29568, 152064),
        "command_r_plus_104b": (64, 12288, 96, 8, 33792, 256000),
        "command_r_35b": (40, 8192, 64, 8, 22528, 256000),
        "deepseek_moe_16b": (28, 2048, 16, 16, 1408, 102400),
        "qwen3_moe_235b_a22b": (94, 4096, 64, 4, 1536, 151936),
        "llava_next_34b": (60, 7168, 56, 8, 20480, 64000),
        "musicgen_medium": (48, 1536, 24, 24, 6144, 2048),
        "recurrentgemma_9b": (38, 4096, 16, 1, 12288, 256000),
        "mamba2_2_7b": (64, 2560, 0, 0, 0, 50280),
        "node18_cifar": (18, 768, 12, 12, 3072, 32768),
    }[arch]
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab)
    assert got == expected, (arch, got, expected)


def test_moe_configs():
    c = get_config("deepseek_moe_16b")
    assert (c.n_experts, c.n_shared_experts, c.top_k) == (64, 2, 6)
    c = get_config("qwen3_moe_235b_a22b")
    assert (c.n_experts, c.n_shared_experts, c.top_k) == (128, 0, 8)
    assert c.resolved_head_dim == 128


def test_shape_plan_skips():
    assert shape_plan("qwen2_72b", "long_500k") is None
    assert shape_plan("command_r_plus_104b", "long_500k") is None
    assert shape_plan("mamba2_2_7b", "long_500k") == (524288, 1, "decode")
    assert shape_plan("recurrentgemma_9b", "long_500k") is not None
    assert shape_plan("qwen2_72b", "train_4k") == (4096, 256, "train")
    assert shape_plan("qwen2_72b", "decode_32k")[2] == "decode"
    assert shape_plan("Qwen2-72B", "prefill_32k") == (32768, 32, "prefill")
    with pytest.raises(KeyError):
        shape_plan("qwen2_72b", "no_such_shape")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch):
    """Every full config's parameter count is the reference's; the three
    of the reference's sanity test sit within its band of the advertised
    size."""
    n = build_model(get_config(arch)).n_params()
    assert n == jbuild_model(jget_config(arch), JRunConfig()).n_params()
    advertised = {"qwen2_72b": 72e9, "deepseek_moe_16b": 16e9,
                  "mamba2_2_7b": 2.7e9}.get(arch)
    if advertised:
        assert 0.75 * advertised < n < 1.35 * advertised, (arch, n)
