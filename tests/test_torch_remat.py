"""``RunConfig.remat="block"`` on the port: each layer group of a train
step under ``torch.utils.checkpoint`` (``models/transformer.py::
stack_apply``), where the reference's ``jax.checkpoint`` wraps its scan
body (``src/repro/models/transformer.py``, ``remat == "block"``).

* Every family's smoke config (dense, MoE, hybrid, SSM; f32, mesh-less)
  and node18 in NODE mode (``NODE_TRAIN``): the loss and every gradient
  bitwise the un-rematted step's, and the groups' blocks run twice (the
  recompute), the tail once.
* NODE mode: ``Model.node_stats`` holds one entry per block, and each
  adaptive solve recomputed in the backward takes the grid and the
  output of its first pass, bit for bit.
* Prefill and decode ignore ``remat``: their logits and caches are
  bitwise the ``"none"`` run's.
* An unknown policy raises ``ValueError``.
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_smoke_config
from repro_torch.configs import node18_cifar as n18
from repro_torch.models import transformer
from repro_torch.models.config import RunConfig
from repro_torch.models.lm import build_model
from repro_torch.train.loop import _grads_of

B, S = 2, 16
FAMILIES = ["qwen2_72b", "deepseek_moe_16b", "recurrentgemma_9b",
            "mamba2_2_7b"]


@pytest.fixture(autouse=True)
def one_thread():
    """Smoke-size steps are thousands of tiny ops: one thread runs them
    fastest, and keeps them fast beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(np.roll(toks, -1, axis=1)),
            "mask": torch.ones(B, S)}


def _step(cfg, remat, monkeypatch, **run):
    """(loss, gradient leaves, node_stats, block calls) of one train
    step."""
    m = build_model(cfg, RunConfig(compute_dtype=torch.float32,
                                   remat=remat, **run))
    m.node_stats = []
    calls = []
    apply_ = transformer.block_apply

    def counted(p, x, cfg_, rcfg, kind, **kw):
        calls.append(kind)
        return apply_(p, x, cfg_, rcfg, kind, **kw)

    monkeypatch.setattr(transformer, "block_apply", counted)
    params = m.init(seed=1, device="cpu")
    loss, _, grads = _grads_of(m, params, _batch(cfg))
    monkeypatch.undo()
    return loss, pytree.tree_leaves(grads), m.node_stats, len(calls)


@pytest.mark.parametrize("arch", FAMILIES + ["node18_node"])
def test_remat_block_gradients_are_bitwise(arch, monkeypatch):
    node = arch == "node18_node"
    cfg = n18.SMOKE if node else get_smoke_config(arch)
    run = {"node": n18.NODE_TRAIN} if node else {}
    loss0, g0, st0, calls0 = _step(cfg, "none", monkeypatch, **run)
    loss1, g1, st1, calls1 = _step(cfg, "block", monkeypatch, **run)
    assert torch.equal(loss0, loss1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    # the groups' blocks ran again in the backward, the tail did not
    unit, n_groups, tail = transformer.stack_plan(cfg)
    assert n_groups > 1
    per_block = calls0 // cfg.n_layers if not node else None
    if not node:
        assert calls0 == cfg.n_layers * per_block
        assert calls1 == calls0 + n_groups * len(unit) * per_block
    else:
        assert calls1 > calls0
        # one entry per block, the same solves
        assert [(k, i) for k, i, _ in st1] == [(k, i) for k, i, _ in st0]
        assert len(st1) == cfg.n_layers
        for (_, _, a), (_, _, b) in zip(st0, st1):
            assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_recomputed_node_solve_takes_its_first_grid(monkeypatch):
    """Under remat every NODE block of a group is solved twice, forward
    and in the backward's recompute: the adaptive solve (NODE_TRAIN:
    HeunEuler 1e-2, segmented ACA, fused path) takes the same steps,
    trials and evaluations and returns the same z(1) bit for bit."""
    seen = []
    node_block = transformer._node_block

    def recording(p, x, *a):
        z, stats = node_block(p, x, *a)
        seen.append((z.detach().clone(), stats))
        return z, stats

    monkeypatch.setattr(transformer, "_node_block", recording)
    cfg = n18.SMOKE
    m = build_model(cfg, RunConfig(compute_dtype=torch.float32,
                                   remat="block", node=n18.NODE_TRAIN))
    m.node_stats = []
    _grads_of(m, m.init(seed=1, device="cpu"), _batch(cfg))
    n = cfg.n_layers
    assert len(seen) == 2 * n and len(m.node_stats) == n
    # the forward solves block after block; the backward recomputes the
    # groups last to first
    first, again = seen[:n], seen[n:][::-1]
    for (z0, s0), (z1, s1) in zip(first, again):
        assert torch.equal(z0, z1)
        for a, b in zip(s0, s1):
            assert torch.equal(a, b)
    assert any(int(s.n_trials) > 1 for _, s in first)


def test_prefill_and_decode_ignore_remat():
    cfg = get_smoke_config("recurrentgemma_9b")
    toks = _batch(cfg)["tokens"]
    outs = []
    for remat in ("none", "block"):
        m = build_model(cfg, RunConfig(compute_dtype=torch.float32,
                                       remat=remat, max_seq=S + 2))
        params = m.init(seed=1, device="cpu")
        with torch.no_grad():
            lg, caches = m.prefill(params, {"tokens": toks[:, :S - 1]})
            lg2, caches = m.decode_step(params, {"tokens": toks[:, -1:]},
                                        caches, S - 1)
        outs.append((lg, lg2, pytree.tree_leaves(caches)))
    (a1, a2, ac), (b1, b2, bc) = outs
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert all(torch.equal(x, y) for x, y in zip(ac, bc))


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat"):
        RunConfig(remat="full")
