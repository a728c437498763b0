"""The port's train loop, checkpoints, optimizers' SGD and gradient
utilities, mirroring the ten tests of ``tests/test_train_and_ckpt.py``
and the three train-loop guard tests of ``tests/test_solve_health.py``
(``test_clip_by_global_norm_nonfinite``,
``test_train_step_skips_nonfinite_update``,
``test_train_loop_counts_skipped_steps``).

Where a mirror computes what the reference computes on the same numbers
(a TokenPipeline batch, the clip, the compressions, one SGD step), it is
also held against the reference: TokenPipeline bitwise (numpy draws),
clip and int8/top-k outputs within 1e-6 relative, the microbatched SGD
step's parameters within 1e-6 of the reference's (absolute; lr 0.1, no
momentum, gradients summed in another order). The loss-decrease,
restart, atomicity, keep-k and straggler checks are the reference's own,
on the port. A bf16 tree's checkpoint round trip is bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import TokenPipeline as JTokenPipeline
from repro.models import ModelConfig as JModelConfig
from repro.models import RunConfig as JRunConfig
from repro.models import build_model as jbuild_model
from repro.optim import sgd as jsgd
from repro.optim import step_decay as jstep_decay
from repro.optim.grad_utils import CompressionState as JComp
from repro.optim.grad_utils import clip_by_global_norm as jclip
from repro.optim.grad_utils import int8_compress_decompress as jint8
from repro.optim.grad_utils import topk_sparsify as jtopk
from repro.train.loop import TrainLoopConfig as JLoopConfig
from repro.train.loop import build_train_step as jbuild_step
from repro.train.state import make_train_state as jmake_state
from repro_torch.ckpt import CheckpointManager, save_checkpoint
from repro_torch.convert import train_state_from_jax
from repro_torch.data import TokenPipeline
from repro_torch.models.config import ModelConfig, RunConfig
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw, cosine_warmup, sgd, step_decay
from repro_torch.optim.grad_utils import (CompressionState,
                                          clip_by_global_norm, global_norm,
                                          init_compression_state,
                                          int8_compress_decompress,
                                          topk_sparsify)
from repro_torch.train import (TrainLoop, TrainLoopConfig, TrainState,
                               build_train_step, make_train_state)

CFG_KW = dict(name="t", family="dense", n_layers=2, d_model=64, vocab=256,
              n_heads=4, n_kv_heads=2, d_ff=128)
CFG = ModelConfig(**CFG_KW)


def _pipe(**kw):
    return TokenPipeline(device="cpu", **kw)


def _loop(tmpdir, **kw):
    m = build_model(CFG, RunConfig(compute_dtype=torch.float32))
    opt = adamw(cosine_warmup(3e-3, 5, 200), weight_decay=0.01)
    lcfg = TrainLoopConfig(ckpt_dir=str(tmpdir) if tmpdir else None,
                           ckpt_every=5, log_every=1, **kw)
    state = make_train_state(m, opt, seed=0, device="cpu")
    return m, opt, lcfg, TrainLoop(m, opt, lcfg, state)


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def test_token_pipeline_is_the_references_bitwise():
    for kw in (dict(vocab=256, seq_len=32, global_batch=8),
               dict(vocab=32768, seq_len=16, global_batch=4, seed=3)):
        for step in (0, 7):
            want = JTokenPipeline(**kw).batch(step)
            got = _pipe(**kw).batch(step)
            for k in ("tokens", "labels", "mask"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
                assert str(got[k].dtype)[6:] == str(np.asarray(want[k]).dtype)
    # a host's slice is the global batch's rows
    p = _pipe(vocab=256, seq_len=8, global_batch=8)
    np.testing.assert_array_equal(p.batch(2, host_slice=(1, 4))["tokens"],
                                  p.batch(2)["tokens"][2:4])


def test_loss_decreases(tmp_path):
    pipe = _pipe(vocab=256, seq_len=32, global_batch=8)
    _, _, _, loop = _loop(None)
    losses = []
    loop.run(lambda s: pipe.batch(0), 25,        # overfit one batch
             log_cb=lambda s, mt: losses.append(mt["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[:3] + losses[-3:]


def test_checkpoint_restart_exact(tmp_path):
    pipe = _pipe(vocab=256, seq_len=32, global_batch=8)
    m, opt, lcfg, loop = _loop(tmp_path)
    loop.run(lambda s: pipe.batch(s), 10)
    params_10 = _leaves(loop.state.params)

    # a fresh loop restores step 10 exactly and continues
    state2 = make_train_state(m, opt, seed=42, device="cpu")
    loop2 = TrainLoop(m, opt, lcfg, state2)
    assert loop2.step == 10
    for a, b in zip(params_10, _leaves(loop2.state.params)):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(loop.state.opt_state),
                    _leaves(loop2.state.opt_state)):
        assert torch.equal(a, b)

    # deterministic data: running 10->12 equals an uninterrupted run
    loop2.run(lambda s: pipe.batch(s), 12)
    _, _, _, loop3 = _loop(None)
    loop3.run(lambda s: pipe.batch(s), 12)
    for a, b in zip(_leaves(loop2.state.params), _leaves(loop3.state.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_ckpt_atomicity_and_fallback(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros((3,))}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, tree)
    mgr.save(2, {k: v + 1 for k, v in tree.items()})
    # corrupt the newest manifest -> restore falls back to step 1
    os.remove(os.path.join(str(tmp_path), "step_0000000002",
                           "manifest.json"))
    step, restored = mgr.restore(tree)
    assert step == 1
    assert torch.equal(restored["w"], tree["w"])
    # a half-written step (no rename) is never the latest
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp"))
    assert mgr.latest_step() == 1


def test_ckpt_keep_k_gc(tmp_path):
    tree = {"x": torch.ones((2,))}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    names = sorted(os.listdir(str(tmp_path)))
    assert names == ["step_0000000003", "step_0000000004"]


def test_ckpt_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.ones((2,))})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore({"x": torch.ones((3,))}) is None
    # and a tree of another structure
    assert mgr.restore({"y": torch.ones((2,))}) is None
    assert mgr.restore({"x": torch.ones((2,))})[0] == 1


def test_ckpt_bf16_round_trip_is_bitwise(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = TrainState(
        step=torch.tensor(3, dtype=torch.int32),
        params={"w": torch.randn(5, 7, generator=g).to(torch.bfloat16),
                "v": torch.randn(4, generator=g) * 1e30},
        opt_state={"i": torch.arange(4, dtype=torch.int64),
                   "h": torch.tensor([-0.0, float("inf")]).to(
                       torch.float16)})
    save_checkpoint(str(tmp_path), 3, tree)
    step, back = CheckpointManager(str(tmp_path)).restore(tree)
    assert step == 3 and isinstance(back, TrainState)
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                           b.view(torch.uint8) if b.dim() else b)


def test_microbatch_accumulation_matches_full_batch():
    pipe = _pipe(vocab=256, seq_len=16, global_batch=8)
    m = build_model(CFG, RunConfig(compute_dtype=torch.float32))
    opt = sgd(step_decay(0.1, [1000]), momentum=0.0)
    batch = pipe.batch(0)
    s1 = build_train_step(m, opt, TrainLoopConfig(microbatches=1,
                                                  clip_norm=1e9))
    s4 = build_train_step(m, opt, TrainLoopConfig(microbatches=4,
                                                  clip_norm=1e9))
    jm = jbuild_model(JModelConfig(**CFG_KW),
                      JRunConfig(compute_dtype=jnp.float32))
    jopt = jsgd(jstep_decay(0.1, [1000]), momentum=0.0)
    jst = jmake_state(jm, jopt, jax.random.PRNGKey(0))
    jr4, _, _ = jax.jit(jbuild_step(jm, jopt, JLoopConfig(
        microbatches=4, clip_norm=1e9)))(
        jst, JTokenPipeline(vocab=256, seq_len=16, global_batch=8).batch(0),
        JComp(error=()))
    st = train_state_from_jax(jax.tree.map(np.asarray, jst), "cpu")
    r1, _, _ = s1(st, batch, CompressionState(error=()))
    r4, _, _ = s4(st, batch, CompressionState(error=()))
    for a, b, ref in zip(_leaves(r1.params), _leaves(r4.params),
                         jax.tree.leaves(jr4.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6)


def test_sgd_momentum_and_nesterov_match_reference():
    rng = np.random.default_rng(1)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    gs = [{k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in p.items()} for _ in range(3)]
    for nesterov in (False, True):
        jopt = jsgd(0.05, momentum=0.9, nesterov=nesterov, weight_decay=0.1)
        opt = sgd(0.05, momentum=0.9, nesterov=nesterov, weight_decay=0.1)
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
        js, ts = jopt.init(jp), opt.init(tp)
        for g in gs:
            ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 js, jp)
            tu, ts = opt.update({k: torch.from_numpy(v) for k, v in
                                 g.items()}, ts, tp)
            jp = {k: jp[k] + ju[k] for k in jp}
            tp = {k: tp[k] + tu[k] for k in tp}
        assert int(ts.step) == 3
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


def test_clip_by_global_norm():
    g = {"a": torch.ones((4,)) * 3.0, "b": torch.ones((2, 2)) * 4.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) > 1.0
    jc, jn = jclip({k: jnp.asarray(v.numpy()) for k, v in g.items()}, 1.0)
    assert abs(float(norm) - float(jn)) <= 1e-6 * float(jn)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)
    # below the threshold: unchanged
    clipped2, _ = clip_by_global_norm(g, 1e9)
    assert torch.equal(clipped2["a"], g["a"])


def test_int8_compression_error_feedback():
    """Error feedback makes repeated compression of a constant gradient
    unbiased: the mean dequantized value converges to the truth."""
    g = {"w": torch.linspace(-1.0, 1.0, 101) * 1e-3}
    state = init_compression_state(g)
    total = torch.zeros_like(g["w"])
    n = 50
    for _ in range(n):
        out, state = int8_compress_decompress(g, state)
        total = total + out["w"]
    np.testing.assert_allclose((total / n).numpy(), g["w"].numpy(),
                               rtol=0.02, atol=2e-7)
    # one step is the reference's
    jout, jst = jint8({"w": jnp.asarray(g["w"].numpy())})
    out, st = int8_compress_decompress(g)
    np.testing.assert_allclose(out["w"].numpy(), np.asarray(jout["w"]),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(st.error["w"].numpy(),
                               np.asarray(jst.error["w"]), rtol=1e-5,
                               atol=1e-12)


def test_topk_sparsity_and_feedback():
    g = {"w": torch.arange(1.0, 101.0)}
    out, state = topk_sparsify(g, 0.1)
    assert int((out["w"] != 0).sum()) == 10
    # the residual holds everything that was dropped
    np.testing.assert_allclose((out["w"] + state.error["w"]).numpy(),
                               g["w"].numpy(), rtol=1e-6)
    jout, _ = jtopk({"w": jnp.asarray(g["w"].numpy())}, 0.1)
    np.testing.assert_array_equal(out["w"].numpy(), np.asarray(jout["w"]))


def test_straggler_hook_fires():
    pipe = _pipe(vocab=256, seq_len=16, global_batch=4)
    hits = []
    m = build_model(CFG, RunConfig(compute_dtype=torch.float32))
    opt = adamw(cosine_warmup(1e-3, 5, 100))
    lcfg = TrainLoopConfig(straggler_factor=3.0)
    state = make_train_state(m, opt, seed=0, device="cpu")
    # injected clock: step 2 takes 31 fake-seconds (a straggler)
    seq = [0.0, 1.0, 1.0, 2.0, 2.0, 33.0, 33.0, 34.0, 34.0, 35.0]
    calls = [0]

    def fake_clock():
        i = calls[0]
        calls[0] += 1
        return seq[i] if i < len(seq) else seq[-1] + (i - len(seq)) + 1.0

    loop = TrainLoop(m, opt, lcfg, state, clock=fake_clock,
                     straggler_cb=lambda s, ratio: hits.append((s, ratio)))
    loop.run(lambda s: pipe.batch(s), 5)
    assert hits, "straggler callback never fired"
    assert max(r for _, r in hits) > 5


# ------------------------------------------------------------ train guards

def test_clip_by_global_norm_nonfinite():
    g = {"a": torch.ones((3,)), "b": torch.tensor([float("inf"), 1.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert not bool(torch.isfinite(norm))     # raw norm surfaces the Inf
    for leaf in _leaves(clipped):             # default: zeroed, not NaN
        assert torch.equal(leaf, torch.zeros_like(leaf))
    clipped, norm = clip_by_global_norm(g, 1.0, on_nonfinite="keep")
    assert torch.equal(clipped["a"], g["a"])  # kept unclipped, unscaled
    with pytest.raises(ValueError, match="on_nonfinite"):
        clip_by_global_norm(g, 1.0, on_nonfinite="explode")
    # healthy path unchanged
    g2 = {"a": torch.ones((3,)) * 3.0}
    clipped, norm = clip_by_global_norm(g2, 1.0)
    np.testing.assert_allclose(float(norm), 3.0 * np.sqrt(3.0), rtol=1e-6)
    np.testing.assert_allclose(float(torch.linalg.norm(clipped["a"])), 1.0,
                               rtol=1e-6)


class _ToyModel:
    """Quadratic toy whose loss goes NaN whenever the batch does."""

    def loss_fn(self, params, batch):
        loss = torch.mean((params["w"] * batch["x"] - 1.0) ** 2)
        return loss, {}


def _toy_state(opt):
    params = {"w": torch.ones((4,))}
    return TrainState(step=torch.zeros((), dtype=torch.int32), params=params,
                      opt_state=opt.init(params))


def test_train_step_skips_nonfinite_update():
    model, opt = _ToyModel(), adamw(lambda s: torch.tensor(1e-2))
    state = _toy_state(opt)
    step = build_train_step(model, opt, TrainLoopConfig())
    comp = CompressionState(error=())
    clean = {"x": torch.ones((4,)) * 2.0}
    poison = {"x": torch.full((4,), float("nan"))}

    s1, comp, m1 = step(state, clean, comp)
    assert int(m1["skipped"]) == 0
    assert float((s1.params["w"] - state.params["w"]).abs().max()) > 0.0

    s2, comp, m2 = step(s1, poison, comp)
    assert int(m2["skipped"]) == 1
    assert int(s2.step) == int(s1.step) + 1   # step advances anyway
    assert torch.equal(s2.params["w"], s1.params["w"])   # update held
    for a, b in zip(_leaves(s2.opt_state), _leaves(s1.opt_state)):
        assert torch.equal(a, b)

    # guard off: no skip metric; the params stay finite only because the
    # clip zeroes the non-finite grads, and AdamW's stale momentum still
    # moves them on the poisoned step
    step_raw = build_train_step(model, opt,
                                TrainLoopConfig(skip_nonfinite=False))
    s3, _, m3 = step_raw(s1, poison, comp)
    assert "skipped" not in m3
    assert not bool(torch.isfinite(m3["loss"]))
    assert bool(torch.isfinite(s3.params["w"]).all())
    assert float((s3.params["w"] - s1.params["w"]).abs().max()) > 0.0


def test_train_loop_counts_skipped_steps():
    model, opt = _ToyModel(), adamw(lambda s: torch.tensor(1e-2))
    loop = TrainLoop(model, opt, TrainLoopConfig(log_every=1),
                     _toy_state(opt))

    def batch_fn(s):
        if s == 1:
            return {"x": torch.full((4,), float("nan"))}
        return {"x": torch.ones((4,)) * 2.0}

    loop.run(batch_fn, 3)
    assert loop.skipped_steps == 1
    assert bool(torch.isfinite(loop.state.params["w"]).all())


def test_train_step_holds_the_compression_state_on_a_skip():
    model, opt = _ToyModel(), sgd(0.1, momentum=0.9)
    state = _toy_state(opt)
    step = build_train_step(model, opt, TrainLoopConfig(compression="int8"))
    comp = init_compression_state(state.params)
    s1, c1, _ = step(state, {"x": torch.ones((4,)) * 2.0}, comp)
    s2, c2, m2 = step(s1, {"x": torch.full((4,), float("nan"))}, c1)
    assert int(m2["skipped"]) == 1
    assert torch.equal(c2.error["w"], c1.error["w"])
    assert torch.equal(s2.opt_state.velocity["w"], s1.opt_state.velocity["w"])
