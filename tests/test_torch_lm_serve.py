"""LM serving of the port (the hybrid RecurrentGemma and the Mamba-2
families) against the reference, mirroring
``tests/test_models_consistency.py``.

Four configs, f32 compute: ``hybrid-window`` (the reference test's, window
8), ``recurrentgemma_9b.SMOKE`` (window 16), ``ssm`` (the reference test's
Mamba-2 config, chunk 8) and ``mamba2_2_7b.SMOKE`` (chunk 16). The
reference's ``init`` draws the weights; ``convert.tree_from_jax`` carries
them over. For the hybrids, prompt lengths cover S below the window, S = 2
x window (the sliding-window route) and S not a multiple of the window
(the banded fallback); each then decodes ``NEW`` tokens, past the window,
so the ring buffer wraps. For Mamba-2 they cover S below the chunk, S = 2
x chunk and S off a multiple (prefill pads to the chunk with dt = 0); the
decode steps then carry the conv and SSM states. The reference runs
jitted (the same functions).

Tolerances, as max |difference| / max |reference|:

* port vs reference (``forward``, ``prefill`` logits and caches, every
  ``decode_step``): 1e-5 — the same f32 algorithm on both sides, summed
  in other orders (observed up to 4e-6);
* the port's prefill -> decode vs its own forward: 1e-4, the reference
  test's bound for the same check;
* ``use_pallas=True`` on the CPU (the plain versions of K7, K8, K9 and
  K10) vs ``use_pallas=False``: 1e-5 — K8's plain version and the
  doubling scan compute the plain route's functions in another order;
* greedy ``generate``: tokens equal to the reference's at every step
  whose top-2 logit margin (reference) exceeds 1e-5 x max |logit|; after
  the first step below that margin the two may rightly diverge.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_2_7b as jm2
from repro.configs import recurrentgemma_9b as jrg
from repro.models import ModelConfig as JModelConfig
from repro.models import RunConfig as JRunConfig
from repro.models import build_model as jbuild_model
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs import mamba2_2_7b as tm2
from repro_torch.configs import recurrentgemma_9b as trg
from repro_torch.convert import tree_from_jax
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig, RunConfig
from repro_torch.models.lm import build_model
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve import engine as engine_mod

TOL = 1e-5
OWN_TOL = 1e-4
NEW = 8

CONFIGS = {
    "hybrid-window": dict(
        name="t", family="hybrid", n_layers=8, d_model=64, vocab=128,
        n_heads=4, n_kv_heads=1, d_ff=128, window=8,
        pattern=("rec", "rec", "attn"), d_rnn=64),
    "recurrentgemma-smoke": dataclasses.asdict(jrg.SMOKE),
    "ssm": dict(
        name="t", family="ssm", n_layers=3, d_model=64, vocab=128,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=8),
    "mamba2-smoke": dataclasses.asdict(jm2.SMOKE),
}
# hybrids: below the window, 2 x window (sliding route), not a multiple
# (banded); Mamba-2: below the chunk, 2 x chunk, not a multiple (padded)
LENGTHS = {"hybrid-window": (5, 16, 12),
           "recurrentgemma-smoke": (10, 32, 24),
           "ssm": (5, 16, 12), "mamba2-smoke": (10, 32, 24)}
CASES = [(name, s) for name in CONFIGS for s in LENGTHS[name]]


def _rel(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tree_rel(port, ref, path=""):
    """Worst relative difference over a cache tree; ``len`` exact."""
    worst = 0.0
    assert set(port) == set(ref), (path, sorted(port), sorted(ref))
    for k in ref:
        if isinstance(ref[k], dict):
            worst = max(worst, _tree_rel(port[k], ref[k], f"{path}{k}."))
            continue
        r = np.asarray(ref[k])
        p = port[k].numpy()
        assert p.shape == r.shape, (path + k, p.shape, r.shape)
        if k == "len":
            np.testing.assert_array_equal(p, r)
        elif np.abs(r).max() > 0:
            worst = max(worst, _rel(port[k], r))
    return worst


_REF = {}


def _reference(name, s):
    """The reference's model, weights, tokens and outputs for one case
    (computed once per module)."""
    if (name, s) in _REF:
        return _REF[(name, s)]
    cfg = JModelConfig(**CONFIGS[name])
    m = jbuild_model(cfg, JRunConfig(compute_dtype=jnp.float32,
                                     max_seq=s + NEW + 4))
    params = m.init(jax.random.PRNGKey(1))
    toks = np.random.default_rng(s).integers(
        0, cfg.vocab, (2, s + NEW)).astype(np.int32)
    full, _, _ = jax.jit(lambda p, b: m.forward(p, b, mode="train"))(
        params, {"tokens": jnp.asarray(toks)})
    last, caches = jax.jit(m.prefill)(params,
                                      {"tokens": jnp.asarray(toks[:, :s])})
    pre_caches = jax.tree.map(np.asarray, caches)
    decode = jax.jit(m.decode_step)
    steps = []
    for j in range(NEW):
        lg, caches = decode(params, {"tokens": jnp.asarray(
            toks[:, s + j:s + j + 1])}, caches, jnp.asarray(s + j, jnp.int32))
        steps.append(np.asarray(lg))
    out = dict(cfg=cfg, model=m, params=params, toks=toks,
               np_params=jax.tree.map(np.asarray, params),
               full=np.asarray(full), last=np.asarray(last),
               caches=pre_caches, steps=steps)
    _REF[(name, s)] = out
    return out


def _port(name, s, **run):
    cfg = ModelConfig(**CONFIGS[name])
    rcfg = RunConfig(compute_dtype=torch.float32, max_seq=s + NEW + 4, **run)
    ref = _reference(name, s)
    return build_model(cfg, rcfg), tree_from_jax(ref["np_params"], "cpu")


def _prefill_decode(model, params, toks, s):
    with torch.no_grad():
        last, caches = model.prefill(params,
                                     {"tokens": torch.from_numpy(toks[:, :s])})
        pre = jax.tree.map(lambda t: t.clone(), caches)
        steps = []
        for j in range(NEW):
            lg, caches = model.decode_step(
                params, {"tokens": torch.from_numpy(toks[:, s + j:s + j + 1])},
                caches, s + j)
            steps.append(lg)
    return last, pre, steps


@pytest.mark.parametrize("name,s", CASES)
def test_forward_matches_reference(name, s):
    ref = _reference(name, s)
    model, params = _port(name, s)
    with torch.no_grad():
        logits, caches, aux = model.forward(
            params, {"tokens": torch.from_numpy(ref["toks"])}, mode="train")
    assert caches is None and float(aux) == 0.0
    assert _rel(logits, ref["full"]) <= TOL


@pytest.mark.parametrize("name,s", CASES)
def test_prefill_and_decode_match_reference(name, s):
    ref = _reference(name, s)
    model, params = _port(name, s)
    last, caches, steps = _prefill_decode(model, params, ref["toks"], s)
    assert _rel(last, ref["last"]) <= TOL
    assert _tree_rel(caches, ref["caches"]) <= TOL
    for j in range(NEW):
        assert _rel(steps[j], ref["steps"][j]) <= TOL, f"decode step {j}"


@pytest.mark.parametrize("name,s", CASES)
def test_prefill_decode_matches_own_forward(name, s):
    ref = _reference(name, s)
    model, params = _port(name, s)
    with torch.no_grad():
        full, _, _ = model.forward(
            params, {"tokens": torch.from_numpy(ref["toks"])}, mode="train")
    last, _, steps = _prefill_decode(model, params, ref["toks"], s)
    assert _rel(last, full[:, s - 1]) <= OWN_TOL
    for j in range(NEW):
        assert _rel(steps[j], full[:, s + j]) <= OWN_TOL, f"decode step {j}"


@pytest.mark.parametrize("name,s", CASES)
def test_use_pallas_plain_versions_match_plain_route(name, s):
    """On CPU tensors ``use_pallas`` reaches the wrappers of K7, K8 and
    K10, which run their plain versions and launch nothing."""
    ref = _reference(name, s)
    plain, params = _port(name, s)
    kern, _ = _port(name, s, use_pallas=True)
    ops.reset_launches()
    last_p, caches_p, steps_p = _prefill_decode(plain, params, ref["toks"], s)
    last_k, caches_k, steps_k = _prefill_decode(kern, params, ref["toks"], s)
    assert all(v == 0 for v in ops.launch_counts().values())
    assert _rel(last_k, last_p) <= TOL
    assert _tree_rel(caches_k, jax.tree.map(lambda t: t.numpy(),
                                            caches_p)) <= TOL
    for j in range(NEW):
        assert _rel(steps_k[j], steps_p[j]) <= TOL, f"decode step {j}"


@pytest.mark.parametrize("name,s", [("hybrid-window", 12),
                                    ("recurrentgemma-smoke", 24),
                                    ("ssm", 12), ("mamba2-smoke", 24)])
def test_generate_greedy_matches_reference(name, s):
    ref = _reference(name, s)
    jeng = JServeEngine(ref["model"], ref["params"],
                        JServeConfig(max_new_tokens=NEW))
    want = np.asarray(jeng.generate(jnp.asarray(ref["toks"][:, :s]))[
        "tokens"])
    model, params = _port(name, s)
    eng = ServeEngine(model, params, ServeConfig(max_new_tokens=NEW))
    got = eng.generate(torch.from_numpy(ref["toks"][:, :s]))["tokens"]
    assert tuple(got.shape) == want.shape and eng.last_decode_steps == NEW - 1
    np.testing.assert_array_equal(got[:, :s].numpy(), want[:, :s])
    # the reference's logits along its own tokens: where is greedy decided?
    m = ref["model"]
    last, caches = jax.jit(m.prefill)(ref["params"],
                                      {"tokens": jnp.asarray(want[:, :s])})
    margins = []
    lg = np.asarray(last)
    for j in range(NEW):
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append(((top2[:, 1] - top2[:, 0])
                        / np.abs(lg).max()).min())
        if j + 1 < NEW:
            lg, caches = jax.jit(m.decode_step)(
                ref["params"], {"tokens": jnp.asarray(want[:, s + j:s + j + 1])},
                caches, jnp.asarray(s + j, jnp.int32))
            lg = np.asarray(lg)
    decided = next((j for j, mg in enumerate(margins) if mg <= TOL), NEW)
    assert decided > 0, f"no greedy step above the margin: {margins}"
    np.testing.assert_array_equal(got[:, s:s + decided].numpy(),
                                  want[:, s:s + decided])


def test_loss_and_cache_defs_match_reference():
    """``loss_fn`` (label smoothing on, a mask) and ``cache_defs`` against
    the reference's on the hybrid-window case (loss at 1e-5 relative)."""
    from repro.models.common import ParamDef as JParamDef
    from repro_torch.models.common import map_defs
    name, s = "hybrid-window", 12
    ref = _reference(name, s)
    toks = ref["toks"]
    mask = (np.arange(toks.shape[1])[None] % 3 != 0).astype(np.float32)
    mask = np.broadcast_to(mask, toks.shape).copy()
    labels = np.roll(toks, -1, axis=1)
    jm = jbuild_model(ref["cfg"], JRunConfig(compute_dtype=jnp.float32,
                                             label_smoothing=0.1))
    want, _ = jax.jit(jm.loss_fn)(ref["params"], {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
        "mask": jnp.asarray(mask)})
    model, params = _port(name, s, label_smoothing=0.1)
    with torch.no_grad():
        got, aux = model.loss_fn(params, {
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels),
            "mask": torch.from_numpy(mask)})
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    assert float(aux["tokens"]) == float(mask.sum())
    jshapes = jax.tree.map(lambda d: (d.shape, str(np.dtype(d.dtype))),
                           ref["model"].cache_defs(2, 32, jnp.float32),
                           is_leaf=lambda d: isinstance(d, JParamDef))
    tshapes = map_defs(lambda d: (d.shape, str(d.dtype)[6:]),
                       model.cache_defs(2, 32, torch.float32))
    assert tshapes == jshapes


# ------------------------------------------------------------ engine logic


class _ScriptedModel:
    """Logits that make greedy decoding emit a fixed token per row and
    step (the reference's ``tests/test_solve_health.py`` device)."""

    def __init__(self, script, vocab=16):
        self.script = np.asarray(script)
        self.vocab = vocab

    def _logits(self, step):
        onehot = np.eye(self.vocab, dtype=np.float32)[self.script[:, step]]
        return torch.from_numpy(onehot * 10.0)

    def prefill(self, params, batch):
        self._s = batch["tokens"].shape[1]
        return self._logits(0), {}

    def decode_step(self, params, batch, caches, pos):
        return self._logits(int(pos) - self._s + 1), caches


def test_generate_breaks_early_on_eos():
    eos = 7
    # rows finish after 3, 5 and 2 new tokens
    script = [[1, 2, eos, 3, 3, 3, 3, 3],
              [1, 2, 3, 4, eos, 3, 3, 3],
              [1, eos, 3, 3, 3, 3, 3, 3]]
    eng = ServeEngine(_ScriptedModel(script), {},
                      ServeConfig(max_new_tokens=8, eos_id=eos))
    out = eng.generate(torch.zeros((3, 4), dtype=torch.int32))["tokens"]
    # the loop stops right after the slowest row's eos: 4 decode steps
    assert eng.last_decode_steps == 4
    assert tuple(out.shape) == (3, 4 + 5)
    got = out[:, 4:].numpy()
    np.testing.assert_array_equal(got[0], [1, 2, eos, eos, eos])
    np.testing.assert_array_equal(got[1], [1, 2, 3, 4, eos])
    np.testing.assert_array_equal(got[2], [1, eos, eos, eos, eos])


def test_generate_all_eos_at_first_token():
    eos = 7
    eng = ServeEngine(_ScriptedModel([[eos] * 8, [eos] * 8]), {},
                      ServeConfig(max_new_tokens=8, eos_id=eos))
    out = eng.generate(torch.zeros((2, 4), dtype=torch.int32))["tokens"]
    assert eng.last_decode_steps == 0      # decode loop never entered
    assert tuple(out.shape) == (2, 5)
    np.testing.assert_array_equal(out[:, -1].numpy(), [eos, eos])


def test_generate_without_eos_runs_full_budget():
    eng = ServeEngine(_ScriptedModel([[1] * 8, [2] * 8]), {},
                      ServeConfig(max_new_tokens=8))
    out = eng.generate(torch.zeros((2, 4), dtype=torch.int32))["tokens"]
    assert eng.last_decode_steps == 7
    assert tuple(out.shape) == (2, 12)


@pytest.fixture(scope="module")
def smoke_lm():
    cfg = get_smoke_config("recurrentgemma_9b")
    model = build_model(cfg, RunConfig(compute_dtype=torch.float32,
                                       max_seq=32))
    return model, model.init(device="cpu", seed=3)


def test_generator_none_is_seed_zero_and_warns_once(smoke_lm, monkeypatch):
    import warnings
    monkeypatch.setattr(engine_mod, "_warned_default_generator", False)
    model, params = smoke_lm
    eng = ServeEngine(model, params, ServeConfig(max_new_tokens=4,
                                                 temperature=0.8))
    toks = torch.randint(0, 512, (2, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    with pytest.warns(UserWarning, match="seeded 0"):
        a = eng.generate(toks)["tokens"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # warns only once per process
        b = eng.generate(toks)["tokens"]
    c = eng.generate(toks, torch.Generator().manual_seed(0))["tokens"]
    assert torch.equal(a, b) and torch.equal(a, c)


def test_explicit_generators_vary_and_reproduce(smoke_lm, monkeypatch):
    import warnings
    monkeypatch.setattr(engine_mod, "_warned_default_generator", False)
    model, params = smoke_lm
    toks = torch.randint(0, 512, (2, 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    eng = ServeEngine(model, params, ServeConfig(max_new_tokens=6,
                                                 temperature=5.0))
    a1 = eng.generate(toks, torch.Generator().manual_seed(7))["tokens"]
    a2 = eng.generate(toks, torch.Generator().manual_seed(7))["tokens"]
    b = eng.generate(toks, torch.Generator().manual_seed(8))["tokens"]
    assert torch.equal(a1, a2) and not torch.equal(a1, b)
    greedy = ServeEngine(model, params, ServeConfig(max_new_tokens=3))
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # greedy draws nothing
        greedy.generate(toks)


# ------------------------------------------------- launcher and registry


def test_launch_serve_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "recurrentgemma_9b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "20", "--new-tokens", "4",
                "--use-pallas"])
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-smoke generated 4 tokens x 2 seqs" in out


def test_launch_serve_mamba2_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "mamba2_2_7b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "20", "--new-tokens", "4",
                "--use-pallas"])
    out = capsys.readouterr().out
    assert "arch=mamba2-smoke generated 4 tokens x 2 seqs" in out


def test_configs_match_the_reference_and_count_its_parameters():
    for port_cfg, ref_cfg in ((trg.CONFIG, jrg.CONFIG),
                              (trg.SMOKE, jrg.SMOKE),
                              (tm2.CONFIG, jm2.CONFIG),
                              (tm2.SMOKE, jm2.SMOKE)):
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)
        assert build_model(port_cfg).n_params() == \
            jbuild_model(ref_cfg).n_params()
    assert get_config("recurrentgemma-9b") is trg.CONFIG
    assert get_config("mamba2-2.7b") is tm2.CONFIG
    assert get_smoke_config("mamba2_2_7b") is tm2.SMOKE
    # the card serves all 64 layers at full width
    assert build_model(tm2.CONFIG).n_params() == 2_830_951_936
    # the card's cut: one (rec, rec, attn) group and the 2-layer rec tail
    cut = build_model(dataclasses.replace(trg.CONFIG, n_layers=5))
    assert 2.8e9 < cut.n_params() < 2.9e9


def test_later_slices_raise_named_errors():
    """Every arch of the registry builds now (the MoE block, the embeds
    frontends and NODE mode in the stack are ported, the sharded LM of
    slice I2, and a NODE stack on ``RunConfig.mesh``); what still raises
    names what is wrong: an unknown arch, an unknown ``remat`` policy."""
    with pytest.raises(KeyError):
        get_config("no_such_arch")
    assert get_config("qwen2_72b").family == "dense"
    assert get_config("mamba2_2_7b").family == "ssm"
    ssm = ModelConfig(name="t", family="ssm", n_layers=2, d_model=32,
                      vocab=64, ssm_state=8)
    assert "u0_ssm" in build_model(ssm).defs["stack"]
    moe = ModelConfig(name="t", family="moe", n_layers=2, d_model=32,
                      vocab=64, n_heads=2, n_kv_heads=2, n_experts=4,
                      top_k=2, d_expert=16)
    assert "moe" in build_model(moe).defs["stack"]["u0_moe_attn"]
    from repro_torch.core.node_block import NodeConfig
    with pytest.raises(ValueError, match="remat must be one of"):
        RunConfig(remat="layer", node=NodeConfig(enabled=True))
    cfg = get_smoke_config("recurrentgemma_9b")
    m = build_model(cfg, RunConfig(node=NodeConfig(
        enabled=True, regime="fixed", steps_per_interval=1)))
    with torch.no_grad():
        logits, _, _ = m.forward(m.init(device="cpu"), {
            "tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert bool(torch.isfinite(logits.float()).all())


def test_attention_routes_match_reference():
    """The reference's chunked, sliding-window and decode attention
    functions on the same arrays (f32, tolerance 1e-5)."""
    from repro.models import attention as jatt
    from repro_torch.models import attention as tatt
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for window in (0, 6):
        got = tatt.chunked_attention(tq, tk, tv, window=window, block=4)
        want = jatt.chunked_attention(jq, jk, jv, window=window, block=4)
        assert _rel(got, want) <= TOL
    got = tatt.sliding_window_attention(tq, tk, tv, window=4)
    want = jatt.sliding_window_attention(jq, jk, jv, window=4)
    assert _rel(got, want) <= TOL
    valid = rng.random((2, 16)) < 0.7
    got = tatt.decode_attention(tq[:, :1], tk, tv, torch.from_numpy(valid),
                                groups=1)
    want = jatt.decode_attention(jq[:, :1], jk, jv, jnp.asarray(valid),
                                 groups=1)
    assert _rel(got, want) <= TOL
