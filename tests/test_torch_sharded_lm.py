"""The sharded LM on the port: parameters, activations, KV caches and
optimizer moments placed on a torch ``DeviceMesh`` by the reference's
logical-axis rules, mirroring ``tests/test_distributed.py::
test_sharded_equals_unsharded`` (its three configs, B = 4, S = 16, f32,
on a ``(data=2, model=4)`` mesh; and a hybrid RG-LRU config) and adding
what the port's slice owes.

The ranks are spawned once for the whole file: a module fixture writes
the reference's weights (its ``init``, carried over), batch and decode
tokens and a mesh-less checkpoint to a directory, runs
``tests/torch_sharded_lm_ranks.py`` (8 gloo ranks on the CPU), and
meanwhile computes here the port's unsharded results and the
reference's. On the CPU the kernel route (``use_pallas=True``) takes the
kernels' plain versions.

NODE blocks on the mesh (node18's smoke width at one layer in NODE
mode, the reference's weights; ``torch_sharded_lm_ranks.node_cases``): the loss and
gradients at the same bounds against the mesh-less port, each block's
steps, trials, evaluations and status equal to the mesh-less run's and
the same on every rank; the mesh-less port against the reference at
``tests/test_torch_node_lm.py``'s bounds (loss 1e-5 relative, every
gradient leaf within 1e-4 of the reference's largest entry). The
lockstep case's two batch halves, solved alone, take different grids;
on the mesh every rank takes the whole batch's, with the same number of
field evaluations and collectives.

Tolerances: the sharded loss within 5e-4 of the unsharded one and the
gradients within rtol 2e-2 / atol 2e-4, flash-decode logits within 2e-4
(the reference test's bounds); the port's unsharded loss within 1e-5
relative of the reference's (``tests/test_torch_lm_consistency.py``'s
bound). Exact: the router's ids, the init on a mesh, a checkpoint
carried between mesh and no mesh, int8 and top-k compression of whole
gradients.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from conftest import tiny_batch
from repro.configs import get_smoke_config as jget_smoke
from repro.configs import node18_cifar as jn18
from repro.core import NodeConfig as JNodeConfig
from repro.models import ModelConfig as JModelConfig
from repro.models import RunConfig as JRunConfig
from repro.models import build_model as jbuild_model
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import node18_cifar as tn18
from repro_torch.convert import tree_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig, RunConfig
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw
from repro_torch.optim.grad_utils import (clip_by_global_norm,
                                          int8_compress_decompress,
                                          topk_sparsify)
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import TrainLoop, TrainLoopConfig, TrainState
from repro_torch.train.loop import _grads_of

from torch_sharded_lm_ranks import (B, CLIP, DECODE_STEPS, MAX_SEQ, S,
                                    TOPK_FRAC, WORLD, configs, decode_cases,
                                    flat, lockstep_inputs, nest, node_cases,
                                    node_model, node_stats_array,
                                    port_node_cases)

ROOT = Path(__file__).resolve().parent.parent
NAMES = [c.name for c in configs(ModelConfig)]
LOSS_ATOL = 5e-4
GRAD_RTOL, GRAD_ATOL = 2e-2, 2e-4
DECODE_TOL = 2e-4
REF_TOL = 1e-5
NODE_GRAD_TOL = 1e-4        # tests/test_torch_node_lm.py's GRAD_TOL
NODE_REF = list(node_cases(JNodeConfig, jn18))
NODE_PORT = list(port_node_cases())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _state(params, opt):
    return TrainState(step=torch.zeros((), dtype=torch.int32),
                      params=params, opt_state=opt.init(params))


class Results:
    """Everything the tests compare: the ranks' files and this process's
    unsharded port and reference results."""

    def __init__(self):
        self.ranks = []
        self.ref_loss, self.ref_decode = {}, {}
        self.loss, self.grads, self.ids = {}, {}, []
        self.decode, self.train = {}, {}
        self.node, self.node_ref, self.halves = {}, {}, {}

    def rank(self, r: int = 0):
        return self.ranks[r]


def _inputs(in_dir: Path, res: Results):
    """The reference's weights, batch and tokens for the ranks, and the
    reference's own results meanwhile."""
    batch = tiny_batch(configs(JModelConfig)[0], B=B, S=S)
    np.savez(in_dir / "batch.npz", **{k: np.asarray(v)
                                      for k, v in batch.items()})
    toks = jax.random.randint(jax.random.PRNGKey(1), (B, S + DECODE_STEPS),
                              0, 128, jnp.int32)
    np.savez(in_dir / "decode.npz", tokens=np.asarray(toks))
    refs = {}
    for cfg in configs(JModelConfig):
        jm = jbuild_model(cfg, JRunConfig(compute_dtype=jnp.float32,
                                          max_seq=MAX_SEQ))
        p = _np(jm.init(jax.random.PRNGKey(0)))
        np.savez(in_dir / f"params_{cfg.name}.npz", **flat(p))
        refs[cfg.name] = (jm, p)
    # a mesh-less checkpoint (step 5, nu not zero) for the ranks
    st = _state(tree_from_jax(refs["dense"][1], "cpu"), adamw(1e-3))
    gen = torch.Generator().manual_seed(5)
    five = torch.tensor(5, dtype=torch.int32)
    st = st._replace(step=five, opt_state=st.opt_state._replace(
        step=five, nu=pytree.tree_map(
            lambda t: torch.rand(t.shape, generator=gen), st.opt_state.nu)))
    save_checkpoint(str(in_dir / "ckpt_plain"), 5, st)
    res.plain_ckpt = st
    jm = jbuild_model(node_model(jget_smoke("node18_cifar")),
                      JRunConfig(compute_dtype=jnp.float32))
    p = _np(jm.init(jax.random.PRNGKey(0)))
    np.savez(in_dir / "params_node18.npz", **flat(p))
    refs["node18"] = (None, p)
    return batch, toks, refs


def _node_reference(batch, p, res: Results):
    """The reference's loss and gradients of each NODE case."""
    for name, ncfg in node_cases(JNodeConfig, jn18).items():
        jm = jbuild_model(node_model(jget_smoke("node18_cifar")),
                          JRunConfig(compute_dtype=jnp.float32, node=ncfg))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            jm.loss_fn, has_aux=True))(p, batch)
        res.node_ref[name] = (float(loss), flat(_np(grads)))


def _node_unsharded(batch, p, res: Results):
    """The mesh-less port's NODE cases; the lockstep case's batch halves
    solved alone too."""
    flat_b = {k: np.asarray(v) for k, v in batch.items()}
    inputs = {False: (flat(p), flat_b),
              True: lockstep_inputs(flat(p), flat_b, tn18.SMOKE.vocab)}

    def run(ncfg, fp, b):
        m = build_model(node_model(tn18.SMOKE), RunConfig(
            compute_dtype=torch.float32, node=ncfg))
        m.node_stats = []
        loss, _, grads = _grads_of(m, tree_from_jax(nest(fp), "cpu"),
                                   {k: torch.from_numpy(np.array(v))
                                    for k, v in b.items()})
        return (float(loss), {k: v.numpy() for k, v in flat(grads).items()},
                node_stats_array(m.node_stats))

    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # tiny ops, beside the 8 ranks: one thread
    try:
        for name, ncfg in port_node_cases().items():
            fp, b = inputs[name == "lockstep"]
            res.node[name] = run(ncfg, fp, b)
            if name == "lockstep":
                half = B // 2
                for part, rows in (("lower", slice(0, half)),
                                   ("upper", slice(half, B))):
                    res.halves[part] = run(
                        ncfg, fp, {k: v[rows] for k, v in b.items()})[2]
    finally:
        torch.set_num_threads(threads)


def _reference(batch, toks, refs, res: Results):
    for name, (jm, p) in refs.items():
        if jm is not None:
            res.ref_loss[name] = float(jax.jit(jm.loss_fn)(p, batch)[0])
    jm, p = refs["dense"]
    lg, c = jm.prefill(p, {"tokens": toks[:, :S]})
    res.ref_decode["prefill"] = np.asarray(lg)
    for j in range(DECODE_STEPS):
        lg, c = jm.decode_step(p, {"tokens": toks[:, S + j:S + j + 1]}, c,
                               jnp.asarray(S + j, jnp.int32))
        res.ref_decode[j] = np.asarray(lg)


def _unsharded(batch, toks, refs, res: Results):
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    for cfg in configs(ModelConfig):
        m = build_model(cfg, RunConfig(compute_dtype=torch.float32))
        params = tree_from_jax(refs[cfg.name][1], "cpu")
        loss, _, grads = _grads_of(m, params, tb)
        res.loss[cfg.name] = float(loss)
        res.grads[cfg.name] = {k: v.numpy() for k, v in flat(grads).items()}
        if cfg.name == "moe":
            top_k = tmoe._top_k

            def record(probs, c):
                ids, gates = top_k(probs, c)
                res.ids.append(ids.numpy().copy())
                return ids, gates

            tmoe._top_k = record
            try:
                with torch.no_grad():
                    m.forward(params, tb)
            finally:
                tmoe._top_k = top_k
    tt = torch.from_numpy(np.array(toks))
    for cfg in configs(ModelConfig):
        m = build_model(cfg, RunConfig(compute_dtype=torch.float32,
                                       max_seq=MAX_SEQ))
        params = tree_from_jax(refs[cfg.name][1], "cpu")
        got = res.decode[cfg.name] = {}
        with torch.no_grad():
            lg, c = m.prefill(params, {"tokens": tt[:, :S]})
            got["prefill"] = lg.numpy()
            for j in range(DECODE_STEPS):
                lg, c = m.decode_step(
                    params, {"tokens": tt[:, S + j:S + j + 1]}, c, S + j)
                got[j] = lg.numpy()
        if cfg.name == "dense":
            res.engine = ServeEngine(m, params, ServeConfig(
                max_new_tokens=DECODE_STEPS + 1)).generate(
                    tt[:, :S])["tokens"].numpy()
    # two AdamW steps without a mesh, as the ranks take them
    m = build_model(configs(ModelConfig)[0],
                    RunConfig(compute_dtype=torch.float32))
    params = tree_from_jax(refs["dense"][1], "cpu")
    opt = adamw(1e-3, weight_decay=0.1)
    loop = TrainLoop(m, opt, TrainLoopConfig(clip_norm=1.0, log_every=1),
                     _state(params, opt))
    losses = []
    loop.run(lambda s: tb, 2, log_cb=lambda s, mt: losses.append(mt["loss"]))
    res.train["losses"] = np.array(losses)
    res.train["state"] = loop.state


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Runs the 8 ranks once for the file; the unsharded port and the
    reference run in this process meanwhile."""
    in_dir = tmp_path_factory.mktemp("sharded_lm_in")
    out = tmp_path_factory.mktemp("sharded_lm_out")
    res = Results()
    batch, toks, refs = _inputs(in_dir, res)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_lm_ranks.py"),
         str(in_dir), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        _reference(batch, toks, refs, res)
        _unsharded(batch, toks, refs, res)
        _node_reference(batch, refs["node18"][1], res)
        _node_unsharded(batch, refs["node18"][1], res)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    errs = sorted(out.glob("rank*.err"))
    assert proc.returncode == 0 and not errs, (
        (errs[0].read_text() if errs else "") + stderr[-4000:])
    res.ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    res.out = out
    return res


# ------------------------------------------------ sharded equals unsharded


@pytest.mark.parametrize("name", NAMES)
def test_sharded_loss_matches_unsharded(ranks, name):
    for r in range(WORLD):      # every rank holds the global loss
        got = float(ranks.rank(r)[f"{name}/loss"])
        assert abs(got - ranks.loss[name]) < LOSS_ATOL, \
            (name, r, got, ranks.loss[name])


@pytest.mark.parametrize("name", NAMES)
def test_sharded_grads_match_unsharded(ranks, name):
    want = ranks.grads[name]
    got = {k[len(f"{name}/grad/"):]: v for k, v in ranks.rank(0).items()
           if k.startswith(f"{name}/grad/")}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", NAMES)
def test_unsharded_loss_matches_reference(ranks, name):
    ref = ranks.ref_loss[name]
    assert abs(ranks.loss[name] - ref) / abs(ref) < REF_TOL, \
        (name, ranks.loss[name], ref)


def test_pod_mesh_matches_unsharded(ranks):
    got = ranks.rank(0)
    assert abs(float(got["pod/loss"]) - ranks.loss["dense"]) < LOSS_ATOL
    for k, want in ranks.grads["dense"].items():
        np.testing.assert_allclose(got[f"pod/grad/{k}"], want,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


# ---------------------------------------------------- flash-decode, caches


@pytest.mark.parametrize("name,route", decode_cases())
def test_decode_matches_local_decode(ranks, name, route):
    got, want = ranks.rank(0), ranks.decode[name]
    for key in ["prefill"] + list(range(DECODE_STEPS)):
        np.testing.assert_allclose(got[f"decode/{name}/{route}/{key}"],
                                   want[key], rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=f"{key}")
        if name == "dense":
            np.testing.assert_allclose(want[key], ranks.ref_decode[key],
                                       rtol=DECODE_TOL, atol=DECODE_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_caches_are_placed_by_cache_specs(ranks, name):
    assert all(bool(f[f"decode/{name}/seq_shard/cache_specs_ok"])
               for f in ranks.ranks)


def test_engine_generates_the_meshless_tokens(ranks):
    for f in ranks.ranks:       # every rank samples the same tokens
        np.testing.assert_array_equal(f["engine/tokens"], ranks.engine)


# ------------------------------------------------ memory, routing, init


@pytest.mark.parametrize("name", NAMES)
def test_local_parameter_bytes_follow_specs(ranks, name):
    total = sum(v.nbytes for v in ranks.grads[name].values())
    for f in ranks.ranks:
        assert int(f[f"{name}/local_bytes"]) == int(f[f"{name}/spec_bytes"])
        assert int(f[f"{name}/local_bytes"]) < total / 4
    if name == "dense":   # wq (layers, d, h·dh) = (2, 64, 64): (-, data, model)
        assert tuple(ranks.rank(0)["dense/wq_local_shape"]) == (2, 32, 16)


def test_moe_routing_ids_match_and_nothing_drops(ranks):
    by_data = {}
    for f in ranks.ranks:
        by_data.setdefault(int(f["moe/data_coord"]), f)
    assert sorted(by_data) == [0, 1]
    cfg = configs(ModelConfig)[1]
    for i, want in enumerate(ranks.ids):
        got = np.concatenate([by_data[c][f"moe/ids/{i}"] for c in (0, 1)])
        np.testing.assert_array_equal(got, want)
        for c in (0, 1):        # per data rank: C from its own tokens
            ids = by_data[c][f"moe/ids/{i}"].reshape(-1)
            cap = tmoe._capacity(ids.size // cfg.top_k, cfg)
            assert np.bincount(ids, minlength=cfg.n_experts).max() <= cap


def test_init_on_mesh_is_the_meshless_init(ranks):
    assert all(bool(f["init/equal"]) for f in ranks.ranks)


# ------------------------------------------- training, checkpoints, grads


def test_train_steps_match_and_moments_follow_params(ranks):
    got = ranks.rank(0)
    np.testing.assert_allclose(got["train/losses"], ranks.train["losses"],
                               atol=LOSS_ATOL)
    assert all(bool(f["train/moments_follow_params"]) for f in ranks.ranks)
    want = {k: v.numpy() for k, v in flat(ranks.train["state"].params)
            .items()}
    for k, v in want.items():
        np.testing.assert_allclose(got[f"train/params/{k}"], v,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)


def test_checkpoint_saved_on_mesh_resumes_without_one(ranks):
    st = ranks.train["state"]
    step, restored = restore_checkpoint(str(ranks.out / "ckpt_mesh"), st)
    assert step == 2
    got = ranks.rank(0)
    for k, v in flat(restored.params).items():
        np.testing.assert_array_equal(v.numpy(), got[f"train/params/{k}"])
    for k, v in flat(restored.opt_state.mu).items():
        np.testing.assert_array_equal(v.numpy(), got[f"train/mu/{k}"])


def test_checkpoint_saved_without_mesh_resumes_on_one(ranks):
    st = ranks.plain_ckpt
    got = ranks.rank(0)
    assert int(got["train/plain_step"]) == 5
    assert all(bool(f["train/plain_placed"]) for f in ranks.ranks)
    for k, v in flat(st.params).items():
        np.testing.assert_array_equal(got[f"train/plain/params/{k}"],
                                      v.numpy())
    for k, v in flat(st.opt_state.nu).items():
        np.testing.assert_array_equal(got[f"train/plain/nu/{k}"], v.numpy())


def test_grad_utils_reduce_whole_tensors(ranks):
    """Clipping, int8 and top-k on the sharded gradients equal the plain
    functions on the same gradients gathered whole: the norm up to the
    order of its sum, int8 (its scale a max) and top-k (its threshold the
    k-th largest of the blocks' own top k) bit for bit."""
    got = ranks.rank(0)
    g = nest({k[len("dense/grad/"):]: torch.from_numpy(v)
              for k, v in got.items() if k.startswith("dense/grad/")})
    clipped, norm = clip_by_global_norm(g, CLIP)
    assert abs(float(got["grads/norm"]) - float(norm)) <= 1e-6 * float(norm)
    for k, v in flat(clipped).items():
        np.testing.assert_allclose(got[f"grads/clip/{k}"], v.numpy(),
                                   rtol=1e-6, atol=0)
    for k, v in flat(int8_compress_decompress(g)[0]).items():
        np.testing.assert_array_equal(got[f"grads/int8/{k}"], v.numpy())
    for k, v in flat(topk_sparsify(g, TOPK_FRAC)[0]).items():
        np.testing.assert_array_equal(got[f"grads/topk/{k}"], v.numpy())


# ------------------------------------------------- NODE blocks on the mesh


def _node_grad_err(got: dict, want: dict) -> float:
    """Max over leaves of max |got - want| / max |want|."""
    worst = 0.0
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        worst = max(worst, float(np.abs(got[k] - w).max()) / scale)
    return worst


@pytest.mark.parametrize("name", NODE_PORT)
def test_node_blocks_on_mesh_match_meshless(ranks, name):
    """Each NODE case on the (data=2, model=4) mesh: the loss and the
    gradients at the sharded bounds, and every block's steps, trials,
    evaluations and status the mesh-less run's, on every rank."""
    loss, grads, stats = ranks.node[name]
    for f in ranks.ranks:
        assert abs(float(f[f"node/{name}/loss"]) - loss) < LOSS_ATOL
        np.testing.assert_array_equal(f[f"node/{name}/stats"], stats)
    got = ranks.rank(0)
    for k, want in grads.items():
        np.testing.assert_allclose(got[f"node/{name}/grad/{k}"], want,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=k)
    assert len(stats) == node_model(tn18.SMOKE).n_layers


@pytest.mark.parametrize("name", NODE_REF)
def test_node_meshless_matches_reference(ranks, name):
    loss, grads, _ = ranks.node[name]
    want_loss, want_grads = ranks.node_ref[name]
    assert abs(loss - want_loss) <= REF_TOL * abs(want_loss)
    assert _node_grad_err(grads, want_grads) <= NODE_GRAD_TOL


def test_node_ranks_stay_in_lockstep(ranks):
    """The lockstep case: the batch's halves, one a data rank, solved
    alone take different grids; on the mesh every rank takes the whole
    batch's grid, evaluates the field as often, forward and backward, and
    issues as many collectives."""
    lower, upper = ranks.halves["lower"], ranks.halves["upper"]
    assert not np.array_equal(lower[:, 1], upper[:, 1])
    whole = ranks.node["lockstep"][2]
    first = ranks.rank(0)
    for f in ranks.ranks:
        np.testing.assert_array_equal(f["node/lockstep/stats"], whole)
        assert int(f["node/lockstep/evals"]) == \
            int(first["node/lockstep/evals"])
        np.testing.assert_array_equal(f["node/lockstep/collectives"],
                                      first["node/lockstep/collectives"])
    assert int(first["node/lockstep/evals"]) > int(whole[:, 2].sum())
