"""The rank side of ``tests/test_torch_sharded_lm.py``.

    PYTHONPATH=src python tests/torch_sharded_lm_ranks.py IN_DIR OUT_DIR

Spawns 8 gloo ranks on the CPU once (``torch.multiprocessing.spawn``, one
thread each). Every rank runs every case of the test file on a ``(data=2,
model=4)`` mesh (a ``(pod=2, data=2, model=2)`` one for the pod case), on
the reference's weights and batches that the test process wrote to
``IN_DIR`` (``params_<config>.npz``, ``batch.npz``, ``decode.npz`` and a
mesh-less checkpoint ``ckpt_plain``):

* ``<config>/``: the sharded loss and its gradients (gathered whole), the
  rank's local parameter bytes beside those its ``Model.specs(mesh)``
  imply, and (moe) the router's top-k ids of one forward;
* ``decode/``: prefill then three decode steps of each config with
  flash-decode (``decode_seq_shard``; the dense one also without it and
  on the kernel route), and whether the prefill caches' placements are
  ``Model.cache_specs``'; ``engine/``: the dense model's greedy tokens
  through ``ServeEngine.generate``;
* ``pod/``: the dense loss and gradients on the 3-D mesh;
* ``init/``: whether ``Model.init`` on the mesh is the mesh-less init;
* ``train/``: two AdamW steps through ``TrainLoop`` (a checkpoint at
  step 2 in ``OUT_DIR/ckpt_mesh``), the moments' placements, and the
  mesh-less checkpoint restored on the mesh;
* ``grads/``: clipping and int8 / top-k compression of the sharded
  gradients, gathered whole;
* ``node/<case>/``: node18's smoke config (one layer) in NODE mode
  (``node_cases``:
  the four regime × method cases of ``test_node_mode_trains``,
  ``NODE_TRAIN``, ``NODE_TRAIN_MALI``; a ``batch_axis=0`` case and the
  ``lockstep`` case, whose batch rows differ strongly between the data
  ranks): the loss, the gradients gathered whole, each block's
  (steps, trials, evaluations, status), and (lockstep) the rank's count
  of field evaluations, forward and backward, and of its collectives.

Rank r writes ``OUT_DIR/rank{r}.npz`` (or ``rank{r}.err``). Imports
neither JAX nor the reference.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
B, S = 4, 16
DECODE_STEPS = 3
MAX_SEQ = S + 4
TOPK_FRAC = 0.05
CLIP = 0.5
# decode routes: RunConfig fields on top of the mesh
ROUTES = {"seq_shard": {}, "no_seq_shard": {"decode_seq_shard": False},
          "pallas": {"use_pallas": True}}
# the lockstep case: the upper half of the batch (the second data rank's
# rows) reads embedding rows scaled by LOCKSTEP_SCALE, so that the two
# halves alone take different grids (at the NodeConfig defaults, one
# block: 13 trials against 7; the whole batch 12)
LOCKSTEP_SCALE = 50.0
LOCKSTEP_KW = dict(enabled=True)
# the NODE cases run node18's smoke width at one of its three layers
NODE_LAYERS = 1


def node_model(smoke):
    """node18's smoke config (the port's or the reference's) cut to
    NODE_LAYERS layers."""
    return smoke.scaled(n_layers=NODE_LAYERS)


def node_cases(node_config, module) -> dict:
    """The NODE configs of the node18 case by name, built with
    ``node_config`` (the port's or the reference's NodeConfig) and
    ``module`` (its ``configs.node18_cifar``): the reference test's four
    regime × method cases (``test_node_mode_trains``), ``NODE_TRAIN``
    (fused path, segmented ACA) and ``NODE_TRAIN_MALI``."""
    kw = dict(enabled=True, steps_per_interval=2, max_steps=16)
    return {"fixed_aca": node_config(regime="fixed", grad_method="aca",
                                     **kw),
            "adaptive_aca": node_config(regime="adaptive",
                                        grad_method="aca", **kw),
            "fixed_adjoint": node_config(regime="fixed",
                                         grad_method="adjoint", **kw),
            "fixed_naive": node_config(regime="fixed", grad_method="naive",
                                       **kw),
            "node_train": module.NODE_TRAIN,
            "node_train_mali": module.NODE_TRAIN_MALI}


def port_node_cases() -> dict:
    """``node_cases`` on the port, with the port's own two: per-row grids
    (``batch_axis=0``, fused path) and the lockstep case."""
    from repro_torch.configs import node18_cifar
    from repro_torch.core.node_block import NodeConfig

    cases = node_cases(NodeConfig, node18_cifar)
    cases["batched"] = NodeConfig(enabled=True, batch_axis=0,
                                  use_pallas=True)
    cases["lockstep"] = NodeConfig(**LOCKSTEP_KW)
    return cases


def lockstep_inputs(params: dict, batch: dict, vocab: int):
    """(params, batch) of the lockstep case from flat numpy ones: the
    batch's lower rows draw tokens below vocab / 2, its upper rows above,
    and the embedding rows above are scaled by LOCKSTEP_SCALE."""
    half = vocab // 2
    toks = batch["tokens"].copy() % half
    toks[toks.shape[0] // 2:] += half
    p = dict(params)
    emb = p["embed"].copy()
    emb[half:] *= LOCKSTEP_SCALE
    p["embed"] = emb
    return p, dict(batch, tokens=toks, labels=np.roll(toks, -1, axis=1))


def node_stats_array(stats) -> np.ndarray:
    """(blocks, 4): each block's steps, trials, evaluations and status
    (batched solves: each row's, (blocks, 4, B))."""
    return np.array([[s.n_steps.numpy(), s.n_trials.numpy(),
                      s.nfe.numpy(), s.status.numpy()]
                     for _, _, s in stats])


def configs(cls):
    """The reference test's three configs (``tests/test_distributed.py``)
    and a hybrid one, built with ``cls`` (the port's or the reference's
    ModelConfig)."""
    return [
        cls(name="dense", family="dense", n_layers=2, d_model=64,
            vocab=128, n_heads=8, n_kv_heads=2, d_ff=128),
        cls(name="moe", family="moe", n_layers=2, d_model=64, vocab=128,
            n_heads=8, n_kv_heads=8, d_ff=64, n_experts=8,
            n_shared_experts=1, top_k=2, d_expert=64, capacity_factor=8.0),
        cls(name="ssm", family="ssm", n_layers=2, d_model=64, vocab=128,
            ssm_state=16, ssm_head_dim=16, ssm_chunk=8),
        # and the port's: RG-LRU blocks and windowed MQA (one group, a tail)
        cls(name="hybrid", family="hybrid", n_layers=4, d_model=64,
            vocab=128, n_heads=8, n_kv_heads=1, head_dim=16, d_ff=128,
            window=8, pattern=("rec", "rec", "attn"), d_rnn=64, act="gelu"),
    ]


def nest(flat: dict) -> dict:
    """{"a/b": x} -> {"a": {"b": x}}."""
    out: dict = {}
    for key, val in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _whole(x) -> np.ndarray:
    from repro_torch.distributed.regions import whole

    return whole(x).detach().numpy()


def _batch(in_dir):
    z = np.load(os.path.join(in_dir, "batch.npz"))
    return {k: torch.from_numpy(z[k]) for k in z.files}


def _loss_and_grads(model, params, batch):
    from repro_torch.train.loop import _grads_of

    loss, _, grads = _grads_of(model, params, batch)
    return loss, grads


def _spec_bytes(model, mesh) -> int:
    """The bytes of this rank's blocks as ``Model.specs(mesh)`` implies
    them: each dim divided by the sizes of the mesh dims its entry
    names."""
    from torch.utils import _pytree as pytree

    from repro_torch.distributed.sharding import P, mesh_shape

    sizes = mesh_shape(mesh)
    total = 0
    specs = pytree.tree_leaves(model.specs(mesh),
                               is_leaf=lambda x: isinstance(x, P))
    for leaf, spec in zip(pytree.tree_leaves(model.abstract()), specs):
        n = leaf.element_size()
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * 8):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            div = 1
            for a in axes:
                div *= sizes[a]
            n *= dim // div
        total += n
    return total


def _case_configs(mesh, in_dir, res):
    from torch.utils import _pytree as pytree

    from repro_torch.convert import tree_from_jax
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig, RunConfig
    from repro_torch.models.lm import build_model

    batch = _batch(in_dir)
    for cfg in configs(ModelConfig):
        m = build_model(cfg, RunConfig(compute_dtype=torch.float32,
                                       mesh=mesh))
        ref = nest(dict(np.load(os.path.join(in_dir,
                                             f"params_{cfg.name}.npz"))))
        params = tree_from_jax(ref, "cpu", mesh=mesh, defs=m.defs)
        loss, grads = _loss_and_grads(m, params, batch)
        res[f"{cfg.name}/loss"] = np.float64(loss)
        for k, g in flat(grads).items():
            res[f"{cfg.name}/grad/{k}"] = _whole(g)
        res[f"{cfg.name}/local_bytes"] = np.int64(sum(
            p.to_local().numel() * p.element_size()
            for p in pytree.tree_leaves(params)))
        res[f"{cfg.name}/spec_bytes"] = np.int64(_spec_bytes(m, mesh))
        if cfg.name == "dense":
            wq = params["stack"]["u0_attn"]["mixer"]["wq"]
            res["dense/wq_local_shape"] = np.array(wq.to_local().shape)
        if cfg.name == "moe":
            seen = []
            top_k = moe._top_k

            def record(probs, c):
                ids, gates = top_k(probs, c)
                seen.append(ids.numpy().copy())
                return ids, gates

            moe._top_k = record
            try:
                with torch.no_grad():
                    m.forward(params, batch)
            finally:
                moe._top_k = top_k
            for i, ids in enumerate(seen):
                res[f"moe/ids/{i}"] = ids
            res["moe/data_coord"] = np.int64(mesh.get_local_rank("data"))
        if cfg.name == "dense":
            _case_grad_utils(grads, res)


def _case_grad_utils(grads, res):
    from repro_torch.optim.grad_utils import (clip_by_global_norm,
                                              int8_compress_decompress,
                                              topk_sparsify)

    clipped, norm = clip_by_global_norm(grads, CLIP)
    res["grads/norm"] = np.float64(norm)
    for k, g in flat(clipped).items():
        res[f"grads/clip/{k}"] = _whole(g)
    q, _ = int8_compress_decompress(grads)
    for k, g in flat(q).items():
        res[f"grads/int8/{k}"] = _whole(g)
    t, _ = topk_sparsify(grads, TOPK_FRAC)
    for k, g in flat(t).items():
        res[f"grads/topk/{k}"] = _whole(g)


def decode_cases():
    """(config, route) of the decode case: the dense config on flash-decode,
    without it and on the kernel route, the others on flash-decode."""
    return [("dense", r) for r in ROUTES] + [
        (n, "seq_shard") for n in ("moe", "ssm", "hybrid")]


def _case_decode(mesh, in_dir, res):
    from repro_torch.convert import tree_from_jax
    from repro_torch.distributed.sharding import (fit_spec_to_shape,
                                                  spec_to_placements)
    from repro_torch.models.config import ModelConfig, RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfgs = {c.name: c for c in configs(ModelConfig)}
    toks = torch.from_numpy(np.load(os.path.join(in_dir, "decode.npz"))
                            ["tokens"])
    for name, route in decode_cases():
        m = build_model(cfgs[name], RunConfig(
            compute_dtype=torch.float32, max_seq=MAX_SEQ, mesh=mesh,
            **ROUTES[route]))
        ref = nest(dict(np.load(os.path.join(in_dir,
                                             f"params_{name}.npz"))))
        params = tree_from_jax(ref, "cpu", mesh=mesh, defs=m.defs)
        key = f"decode/{name}/{route}"
        with torch.no_grad():
            lg, caches = m.prefill(params, {"tokens": toks[:, :S]})
            res[f"{key}/prefill"] = lg.numpy()
            specs = flat(m.cache_specs(B, MAX_SEQ, torch.float32))
            res[f"{key}/cache_specs_ok"] = np.bool_(all(
                tuple(c.placements) == spec_to_placements(
                    fit_spec_to_shape(tuple(c.shape), specs[k], mesh), mesh)
                for k, c in flat(caches).items()))
            for j in range(DECODE_STEPS):
                lg, caches = m.decode_step(
                    params, {"tokens": toks[:, S + j:S + j + 1]}, caches,
                    S + j)
                res[f"{key}/{j}"] = lg.numpy()
        if name == "dense" and route == "seq_shard":
            out = ServeEngine(m, params, ServeConfig(
                max_new_tokens=DECODE_STEPS + 1)).generate(toks[:, :S])
            res["engine/tokens"] = out["tokens"].numpy()


def _case_pod(in_dir, res):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.convert import tree_from_jax
    from repro_torch.models.config import ModelConfig, RunConfig
    from repro_torch.models.lm import build_model

    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    cfg = configs(ModelConfig)[0]
    m = build_model(cfg, RunConfig(compute_dtype=torch.float32, mesh=mesh))
    ref = nest(dict(np.load(os.path.join(in_dir, "params_dense.npz"))))
    params = tree_from_jax(ref, "cpu", mesh=mesh, defs=m.defs)
    loss, grads = _loss_and_grads(m, params, _batch(in_dir))
    res["pod/loss"] = np.float64(loss)
    for k, g in flat(grads).items():
        res[f"pod/grad/{k}"] = _whole(g)


def _case_init(mesh, res):
    from torch.utils import _pytree as pytree

    from repro_torch.models.config import ModelConfig, RunConfig
    from repro_torch.models.lm import build_model

    ok = True
    for cfg in configs(ModelConfig):
        on = build_model(cfg, RunConfig(mesh=mesh)).init(seed=3,
                                                        device="cpu")
        off = build_model(cfg, RunConfig()).init(seed=3, device="cpu")
        for a, b in zip(pytree.tree_leaves(on), pytree.tree_leaves(off)):
            ok = ok and bool(torch.equal(a.full_tensor(), b))
    res["init/equal"] = np.bool_(ok)


def _case_train(mesh, in_dir, out_dir, res):
    from torch.utils import _pytree as pytree

    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.convert import tree_from_jax
    from repro_torch.models.config import ModelConfig, RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import (TrainLoop, TrainLoopConfig, TrainState)

    cfg = configs(ModelConfig)[0]
    m = build_model(cfg, RunConfig(compute_dtype=torch.float32, mesh=mesh))
    ref = nest(dict(np.load(os.path.join(in_dir, "params_dense.npz"))))
    params = tree_from_jax(ref, "cpu", mesh=mesh, defs=m.defs)
    opt = adamw(1e-3, weight_decay=0.1)
    state = TrainState(step=torch.zeros((), dtype=torch.int32),
                       params=params, opt_state=opt.init(params))
    loop = TrainLoop(m, opt, TrainLoopConfig(
        ckpt_dir=os.path.join(out_dir, "ckpt_mesh"), ckpt_every=2,
        clip_norm=1.0, log_every=1), state)
    batch = _batch(in_dir)
    losses = []
    loop.run(lambda s: batch, 2,
             log_cb=lambda s, mt: losses.append(mt["loss"]))
    res["train/losses"] = np.array(losses)
    st = loop.state
    p_leaves = pytree.tree_leaves(st.params)
    ok = True
    for mom in (st.opt_state.mu, st.opt_state.nu):
        for a, p in zip(pytree.tree_leaves(mom), p_leaves):
            ok = ok and type(a).__name__ == "DTensor" \
                and tuple(a.placements) == tuple(p.placements)
    res["train/moments_follow_params"] = np.bool_(ok)
    for k, v in flat(st.params).items():
        res[f"train/params/{k}"] = _whole(v)
    for k, v in flat(st.opt_state.mu).items():
        res[f"train/mu/{k}"] = _whole(v)

    # a mesh-less checkpoint restored onto the mesh
    got = restore_checkpoint(os.path.join(in_dir, "ckpt_plain"), st)
    res["train/plain_step"] = np.int64(got[0])
    restored = got[1]
    for k, v in flat(restored.params).items():
        res[f"train/plain/params/{k}"] = _whole(v)
    for k, v in flat(restored.opt_state.nu).items():
        res[f"train/plain/nu/{k}"] = _whole(v)
    res["train/plain_placed"] = np.bool_(all(
        tuple(a.placements) == tuple(p.placements) for a, p in zip(
            pytree.tree_leaves(restored.params), p_leaves)))


def _case_node(mesh, in_dir, res):
    from repro_torch.configs import node18_cifar
    from repro_torch.convert import tree_from_jax
    from repro_torch.distributed import regions
    from repro_torch.models import transformer
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model

    cfg = node_model(node18_cifar.SMOKE)
    flat_p = dict(np.load(os.path.join(in_dir, "params_node18.npz")))
    batch = dict(np.load(os.path.join(in_dir, "batch.npz")))
    inputs = {False: (flat_p, batch),
              True: lockstep_inputs(flat_p, batch, cfg.vocab)}
    block_apply = transformer.block_apply
    for name, ncfg in port_node_cases().items():
        fp, b = inputs[name == "lockstep"]
        m = build_model(cfg, RunConfig(compute_dtype=torch.float32,
                                       mesh=mesh, node=ncfg))
        m.node_stats = []
        params = tree_from_jax(nest(fp), "cpu", mesh=mesh, defs=m.defs)
        evals = [0]

        def counted(*a, **k):
            evals[0] += 1
            return block_apply(*a, **k)

        transformer.block_apply = counted
        regions.reset_counts()
        try:
            loss, grads = _loss_and_grads(
                m, params, {k: torch.from_numpy(v) for k, v in b.items()})
        finally:
            transformer.block_apply = block_apply
        key = f"node/{name}"
        res[f"{key}/loss"] = np.float64(loss)
        for k, g in flat(grads).items():
            res[f"{key}/grad/{k}"] = _whole(g)
        res[f"{key}/stats"] = node_stats_array(m.node_stats)
        res[f"{key}/evals"] = np.int64(evals[0])
        res[f"{key}/collectives"] = np.array(
            [v for _, v in sorted(regions.counts.items())])



def worker(rank: int, world: int, port: int, in_dir: str,
           out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_debug_mesh

        mesh = make_debug_mesh(2, 4, device_type="cpu")
        res: dict = {}
        for case in (lambda: _case_configs(mesh, in_dir, res),
                     lambda: _case_decode(mesh, in_dir, res),
                     lambda: _case_init(mesh, res),
                     lambda: _case_train(mesh, in_dir, out_dir, res),
                     lambda: _case_node(mesh, in_dir, res),
                     lambda: _case_pod(in_dir, res)):
            t0 = time.perf_counter()
            case()
            if rank == 0:
                print(f"{case.__code__.co_names[0]} "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    except Exception:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def main(in_dir: str, out_dir: str) -> None:
    from repro_torch.launch.mesh import free_port

    mp.spawn(worker, args=(WORLD, free_port(), in_dir, out_dir),
             nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
