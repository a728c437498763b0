"""Mesh-sharded batched solving on the port: ``odeint(..., batch_axis=0,
mesh=...)`` over a torch ``DeviceMesh``, mirroring
``tests/test_sharded_solve.py`` (its 17 tests) with its inputs (B = 8,
D = 4, ``TS``, ``_kw``, ``_batch_for``) and its ``ARGS_RTOL``.

The ranks are spawned once for the whole file: a module fixture runs
``tests/torch_sharded_ranks.py``, whose 8 gloo ranks on the CPU run
every case on the same global inputs (a flat 8-rank ``("data",)`` mesh,
a ``(data=4, model=2)``, a ``(pod=2, data=2, model=2)`` and a ``(data=2,
model=4)`` mesh) and write their
results as numpy files; each test compares them here. On the CPU the
kernel route (``use_pallas=True``) takes the kernels' plain versions.

Contract, as the reference pins it for its own sharded solve: ``ys``,
``SolveStats`` and ``z0`` gradients bitwise the unsharded batched solve,
for all four methods and both routes; the shared ``args`` gradient is
the per-shard partial sums summed once more (within ``ARGS_RTOL``); every
rank returns the global result. Against the reference's ``odeint``
without a mesh: the batched parity tolerances of
``tests/test_torch_batched_methods.py``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import odeint as jodeint
from repro_torch.core import SolveStatus
from repro_torch.launch.mesh import (NoProcessGroupError,
                                     elastic_mesh_shape, make_debug_mesh,
                                     make_elastic_mesh, make_production_mesh)

from torch_sharded_ranks import (B, FAULT_ROW, METHODS, TS, W, WORLD,
                                 batch_for)

ROOT = Path(__file__).resolve().parent.parent
# shared-args cotangent tolerance (the reference test's): the cross-shard
# sum reorders the per-shard partial sums; mali accumulates over ~10x
# more (lattice) steps
ARGS_RTOL = {"aca": 1e-6, "adjoint": 1e-6, "naive": 1e-6, "mali": 5e-6}
STATS = ("n_steps", "n_trials", "nfe", "overflow", "status")
# port against reference, both batched (test_torch_batched_methods.py)
REF_RTOL, REF_ATOL, REF_W_ATOL = 1e-5, 1e-7, 1e-6
# mali against the reference at 1e-4 (test_torch_batched_methods.py's
# MALI_REF_TOL): below it the ALF stepsize of the stiffer rows follows
# rounding noise (ROADMAP queue 3)
MALI_REF_KW = dict(rtol=1e-4, atol=1e-4)


class Ranks:
    """The 8 ranks' results: ``sharded(case)`` is rank ``r``'s, and
    ``unsharded(case)`` the one rank's that solved it without a mesh."""

    def __init__(self, files):
        self.files = files

    def _fields(self, rank: int, prefix: str) -> dict:
        return {k[len(prefix):]: v for k, v in self.files[rank].items()
                if k.startswith(prefix)}

    def sharded(self, case: str, rank: int = 0) -> dict:
        return self._fields(rank, f"{case}/sharded/")

    def unsharded(self, case: str) -> dict:
        for r in range(WORLD):
            got = self._fields(r, f"{case}/unsharded/")
            if got:
                return got
        raise KeyError(case)

    def get(self, key: str, rank: int = 0):
        return self.files[rank][key]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Runs the 8 ranks once for the file; the reference's solves run in
    this process meanwhile (``Ranks.reference``)."""
    out = tmp_path_factory.mktemp("sharded_ranks")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_ranks.py"),
         str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        reference = {m: _reference(m) for m in METHODS}
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    errs = "".join(p.read_text() for p in sorted(out.glob("*.err")))
    assert proc.returncode == 0, (stdout[-2000:], stderr[-4000:], errs)
    r = Ranks([dict(np.load(out / f"rank{k}.npz")) for k in range(WORLD)])
    r.reference = reference
    return r


def _assert_fields_equal(a: dict, b: dict, names):
    for n in names:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


# ---------------------------------------------------------------- parity

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_sharded_matches_unsharded(ranks, method, route):
    """ys/stats bit-equal, z0-grad bit-equal, args-grad within
    ARGS_RTOL."""
    s = ranks.sharded(f"parity/{method}/{route}")
    u = ranks.unsharded(f"parity/{method}/{route}")
    _assert_fields_equal(s, u, ("ys",) + STATS + ("gz",))
    assert (s["status"] == SolveStatus.OK).all()
    assert len(np.unique(s["n_steps"])) > 1     # every row its own grid
    np.testing.assert_allclose(s["gw"], u["gw"], rtol=ARGS_RTOL[method])


@pytest.mark.parametrize("method", METHODS)
def test_sharded_matches_vmap_of_solo(ranks, method):
    """Row r of the sharded solve is bitwise the solo solve of row r (the
    batched engine's contract, kept under sharding)."""
    s = ranks.sharded(f"parity/{method}/plain")
    for r in range(B):
        np.testing.assert_array_equal(
            s["ys"][:, r], ranks.get(f"solo/{method}/row{r}/ys", r))
        assert int(s["n_steps"][r]) == int(
            ranks.get(f"solo/{method}/row{r}/n_steps", r))


def test_per_element_h0_shards_with_the_batch(ranks):
    _assert_fields_equal(ranks.sharded("h0"), ranks.unsharded("h0"),
                         ("ys",) + STATS)


@pytest.mark.parametrize("method", METHODS)
def test_scalar_args_grad_wrt_z0_only(ranks, method):
    """Gradients taken with respect to z0 only, with a 0-d ``w`` in a
    tuple and in a dict: bitwise the unsharded solve's, and the backward
    then runs only the z0 gather."""
    for case in (f"scalar_args/{method}", f"dict_args/{method}"):
        s, u = ranks.sharded(case), ranks.unsharded(case)
        _assert_fields_equal(s, u, ("ys", "gz"))
        assert "gw" not in s
        assert s["bwd_collectives"].tolist() == [1, 0]


def test_2d_mesh_shards_data_axis_only(ranks):
    """On a (data=4, model=2) mesh the batch splits 4-way over 'data' and
    replicates over 'model': the same answers, and the args cotangent
    summed over 'data' only (over all 8 ranks it would double)."""
    assert ranks.get("mesh_2d_axes/axes").tolist() == ["data"]
    assert int(ranks.get("mesh_2d_axes/count")) == 4
    s, u = ranks.sharded("mesh_2d"), ranks.unsharded("mesh_2d")
    _assert_fields_equal(s, u, ("ys",) + STATS + ("gz",))
    np.testing.assert_allclose(s["gw"], u["gw"], rtol=ARGS_RTOL["aca"])


def test_pod_and_data_dims_shard_together(ranks):
    """On a (pod=2, data=2, model=2) mesh the default rules split the
    batch over (pod, data), pod major: 4 shards of 2 rows, the same
    answers, the args cotangent summed over both dims."""
    s, u = ranks.sharded("mesh_3d"), ranks.unsharded("mesh_3d")
    _assert_fields_equal(s, u, ("ys",) + STATS + ("gz",))
    np.testing.assert_allclose(s["gw"], u["gw"], rtol=ARGS_RTOL["aca"])
    assert s["fwd_collectives"].tolist() == [2, 0]
    assert s["bwd_collectives"].tolist() == [1, 1]


def test_composes_with_segmented_checkpoints(ranks):
    _assert_fields_equal(ranks.sharded("segments"),
                         ranks.unsharded("segments"), ("ys",) + STATS)


def test_composes_with_interpolate_ts(ranks):
    """Dense-output reads under sharding: stats and the end states
    bitwise, the interior within 1e-5 / 1e-6 (the reference test's
    bounds; the port's sharded reads are bitwise too)."""
    s, u = ranks.sharded("interpolate"), ranks.unsharded("interpolate")
    _assert_fields_equal(s, u, STATS)
    np.testing.assert_array_equal(s["ys"][0], u["ys"][0])
    np.testing.assert_array_equal(s["ys"][-1], u["ys"][-1])
    np.testing.assert_allclose(s["ys"], u["ys"], rtol=1e-5, atol=1e-6)


# ------------------------------------------------- solve-health isolation

def test_fault_isolation_per_shard(ranks):
    """A NaN-poisoned row fails alone under sharding: only its status is
    NONFINITE_STATE, the outputs stay finite, and the faulty solve is the
    unsharded faulty solve's (stats bitwise, outputs within 1e-6)."""
    s, u = ranks.sharded("fault"), ranks.unsharded("fault")
    for b in range(B):
        want = SolveStatus.NONFINITE_STATE if b == FAULT_ROW \
            else SolveStatus.OK
        assert int(s["status"][b]) == want, (b, s["status"])
    _assert_fields_equal(s, u, STATS)
    np.testing.assert_allclose(s["ys"], u["ys"], rtol=1e-6, atol=1e-6)
    assert np.isfinite(s["ys"]).all()


# ------------------------------------------------------- validation errors

def test_uneven_batch_raises(ranks):
    assert re.search("does not divide evenly", str(ranks.get(
        "errors/uneven")))


def test_mesh_requires_batch_axis(ranks):
    assert re.search("mesh requires batch_axis", str(ranks.get(
        "errors/no_batch_axis")))


def test_mesh_without_data_axis_raises(ranks):
    assert re.search("no data-parallel axis", str(ranks.get(
        "errors/no_data_axis")))


def test_mesh_refuses_per_row_ts_and_tolerances():
    """What the reference's sharded solve does not take raises before any
    collective (a DeviceMesh of 8 fake ranks in this process): per-row
    (B, T) ts (the reference takes a 1D ts, replicated) and per-element
    tolerances (its wording), and a mesh that is no DeviceMesh."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.core import odeint
    from repro_torch.distributed import shard_mesh
    from torch_sharded_ranks import field, hetero_batch, kw

    z0, w = torch.tensor(hetero_batch()), (torch.tensor(np.float32(W)),)
    with pytest.raises(ValueError, match="mesh must be a torch DeviceMesh"):
        odeint(field, z0, TS, w, mesh=object(), **kw("aca"))
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        mesh = shard_mesh("cpu")
        per_row = torch.tensor([TS] * B)
        with pytest.raises(ValueError, match="per-row .B, T. ts do not "
                           "compose with mesh"):
            odeint(field, z0, per_row, w, mesh=mesh, **kw("aca"))
        with pytest.raises(ValueError, match="per-element rtol/atol do not "
                           "compose with mesh"):
            odeint(field, z0, TS, w, mesh=mesh,
                   **{**kw("aca"), "rtol": torch.full((B,), 1e-5)})
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ NodeConfig thread

def test_node_block_mesh_threading(ranks):
    np.testing.assert_array_equal(ranks.sharded("node")["zT"],
                                  ranks.unsharded("node")["zT"])


# ------------------------------------------------------------ the port's

def test_collectives_per_solve(ranks):
    """Two collectives forward (the ys and stats gathers), two backward
    (the args all_reduce and the z0 gather), none inside a trial loop:
    every field evaluation of the forward sees 0 collectives issued, and
    every one of the backward sees the forward's 2."""
    for m in METHODS:
        for route in ("plain", "kernel"):
            s = ranks.sharded(f"parity/{m}/{route}")
            assert s["fwd_collectives"].tolist() == [2, 0], (m, route)
            assert s["bwd_collectives"].tolist() == [1, 1], (m, route)
    for r in range(WORLD):
        s = ranks.sharded("parity/aca/plain", r)
        assert len(s["probe_fwd"]) and not s["probe_fwd"].any(), r
        assert len(s["probe_bwd"]) and (s["probe_bwd"] == 2).all(), r


def test_every_rank_returns_the_global_result(ranks):
    keys = [k for k in ranks.files[0] if "/sharded/" in k
            and "/probe_" not in k]
    for r in range(1, WORLD):
        for k in keys:
            np.testing.assert_array_equal(ranks.files[r][k],
                                          ranks.files[0][k], err_msg=k)


def test_mixed_dtype_state_on_two_ranks(ranks):
    """A state of an f32 leaf and a bf16 leaf on a (data=2, model=4) mesh,
    with an f32 and a bf16 parameter: the leaves travel as their bytes, so
    ys, stats and z0 gradients are bitwise the unsharded solve's and the
    bf16 leaf stays bf16. Both parameters' cotangents are summed in one
    all_reduce, in f32: the f32 one within ARGS_RTOL of the unsharded
    gradient, the bf16 one exactly bf16(f32(p0) + f32(p1)), where p0 and
    p1 are the gradients of each shard's rows solved alone."""
    import torch

    s, u = ranks.sharded("mixed"), ranks.unsharded("mixed")
    assert str(s["dtype_b"]) == "torch.bfloat16"
    assert str(s["dtype_gwb"]) == "torch.bfloat16"
    _assert_fields_equal(s, u, ("ys_a", "ys_b", "gz_a", "gz_b") + STATS)
    np.testing.assert_allclose(s["gw"], u["gw"], rtol=ARGS_RTOL["aca"])
    parts = sum(torch.tensor(u[f"gwb_part{k}"]) for k in range(2))
    np.testing.assert_array_equal(s["gwb"], parts.bfloat16().float().numpy())
    assert s["bwd_collectives"].tolist() == [1, 1]


# --------------------------------------------------------- the reference

def _f_j(t, z, w):
    x, logk = z[:-1], z[-1]
    dx = -jnp.exp(logk) * x + 0.1 * jnp.tanh(w * x)
    return jnp.concatenate([dx, jnp.zeros((1,), z.dtype)])


def _reference(method):
    """The reference's batched odeint without a mesh on the test's numpy
    inputs (mali at MALI_REF_KW): ys, stats and the gradients of
    sum(ys * ys)."""
    kw = dict(rtol=1e-5, atol=1e-5, grad_method=method, batch_axis=0)
    kw.update(dict(max_steps=2048, **MALI_REF_KW) if method == "mali"
              else dict(solver="dopri5", max_steps=64))

    def loss(w, z0):
        ys, st = jodeint(_f_j, z0, jnp.asarray(TS, jnp.float32), (w,), **kw)
        return jnp.sum(ys * ys), (ys, st)

    (_, (ys, st)), (gw, gz) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.float32(W),
                                            jnp.asarray(batch_for(method)))
    out = {k: np.asarray(v) for k, v in st._asdict().items()}
    out.update(ys=np.asarray(ys), gz=np.asarray(gz), gw=np.asarray(gw))
    return out


@pytest.mark.parametrize("method", METHODS)
def test_sharded_matches_reference(ranks, method):
    """The sharded solve against the reference's odeint without a mesh on
    the same numpy inputs, at the batched parity bounds of
    test_torch_batched_methods.py: per-row steps, statuses and overflows
    equal (the adjoint's trials and evaluations too; the naive method
    counts the trials it takes, within the reference's budget), ys and
    gradients within rtol 1e-5. mali runs at 1e-4, where the steps agree
    within one (the lattice's quanta and the stiff rows' rounding-bound
    stepsizes differ; ROADMAP queue 3): its gradients within the same
    bounds, its ys within the solve's own tolerance."""
    ref = ranks.reference[method]
    s = ranks.sharded("mali_ref" if method == "mali"
                      else f"parity/{method}/plain")
    fields = ["status", "overflow"]
    if method == "mali":
        assert np.abs(s["n_steps"] - ref["n_steps"]).max() <= 1
        np.testing.assert_allclose(s["ys"], ref["ys"], **MALI_REF_KW)
    else:
        fields.append("n_steps")
        np.testing.assert_allclose(s["ys"], ref["ys"], rtol=REF_RTOL,
                                   atol=REF_ATOL)
    if method == "adjoint":
        fields += ["n_trials", "nfe"]
    elif method == "naive":
        assert (s["n_trials"] <= ref["n_trials"]).all()
    for name in fields:
        np.testing.assert_array_equal(s[name], ref[name], err_msg=name)
    np.testing.assert_allclose(s["gz"], ref["gz"], rtol=REF_RTOL,
                               atol=REF_ATOL)
    np.testing.assert_allclose(s["gw"], ref["gw"], rtol=REF_RTOL,
                               atol=REF_W_ATOL)


# -------------------------------------------------- elastic mesh shapes

def test_elastic_mesh_shape_pure():
    assert elastic_mesh_shape(1, 1) == (1, 1, 1)
    assert elastic_mesh_shape(8, 1) == (1, 8, 1)
    assert elastic_mesh_shape(16, 1) == (1, 16, 1)
    assert elastic_mesh_shape(32, 1) == (2, 16, 1)
    assert elastic_mesh_shape(16) == (1, 1, 16)
    assert elastic_mesh_shape(256) == (1, 16, 16)
    assert elastic_mesh_shape(512) == (2, 16, 16)
    assert elastic_mesh_shape(1024) == (4, 16, 16)


def test_elastic_mesh_shape_always_consistent():
    for mp in (1, 2, 16):
        for dp in range(1, 67):
            n = dp * mp
            pods, data, model = elastic_mesh_shape(n, mp)
            assert pods * data * model == n, (n, mp, pods, data, model)
            assert dp % pods == 0 and pods <= max(dp // 16, 1)


def test_elastic_mesh_shape_raises_readably():
    with pytest.raises(ValueError, match="not a multiple"):
        elastic_mesh_shape(8, 16)
    with pytest.raises(ValueError, match="at least one device"):
        elastic_mesh_shape(0)


def test_make_elastic_mesh_fake_ranks():
    """Meshes built at 1, 8, 16 and 32 ranks of the "fake" backend in this
    process (one process group at a time), and the named errors: a model
    dim that does not divide the world, and no process group at all."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    with pytest.raises(NoProcessGroupError):
        make_elastic_mesh(device_type="cpu")
    for n, mp in [(1, 1), (8, 2), (16, 4), (32, 8)]:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        try:
            mesh = make_elastic_mesh(model_parallel=mp, device_type="cpu")
            assert mesh.mesh_dim_names == ("pod", "data", "model"), mesh
            assert mesh.mesh.numel() == n, (n, mesh)
            assert mesh.size(2) == mp, (mp, mesh)
            assert tuple(mesh.shape) == elastic_mesh_shape(n, mp)
            if n == 8:
                with pytest.raises(ValueError, match="not a multiple"):
                    make_elastic_mesh(model_parallel=16, device_type="cpu")
                debug = make_debug_mesh(4, 2, device_type="cpu")
                assert debug.mesh_dim_names == ("data", "model")
                assert tuple(debug.shape) == (4, 2)
        finally:
            dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_fake_ranks(multi_pod):
    """The one-pod (data=16, model=16) and two-pod (pod=2, data=16,
    model=16) layouts on 256 and 512 fake ranks."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert tuple(mesh.shape) == shape
        assert mesh.mesh_dim_names[-2:] == ("data", "model")
        # a mesh must cover the whole world
        with pytest.raises(ValueError, match="holds 4 ranks"):
            make_debug_mesh(2, 2, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_init_distributed_from_torchrun_env(monkeypatch):
    """Without torchrun's environment init_distributed raises the named
    error; with it (one rank, gloo) it starts the default group, on which
    shard_mesh builds the flat one-rank mesh."""
    import torch.distributed as dist

    from repro_torch.distributed import shard_mesh
    from repro_torch.launch.mesh import free_port, init_distributed

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(NoProcessGroupError, match="torchrun"):
        init_distributed("cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    try:
        assert init_distributed("cpu") == (0, 1)
        assert dist.get_backend() == "gloo"
        mesh = shard_mesh("cpu")
        assert mesh.mesh_dim_names == ("data",) and mesh.size(0) == 1
    finally:
        dist.destroy_process_group()
