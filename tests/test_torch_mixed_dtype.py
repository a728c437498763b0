"""States whose leaves mix dtypes on the port, held against the reference.

The state ``{"a": f32 (3,), "b": bf16 (2,)}`` (two rows under
``batch_axis=0``), dz/dt = −w z, w = 0.7, ts [0, 0.5, 1], rtol 1e-3, atol
1e-4, goes through every gradient method × {solo, batched} × {adaptive,
fixed rk4 grid, ``checkpoint_segments=2``, ``interpolate_ts``} that the
reference takes. The reference's numbers for the same numpy inputs are in
``tests/torch_mixed_dtype_reference.json``, written by
``tests/torch_mixed_dtype_reference.py``; two cases are rerun live
against it. Each case checks each leaf's dtype, the outputs, the counters
and the status, and the gradients of the sum of squares of every output
with respect to z0 and w.

The port ravels the state into one flat tensor per dtype and maps every
elementwise step over the groups; the bf16 group rounds each tableau
weight to bf16 before it multiplies, as the reference's weakly typed
weights do, so every grid is the reference's (the bf16 leaf's error
estimate sits at rounding level at these tolerances, so any other
rounding of the weights moves the grid). Tolerances, as max |port − ref|
over max |ref|, per leaf dtype:

* outputs: f32 leaf 2e-6 (the same grid, f32 rounding in another order
  over at most 19 steps); bf16 leaf 2^-7 (one bf16 ulp of the largest
  output: XLA's fused bf16 arithmetic rounds some sums once where the
  port rounds every op).
* gradients of aca, adjoint and mali: f32 leaf 1e-5; the bf16 leaf and
  w 2^-6 (a few bf16 ulps: the bf16 cotangent accumulates over the steps,
  and w's cotangent sums the bf16 leaf's bf16 products).
* gradients of the naive method: it differentiates the stepsize chain,
  whose error norm the bf16 group's rounding dominates, so every
  gradient carries bf16-level noise: f32 leaf 2^-8, bf16 leaf and w
  2^-6; on the natural grid the interpolant's bf16 coefficients (sums of
  terms up to 32|z|) add their cancellation: bf16 leaf and w 2^-3 (there
  the port and the reference land 0.88 and 0.66 for a component whose
  exact gradient is 2.09; ROADMAP queue 3).

The naive method's ``n_trials`` counts the trials taken, the reference's
its budget (ROADMAP queue 3, "Deliberate (PR 20)").
"""

import json

import numpy as np
import pytest
import torch

import torch_mixed_dtype_reference as ref_cases
from repro_torch.core import (
    SolveStatus,
    odeint,
    odeint_checked,
    odeint_dense,
    solve_with_fallback,
)
from repro_torch.kernels import ops
from torch_mixed_dtype_reference import CASES, TS, W, case_id, inputs, kwargs

Y_TOL = {"a": 2e-6, "b": 2.0 ** -7}
G_TOL = {"aca": {"a": 1e-5, "b": 2.0 ** -6, "w": 2.0 ** -6},
         "naive": {"a": 2.0 ** -8, "b": 2.0 ** -6, "w": 2.0 ** -6},
         "naive-interpolate_ts": {"a": 2.0 ** -8, "b": 2.0 ** -3,
                                  "w": 2.0 ** -3}}
G_TOL["adjoint"] = G_TOL["mali"] = G_TOL["aca"]

with open(ref_cases.PATH) as _fh:
    REFERENCE = json.load(_fh)


def field(t, z, w):
    return {"a": -w * z["a"], "b": -w.to(z["b"].dtype) * z["b"]}


def port(case, **extra):
    """One case through the port: (ys, stats, (dL/da, dL/db, dL/dw))."""
    a, b = inputs(case[1])
    za = torch.tensor(a, requires_grad=True)
    zb = torch.tensor(b).bfloat16().requires_grad_()
    w = torch.tensor(W, requires_grad=True)
    ys, st = odeint(field, {"a": za, "b": zb}, TS, (w,),
                    **kwargs(case), **extra)
    loss = sum(torch.sum(y.float() ** 2) for y in ys.values())
    return ys, st, torch.autograd.grad(loss, [za, zb, w])


def _rel(x, want) -> float:
    x = np.asarray(torch.as_tensor(x).detach().float()).ravel()
    want = np.asarray(want, np.float64).ravel()
    return float(np.abs(x - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_mixed_state_matches_reference(case):
    method, _, mode = case
    want = REFERENCE[case_id(case)]
    ys, st, (ga, gb, gw) = port(case)
    assert {k: str(v.dtype).replace("torch.", "") for k, v in ys.items()} \
        == want["dtypes"]
    assert (str(ga.dtype), str(gb.dtype)) == ("torch.float32",
                                              "torch.bfloat16")
    assert want["grad_dtypes"] == {"a": "float32", "b": "bfloat16"}
    assert st.status.reshape(-1).tolist() == want["status"] \
        == [SolveStatus.OK] * len(want["status"])
    assert st.n_steps.reshape(-1).tolist() == want["n_steps"]
    if method == "naive" and mode != "fixed":
        # the port stops where the solve ends; the reference scans its
        # whole trial budget
        assert want["n_trials"] == [ref_cases.KW["max_steps"] * 12] * len(
            want["n_trials"])
        assert st.n_trials.reshape(-1).tolist() == want["n_steps"]
    else:
        assert st.n_trials.reshape(-1).tolist() == want["n_trials"]
    for leaf in ("a", "b"):
        assert _rel(ys[leaf], want["ys"][leaf]) <= Y_TOL[leaf], leaf
    tol = G_TOL.get(f"{method}-{mode}", G_TOL[method])
    for leaf, g in (("a", ga), ("b", gb), ("w", gw)):
        assert _rel(g, want["grad"][leaf]) <= tol[leaf], leaf


@pytest.mark.parametrize("name", ["aca-solo-fixed", "mali-solo-adaptive"])
def test_reference_numbers_are_current(name):
    """The stored reference numbers are what the reference computes now."""
    case = next(c for c in CASES if case_id(c) == name)
    assert ref_cases.reference(case) == REFERENCE[name]


_FUSED = ("rk_stage_increment", "rk_stage_combine_err",
          "rk_stage_increment_batched", "rk_stage_combine_err_batched")


@pytest.fixture
def fused_calls(monkeypatch):
    """Calls of the fused stage and combine wrappers, by name."""
    calls = {k: 0 for k in _FUSED}
    for name in _FUSED:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == "adaptive"],
                         ids=[case_id(c) for c in CASES
                              if c[2] == "adaptive"])
def test_use_pallas_on_mixed_state_takes_no_kernel(case, fused_calls):
    """A mixed state never takes K1-K5 (the reference's maybe_flatten
    rule): use_pallas=True calls no fused wrapper and gives use_pallas=
    False's bits, gradients included."""
    ys0, st0, g0 = port(case)
    ys1, st1, g1 = port(case, use_pallas=True)
    assert sum(fused_calls.values()) == 0
    for k in ys0:
        assert torch.equal(ys0[k], ys1[k])
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert torch.equal(st0.n_trials, st1.n_trials)
    # the same problem in one dtype does take them (mali's only in its
    # backward)
    a, b = inputs(case[1])
    za = torch.tensor(a, requires_grad=True)
    ys, _ = odeint(field, {"a": za, "b": torch.tensor(b)}, TS,
                   (torch.tensor(W),), use_pallas=True, **kwargs(case))
    torch.autograd.grad(ys["a"].sum(), za)
    assert sum(fused_calls.values()) > 0


@pytest.mark.parametrize("method", ["aca", "adjoint", "naive", "mali"])
@pytest.mark.parametrize("batched", [False, True], ids=["solo", "batched"])
def test_one_dtype_pytree_is_the_raveled_solve(method, batched):
    """A pytree of one dtype still ravels into one tensor: its solve is bit
    for bit the solve of the concatenated state, gradients included."""
    a, b = inputs(batched)
    kw = dict(kwargs((method, batched, "adaptive")))
    cat = np.concatenate([a, b], axis=-1)

    def grads(z0, f, split):
        w = torch.tensor(W, requires_grad=True)
        leaves = [z0] if torch.is_tensor(z0) else list(z0.values())
        ys, st = odeint(f, z0, TS, (w,), **kw)
        out = split(ys)
        loss = sum(torch.sum(y ** 2) for y in out)
        return out, st, torch.autograd.grad(loss, leaves + [w])

    za, zb = torch.tensor(a, requires_grad=True), \
        torch.tensor(b, requires_grad=True)
    tree = grads({"a": za, "b": zb}, field, lambda ys: [ys["a"], ys["b"]])
    flat = grads(torch.tensor(cat, requires_grad=True),
                 lambda t, z, w: torch.cat([-w * z[..., :3],
                                            -w * z[..., 3:]], dim=-1),
                 lambda ys: [ys[..., :3], ys[..., 3:]])
    for x, y in zip(tree[0], flat[0]):
        assert torch.equal(x, y)
    assert torch.equal(tree[1].n_trials, flat[1].n_trials)
    gflat = flat[2]
    assert torch.equal(torch.cat([tree[2][0], tree[2][1]], dim=-1), gflat[0])
    assert torch.equal(tree[2][2], gflat[1])


def _mixed(a=None):
    a0, b0 = inputs(False)
    return {"a": torch.tensor(a0 if a is None else a),
            "b": torch.tensor(b0).bfloat16()}


def test_dense_checked_and_fallback_take_mixed_states():
    """``odeint_dense`` reads each leaf off its own dtype's interpolant:
    the f32 leaf within the tolerance of a landing solve, the bf16 leaf
    within the bf16 quartic's rounding (its coefficients sum terms up to
    32·max|z|, each rounded to bf16: 4 half ulps of 32·max|z|)."""
    w = (torch.tensor(W),)
    sol, st = odeint_dense(field, _mixed(), 0.0, 1.0, w, rtol=1e-3,
                           atol=1e-4)
    assert int(st.status) == SolveStatus.OK
    out = sol.evaluate(torch.tensor([0.25, 1.0]))
    assert (out["a"].dtype, out["b"].dtype) == (torch.float32,
                                                torch.bfloat16)
    ys, _ = odeint(field, _mixed(), [0.0, 0.25, 1.0], w, rtol=1e-3,
                   atol=1e-4)
    assert torch.allclose(out["a"], ys["a"][1:], atol=1e-3)
    zmax = float(_mixed()["b"].float().abs().max())
    bound = 4 * 0.5 * 2.0 ** (np.floor(np.log2(32 * zmax)) - 7)
    assert float((out["b"].float() - ys["b"][1:].float()).abs().max()) \
        <= bound
    ys_c, _ = odeint_checked(field, _mixed(), TS, w, rtol=1e-3, atol=1e-4)
    assert torch.equal(ys_c["b"], odeint(field, _mixed(), TS, w, rtol=1e-3,
                                         atol=1e-4)[0]["b"])
    ys_f, st_f, report = solve_with_fallback(field, _mixed(), TS, w,
                                             rtol=1e-3, atol=1e-4)
    assert report[0]["ok"] and int(st_f.status) == SolveStatus.OK
    assert ys_f["b"].dtype == torch.bfloat16


def test_mixed_state_in_reverse_time_and_with_f64():
    """Descending ts and an f32/f64 pair: each leaf keeps its dtype and the
    f64 leaf decays as exp(-w t)."""
    z0 = {"x": torch.tensor([1.0, 2.0], dtype=torch.float64),
          "y": torch.tensor([0.5])}
    ys, st = odeint(lambda t, z, w: {"x": -w * z["x"], "y": -w * z["y"]},
                    z0, [1.0, 0.0], (torch.tensor(W),), rtol=1e-8,
                    atol=1e-10)
    assert (ys["x"].dtype, ys["y"].dtype) == (torch.float64, torch.float32)
    np.testing.assert_allclose(ys["x"][-1].numpy(), [np.exp(W),
                                                     2 * np.exp(W)],
                               rtol=1e-6)


def test_one_dtype_bf16_state_keeps_its_unrounded_weights():
    """A bf16 tensor state alone rounds its tableau weights to bf16 as the
    reference's plain route does (a weakly typed weight takes the leaf's
    dtype), so it takes the reference's grid at rtol 1e-3, where its error
    estimate sits at rounding level: the reference's counters and outputs.
    (The name is kept from when the one-tensor path used the unrounded
    weights and took 6 steps against the reference's 4.)"""
    from repro.core import odeint as jodeint
    import jax.numpy as jnp

    b = inputs(False)[1]
    ys, st = odeint(lambda t, z, w: -w.to(z.dtype) * z,
                    torch.tensor(b).bfloat16(), TS, (torch.tensor(W),),
                    rtol=1e-3, atol=1e-4)
    ys_r, st_r = jodeint(lambda t, z, w: -w.astype(z.dtype) * z,
                         jnp.asarray(b).astype(jnp.bfloat16),
                         jnp.asarray(TS, jnp.float32), (jnp.float32(W),),
                         rtol=1e-3, atol=1e-4)
    for name in ("n_steps", "n_trials", "nfe", "status"):
        assert int(getattr(st, name)) == int(getattr(st_r, name)), name
    assert int(st.n_steps) == 4
    assert np.array_equal(ys.float().numpy(),
                          np.asarray(ys_r.astype(jnp.float32)))
