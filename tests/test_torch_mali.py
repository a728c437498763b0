"""MALI on the port, mirroring ``tests/test_mali.py``.

* ``alf_step_inverse(alf_step(s)) == s`` bit for bit: the reference's
  dtype × scale grid (f32 and f64; bf16 too here), a nested-pytree chain
  of 50 steps, per-row batched steps with an h = 0 row, and a seeded grid
  in place of the reference's hypothesis sweep (optional, often absent);
* the whole trajectory reconstructed bitwise by inverting from the
  terminal pair, in a replay and through the backward sweep itself;
* gradients against the naive method within 1e-5 relative on the stiff
  van der Pol problem (solo and batched, plain and fused path), pytree
  states, batched against solo per row, several eval times, reverse time;
* the api surface: the ``solver="alf"`` pairing, the rejected
  ``checkpoint_segments``/``interpolate_ts``, ``NodeConfig`` threading,
  the fused backward's half-drifts through the port's ``ops``.

Beyond the reference: the lattice's integer adds wrap at ±2³¹ and ±2⁶³,
its quanta are exact powers of two (the reference's ``jnp.exp2`` is not,
on XLA's CPU backend), rounding is half to even and bf16 products round
in bf16; ys, ``SolveStats`` and gradients agree with the reference's on
its problems at rtol=1e-5, atol=1e-6 for values and 1e-5 of the
gradient's scale, with equal steps and trials at 1e-4 and 1e-5 (tighter
grids follow f32 rounding noise, ROADMAP queue 3);
``repro_torch.benchmarks.mali_memory`` at its quick size.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import odeint as jodeint
from repro.core import stepper as jstep
from repro.core.integrate import mali_adaptive_solve as jmali_solve
from repro.kernels import ops as jops
from repro_torch.core import NodeConfig, node_block_apply, odeint
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.integrate import mali_adaptive_solve
from repro_torch.core.stepper import (
    _lattice_quantize_leaf,
    _pow2,
    alf_lattice_exponent,
    alf_step,
    alf_step_batched,
    alf_step_inverse,
    alf_step_inverse_batched,
    lattice_add,
    lattice_decode,
    lattice_encode,
    lattice_sub,
)

MU = 2.0
Z0_VDP = np.array([2.0, 0.0], np.float32)
TS_VDP = np.array([0.0, 0.5], np.float32)
ZB_VDP = np.array([[2.0, 0.0], [1.0, 0.5], [0.3, -0.2]], np.float32)
PARITY = 1e-5
# The f32 parameter gradient on the van der Pol problem, relative to its
# scale: twice the gaps the tests meet on the CPU (1.48e-5 against the
# naive method at rtol 1e-7, 1.28e-5 against the reference at rtol 1e-4),
# and above every gap measured at rtol 5e-8 to 2e-7 (at most 1.79e-5,
# the reference's own). They come from the f32 lattice's quantum (2^-23
# at this state's scale, a third of the error scale at rtol 1e-7):
# rounding the pair onto it moves the accepted grid, and the parameter
# gradient, a sum over every step's contribution, follows the grid
# (ROADMAP queue 3).
F32_PARAM_GRAD = 3e-5
tmali = importlib.import_module("repro_torch.core.odeint_mali")
tstep = importlib.import_module("repro_torch.core.stepper")


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jops.set_interpret(True)
    yield
    jops.set_interpret(None)


def vdp(t, z, mu):
    """Stiff-ish van der Pol: the MALI smoke problem."""
    x, y = z[..., 0], z[..., 1]
    return torch.stack([y, mu * (1.0 - x ** 2) * y - x], dim=-1)


def vdp_j(t, z, mu):
    x, y = z[..., 0], z[..., 1]
    return jnp.stack([y, mu * (1.0 - x ** 2) * y - x], axis=-1)


def linear(t, z, k):
    return k * z


def _bits_equal(a, b):
    la = torch.utils._pytree.tree_leaves(a)
    lb = torch.utils._pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _rel(port, ref) -> float:
    port, ref = np.asarray(port), np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# bit-exact inversion of the lattice pair step
# ---------------------------------------------------------------------------

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 37.0, 1e8, 1e30])
def test_alf_roundtrip_bitexact_scales(dtype, scale):
    """inverse(step(s)) == s bitwise across dtypes and 50 orders of
    magnitude (lattice wraparound included). In f32 the lattice exponent
    is the reference's and the decoded step within 2e-6 relative of its:
    not its integers, since the reference's quanta come from ``jnp.exp2``,
    which XLA's CPU backend rounds (up to 1.01e-6 off a power of two; the
    port builds exact powers, ``test_quanta_are_exact_powers_of_two``)."""
    dt = DTYPES[dtype]
    zn = np.random.default_rng(0).standard_normal(17) * scale
    k = torch.tensor(-0.7, dtype=dt)
    z = torch.tensor(zn, dtype=torch.float64).to(dt)
    v = linear(0.0, z, k)
    se = alf_lattice_exponent(z, v)
    zq, vq = lattice_encode(z, se), lattice_encode(v, se)
    t, h = torch.tensor(0.3, dtype=dt), torch.tensor(0.05, dtype=dt)
    res = alf_step(linear, t, h, zq, vq, se, z, (k,))
    back = alf_step_inverse(linear, t, h, res.zq_next, res.vq_next, se, z,
                            (k,))
    assert _bits_equal(back, (zq, vq))
    if dt == torch.float32:
        zj = jnp.asarray(z.numpy())
        kj = jnp.float32(-0.7)
        vj = kj * zj
        sej = jstep.alf_lattice_exponent(zj, vj)
        assert float(se) == float(sej)
        rj = jax.jit(lambda a, b: jstep.alf_step(
            lambda t, z, k: k * z, jnp.float32(0.3), jnp.float32(0.05), a,
            b, sej, zj, (kj,)))(jstep.lattice_encode(zj, sej),
                                jstep.lattice_encode(vj, sej))
        zn_r = np.asarray(rj.z_next)
        np.testing.assert_allclose(res.z_next.numpy(), zn_r, rtol=2e-6,
                                   atol=2e-6 * np.abs(zn_r).max())


def test_alf_roundtrip_bitexact_pytree_chain():
    """50 chained steps then 50 inversions recover every intermediate pair
    bitwise, on a nested pytree state."""
    def f(t, z, k):
        return {"a": k * z["a"], "b": -0.3 * z["b"] + torch.mean(z["a"])}

    rng = np.random.default_rng(1)
    k = torch.tensor(-0.5)
    z = {"a": torch.tensor(rng.standard_normal(8), dtype=torch.float32),
         "b": torch.tensor(rng.standard_normal((3, 2)), dtype=torch.float32)}
    v = f(0.0, z, k)
    se = alf_lattice_exponent(z, v)
    h = torch.tensor(0.02)
    states = [(lattice_encode(z, se), lattice_encode(v, se))]
    for i in range(50):
        r = alf_step(f, torch.tensor(0.02 * i), h, *states[-1], se, z, (k,))
        states.append((r.zq_next, r.vq_next))
    cur = states[-1]
    for i in range(49, -1, -1):
        cur = alf_step_inverse(f, torch.tensor(0.02 * i), h, *cur, se, z,
                               (k,))
        assert _bits_equal(cur, states[i]), f"mismatch at step {i}"


def test_alf_roundtrip_bitexact_batched():
    """Per-row inversion is bitwise with per-row stepsizes, an h = 0 row
    included (the batched sweep inverts, then masks)."""
    k = torch.tensor(-0.9)
    z = torch.tensor(np.random.default_rng(3).standard_normal((4, 6)),
                     dtype=torch.float32)
    v = torch.func.vmap(lambda zi: linear(0.0, zi, k))(z)
    se = alf_lattice_exponent(z, v)
    zq, vq = lattice_encode(z, se), lattice_encode(v, se)
    t = torch.tensor([0.0, 0.1, 0.2, 0.3])
    h = torch.tensor([0.05, 0.0, 0.11, 0.02])
    res = alf_step_batched(linear, t, h, zq, vq, se, z, (k,))
    back = alf_step_inverse_batched(linear, t, h, res.zq_next, res.vq_next,
                                    se, z, (k,))
    assert _bits_equal(back, (zq, vq))


def test_alf_step_order():
    """One ALF step is second order: halving h cuts the one-step error
    about 8× (local O(h³)) on dz/dt = kz."""
    k = torch.tensor(-1.3)
    z = torch.tensor([1.5])
    v = linear(0.0, z, k)
    se = alf_lattice_exponent(z, v)

    def one_step_err(h):
        r = alf_step(linear, torch.tensor(0.0), torch.tensor(h),
                     lattice_encode(z, se), lattice_encode(v, se), se, z,
                     (k,))
        return abs(float(r.z_next[0]) - 1.5 * np.exp(float(k) * h))

    e1, e2 = one_step_err(0.2), one_step_err(0.1)
    assert e1 / e2 > 5.0, (e1, e2)


GRID = [(seed, scale, h, k)
        for seed, (scale, h, k) in enumerate(
            [(1e-6, 1e-6, -5.0), (1e-3, 0.3, 4.9), (1.0, 10.0, -0.1),
             (7.5, 1e-3, 2.5), (1e3, 0.77, -3.3), (1e6, 5.0, 0.0),
             (0.5, 2.0, -4.99), (3e4, 1e-5, 1.7), (12.0, 9.99, -2.2),
             (1e-2, 0.05, 5.0), (2e5, 3.3, -0.6), (0.08, 7.1, 3.9)])]


@pytest.mark.parametrize("seed,scale,h,k", GRID)
def test_alf_roundtrip_bitexact_property(seed, scale, h, k):
    """inverse(step(s)) == s bitwise over a seeded grid of states, scales
    (1e-6-1e6), stepsizes (1e-6-10) and rates (-5-5): the reference's
    hypothesis ranges."""
    kk = torch.tensor(k, dtype=torch.float32)
    z = torch.tensor(np.random.default_rng(seed).standard_normal(9) * scale,
                     dtype=torch.float32)
    v = linear(0.0, z, kk)
    se = alf_lattice_exponent(z, v)
    zq, vq = lattice_encode(z, se), lattice_encode(v, se)
    hh, t0 = torch.tensor(h, dtype=torch.float32), torch.tensor(0.0)
    res = alf_step(linear, t0, hh, zq, vq, se, z, (kk,))
    back = alf_step_inverse(linear, t0, hh, res.zq_next, res.vq_next, se, z,
                            (kk,))
    assert _bits_equal(back, (zq, vq))


# ---------------------------------------------------------------------------
# the lattice's arithmetic, pinned
# ---------------------------------------------------------------------------

def test_lattice_adds_wrap_at_the_integer_range():
    """torch's int32 and int64 adds and subtracts wrap (two's complement)
    on the CPU, near ±2³¹ and ±2⁶³; the card test pins the same on CUDA."""
    for dt, bits in ((torch.int32, 32), (torch.int64, 64)):
        hi, lo = 2 ** (bits - 1) - 1, -2 ** (bits - 1)
        a = torch.tensor([hi, lo, hi - 5, lo + 5, 0], dtype=dt)
        b = torch.tensor([1, -1, 10, -10, hi], dtype=dt)
        want_add = [lo, hi, lo + 4, hi - 4, hi]
        want_sub = [hi - 1, lo + 1, hi - 15, lo + 15, -hi]
        assert lattice_add(a, b).tolist() == want_add
        assert lattice_sub(a, b).tolist() == want_sub
        # the bijection the inverse relies on, across the wrap
        assert torch.equal(lattice_sub(lattice_add(a, b), b), a)


def test_quanta_are_exact_powers_of_two():
    """δ and 1/δ come from exponent bits: exactly 2^e in f32 (e in
    [-126, 127]), f64 (e in [-1022, 1023]) and bf16, equal to
    ``torch.ldexp``. The reference's ``jnp.exp2`` is not exact on XLA's
    CPU backend: within 1.1e-6 relative for the exponents of states of
    magnitude 2^-6 to 2^54 (e in [-30, 30]), off on 28 of them (ROADMAP
    queue 3)."""
    e32 = torch.arange(-126, 128, dtype=torch.float32)
    p32 = _pow2(e32, torch.float32)
    assert torch.equal(p32, torch.ldexp(torch.ones_like(e32),
                                        e32.to(torch.int32)))
    mid = slice(126 - 30, 126 + 31)
    ref = np.asarray(jnp.exp2(jnp.asarray(e32[mid].numpy())))
    np.testing.assert_allclose(ref, p32[mid].numpy(), rtol=1.1e-6, atol=0)
    np.testing.assert_array_equal(p32.numpy(), np.ldexp(
        np.float32(1), np.arange(-126, 128)).astype(np.float32))
    e64 = torch.arange(-1022, 1024, dtype=torch.float32)
    np.testing.assert_array_equal(
        _pow2(e64, torch.float64).numpy(),
        np.ldexp(1.0, np.arange(-1022, 1024)))
    assert torch.equal(_pow2(e32, torch.bfloat16).float(), p32)


def test_lattice_rounding_rules():
    """Half to even (as ``jnp.round``), decoding |q| > 2²⁴ rounds to
    nearest, bf16 products round in bf16, and a bf16 coordinate at the
    clip bound saturates at 2³¹ − 1 as the reference's convert does."""
    se = torch.tensor(0.0)
    # x · 2^24 lands on .5 quanta: ties go to the even integer
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5], dtype=torch.float64) \
        * 2.0 ** -24
    q = _lattice_quantize_leaf(x.float(), se)
    assert q.tolist() == [0, 2, 2, 0, -2]
    q = torch.tensor([2 ** 24 + 1, 2 ** 25 + 3, 2 ** 31 - 1, -(2 ** 24) - 3],
                     dtype=torch.int32)
    got = lattice_decode(q, torch.tensor(24.0), torch.zeros(4))
    np.testing.assert_array_equal(got.numpy(),
                                  q.double().float().numpy())
    np.testing.assert_array_equal(got.numpy(), [2.0 ** 24, 2.0 ** 25 + 4,
                                                2.0 ** 31, -(2.0 ** 24) - 4])
    xb = torch.tensor([1.0 + 2 ** -7, 3.0 - 2 ** -6, 1e-3],
                      dtype=torch.bfloat16)
    qb = _lattice_quantize_leaf(xb, torch.tensor(2.0))
    inv = torch.tensor(2.0 ** 22, dtype=torch.bfloat16)
    assert qb.tolist() == torch.round(xb * inv).to(torch.int32).tolist()
    big = _lattice_quantize_leaf(torch.tensor([1e12, -1e12],
                                              dtype=torch.bfloat16), se)
    assert big.tolist() == [2 ** 31 - 1, -2 ** 31]
    np.testing.assert_array_equal(big.numpy(), np.asarray(
        jstep.lattice_encode(jnp.asarray([1e12, -1e12], jnp.bfloat16),
                             jnp.float32(0.0))))


# ---------------------------------------------------------------------------
# full-trajectory reverse reconstruction (solo engine)
# ---------------------------------------------------------------------------

def test_reverse_reconstruction_bit_identical():
    """Inverting from the terminal pair reproduces every accepted forward
    pair bitwise, in a replay of the grid and through the backward sweep
    (which ends on the encoded start pair)."""
    z0, mu = torch.tensor(Z0_VDP), torch.tensor(MU)
    ts = torch.tensor(TS_VDP)
    _, grid, stats = mali_adaptive_solve(vdp, z0, ts, (mu,), 1e-5, 1e-5,
                                         ControllerConfig(max_steps=1024))
    assert not bool(stats.overflow)
    n = grid.n
    assert n > 20
    v0 = vdp(ts[0], z0, mu)
    pairs = [(lattice_encode(z0, grid.scale_exp),
              lattice_encode(v0, grid.scale_exp))]
    for i in range(n):
        r = alf_step(vdp, grid.t[i], grid.h[i], *pairs[-1], grid.scale_exp,
                     z0, (mu,))
        pairs.append((r.zq_next, r.vq_next))
    # the engine's loop and the replay agree bitwise
    assert _bits_equal(pairs[-1], (grid.zT, grid.vT))
    cur = (grid.zT, grid.vT)
    for i in range(n - 1, -1, -1):
        cur = alf_step_inverse(vdp, grid.t[i], grid.h[i], *cur,
                               grid.scale_exp, z0, (mu,))
        assert _bits_equal(cur, pairs[i]), f"mismatch at step {i}"

    # the backward sweep of odeint itself ends on the encoded start pair
    ends = []
    orig = tmali.mali_backward_sweep

    def recording(sw):
        out = orig(sw)
        ends.append(((sw.zq, sw.vq), sw.encoded_start()))
        return out

    tmali.mali_backward_sweep = recording
    try:
        for batch in (False, True):
            zz = torch.tensor(ZB_VDP if batch else Z0_VDP,
                              requires_grad=True)
            ys, _ = odeint(vdp, zz, ts, (mu,), grad_method="mali", rtol=1e-5,
                           atol=1e-5, max_steps=1024,
                           batch_axis=0 if batch else None)
            ys[-1].sum().backward()
    finally:
        tmali.mali_backward_sweep = orig
    assert len(ends) == 2
    for got, want in ends:
        assert _bits_equal(got, want)


# ---------------------------------------------------------------------------
# forward accuracy and gradients against the naive method
# ---------------------------------------------------------------------------

def test_forward_tracks_tolerance():
    ts = torch.linspace(0.0, 2.0, 5)
    ys, st = odeint(linear, torch.tensor(1.5), ts, (torch.tensor(-0.8),),
                    grad_method="mali", rtol=1e-5, atol=1e-5, max_steps=2048)
    exact = 1.5 * np.exp(-0.8 * ts.numpy())
    assert not bool(st.overflow)
    assert np.abs(ys.numpy() - exact).max() < 1e-4


def test_one_feval_per_trial():
    """ALF costs one field evaluation a trial (+3: v0 and the initial
    stepsize's two)."""
    _, st = odeint(linear, torch.tensor(1.0), torch.tensor([0.0, 1.0]),
                   (torch.tensor(-0.5),), grad_method="mali", rtol=1e-4,
                   atol=1e-4, max_steps=1024)
    assert int(st.nfe) == int(st.n_trials) + 3


def _vdp_grads(method, *, rtol, max_steps, use_pallas=False, batch=False,
               solver=None):
    z0 = torch.tensor(ZB_VDP if batch else Z0_VDP, requires_grad=True)
    mu = torch.tensor(MU, requires_grad=True)
    ys, st = odeint(vdp, z0, torch.tensor(TS_VDP), (mu,), grad_method=method,
                    solver=solver, rtol=rtol, atol=rtol, max_steps=max_steps,
                    use_pallas=use_pallas, batch_axis=0 if batch else None)
    torch.sum(ys[-1] ** 2).backward()
    return (z0.grad, mu.grad), ys.detach(), st


def _vdp_grads_dtype(method, dtype, *, rtol, max_steps, use_pallas=False,
                     batch=False, solver=None):
    z0 = torch.tensor(ZB_VDP if batch else Z0_VDP, dtype=dtype,
                      requires_grad=True)
    mu = torch.tensor(MU, dtype=dtype, requires_grad=True)
    ys, _ = odeint(vdp, z0, torch.tensor(TS_VDP, dtype=dtype), (mu,),
                   grad_method=method, solver=solver, rtol=rtol, atol=rtol,
                   max_steps=max_steps, use_pallas=use_pallas,
                   batch_axis=0 if batch else None)
    torch.sum(ys[-1] ** 2).backward()
    return z0.grad, mu.grad


@functools.lru_cache(maxsize=None)
def _naive_vdp(batch, dtype):
    return _vdp_grads_dtype("naive", DTYPES[dtype], rtol=1e-8,
                            max_steps=512, batch=batch, solver="dopri5")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("batch", [False, True])
def test_grads_match_naive_vdp(use_pallas, batch):
    """MALI's gradients within 1e-5 (of each gradient's largest entry) of
    the naive method's on the stiff van der Pol problem at the reference's
    settings (MALI rtol 1e-7, naive Dopri5 1e-8), solo and batched, plain
    and fused.

    In f64 (the int64 lattice, on the plain path: the kernels take f32 and
    bf16) every gradient is held to the bound. In f32 the state gradient
    is; the parameter gradient (0.039, a sum over ~1,800 steps'
    contributions) is held to ``F32_PARAM_GRAD``, 3e-5: at rtol 1e-7 the
    f32 lattice's quantum, 2^-23 at this state's scale, is a third of the
    error scale, and that gradient lands 1e-7 to 2e-5 from the naive one
    as the grid moves, in the reference as in the port (ROADMAP queue 3:
    the reference's own misses its 1e-5 at rtol 5e-8, 7e-8 and 2e-7 and
    reads 2.85e-6 at 1e-7; the port's is 1.48e-5 at 1e-7, its f64
    1.1e-6)."""
    for dtype in ("float64", "float32"):
        g_mali = _vdp_grads_dtype("mali", DTYPES[dtype], rtol=1e-7,
                                  max_steps=8192, batch=batch,
                                  use_pallas=use_pallas
                                  and dtype == "float32")
        bounds = (1e-5, 1e-5 if dtype == "float64" else F32_PARAM_GRAD)
        for gm, gr, bound in zip(g_mali, _naive_vdp(batch, dtype), bounds):
            denom = float(gr.abs().max())
            assert float((gm - gr).abs().max()) <= bound * denom, \
                (dtype, gm, gr)


def _pair_field(t, z, k):
    return {"a": k * z["a"], "b": -0.4 * z["b"] + torch.mean(z["a"])}


def test_grads_match_naive_pytree():
    """A dict state with leaves of two shapes."""
    def grads(method, rtol, ms, solver):
        z0 = {"a": torch.tensor([1.0, -0.5], requires_grad=True),
              "b": torch.tensor([[0.2], [0.7]], requires_grad=True)}
        k = torch.tensor(-0.6, requires_grad=True)
        ys, _ = odeint(_pair_field, z0, torch.tensor([0.0, 0.8]), (k,),
                       grad_method=method, solver=solver, rtol=rtol,
                       atol=rtol, max_steps=ms)
        sum(torch.sum(y[-1] ** 2) for y in ys.values()).backward()
        return [z0["a"].grad, z0["b"].grad, k.grad]

    g_ref = grads("naive", 1e-8, 512, "dopri5")
    g_mali = grads("mali", 1e-7, 8192, None)
    for gm, gr in zip(g_mali, g_ref):
        denom = float(gr.abs().max())
        assert float((gm - gr).abs().max()) <= 1e-5 * max(denom, 1e-6)


def test_batched_matches_vmap_of_solo():
    """Every row on its own grid and lattice: the batched solve's steps,
    outputs (bit for bit) and gradients (within 1e-6) are each row's solo
    solve's."""
    mu = torch.tensor(MU)
    ts = torch.tensor(TS_VDP)
    kw = dict(grad_method="mali", rtol=1e-5, atol=1e-5, max_steps=2048)
    zb = torch.tensor(ZB_VDP, requires_grad=True)
    ysb, stb = odeint(vdp, zb, ts, (mu,), batch_axis=0, **kw)
    torch.sum(ysb[-1] ** 2).backward()
    assert len(set(stb.n_steps.tolist())) > 1
    for b in range(3):
        zs = torch.tensor(ZB_VDP[b], requires_grad=True)
        ys, st = odeint(vdp, zs, ts, (mu,), **kw)
        torch.sum(ys[-1] ** 2).backward()
        assert int(st.n_steps) == int(stb.n_steps[b])
        assert torch.equal(ys.detach(), ysb[:, b].detach())
        assert float((zs.grad - zb.grad[b]).abs().max()) < 1e-6


def test_multi_time_outputs_and_grad():
    """Interior eval times land exactly and carry their cotangents through
    the inverting sweep."""
    ts = torch.linspace(0.0, 1.0, 5)
    z0 = torch.tensor(1.3, requires_grad=True)
    ys, _ = odeint(linear, z0, ts, (torch.tensor(-1.1),), grad_method="mali",
                   rtol=1e-6, atol=1e-6, max_steps=4096)
    torch.sum(ys ** 2).backward()
    exact = sum(2 * 1.3 * np.exp(2 * -1.1 * t) for t in ts.numpy())
    assert abs(float(z0.grad) - exact) < 1e-3 * abs(exact)


def test_reverse_time_descending_ts():
    z0 = torch.tensor(1.0, requires_grad=True)
    ys, _ = odeint(linear, z0, torch.tensor([2.0, 0.0]),
                   (torch.tensor(-0.8),), grad_method="mali", rtol=1e-5,
                   atol=1e-5, max_steps=2048)
    ys[-1].backward()
    assert abs(float(ys[-1].detach()) - np.exp(1.6)) < 1e-3
    assert abs(float(z0.grad) - np.exp(1.6)) < 1e-3 * np.exp(1.6)


# ---------------------------------------------------------------------------
# against the reference on its problems
# ---------------------------------------------------------------------------

def _ref_vdp(tol, batch, use_pallas):
    def loss(z0, mu):
        ys, st = jodeint(vdp_j, z0, jnp.asarray(TS_VDP), (mu,),
                         grad_method="mali", rtol=tol, atol=tol,
                         max_steps=2048, use_pallas=use_pallas,
                         batch_axis=0 if batch else None)
        return jnp.sum(ys[-1] ** 2), (ys, st)

    return jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(ZB_VDP if batch else Z0_VDP), jnp.float32(MU))


def _xla_pow2(e, fdt):
    """The reference's quanta: XLA's ``jnp.exp2`` of the same exponents."""
    return torch.tensor(np.asarray(jnp.exp2(jnp.asarray(
        e.detach().numpy())))).to(fdt)


@pytest.mark.parametrize("tol", [1e-4, 1e-5])
@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_mali_matches_reference_vdp(tol, batch, use_pallas):
    """ys, SolveStats and gradients of the port's MALI against the
    reference's on the van der Pol problem: steps, trials, evaluations and
    status equal, ys within rtol=1e-5, atol=1e-6, the state gradient
    within 1e-5 of its scale, the parameter gradient within
    ``F32_PARAM_GRAD`` (3e-5): with the port's exact quanta it sits up to
    1.28e-5 from the reference's, the reference's exp2 rounding (ROADMAP
    queue 3). With the reference's quanta in the port's lattice
    (``_xla_pow2``) it is held to 1e-5 as well."""
    g, ys, st = _vdp_grads("mali", rtol=tol, max_steps=2048, batch=batch,
                           use_pallas=use_pallas)
    (_, (ys_r, st_r)), g_r = _ref_vdp(tol, batch, use_pallas)
    for name in ("n_steps", "n_trials", "nfe", "status"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(st_r, name)), name)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_r), rtol=1e-5,
                               atol=1e-6)
    assert _rel(g[0], g_r[0]) <= PARITY
    assert _rel(g[1], g_r[1]) <= F32_PARAM_GRAD
    orig = tstep._pow2
    tstep._pow2 = _xla_pow2
    try:
        g, _, st = _vdp_grads("mali", rtol=tol, max_steps=2048, batch=batch,
                              use_pallas=use_pallas)
    finally:
        tstep._pow2 = orig
    np.testing.assert_array_equal(st.n_steps.numpy(),
                                  np.asarray(st_r.n_steps))
    for a, b in zip(g, g_r):
        assert _rel(a, b) <= PARITY


def test_mali_matches_reference_multi_time_pytree():
    """Several eval times, a dict state and a parameter: the reference's
    counters and, within the parity bounds, its outputs and gradients."""
    ts = np.array([0.0, 0.3, 0.8], np.float32)
    z0 = {"a": np.array([1.0, -0.5], np.float32),
          "b": np.array([[0.2], [0.7]], np.float32)}
    zt = {k: torch.tensor(v, requires_grad=True) for k, v in z0.items()}
    k = torch.tensor(-0.6, requires_grad=True)
    ys, st = odeint(_pair_field, zt, torch.tensor(ts), (k,),
                    grad_method="mali", rtol=1e-4, atol=1e-4, max_steps=512)
    sum(torch.sum(y ** 2) for y in ys.values()).backward()

    def loss(z, k):
        ys, st = jodeint(
            lambda t, z, k: {"a": k * z["a"],
                             "b": -0.4 * z["b"] + jnp.mean(z["a"])},
            z, jnp.asarray(ts), (k,), grad_method="mali", rtol=1e-4,
            atol=1e-4, max_steps=512)
        return sum(jnp.sum(y ** 2) for y in ys.values()), (ys, st)

    (_, (ys_r, st_r)), (gz_r, gk_r) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(
            {k_: jnp.asarray(v) for k_, v in z0.items()}, jnp.float32(-0.6))
    assert int(st.n_steps) == int(st_r.n_steps)
    assert int(st.n_trials) == int(st_r.n_trials)
    for key in z0:
        np.testing.assert_allclose(ys[key].detach().numpy(),
                                   np.asarray(ys_r[key]), rtol=1e-5,
                                   atol=1e-6)
        assert _rel(zt[key].grad, gz_r[key]) <= PARITY
    assert _rel(k.grad, gk_r) <= PARITY


def test_grid_and_pair_match_reference_engine():
    """The solo engine's grid and terminal pair against the reference's
    jitted engine at 1e-5: the lattice exponent, the step and trial counts
    and the landings equal; the decoded terminal state within rtol 1e-5.
    The stepsizes agree to 3.3e-4 relative over the first 50 steps, not
    the RK engines' 2.6e-5: the reference's quanta are exp2-rounded and
    its field is fused (ROADMAP queue 3)."""
    z0, mu = torch.tensor(Z0_VDP), torch.tensor(MU)
    _, grid, st = mali_adaptive_solve(vdp, z0, torch.tensor(TS_VDP), (mu,),
                                      1e-5, 1e-5,
                                      ControllerConfig(max_steps=1024))
    _, grid_r, st_r = jax.jit(lambda z: jmali_solve(
        vdp_j, z, jnp.asarray(TS_VDP), (jnp.float32(MU),), 1e-5, 1e-5,
        ControllerConfig(max_steps=1024)))(jnp.asarray(Z0_VDP))
    assert grid.n == int(grid_r.n)
    assert int(st.n_trials) == int(st_r.n_trials)
    assert float(grid.scale_exp) == float(grid_r.scale_exp)
    np.testing.assert_array_equal(grid.out_idx.numpy(),
                                  np.asarray(grid_r.out_idx))
    zT = lattice_decode(grid.zT, grid.scale_exp, z0).numpy()
    zT_r = np.asarray(jstep.lattice_decode(grid_r.zT, grid_r.scale_exp,
                                           jnp.asarray(Z0_VDP)))
    np.testing.assert_allclose(zT, zT_r, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# api surface
# ---------------------------------------------------------------------------

def test_api_solver_pairing():
    ts, z0 = torch.tensor([0.0, 1.0]), torch.tensor(1.0)
    k = (torch.tensor(-1.0),)
    with pytest.raises(ValueError, match="alf"):
        odeint(linear, z0, ts, k, grad_method="mali", solver="dopri5")
    with pytest.raises(ValueError, match="mali"):
        odeint(linear, z0, ts, k, grad_method="aca", solver="alf")
    # the default solver resolves per method: both run
    odeint(linear, z0, ts, k, grad_method="mali", rtol=1e-3, atol=1e-3)
    odeint(linear, z0, ts, k, grad_method="aca")


def test_api_rejects_checkpoint_segments():
    with pytest.raises(ValueError, match="checkpoint"):
        odeint(linear, torch.tensor(1.0), torch.tensor([0.0, 1.0]),
               (torch.tensor(-1.0),), grad_method="mali",
               checkpoint_segments=4)


def test_api_rejects_interpolate_ts():
    with pytest.raises(ValueError, match="interpolate_ts"):
        odeint(linear, torch.tensor(1.0), torch.tensor([0.0, 1.0]),
               (torch.tensor(-1.0),), grad_method="mali",
               interpolate_ts=True)


def test_node_block_mali():
    """NodeConfig(grad_method='mali') threads through the block; the fixed
    regime is rejected."""
    def block_fn(p, z, t):
        return torch.tanh(z @ p)

    rng = np.random.default_rng(0)
    p = torch.tensor(rng.standard_normal((8, 8)) * 0.3, dtype=torch.float32,
                     requires_grad=True)
    z0 = torch.tensor(rng.standard_normal((4, 8)), dtype=torch.float32)
    cfg = NodeConfig(enabled=True, solver="alf", grad_method="mali",
                     rtol=1e-3, atol=1e-3, max_steps=256)
    zT = node_block_apply(block_fn, p, z0, cfg)
    assert zT.shape == z0.shape and bool(torch.isfinite(zT).all())
    torch.sum(zT ** 2).backward()
    assert bool(torch.isfinite(p.grad).all())
    with pytest.raises(ValueError, match="fixed"):
        node_block_apply(block_fn, p, z0, NodeConfig(
            enabled=True, grad_method="mali", regime="fixed"))


def test_pallas_backward_dispatches_increment_kernel(monkeypatch):
    """use_pallas=True sends the backward's half-drifts through the K1
    wrapper (its plain version on the CPU), two a replayed step, with the
    row (0.5,); batched, through K3's."""
    from repro_torch.core import stepper
    calls = {"increment": [], "increment_batched": []}
    for name, key in (("rk_stage_increment", "increment"),
                      ("rk_stage_increment_batched", "increment_batched")):
        orig = getattr(stepper.ops, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key].append(tuple(a[3]))
            return _orig(*a, **k)

        monkeypatch.setattr(stepper.ops, name, counted)
    z0 = torch.ones(4, requires_grad=True)
    ys, st = odeint(linear, z0, torch.tensor([0.0, 1.0]),
                    (torch.tensor(-0.5),), grad_method="mali", rtol=1e-3,
                    atol=1e-3, max_steps=256, use_pallas=True)
    assert calls["increment"] == []          # the forward is integer math
    ys[-1].sum().backward()
    assert calls["increment"] == [(0.5,)] * (2 * int(st.n_steps))
    assert bool(torch.isfinite(z0.grad).all())
    zb = torch.ones(3, 4, requires_grad=True)
    ys, st = odeint(linear, zb, torch.tensor([0.0, 1.0]),
                    (torch.tensor(-0.5),), grad_method="mali", rtol=1e-3,
                    atol=1e-3, max_steps=256, use_pallas=True, batch_axis=0)
    ys[-1].sum().backward()
    assert calls["increment_batched"] == [(0.5,)] * (
        2 * int(st.n_steps.max()))


def test_stats_shape_batched():
    z0b = torch.tensor([[1.0, 0.0], [0.5, 0.2]])
    _, st = odeint(vdp, z0b, torch.tensor([0.0, 0.3]), (torch.tensor(MU),),
                   grad_method="mali", batch_axis=0, rtol=1e-4, atol=1e-4,
                   max_steps=1024)
    assert st.n_steps.shape == (2,)
    assert not bool(st.overflow.any())


# ---------------------------------------------------------------------------
# the memory benchmark
# ---------------------------------------------------------------------------

def test_mali_memory_bench_quick():
    """``repro_torch.benchmarks.mali_memory`` at its quick size: the
    reference's rows and gates (MALI flat within 1.05× from 32 to 256
    steps, ACA growing past it), and MALI's count is its grid's growth
    alone: 3 scalars a step of budget."""
    from repro_torch.benchmarks import mali_memory

    out = mali_memory.run(quick=True, device="cpu")
    assert set(out) == {f"mali_memory_bytes/{m}_{n}"
                        for m in ("mali", "aca") for n in (32, 256)}
    assert out["mali_memory_bytes/mali_256"] - \
        out["mali_memory_bytes/mali_32"] == 3 * 4 * (256 - 32)
    assert out["mali_memory_bytes/aca_256"] - \
        out["mali_memory_bytes/aca_32"] >= (256 - 32) * 4 * 128 * 4
