"""K3/K4/K5 plain versions and autograd Functions against the reference.

The same numpy inputs go to the reference's batched jnp twins
(``increment_batched_jnp``, ``combine_err_batched_jnp``), to its Pallas
kernels in interpret mode, and to the port on the CPU, where each wrapper
runs its kernel's plain version.

Tolerances: z_next is bitwise the jnp twin's, in f32 and bf16 (same f32
products and sums in the same order). Against the Pallas kernels in
interpret mode z_next is held to 1e-6, the reference's kernel-vs-oracle
bound: XLA contracts the interpret kernel's ``z + h*acc`` into a
multiply-add, a one-ulp difference on some elements. The per-row norm is
held to 1e-6 relative (summation order); in bf16 only against the Pallas
kernel, whose scale reads the unrounded f32 z_next as the port's does
(the jnp twin reads the bf16-rounded one). Gradients of the Functions
against ``jax.vjp`` of the twins to max |difference| <= 1e-6 x max
|value| per gradient: the norm's gradient divides by the scale, so an
element-wise relative bound would be set by the smallest entries'
rounding, not by the arithmetic. Inside the port,
bitwise: an h = 0 row passes through, and K5's form at equal tolerance
is K4's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tableaus import DOPRI5, HEUN_EULER
from repro.kernels import rk_stage as jrk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rk_stage

TABS = {"heun_euler": HEUN_EULER, "dopri5": DOPRI5}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
RTOL, ATOL = 1e-3, 1e-4


def _inputs(seed, stages, rows, n):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((rows, n)).astype(np.float32)
    k = rng.standard_normal((stages, rows, n)).astype(np.float32)
    h = rng.uniform(0.01, 0.2, rows).astype(np.float32)
    return z, k, h


def _both(x, jdt, tdt):
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


CASES = [(tab, dt, rows, n) for tab in sorted(TABS) for dt in sorted(DTYPES)
         for rows in (1, 3) for n in (1000, 1003)]


@pytest.mark.parametrize("tab,dtype,rows,n", CASES)
def test_increment_batched_plain_matches_reference(tab, dtype, rows, n):
    """K3 for every stage row a[1..s-1] and the b row."""
    tab = TABS[tab]
    jdt, tdt = DTYPES[dtype]
    z, k, h = _inputs(rows * n, tab.stages, rows, n)
    zj, zt = _both(z, jdt, tdt)
    kj, kt = _both(k, jdt, tdt)
    ht = torch.from_numpy(h)
    row_list = [(i, tab.a[i]) for i in range(1, tab.stages)]
    row_list.append((tab.stages, tab.b))
    for i, a in row_list:
        o_port = rk_stage.rk_stage_increment_batched(
            zt, kt[:i].contiguous(), ht, a)
        assert o_port.dtype == tdt and tuple(o_port.shape) == (rows, n)
        o_twin = jrk.increment_batched_jnp(zj, kj[:i], jnp.asarray(h), a)
        np.testing.assert_array_equal(_np(o_port), _np(o_twin),
                                      err_msg=f"row {i}")
        if dtype == "f32":
            o_pal = jrk.rk_stage_increment_batched_pallas(
                zj, kj[:i], jnp.asarray(h), a, block=512, interpret=True)
            np.testing.assert_allclose(_np(o_port), _np(o_pal), rtol=1e-6,
                                       atol=1e-6, err_msg=f"row {i}")


@pytest.mark.parametrize("tab,dtype,rows,n", CASES)
def test_combine_err_batched_plain_matches_reference(tab, dtype, rows, n):
    """K4 (scalar tolerances) and K5 ((B,) tolerances): z_next and the
    per-row norm."""
    tab = TABS[tab]
    jdt, tdt = DTYPES[dtype]
    z, k, h = _inputs(rows * n + 1, tab.stages, rows, n)
    zj, zt = _both(z, jdt, tdt)
    kj, kt = _both(k, jdt, tdt)
    hj, ht = jnp.asarray(h), torch.from_numpy(h)
    rt = np.geomspace(1e-2, 1e-4, rows).astype(np.float32)
    at = (rt * 1e-2).astype(np.float32)
    forms = [
        ("k4", (RTOL, ATOL), (RTOL, ATOL),
         rk_stage.rk_stage_combine_err_batched,
         jrk.rk_stage_combine_err_batched_pallas),
        ("k5", (torch.from_numpy(rt), torch.from_numpy(at)),
         (jnp.asarray(rt), jnp.asarray(at)),
         rk_stage.rk_stage_combine_err_batched_rowtol,
         jrk.rk_stage_combine_err_batched_rowtol_pallas),
    ]
    for name, tols_t, tols_j, port_fn, pallas_fn in forms:
        zn, part = port_fn(zt, kt, ht, tab.b, tab.b_err, *tols_t)
        assert zn.dtype == tdt and part.dtype == torch.float32
        sq = part.sum(-1).numpy()
        zn_twin, sq_twin = jrk.combine_err_batched_jnp(
            zj, kj, hj, tab.b, tab.b_err, *tols_j)
        np.testing.assert_array_equal(_np(zn), _np(zn_twin), err_msg=name)
        zn_pal, part_pal = pallas_fn(zj, kj, hj, tab.b, tab.b_err, *tols_j,
                                     block=512, interpret=True)
        np.testing.assert_allclose(_np(zn), _np(zn_pal), rtol=1e-6,
                                   atol=1e-6 if dtype == "f32" else 2e-2,
                                   err_msg=name)
        assert _rel(sq, np.asarray(part_pal).sum(-1)) <= 1e-6, name
        if dtype == "f32":
            assert _rel(sq, np.asarray(sq_twin)) <= 1e-6, name


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_zero_stepsize_row_passes_through(dtype):
    """A row with h = 0 comes out of K3 and K4/K5 bit for bit as it went
    in, with a zero norm: how the batched loop freezes finished rows."""
    _, tdt = DTYPES[dtype]
    z, k, h = _inputs(5, DOPRI5.stages, 3, 1003)
    h[1] = 0.0
    zt, kt, ht = (torch.from_numpy(x) for x in (z, k, h))
    zt, kt = zt.to(tdt), kt.to(tdt)
    for i in range(1, DOPRI5.stages):
        out = rk_stage.rk_stage_increment_batched(
            zt, kt[:i].contiguous(), ht, DOPRI5.a[i])
        assert torch.equal(out[1], zt[1])
    zn, part = rk_stage.rk_stage_combine_err_batched(
        zt, kt, ht, DOPRI5.b, DOPRI5.b_err, RTOL, ATOL)
    assert torch.equal(zn[1], zt[1]) and float(part[1].sum()) == 0.0
    assert not torch.equal(zn[0], zt[0])


def test_rowtol_at_equal_tolerance_is_k4_bitwise():
    """K5 with every row at K4's tolerance gives K4's z_next and norms bit
    for bit; a row's result does not depend on its neighbours'
    tolerances."""
    z, k, h = _inputs(6, DOPRI5.stages, 4, 1003)
    zt, kt, ht = (torch.from_numpy(x) for x in (z, k, h))
    zn4, p4 = rk_stage.rk_stage_combine_err_batched(
        zt, kt, ht, DOPRI5.b, DOPRI5.b_err, RTOL, ATOL)
    zn5, p5 = rk_stage.rk_stage_combine_err_batched_rowtol(
        zt, kt, ht, DOPRI5.b, DOPRI5.b_err, torch.full((4,), RTOL),
        torch.full((4,), ATOL))
    assert torch.equal(zn4, zn5) and torch.equal(p4, p5)
    _, pm = rk_stage.rk_stage_combine_err_batched_rowtol(
        zt, kt, ht, DOPRI5.b, DOPRI5.b_err,
        torch.tensor([RTOL, 1e-6, 1e-1, RTOL]),
        torch.tensor([ATOL, 1e-7, 1e-2, ATOL]))
    assert torch.equal(pm[0], p4[0]) and torch.equal(pm[3], p4[3])
    assert not torch.equal(pm[1], p4[1])


def test_dispatch_picks_k4_for_floats_and_k5_for_rows():
    """The differentiable dispatch: float tolerances take K4's form, a
    tensor tolerance K5's, with the same bits at equal tolerance."""
    z, k, h = _inputs(7, HEUN_EULER.stages, 2, 64)
    zt, kt, ht = (torch.from_numpy(x) for x in (z, k, h))
    zn_s, sq_s = tops.rk_stage_combine_err_batched(
        zt, kt, ht, HEUN_EULER.b, HEUN_EULER.b_err, RTOL, ATOL)
    zn_r, sq_r = tops.rk_stage_combine_err_batched(
        zt, kt, ht, HEUN_EULER.b, HEUN_EULER.b_err,
        torch.tensor(RTOL), torch.full((2,), ATOL))
    assert sq_s.shape == (2,)
    assert torch.equal(zn_s, zn_r) and torch.equal(sq_s, sq_r)


def test_autograd_functions_match_jax_vjp_of_twins():
    """The Functions' backward = jax.vjp of the reference's batched jnp
    twins (the reference's custom_vjp backward), K3, K4 and K5."""
    tab = DOPRI5
    z, k, h = _inputs(8, tab.stages, 3, 200)
    rt = np.asarray([1e-2, 1e-3, 1e-4], np.float32)
    at = np.asarray([1e-3, 1e-4, 1e-5], np.float32)

    def loss_j(z, k, h, rtol, atol):
        zn, sq = jrk.combine_err_batched_jnp(z, k, h, tab.b, tab.b_err, rtol,
                                             atol)
        zi = jrk.increment_batched_jnp(z, k[:4], h, tab.a[4])
        return jnp.sum(zn ** 2) + jnp.sum(sq * jnp.arange(1.0, 4.0)) \
            + jnp.sum(jnp.sin(zi))

    def loss_t(z, k, h, rtol, atol):
        zn, sq = tops.rk_stage_combine_err_batched(z, k, h, tab.b, tab.b_err,
                                                   rtol, atol)
        zi = tops.rk_stage_increment_batched(z, k[:4].contiguous(), h,
                                             tab.a[4])
        return torch.sum(zn ** 2) + torch.sum(sq * torch.arange(1.0, 4.0)) \
            + torch.sum(torch.sin(zi))

    for tols_j, tols_t in [((RTOL, ATOL), (RTOL, ATOL)),
                           ((jnp.asarray(rt), jnp.asarray(at)),
                            (torch.from_numpy(rt), torch.from_numpy(at)))]:
        g_ref = jax.grad(loss_j, argnums=(0, 1, 2))(
            jnp.asarray(z), jnp.asarray(k), jnp.asarray(h), *tols_j)
        zt, kt, ht = (torch.tensor(v, requires_grad=True) for v in (z, k, h))
        loss_t(zt, kt, ht, *tols_t).backward()
        for name, gp, gr in zip("zkh", (zt.grad, kt.grad, ht.grad), g_ref):
            gr = np.asarray(gr)
            assert np.abs(gp.numpy() - gr).max() <= 1e-6 * np.abs(gr).max(), \
                name


def test_tolerances_take_no_gradient():
    z, k, h = _inputs(9, HEUN_EULER.stages, 2, 16)
    rt = torch.full((2,), 1e-3, requires_grad=True)
    zt = torch.tensor(z, requires_grad=True)
    _, sq = tops.rk_stage_combine_err_batched(
        zt, torch.from_numpy(k), torch.from_numpy(h), HEUN_EULER.b,
        HEUN_EULER.b_err, rt, 1e-4)
    sq.sum().backward()
    assert rt.grad is None and zt.grad is not None


def test_batched_wrappers_validate_inputs():
    z = torch.zeros(2, 8)
    h = torch.full((2,), 0.1)
    with pytest.raises(ValueError, match="k \\(s, B, N\\)"):
        rk_stage.rk_stage_increment_batched(z, torch.zeros(1, 3, 8), h,
                                            (1.0,))
    with pytest.raises(ValueError, match="one stepsize per row"):
        rk_stage.rk_stage_increment_batched(z, torch.zeros(1, 2, 8),
                                            torch.tensor(0.1), (1.0,))
    with pytest.raises(ValueError, match="one dtype"):
        rk_stage.rk_stage_increment_batched(
            z, torch.zeros(1, 2, 8, dtype=torch.float64), h, (1.0,))
    with pytest.raises(ValueError, match="b and"):
        rk_stage.rk_stage_combine_err_batched(
            z, torch.zeros(2, 2, 8), h, (1.0,), (0.0,), 1e-3, 1e-3)
    with pytest.raises(ValueError, match="rtol must be a \\(2,\\) tensor"):
        rk_stage.rk_stage_combine_err_batched_rowtol(
            z, torch.zeros(2, 2, 8), h, (0.5, 0.5), (1.0, -1.0),
            torch.full((3,), 1e-3), torch.full((2,), 1e-3))


def test_cpu_tensors_take_the_plain_version_without_counting():
    rk_stage.reset_launches()
    z, k, h = torch.zeros(2, 16), torch.ones(2, 2, 16), torch.tensor([0.5,
                                                                      0.0])
    out = rk_stage.rk_stage_increment_batched(z, k, h, (0.5, 0.5))
    assert torch.equal(out[0], torch.full((16,), 0.5))
    assert torch.equal(out[1], torch.zeros(16))
    rk_stage.rk_stage_combine_err_batched_rowtol(
        z, k, h, (0.5, 0.5), (1.0, -1.0), torch.full((2,), 1e-3),
        torch.full((2,), 1e-3))
    assert all(v == 0 for v in rk_stage.launches.values())
    assert set(rk_stage.launches) >= {
        "rk_stage_increment_batched", "rk_stage_combine_err_batched",
        "rk_stage_combine_err_batched_rowtol"}
