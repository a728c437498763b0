"""K1/K2 plain versions and autograd Functions against the reference.

The same numpy inputs go to the reference's dispatch layer
(``repro.kernels.ops``, Pallas in interpret mode, as ``tests/
test_kernels.py`` runs it) and to the port on the CPU, where each wrapper
runs its kernel's plain version. Mirrors ``test_kernels.py:43-115``.

Tolerances: f32 outputs rtol=atol=1e-6, the reference's own kernel-vs-
oracle bound (both sides accumulate in f32 in the same order; the bound
leaves room for XLA contracting a multiply-add); bf16 outputs 2e-2, the
reference's bf16 bound (a one-ulp rounding flip of a bf16 value is up to
2^-8 relative); the norm sum rtol=1e-5 (the interpret kernel sums tile
partials, the plain version one array: summation order); gradients
rtol=1e-5, atol=1e-6 as in the reference's differentiability test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tableaus import BOGACKI_SHAMPINE, DOPRI5, HEUN_EULER
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rk_stage

TABS = {"heun_euler": HEUN_EULER, "bosh3": BOGACKI_SHAMPINE,
        "dopri5": DOPRI5}
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-6),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True)
def _force_interpret():
    jops.set_interpret(True)
    yield
    jops.set_interpret(None)


def _inputs(seed, stages, n):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal(n).astype(np.float32)
    k = rng.standard_normal((stages, n)).astype(np.float32)
    return z, k


def _both(x, jdt, tdt):
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("tab", sorted(TABS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_increment_plain_matches_reference(tab, dtype):
    """K1 for every stage row a[1..s-1] and the b row."""
    tab = TABS[tab]
    jdt, tdt, tol = DTYPES[dtype]
    h = 0.05
    for n in (37, 1000, 5000):
        z, k = _inputs(n, tab.stages, n)
        zj, zt = _both(z, jdt, tdt)
        kj, kt = _both(k, jdt, tdt)
        rows = [(i, tab.a[i]) for i in range(1, tab.stages)]
        rows.append((tab.stages, tab.b))
        for i, a in rows:
            o_ref = jops.rk_stage_increment(zj, kj[:i], jnp.float32(h), a,
                                            block=512)
            o_port = rk_stage.rk_stage_increment(
                zt, kt[:i].contiguous(), torch.tensor(h), a)
            assert o_port.dtype == tdt and o_port.shape == (n,)
            np.testing.assert_allclose(_np(o_port), _np(o_ref), rtol=tol,
                                       atol=tol, err_msg=f"n={n} row={i}")


@pytest.mark.parametrize("tab", sorted(TABS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_combine_err_plain_matches_reference(tab, dtype):
    """K2 with ``with_err`` both ways: z_next, err and the norm sum."""
    tab = TABS[tab]
    jdt, tdt, tol = DTYPES[dtype]
    rtol, atol, h = 1e-3, 1e-4, 0.05
    for n in (37, 1000, 5000):
        z, k = _inputs(n + 1, tab.stages, n)
        zj, zt = _both(z, jdt, tdt)
        kj, kt = _both(k, jdt, tdt)
        zn_r, err_r, sq_r = jops.rk_stage_combine_err(
            zj, kj, jnp.float32(h), tab.b, tab.b_err, rtol, atol, block=512)
        zn_p, err_p, part = rk_stage.rk_stage_combine_err(
            zt, kt, torch.tensor(h), tab.b, tab.b_err, rtol, atol,
            with_err=True)
        np.testing.assert_allclose(_np(zn_p), _np(zn_r), rtol=tol, atol=tol)
        assert err_p.dtype == torch.float32
        np.testing.assert_allclose(_np(err_p), _np(err_r), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(float(part.sum()), float(sq_r),
                                   rtol=1e-5)
        # the solver loop's form: no err store, z_next and norm unchanged
        zn_q, err_q, part_q = rk_stage.rk_stage_combine_err(
            zt, kt, torch.tensor(h), tab.b, tab.b_err, rtol, atol,
            with_err=False)
        assert err_q is None
        assert torch.equal(zn_q, zn_p) and torch.equal(part_q, part)


def test_autograd_functions_match_jax_vjp_of_twins():
    """The port's Functions' backward = jax.vjp of the reference twins
    (mirrors test_rk_ops_differentiable)."""
    tab = DOPRI5
    n = 300
    z, k = _inputs(7, tab.stages, n)
    h = np.float32(0.07)
    rtol, atol = 1e-3, 1e-4

    def loss_ref(z, k, h):
        zn, err, sq = jref.rk_stage_combine_err_ref(z, k, h, tab.b,
                                                    tab.b_err, rtol, atol)
        return jnp.sum(zn ** 2) + jnp.sum(err ** 2) + sq

    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(
        jnp.asarray(z), jnp.asarray(k), jnp.float32(h))
    zt, kt, ht = (torch.tensor(v, requires_grad=True) for v in (z, k, h))
    zn, err, sq = tops.rk_stage_combine_err(zt, kt, ht, tab.b, tab.b_err,
                                            rtol, atol, with_err=True)
    (torch.sum(zn ** 2) + torch.sum(err ** 2) + sq).backward()
    for gp, gr in zip((zt.grad, kt.grad, ht.grad), g_ref):
        np.testing.assert_allclose(gp.numpy(), np.asarray(gr), rtol=1e-5,
                                   atol=1e-6)

    gi_ref = jax.grad(lambda z, k, h: jnp.sum(
        jref.rk_stage_increment_ref(z, k, h, tab.a[3]) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(z), jnp.asarray(k[:3]),
                           jnp.float32(h))
    zt, kt, ht = (torch.tensor(v, requires_grad=True)
                  for v in (z, k[:3], h))
    torch.sum(tops.rk_stage_increment(zt, kt, ht, tab.a[3]) ** 2).backward()
    for gp, gr in zip((zt.grad, kt.grad, ht.grad), gi_ref):
        np.testing.assert_allclose(gp.numpy(), np.asarray(gr), rtol=1e-5,
                                   atol=1e-6)


def test_combine_err_without_err_is_differentiable():
    """The loop's with_err=False form: gradient of sq through the Function
    equals autograd through the plain version."""
    tab = HEUN_EULER
    z, k = _inputs(3, tab.stages, 64)
    h = np.float32(0.1)
    grads = []
    for fused in (True, False):
        zt, kt, ht = (torch.tensor(v, requires_grad=True) for v in (z, k, h))
        if fused:
            zn, _, sq = tops.rk_stage_combine_err(
                zt, kt, ht, tab.b, tab.b_err, 1e-2, 1e-2, with_err=False)
        else:
            zn, _, sq = rk_stage.combine_err_plain(
                zt, kt, ht, tab.b, tab.b_err, 1e-2, 1e-2, False)
        (zn.sum() + sq.sum()).backward()
        grads.append((zt.grad, kt.grad, ht.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_wrappers_validate_inputs():
    z = torch.zeros(8)
    with pytest.raises(ValueError, match="k \\(s, N\\)"):
        rk_stage.rk_stage_increment(z, torch.zeros(2, 9), torch.tensor(0.1),
                                    (1.0,))
    with pytest.raises(ValueError, match="one dtype"):
        rk_stage.rk_stage_increment(z, torch.zeros(1, 8, dtype=torch.float64),
                                    torch.tensor(0.1), (1.0,))
    with pytest.raises(ValueError, match="at most 7 stages"):
        rk_stage.rk_stage_increment(z, torch.zeros(8, 8), torch.tensor(0.1),
                                    (1.0,) * 8)
    with pytest.raises(ValueError, match="b and"):
        rk_stage.rk_stage_combine_err(z, torch.zeros(2, 8), torch.tensor(0.1),
                                      (1.0,), (0.0,), 1e-3, 1e-3)


def test_cpu_tensors_take_the_plain_version_without_counting():
    rk_stage.reset_launches()
    z, k = torch.zeros(16), torch.ones(2, 16)
    out = rk_stage.rk_stage_increment(z, k, torch.tensor(0.5), (0.5, 0.5))
    assert torch.equal(out, torch.full((16,), 0.5))
    assert rk_stage.launches["rk_stage_increment"] == 0
    assert rk_stage.launches["rk_stage_combine_err"] == 0
    assert all(v == 0 for v in rk_stage.launches.values())
