"""The port's kernels and solve on an NVIDIA card (marker ``cuda``).

These skip without a card. On one, run them without the repository's
conftest, which imports JAX (a machine with the card need not have it)::

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest \\
        -m cuda tests/test_torch_cuda.py

K1 and K2 must give z_next bitwise equal to their plain versions (the
kernels round each product and sum like the plain PyTorch ops); K2's err
within rtol 1e-6 of the plain version's max |err| (same arithmetic) and
its norm within rtol 1e-5 (block partials vs one torch.sum over N terms).
TF32 is off, so matmuls run in full f32 on both sides.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import odeint
from repro_torch.core.tableaus import BOGACKI_SHAMPINE, DOPRI5, HEUN_EULER
from repro_torch.kernels import rk_stage

pytestmark = pytest.mark.cuda

TABS = [HEUN_EULER, BOGACKI_SHAMPINE, DOPRI5]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU "
                    "mode, and torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, n, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    z = torch.randn(n, generator=g).to(dtype).to(card)
    k = torch.randn(7, n, generator=g).to(dtype).to(card)
    return z, k, torch.full((), 0.05, device=card)


@pytest.mark.parametrize("n", [1, 37, 4096, 100_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_increment_kernel_is_bitwise_its_plain_version(card, n, dtype):
    z, k, h = _inputs(card, n, dtype)
    before = rk_stage.launches["rk_stage_increment"]
    for tab in TABS:
        rows = [(i, tab.a[i]) for i in range(1, tab.stages)]
        rows.append((tab.stages, tab.b))
        for i, a in rows:
            kk = k[:i].contiguous()
            out = rk_stage.rk_stage_increment(z, kk, h, a)
            assert torch.equal(out, rk_stage.increment_plain(z, kk, h, a))
    assert rk_stage.launches["rk_stage_increment"] > before


@pytest.mark.parametrize("n", [1, 37, 4096, 100_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_err_kernel_matches_its_plain_version(card, n, dtype):
    z, k, h = _inputs(card, n, dtype, seed=1)
    for tab in TABS:
        kk = k[:tab.stages].contiguous()
        for with_err in (True, False):
            zn, err, part = rk_stage.rk_stage_combine_err(
                z, kk, h, tab.b, tab.b_err, 1e-3, 1e-4, with_err=with_err)
            zn_p, err_p, sq_p = rk_stage.combine_err_plain(
                z, kk, h, tab.b, tab.b_err, 1e-3, 1e-4, with_err)
            assert torch.equal(zn, zn_p)
            if with_err:
                assert err.dtype == torch.float32
                scale = float(err_p.abs().max())
                assert float((err - err_p).abs().max()) <= 1e-6 * scale
            else:
                assert err is None
            np.testing.assert_allclose(float(part.sum()), float(sq_p.sum()),
                                       rtol=1e-5)


def test_wrapper_refuses_non_contiguous_card_tensors(card):
    z, k, h = _inputs(card, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        rk_stage.rk_stage_increment(z[:32], k[:2, ::2], h, (0.5, 0.5))


@pytest.mark.parametrize("solver", ["heun_euler", "bosh3", "dopri5"])
def test_solve_fused_matches_plain_on_the_card(card, solver):
    rng = np.random.default_rng(0)
    w = torch.tensor((rng.standard_normal((64, 64)) * 0.2).astype(
        np.float32), device=card)
    z0 = torch.tensor(rng.standard_normal(64).astype(np.float32),
                      device=card)
    out = []
    for up in (False, True):
        zz = z0.clone().requires_grad_()
        ww = w.clone().requires_grad_()
        ys, st = odeint(lambda t, z, m: torch.tanh(m @ z), zz, [0.0, 1.0],
                        (ww,), solver=solver, rtol=1e-3, atol=1e-3,
                        use_pallas=up)
        torch.sum(ys[-1] ** 2).backward()
        out.append((ys.detach(), int(st.n_steps), zz.grad, ww.grad))
    (y0, s0, gz0, gw0), (y1, s1, gz1, gw1) = out
    assert s0 == s1
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gz1, gz0, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gw1, gw0, rtol=1e-4, atol=1e-6)


def test_toy_gradient_on_the_card(card):
    z0 = torch.tensor(1.5, device=card, requires_grad=True)
    ys, st = odeint(lambda t, z, c: c * z, z0, [0.0, 1.0],
                    (torch.tensor(2.0, device=card),), solver="dopri5",
                    rtol=1e-6, atol=1e-6, use_pallas=True)
    (ys[-1] ** 2).sum().backward()
    analytic = 2 * 1.5 * np.exp(4.0)
    assert abs(float(z0.grad) - analytic) / analytic < 1e-4
    assert ys.device.type == "cuda"
