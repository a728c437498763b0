"""The port's kernels and solve on an NVIDIA card (marker ``cuda``).

These skip without a card. On one, run them without the repository's
conftest, which imports JAX (a machine with the card need not have it)::

    PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest \\
        -m cuda tests/test_torch_cuda.py

K1 and K2 must give z_next bitwise equal to their plain versions (the
kernels round each product and sum like the plain PyTorch ops); K2's err
within rtol 1e-6 of the plain version's max |err| (same arithmetic) and
its norm within rtol 1e-5 (block partials vs one torch.sum over N terms).
The batched K3, K4 and K5 likewise give z_next bitwise, per-row norms
within rtol 1e-6 (rows of at most 100,003 terms), an h = 0 row bit for
bit, and K5 at K4's tolerance K4's bits. TF32 is off, so matmuls run in
full f32 on both sides.

The serving kernels against their plain versions, as max |difference| /
max |plain|: K7 RMSNorm f32 within 2e-6 (the sum of squares in another
order, rsqrtf) and bf16 within one bf16 ulp of each value; K8 attention
f32 within 2e-5 (FMA sums in another order) and bf16 within 1e-2 (the
kernel rounds p to bf16 for the tensor cores); K10 within 1e-5 (the
chunked walk and the doubling scan multiply in other orders). The SMOKE
hybrid model generates the same greedy tokens with ``use_pallas`` on the
card as without, its prefill logits within 1e-4, and the kernels launch
as counted (K7 11 per prefill and per decode step with 8 layers: 2 x 8 +
1 = 17, K8 once per attention layer per prefill, K10 once per rec layer
per prefill).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import odeint
from repro_torch.core.tableaus import BOGACKI_SHAMPINE, DOPRI5, HEUN_EULER
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rg_lru as lru
from repro_torch.kernels import rk_stage
from repro_torch.models.common import rmsnorm as rmsnorm_plain
from repro_torch.serve import NodeEngineConfig, NodeRequest, NodeServeEngine

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


def _batched_inputs(card, rows, n, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    z = torch.randn(rows, n, generator=g).to(dtype).to(card)
    k = torch.randn(7, rows, n, generator=g).to(dtype).to(card)
    h = torch.linspace(0.01, 0.08, rows).to(card)
    if rows > 1:
        h[1] = 0.0                  # a frozen row
    return z, k, h


@pytest.mark.parametrize("rows,n", [(1, 37), (3, 4096), (5, 100_003),
                                    (2, 4098)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_increment_batched_kernel_is_bitwise_its_plain_version(card, rows,
                                                               n, dtype):
    z, k, h = _batched_inputs(card, rows, n, dtype)
    before = rk_stage.launches["rk_stage_increment_batched"]
    for tab in TABS:
        row_list = [(i, tab.a[i]) for i in range(1, tab.stages)]
        row_list.append((tab.stages, tab.b))
        for i, a in row_list:
            kk = k[:i].contiguous()
            out = rk_stage.rk_stage_increment_batched(z, kk, h, a)
            assert torch.equal(out, rk_stage.increment_batched_plain(
                z, kk, h, a))
            if rows > 1:
                assert torch.equal(out[1], z[1])     # the h = 0 row
    assert rk_stage.launches["rk_stage_increment_batched"] > before


@pytest.mark.parametrize("rows,n", [(1, 37), (3, 4096), (5, 100_003),
                                    (2, 4098)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_err_batched_kernels_match_their_plain_version(card, rows,
                                                               n, dtype):
    z, k, h = _batched_inputs(card, rows, n, dtype, seed=1)
    rt = torch.logspace(-2, -5, rows).to(card)
    at = 0.1 * rt
    for tab in TABS:
        kk = k[:tab.stages].contiguous()
        args = (z, kk, h, tab.b, tab.b_err)
        zn4, p4 = rk_stage.rk_stage_combine_err_batched(*args, 1e-3, 1e-4)
        zp, sqp = rk_stage.combine_err_batched_plain(*args, 1e-3, 1e-4)
        assert torch.equal(zn4, zp)
        torch.testing.assert_close(p4.sum(-1), sqp, rtol=1e-6, atol=0.0)
        zn5, p5 = rk_stage.rk_stage_combine_err_batched_rowtol(
            *args, torch.full((rows,), 1e-3, device=card),
            torch.full((rows,), 1e-4, device=card))
        assert torch.equal(zn5, zn4) and torch.equal(p5, p4)
        zn5, p5 = rk_stage.rk_stage_combine_err_batched_rowtol(*args, rt, at)
        zp, sqp = rk_stage.combine_err_batched_plain(*args, rt, at)
        assert torch.equal(zn5, zp)
        torch.testing.assert_close(p5.sum(-1), sqp, rtol=1e-6, atol=0.0)
        if rows > 1:
            assert torch.equal(zn4[1], z[1]) and float(p4[1].sum()) == 0.0


def test_batched_solve_fused_matches_plain_on_the_card(card):
    rng = np.random.default_rng(0)
    w = torch.tensor((rng.standard_normal((64, 64)) * 0.2).astype(
        np.float32), device=card)
    z0 = torch.tensor(rng.standard_normal((4, 64)).astype(np.float32),
                      device=card)
    tols = torch.tensor([1e-2, 1e-3, 1e-4, 1e-3], device=card)
    out = []
    for up in (False, True):
        zz = z0.clone().requires_grad_()
        ys, st = odeint(lambda t, z, m: torch.tanh(m @ z), zz, [0.0, 1.0],
                        (w,), solver="dopri5", rtol=tols, atol=1e-4,
                        batch_axis=0, use_pallas=up)
        torch.sum(ys[-1] ** 2).backward()
        out.append((ys.detach(), st.n_steps.tolist(), zz.grad))
    (y0, s0, g0), (y1, s1, g1) = out
    assert s0 == s1 and len(set(s0)) > 1
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g1, g0, rtol=1e-4, atol=1e-6)


def test_node_serve_engine_on_the_card(card):
    """A small engine run through K3 and K5: every request OK, and one
    request alone gives its bits in the mix."""
    w = torch.tensor(1.3, device=card)

    def field(t, z, ww):
        return torch.tanh(ww * z) - 0.1 * z * torch.sin(t)

    rng = np.random.default_rng(3)
    reqs = [NodeRequest(z0=rng.standard_normal(64).astype(np.float32),
                        t1=float(t1), rtol=tol, atol=tol)
            for t1, tol in zip([0.5, 1.0, 1.5, 1.0, 0.5],
                               [1e-3, 1e-4, 1e-3, 1e-5, 1e-4])]
    eng = NodeServeEngine(field, 64, (w,),
                          NodeEngineConfig(slots=4, use_pallas=True),
                          device=card)
    rk_stage.reset_launches()
    for i, r in enumerate(reqs):
        eng.submit(r, arrival=0.5 * i)
    res = eng.run()
    assert all(r.ok for r in res)
    assert rk_stage.launches["rk_stage_increment_batched"] > 0
    assert rk_stage.launches["rk_stage_combine_err_batched_rowtol"] > 0
    eng.reset()
    eng.submit(reqs[1], arrival=0.5)
    alone = eng.run()[0]
    assert np.array_equal(alone.z_final, res[1].z_final)
    assert alone.n_trials == res[1].n_trials


# ------------------------------------------------ serving kernels K7/K8/K10

def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _bf16_ulps(a, b):
    a, b = a.float(), b.float()
    _, e = torch.frexp(b.abs())
    ulp = torch.ldexp(torch.ones_like(b), e - 8).clamp_min(2.0 ** -133)
    return float(((a - b).abs() / ulp).max())


@pytest.mark.parametrize("rows,d", [(4, 4096), (1000, 4096), (33, 64),
                                    (7, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_its_plain_version(card, rows, d, dtype,
                                                  wdtype):
    g = torch.Generator(device="cpu").manual_seed(rows + d)
    x = (3 * torch.randn(rows, d, generator=g)).to(dtype).to(card)
    w = torch.randn(d, generator=g).to(wdtype).to(card)
    before = ops.launch_counts()["rmsnorm"]
    out = ops.rmsnorm(x, w)
    want = rmsnorm_plain(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == before + 1
    assert out.dtype == dtype
    if dtype == torch.float32:
        assert _rel(out, want) <= 2e-6
    else:
        assert _bf16_ulps(out, want) <= 1.0


@pytest.mark.parametrize("b,h,hkv,s,dh", [(2, 4, 1, 128, 256),
                                          (1, 4, 2, 100, 64),
                                          (2, 2, 2, 37, 16),
                                          (1, 8, 1, 300, 128)])
@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_its_plain_version(card, b, h, hkv,
                                                          s, dh, window,
                                                          dtype):
    g = torch.Generator(device="cpu").manual_seed(s + dh)
    q = torch.randn(b, h, s, dh, generator=g).to(dtype).to(card)
    k = torch.randn(b, hkv, s, dh, generator=g).to(dtype).to(card)
    v = torch.randn(b, hkv, s, dh, generator=g).to(dtype).to(card)
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v, window=window)
    want = fa.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert _rel(out, want) <= (2e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("b,s,c", [(2, 1000, 64), (1, 4096, 256),
                                   (3, 7, 5)])
def test_rg_lru_kernel_matches_its_plain_version(card, b, s, c):
    g = torch.Generator(device="cpu").manual_seed(s + c)
    log_a = -torch.nn.functional.softplus(
        torch.randn(b, s, c, generator=g)).to(card)
    x = torch.randn(b, s, c, generator=g).to(card)
    before = ops.launch_counts()["rg_lru"]
    out = ops.rg_lru(log_a, x)
    want = lru.rg_lru_plain(log_a, x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rg_lru"] == before + 1
    assert _rel(out, want) <= 1e-5
    strong = ops.rg_lru(torch.full_like(log_a, -2.0), torch.ones_like(x))
    assert bool(torch.isfinite(strong).all())


def test_hybrid_smoke_generate_with_kernels_on_the_card(card):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = get_smoke_config("recurrentgemma_9b")     # 8 layers, window 16
    runs = {}
    for up in (True, False):
        model = build_model(cfg, RunConfig(compute_dtype=torch.float32,
                                           use_pallas=up, max_seq=64))
        params = model.init(device=card, seed=0)
        toks = torch.randint(0, cfg.vocab, (2, 40), device=card,
                             generator=torch.Generator(card).manual_seed(1))
        ops.reset_launches()
        with torch.no_grad():
            last, _ = model.prefill(params, {"tokens": toks})
        counts = ops.launch_counts()
        out = ServeEngine(model, params, ServeConfig(
            max_new_tokens=6)).generate(toks)["tokens"]
        runs[up] = (last, out, counts)
    (lk, ok, ck), (lp, op_, cp) = runs[True], runs[False]
    assert ck["rmsnorm"] == 17 and ck["flash_attention"] == 2 \
        and ck["rg_lru"] == 6
    assert all(v == 0 for v in cp.values())
    assert _rel(lk, lp) <= 1e-4
    assert torch.equal(ok, op_)
