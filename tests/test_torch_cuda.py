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
kernel rounds p to bf16 for the tensor cores), also for lengths and
windows that are no multiple of its tiles and every head dim; K7's one-
and two-pass kernels each at the decode rows and serving widths, at the
one-pass kernel's widest row and one vector beyond, and with an
unaligned weight, each launch counted under its kernel; K10 within 1e-5 (the
chunked walk and the doubling scan multiply in other orders). The SMOKE
hybrid model generates the same greedy tokens with ``use_pallas`` on the
card as without, its prefill logits within 1e-4, and the kernels launch
as counted (K7 11 per prefill and per decode step with 8 layers: 2 x 8 +
1 = 17, K8 once per attention layer per prefill, K10 once per rec layer
per prefill).

K6 (combine without the norm) gives z_next and err bitwise equal to its
plain version (K2's rounding, pinned with __fmul_rn/__fadd_rn). K9 (the
SSD chunk scan) against its plain version, as max |difference| / max
|plain|: f32 within 1e-4 (FMA sums and the chunk cumsum in other orders);
bf16 within one bf16 ulp of each plain value plus that f32 bound (y is
rounded once to bf16 on both sides, from f32 values that differ by the f32
bound); h_last within 1e-4 in both. K9's three bf16 kernels one at a time
against their plain parts on the same inputs: cs and S_c
(``chunk_states``), h_prev and h_last (``state_pass``) within 1e-4 (the
f32 operands enter the tensor cores as hi + lo bf16 pairs, about 16 bits;
the pass rounds as the plain version does), y (``chunk_outputs``) within
one bf16 ulp plus 1e-4. The SMOKE Mamba-2 model generates the
same greedy tokens with ``use_pallas`` as without, its prefill logits
within 1e-4, K9 once per layer per prefill and K7 2 per layer + 1 per
prefill and per decode step.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import odeint
from repro_torch.core.tableaus import BOGACKI_SHAMPINE, DOPRI5, HEUN_EULER
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rg_lru as lru
from repro_torch.kernels import rk_stage
from repro_torch.kernels import rmsnorm as k7
from repro_torch.kernels import ssd_scan as k9
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


@pytest.mark.parametrize("rows", [1, 2, 3, 4, 5, 6, 7, 8, 4096])
@pytest.mark.parametrize("d", [2560, 4096, 5120])
@pytest.mark.parametrize("kernel", ["one_pass", "two_pass"])
def test_rmsnorm_kernels_at_the_serving_widths(card, rows, d, kernel):
    # the decode rows (1-8) and prefill-like rows at the Mamba-2 and
    # RecurrentGemma widths, bf16, through each of K7's two kernels
    g = torch.Generator(device="cpu").manual_seed(rows * d)
    x = (3 * torch.randn(rows, d, generator=g)).to(torch.bfloat16).to(card)
    w = torch.randn(d, generator=g).to(torch.bfloat16).to(card)
    before = ops.launch_counts()["rmsnorm"]
    ran = k7.variant_launches[kernel]
    out = k7.rmsnorm(x, w, kernel=kernel)
    want = rmsnorm_plain(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rmsnorm"] == before + 1
    assert k7.variant_launches[kernel] == ran + 1
    assert _bf16_ulps(out, want) <= 1.0
    if kernel == "one_pass":  # the wrapper's own choice at these widths
        ran = k7.variant_launches["one_pass"]
        ops.rmsnorm(x, w)
        assert k7.variant_launches["one_pass"] == ran + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extra,chosen", [(0, "one_pass"), (1, "two_pass")])
def test_rmsnorm_at_the_one_pass_limit(card, dtype, extra, chosen):
    # the widest row the one-pass kernel holds, and one vector beyond it
    size = torch.empty((), dtype=dtype).element_size()
    d = k7.one_pass_max_d(size) + extra * (16 // size)
    g = torch.Generator(device="cpu").manual_seed(d)
    x = (3 * torch.randn(3, d, generator=g)).to(dtype).to(card)
    w = torch.randn(d, generator=g).to(dtype).to(card)
    ran = k7.variant_launches[chosen]
    out = ops.rmsnorm(x, w)
    want = rmsnorm_plain(x, w)
    torch.cuda.synchronize()
    assert k7.variant_launches[chosen] == ran + 1
    if dtype == torch.float32:
        assert _rel(out, want) <= 2e-6
    else:
        assert _bf16_ulps(out, want) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_with_a_misaligned_weight(card, dtype):
    # w one element into its buffer: not 16-byte aligned, so the two-pass
    # kernel takes it; the one-pass kernel refuses it
    g = torch.Generator(device="cpu").manual_seed(7)
    x = (3 * torch.randn(4, 4096, generator=g)).to(dtype).to(card)
    w = torch.randn(4097, generator=g).to(dtype).to(card)[1:]
    assert w.data_ptr() % 16 != 0
    ran = k7.variant_launches["two_pass"]
    out = ops.rmsnorm(x, w)
    want = rmsnorm_plain(x, w)
    torch.cuda.synchronize()
    assert k7.variant_launches["two_pass"] == ran + 1
    if dtype == torch.float32:
        assert _rel(out, want) <= 2e-6
    else:
        assert _bf16_ulps(out, want) <= 1.0
    with pytest.raises(ValueError, match="one-pass"):
        k7.rmsnorm(x, w, kernel="one_pass")


@pytest.mark.parametrize("s", [1, 63, 65, 200, 777])
@pytest.mark.parametrize("window", [0, 1, 7, 63, 100, 1000])
@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
def test_flash_attention_bf16_tile_classes(card, s, window, dh):
    # lengths and windows that are no multiple of the 64-key tile, windows
    # shorter than one tile and longer than S, every head dim, GQA with 2
    # kv heads: interior, diagonal, window-edge and past-S tiles
    g = torch.Generator(device="cpu").manual_seed(s * 7 + window + dh)
    q = torch.randn(2, 4, s, dh, generator=g).to(torch.bfloat16).to(card)
    k = torch.randn(2, 2, s, dh, generator=g).to(torch.bfloat16).to(card)
    v = torch.randn(2, 2, s, dh, generator=g).to(torch.bfloat16).to(card)
    before = ops.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v, window=window)
    want = fa.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert bool(torch.isfinite(out).all())
    assert _rel(out, want) <= 1e-2


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


# ------------------------------------------------------------ K6 and K9


@pytest.mark.parametrize("n", [1, 37, 4096, 100_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_kernel_is_bitwise_its_plain_version(card, n, dtype):
    z, k, h = _inputs(card, n, dtype, seed=3)
    before = rk_stage.launches["rk_stage_combine"]
    for tab in TABS:
        kk = k[:tab.stages].contiguous()
        for e in (tab.b_err, None):
            zn, err = rk_stage.rk_stage_combine(z, kk, h, tab.b, e)
            zp, ep = rk_stage.combine_plain(z, kk, h, tab.b, e)
            assert torch.equal(zn, zp) and torch.equal(err, ep)
    assert rk_stage.launches["rk_stage_combine"] == before + 2 * len(TABS)


def _ssd_inputs(card, b, s, h, p, g, n, dtype, seed, h0=False, weak=False):
    """The reference init's dt = softplus(N(0, 1)), a = -U[1, 16], under
    which a chunk forgets its state; or, with ``weak``, dt log-uniform in
    [1e-3, 1e-2] and a = -exp(N(0, 1)), under which the state carried
    between chunks dominates."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = (0.5 * torch.randn(b, s, h, p, generator=gen)).to(dtype).to(card)
    if weak:
        lo, hi = math.log(1e-3), math.log(1e-2)
        dt = torch.exp(lo + (hi - lo) * torch.rand(b, s, h, generator=gen))
        a = -torch.exp(torch.randn(h, generator=gen))
    else:
        dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen))
        a = -(1.0 + 15.0 * torch.rand(h, generator=gen))
    bm = (0.5 * torch.randn(b, s, g, n, generator=gen)).to(dtype).to(card)
    cm = (0.5 * torch.randn(b, s, g, n, generator=gen)).to(dtype).to(card)
    h0t = torch.randn(b, h, p, n, generator=gen).to(card) if h0 else None
    return x, dt.to(card), a.to(card), bm, cm, h0t


def _ssd_err(y, yp):
    """max |y - yp| beyond one bf16 ulp of yp (bf16) or at all (f32), over
    max |yp|."""
    d = (y.float() - yp.float()).abs()
    if y.dtype == torch.bfloat16:
        _, e = torch.frexp(yp.float().abs())
        d = (d - torch.ldexp(torch.ones_like(d), e - 8)).clamp_min(0.0)
    return float(d.max() / yp.float().abs().max())


SSD_SHAPES = [(2, 64, 4, 16, 1, 16, 16), (2, 128, 4, 16, 2, 16, 32),
              (1, 512, 8, 64, 2, 128, 256), (2, 256, 6, 64, 2, 128, 64)]


@pytest.mark.parametrize("b,s,h,p,g,n,q", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("weak", [False, True])
def test_ssd_scan_kernel_matches_its_plain_version(card, b, s, h, p, g, n, q,
                                                   dtype, h0, weak):
    x, dt, a, bm, cm, h0t = _ssd_inputs(card, b, s, h, p, g, n, dtype,
                                        seed=s + n, h0=h0, weak=weak)
    before = ops.launch_counts()["ssd_scan"]
    y, hl = ops.ssd_scan(x, dt, a, bm, cm, q, h0=h0t)
    yp, hp = k9.ssd_scan_plain(x, dt, a, bm, cm, q, h0=h0t)
    if weak:
        # the inputs do what they are for: each chunk scanned from a zero
        # state (no carry) is far from the chunked scan
        alone = torch.cat([k9.ssd_chunked(
            *(t[:, c * q:(c + 1) * q] for t in (x, dt)), a,
            *(t[:, c * q:(c + 1) * q] for t in (bm, cm)), q)[0]
            for c in range(s // q)], dim=1)
        assert _rel(alone, yp) > 0.5
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    assert y.dtype == dtype and hl.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())
    assert _ssd_err(y, yp) <= 1e-4
    assert _rel(hl, hp) <= 1e-4


@pytest.mark.parametrize("b,s,h,p,g,n,q", SSD_SHAPES)
@pytest.mark.parametrize("weak", [False, True])
def test_ssd_chunk_state_kernel_matches_its_plain_part(card, b, s, h, p, g, n,
                                                       q, weak):
    """Kernel 1 (bf16 only) against ``chunk_states``: cs and S_c."""
    x, dt, a, bm, _, _ = _ssd_inputs(card, b, s, h, p, g, n, torch.bfloat16,
                                     seed=s + n, weak=weak)
    before = ops.launch_counts()["ssd_chunk_state"]
    cs, states = k9.ssd_chunk_state(x, dt, a, bm, q)
    cs_p, states_p = k9.chunk_states(x, dt, a, bm, q)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_chunk_state"] == before + 1
    assert cs.shape == cs_p.shape and states.shape == states_p.shape
    assert _rel(cs, cs_p) <= 1e-4 and _rel(states, states_p) <= 1e-4
    with pytest.raises(ValueError, match="bfloat16"):
        k9.ssd_chunk_state(x.float(), dt, a, bm.float(), q)


@pytest.mark.parametrize("b,s,h,p,g,n,q", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("weak", [False, True])
def test_ssd_state_pass_kernel_matches_its_plain_part(card, b, s, h, p, g, n,
                                                      q, dtype, h0, weak):
    """Kernel 2 against ``state_pass`` on the same chunk states (from
    inputs in either dtype): h_prev (written over the states) and h_last."""
    x, dt, a, bm, _, h0t = _ssd_inputs(card, b, s, h, p, g, n, dtype,
                                       seed=s + n, h0=h0, weak=weak)
    cs, states = k9.chunk_states(x, dt, a, bm, q)
    h_prev_p, h_last_p = k9.state_pass(states, cs, q, h0=h0t)
    before = ops.launch_counts()["ssd_state_pass"]
    work = states.clone()
    h_prev, h_last = k9.ssd_state_pass(work, cs, q, h0=h0t)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_state_pass"] == before + 1
    assert h_prev.data_ptr() == work.data_ptr()      # in place
    assert _rel(h_prev, h_prev_p) <= 1e-4 and _rel(h_last, h_last_p) <= 1e-4


@pytest.mark.parametrize("b,s,h,p,g,n,q", SSD_SHAPES)
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("weak", [False, True])
def test_ssd_chunk_scan_kernel_matches_its_plain_part(card, b, s, h, p, g, n,
                                                      q, h0, weak):
    """Kernel 3 (bf16 only) against ``chunk_outputs`` on the same cs and
    h_prev: y within one bf16 ulp of each plain value plus 1e-4."""
    x, dt, a, bm, cm, h0t = _ssd_inputs(card, b, s, h, p, g, n,
                                        torch.bfloat16, seed=s + n, h0=h0,
                                        weak=weak)
    cs, states = k9.chunk_states(x, dt, a, bm, q)
    h_prev, _ = k9.state_pass(states, cs, q, h0=h0t)
    before = ops.launch_counts()["ssd_chunk_scan"]
    y = k9.ssd_chunk_scan(x, dt, cs, bm, cm, h_prev, q)
    yp = k9.chunk_outputs(x, dt, cs, bm, cm, h_prev, q).to(x.dtype)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_chunk_scan"] == before + 1
    assert y.dtype == torch.bfloat16 and bool(torch.isfinite(y.float()).all())
    assert _ssd_err(y, yp) <= 1e-4


def test_ssd_scan_kernel_refuses_what_it_does_not_take(card):
    x, dt, a, bm, cm, _ = _ssd_inputs(card, 1, 48, 2, 16, 1, 16,
                                      torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="does not take"):
        ops.ssd_scan(x, dt, a, bm, cm, 24)           # chunk not a multiple
    x, dt, a, bm, cm, _ = _ssd_inputs(card, 1, 32, 2, 16, 1, 256,
                                      torch.bfloat16, seed=1)
    with pytest.raises(ValueError, match="does not take"):
        ops.ssd_scan(x, dt, a, bm, cm, 16)           # bf16 state 256


def test_mamba2_smoke_generate_with_kernels_on_the_card(card):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = get_smoke_config("mamba2_2_7b")     # 3 layers, chunk 16
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
    assert ck["rmsnorm"] == 7 and ck["ssd_scan"] == 3
    assert all(v == 0 for v in cp.values())
    assert _rel(lk, lp) <= 1e-4
    assert torch.equal(ok, op_)
