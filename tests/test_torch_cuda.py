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
bit, and K5 at K4's tolerance K4's bits; K3 also on rows that start at
every offset modulo 16 bytes (its vector path peels a scalar head per
row), on views one element into larger buffers, and where (rows * N) % V
!= 0 sends it down the scalar path. K4's and K5's partials are bitwise
the plain tile partials (``combine_err_batched_tile_partials``: one per
2048 elements of a row, summed in the kernels' order), and a row's
partials and z_next are the same bits at B = 1, 3 and 8 and on views 0-3
elements into larger buffers, at the serving row (8, 393,218) and the
batched block's (8, 393,216), f32 and bf16; the serving engine gives a
request alone its bits in a mix on a ragged row too (odd dim), and its
aca, adjoint and naive methods serve one trace on K3/K5 with z_final,
trials and sim clock bitwise equal. TF32 is
off, so matmuls run in full f32 on both sides. The adjoint and naive
methods (toy, batch_axis=0 and fixed-grid solves, ACA's too where
batched or fixed) through K1-K4 on the card against the same solves on
CPU tensors: steps equal; the toy's gradient within 1e-5, the fixed
grid's outputs within rtol 1e-5 and gradients within 1e-4, the batched
adaptive solve's outputs within 10 x its tolerance and gradients within
1e-4 of their scale (its grids drift with the fields' rounding; the
test says why), and the batched solve against its plain path on the
card as the ACA test above. Per-row (B, T) eval times through K3/K4
against the plain path on the card: steps equal, ys within rtol 1e-5,
gradients within 1e-4 of their scale (the naive method differentiates
the stepsize chain through K4's reordered norm); Table 1's
``aca_pallas`` (K1/K2) against ``aca`` on the card: z(1) bitwise,
gradients within 1e-5. K1 and K3 with Dopri5's b_mid row (the dense
midpoint) bitwise their plain versions, and a small segmented ACA solve
(solo and batched, with and without ``interpolate_ts``) on the kernels
bitwise its full buffer.

The serving kernels against their plain versions, as max |difference| /
max |plain|: K7 RMSNorm f32 within 2e-6 (the sum of squares in another
order, rsqrtf) and bf16 within one bf16 ulp of each value; K8 attention
f32 within 2e-5 (FMA sums in another order) and bf16 within 1e-2 (the
kernel rounds p to bf16 for the tensor cores), also for lengths and
windows that are no multiple of its tiles and every head dim, each
through the kernel K8's rule picks (wgmma at head dims 64-256, mma.sync
at 16 and 32); K7's one-
and two-pass kernels each at the decode rows and serving widths, at the
one-pass kernel's widest row and one vector beyond, and with an
unaligned weight, each launch counted under its kernel; K10 within 1e-5 (the
segmented walk and the doubling scan multiply in other orders), at lengths
and widths that are no multiple of its tile, and with weak decay within
the bound derived beside that test. The SMOKE
hybrid model generates the same greedy tokens with ``use_pallas`` on the
card as without, its prefill logits within 1e-4, and the kernels launch
as counted (K7 11 per prefill and per decode step with 8 layers: 2 x 8 +
1 = 17, K8 once per attention layer per prefill, K10 once per rec layer
per prefill).

MALI: the lattice's int32/int64 adds wrap on CUDA as on the CPU; K1 and
K3 with the half-drift row (0.5,) are bitwise their plain versions (an
h = 0 row of K3 passing through); ``alf_step_inverse(alf_step(s)) == s``
bitwise on CUDA tensors for the reference's dtype × scale grid (bf16
too), with the CPU's integers; a van der Pol MALI solve on the fused path
(solo on K1, batched on K3, two launches a replayed step) takes the CPU
solve's steps and trials with ys bitwise (an elementwise field rounds
alike on both devices), gradients within 1e-5 of their scale, and its
backward ends on the encoded start pair bit for bit; the MALI serving
engine on the card gives the CPU engine's statuses and chunks, z_final
within 1e-5 relative.

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

Dense and MoE LMs, LM training: deepseek_moe_16b's SMOKE model with
``use_pallas`` against its plain route (prefill logits within 1e-4, the
same greedy tokens, K7 and K8 launches as counted); a repeated bf16 MoE
decode bitwise; one NODE-LM train step (node18's SMOKE, ``NODE_TRAIN``)
through K1/K2 against their plain versions: the loss bitwise, the updated
parameters within 1e-5. The sharded LM: a 2-layer dense model on a
one-rank NCCL mesh with ``use_pallas``, prefill and decode bitwise the
mesh-less route, K7 and K8 launched as often on both.
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


def _card_and_cpu(run):
    """``run(device)`` on the card and on CPU tensors (the kernels' plain
    versions), the card's K1-K4 launches counted."""
    rk_stage.reset_launches()
    on_card = run(torch.device("cuda"))
    launched = dict(rk_stage.launches)
    return on_card, run(torch.device("cpu")), launched


@pytest.mark.parametrize("method", ["adjoint", "naive"])
def test_toy_gradient_methods_on_the_card(card, method):
    """The adjoint and naive toy solves through K1/K2 on the card: the
    analytic gradient within 1e-4 (the reference test's), and the CPU
    solve's steps and gradient within 1e-5 (K2's norm sums in another
    order, which moves a stepsize by ulps)."""
    def run(dev):
        z0 = torch.tensor(1.5, device=dev, requires_grad=True)
        ys, st = odeint(lambda t, z, c: c * z, z0, [0.0, 1.0],
                        (torch.tensor(2.0, device=dev),), solver="dopri5",
                        grad_method=method, rtol=1e-6, atol=1e-6,
                        use_pallas=True)
        (ys[-1] ** 2).sum().backward()
        return float(z0.grad), int(st.n_steps)

    (g, n), (g_cpu, n_cpu), launched = _card_and_cpu(run)
    analytic = 2 * 1.5 * np.exp(4.0)
    assert abs(g - analytic) / analytic < 1e-4
    assert n == n_cpu and abs(g - g_cpu) <= 1e-5 * abs(g_cpu)
    assert launched["rk_stage_increment"] > 0
    assert launched["rk_stage_combine_err"] > 0


@pytest.mark.parametrize("method", ["aca", "adjoint", "naive"])
def test_batched_methods_on_the_card(card, method):
    """A small batch_axis=0 solve of each method through K3/K4 on the
    card, against its plain path on the card (steps equal, ys within
    rtol 1e-5, gradients within rtol 1e-4: the norm sums in another order)
    and against the same solve on CPU tensors: per-row steps equal, ys
    within 10 x the solve tolerance and gradients within 1e-4 of their
    scale. The two devices' fields round differently and the error
    estimate, a difference of nearly equal stage sums, carries that
    rounding into the stepsizes, so the grids drift apart by a fraction
    of the local error the controller allows (measured on an H100: 2.3e-6
    at tolerance 1e-6, 4.2e-5 at 1e-4)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 64)) * 0.2).astype(np.float32)
    z0 = rng.standard_normal((4, 64)).astype(np.float32)
    tol = 1e-6

    def run(dev, use_pallas=True):
        zz = torch.tensor(z0, device=dev, requires_grad=True)
        ww = torch.tensor(w, device=dev, requires_grad=True)
        ys, st = odeint(lambda t, z, m: torch.tanh(m @ z), zz, [0.0, 1.0],
                        (ww,), solver="dopri5", grad_method=method,
                        rtol=tol, atol=tol, batch_axis=0,
                        use_pallas=use_pallas)
        torch.sum(ys[-1] ** 2).backward()
        return (ys.detach().cpu(), st.n_steps.tolist(), zz.grad.cpu(),
                ww.grad.cpu())

    (y1, s1, gz1, gw1), (y0, s0, gz0, gw0), launched = _card_and_cpu(run)
    assert launched["rk_stage_increment_batched"] > 0
    assert launched["rk_stage_combine_err_batched"] > 0
    assert s1 == s0
    torch.testing.assert_close(y1, y0, rtol=0.0, atol=10 * tol)
    for g1, g0 in ((gz1, gz0), (gw1, gw0)):
        assert float((g1 - g0).abs().max() / g0.abs().max()) <= 1e-4
    yp, sp, gzp, gwp = run(card, use_pallas=False)
    assert sp == s1
    torch.testing.assert_close(y1, yp, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(gz1, gzp, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(gw1, gwp, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("method", ["aca", "adjoint", "naive"])
def test_per_row_ts_on_the_card(card, method):
    """(B, T) eval times, every row on its own times and start, through
    K3/K4 on the card against the plain path on the card: per-row steps
    equal, ys within rtol 1e-5, gradients within 1e-4 of their max |value|.
    K4 sums each row's norm in another order than the plain path, which
    moves the error ratio by an ulp or two; the naive method
    differentiates the stepsize chain through that ratio, and on the CPU a
    ratio scaled by 1 +- 1e-7 or 1 + 3e-7 moves its z0 gradient by up to
    3.7e-5 of max |g| (2.6e-4 of one element's own value)."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((16, 16)) * 0.3).astype(np.float32)
    z0 = rng.standard_normal((5, 16)).astype(np.float32)
    ts = np.sort(rng.uniform(0.0, 2.0, (5, 6)), axis=1).astype(np.float32)
    ts[:, 0] = rng.uniform(0.0, 0.2, 5)

    def run(use_pallas):
        zz = torch.tensor(z0, device=card, requires_grad=True)
        ww = torch.tensor(w, device=card, requires_grad=True)
        ys, st = odeint(lambda t, z, m: torch.tanh(m @ z), zz,
                        torch.tensor(ts, device=card), (ww,),
                        solver="dopri5", grad_method=method, rtol=1e-4,
                        atol=1e-4, batch_axis=0, use_pallas=use_pallas)
        torch.sum(ys ** 2).backward()
        return ys.detach(), st.n_steps.tolist(), zz.grad, ww.grad

    rk_stage.reset_launches()
    y1, s1, gz1, gw1 = run(True)
    assert rk_stage.launches["rk_stage_increment_batched"] > 0
    assert rk_stage.launches["rk_stage_combine_err_batched"] > 0
    y0, s0, gz0, gw0 = run(False)
    assert s1 == s0 and len(set(s1)) > 1
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-6)
    for g1, g0 in ((gz1, gz0), (gw1, gw0)):
        assert float((g1 - g0).abs().max() / g0.abs().max()) <= 1e-4


@pytest.mark.parametrize("n", [1, 37, 4096, 100_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b_mid_kernels_are_bitwise_their_plain_versions(card, n, dtype):
    """K1 and K3 with Dopri5's 7-weight b_mid row (the dense midpoint):
    bitwise their plain versions; a K3 row with h = 0 passes through."""
    z, k, h = _inputs(card, n, dtype, seed=5)
    out = rk_stage.rk_stage_increment(z, k, h, DOPRI5.b_mid)
    assert torch.equal(out, rk_stage.increment_plain(z, k, h, DOPRI5.b_mid))
    zb = torch.stack([z, -z, 2 * z])
    kb = torch.stack([k, k.flip(1), -k], dim=1).contiguous()
    hb = torch.tensor([0.05, 0.0, 0.02], device=card)
    out = rk_stage.rk_stage_increment_batched(zb, kb, hb, DOPRI5.b_mid)
    assert torch.equal(out, rk_stage.increment_batched_plain(
        zb, kb, hb, DOPRI5.b_mid))
    assert torch.equal(out[1], zb[1])


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("interpolate", [False, True])
def test_segmented_solve_is_bitwise_its_full_buffer_on_the_card(
        card, batched, interpolate):
    """A small segmented ACA solve through K1/K2 (K3/K4 batched) on the
    card: steps, outputs and gradients bitwise the full buffer's, with
    and without interpolate_ts (the b_mid midpoint on the kernels)."""
    rng = np.random.default_rng(2)
    w = torch.tensor((rng.standard_normal((32, 32)) * 0.3).astype(
        np.float32), device=card)
    z0 = torch.tensor(rng.standard_normal((3, 32) if batched else 32)
                      .astype(np.float32), device=card)
    out = []
    for segs in (None, 3):
        rk_stage.reset_launches()
        zz, ww = z0.clone().requires_grad_(), w.clone().requires_grad_()
        ys, st = odeint(lambda t, z, m: torch.tanh(m @ z) - 0.2 * z, zz,
                        torch.linspace(0.0, 2.0, 9), (ww,),
                        solver="dopri5", rtol=1e-6, atol=1e-6, max_steps=48,
                        use_pallas=True, checkpoint_segments=segs,
                        interpolate_ts=interpolate,
                        batch_axis=0 if batched else None)
        torch.sum(ys ** 2).backward()
        out.append((st.n_steps.tolist(), ys.detach(), zz.grad, ww.grad))
        key = "rk_stage_increment_batched" if batched else \
            "rk_stage_increment"
        assert rk_stage.launches[key] > 0
    (s0, *a), (s1, *b) = out
    assert s0 == s1 and max(np.ravel(s0)) > 3
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_method_costs_aca_pallas_matches_aca_on_the_card(card):
    """Table 1's aca_pallas row (K1/K2) against its aca row on the card:
    the same trials on the same bits, so z(1) bitwise; gradients within
    1e-5 of their scale (the replay differentiates through the plain
    versions)."""
    from repro_torch.benchmarks import method_costs

    w1, w2, z0 = method_costs.init(card)
    rk_stage.reset_launches()
    _, g1, z1, st1 = method_costs.value_and_grad("aca_pallas", w1, w2, z0, 32)
    assert rk_stage.launches["rk_stage_increment"] > 0
    assert rk_stage.launches["rk_stage_combine_err"] > 0
    _, g0, z0_, st0 = method_costs.value_and_grad("aca", w1, w2, z0, 32)
    assert int(st1.n_steps) == int(st0.n_steps)
    assert torch.equal(z1, z0_)
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


@pytest.mark.parametrize("method", ["aca", "adjoint", "naive"])
def test_fixed_grid_methods_on_the_card(card, method):
    """rk4 on a fixed grid through K1 on the card against CPU tensors:
    ys within rtol 1e-5, gradients within rtol 1e-4."""
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((64, 64)) * 0.2).astype(np.float32)
    z0 = rng.standard_normal(64).astype(np.float32)

    def run(dev):
        ww = torch.tensor(w, device=dev, requires_grad=True)
        ys, _ = odeint(lambda t, z, m: torch.tanh(m @ z),
                       torch.tensor(z0, device=dev), [0.0, 0.5, 1.0], (ww,),
                       solver="rk4", grad_method=method,
                       steps_per_interval=8, use_pallas=True)
        torch.sum(ys ** 2).backward()
        return ys.detach().cpu(), ww.grad.cpu()

    (y1, g1), (y0, g0), launched = _card_and_cpu(run)
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(g1, g0, rtol=1e-4, atol=1e-6)
    assert launched["rk_stage_increment"] > 0


def _batched_inputs(card, rows, n, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    z = torch.randn(rows, n, generator=g).to(dtype).to(card)
    k = torch.randn(7, rows, n, generator=g).to(dtype).to(card)
    h = torch.linspace(0.01, 0.08, rows).to(card)
    if rows > 1:
        h[1] = 0.0                  # a frozen row
    return z, k, h


# (8, 393,218) is the serving state; (4, 4098) and (8, 100,003) put row
# starts at every offset modulo 16 bytes on the vector path; (3, 4098) and
# (5, 100,003) have (rows * N) % V != 0 and take the scalar path
@pytest.mark.parametrize("rows,n", [(1, 37), (3, 4096), (5, 100_003),
                                    (2, 4098), (8, 393_218), (3, 4098),
                                    (4, 4098), (8, 100_003)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_increment_batched_kernel_is_bitwise_its_plain_version(card, rows,
                                                               n, dtype):
    z, k, h = _batched_inputs(card, rows, n, dtype)
    width = 16 // z.element_size()
    assert rk_stage.row_vectorized(rows, n, dtype, z, k) == (
        (rows * n) % width == 0)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_increment_batched_kernel_on_views_one_element_in(card, dtype):
    """z and k start one element into larger buffers (mutually aligned, not
    16-byte aligned): K3 allocates out at the same offset, takes the vector
    path with a scalar head in every row, and stays bitwise."""
    rows, n = 8, 100_003
    z0, k0, h = _batched_inputs(card, rows, n, dtype)
    zbuf = torch.empty(rows * n + 1, dtype=dtype, device=card)
    kbuf = torch.empty(7 * rows * n + 1, dtype=dtype, device=card)
    z = zbuf[1:].view(rows, n)
    k = kbuf[1:].view(7, rows, n)
    z.copy_(z0)
    k.copy_(k0)
    assert z.data_ptr() % 16 == z.element_size()
    assert rk_stage.row_vectorized(rows, n, dtype, z, k)
    for tab in TABS:
        for i, a in [(1, tab.a[1]), (tab.stages, tab.b)]:
            out = rk_stage.rk_stage_increment_batched(z, k[:i], h, a)
            assert out.data_ptr() % 16 == z.data_ptr() % 16
            assert torch.equal(out, rk_stage.increment_batched_plain(
                z0, k0[:i].contiguous(), h, a))
            assert torch.equal(out[1], z0[1])       # the h = 0 row
    # z alone one element in: no shared offset with k, the scalar path
    assert not rk_stage.row_vectorized(rows, n, dtype, z, k0)
    a = DOPRI5.b
    out = rk_stage.rk_stage_increment_batched(z, k0, h, a)
    assert torch.equal(out, rk_stage.increment_batched_plain(z0, k0, h, a))


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


TILE_ROWS = [393_218, 393_216]    # the serving row, the batched block's


def _k4_k5(z, k, h, rt, at, tab=HEUN_EULER):
    """K4 at (1e-3, 1e-4) and K5 at (rt, at): (z_next, partials) each,
    then the per-row sums the solver reads (``ops``: partials.sum(-1))."""
    args = (z, k, h, tab.b, tab.b_err)
    return (*rk_stage.rk_stage_combine_err_batched(*args, 1e-3, 1e-4),
            *rk_stage.rk_stage_combine_err_batched_rowtol(*args, rt, at),
            ops.rk_stage_combine_err_batched(*args, 1e-3, 1e-4)[1],
            ops.rk_stage_combine_err_batched(*args, rt, at)[1])


@pytest.mark.parametrize("n", TILE_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_err_batched_partials_are_the_tile_partials(card, n, dtype):
    """K4's and K5's partials: ceil(N / 2048) a row, bitwise the plain tile
    partials; z_next bitwise the plain version's; the h = 0 row passes
    through with zero partials; K5 at K4's tolerance is K4."""
    rows = 8
    z, k, h = _batched_inputs(card, rows, n, dtype, seed=2)
    rt = torch.logspace(-2, -5, rows).to(card)
    at = 0.1 * rt
    for tab in (HEUN_EULER, DOPRI5):
        kk = k[:tab.stages].contiguous()
        args = (z, kk, h, tab.b, tab.b_err)
        zn4, p4, zn5, p5, _, _ = _k4_k5(z, kk, h, rt, at, tab)
        assert tuple(p4.shape) == (rows, -(-n // 2048)) == (
            rows, rk_stage.norm_tiles(n))
        assert p4.stride(0) % 4 == 0 and p4.data_ptr() % 16 == 0
        for zn, p, tols in ((zn4, p4, (1e-3, 1e-4)), (zn5, p5, (rt, at))):
            assert torch.equal(p, rk_stage.combine_err_batched_tile_partials(
                *args, *tols, rk_stage.NORM_TILE))
            assert torch.equal(zn, rk_stage.combine_err_batched_plain(
                *args, *tols)[0])
            assert torch.equal(zn[1], z[1]) and not bool(p[1].any())
        eq = rk_stage.rk_stage_combine_err_batched_rowtol(
            *args, torch.full((rows,), 1e-3, device=card),
            torch.full((rows,), 1e-4, device=card))
        assert torch.equal(eq[0], zn4) and torch.equal(eq[1], p4)


@pytest.mark.parametrize("n", TILE_ROWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_err_batched_row_does_not_depend_on_b_or_offset(card, n,
                                                               dtype):
    """Row 5's K4/K5 partials and z_next, and the per-row sums the solver
    reads, are the same bits solved at B = 8, 3 (rows 4-6) and 1, and with
    z, k (and so z_next) views 0-3 elements into larger buffers, though B
    and the offset move the row's head and, at N = 393,218, send B = 1
    down the scalar path."""
    z, k, h = _batched_inputs(card, 8, n, dtype, seed=3)
    k = k[:HEUN_EULER.stages].contiguous()
    rt = torch.logspace(-2, -5, 8).to(card)
    at = 0.1 * rt
    row = 5
    want = [x[row] for x in _k4_k5(z, k, h, rt, at)]
    paths = set()
    for lo, hi in ((0, 8), (4, 7), (5, 6)):
        b = hi - lo
        for shift in range(4):
            zv = torch.empty(b * n + shift, dtype=dtype,
                             device=card)[shift:].view(b, n)
            kv = torch.empty(k.shape[0] * b * n + shift, dtype=dtype,
                             device=card)[shift:].view(k.shape[0], b, n)
            zv.copy_(z[lo:hi])
            kv.copy_(k[:, lo:hi])
            paths.add(rk_stage.row_vectorized(b, n, dtype, zv, kv))
            got = _k4_k5(zv, kv, h[lo:hi], rt[lo:hi], at[lo:hi])
            assert got[0].data_ptr() % 16 == zv.data_ptr() % 16
            for g, w in zip(got, want):
                assert torch.equal(g[row - lo], w), (b, shift)
    assert paths == ({True, False} if n % 4 else {True})


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


def _serve_alone_and_in_a_mix(card, dim):
    """A small engine run through K3 and K5 on rows of dim + 2: every
    request OK, and one request alone gives its bits in the mix."""
    w = torch.tensor(1.3, device=card)

    def field(t, z, ww):
        return torch.tanh(ww * z) - 0.1 * z * torch.sin(t)

    rng = np.random.default_rng(3)
    reqs = [NodeRequest(z0=rng.standard_normal(dim).astype(np.float32),
                        t1=float(t1), rtol=tol, atol=tol)
            for t1, tol in zip([0.5, 1.0, 1.5, 1.0, 0.5],
                               [1e-3, 1e-4, 1e-3, 1e-5, 1e-4])]
    eng = NodeServeEngine(field, dim, (w,),
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


def test_node_serve_engine_on_the_card(card):
    _serve_alone_and_in_a_mix(card, 64)


def test_node_serve_engine_on_a_ragged_row_on_the_card(card):
    """dim 63: rows of 65, so every slot starts at another offset modulo
    16 bytes (its own head on the vector path)."""
    _serve_alone_and_in_a_mix(card, 63)


def test_node_serve_engine_on_the_serving_row_on_the_card(card):
    """node18's width: rows of 393,218, 193 norm partials a row (not a
    multiple of 4), so a slot's partials would start at another offset
    modulo 16 bytes but for their padded row stride."""
    _serve_alone_and_in_a_mix(card, 393_216)


# ------------------------------------------------ serving kernels K7/K8/K10

def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _rows_rel(a, b, rows=16):
    # max over tiles of 16 rows (a warp's rows in both bf16 kernels) of
    # ||a - b|| / ||b||: K8's rows that see many keys are ~100x smaller
    # than its first ones, which set max |b| in _rel
    def sq(x):
        x = torch.nn.functional.pad(x.flatten(0, -3),
                                    (0, 0, 0, -x.shape[-2] % rows))
        return x.unflatten(1, (-1, rows)).square().sum((-1, -2))

    a, b = a.float(), b.float()
    return float((sq(a - b) / sq(b).clamp_min(1e-30)).sqrt().max())


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


@pytest.mark.parametrize("s", [1, 63, 65, 200, 777, 127, 129, 1000])
@pytest.mark.parametrize("window", [0, 1, 7, 63, 100, 1000])
@pytest.mark.parametrize("dh", [16, 32, 64, 128, 256])
def test_flash_attention_bf16_tile_classes(card, s, window, dh):
    # lengths and windows that are no multiple of the kernels' tiles (64 x
    # 64 for mma.sync; for wgmma 128 query rows, two warpgroups of 64, and
    # 128 or 64 keys: 127, 129 and 1000 straddle them), windows shorter
    # than one tile and longer than S, every head dim, GQA with 2 kv
    # heads: interior, diagonal, window-edge and past-S tiles, and a
    # second warpgroup with no rows; each through the kernel K8's rule
    # picks
    g = torch.Generator(device="cpu").manual_seed(s * 7 + window + dh)
    q = torch.randn(2, 4, s, dh, generator=g).to(torch.bfloat16).to(card)
    k = torch.randn(2, 2, s, dh, generator=g).to(torch.bfloat16).to(card)
    v = torch.randn(2, 2, s, dh, generator=g).to(torch.bfloat16).to(card)
    before = ops.launch_counts()["flash_attention"]
    kernel = fa.kernel_for(dh, 2)
    ran = fa.variant_launches[kernel]
    out = ops.flash_attention(q, k, v, window=window)
    want = fa.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert fa.variant_launches[kernel] == ran + 1
    assert bool(torch.isfinite(out).all())
    assert _rel(out, want) <= 1e-2
    assert _rows_rel(out, want) <= 1e-2


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
    if dtype == torch.bfloat16:
        assert _rows_rel(out, want) <= 1e-2


# the tile edges: S = 7, 65, T + 1 and 1000 (T = lru.SEGMENTS *
# lru.SEGMENT_STEPS steps a tile, 128) and C = 5 and 4096 + 16 (no
# multiple of the 32-channel tile)
@pytest.mark.parametrize("b,s,c", [(2, 1000, 64), (1, 4096, 256),
                                   (3, 7, 5), (2, 65, 4112), (2, 129, 4112),
                                   (1, 1000, 5), (4, 7, 4112),
                                   (2, 1000, 4112)])
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


# weak decay, Griffin's trained range a^8 in [0.9, 0.999] at r = 1
# (src/repro/models/rglru.py:53): log a in [-1.3e-2, -1.25e-4], so the
# state carries across the whole sequence. Bound, as a share of max |h|:
# an error made at step j reaches step t scaled by decay factors <= 1, so
# over S steps the kernel's roundings (the state's multiply-add and the
# segment product, each once a step; the compose once a segment: < 3 a
# step) and expf's 2 ulp, should torch.exp differ, add at most
# 5 S 2^-24 (1.2e-3 at S = 4096); the doubling scan rounds 3 log2 S
# times. The existing cases keep 1e-5.
WEAK_LOG_A = (-1.3e-2, -1.25e-4)


def weak_rtol(s):
    return 5 * s * 2.0 ** -24


def test_rg_lru_kernel_with_weak_decay(card):
    g = torch.Generator(device="cpu").manual_seed(11)
    b, s, c = 2, 4096, 256
    lo, hi = WEAK_LOG_A
    log_a = (lo + (hi - lo) * torch.rand(b, s, c, generator=g)).to(card)
    x = torch.randn(b, s, c, generator=g).to(card)
    before = ops.launch_counts()["rg_lru"]
    out = ops.rg_lru(log_a, x)
    want = lru.rg_lru_plain(log_a, x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rg_lru"] == before + 1
    assert bool(torch.isfinite(out).all())
    assert _rel(out, want) <= weak_rtol(s)


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


# ------------------------------------------------------------------ MALI

def test_lattice_adds_wrap_on_the_card(card):
    """The lattice's int32 and int64 adds and subtracts wrap on CUDA, near
    ±2³¹ and ±2⁶³, as on the CPU (tests/test_torch_mali.py)."""
    from repro_torch.core.stepper import lattice_add, lattice_sub
    for dt, bits in ((torch.int32, 32), (torch.int64, 64)):
        hi, lo = 2 ** (bits - 1) - 1, -2 ** (bits - 1)
        a = torch.tensor([hi, lo, hi - 5, lo + 5, 0], dtype=dt, device=card)
        b = torch.tensor([1, -1, 10, -10, hi], dtype=dt, device=card)
        assert lattice_add(a, b).tolist() == [lo, hi, lo + 4, hi - 4, hi]
        assert lattice_sub(a, b).tolist() == [hi - 1, lo + 1, hi - 15,
                                              lo + 15, -hi]
        assert torch.equal(lattice_sub(lattice_add(a, b), b), a)


@pytest.mark.parametrize("n", [1, 37, 4096, 100_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_half_drift_kernels_are_bitwise_their_plain_versions(card, n, dtype):
    """K1 and K3 with MALI's one-weight row (0.5,) and one stage row:
    bitwise their plain versions, an h = 0 row of K3 passing through."""
    from repro_torch.core.stepper import HALF_DRIFT
    z, k, h = _inputs(card, n, dtype, seed=5)
    before = rk_stage.launches["rk_stage_increment"]
    v = k[:1].contiguous()
    assert torch.equal(rk_stage.rk_stage_increment(z, v, h, HALF_DRIFT),
                       rk_stage.increment_plain(z, v, h, HALF_DRIFT))
    assert rk_stage.launches["rk_stage_increment"] == before + 1
    zb = torch.stack([z, -z, 2 * z]).contiguous()
    vb = torch.stack([v[0], v[0], -v[0]])[None].contiguous()
    hb = torch.tensor([0.05, 0.0, 0.0125], device=card)
    out = rk_stage.rk_stage_increment_batched(zb, vb, hb, HALF_DRIFT)
    assert torch.equal(out, rk_stage.increment_batched_plain(zb, vb, hb,
                                                             HALF_DRIFT))
    assert torch.equal(out[1], zb[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 37.0, 1e8, 1e30])
def test_alf_roundtrip_bitexact_on_the_card(card, dtype, scale):
    """inverse(step(s)) == s bitwise on CUDA tensors for the reference's
    dtype × scale grid, and the step's integers are the CPU's (the
    quanta are exact powers of two on both devices)."""
    from repro_torch.core.stepper import (alf_lattice_exponent, alf_step,
                                          alf_step_inverse, lattice_encode)

    def lin(t, z, k):
        return k * z

    zn = np.random.default_rng(0).standard_normal(17) * scale
    out = {}
    for dev in (card, torch.device("cpu")):
        k = torch.tensor(-0.7, dtype=dtype, device=dev)
        z = torch.tensor(zn, dtype=torch.float64).to(dtype).to(dev)
        v = lin(0.0, z, k)
        se = alf_lattice_exponent(z, v)
        zq, vq = lattice_encode(z, se), lattice_encode(v, se)
        t = torch.tensor(0.3, dtype=dtype, device=dev)
        h = torch.tensor(0.05, dtype=dtype, device=dev)
        r = alf_step(lin, t, h, zq, vq, se, z, (k,))
        bz, bv = alf_step_inverse(lin, t, h, r.zq_next, r.vq_next, se, z,
                                  (k,))
        assert torch.equal(bz, zq) and torch.equal(bv, vq)
        out[dev.type] = (r.zq_next.cpu(), r.vq_next.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])


def _vdp(t, z, mu):
    x, y = z[..., 0], z[..., 1]
    return torch.stack([y, mu * (1.0 - x ** 2) * y - x], dim=-1)


@pytest.mark.parametrize("batched", [False, True])
def test_mali_on_the_card(card, batched):
    """MALI on the fused path on the card (K1, or K3 batched, for the
    backward's half-drifts: two launches a replayed step) against the same
    solve on CPU tensors: the CPU's steps and trials, ys bitwise solo and
    within 10 x the tolerance batched (the vmapped initial-stepsize
    heuristic rounds differently on the two devices, which moves the grid:
    ROADMAP queue 3, the card's grids), gradients within 1e-5 of their
    scale solo, 1e-4 batched; the backward ends on the encoded start pair
    bit for bit on both."""
    import importlib
    mali_mod = importlib.import_module("repro_torch.core.odeint_mali")
    z0n = np.array([[2.0, 0.0], [1.0, 0.5], [0.3, -0.2]] if batched
                   else [2.0, 0.0], np.float32)
    ends = []
    orig = mali_mod.mali_backward_sweep

    def recording(sw):
        out = orig(sw)
        ends.append(all(torch.equal(a, b) for a, b in
                        zip((sw.zq, sw.vq), sw.encoded_start())))
        return out

    def run(dev):
        z0 = torch.tensor(z0n, device=dev, requires_grad=True)
        mu = torch.tensor(2.0, device=dev, requires_grad=True)
        ys, st = odeint(_vdp, z0, [0.0, 0.5], (mu,), grad_method="mali",
                        rtol=1e-5, atol=1e-5, max_steps=2048,
                        use_pallas=True, batch_axis=0 if batched else None)
        torch.sum(ys[-1] ** 2).backward()
        return (ys.detach().cpu(), st.n_steps.cpu(), st.n_trials.cpu(),
                z0.grad.cpu(), mu.grad.cpu())

    mali_mod.mali_backward_sweep = recording
    try:
        on_card, on_cpu, launched = _card_and_cpu(run)
    finally:
        mali_mod.mali_backward_sweep = orig
    assert ends == [True, True]
    key = "rk_stage_increment_batched" if batched else "rk_stage_increment"
    assert launched[key] == 2 * int(on_card[1].max())
    assert torch.equal(on_card[1], on_cpu[1])
    assert torch.equal(on_card[2], on_cpu[2])
    if batched:
        assert float((on_card[0] - on_cpu[0]).abs().max()) <= 1e-4
    else:
        assert torch.equal(on_card[0], on_cpu[0])
    grad_rtol = 1e-4 if batched else 1e-5
    for a, b in zip(on_card[3:], on_cpu[3:]):
        assert float((a - b).abs().max()) <= grad_rtol * float(
            b.abs().max())


def test_engine_gradient_methods_on_the_card(card):
    """NodeServeEngine under aca, adjoint and naive on the card (K3/K5)
    serves one short trace: the adjoint's and the naive method's z(T) are
    ACA's, so every z_final is bitwise ACA's. The naive method's rounds
    run its own trial loop, which stops where the request's chunk ends, so
    its sim clock charges the trials it takes (not the reference's
    budget): the same trials as ACA's, and the same clock."""
    out = {}
    for method in ("aca", "adjoint", "naive"):
        cfg = NodeEngineConfig(slots=2, chunk_dt=0.5, grad_method=method,
                               use_pallas=True)
        e = NodeServeEngine(
            lambda t, z, w: torch.tanh(w * z) - 0.1 * z * torch.sin(t), 6,
            (torch.tensor(1.3, device=card),), cfg, device=card)
        for i in range(4):
            z = np.random.default_rng(i).normal(size=6).astype(np.float32)
            e.submit(NodeRequest(z0=z, t1=0.6 + 0.4 * i, rtol=1e-4),
                     arrival=0.3 * i)
        ops.reset_launches()
        out[method] = (e.run(), e.clock.now)
        assert rk_stage.launches["rk_stage_increment_batched"] > 0
        assert rk_stage.launches["rk_stage_combine_err_batched_rowtol"] > 0
    aca, clock = out["aca"]
    assert all(r.ok for r in aca)
    for method in ("adjoint", "naive"):
        res, now = out[method]
        assert now == clock
        for a, b in zip(res, aca):
            assert a.ok and a.status == b.status
            assert a.n_trials == b.n_trials and a.n_chunks == b.n_chunks
            assert np.array_equal(a.z_final, b.z_final)


def test_mali_engine_on_the_card(card):
    """NodeServeEngine(grad_method="mali") on the card serves a mix of
    requests with the CPU engine's statuses and chunk counts, z_final
    within 1e-5 relative."""
    cfg = NodeEngineConfig(slots=2, chunk_dt=0.5, grad_method="mali",
                           use_pallas=True)
    out = {}
    for dev in ("cuda", "cpu"):
        e = NodeServeEngine(lambda t, z, w: torch.tanh(w * z) - 0.1 * z,
                            6, (torch.tensor(1.3, device=dev),), cfg,
                            device=dev)
        for i in range(3):
            z = np.random.default_rng(i).normal(size=6).astype(np.float32)
            e.submit(NodeRequest(z0=z, t1=0.6 + 0.4 * i, rtol=1e-4),
                     arrival=0.0)
        out[dev] = e.run()
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.ok and b.ok and a.status == b.status
        assert a.n_chunks == b.n_chunks
        scale = max(1.0, float(np.abs(b.z_final).max()))
        assert float(np.abs(a.z_final - b.z_final).max()) <= 1e-5 * scale


# ------------------------------------------------ MoE serving, NODE-LM training

def test_moe_smoke_generate_with_kernels_on_the_card(card):
    """deepseek_moe_16b's SMOKE (f32) with ``use_pallas`` against its plain
    route on the card: prefill logits within 1e-4 (K7's and K8's f32
    rounding; no router choice sits that close to a tie here), the same
    greedy tokens, K7 2 per layer + 1 per prefill and per decode step, K8
    once per layer per prefill."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServeEngine
    cfg = get_smoke_config("deepseek_moe_16b")     # 2 layers, 8 experts
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
    assert ck["rmsnorm"] == 5 and ck["flash_attention"] == 2
    assert all(v == 0 for v in cp.values())
    assert _rel(lk, lp) <= 1e-4
    assert torch.equal(ok, op_)


def test_moe_decode_repeats_bitwise_on_the_card(card):
    """The MoE combine sums each token's experts in a fixed order (no
    atomics): the same decode step twice gives the same bits, in bf16."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    cfg = get_smoke_config("deepseek_moe_16b")
    model = build_model(cfg, RunConfig(param_dtype=torch.bfloat16,
                                       use_pallas=True, max_seq=64))
    params = model.init(device=card, seed=3)
    toks = torch.randint(0, cfg.vocab, (4, 33), device=card,
                         generator=torch.Generator(card).manual_seed(4))
    outs = []
    with torch.no_grad():
        for _ in range(2):
            last, caches = model.prefill(params, {"tokens": toks[:, :32]})
            lg, _ = model.decode_step(params, {"tokens": toks[:, 32:]},
                                      caches, 32)
            outs.append((last, lg))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_node_lm_train_step_kernels_match_plain_on_the_card(card):
    """One NODE-LM train step (node18's SMOKE, NODE_TRAIN, f32) through
    K1/K2 against the same step on their plain versions: the loss bit for
    bit (K1/K2 are bitwise their plain versions, so every accept/reject
    decision is the same), each parameter's update within 1e-5 of its
    largest (SGD at lr 1 without momentum or clipping: the update is the
    gradient; the backward replays sum in other orders)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.node18_cifar import NODE_TRAIN
    from repro_torch.data import TokenPipeline
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.optim import constant, sgd
    from repro_torch.optim.grad_utils import CompressionState
    from repro_torch.train import (TrainLoopConfig, build_train_step,
                                   make_train_state)
    cfg = get_smoke_config("node18_cifar")
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=4,
                          device="cuda").batch(0)
    opt = sgd(constant(1.0), momentum=0.0)
    out = {}
    for up in (True, False):
        node = dataclasses.replace(NODE_TRAIN, use_pallas=up)
        model = build_model(cfg, RunConfig(compute_dtype=torch.float32,
                                           node=node))
        state = make_train_state(model, opt, seed=0, device=card)
        ops.reset_launches()
        new, _, metrics = build_train_step(model, opt, TrainLoopConfig(
            clip_norm=1e9))(state, batch, CompressionState(error=()))
        torch.cuda.synchronize()
        upd = [b - a for a, b in zip(
            torch.utils._pytree.tree_leaves(state.params),
            torch.utils._pytree.tree_leaves(new.params))]
        out[up] = (metrics, upd, ops.launch_counts())
    (mk, sk, ck), (mp, sp, cp) = out[True], out[False]
    assert ck["rk_stage_increment"] > 0 and ck["rk_stage_combine_err"] > 0
    assert all(v == 0 for v in cp.values())
    assert int(mk["skipped"]) == 0 and bool(torch.isfinite(mk["loss"]))
    assert torch.equal(mk["loss"], mp["loss"])
    for a, b in zip(sk, sp):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            float(b.abs().max()), 1e-30)


def test_sharded_lm_on_a_one_rank_mesh_is_bitwise(card):
    """A 2-layer dense LM (f32, GQA) on a one-rank NCCL ``(data, model)``
    mesh with ``use_pallas``: prefill and three decode steps give the
    mesh-less route's logits bit for bit (on one rank every placement is
    the whole tensor and every collective a copy), and K7 and K8 launch
    as often on both routes (K7 2 per layer + 1 per prefill and per decode
    step, K8 once per layer per prefill)."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import (free_port, init_distributed,
                                         make_debug_mesh)
    from repro_torch.models.common import place_params
    from repro_torch.models.config import ModelConfig, RunConfig
    from repro_torch.models.lm import build_model

    cfg = ModelConfig(name="dense2", family="dense", n_layers=2, d_model=128,
                      vocab=256, n_heads=4, n_kv_heads=2, d_ff=256)
    os.environ.update({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1",
                       "MASTER_PORT": str(free_port())})
    init_distributed("cuda")
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        rcfg = RunConfig(compute_dtype=torch.float32, use_pallas=True,
                         max_seq=64)
        plain = build_model(cfg, rcfg)
        sharded = build_model(cfg, rcfg.with_(mesh=mesh))
        params = plain.init(device=card, seed=0)
        dparams = place_params(params, sharded.defs, rcfg.rules, mesh)
        toks = torch.randint(0, cfg.vocab, (2, 43), device=card,
                             generator=torch.Generator(card).manual_seed(1))
        runs = []
        for m, p in ((plain, params), (sharded, dparams)):
            ops.reset_launches()
            with torch.no_grad():
                out, caches = m.prefill(p, {"tokens": toks[:, :40]})
                outs = [out]
                for j in range(3):
                    out, caches = m.decode_step(
                        p, {"tokens": toks[:, 40 + j:41 + j]}, caches, 40 + j)
                    outs.append(out)
            runs.append((outs, ops.launch_counts()))
        (lp, cp), (lm, cm) = runs
        assert all(torch.equal(a, b) for a, b in zip(lp, lm))
        assert cp["rmsnorm"] == cm["rmsnorm"] == 5 * 4
        assert cp["flash_attention"] == cm["flash_attention"] == 2
    finally:
        dist.destroy_process_group()
