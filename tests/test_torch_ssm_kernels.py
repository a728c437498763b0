"""K9's plain version (the port's ``ssd_chunked``) and the Mamba-2 pieces
against the reference.

The same numpy arrays go to the reference's oracles (``repro.kernels.ref``
``ssd_scan_ref`` and ``ssd_scan_sequential_ref``), to its Pallas kernel
through ``repro.kernels.ops.ssd_scan`` (interpret mode on the CPU, as
``tests/test_kernels.py`` runs it), to the reference model's
``ssd_chunked``/``ssd_decode_step``/``mamba2_block_apply`` and to the port,
whose K9 wrapper runs its plain version on CPU tensors and counts no
launch. The shapes mirror ``tests/test_kernels.py::test_ssd_scan`` ((64,
16) and (128, 32), one and two groups).

Tolerances:

* against the oracles and the interpret-mode kernel: rtol = atol = 1e-4,
  the reference test's bound (the sequential oracle and the Pallas
  kernel sum in other orders);
* y and h_last against the reference's ``ssd_chunked``, and the decode
  step and the block against the reference's: 1e-5 of max |reference| —
  the same f32 algorithm, summed in other orders (observed ≤ 1e-6);
* one scan at two chunk sizes: 1e-5 of max |y| (the chunked algebra is
  exact; only rounding differs);
* bf16 x, B and C: y is the f32 result rounded once to bf16, so within
  one bf16 ulp (2^-8 relative) of the f32 y on the same bf16 inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as jm2
from repro.models import ModelConfig as JModelConfig
from repro.models import RunConfig as JRunConfig
from repro_torch.convert import tree_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as k9
from repro_torch.models import mamba2 as tm2
from repro_torch.models.config import ModelConfig, RunConfig

TOL = 1e-5
ORACLE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _interpret_kernels():
    jops.set_interpret(True)
    yield
    jops.set_interpret(None)


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launches()
    yield
    assert all(v == 0 for v in ops.launch_counts().values()), \
        f"a CPU tensor launched a kernel: {ops.launch_counts()}"


def _rel(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _scan_inputs(b, s, h, p, g, n, seed=2, h0=False):
    """The reference test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, s, h, p))).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    bm = (0.5 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    cm = (0.5 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    out = [x, dt, a, bm, cm]
    if h0:
        out.append(rng.standard_normal((b, h, p, n)).astype(np.float32))
    return out


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32)])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_plain_matches_oracles_and_pallas(s, chunk, g):
    arrs = _scan_inputs(2, s, 4, 16, g, 8)
    y, h_last = ops.ssd_scan(*_t(*arrs), chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, s, 4, 16)
    assert h_last.dtype == torch.float32 and tuple(h_last.shape) == (2, 4,
                                                                      16, 8)
    want = jref.ssd_scan_ref(*_j(*arrs), chunk)
    seq = jref.ssd_scan_sequential_ref(*_j(*arrs))
    pallas = jops.ssd_scan(*_j(*arrs), chunk)
    for other in (want, seq, pallas):
        np.testing.assert_allclose(y.numpy(), np.asarray(other),
                                   rtol=ORACLE_TOL, atol=ORACLE_TOL)


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32)])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("h0", [False, True])
def test_ssd_chunked_matches_reference_y_and_state(s, chunk, g, h0):
    arrs = _scan_inputs(2, s, 4, 16, g, 8, seed=s + g, h0=h0)
    x, dt, a, bm, cm = arrs[:5]
    hj = jnp.asarray(arrs[5]) if h0 else None
    ht = torch.from_numpy(arrs[5]) if h0 else None
    y_r, h_r = jm2.ssd_chunked(*_j(x, dt, a, bm, cm), chunk, h0=hj)
    y_p, h_p = tm2.ssd_chunked(*_t(x, dt, a, bm, cm), chunk, h0=ht)
    assert _rel(y_p, y_r) <= TOL
    assert _rel(h_p, h_r) <= TOL
    # the wrapper's CPU route is the plain version
    y_w, h_w = ops.ssd_scan(*_t(x, dt, a, bm, cm), chunk, h0=ht)
    assert torch.equal(y_w, y_p) and torch.equal(h_w, h_p)


def _weak_decay_inputs(b, s, h, p, g, n, seed):
    """Long memory: dt log-uniform in [1e-3, 1e-2], a = -exp(N(0, 1)), so a
    chunk of 64 steps keeps most of its state and the carry dominates."""
    x, _, a, bm, cm = _scan_inputs(b, s, h, p, g, n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-2), (b, s, h))).astype(
        np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_carries_a_weakly_decaying_state(g):
    x, dt, a, bm, cm = _weak_decay_inputs(2, 512, 4, 16, g, 8, seed=5 + g)
    y_p, h_p = tm2.ssd_chunked(*_t(x, dt, a, bm, cm), 64)
    y_r, h_r = jm2.ssd_chunked(*_j(x, dt, a, bm, cm), 64)
    assert _rel(y_p, y_r) <= TOL and _rel(h_p, h_r) <= TOL
    seq = jref.ssd_scan_sequential_ref(*_j(x, dt, a, bm, cm))
    np.testing.assert_allclose(y_p.numpy(), np.asarray(seq),
                               rtol=ORACLE_TOL, atol=ORACLE_TOL)
    # the inputs do what they are for: each chunk scanned from a zero
    # state (no carry) is far from the chunked scan
    nc = 512 // 64
    alone = torch.cat([tm2.ssd_chunked(
        *_t(*(v[:, c * 64:(c + 1) * 64] for v in (x, dt)), a,
            *(v[:, c * 64:(c + 1) * 64] for v in (bm, cm))), 64)[0]
        for c in range(nc)], dim=1)
    assert _rel(alone, y_p) > 0.1


def test_ssd_chunked_groups_map_heads_by_blocks():
    """Head h reads group h // (H/G) (``jnp.repeat``), not h % G: with two
    groups, heads 0-1 see group 0 and heads 2-3 group 1."""
    x, dt, a, bm, cm = _scan_inputs(1, 32, 4, 8, 2, 8, seed=5)
    y2, h2 = tm2.ssd_chunked(*_t(x, dt, a, bm, cm), 16)
    for head in range(4):
        grp = head // 2
        y1, h1 = tm2.ssd_chunked(
            *_t(x[:, :, head:head + 1], dt[:, :, head:head + 1],
                a[head:head + 1], bm[:, :, grp:grp + 1],
                cm[:, :, grp:grp + 1]), 16)
        assert _rel(y2[:, :, head:head + 1], y1) <= TOL
        assert _rel(h2[:, head:head + 1], h1) <= TOL


def test_ssd_chunked_is_chunk_size_invariant():
    arrs = _scan_inputs(2, 64, 4, 16, 1, 8, seed=11)
    y16, h16 = tm2.ssd_chunked(*_t(*arrs), 16)
    y64, h64 = tm2.ssd_chunked(*_t(*arrs), 64)
    assert _rel(y16, y64) <= TOL and _rel(h16, h64) <= TOL


def test_ssd_chunked_strong_decay_stays_finite():
    """dt·a near -16 per step: cumsums reach the thousands and exp of the
    upper triangle's differences would overflow; the mask comes first."""
    x, dt, a, bm, cm = _scan_inputs(1, 256, 2, 8, 1, 8, seed=3)
    dt = np.full_like(dt, 4.0)
    a = np.full_like(a, -16.0)
    y, h_last = tm2.ssd_chunked(*_t(x, dt, a, bm, cm), 256)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(
        h_last).all())
    y_r, _ = jm2.ssd_chunked(*_j(x, dt, a, bm, cm), 256)
    assert _rel(y, y_r) <= TOL


def test_ssd_scan_bf16_rounds_y_once():
    x, dt, a, bm, cm = _scan_inputs(2, 64, 4, 16, 1, 16, seed=7)
    xt, bt, ct = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, bm, cm))
    y, h_last = ops.ssd_scan(xt, torch.from_numpy(dt), torch.from_numpy(a),
                             bt, ct, 16)
    assert y.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    y32, h32 = tm2.ssd_chunked(xt.float(), torch.from_numpy(dt),
                               torch.from_numpy(a), bt.float(), ct.float(),
                               16)
    assert torch.equal(h_last, h32)
    assert float(((y.float() - y32).abs()
                  / y32.abs().clamp_min(1e-30)).max()) <= 2.0 ** -8


# ``ssd_chunked`` as it was before the split into the three kernels'
# plain versions, op for op: the composition must give its bits
def _ssd_chunked_frozen(x, dt, a, b_mat, c_mat, chunk, h0=None):
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    nc = s // chunk
    rep = h // g
    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtc = dt.float().reshape(bsz, nc, chunk, h)
    bf = torch.repeat_interleave(b_mat.float(), rep, dim=2).reshape(
        bsz, nc, chunk, h, n)
    cf = torch.repeat_interleave(c_mat.float(), rep, dim=2).reshape(
        bsz, nc, chunk, h, n)
    da = dtc * a.float()[None, None, None, :]
    da_cum = k9.chunk_cumsum(da, 2)
    da_total = da_cum[:, :, -1]
    l_mat = torch.exp(k9._segsum(da_cum.transpose(2, 3)))
    cb = torch.einsum("bcqhn,bckhn->bchqk", cf, bf)
    y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", cb * l_mat, dtc, xf)
    decay_to_end = torch.exp(da_total[:, :, None, :] - da_cum)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", bf,
                          dtc * decay_to_end, xf)
    hc = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hc)
        hc = hc * torch.exp(da_total[:, c])[..., None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)
    decay_from_start = torch.exp(da_cum)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cf, h_prev,
                           decay_from_start)
    return (y_diag + y_inter).reshape(bsz, s, h, p), hc


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32)])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("weak", [False, True])
def test_ssd_chunked_is_the_pre_split_arithmetic_bitwise(s, chunk, g, h0,
                                                         weak):
    arrs = _scan_inputs(2, s, 4, 16, g, 8, seed=s + g, h0=h0)
    if weak:
        arrs[:5] = _weak_decay_inputs(2, s, 4, 16, g, 8, seed=s + g)
    ts = _t(*arrs)
    h0t = ts[5] if h0 else None
    y, h_last = k9.ssd_chunked(*ts[:5], chunk, h0=h0t)
    y_f, h_f = _ssd_chunked_frozen(*ts[:5], chunk, h0=h0t)
    assert torch.equal(y, y_f) and torch.equal(h_last, h_f)


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32)])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("h0", [False, True])
def test_ssd_parts_match_the_reference_chunked_scan(s, chunk, g, h0):
    """Each plain part against the quantity the reference's ``ssd_chunked``
    builds: cs against its within-chunk cumsum of dt·a; S_c against its
    h_last over chunk c alone from a zero state (0·e + S_c = S_c); the
    state before chunk c against its h_last over chunks 0..c-1 from h0;
    h_last and y against its outputs. 1e-5 of max |reference|."""
    arrs = _scan_inputs(2, s, 4, 16, g, 8, seed=3 * s + g, h0=h0)
    x, dt, a, bm, cm = arrs[:5]
    hj = jnp.asarray(arrs[5]) if h0 else None
    ht = torch.from_numpy(arrs[5]) if h0 else None
    nc = s // chunk
    cs, states = k9.chunk_states(*_t(x, dt, a, bm), chunk)
    assert tuple(cs.shape) == (2, s, 4) and tuple(states.shape) == (
        2, nc, 4, 16, 8)
    da = jnp.asarray(dt).reshape(2, nc, chunk, 4) * jnp.asarray(a)
    cs_r = jnp.cumsum(da, axis=2).reshape(2, s, 4)
    assert _rel(cs, cs_r) <= TOL
    h_prev, h_last = k9.state_pass(states, cs, chunk, h0=ht)
    y = k9.chunk_outputs(*_t(x, dt), cs, *_t(bm, cm), h_prev, chunk)
    y_r, h_r = jm2.ssd_chunked(*_j(x, dt, a, bm, cm), chunk, h0=hj)
    assert _rel(y, y_r) <= TOL and _rel(h_last, h_r) <= TOL
    for c in range(nc):
        part = slice(c * chunk, (c + 1) * chunk)
        _, s_r = jm2.ssd_chunked(*_j(x[:, part], dt[:, part], a,
                                     bm[:, part], cm[:, part]), chunk)
        assert _rel(states[:, c], s_r) <= TOL, c
        if c == 0:
            want = arrs[5] if h0 else np.zeros((2, 4, 16, 8), np.float32)
            assert np.array_equal(h_prev[:, 0].numpy(), want)
        else:
            upto = slice(0, c * chunk)
            _, p_r = jm2.ssd_chunked(*_j(x[:, upto], dt[:, upto], a,
                                         bm[:, upto], cm[:, upto]), chunk,
                                     h0=hj)
            assert _rel(h_prev[:, c], p_r) <= TOL, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0", [False, True])
def test_ssd_part_wrappers_compose_to_the_scan_on_the_cpu(dtype, h0):
    """On CPU tensors the three kernels' wrappers run their plain versions,
    count no launch, and compose to ``ssd_scan`` bit for bit."""
    arrs = _scan_inputs(2, 64, 4, 16, 2, 16, seed=13, h0=h0)
    x, dt, a, bm, cm = _t(*arrs[:5])
    x, bm, cm = x.to(dtype), bm.to(dtype), cm.to(dtype)
    ht = torch.from_numpy(arrs[5]) if h0 else None
    cs, states = k9.ssd_chunk_state(x, dt, a, bm, 16)
    h_prev, h_last = k9.ssd_state_pass(states, cs, 16, h0=ht)
    y = k9.ssd_chunk_scan(x, dt, cs, bm, cm, h_prev, 16)
    y_w, h_w = ops.ssd_scan(x, dt, a, bm, cm, 16, h0=ht)
    assert y.dtype == dtype
    assert torch.equal(y, y_w) and torch.equal(h_last, h_w)


def test_ssd_part_wrappers_refuse_bad_inputs():
    x, dt, a, bm, cm = _t(*_scan_inputs(1, 32, 4, 8, 2, 8))
    cs, states = k9.ssd_chunk_state(x, dt, a, bm, 16)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        k9.ssd_chunk_state(x, dt, a, bm, 12)
    with pytest.raises(ValueError, match="states"):
        k9.ssd_state_pass(states, cs, 8)
    with pytest.raises(ValueError, match="float32"):
        k9.ssd_state_pass(states.double(), cs.double(), 16)
    with pytest.raises(ValueError, match="h_prev"):
        k9.ssd_chunk_scan(x, dt, cs, bm, cm, states[:, :1], 16)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(4)
    b, h, p, g, n = 2, 4, 16, 2, 8
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, h)), 0).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h))).astype(np.float32)
    bv, cv = (rng.standard_normal((b, g, n)).astype(np.float32)
              for _ in range(2))
    st = rng.standard_normal((b, h, p, n)).astype(np.float32)
    y_r, s_r = jm2.ssd_decode_step(*_j(x, dt, a, bv, cv, st))
    y_p, s_p = tm2.ssd_decode_step(*_t(x, dt, a, bv, cv, st))
    assert _rel(y_p, y_r) <= TOL and _rel(s_p, s_r) <= TOL


def test_softplus_is_jax_softplus():
    """logaddexp(x, 0) on both sides: within 2 f32 ulps (the two
    libraries' log1p/exp round differently; below the smallest normal
    f32 one side may flush to 0), also above 20 where
    ``F.softplus`` would switch to x."""
    v = np.concatenate([np.linspace(-40, 40, 801),
                        [-100.0, 19.9, 20.0, 20.1, 100.0]]).astype(np.float32)
    np.testing.assert_allclose(
        tm2.softplus(torch.from_numpy(v)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(v))), rtol=2.4e-7,
        atol=np.finfo(np.float32).tiny)


BLOCK_CFG = dict(name="t", family="ssm", n_layers=1, d_model=32, vocab=64,
                 ssm_state=8, ssm_head_dim=8, ssm_chunk=8, ssm_ngroups=2)


@pytest.mark.parametrize("s", [5, 16, 12])
def test_mamba2_block_matches_reference_in_every_mode(s):
    """Train and prefill (padded to the chunk when S is not a multiple),
    the prefill caches, and three decode steps from them."""
    jcfg = JModelConfig(**BLOCK_CFG)
    tcfg = ModelConfig(**BLOCK_CFG)
    from repro.models.common import init_params as jinit
    pj = jinit(jm2.mamba2_defs(jcfg, jnp.float32), jax.random.PRNGKey(3))
    pt = tree_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    jr = JRunConfig(compute_dtype=jnp.float32)
    tr = RunConfig(compute_dtype=torch.float32)
    x = np.random.default_rng(s).standard_normal((2, s + 3, 32)).astype(
        np.float32)
    for mode in ("train", "prefill"):
        y_r, c_r = jm2.mamba2_block_apply(pj, jnp.asarray(x[:, :s]), jcfg,
                                          jr, mode=mode)
        with torch.no_grad():
            y_p, c_p = tm2.mamba2_block_apply(pt, torch.from_numpy(
                x[:, :s]), tcfg, tr, mode=mode)
        assert _rel(y_p, y_r) <= TOL, mode
    for key in ("conv", "ssm"):
        assert _rel(c_p[key], c_r[key]) <= TOL, key
    for j in range(3):
        y_r, c_r = jm2.mamba2_block_apply(
            pj, jnp.asarray(x[:, s + j:s + j + 1]), jcfg, jr, mode="decode",
            cache=c_r)
        with torch.no_grad():
            y_p, c_p = tm2.mamba2_block_apply(
                pt, torch.from_numpy(x[:, s + j:s + j + 1]), tcfg, tr,
                mode="decode", cache=c_p)
        assert _rel(y_p, y_r) <= TOL, f"decode step {j}"
        for key in ("conv", "ssm"):
            assert _rel(c_p[key], c_r[key]) <= TOL, (j, key)


def test_mamba2_defs_and_cache_defs_match_reference():
    from repro.models.common import ParamDef as JParamDef
    from repro_torch.models.common import map_defs
    jcfg, tcfg = JModelConfig(**BLOCK_CFG), ModelConfig(**BLOCK_CFG)
    leaf = lambda d: isinstance(d, JParamDef)       # noqa: E731
    for jdefs, tdefs in (
            (jm2.mamba2_defs(jcfg, jnp.bfloat16),
             tm2.mamba2_defs(tcfg, torch.bfloat16)),
            (jm2.mamba2_cache_defs(jcfg, 3), tm2.mamba2_cache_defs(tcfg, 3))):
        want = jax.tree.map(lambda d: (d.shape, str(np.dtype(d.dtype)),
                                       d.init), jdefs, is_leaf=leaf)
        got = map_defs(lambda d: (d.shape, str(d.dtype)[6:], d.init), tdefs)
        assert got == want


def test_uniform_ssm_init_is_log_of_one_to_sixteen():
    from repro_torch.models.common import ParamDef, init_params
    out = init_params({"a_log": ParamDef((4096,), torch.float32,
                                         init="uniform_ssm")},
                      torch.Generator().manual_seed(0), "cpu")["a_log"]
    a = torch.exp(out)
    assert float(a.min()) >= 1.0 and float(a.max()) <= 16.0
    assert abs(float(a.mean()) - 8.5) < 0.3


def test_ssd_scan_wrapper_refuses_bad_inputs():
    x, dt, a, bm, cm = _t(*_scan_inputs(1, 32, 4, 8, 2, 8))
    with pytest.raises(ValueError, match="not divisible by chunk"):
        k9.ssd_scan(x, dt, a, bm, cm, 12)
    with pytest.raises(ValueError, match="G must divide H"):
        k9.ssd_scan(x, dt, a, bm[:, :, :1].expand(1, 32, 3, 8), cm[:, :, :1]
                    .expand(1, 32, 3, 8), 16)
    with pytest.raises(ValueError, match="one dtype"):
        k9.ssd_scan(x, dt, a, bm.to(torch.bfloat16), cm, 16)
    with pytest.raises(ValueError, match="float32"):
        k9.ssd_scan(x, dt.double(), a, bm, cm, 16)
    with pytest.raises(ValueError, match="h0 must be"):
        k9.ssd_scan(x, dt, a, bm, cm, 16, h0=torch.zeros(1, 4, 8, 4))
