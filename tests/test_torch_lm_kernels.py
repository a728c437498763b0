"""The plain versions of K7 (RMSNorm), K8 (flash attention) and K10
(RG-LRU scan) against the reference's oracles and its Pallas kernels.

The same numpy arrays go to ``repro.kernels.ref`` (``rmsnorm_ref``,
``flash_attention_ref``, ``rg_lru_ref``), to the reference's Pallas
kernels through ``repro.kernels.ops`` (interpret mode on the CPU, as
``tests/test_kernels.py`` runs them) and to the port's wrappers, which on
CPU tensors run their plain versions and count no launch. The cases
mirror ``tests/test_kernels.py``: causal and windowed, MQA and GQA, f32
and bf16, the strong-decay recurrence.

Tolerances (max |difference| / max |reference|):

* RMSNorm f32: 1e-6 — the same f32 arithmetic, the mean summed in
  another order. bf16: one bf16 ulp of each value — both sides round the
  same f32 result once.
* Attention f32: 1e-5 — scores, softmax and products in f32 on both
  sides, summed in other orders. bf16: 2e-2, the reference test's bound —
  the oracle rounds its scores and probabilities to bf16, the port keeps
  them in f32 and rounds the output once.
* RG-LRU: 2e-6 against the oracle — both compose the same (a, b) pairs in
  f32 over log2(S) levels of two different trees; 1e-5 against the
  sequential Pallas walk. K10's order (segments scanned from 0, composed
  as (A, h) pairs per tile, the carry across tiles), emulated here in
  torch: 1e-5 against both; with weak decay (the state carried over the
  whole sequence) 5 S 2^-24 of max |h|, the bound derived in
  ``tests/test_torch_cuda.py`` (an error made at a step reaches later
  steps scaled by decay factors <= 1: under 3 roundings a step on the
  kernel's side, 2 ulp of exp).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rg_lru as lru
from repro_torch.kernels import rmsnorm as k7

# the oracle's associative scan runs op by op without jit (seconds)
rg_lru_ref = jax.jit(jref.rg_lru_ref)

BF16 = {np.float32: (jnp.float32, torch.float32),
        "bf16": (jnp.bfloat16, torch.bfloat16)}


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


def _both(x: np.ndarray, dtype):
    jd, td = BF16[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def _rel(a, b) -> float:
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _max_bf16_ulps(a, b) -> float:
    """max |a - b| in units of b's bf16 ulp (8 significant bits)."""
    a, b = _np(a), _np(b)
    _, e = np.frexp(np.abs(b))
    ulp = np.ldexp(np.ones_like(b), e - 8)
    ulp = np.maximum(ulp, np.float32(2.0 ** -133))
    return float((np.abs(a - b) / ulp).max())


# ------------------------------------------------------------------ K7


@pytest.mark.parametrize("shape", [(4, 64), (3, 17, 128), (2, 5, 7, 256)])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_rmsnorm_plain_matches_oracle_and_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    xj, xt = _both(x, dtype)
    out = ops.rmsnorm(xt, torch.from_numpy(w))
    assert out.dtype == xt.dtype and tuple(out.shape) == shape
    want = jref.rmsnorm_ref(xj, jnp.asarray(w))
    pallas = jops.rmsnorm(xj, jnp.asarray(w), rows=8)
    if dtype == np.float32:
        assert _rel(out, want) <= 1e-6
        assert _rel(out, pallas) <= 1e-6
    else:
        assert _max_bf16_ulps(out, want) <= 1.0
        assert _max_bf16_ulps(out, pallas) <= 1.0


def test_rmsnorm_weight_keeps_its_dtype():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = ops.rmsnorm(xb, w.to(torch.bfloat16))
    want = jref.rmsnorm_ref(jnp.asarray(x.numpy()).astype(jnp.bfloat16),
                            jnp.asarray(w.numpy()).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _max_bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("d,itemsize,aligned,want", [
    (2560, 2, True, "one_pass"), (4096, 2, True, "one_pass"),
    (5120, 2, True, "one_pass"), (16384, 2, True, "one_pass"),
    (16392, 2, True, "two_pass"), (8192, 4, True, "one_pass"),
    (8196, 4, True, "two_pass"), (64, 4, True, "one_pass"),
    (100, 2, True, "two_pass"), (4096, 2, False, "two_pass")])
def test_rmsnorm_kernel_rule(d, itemsize, aligned, want):
    # K7's one-pass kernel takes aligned rows of whole 16-byte vectors up
    # to 1024 threads x 2 vectors; the two-pass kernel takes the rest
    assert k7.one_pass_max_d(itemsize) == 1024 * 2 * (16 // itemsize)
    assert k7.kernel_for(d, itemsize, aligned) == want


# ------------------------------------------------------------------ K8


def _qkv(b, h, hkv, s, d, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.4).astype(np.float32)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


@pytest.mark.parametrize("hkv", [1, 4])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_flash_attention_causal(hkv, dtype):
    q, k, v = _qkv(2, 4, hkv, 128, 32)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt)
    assert out.dtype == qt.dtype and tuple(out.shape) == q.shape
    want = jref.flash_attention_ref(qj, kj, vj)
    pallas = jops.flash_attention(qj, kj, vj, block_q=64, block_k=64)
    tol = 1e-5 if dtype == np.float32 else 2e-2
    assert _rel(out, want) <= tol
    assert _rel(out, pallas) <= tol


# the (heads, kv heads) of the dense and MoE configs served on the card at
# head dim 128: qwen1.5 (40, 40), llava (56, 8), qwen2 and command-r (64,
# 8), command-r-plus (96, 8), qwen3-moe (64, 4); group ratios 1, 7, 8, 12
# and 16, here with 2 kv heads each
@pytest.mark.parametrize("groups", [1, 7, 8, 12, 16])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_flash_attention_causal_group_ratios(groups, dtype):
    q, k, v = _qkv(1, 2 * groups, 2, 40, 128, seed=4 + groups)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dtype) for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt)
    assert out.dtype == qt.dtype and tuple(out.shape) == q.shape
    want = jref.flash_attention_ref(qj, kj, vj)
    assert _rel(out, want) <= (1e-5 if dtype == np.float32 else 2e-2)


@pytest.mark.parametrize("window", [64, 128])
def test_flash_attention_windowed(window):
    q, k, v = _qkv(1, 2, 1, 256, 32, seed=1)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              window=window)
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    window=window)
    pallas = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                  window=window, block_q=64, block_k=64)
    assert _rel(out, want) <= 1e-5
    assert _rel(out, pallas) <= 1e-5


@pytest.mark.parametrize("s,window", [(100, 0), (100, 32), (37, 64)])
def test_flash_attention_any_length(s, window):
    """The port takes any S (the Pallas kernel needs S divisible by its
    blocks): a ragged length against the oracle, GQA with 2 groups."""
    q, k, v = _qkv(2, 4, 2, s, 16, seed=2)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              window=window)
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    window=window)
    assert _rel(out, want) <= 1e-5


def test_flash_attention_scale_and_band_mask():
    q, k, v = _qkv(1, 2, 1, 24, 16, seed=3)
    scale = 0.3
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              window=5, scale=scale)
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    window=5, scale=scale)
    assert _rel(out, want) <= 1e-5
    m = fa.band_mask(6, 2)
    assert m.tolist() == [[j <= i and j > i - 2 for j in range(6)]
                          for i in range(6)]


# ------------------------------------------------------------------ K10


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 64)])
@pytest.mark.parametrize("c,ct", [(32, 32), (64, 32)])
def test_rg_lru(s, chunk, c, ct):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, s, c)).astype(np.float32)
    log_a = np.array(-jax.nn.softplus(jnp.asarray(x)))
    b = rng.standard_normal((2, s, c)).astype(np.float32)
    out = ops.rg_lru(torch.from_numpy(log_a), torch.from_numpy(b))
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, s, c)
    want = rg_lru_ref(jnp.asarray(log_a), jnp.asarray(b))
    pallas = jops.rg_lru(jnp.asarray(log_a), jnp.asarray(b), chunk=chunk,
                         c_tile=ct)
    assert _rel(out, want) <= 2e-6
    assert _rel(out, pallas) <= 1e-5


def test_rg_lru_strong_decay_stability():
    """Decay strong enough to underflow a cumprod (e^-512) stays finite and
    right: the doubling scan never divides."""
    s, c = 256, 16
    log_a = np.full((1, s, c), -2.0, np.float32)
    b = np.ones((1, s, c), np.float32)
    out = ops.rg_lru(torch.from_numpy(log_a), torch.from_numpy(b))
    want = rg_lru_ref(jnp.asarray(log_a), jnp.asarray(b))
    pallas = jops.rg_lru(jnp.asarray(log_a), jnp.asarray(b), chunk=64,
                         c_tile=16)
    assert np.isfinite(out.numpy()).all()
    assert _rel(out, want) <= 1e-5
    assert _rel(out, pallas) <= 1e-5
    fixed = 1.0 / (1.0 - math.exp(-2.0))
    assert abs(float(out[0, -1, 0]) - fixed) <= 1e-6 * fixed


def test_rg_lru_plain_is_the_sequential_recurrence():
    rng = np.random.default_rng(4)
    log_a = -rng.uniform(0, 3, (3, 50, 8)).astype(np.float32)
    b = rng.standard_normal((3, 50, 8)).astype(np.float32)
    h = np.zeros((3, 8), np.float64)
    seq = []
    for t in range(50):
        h = np.exp(log_a[:, t].astype(np.float64)) * h + b[:, t]
        seq.append(h)
    seq = np.stack(seq, axis=1)
    got = lru.rg_lru_plain(torch.from_numpy(log_a), torch.from_numpy(b))
    assert float(np.abs(got.numpy() - seq).max()) <= 1e-5 * np.abs(seq).max()


def _k10_order(log_a, b, segments, steps):
    """h by K10's order (csrc/rg_lru.cu), in plain torch: per tile of
    ``segments * steps`` steps, each segment scanned from 0 to its (A,
    h_end); the tile's carry-in pushed through the segments' pairs in
    ascending order gives each segment's entering state and the next
    tile's carry; each segment scanned again from its entering state.
    Steps past S are the identity step (log_a, b) = (0, 0)."""
    bsz, s, c = log_a.shape
    tile = segments * steps
    sp = -(-s // tile) * tile
    a = torch.ones(bsz, sp, c)
    a[:, :s] = torch.exp(log_a)
    bp = torch.zeros(bsz, sp, c)
    bp[:, :s] = b
    y = torch.empty(bsz, sp, c)
    carry = torch.zeros(bsz, c)
    for t0 in range(0, sp, tile):
        at = a[:, t0:t0 + tile].reshape(bsz, segments, steps, c)
        bt = bp[:, t0:t0 + tile].reshape(bsz, segments, steps, c)
        big_a = torch.ones(bsz, segments, c)
        h = torch.zeros(bsz, segments, c)
        for i in range(steps):
            h = at[:, :, i] * h + bt[:, :, i]
            big_a = big_a * at[:, :, i]
        enter = []
        for seg in range(segments):
            enter.append(carry)
            carry = big_a[:, seg] * carry + h[:, seg]
        h = torch.stack(enter, dim=1)
        for i in range(steps):
            h = at[:, :, i] * h + bt[:, :, i]
            y[:, t0:t0 + tile].view(bsz, segments, steps, c)[:, :, i] = h
    return y[:, :s]


# (segments, steps) of the kernel's tile and of a wider and a narrower one
K10_TILES = [(lru.SEGMENTS, lru.SEGMENT_STEPS), (4, 16), (2, 4)]
WEAK_LOG_A = (-1.3e-2, -1.25e-4)     # Griffin's trained decay, r = 1


@pytest.mark.parametrize("segments,steps", K10_TILES)
@pytest.mark.parametrize("s", [7, 3 * 128 + 5])
@pytest.mark.parametrize("weak", [False, True])
def test_rg_lru_kernel_order(segments, steps, s, weak):
    """K10's composition against the oracle and the sequential Pallas walk
    at lengths that are no multiple of the tile."""
    rng = np.random.default_rng(s + 7 * steps + weak)
    c = 24
    if weak:
        log_a = rng.uniform(*WEAK_LOG_A, (2, s, c)).astype(np.float32)
    else:
        x = rng.standard_normal((2, s, c)).astype(np.float32)
        log_a = np.array(-jax.nn.softplus(jnp.asarray(x)))
    b = rng.standard_normal((2, s, c)).astype(np.float32)
    got = _k10_order(torch.from_numpy(log_a), torch.from_numpy(b), segments,
                     steps)
    want = rg_lru_ref(jnp.asarray(log_a), jnp.asarray(b))
    pallas = jops.rg_lru(jnp.asarray(log_a), jnp.asarray(b), chunk=s,
                         c_tile=c)
    tol = 5 * s * 2.0 ** -24 if weak else 1e-5
    assert _rel(got, want) <= tol
    assert _rel(got, pallas) <= tol


# ------------------------------------------------------------ wrappers


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="rmsnorm"):
        ops.rmsnorm(x, torch.ones(4))
    with pytest.raises(ValueError, match="rmsnorm"):
        ops.rmsnorm(x.double(), torch.ones(8))
    with pytest.raises(ValueError, match="kernel"):
        k7.rmsnorm(x, torch.ones(8), kernel="three_pass")
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="flash_attention"):
        ops.flash_attention(q, torch.zeros(1, 3, 8, 16),
                            torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="flash_attention"):
        ops.flash_attention(q, torch.zeros(1, 1, 8, 16),
                            torch.zeros(1, 1, 8, 16), window=-1)
    with pytest.raises(ValueError, match="rg_lru"):
        ops.rg_lru(torch.zeros(1, 4, 2), torch.zeros(1, 4, 3))
    with pytest.raises(ValueError, match="rg_lru"):
        ops.rg_lru(torch.zeros(1, 4, 2).double(), torch.zeros(1, 4, 2))
