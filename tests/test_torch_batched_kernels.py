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

K4's and K5's card layout, one norm partial per tile of 2048 elements of
a row: the plain tile partials (``combine_err_batched_tile_partials``)
sum to the plain norm within 1e-6 and match the reference's
interpret-mode tile partials within 1e-6 (summation order); an emulation
of the kernels' work split and order gives them bit for bit for every
head, B and ragged N.
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


# ------------------------------------------------- K3's row split (card)


def _k3_coverage(rows, n, v, lead, blocks, unroll):
    """How often K3's vector path (``increment_row`` in csrc/rk_stage.cu)
    touches each element of a (rows, n) state whose first element lies
    ``lead`` elements past a 16-byte boundary, with ``blocks`` blocks of
    ``rk_stage.THREADS`` threads per row: the scalar head up to the row's
    first boundary, ``unroll`` vectors a thread and pass over the
    interior, the scalar tail."""
    seen = np.zeros((rows, n), np.int64)
    threads = blocks * rk_stage.THREADS
    g = np.arange(threads)
    for r in range(rows):
        head = min((v - (lead + r * n) % v) % v, n)
        units = (n - head) // v
        tail = head + units * v
        np.add.at(seen[r], g[g < head], 1)
        np.add.at(seen[r], tail + g[g < n - tail], 1)
        for u0 in range(0, max(units, 1), threads * unroll):
            for q in range(unroll):
                u = u0 + q * threads + g
                u = u[u < units]
                for i in range(v):
                    np.add.at(seen[r], head + u * v + i, 1)
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_k3_row_split_covers_each_element_once(dtype, rows):
    """Every element of every row exactly once, for N mod V in 0..V-1 and
    every start offset the vector path takes, with the wrapper's grid and
    with one block a row (the grid-stride loop)."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    for n in range(5000, 5000 + v):
        if (rows * n) % v:
            continue                # the scalar path
        for lead in range(v):
            for blocks in (rk_stage.increment_blocks(n, dtype, True),
                           1):
                seen = _k3_coverage(rows, n, v, lead, blocks,
                                    rk_stage.UNROLL)
                assert (seen == 1).all(), (n, lead, blocks)


def test_k3_path_decision_and_output_offset():
    """The vector path needs (rows * N) % V == 0 and one offset modulo 16
    bytes for z, k and out; out is allocated at z's offset."""
    buf = torch.zeros(8 * 4099 + 3)
    z = buf[1:1 + 8 * 4098].view(8, 4098)          # 4 bytes past 16
    kbuf = torch.zeros(2 * 8 * 4098 + 1)
    k = kbuf[1:].view(2, 8, 4098)
    out = rk_stage.empty_at_offset_of(z)
    assert out.shape == z.shape and out.is_contiguous()
    assert out.data_ptr() % 16 == z.data_ptr() % 16 == 4
    assert rk_stage.row_vectorized(8, 4098, torch.float32, z, k, out)
    assert not rk_stage.row_vectorized(8, 4098, torch.float32, z,
                                       torch.zeros(2, 8, 4098), out)
    zb = torch.zeros(3, 4098)
    assert not rk_stage.row_vectorized(3, 4098, torch.float32, zb, zb, zb)
    assert rk_stage.row_vectorized(3, 4096, torch.float32, zb, zb, zb)
    assert rk_stage.empty_at_offset_of(zb).data_ptr() % 16 == 0


# ------------------------------------- K4/K5's norm tiles (card layout)

ROW_NORM_RTOL = 1e-6
TILE_NS = (1003, 4097, 393_218)


@pytest.mark.parametrize("tab,dtype,rows,n",
                         [(t, d, r, n) for t in sorted(TABS)
                          for d in sorted(DTYPES) for r in (1, 3)
                          for n in (1003, 4097)])
def test_tile_partials_sum_to_the_plain_norm(tab, dtype, rows, n):
    """Each row's tile partials (K4's and K5's layout on the card) add up
    to the plain version's one-sum norm within ROW_NORM_RTOL (summation
    order), at the kernels' tile and at a tile of 256 (many tiles a
    row); P = ceil(N / tile)."""
    tab = TABS[tab]
    _, tdt = DTYPES[dtype]
    z, k, h = _inputs(rows * n + 2, tab.stages, rows, n)
    zt, kt, ht = torch.from_numpy(z).to(tdt), torch.from_numpy(k).to(tdt), \
        torch.from_numpy(h)
    rt = torch.from_numpy(np.geomspace(1e-2, 1e-4, rows).astype(np.float32))
    for tols in ((RTOL, ATOL), (rt, 0.1 * rt)):
        _, sq = rk_stage.combine_err_batched_plain(zt, kt, ht, tab.b,
                                                   tab.b_err, *tols)
        for tile in (rk_stage.NORM_TILE, 256):
            part = rk_stage.combine_err_batched_tile_partials(
                zt, kt, ht, tab.b, tab.b_err, *tols, tile)
            assert part.dtype == torch.float32
            assert tuple(part.shape) == (rows, -(-n // tile))
            assert _rel(part.sum(-1).numpy(), sq.numpy()) <= ROW_NORM_RTOL


@pytest.mark.parametrize("tab", sorted(TABS))
@pytest.mark.parametrize("n", [1003, 4097])
def test_tile_partials_match_the_reference_tiles(tab, n):
    """At the kernels' tile (the reference's _BLOCK = 2048) the partials
    have the reference's (B, n_tiles) shape, and each matches the
    reference's interpret-mode Pallas tile partial (K4's kernel at scalar
    tolerances, K5's at (B,) ones) within ROW_NORM_RTOL: the same terms,
    summed in another order."""
    tab = TABS[tab]
    rows = 3
    z, k, h = _inputs(n + 5, tab.stages, rows, n)
    zt, kt, ht = (torch.from_numpy(x) for x in (z, k, h))
    rt = np.geomspace(1e-2, 1e-4, rows).astype(np.float32)
    at = (rt * 1e-2).astype(np.float32)
    assert rk_stage.NORM_TILE == 2048
    forms = [((RTOL, ATOL), (RTOL, ATOL),
              jrk.rk_stage_combine_err_batched_pallas),
             ((torch.from_numpy(rt), torch.from_numpy(at)),
              (jnp.asarray(rt), jnp.asarray(at)),
              jrk.rk_stage_combine_err_batched_rowtol_pallas)]
    for tols_t, tols_j, pallas_fn in forms:
        part = rk_stage.combine_err_batched_tile_partials(
            zt, kt, ht, tab.b, tab.b_err, *tols_t, rk_stage.NORM_TILE)
        _, part_pal = pallas_fn(jnp.asarray(z), jnp.asarray(k),
                                jnp.asarray(h), tab.b, tab.b_err, *tols_j,
                                interpret=True)
        part_pal = np.asarray(part_pal)
        assert part.shape == part_pal.shape == (rows, -(-n // 2048))
        assert _rel(part.numpy(), part_pal) <= ROW_NORM_RTOL


def _tile_writes(length, head, v, unroll, tile, threads):
    """K4/K5's shared-memory map of one tile (``rk_stage_combine_err_
    batched_kernel`` in csrc/rk_stage.cu): for each slot of its
    ``tile + 8`` floats, the element of the tile written there (-2 never
    written, -1 a zero past the row's end), and how often each slot was
    written. ``head`` is the scalar head, ``length`` the tile's length."""
    src = np.full(tile + 8, -2, np.int64)
    count = np.zeros(tile + 8, np.int64)
    pad = (v - head) % v
    units = (length - head) // v
    tail = head + units * v
    tid = np.arange(threads)

    def write(slots, elems):
        np.add.at(count, slots, 1)
        src[slots] = elems

    q = np.arange(length, tile)
    write(pad + q, np.full(q.shape, -1))                 # zero fill
    for u0 in range(0, max(units, 1), threads * unroll):
        for j in range(unroll):
            u = u0 + j * threads + tid
            u = u[u < units]
            if v > 1:
                assert ((pad + head + u * v) % 4 == 0).all()   # float4
            for i in range(v):
                write(pad + head + u * v + i, head + u * v + i)
    write(pad + tid[tid < head], tid[tid < head])
    rest = tid[tid < length - tail]
    write(pad + tail + rest, tail + rest)
    return src, count, pad


def _emulate_tiles(x, off, v, unroll, tile, threads=rk_stage.THREADS):
    """A row's partials as the kernel forms them, from its squared scaled
    errors ``x`` (N,) f32, its first element ``off`` elements past a
    16-byte boundary, on the vector path of width v (1: the scalar path):
    the tile split above, then thread i's register tree over slots
    i + threads * m, warp 0's over i + 32 * m, and the shuffles."""
    n = x.shape[0]
    n_tiles = max(1, -(-n // tile))
    out = np.empty(n_tiles, np.float32)
    maps = {}
    for t in range(n_tiles):
        lo = t * tile
        length = min(tile, n - lo)
        head = min((v - (off + lo) % v) % v, length)
        if (length, head) not in maps:
            maps[(length, head)] = _tile_writes(length, head, v, unroll,
                                                tile, threads)
        src, count, pad = maps[(length, head)]
        assert (count[pad:pad + tile] == 1).all()
        assert (src[pad:pad + length] == np.arange(length)).all()
        slots = np.where(src >= 0, x[lo + np.maximum(src, 0)],
                         np.float32(0.0)).astype(np.float32)
        s = slots[pad:pad + tile]
        val = s.reshape(tile // threads, threads)           # [m, i]
        while val.shape[0] > 1:
            w = val.shape[0] // 2
            val = val[:w] + val[w:]
        c = val[0].reshape(threads // 32, 32)               # [m, lane]
        while c.shape[0] > 1:
            w = c.shape[0] // 2
            c = c[:w] + c[w:]
        lanes = c[0]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + np.concatenate([lanes[o:], lanes[32 - o:]])
        out[t] = lanes[0]
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", TILE_NS)
def test_k4_k5_tile_split_gives_one_rows_partials_bitwise(dtype, n):
    """The kernels' work split and order give one row's partials bit for
    bit the plain tile partials, whatever the row's head (every length 0
    to V - 1), B (1, 3, 8: its place in the batch, and the vector or
    scalar path by (B * N) % V) and the vectors a thread and pass (1, 2):
    each element lands once at its tile position, and the order is by
    position alone."""
    _, tdt = DTYPES[dtype]
    v = 16 // torch.empty((), dtype=tdt).element_size()
    tile = rk_stage.NORM_TILE
    z, k, h = _inputs(n, HEUN_EULER.stages, 1, n)
    zt, kt, ht = torch.from_numpy(z).to(tdt), torch.from_numpy(k).to(tdt), \
        torch.from_numpy(h)
    want = rk_stage.combine_err_batched_tile_partials(
        zt, kt, ht, HEUN_EULER.b, HEUN_EULER.b_err, RTOL, ATOL, tile)[0]
    _, r = rk_stage._combine_batched_f32(zt, kt, ht, HEUN_EULER.b,
                                         HEUN_EULER.b_err, RTOL, ATOL)
    x = (r * r)[0].numpy()
    want = want.numpy()
    seen = set()
    for rows in (1, 3, 8):
        vec = (rows * n) % v == 0
        for lead in range(v):
            for row in range(rows):
                off = (lead + row * n) % v
                for unroll in ((1, 2) if vec else (tile // rk_stage.THREADS,)):
                    key = (off if vec else 0, vec, unroll)
                    if key in seen:
                        continue
                    seen.add(key)
                    got = _emulate_tiles(x, off, v if vec else 1, unroll,
                                         tile)
                    np.testing.assert_array_equal(got, want, err_msg=str(
                        (rows, lead, row, unroll)))
    heads = {(v - o) % v for o, vec, _ in seen if vec}
    assert heads == set(range(v))


def test_tile_partials_pass_an_h0_row_and_refuse_odd_tiles():
    z, k, h = _inputs(11, DOPRI5.stages, 3, 1003)
    h[1] = 0.0
    zt, kt, ht = (torch.from_numpy(x) for x in (z, k, h))
    part = rk_stage.combine_err_batched_tile_partials(
        zt, kt, ht, DOPRI5.b, DOPRI5.b_err, RTOL, ATOL, 256)
    assert part.shape == (3, 4) and bool((part[1] == 0).all())
    assert bool((part[0] > 0).all())
    with pytest.raises(ValueError, match="power of two"):
        rk_stage.combine_err_batched_tile_partials(
            zt, kt, ht, DOPRI5.b, DOPRI5.b_err, RTOL, ATOL, 1000)
    assert [rk_stage.norm_tiles(m) for m in (0, 1, 2048, 2049, 393_218)] \
        == [1, 1, 1, 2, 193]


@pytest.mark.parametrize("n,p,stride", [(393_218, 193, 196),
                                        (393_216, 192, 192), (65, 1, 4)])
def test_norm_partials_rows_start_16_bytes_apart(n, p, stride):
    """K4/K5's partials: (B, P) with rows P rounded up to 4 floats apart, so
    every row starts 16-byte aligned and torch's per-row sum adds each
    row in the same order whatever its index."""
    part = rk_stage.norm_partials(3, n, "cpu")
    assert part.shape == (3, p) and part.stride() == (stride, 1)
    assert part.dtype == torch.float32
