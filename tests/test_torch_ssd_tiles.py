"""K9.3's wgmma kernel on the CPU: its tile rule, its kernel rule, its
barrier protocol, its roundings, and the build's digest of the shared
header.

``csrc/ssd_scan.cu``'s ``ssd_chunk_scan_wgmma`` covers a chunk with blocks
of up to 256 query rows, each split into 64-row query blocks that its two
consumer warpgroups own (``ssd_wg_of``), and walks, for each query block,
the key tiles ``ssd_tiles`` names: all up to the diagonal, the interior
ones without a mask. The Python twins (``ssd_scan.chunk_tiles``,
``ssd_scan.warpgroup_of``) are held here against the causal mask, against
the source's text and constants, and against the load the warpgroups
carry. A model of the kernel's barriers (C's, and the B and x ring's full
and empty mbarriers) runs every block of many chunk lengths, key tiles,
stages and warpgroup counts to its end, and finds a planted deadlock. An
emulation of the kernel's arithmetic on the CPU (the key-tile order, the
two-factor decay, M and h_prev as bf16 hi + lo, f32 sums, y rounded once)
is held against ``chunk_outputs``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import ssd_scan as k9

# chunk lengths and key tiles the rule is held at (each chunk a multiple
# of both 64 and the tile, as the kernel requires)
CHUNKS = [64, 128, 192, 256, 320, 512, 1024]
BKS = [32, 64, 128]
CHUNK_TILES = [(q, bk) for q in CHUNKS for bk in BKS if q % bk == 0]


def _blocks(q, rows):
    """(first row, query blocks) of each block of a chunk of q rows."""
    return [(r0, min(rows, q - r0) // 64) for r0 in range(0, q, rows)]


@pytest.mark.parametrize("q,bk", CHUNK_TILES)
def test_chunk_tiles_cover_each_causal_pair_once_and_mask_the_diagonal(q, bk):
    rows = k9.source_config()["rows"]
    seen = np.zeros((q, q), dtype=np.int64)
    i = np.arange(q)[:, None]
    j = np.arange(q)[None, :]
    for r0, nb in _blocks(q, rows):
        for r in range(nb):
            q0 = r0 + 64 * r
            hi, ihi = k9.chunk_tiles(q0, bk)
            assert 0 <= hi < q // bk and -1 <= ihi < hi
            for t in range(hi + 1):
                live = (i[q0:q0 + 64] >= j[:, t * bk:(t + 1) * bk])
                # interior exactly when every key is live for every row
                assert (t <= ihi) == bool(live.all()), (q0, t)
                seen[q0:q0 + 64, t * bk:(t + 1) * bk] += live
            # no tile past hi holds a live pair
            assert not (i[q0:q0 + 64] >= j[:, (hi + 1) * bk:]).any()
            if bk == 64:   # one masked tile, the diagonal one
                assert (hi, ihi) == (q0 // 64, q0 // 64 - 1)
    assert np.array_equal(seen, (i >= j).astype(np.int64))


@pytest.mark.parametrize("q", CHUNKS)
def test_warpgroups_own_each_query_block_once_and_share_the_key_tiles(q):
    cfg = k9.source_config()
    slots = cfg["rows"] // 64 // cfg["nwg"]
    for r0, nb in _blocks(q, cfg["rows"]):
        owners = [k9.warpgroup_of(r, nb, cfg["nwg"]) for r in range(nb)]
        assert all(0 <= w < cfg["nwg"] for w in owners)
        assert max(owners.count(w) for w in range(cfg["nwg"])) <= slots
        tiles = [sum(k9.chunk_tiles(r0 + 64 * r, cfg["bk"])[0] + 1
                     for r in range(nb) if owners[r] == w)
                 for w in range(cfg["nwg"])]
        if nb == 4:   # heaviest with lightest: equal key tiles
            assert tiles[0] == tiles[1]
        if nb >= 2:   # both warpgroups work
            assert min(tiles) > 0
    # the main path's chunk of 256: rows 0-63 with 192-255, 64-127 with
    # 128-191, 5 key tiles of 64 each
    assert [k9.warpgroup_of(r, 4, 2) for r in range(4)] == [0, 1, 1, 0]
    assert k9.warpgroup_of(0, 4, 1) == k9.warpgroup_of(3, 4, 1) == 0


def test_rules_and_constants_match_the_source():
    cfg = k9.source_config()
    assert cfg == {"p": 64, "n": 128, "rows": 256, "nwg": 2, "bk": 64,
                   "stages": 2}
    text = (build.CSRC_DIR / "ssd_scan.cu").read_text()
    # the tile rule, the warpgroup rule and the kernel rule as the twins
    # state them
    assert "hi = (q0 + 63) / bk;" in text
    assert "ihi = (q0 + 1) / bk - 1;" in text
    assert "if (nwg == 1) return 0;\n  if (nb == 2) return r;\n" \
           "  return (r < nb - 1 - r ? r : nb - 1 - r) % 2;" in text
    assert "P == SSD_WG_P && N == SSD_WG_N && Q % 64 == 0 ? 2 : 1" in text
    assert "#define SSD_WG_P 64" in text and "#define SSD_WG_N 128" in text
    # a block's shared memory at the main path's chunk (ssd_wg_smem: C,
    # the state's hi and lo tiles, the ring, the barriers (C's, four a
    # stage), cs, dt and wk) fits the 227 KB a block may have, one block an
    # SM
    q = 256
    smem = 1024 + min(q, cfg["rows"]) * cfg["n"] * 2 \
        + 2 * cfg["p"] * cfg["n"] * 2 \
        + cfg["stages"] * cfg["bk"] * (cfg["n"] + cfg["p"]) * 2 \
        + 8 * (1 + 4 * cfg["stages"]) + 3 * q * 4
    assert smem == 151_624 and smem <= 227 * 1024


@pytest.mark.parametrize("p,n,q,want", [
    (64, 128, 256, "wgmma"), (64, 128, 64, "wgmma"), (64, 128, 128, "wgmma"),
    (64, 128, 512, "wgmma"), (64, 128, 16, "mma_sync"),
    (64, 128, 32, "mma_sync"), (64, 128, 48, "mma_sync"),
    (64, 128, 80, "mma_sync"), (16, 16, 16, "mma_sync"),
    (16, 16, 64, "mma_sync"), (16, 16, 256, "mma_sync")])
def test_kernel_for(p, n, q, want):
    assert k9.kernel_for(p, n, q) == want
    assert want in k9.KERNELS


# ----------------------------------------------------- the ring's barriers

def _programs(q0_block, nb, bk, nwg, late_b=False):
    """The producer's and each consumer warpgroup's barrier operations for
    the block of nb query blocks from chunk row q0_block, in
    ssd_chunk_scan_wgmma's order. The producer loads C, then B(j) and x(j)
    of each key tile, each once its stage's readers released the key tile
    ``stages`` before it. A warpgroup lays out the block's state with the
    other (one named-barrier sync: in its first step, after the first S is
    issued; at once where it has no query block), waits for C before its
    first S, then per step (slot k on key tile j, tile-major, lightest
    slot first) waits for B(j), then for x of the step before (whose M x
    it issues), releases B(j) after the key tile's last slot's S and x
    after its last M x; then the last M x, then passes the block's key
    tiles past its own. ``late_b`` plants a fault: warpgroup 0 releases
    its B stages only at its end."""
    jmax = (q0_block + 64 * nb - 1) // bk
    prod = [("load", "c", 0)]
    for j in range(jmax + 1):
        prod += [("free", "b", j), ("load", "b", j),
                 ("free", "x", j), ("load", "x", j)]
    progs = [prod]
    for w in range(nwg):
        ops, held = [], []
        slots = [k9.chunk_tiles(q0_block + 64 * r, bk)[0]
                 for r in range(nb) if k9.warpgroup_of(r, nb, nwg) == w]
        last = len(slots) - 1
        hi_last = slots[-1] if slots else -1
        pk = pj = -1
        if not slots:
            ops.append(("sync", 1))
        for j in range(hi_last + 1):
            for k, hi in enumerate(slots):
                if j > hi:
                    continue
                if pk < 0:
                    ops.append(("wait", "c", 0))
                ops.append(("wait", "b", j))
                ops.append(("sync", 1) if pk < 0 else ("wait", "x", pj))
                if k == last:
                    (held if late_b and w == 0 else ops).append(
                        ("release", "b", j))
                if pk == last:
                    ops.append(("release", "x", pj))
                pk, pj = k, j
        if pk >= 0:
            ops += [("wait", "x", pj), ("release", "x", pj)]
        for j in range(hi_last + 1, jmax + 1):
            ops += [("wait", "b", j), ("wait", "x", j),
                    ("release", "b", j), ("release", "x", j)]
        progs.append(ops + held)
    return progs


def _run(progs, stages, readers):
    """Steps every program while one can move; True when all end with each
    key tile released once by every reader and no named-barrier arrival
    left. A ring stage is free once every reader has released the key tile
    ``stages`` before; the named barrier completes when every consumer
    warpgroup has synced on it."""
    pc = [0] * len(progs)
    loaded, released = set(), {}
    count, phase, parked = 0, 0, {}
    while True:
        moved = False
        for a, prog in enumerate(progs):
            if pc[a] >= len(prog):
                continue
            if a in parked:
                if phase > parked[a]:
                    del parked[a]
                    pc[a] += 1
                    moved = True
                continue
            op = prog[pc[a]]
            if op[0] == "free":
                prev = (op[1], op[2] - stages)
                if prev[1] >= 0 and released.get(prev, 0) < readers:
                    continue
            elif op[0] == "load":
                loaded.add(op[1:])
            elif op[0] == "wait":
                if op[1:] not in loaded:
                    continue
            elif op[0] == "release":
                released[op[1:]] = released.get(op[1:], 0) + 1
            else:
                count += 1
                if count == readers:
                    count = 0
                    phase += 1
                else:
                    parked[a] = phase
                    moved = True
                    continue
            pc[a] += 1
            moved = True
        if all(p >= len(prog) for p, prog in zip(pc, progs)):
            tiles = {t for t in loaded if t[0] != "c"}
            return not parked and count == 0 \
                and all(released.get(t, 0) == readers for t in tiles) \
                and len(released) == len(tiles)
        if not moved:
            return False


@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("nwg", [1, 2])
@pytest.mark.parametrize("bk", BKS)
def test_ring_barriers_neither_deadlock_nor_leave_releases(bk, nwg, stages):
    rows = k9.source_config()["rows"]
    for q in CHUNKS:
        if q % bk:
            continue
        for r0, nb in _blocks(q, rows):
            progs = _programs(r0, nb, bk, nwg)
            assert _run(progs, stages, nwg), (q, r0)


def test_the_barrier_model_finds_a_deadlock():
    # B's stages held to the end by one warpgroup: the producer cannot
    # refill a stage, the warpgroup waits for the key tile it would bring
    assert _run(_programs(0, 4, 64, 2), 2, 2)
    assert not _run(_programs(0, 4, 64, 2, late_b=True), 2, 2)


# --------------------------------------------------------- the roundings

def _split(v):
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _emulate(x, dt, cs, bm, cm, h_prev, q, bk):
    """ssd_chunk_scan_wgmma's arithmetic on the CPU in f32, G = 1: per
    chunk and head, C h_prevᵀ as hi + lo and scaled by e^{cs_i}; per 64-row
    query block the key tiles of ``chunk_tiles`` in order, S = C Bᵀ, the
    decay (interior: e^{cs_i - cs_j1} · e^{cs_j1 - cs_j} dt_j; masked: the
    mask before the exp), M as hi + lo bf16 against x; y rounded to bf16
    once."""
    bsz, s, h, p = x.shape
    y = torch.empty(bsz, s, h, p)
    for b in range(bsz):
        for c in range(s // q):
            rows = slice(c * q, (c + 1) * q)
            cc, bb = cm[b, rows, 0].float(), bm[b, rows, 0].float()
            for hh in range(h):
                xs, css = x[b, rows, hh].float(), cs[b, rows, hh]
                dts = dt[b, rows, hh]
                hhi, hlo = _split(h_prev[b, c, hh])
                yc = (cc @ hhi.T + cc @ hlo.T) * torch.exp(css)[:, None]
                j1 = torch.arange(q) | (bk - 1)
                wk = torch.exp(css[j1] - css) * dts
                for q0 in range(0, q, 64):
                    hi, ihi = k9.chunk_tiles(q0, bk)
                    ci = css[q0:q0 + 64]
                    for t in range(hi + 1):
                        keys = slice(t * bk, (t + 1) * bk)
                        sm = cc[q0:q0 + 64] @ bb[keys].T
                        if t <= ihi:
                            r = torch.exp(ci - css[(t + 1) * bk - 1])
                            m = sm * r[:, None] * wk[keys][None, :]
                        else:
                            ii = torch.arange(q0, q0 + 64)[:, None]
                            jj = torch.arange(t * bk, (t + 1) * bk)[None, :]
                            ex = torch.where(jj <= ii, ci[:, None]
                                             - css[keys][None, :], 0.0)
                            m = torch.where(jj <= ii, sm * torch.exp(ex)
                                            * dts[keys][None, :], 0.0)
                        mhi, mlo = _split(m)
                        yc[q0:q0 + 64] += mhi @ xs[keys] + mlo @ xs[keys]
                y[b, rows, hh] = yc
    return y


def test_kernel_roundings_stay_well_under_the_tolerance():
    """At (1, 512, 2, 64), state 128, chunk 256, weak decay (a chunk keeps
    about e^-1 of its state, so C h_prevᵀ carries most of y), the emulated
    kernel lands 2.6e-6 of max |y| from ``chunk_outputs`` before y's
    rounding and 9.8e-7 beyond one bf16 ulp after it (bounds here 5e-6 and
    2e-6), two orders under the card tests' 1e-4."""
    rng = np.random.default_rng(33)
    b, s, h, p, n, q = 1, 512, 2, 64, 128, 256
    x = torch.from_numpy(0.5 * rng.standard_normal((b, s, h, p))).to(
        torch.bfloat16)
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(1e-2),
                                             (b, s, h)))).float()
    a = torch.from_numpy(-np.exp(rng.standard_normal(h))).float()
    bm = torch.from_numpy(0.5 * rng.standard_normal((b, s, 1, n))).to(
        torch.bfloat16)
    cm = torch.from_numpy(0.5 * rng.standard_normal((b, s, 1, n))).to(
        torch.bfloat16)
    h0 = torch.from_numpy(rng.standard_normal((b, h, p, n))).float()
    cs, states = k9.chunk_states(x, dt, a, bm, q)
    h_prev, _ = k9.state_pass(states, cs, q, h0=h0)
    want = k9.chunk_outputs(x, dt, cs, bm, cm, h_prev, q)
    got = _emulate(x, dt, cs, bm, cm, h_prev, q, k9.source_config()["bk"])
    scale = float(want.abs().max())
    pre = float((got - want).abs().max()) / scale
    yb, wb = got.to(torch.bfloat16).float(), want.to(torch.bfloat16)
    _, e = torch.frexp(wb.float().abs())
    beyond = (yb - wb.float()).abs() - torch.ldexp(torch.ones_like(yb), e - 8)
    post = float(beyond.clamp_min(0.0).max()) / scale
    assert pre <= 5e-6 and post <= 2e-6, (pre, post)
    # the carried state matters here: without it y moves by far more
    alone = k9.chunk_outputs(x, dt, cs, bm, cm, torch.zeros_like(h_prev), q)
    assert float((alone - want).abs().max()) / scale > 0.1


# ------------------------------------------------------ the build's digest

def test_an_edited_header_changes_the_library_name(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    _, first = build._target("k")
    assert build._target("k")[1] == first
    (tmp_path / "h.cuh").write_text("// two\n")
    _, second = build._target("k")
    assert second != first
    (tmp_path / "h.cuh").write_text("// one\n")
    assert build._target("k")[1] == first
    (tmp_path / "g.cuh").write_text("// another header\n")
    assert build._target("k")[1] not in (first, second)
    # headers are not sources: only *.cu builds
    assert build.sources() == ["k"]


def test_the_port_builds_each_cu_and_shares_one_header():
    assert build.sources() == ["flash_attention", "rg_lru", "rk_stage",
                               "rmsnorm", "ssd_scan"]
    assert sorted(p.name for p in build.CSRC_DIR.glob("*.cuh")) == [
        "sm90.cuh"]
    for name in ("flash_attention", "ssd_scan"):
        assert '#include "sm90.cuh"' in (build.CSRC_DIR
                                         / f"{name}.cu").read_text()
    assert "-I" in build.NVCC_FLAGS


def test_the_ablations_match_the_source():
    # tests/torch_k9_ablations.py changes the source by text substitution
    # and stops where a substitution no longer matches
    import sys
    sys.path.insert(0, str(build.CSRC_DIR.parents[3] / "tests"))
    import torch_k9_ablations as ablations
    for name, subs in ablations.VARIANTS.items():
        assert ablations.patched(subs) != "", name
