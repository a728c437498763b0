"""K8's kv-tile rule against the band mask, and its wgmma kernel's
barrier protocol, on the CPU.

The bf16 flash-attention kernels (``csrc/flash_attention.cu``) visit, for
each query tile, only the kv tiles ``kv_tiles`` names, and run the
interior ones among them without a mask. Its Python twin
``flash_attention.kv_tiles`` is held here against ``band_mask`` over many
lengths, windows and tile sizes (each kernel's, ``flash_attention.tiles``,
among them): every live (query, key) pair of a query tile lies in a
visited kv tile, a tile outside that range holds no live pair, and a
visited tile is interior exactly when every pair in it is live (so no tile
that needs a mask runs without one, and no fully live tile pays for one).

The tiles ``tiles`` reads from the source are held against what the
kernels need of them (two 64-row consumer warpgroups, the shared memory
of a block), and the order in which the wgmma kernel's producer thread
and its two consumer warpgroups wait on and arrive at their barriers
(Q's, and the K and V ring's full and empty mbarriers, the ping-pong's
named barriers) is replayed by a model of those barriers: for every block
of many lengths and windows, at each head dim's tiles, with the
overlapped softmax and without it (the ``no_overlap`` variant of
``tests/torch_k7_k8_ablations.py``), every program runs to its end (no
deadlock) and the named barriers end with no arrival left over.
"""

import pytest

from repro_torch.kernels import flash_attention as fa

LENGTHS = [1, 5, 63, 64, 65, 100, 257, 1000]
WINDOWS = [0, 1, 7, 63, 64, 65, 100, 2048]
# mma.sync's 64 x 64, the wgmma kernel's per head dim, and others
TILES = sorted({(64, 64), (128, 64), (64, 32), (16, 32),
                *(fa.tiles(dh) for dh in fa.HEAD_DIMS)})


@pytest.mark.parametrize("bq,bk", TILES)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("s", LENGTHS)
def test_kv_tiles_cover_the_band_and_mask_only_what_needs_it(s, window, bq,
                                                            bk):
    mask = fa.band_mask(s, window)
    n_kv = -(-s // bk)
    for q0 in range(0, s, bq):
        rows = mask[q0:min(q0 + bq, s)]
        lo, hi, ilo, ihi = fa.kv_tiles(q0, s, window, bq, bk)
        assert 0 <= lo <= hi < n_kv
        for j in range(n_kv):
            block = rows[:, j * bk:(j + 1) * bk]
            full = block.shape[1] == bk and bool(block.all())
            if j < lo or j > hi:
                assert not bool(block.any()), (q0, j)
            else:
                assert (ilo <= j <= ihi) == full, (q0, j)


def test_kv_tiles_at_the_serving_shape():
    # recurrentgemma_9b's prefill: S 4096, window 2048, with the mma.sync
    # kernel's 64 x 64 tiles (passed explicitly: the tiles now depend on
    # the kernel). Past the window's first tiles a query tile visits 33 kv
    # tiles, of which only the diagonal and the window's lower edge need a
    # mask.
    lo, hi, ilo, ihi = fa.kv_tiles(4032, 4096, 2048, 64, 64)
    assert (lo, hi) == (31, 63) and (ilo, ihi) == (32, 62)
    # causal (window 0): every tile below the diagonal is interior
    assert fa.kv_tiles(4032, 4096, 0, 64, 64) == (0, 63, 0, 62)
    # the first query tile has only its diagonal tile
    assert fa.kv_tiles(0, 4096, 2048, 64, 64) == (0, 0, 0, -1)


@pytest.mark.parametrize("window,want", [
    # the wgmma kernel at head dim 256 (128 query rows, 64 keys): the last
    # query tile visits 34 kv tiles, the two at the window's lower edge and
    # the two diagonal ones masked
    (2048, (30, 63, 32, 61)),
    # causal: every tile below the two diagonal ones interior
    (0, (0, 63, 0, 61)),
])
def test_kv_tiles_at_the_serving_shape_wgmma(window, want):
    bq, bk = fa.tiles(256)
    assert (bq, bk) == (128, 64)
    assert fa.kv_tiles(4096 - bq, 4096, window, bq, bk) == want


@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_kernel_rule_and_tiles_match_the_source(dh):
    # the source's FA_CFG lines name exactly the wgmma head dims; its
    # ping-pong takes two 64-row consumer warpgroups; a block's Q, its K
    # and V ring and barriers, with 1024 bytes to align them, fit in the
    # 227 KB of shared memory a block may have
    cfg = fa.source_config()
    assert sorted(cfg["bk"]) == list(fa.WGMMA_HEAD_DIMS)
    assert fa.kernel_for(dh, 4) == "f32"
    bq, bk = fa.tiles(dh)
    if dh in fa.WGMMA_HEAD_DIMS:
        assert fa.kernel_for(dh, 2) == "wgmma"
        assert cfg["nwg"] == 2 and bq == 128 and bk % 64 == 0
        smem = 1024 + 2 * dh * (bq + 2 * cfg["stages"] * bk) \
            + 8 * (1 + 4 * cfg["stages"])
        assert smem <= 227 * 1024
    else:
        assert fa.kernel_for(dh, 2) == "mma_sync"
        assert (bq, bk) == (64, 64)


# ------------------------------------------- the wgmma kernel's barriers

def _programs(s, q0, window, bq, bk, overlap):
    """The producer's and the two consumer warpgroups' barrier operations
    for the block of query rows [q0, q0 + bq), in flash_fwd_wgmma's order:
    the producer loads Q, then K(j) and V(j), each once its stage's last
    readers have released the tile ``stages`` before it. A consumer waits
    for Q, passes the block's tiles outside its band (waits for and
    releases them, one empty ping-pong turn each), and over its own tiles
    takes one turn per S product and one for the last P V (with overlap,
    P(j - 1) V(j - 1) rides in S(j)'s turn), releasing K(j) once S(j) is
    done and V(j) once P(j) V(j) is."""
    lo, hi, _, _ = fa.kv_tiles(q0, s, window, bq, bk)
    prod = [("load", "q", 0)]
    for j in range(lo, hi + 1):
        prod += [("free", "k", j), ("load", "k", j),
                 ("free", "v", j), ("load", "v", j)]
    progs = [prod]
    all_turns = hi - lo + 1 + (1 if overlap else 0)
    for cw in range(bq // 64):
        ops = []
        qw = q0 + 64 * cw
        if qw < s:
            wlo, whi, _, _ = fa.kv_tiles(qw, s, window, 64, bk)
        else:
            wlo, whi = hi + 1, hi
        turns = [0]

        def turn(inner=(), cw=cw, ops=ops, turns=turns):
            ops.append(("sync", 3 + cw))
            ops.extend(inner)
            turns[0] += 1
            if cw == 0 or turns[0] < all_turns:
                ops.append(("arrive", 4 - cw))

        def pass_turn(j, ops=ops, turn=turn):
            ops.extend([("wait", "k", j), ("wait", "v", j),
                        ("release", "k", j), ("release", "v", j)])
            turn()

        if cw == 1:
            ops.append(("arrive", 3))
        ops.append(("wait", "q", 0))
        for j in range(lo, wlo):
            pass_turn(j)
        if overlap and wlo <= whi:
            ops.append(("wait", "k", wlo))
            turn()
            ops.append(("release", "k", wlo))
            for j in range(wlo + 1, whi + 1):
                ops.append(("wait", "k", j))
                turn([("wait", "v", j - 1)])
                ops += [("release", "k", j), ("release", "v", j - 1)]
            ops.append(("wait", "v", whi))
            turn()
            ops.append(("release", "v", whi))
        elif overlap:
            turn()
        else:
            for j in range(wlo, whi + 1):
                ops.append(("wait", "k", j))
                turn()
                ops += [("release", "k", j), ("wait", "v", j),
                        ("release", "v", j)]
        for j in range(whi + 1, hi + 1):
            pass_turn(j)
        assert turns[0] == all_turns
        progs.append(ops)
    return progs, lo


def _run(progs, lo, stages, readers):
    """Steps every program while one can move; True when all end and the
    named barriers hold no arrival. A named barrier of 256 threads
    completes on two arrivals (a warpgroup's sync or arrive); a ring stage
    is free once every reader has released the tile ``stages`` before."""
    pc = [0] * len(progs)
    loaded, released = set(), {}
    count, phase, parked = {3: 0, 4: 0}, {3: 0, 4: 0}, {}
    while True:
        moved = False
        for a, prog in enumerate(progs):
            if pc[a] >= len(prog):
                continue
            if a in parked:
                bar, ph = parked[a]
                if phase[bar] > ph:
                    del parked[a]
                    pc[a] += 1
                    moved = True
                continue
            op = prog[pc[a]]
            if op[0] == "free":
                prev = (op[1], op[2] - stages)
                if prev[1] >= lo and released.get(prev, 0) < readers:
                    continue
            elif op[0] == "load":
                loaded.add(op[1:])
            elif op[0] == "wait":
                if op[1:] not in loaded:
                    continue
            elif op[0] == "release":
                released[op[1:]] = released.get(op[1:], 0) + 1
            else:
                bar = op[1]
                count[bar] += 1
                if count[bar] == 2:
                    count[bar] = 0
                    phase[bar] += 1
                elif op[0] == "sync":
                    parked[a] = (bar, phase[bar])
                    moved = True
                    continue
            pc[a] += 1
            moved = True
        if all(p >= len(prog) for p, prog in zip(pc, progs)):
            return not parked and count == {3: 0, 4: 0}
        if not moved:
            return False


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("dh", list(fa.WGMMA_HEAD_DIMS))
def test_wgmma_barriers_neither_deadlock_nor_leave_arrivals(dh, overlap):
    stages = fa.source_config()["stages"]
    bq, bk = fa.tiles(dh)
    for s in (1, 63, 64, 65, 127, 129, 200, 257, 777, 1000):
        for window in (0, 1, 63, 64, 65, 100, 1000):
            for q0 in range(0, s, bq):
                progs, lo = _programs(s, q0, window, bq, bk, overlap)
                assert _run(progs, lo, stages, bq // 64), (s, window, q0)


def test_the_barrier_model_finds_a_deadlock():
    # the protocol with the empty turns of a warpgroup's skipped tiles
    # taken after all its work, not where the tiles come: warpgroup 1 of
    # the last block (no rows) then waits for a tile whose stage warpgroup
    # 0 frees only after a turn that warpgroup 1 has not given
    progs, lo = _programs(257, 256, 0, 128, 128, True)
    late = [op for op in progs[2] if op[0] not in ("sync", "arrive")]
    turns = [op for op in progs[2] if op[0] in ("sync", "arrive")]
    assert not _run([progs[0], progs[1], late + turns], lo, 2, 2)
    assert _run(progs, lo, 2, 2)
