"""K8's kv-tile rule against the band mask, on the CPU.

The bf16 flash-attention kernel (``csrc/flash_attention.cu``) visits, for
each query tile, only the kv tiles ``kv_tiles`` names, and runs the
interior ones among them without a mask. Its Python twin
``flash_attention.kv_tiles`` is held here against ``band_mask`` over many
lengths, windows and tile sizes: every live (query, key) pair of a query
tile lies in a visited kv tile, a tile outside that range holds no live
pair, and a visited tile is interior exactly when every pair in it is
live (so no tile that needs a mask runs without one, and no fully live
tile pays for one).
"""

import pytest

from repro_torch.kernels import flash_attention as fa

LENGTHS = [1, 5, 63, 64, 65, 100, 257, 1000]
WINDOWS = [0, 1, 7, 63, 64, 65, 100, 2048]
TILES = [(64, 64), (128, 64), (64, 32), (16, 32)]


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
    # recurrentgemma_9b's prefill: S 4096, window 2048, 64 x 64 tiles.
    # Past the window's first tiles a query tile visits 33 kv tiles, of
    # which only the diagonal and the window's lower edge need a mask.
    lo, hi, ilo, ihi = fa.kv_tiles(4032, 4096, 2048)
    assert (lo, hi) == (31, 63) and (ilo, ihi) == (32, 62)
    # causal (window 0): every tile below the diagonal is interior
    assert fa.kv_tiles(4032, 4096, 0) == (0, 63, 0, 62)
    # the first query tile has only its diagonal tile
    assert fa.kv_tiles(0, 4096, 2048) == (0, 0, 0, -1)
