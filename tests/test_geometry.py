"""Geometry scaling: block sizing (size4dim, dsv_encoder.c:556-572),
auto pyramid depth (dsv_encoder.c:602-613), coefficient layouts and HZCC
traversal tables must stay consistent up to 8K."""

import pytest

from dsv1_tpu.constants import (MAX_BLOCK_SIZE, MIN_BLOCK_SIZE, SUBSAMP_420,
                                div_round)
from dsv1_tpu.models.encoder import auto_pyramid_levels, coef_geometry
from dsv1_tpu.parallel.gop import block_geometry


@pytest.mark.parametrize("w,h,blk", [
    (352, 288, (16, 16)), (704, 480, (24, 24)), (1280, 720, (48, 32)),
    (1920, 1080, (64, 48)), (3840, 2160, (64, 64)), (7680, 4320, (64, 64)),
])
def test_block_geometry_matches_reference_sizing(w, h, blk):
    bw, bh, nbh, nbv = block_geometry(w, h)
    assert (bw, bh) == blk
    assert MIN_BLOCK_SIZE <= bw <= MAX_BLOCK_SIZE
    assert nbh == div_round(w, bw) and nbv == div_round(h, bh)


@pytest.mark.parametrize("w,h", [(1920, 1080), (3840, 2160), (7680, 4320)])
def test_traversal_tables_cover_every_coefficient(w, h):
    bw, bh, nbh, nbv = block_geometry(w, h)
    lv = auto_pyramid_levels(w, h, nbh, nbv)
    assert 3 <= lv <= 5
    _, dims, tables = coef_geometry(SUBSAMP_420, w, h, nbh, nbv)
    for (cw, ch), t in zip(dims, tables):
        assert t.n >= 1
        assert len(t.segs) == 10  # LL + 3 levels x (LH, HL, HH)
        # every traversal position indexes inside the plane
        assert int(t.perm.max()) < cw * ch
        assert int(t.perm.min()) >= 0


@pytest.mark.parametrize("w,h,nbh,nbv", [(352, 288, 22, 18),
                                         (1920, 1080, 30, 23),
                                         (101, 85, 7, 6)])
def test_band_stability_gather_matches_position_table(w, h, nbh, nbv):
    """The per-band integer gather of block stability flags
    (hzcc._band_stable) equals the per-position block table, band by
    band — the map the quantizer and dequantizer read."""
    import numpy as np

    from dsv1_tpu.ops import hzcc

    t = hzcc.build_tables(w, h, nbh, nbv)
    stable = np.random.default_rng(w).integers(0, 4, nbv * nbh) \
        .astype(np.int32)
    for k, (lvl, _, _, sh, sw, rows, cols) in enumerate(t.segs):
        if lvl < 0:
            continue
        got = np.asarray(hzcc._band_stable(stable.reshape(nbv, nbh),
                                           rows, cols))
        lo, hi = t.seg_bounds[k], t.seg_bounds[k + 1]
        np.testing.assert_array_equal(got.reshape(-1),
                                      stable[t.blk[lo:hi]])
        assert got.shape == (sh, sw)
