"""Golden tests: hierarchical motion estimation vs reference dsv_hme.

The encoder targets byte-exact streams vs the reference, which requires the
MV field (mode/mv/submask/lo_*/high_detail) to match bit-for-bit.
"""

import ctypes

import numpy as np
import pytest

import jax.numpy as jnp

from dsv1_tpu.constants import SUBSAMP_420, round_shift
from dsv1_tpu.ops import frame as fr
from dsv1_tpu.ops import hme

from . import corpus, oracle


def _pyramid_images(planes, subsamp, levels):
    """Our pyramid: flat images per level (level 0 = full frame)."""
    h, w = planes[0].shape
    layouts = [fr.make_layout(subsamp, w, h, True)]
    imgs = [fr.image_from_planes(layouts[0], [jnp.asarray(p) for p in planes])]
    for i in range(levels):
        pw, ph = round_shift(w, i + 1), round_shift(h, i + 1)
        lay = fr.make_layout(subsamp, pw, ph, True)
        prev_lay = layouts[-1]
        prev_luma = fr.plane_view_ext(imgs[-1], prev_lay, 0, 1)
        luma = fr.ds2x_luma(prev_luma, pw, ph)
        zero = jnp.zeros((lay.planes[1].h, lay.planes[1].w), jnp.uint8)
        imgs.append(fr.image_from_planes(lay, [luma, zero, zero]))
        layouts.append(lay)
    return imgs, layouts


def _ref_setup(src_planes, ref_planes, subsamp, levels, blk=16):
    L = oracle.lib()
    h, w = src_planes[0].shape
    meta = oracle.DSV_META()
    meta.width, meta.height, meta.subsamp = w, h, subsamp
    meta.fps_num, meta.fps_den = 30, 1
    params = oracle.DSV_PARAMS()
    params.vidmeta = ctypes.pointer(meta)
    params.blk_w = params.blk_h = blk
    params.nblocks_h = (w + blk - 1) // blk
    params.nblocks_v = (h + blk - 1) // blk
    sf = oracle.mk_frame_planar(src_planes, subsamp)
    rf = oracle.mk_frame_planar(ref_planes, subsamp)
    sp = [sf] + oracle.mk_pyramid(sf, levels, subsamp)
    rp = [rf] + oracle.mk_pyramid(rf, levels, subsamp)
    return sp, rp, params, meta


@pytest.mark.parametrize("seed,shift", [(1, 3), (2, 0), (5, 11)])
def test_hme_matches_reference(seed, shift):
    w, h, subsamp, levels, blk = 96, 80, SUBSAMP_420, 3, 16
    yuv = corpus.make_clip(w, h, subsamp, 2, seed=seed)
    fsz = w * h + 2 * (w // 2) * (h // 2)
    f0 = fr.np_yuv_split(np.frombuffer(yuv[:fsz], np.uint8), subsamp, w, h)
    f1 = fr.np_yuv_split(np.frombuffer(yuv[fsz:2 * fsz], np.uint8).copy(),
                         subsamp, w, h)
    if shift:  # extra known motion
        f1 = (np.roll(f0[0], shift, axis=1), f0[1], f0[2])

    sp, rp, params, meta = _ref_setup(f1, f0, subsamp, levels, blk)
    ref_out, ref_pct = oracle.run_hme(sp, rp, params, levels)

    src_imgs, layouts = _pyramid_images([np.asarray(x) for x in f1],
                                        subsamp, levels)
    ref_imgs, _ = _pyramid_images([np.asarray(x) for x in f0],
                                  subsamp, levels)
    nbh, nbv = params.nblocks_h, params.nblocks_v
    out = hme.hme(src_imgs, ref_imgs, layouts, blk, blk, nbh, nbv,
                  subsamp, levels)

    for key in ("mode", "mvx", "mvy", "submask", "lo_tex", "lo_var",
                "high_detail"):
        got = np.asarray(out[key]).reshape(-1)
        np.testing.assert_array_equal(
            got, ref_out[key], err_msg=f"field {key}")
    assert int(out["intra_pct"]) == ref_pct
