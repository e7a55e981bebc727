"""Motion compensation (ops/bmc.py compensate_plane) vs a plain numpy
block-by-block reference of bmc.c:204-302: half-pel variant planes in
flat image space, per-block window fetch with the MV clamp, intra DC
fills (whole block and sub-block quadrants), zero-MV copies, and the
inter/intra mode select. The e2e encoder/decoder suites check the same
code against the reference C through whole streams."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dsv1_tpu.constants import (FRAME_BORDER, MASK_ALL_INTRA, MODE_INTER,
                                SUBSAMP_420, format_h_shift, format_v_shift)
from dsv1_tpu.ops import bmc, frame as fr
from dsv1_tpu.utils.yuv import frame_size

from . import corpus


def _np_variants(img, stride: int, luma: bool):
    """The four half-pel phase planes over the flat image, phase index
    (xh << 1) | yh (bmc.c:57-174); reads past the array are zero."""
    n = img.size
    P = 2 * stride + 2
    ap = np.pad(img.astype(np.int64), (P, P))

    def sh(a, k):
        return a[P + k:P + k + n]

    a0 = sh(ap, 0)
    s = stride
    if luma:
        hu = 9 * (a0 + sh(ap, 1)) - (sh(ap, -1) + sh(ap, 2))
        vu = 9 * (a0 + sh(ap, s)) - (sh(ap, -s) + sh(ap, 2 * s))
        hp = np.pad(hu, (P, P))
        du = 9 * (sh(hp, 0) + sh(hp, s)) - (sh(hp, -s) + sh(hp, 2 * s))
        return [a0, np.clip((vu + 8) >> 4, 0, 255),
                np.clip((hu + 8) >> 4, 0, 255),
                np.clip((du + 128) >> 8, 0, 255)]
    ax, ay, axy = sh(ap, 1), sh(ap, s), sh(ap, s + 1)
    return [a0, (a0 + ay + 1) >> 1, (a0 + ax + 1) >> 1,
            (a0 + ax + ay + axy + 2) >> 2]


def _np_compensate(img, layout, c, blk_w, blk_h, nbh, nbv, modes, mvx, mvy,
                   sub):
    """One block at a time, as the reference loops."""
    p = layout.planes[c]
    hs = 0 if c == 0 else format_h_shift(layout.subsamp)
    vs = 0 if c == 0 else format_v_shift(layout.subsamp)
    bw, bh = blk_w >> hs, blk_h >> vs
    S = p.stride
    base = fr.flat_base(layout, c)
    var = _np_variants(img, S, c == 0)
    ref = np.array([[img[base + y * S + x] for x in range(p.w)]
                    for y in range(p.h)], np.int64)
    pred = np.zeros((p.h, p.w), np.int64)
    for j in range(nbv):
        for i in range(nbh):
            k = j * nbh + i
            bx, by = i * bw, j * bh
            cw = min(max(p.w - bx, 0), bw)
            ch = min(max(p.h - by, 0), bh)
            if modes[k] == MODE_INTER:
                dx, dy = int(mvx[k]) >> hs, int(mvy[k]) >> vs
                px = min(max(bx + (dx >> 1), -FRAME_BORDER),
                         p.w - bw + FRAME_BORDER - 1)
                py = min(max(by + (dy >> 1), -FRAME_BORDER),
                         p.h - bh + FRAME_BORDER - 1)
                v = var[((dx & 1) << 1) | (dy & 1)]
                for r in range(ch):
                    for q in range(cw):
                        pred[by + r, bx + q] = v[base + (py + r) * S + px + q]
                continue
            blk = ref[by:by + ch, bx:bx + cw]
            if sub[k] == MASK_ALL_INTRA:
                pred[by:by + ch, bx:bx + cw] = blk.sum() // max(cw * ch, 1)
                continue
            sbw, sbh = cw // 2, ch // 2
            out = np.zeros((ch, cw), np.int64)
            for qy in (0, 1):
                for qx in (0, 1):
                    if sbw == 0 or sbh == 0:
                        continue
                    ys = slice(qy * sbh, (qy + 1) * sbh)
                    xs = slice(qx * sbw, (qx + 1) * sbw)
                    if (sub[k] >> (qy * 2 + qx)) & 1:
                        out[ys, xs] = blk[ys, xs].sum() // (sbw * sbh)
                    else:
                        out[ys, xs] = blk[ys, xs]
            pred[by:by + ch, bx:bx + cw] = out
    return pred.astype(np.uint8)


# partial right/bottom blocks, odd clipped block dims (pixels outside
# the 2x2 sub-block grid) and odd plane dims
@pytest.mark.parametrize("w,h,seed", [(96, 80, 0), (100, 84, 1),
                                      (98, 86, 2), (101, 85, 3)])
@pytest.mark.parametrize("c", [0, 1, 2])
def test_compensate_plane_matches_blockwise_reference(w, h, seed, c):
    blk = 16
    nbh, nbv = -(-w // blk), -(-h // blk)
    nblk = nbh * nbv
    rng = np.random.default_rng(seed)
    yuv = corpus.make_clip(w, h, SUBSAMP_420, 1, seed=seed)
    planes = fr.np_yuv_split(
        np.frombuffer(yuv[:frame_size(w, h, SUBSAMP_420)], np.uint8),
        SUBSAMP_420, w, h)
    layout = fr.make_layout(SUBSAMP_420, w, h, True)
    img = fr.image_from_planes(layout, [jnp.asarray(p) for p in planes])
    # random MV field incl. intra blocks, extreme clamped MVs, submasks
    modes = rng.integers(0, 2, nblk).astype(np.int32)
    mvx = rng.integers(-2 * w, 2 * w, nblk).astype(np.int32)
    mvy = rng.integers(-2 * h, 2 * h, nblk).astype(np.int32)
    sub = rng.integers(0, 16, nblk).astype(np.int32)

    def run(img_, m, x, y, s):
        return bmc.compensate_plane(img_, fr.plane_view(img_, layout, c),
                                    layout, c, blk, blk, nbh, nbv,
                                    m, x, y, s)

    got = np.asarray(jax.jit(run)(img, modes, mvx, mvy, sub))
    want = _np_compensate(np.asarray(img), layout, c, blk, blk, nbh, nbv,
                          modes, mvx, mvy, sub)
    np.testing.assert_array_equal(got, want)
