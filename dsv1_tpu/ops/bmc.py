"""Block motion compensation — whole-plane filtering + one fused gather.

The reference compensates block by block: per-block half-pel filtering
(luma 4-tap 9*(p0+p1)-(p-1+p2), chroma bilinear; reference bmc.c:57-174)
and intra DC fills (bmc.c:256-298), then residual add/sub with +128 bias
(bmc.c:29-55).

Design: the half-pel filters are position-invariant, so we
precompute all four phase variants over the *whole padded plane* once
(vectorized, in flat C-layout index space so row-crossing edge reads match
the reference exactly), then build the prediction with a single gather
indexed by each pixel's block MV. Intra DC averages come from integral
images. The per-pixel select covers inter/intra/sub-block-mask cases with
no data-dependent control flow — ideal for XLA fusion.
"""

import jax.numpy as jnp

from ..constants import (FRAME_BORDER, MASK_ALL_INTRA, MODE_INTER,
                         format_h_shift, format_v_shift)
from .frame import FrameLayout, flat_base
from .opt import runtime, span_gather


def _shift(ap, P: int, n: int, k: int):
    """ap: zero-padded flat image (P pad each side); returns a[i+k] (int32)."""
    return ap[P + k: P + k + n].astype(jnp.int32)


def hpel_variants_luma(img, layout: FrameLayout, c: int):
    """D.1.1 luma half-pel filter over the whole image, 4 phases.

    Returns uint8 array of shape (4, n) in flat index space: phase
    (xh<<1)|yh as in bmc.c:124-174.
    """
    s = layout.planes[c].stride
    n = img.shape[0]
    P = 2 * s + 2
    ap = jnp.pad(img, (P, P))
    a0 = _shift(ap, P, n, 0)
    # horizontal: 9*(a[0]+a[+1]) - (a[-1]+a[+2])
    hu = 9 * (a0 + _shift(ap, P, n, 1)) - (_shift(ap, P, n, -1) +
                                           _shift(ap, P, n, 2))
    h8 = jnp.clip((hu + 8) >> 4, 0, 255)
    # vertical
    vu = 9 * (a0 + _shift(ap, P, n, s)) - (_shift(ap, P, n, -s) +
                                           _shift(ap, P, n, 2 * s))
    v8 = jnp.clip((vu + 8) >> 4, 0, 255)
    # diagonal: vertical 4-tap over unclamped horizontal intermediates
    hp = jnp.pad(hu, (P, P))
    du = 9 * (_shift(hp, P, n, 0) + _shift(hp, P, n, s)) - (
        _shift(hp, P, n, -s) + _shift(hp, P, n, 2 * s))
    d8 = jnp.clip((du + 128) >> 8, 0, 255)
    # flat (4n,) concat: callers index the variants as one flat array
    return jnp.concatenate(
        [a.astype(jnp.uint8) for a in (a0, v8, h8, d8)])


def hpel_variants_chroma(img, layout: FrameLayout, c: int):
    """D.1.2 chroma half-pel (bilinear) over the whole image, 4 phases."""
    s = layout.planes[c].stride
    n = img.shape[0]
    P = s + 1
    ap = jnp.pad(img, (P, P))
    a0 = _shift(ap, P, n, 0)
    ax = _shift(ap, P, n, 1)
    ay = _shift(ap, P, n, s)
    axy = _shift(ap, P, n, s + 1)
    v1 = (a0 + ay + 1) >> 1
    v2 = (a0 + ax + 1) >> 1
    v3 = (a0 + ax + ay + axy + 2) >> 2
    # flat concat — see hpel_variants_luma
    return jnp.concatenate(
        [a.astype(jnp.uint8) for a in (a0, v1, v2, v3)])


def _block_avgs(ref_plane, nbh: int, nbv: int, bw: int, bh: int):
    """Whole-block and quadrant DC averages via an integral image.

    Returns (avg_full[nbv,nbh], avg_sub[nbv,nbh,2,2]) with the reference's
    truncating division (bmc.c:176-189), using clipped block dims.
    """
    ph, pw = ref_plane.shape
    # uint32 integral image: sums < 2^32 up to 4K planes; modular subtraction
    # keeps box sums exact. The plane is padded to (8, 128) multiples
    # before the cumsums (an earlier backend's fast form; whether it
    # still pays is open); trailing zeros leave the valid prefix sums
    # unchanged.
    pw_p = -(-pw // 128) * 128
    ph_p = -(-ph // 8) * 8
    a = ref_plane.astype(jnp.uint32)
    if (ph_p, pw_p) != (ph, pw):
        a = jnp.pad(a, ((0, ph_p - ph), (0, pw_p - pw)))
    ii = jnp.pad(jnp.cumsum(jnp.cumsum(a, 0), 1),
                 ((1, 0), (1, 0)))[:ph + 1, :pw + 1]

    bj, bi = runtime(*jnp.mgrid[0:nbv, 0:nbh])  # see ops/opt.py
    x0 = bi * bw
    y0 = bj * bh
    cw = jnp.clip(pw - x0, 0, bw)
    ch = jnp.clip(ph - y0, 0, bh)
    x1 = x0 + cw
    y1 = y0 + ch

    def boxsum(ya, xa, yb, xb):
        ya = jnp.clip(ya, 0, ph)
        yb = jnp.clip(yb, 0, ph)
        xa = jnp.clip(xa, 0, pw)
        xb = jnp.clip(xb, 0, pw)
        return (ii[yb, xb] - ii[ya, xb] - ii[yb, xa] + ii[ya, xa])

    area = jnp.maximum(cw * ch, 1).astype(jnp.uint32)
    avg_full = (boxsum(y0, x0, y1, x1) // area).astype(jnp.int32)

    sbw = cw // 2
    sbh = ch // 2
    subs = []
    for qy in (0, 1):
        row = []
        for qx in (0, 1):
            sx0 = x0 + qx * sbw
            sy0 = y0 + qy * sbh
            ssum = boxsum(sy0, sx0, sy0 + sbh, sx0 + sbw)
            sarea = jnp.maximum(sbw * sbh, 1).astype(jnp.uint32)
            row.append((ssum // sarea).astype(jnp.int32))
        subs.append(jnp.stack(row, -1))
    avg_sub = jnp.stack(subs, -2)  # [nbv, nbh, qy, qx]
    return avg_full, avg_sub


def compensate_plane(ref_img, ref_plane, layout: FrameLayout, c: int,
                     blk_w: int, blk_h: int, nbh: int, nbv: int,
                     modes, mvx, mvy, submask):
    """D.1/D.2 compensate (bmc.c:204-302): build the prediction plane.

    ref_img: flat extended reference image; ref_plane: its (h, w) core view.
    Returns the (h, w) uint8 prediction.
    """
    p = layout.planes[c]
    ph, pw = p.h, p.w
    sh = 0 if c == 0 else format_h_shift(layout.subsamp)
    sv = 0 if c == 0 else format_v_shift(layout.subsamp)
    bw, bh = blk_w >> sh, blk_h >> sv
    limx = (pw - bw) + FRAME_BORDER - 1
    limy = (ph - bh) + FRAME_BORDER - 1

    variants = (hpel_variants_luma if c == 0 else hpel_variants_chroma)(
        ref_img, layout, c)
    n = ref_img.shape[0]
    vflat = variants.reshape(-1)
    S = p.stride
    base = flat_base(layout, c)

    # Per-block fields expanded to the pixel grid by static-factor repeats
    # (dense ops instead of per-pixel table gathers).
    def up(blk2d):
        return jnp.repeat(jnp.repeat(blk2d, bh, axis=0), bw,
                          axis=1)[:ph, :pw]

    m2 = modes.reshape(nbv, nbh)
    sub2 = submask.reshape(nbv, nbh)
    dx2 = (mvx.reshape(nbv, nbh).astype(jnp.int32)) >> sh
    dy2 = (mvy.reshape(nbv, nbh).astype(jnp.int32)) >> sv

    # --- inter (bmc.c:241-255): each block reads bh contiguous bw-byte
    # spans of one half-pel variant -> one span_gather over (nblk, bh).
    # (Per-block spans keep the one-hot alignment tensor small — a
    # per-pixel-row formulation needs ph*nbh spans and gigabyte-scale
    # selection masks at 1080p.)
    px = jnp.clip(jnp.arange(nbh)[None, :] * bw + (dx2 >> 1),
                  -FRAME_BORDER, limx)                # (nbv, nbh)
    py0 = jnp.clip((jnp.arange(nbv) * bh)[:, None] + (dy2 >> 1),
                   -FRAME_BORDER, limy)
    phase = ((dx2 & 1) << 1) | (dy2 & 1)
    start0 = (phase * n + base + py0 * S + px).reshape(-1)   # (nblk,)
    row_start = start0[:, None] + (jnp.arange(bh) * S)[None, :]
    spans = span_gather(vflat, row_start, bw, S)      # (nblk, bh, bw)
    inter_full = spans.reshape(nbv, nbh, bh, bw).transpose(0, 2, 1, 3) \
        .reshape(nbv * bh, nbh * bw)
    inter_val = inter_full[:ph, :pw].astype(jnp.int32)

    # --- intra: DC fills / zero-MV copies (bmc.c:256-298), all dense
    avg_full, avg_sub = _block_avgs(ref_plane, nbh, nbv, bw, bh)
    mode_px = up(m2)
    sub_px = up(sub2)
    avgf_px = up(avg_full)
    quads = [[up(avg_sub[:, :, qy_, qx_]) for qx_ in (0, 1)]
             for qy_ in (0, 1)]
    cw2 = jnp.clip(pw - jnp.arange(nbh) * bw, 0, bw)
    ch2 = jnp.clip(ph - jnp.arange(nbv) * bh, 0, bh)
    sbw_px = up(jnp.broadcast_to((cw2 // 2)[None, :], (nbv, nbh)))
    sbh_px = up(jnp.broadcast_to((ch2 // 2)[:, None], (nbv, nbh)))
    lx = (jnp.arange(pw) % bw)[None, :]
    ly = (jnp.arange(ph) % bh)[:, None]
    qx = (lx >= sbw_px).astype(jnp.int32)
    qy = (ly >= sbh_px).astype(jnp.int32)
    in_sub = (lx < 2 * sbw_px) & (ly < 2 * sbh_px) \
        & (sbw_px > 0) & (sbh_px > 0)
    mask_bit = (sub_px >> (qy * 2 + qx)) & 1
    quad_avg = jnp.where(qy == 0,
                         jnp.where(qx == 0, quads[0][0], quads[0][1]),
                         jnp.where(qx == 0, quads[1][0], quads[1][1]))
    intra_val = jnp.where(
        sub_px == MASK_ALL_INTRA, avgf_px,
        jnp.where(~in_sub, 0,
                  jnp.where(mask_bit == 1, quad_avg,
                            ref_plane.astype(jnp.int32))))

    pred = jnp.where(mode_px == MODE_INTER, inter_val, intra_val)
    return pred.astype(jnp.uint8)


def add_residual(pred, dif):
    """addf (bmc.c:29-41): out = clamp(pred + dif - 128)."""
    v = pred.astype(jnp.int32) + dif.astype(jnp.int32) - 128
    return jnp.clip(v, 0, 255).astype(jnp.uint8)


def sub_residual(inp, pred):
    """subf (bmc.c:43-55): residual = clamp(inp - pred + 128)."""
    v = inp.astype(jnp.int32) - pred.astype(jnp.int32) + 128
    return jnp.clip(v, 0, 255).astype(jnp.uint8)
