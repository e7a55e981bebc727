"""Hierarchical motion estimation — batched over all blocks per level.

The reference searches a luma pyramid top-down: per block, candidate MVs
inherited from 5 parent positions, SAD selection, 9-point full-pel refine,
and at level 0 an 8-point half-pel refine plus an HVS-driven intra/inter
decision cascade (reference hme.c:378-728). The reference's left/top
neighbour coupling for the high-detail flag (hme.c:620-647) only consumes
per-block quantities that are themselves neighbour-independent, so it
becomes a second vectorized pass here instead of a raster dependency.

Design: every level processes all blocks as one batch — window
gathers from flat C-layout images, SADs as masked reductions, the decision
cascade as vectorized selects. Half-pel candidate SADs sample the same
whole-plane filter variants used by motion compensation (ops/bmc.py), which
is mathematically identical to the reference's per-block interpolation.

Arithmetic notes: the reference's block statistics use *unsigned* 32-bit
arithmetic whose products wrap (e.g. s*s in block_analysis, hme.c:208,244);
we reproduce that with uint32 ops so mode decisions match bit-for-bit.
"""

import jax.numpy as jnp
import numpy as np

from ..constants import (FRAME_BORDER, HP_SAD_SZ, MASK_ALL_INTRA, MODE_INTER,
                         MODE_INTRA, format_h_shift, format_v_shift)
from .bmc import hpel_variants_luma
from .frame import FrameLayout, flat_base
from .opt import runtime, span_gather

# np scalar, not jnp: a module-level device array would initialize the
# JAX backend at import
INT_MAX = np.int32(2**31 - 1)

# ablation switches for performance work (timing only — results are wrong
# when non-empty): {"halfpel", "intra", "coarse", "cands", "ninepoint"}
DEBUG_SKIP: frozenset = frozenset()

# search point tables (hme.c:422-427)
XF = np.array([0, 1, -1, 0, 0, -1, 1, -1, 1], np.int32)
YF = np.array([0, 0, 0, 1, -1, -1, -1, 1, 1], np.int32)
XH = np.array([1, -1, 0, 0, -1, 1, -1, 1], np.int32)
YH = np.array([0, 0, 1, -1, -1, -1, 1, 1], np.int32)
# parent candidate offsets (hme.c:454)
PT = np.array([[0, 0], [-2, 0], [2, 0], [0, -2], [0, 2]], np.int32)


def _window(flat, layout: FrameLayout, c: int, bx, by, BW: int, BH: int):
    """Gather (nb, BH, BW) uint8 windows at per-block coords (flat C space)."""
    p = layout.planes[c]
    base = flat_base(layout, c)
    s = base + (by[:, None] + jnp.arange(BH)[None, :]) * p.stride + bx[:, None]
    return span_gather(flat, s, BW, p.stride)


def _window_variants(vflat, n: int, layout: FrameLayout, phase, bx, by,
                     BW: int, BH: int):
    """Gather windows from stacked half-pel variant planes (phase per block)."""
    p = layout.planes[0]
    base = flat_base(layout, 0)
    s = (phase[:, None] * n + base
         + (by[:, None] + jnp.arange(BH)[None, :]) * p.stride + bx[:, None])
    return span_gather(vflat, s, BW, p.stride)


def _masked_sad(a, b, colmask, rowmask):
    d = jnp.abs(a.astype(jnp.int32) - b.astype(jnp.int32))
    d = d * colmask[:, None, :] * rowmask[:, :, None]
    return jnp.sum(d, axis=(1, 2))


def _block_analysis(win, cw, ch, BW: int, BH: int):
    """Variance + texture with the reference's unsigned wrap semantics
    (hme.c:212-245). win: (nb, BH, BW) uint8; cw/ch: (nb,) clipped dims.

    Returns (var u32, tex u32, s u32, ss u32)."""
    a = win.astype(jnp.uint32)
    colm = (jnp.arange(BW)[None, :] < cw[:, None])
    rowm = (jnp.arange(BH)[None, :] < ch[:, None])
    m = (colm[:, None, :] & rowm[:, :, None]).astype(jnp.uint32)
    am = a * m
    s = jnp.sum(am, axis=(1, 2))
    ss = jnp.sum(am * am, axis=(1, 2))
    dh = jnp.abs(a[:, :, 1:].astype(jnp.int32) - a[:, :, :-1].astype(jnp.int32))
    mh = (colm[:, None, 1:] & rowm[:, :, None]).astype(jnp.int32)
    sh = jnp.sum(dh * mh, axis=(1, 2)).astype(jnp.uint32)
    dv = jnp.abs(a[:, 1:, :].astype(jnp.int32) - a[:, :-1, :].astype(jnp.int32))
    mv_ = (colm[:, None, :] & rowm[:, 1:, None]).astype(jnp.int32)
    sv = jnp.sum(dv * mv_, axis=(1, 2)).astype(jnp.uint32)
    area = (cw * ch).astype(jnp.uint32)
    area = jnp.maximum(area, 1)
    tex = ((sh + sv) // 2) // area
    var = ss - (s * s) // area
    return var, tex, s, ss


def _y_sqrvar(win, cw, ch, BW: int, BH: int):
    """y_sqrvar (hme.c:247-267), unsigned."""
    a = win.astype(jnp.uint32)
    colm = (jnp.arange(BW)[None, :] < cw[:, None])
    rowm = (jnp.arange(BH)[None, :] < ch[:, None])
    m = (colm[:, None, :] & rowm[:, :, None]).astype(jnp.uint32)
    am = a * m
    s = jnp.sum(am, axis=(1, 2))
    ss = jnp.sum(am * am, axis=(1, 2))
    area = jnp.maximum((cw * ch).astype(jnp.uint32), 1)
    return ss - (s * s) // area


def _block_texture14(win):
    """block_texture (hme.c:180-210) on fixed 14x14 windows.

    Returns (tex u32, avg i32, var i32)."""
    a = win.astype(jnp.uint32)
    s = jnp.sum(a, axis=(1, 2))
    ss = jnp.sum(a * a, axis=(1, 2))
    dh = jnp.abs(a[:, :, 1:].astype(jnp.int32) - a[:, :, :-1].astype(jnp.int32))
    sh = jnp.sum(dh, axis=(1, 2)).astype(jnp.uint32)
    dv = jnp.abs(a[:, 1:, :].astype(jnp.int32) - a[:, :-1, :].astype(jnp.int32))
    sv = jnp.sum(dv, axis=(1, 2)).astype(jnp.uint32)
    n = HP_SAD_SZ * HP_SAD_SZ
    tex = ((sh + sv) // 2) // n
    avg = (s // n).astype(jnp.int32)
    var = (ss - (s * s) // n).astype(jnp.int32)
    return tex, avg, var


def _intra_metric(aw, bw_, cw, ch, BW: int, BH: int):
    """intra_metric (hme.c:89-134) on (nb, BH, BW) windows with clip masks.

    Returns bool: inter is 'good' (keep zero-MV inter)."""
    a = aw.astype(jnp.int32)
    b = bw_.astype(jnp.int32)
    colm = (jnp.arange(BW)[None, :] < cw[:, None])
    rowm = (jnp.arange(BH)[None, :] < ch[:, None])
    m = (colm[:, None, :] & rowm[:, :, None]).astype(jnp.uint32)
    dif = jnp.abs(a - b)
    ngood = jnp.where(dif == 0, 192, jnp.where(dif == 1, 128,
                                               jnp.where(dif == 2, 96, 0)))
    nevil = jnp.where(dif > 2, dif, 0)
    # horizontal gradients (first column term is zero)
    gh_a = jnp.pad(jnp.abs(a[:, :, 1:] - a[:, :, :-1]), ((0, 0), (0, 0), (1, 0)))
    gh_b = jnp.pad(jnp.abs(b[:, :, 1:] - b[:, :, :-1]), ((0, 0), (0, 0), (1, 0)))
    # vertical gradients (first row term is zero)
    gv_a = jnp.pad(jnp.abs(a[:, 1:, :] - a[:, :-1, :]), ((0, 0), (1, 0), (0, 0)))
    gv_b = jnp.pad(jnp.abs(b[:, 1:, :] - b[:, :-1, :]), ((0, 0), (1, 0), (0, 0)))
    good = jnp.sum((ngood + gh_a + gh_b + gv_a + gv_b).astype(jnp.uint32) * m,
                   axis=(1, 2))
    evil = jnp.sum(nevil.astype(jnp.uint32) * m, axis=(1, 2))
    return good >= (((cw + ch).astype(jnp.uint32) >> 1) * evil)


def _block_intra_test(srcw, refw, cw, ch, BW: int, BH: int):
    """D.3 reduced-range intra simulation (hme.c:143-178).

    Returns bool: True if the block would NOT survive intra (go inter)."""
    colm = (jnp.arange(BW)[None, :] < cw[:, None])
    rowm = (jnp.arange(BH)[None, :] < ch[:, None])
    m = colm[:, None, :] & rowm[:, :, None]
    r = refw.astype(jnp.uint32) * m.astype(jnp.uint32)
    area = jnp.maximum((cw * ch).astype(jnp.uint32), 1)
    ravg = (jnp.sum(r, axis=(1, 2)) // area).astype(jnp.int32)
    dec = srcw.astype(jnp.int32)
    rv = ravg[:, None, None]
    inner = jnp.clip(dec - rv + 128, 0, 255)
    dif = jnp.clip(rv + inner - 128, 0, 255)
    bad = (dif != dec) & m
    return jnp.any(bad, axis=(1, 2))


def _refine_common(level: int, mvf, src_img, ref_img, layout: FrameLayout,
                   blk_w: int, blk_h: int, nbh: int, nbv: int):
    """Candidate selection + 9-point full-pel refine for one level.

    mvf: (nbv, nbh, 2) int32 parent MV field (full-res units) or None.
    Returns (bx, by, bw_c, bh_c, valid, dx, dy, best) for active blocks,
    plus the active index grids.
    """
    step = 1 << level
    p = layout.planes[0]
    w, h = p.w, p.h
    ii = np.arange(0, nbh, step)
    jj = np.arange(0, nbv, step)
    gj, gi = jnp.meshgrid(jnp.asarray(jj), jnp.asarray(ii), indexing="ij")
    # runtime-barrier the block grid so downstream window gathers never see
    # constant indices (see ops/opt.py)
    gi_f, gj_f = runtime(gi.reshape(-1), gj.reshape(-1))
    bx = (gi_f * blk_w) >> level
    by = (gj_f * blk_h) >> level
    inframe = (bx < w) & (by < h)
    bw_c = jnp.clip(w - bx, 0, blk_w)
    bh_c = jnp.clip(h - by, 0, blk_h)
    nb = bx.shape[0]
    BW, BH = blk_w, blk_h

    srcw = _window(src_img, layout, 0, bx, by, BW, BH)
    colmask = (jnp.arange(BW)[None, :] < bw_c[:, None]).astype(jnp.int32)
    rowmask = (jnp.arange(BH)[None, :] < bh_c[:, None]).astype(jnp.int32)

    # --- inherited candidates: zero + 5 parent-grid neighbours (hme.c:452-510)
    if mvf is None:
        cand = jnp.zeros((nb, 1, 2), jnp.int32)
        ncand = 1
    else:
        parent_mask = ~((step << 1) - 1)
        pi = gi_f & parent_mask
        pj = gj_f & parent_mask
        cands = [jnp.zeros((nb, 2), jnp.int32)]
        for (ox, oy) in PT:
            x = pi + int(ox) * step
            y = pj + int(oy) * step
            ok = (x >= 0) & (x < nbh) & (y >= 0) & (y < nbv)
            xc = jnp.clip(x, 0, nbh - 1)
            yc = jnp.clip(y, 0, nbv - 1)
            mv = mvf[yc, xc]
            mv = jnp.where(ok[:, None] & (mv != 0).any(-1, keepdims=True),
                           mv, 0)
            cands.append(mv)
        cand = jnp.stack(cands, axis=1)  # (nb, 6, 2)
        ncand = 6

    if "cands" in DEBUG_SKIP:
        z = jnp.zeros_like(bx)
        return (gi_f, gj_f, bx, by, bw_c, bh_c, inframe, z, z, z + INT_MAX,
                srcw, colmask, rowmask)

    # SAD for all candidates in one batched window gather (invalid ref
    # blocks scored INT_MAX)
    b = FRAME_BORDER
    rx = bx[:, None] + (cand[:, :, 0] >> level)      # (nb, ncand)
    ry = by[:, None] + (cand[:, :, 1] >> level)
    ok = ((rx >= -b) & (ry >= -b) & (rx + bw_c[:, None] <= w + b)
          & (ry + bh_c[:, None] <= h + b) & inframe[:, None])
    refw = _window(ref_img, layout, 0, rx.reshape(-1), ry.reshape(-1),
                   BW, BH).reshape(nb, ncand, BH, BW)
    d = jnp.abs(srcw[:, None].astype(jnp.int32) - refw.astype(jnp.int32))
    d = d * colmask[:, None, None, :] * rowmask[:, None, :, None]
    scores = jnp.where(ok, jnp.sum(d, axis=(2, 3)), INT_MAX)
    bestk = jnp.argmin(scores, axis=1)
    bdx = jnp.take_along_axis(cand[:, :, 0], bestk[:, None], 1)[:, 0] >> level
    bdy = jnp.take_along_axis(cand[:, :, 1], bestk[:, None], 1)[:, 0] >> level
    # candidates only searched when more than one distinct (n > 1); with a
    # single (zero) candidate the start is zero — bestk handles both since
    # duplicates/invalids can't strictly beat slot 0.

    # full-pel clamp (hme.c:519-520)
    bdx = jnp.clip(bdx, -bw_c - bx, w - bx)
    bdy = jnp.clip(bdy, -bh_c - by, h - by)

    if "ninepoint" in DEBUG_SKIP:
        best0 = jnp.take_along_axis(scores, bestk[:, None], 1)[:, 0]
        return (gi_f, gj_f, bx, by, bw_c, bh_c, inframe, bdx, bdy, best0,
                srcw, colmask, rowmask)

    # 9-point refine (hme.c:526-541) — no validity checks in the reference.
    # One (BH+2, BW+2) padded window per block; the 9 shifted views are
    # static slices (saves 8 window gathers per level).
    xx = bx + bdx
    yy = by + bdy
    padw = _window(ref_img, layout, 0, xx - 1, yy - 1, BW + 2, BH + 2)
    s9 = []
    for k in range(9):
        oy, ox = int(YF[k]) + 1, int(XF[k]) + 1
        refw = padw[:, oy:oy + BH, ox:ox + BW]
        s9.append(_masked_sad(srcw, refw, colmask, rowmask))
    s9 = jnp.stack(s9, axis=1)
    m9 = jnp.argmin(s9, axis=1)
    best = jnp.min(s9, axis=1)
    dx = bdx + jnp.asarray(XF)[m9]
    dy = bdy + jnp.asarray(YF)[m9]
    return (gi_f, gj_f, bx, by, bw_c, bh_c, inframe, dx, dy, best, srcw,
            colmask, rowmask)


def refine_coarse(level: int, mvf, src_img, ref_img, layout: FrameLayout,
                  blk_w: int, blk_h: int, nbh: int, nbv: int):
    """Levels > 0: returns updated (nbv, nbh, 2) MV field (full-res units)."""
    (gi, gj, bx, by, bw_c, bh_c, inframe, dx, dy, best, _s, _c, _r) = \
        _refine_common(level, mvf, src_img, ref_img, layout,
                       blk_w, blk_h, nbh, nbv)
    mvx = jnp.where(inframe, dx << level, 0)
    mvy = jnp.where(inframe, dy << level, 0)
    out = jnp.zeros((nbv, nbh, 2), jnp.int32)
    out = out.at[gj, gi, 0].set(mvx)
    out = out.at[gj, gi, 1].set(mvy)
    return out


def refine_base(mvf, src_img, ref_img, layout: FrameLayout,
                blk_w: int, blk_h: int, nbh: int, nbv: int, subsamp: int,
                effort: int = 0):
    """Level 0: half-pel refine + intra decision + block metrics
    (hme.c:543-722). Returns per-block arrays shaped (nbv, nbh).

    effort > 0 is a beyond-reference mode: an exhaustive ±2·effort
    full-pel window around the 9-point/candidate best, before the
    half-pel stage. The bitstream does not encode how MVs were found,
    so streams stay spec-valid and reference-decodable; better
    prediction means fewer residual bits at the same quant. effort == 0
    reproduces the reference search decision-for-decision."""
    (gi, gj, bx, by, bw_c, bh_c, inframe, dx, dy, best, srcw,
     colmask, rowmask) = _refine_common(0, mvf, src_img, ref_img, layout,
                                        blk_w, blk_h, nbh, nbv)
    if effort > 0:
        # one padded window per block covers all (2R+1)^2 shifted views
        # as static slices (same trick as the 9-point refine above)
        R = 2 * effort
        dx0, dy0 = dx, dy
        padw = _window(ref_img, layout, 0, bx + dx0 - R, by + dy0 - R,
                       blk_w + 2 * R, blk_h + 2 * R)
        for oy in range(2 * R + 1):
            for ox in range(2 * R + 1):
                if oy == R and ox == R:
                    continue  # centre SAD is already `best`
                s = _masked_sad(srcw, padw[:, oy:oy + blk_h, ox:ox + blk_w],
                                colmask, rowmask)
                better = s < best
                best = jnp.where(better, s, best)
                dx = jnp.where(better, dx0 + (ox - R), dx)
                dy = jnp.where(better, dy0 + (oy - R), dy)
    p = layout.planes[0]
    w, h = p.w, p.h
    nb = bx.shape[0]
    yarea = (bw_c * bh_c).astype(jnp.int32)
    yareasq = (yarea.astype(jnp.uint32) * yarea.astype(jnp.uint32))
    hpel_thresh = blk_w * blk_h
    HP = HP_SAD_SZ

    variants = hpel_variants_luma(ref_img, layout, 0)
    n = ref_img.shape[0]
    vflat = variants.reshape(-1)

    # centre 14x14 window (hme.c:560-562)
    cx = bx + (bw_c >> 1) - HP // 2
    cy = by + (bh_c >> 1) - HP // 2
    srcw14 = _window(src_img, layout, 0, cx, cy, HP, HP)

    if "halfpel" in DEBUG_SKIP:
        mvx = dx << 1
        mvy = dy << 1
        refblk = srcw14
        return _base_tail(gi, gj, bx, by, bw_c, bh_c, inframe, best, srcw,
                          srcw14, refblk, mvx, mvy, src_img, ref_img, layout,
                          blk_w, blk_h, nbh, nbv, subsamp, yareasq)

    do_hp = (best > hpel_thresh) & inframe
    best_hp0 = best * (HP * HP) // jnp.maximum(yarea, 1)
    if effort > 0:
        # beyond-reference: full half-pel grid ±(1+effort) around the
        # full-pel best instead of the 8 unit neighbours (spec-valid —
        # precision stays half-pel, only the searched set widens)
        rh = 1 + effort
        xh = np.array([x for y in range(-rh, rh + 1)
                       for x in range(-rh, rh + 1) if (x, y) != (0, 0)],
                      np.int32)
        yh = np.array([y for y in range(-rh, rh + 1)
                       for x in range(-rh, rh + 1) if (x, y) != (0, 0)],
                      np.int32)
    else:
        xh, yh = XH, YH
    npts = len(xh)
    # all half-pel offsets in one batched variant-window fetch
    X8 = 2 * (cx + dx)[:, None] + jnp.asarray(xh)[None, :]
    Y8 = 2 * (cy + dy)[:, None] + jnp.asarray(yh)[None, :]
    refw8 = _window_variants(
        vflat, n, layout,
        (((X8 & 1) << 1) | (Y8 & 1)).reshape(-1),
        (X8 >> 1).reshape(-1), (Y8 >> 1).reshape(-1), HP, HP) \
        .reshape(nb, npts, HP, HP)
    s8 = jnp.sum(jnp.abs(srcw14[:, None].astype(jnp.int32)
                         - refw8.astype(jnp.int32)), axis=(2, 3))
    # strict-improvement argmin against the scaled threshold (hme.c:569-576)
    run_best = best_hp0
    run_m = jnp.full((nb,), -1, jnp.int32)
    for k in range(npts):
        better = s8[:, k] < run_best
        run_best = jnp.where(better, s8[:, k], run_best)
        run_m = jnp.where(better, k, run_m)
    hp_hit = do_hp & (run_m >= 0)
    mvx = jnp.where(hp_hit, (dx << 1) + jnp.asarray(xh)[jnp.maximum(run_m, 0)],
                    dx << 1)
    mvy = jnp.where(hp_hit, (dy << 1) + jnp.asarray(yh)[jnp.maximum(run_m, 0)],
                    dy << 1)
    best = jnp.where(hp_hit, run_best * yarea // (HP * HP), best)

    # refblock: centre window of the chosen (half-pel) prediction
    RX = 2 * cx + mvx
    RY = 2 * cy + mvy
    refblk = _window_variants(vflat, n, layout,
                              ((RX & 1) << 1) | (RY & 1), RX >> 1, RY >> 1,
                              HP, HP)

    return _base_tail(gi, gj, bx, by, bw_c, bh_c, inframe, best, srcw,
                      srcw14, refblk, mvx, mvy, src_img, ref_img, layout,
                      blk_w, blk_h, nbh, nbv, subsamp, yareasq)


def _base_tail(gi, gj, bx, by, bw_c, bh_c, inframe, best, srcw, srcw14,
               refblk, mvx, mvy, src_img, ref_img, layout, blk_w, blk_h,
               nbh, nbv, subsamp, yareasq):
    nb = bx.shape[0]
    HP = HP_SAD_SZ
    # block metrics (hme.c:598-648); out-of-frame blocks stay zeroed like the
    # reference's calloc'd MV fields (hme.c:442-445)
    luma_var, luma_tex, _, _ = _block_analysis(srcw, bw_c, bh_c, blk_w, blk_h)
    lo_tex = (luma_tex <= 2) & inframe
    lo_var = (luma_var < yareasq) & inframe
    src_tex, src_avg, src_var = _block_texture14(srcw14)
    ref_tex, ref_avg, ref_var = _block_texture14(refblk)

    if "intra" in DEBUG_SKIP:
        z = jnp.zeros((nbv, nbh), jnp.int32)
        return {"mode": z + MODE_INTER, "mvx": z, "mvy": z, "submask": z,
                "lo_tex": z + lo_tex.reshape(nbv, nbh), "lo_var": z,
                "high_detail": z + src_var.reshape(nbv, nbh),
                "nintra": jnp.int32(0)}

    # intra decision cascade (hme.c:650-716)
    zerow = _window(ref_img, layout, 0, bx, by, blk_w, blk_h)
    zvar = _y_sqrvar(zerow, bw_c, bh_c, blk_w, blk_h)
    ubest = best.astype(jnp.uint32)
    go_intra = (
        ((src_tex < 2) & (zvar > luma_var * 2))
        | (ref_var > src_var * 2)
        | ((src_tex == 0) & (ref_tex != 0))
        | (jnp.abs(src_avg - ref_avg) > 8)
        | ((luma_tex <= 10) & (ubest > yareasq // 16))
    )
    # chroma variance check (hme.c:667-682)
    hs, vs = format_h_shift(subsamp), format_v_shift(subsamp)
    cbx = gi * (blk_w >> hs)
    cby = gj * (blk_h >> vs)
    cbw = blk_w >> hs
    cbh = blk_h >> vs
    ccw = bw_c >> hs
    cch = bh_c >> vs
    cvars_s, cvars_r = [], []
    for img in (src_img, ref_img):
        vs_ = []
        for c in (1, 2):
            wv = _window(img, layout, c, cbx, cby, cbw, cbh)
            vs_.append(_y_sqrvar(wv, ccw, cch, cbw, cbh))
        cvars_s.append(jnp.maximum(vs_[0], vs_[1]))
    cvarS, cvarR = cvars_s
    go_intra = go_intra | (cvarR > 4 * cvarS)

    # intra confirmation + sub-block masks (hme.c:684-716)
    not_intra_after_test = _block_intra_test(srcw, zerow, bw_c, bh_c,
                                             blk_w, blk_h)
    sbw = bw_c // 2
    sbh = bh_c // 2
    hi_tex = src_tex > 1
    # all 4 sub-block quadrants in one batched window fetch per image
    fq = jnp.asarray(np.array([0, 1, 0, 1], np.int32))
    gq = jnp.asarray(np.array([0, 0, 1, 1], np.int32))
    qx = (bx[:, None] + fq[None, :] * sbw[:, None]).reshape(-1)
    qy = (by[:, None] + gq[None, :] * sbh[:, None]).reshape(-1)
    aq = _window(src_img, layout, 0, qx, qy, blk_w // 2, blk_h // 2)
    bq = _window(ref_img, layout, 0, qx, qy, blk_w // 2, blk_h // 2)
    good4 = _intra_metric(
        aq, bq, jnp.repeat(sbw, 4), jnp.repeat(sbh, 4),
        blk_w // 2, blk_h // 2).reshape(nb, 4)
    clear = (hi_tex[:, None] & good4).astype(jnp.int32)
    qbits = jnp.sum(clear * jnp.asarray([1, 2, 4, 8])[None, :], axis=1)
    submask = MASK_ALL_INTRA & ~qbits
    is_intra = (go_intra & ~not_intra_after_test & (submask != 0) & inframe)

    mode = jnp.where(is_intra, MODE_INTRA, MODE_INTER).astype(jnp.int32)
    submask = jnp.where(is_intra, submask, 0)
    mvx = jnp.where(inframe, mvx, 0)
    mvy = jnp.where(inframe, mvy, 0)

    # second pass: high_detail from left/top/topleft neighbours (hme.c:620-648)
    def grid(x, fill=0):
        g = jnp.full((nbv, nbh), fill, x.dtype)
        return g.at[gj, gi].set(x)

    g_mode = grid(mode)
    g_lotex = grid(lo_tex.astype(jnp.int32))
    g_lovar = grid(lo_var.astype(jnp.int32))
    strong = (g_mode == MODE_INTER) & (g_lotex == 0) & (g_lovar == 0)

    def shifted(a, dy_, dx_, fill=False):
        out = jnp.full_like(a, fill)
        if dy_ == 0 and dx_ == 0:
            return a
        return out.at[dy_:, dx_:].set(a[:a.shape[0] - dy_, :a.shape[1] - dx_])

    left = shifted(strong, 0, 1)
    top = shifted(strong, 1, 0)
    topleft = shifted(strong, 1, 1)
    thresh_var = jnp.full((nbv, nbh), HP * HP, jnp.int32)
    thresh_tex = jnp.ones((nbv, nbh), jnp.uint32)
    thresh_var = jnp.where(left, thresh_var * HP, thresh_var)
    thresh_tex = thresh_tex + left
    thresh_var = jnp.where(top, thresh_var * HP, thresh_var)
    thresh_tex = thresh_tex + top
    thresh_var = jnp.where(topleft, thresh_var * (HP // 4), thresh_var)
    thresh_tex = thresh_tex + topleft
    g_ltex = grid(luma_tex)
    g_svar = grid(src_var)
    high_detail = ((g_ltex > thresh_tex) & (g_svar > thresh_var)
                   & grid(inframe))

    out = {
        "mode": g_mode,
        "mvx": grid(mvx),
        "mvy": grid(mvy),
        "submask": grid(submask),
        "lo_tex": g_lotex,
        "lo_var": g_lovar,
        "high_detail": high_detail.astype(jnp.int32),
        "nintra": jnp.sum(is_intra.astype(jnp.int32)),
    }
    return out


def hme(src_imgs, ref_imgs, layouts, blk_w: int, blk_h: int,
        nbh: int, nbv: int, subsamp: int, levels: int, effort: int = 0):
    """dsv_hme (hme.c:730-741): top-down refinement over the pyramid.

    src_imgs/ref_imgs: flat images, index 0 = full-res padded frame,
    index l = pyramid level l-1. Returns the level-0 result dict and
    intra percentage. effort > 0 widens the level-0 search (see
    refine_base)."""
    mvf = None
    if "coarse" not in DEBUG_SKIP:
        for level in range(levels, 0, -1):
            mvf = refine_coarse(level, mvf, src_imgs[level], ref_imgs[level],
                                layouts[level], blk_w, blk_h, nbh, nbv)
    out = refine_base(mvf, src_imgs[0], ref_imgs[0], layouts[0],
                      blk_w, blk_h, nbh, nbv, subsamp, effort=effort)
    out["intra_pct"] = out["nintra"] * 100 // (nbh * nbv)
    return out
