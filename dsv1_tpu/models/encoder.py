"""DSV1 encoder — byte-exact streams vs the reference encoder.

Orchestration mirrors encode_one_frame (reference dsv_encoder.c:574-694):
GOP bookkeeping and metadata re-emit, scene-change detection on the smallest
pyramid level, hierarchical ME with forced-intra promotion, CRF/ABR rate
control, stability-tracked adaptive quantization, motion/stability substream
coding and packet link offsets.

Device/host split: all per-pixel work (pyramids, HME, prediction/residual,
forward/inverse transforms, quantize+write-back) runs as jitted device
functions cached per geometry; the host carries only the small control state
(RC scalars, stability accumulators — mirroring DSV_ENCODER,
dsv_encoder.h:58-110) and assembles packets with vectorized bit packing.
"""

from dataclasses import dataclass, field
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .. import bits
from ..constants import (FOURCC, GOP_INTRA, MAX_QP_BITS, MAX_QUALITY,
                         MIN_BLOCK_SIZE, MAX_BLOCK_SIZE, MAX_PYRAMID_LEVELS,
                         MODE_INTER, BPF_RESET, PT_EOS, RATE_CONTROL_CRF,
                         VERSION_MINOR, div_round, make_pt, quality_percent,
                         quant_of_quality, round_pow2, round_shift)
from ..ops import bmc, frame as fr, hzcc, sbt
from ..ops.cint import lb2_static
from ..ops.golomb import BitWriter, zbrle_encode
from ..ops.hme import hme as hme_run
from .bitstream import encode_eos_packet, encode_metadata_packet, \
    set_link_offsets, write_packet_hdr
from .metadata import Metadata
from .plane import encode_plane_bits


def size4dim(dim: int) -> int:
    """Resolution-based block size (dsv_encoder.c:556-572)."""
    if dim > 1280:
        return MAX_BLOCK_SIZE
    if dim > 1024:
        return 48
    if dim > 704:
        return 32
    if dim > 352:
        return 24
    return MIN_BLOCK_SIZE


def auto_pyramid_levels(w: int, h: int, nbh: int, nbv: int) -> int:
    """Auto pyramid depth (dsv_encoder.c:602-613)."""
    lvls = lb2_static(min(w, h))
    maxdim = max(nbh, nbv)
    while (1 << lvls) > maxdim:
        lvls -= 1
    return max(3, min(lvls, MAX_PYRAMID_LEVELS))


@dataclass
class EncoderConfig:
    """User-facing knobs (defaults: dsv_enc_init, dsv_encoder.c:696-722)."""
    quality: int = quality_percent(85)
    gop: int = 24
    do_scd: bool = True
    rc_mode: int = RATE_CONTROL_CRF
    rc_high_motion_nudge: bool = True
    bitrate: int = 2**31 - 1
    max_q_step: int = MAX_QUALITY * 1 // 200
    min_quality: int = quality_percent(1)
    max_quality: int = quality_percent(95)
    min_I_frame_quality: int = quality_percent(5)
    intra_pct_thresh: int = 50
    scene_change_delta: int = 4
    stable_refresh: int = 14
    pyramid_levels: int = 0
    # beyond-reference: 0 = reference-parity motion search; 1..3 adds an
    # exhaustive ±2·effort full-pel window at level 0 (ops/hme.py
    # refine_base) — spec-valid streams, better prediction, fewer bits
    effort: int = 0


@lru_cache(maxsize=16)
def _pyr_layouts(subsamp: int, w: int, h: int, levels: int):
    outs = [fr.make_layout(subsamp, w, h, True)]
    for i in range(levels):
        outs.append(fr.make_layout(subsamp, round_shift(w, i + 1),
                                   round_shift(h, i + 1), True))
    return tuple(outs)


def make_prep(subsamp: int, w: int, h: int, levels: int):
    """Pure fn: input planes -> padded image + luma pyramid images +
    smallest-level average luma (for SCD). Shared by the per-frame host
    path and the GOP-scan device path (parallel/gop.py)."""
    layouts = _pyr_layouts(subsamp, w, h, levels)

    def f(planes):
        imgs = [fr.image_from_planes(layouts[0], planes)]
        for i in range(levels):
            lay = layouts[i + 1]
            src = fr.plane_view_ext(imgs[-1], layouts[i], 0, 1)
            luma = fr.ds2x_luma(src, lay.planes[0].w, lay.planes[0].h)
            imgs.append(fr.image_from_luma(lay, luma))
        al = fr.avg_luma(fr.plane_view(imgs[-1], layouts[-1], 0)) \
            if levels else jnp.int32(0)
        return imgs, al

    return f


@lru_cache(maxsize=16)
def _jit_prep(subsamp: int, w: int, h: int, levels: int):
    prep = make_prep(subsamp, w, h, levels)

    @jax.jit
    def f(packed):
        return prep(fr.split_packed_planes(packed, subsamp, w, h))

    return f


@lru_cache(maxsize=16)
def _jit_prep_hme(subsamp: int, w: int, h: int, blk_w: int, blk_h: int,
                  nbh: int, nbv: int, levels: int, effort: int = 0):
    """Fused per-frame prep + HME: one dispatch and one small D2H blob
    instead of two dispatches plus ~10 scalar/array fetches. The padded
    image pyramid stays on device (it becomes the next frame's HME
    reference and the encode-core input)."""
    from ..ops.opt import blob_concat
    layouts = _pyr_layouts(subsamp, w, h, levels)
    prep = make_prep(subsamp, w, h, levels)
    box = {}

    @jax.jit
    def f(packed, ref_imgs):
        imgs, al = prep(fr.split_packed_planes(packed, subsamp, w, h))
        mv = hme_run(list(imgs), list(ref_imgs), list(layouts),
                     blk_w, blk_h, nbh, nbv, subsamp, levels,
                     effort=effort)
        small = dict(mv)
        small["al"] = jnp.asarray(al, jnp.int32)
        blob = blob_concat(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], small),
            1, box)
        return tuple(imgs), blob

    return f, box


@lru_cache(maxsize=16)
def _jit_core_compact(subsamp: int, w: int, h: int, blk_w: int, blk_h: int,
                      nbh: int, nbv: int, has_ref: bool, want_recon: bool,
                      cap_div: int = 128):
    """Encode core with device-side output compaction + blob coalescing:
    P planes as capped sparse (run, value) lists, intra planes as dense
    int8 + LL exception lists (ops/hzcc.py) — one D2H fetch per frame.
    cap_div: sparse cap class from hzcc.sparse_cap_div (at most 3
    compiled variants)."""
    from ..ops.hzcc import compact_dense_i, compact_sparse_p
    from ..ops.opt import blob_concat
    core = make_encode_core(subsamp, w, h, blk_w, blk_h, nbh, nbv,
                            has_ref, want_recon)
    ll_sizes = [int(t.seg_bounds[1])
                for t in coef_geometry(subsamp, w, h, nbh, nbv)[2]]
    box = {}

    nblk = nbh * nbv

    @jax.jit
    def f(input_img, ref_img, smalls):
        # smalls: one coalesced int32 upload — [quant, stable(nblk),
        # mode(nblk), mvx(nblk), mvy(nblk), submask(nblk)] instead of
        # six small uploads
        quant = smalls[0]
        stable = smalls[1:1 + nblk].astype(jnp.uint8)
        m0, m1, m2, m3 = (smalls[1 + (k + 1) * nblk:1 + (k + 2) * nblk]
                          for k in range(4))
        qvals, dcs, recon = core(input_img, ref_img, quant, stable,
                                 m0, m1, m2, m3)
        if has_ref:
            comp = tuple(compact_sparse_p(qv, cap_div) for qv in qvals)
        else:
            comp = tuple(compact_dense_i(qv, ll_n)
                         for qv, ll_n in zip(qvals, ll_sizes))
        out = {"comp": comp,
               "dc": jnp.stack([jnp.asarray(d, jnp.int32) for d in dcs])}
        blob = blob_concat(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], out),
            1, box)
        return blob, recon

    return f, box


def coef_geometry(subsamp: int, w: int, h: int, nbh: int, nbv: int):
    """Per-plane coefficient dims + HZCC traversal tables."""
    layout = fr.make_layout(subsamp, w, h, True)
    coef_dims = []
    for c in range(3):
        p = layout.planes[c]
        if c > 0:
            coef_dims.append((round_pow2(p.w, 1), round_pow2(p.h, 1)))
        else:
            coef_dims.append((p.w, p.h))
    tables = [hzcc.build_tables(cw, ch, nbh, nbv) for (cw, ch) in coef_dims]
    return layout, coef_dims, tables


def make_encode_core(subsamp: int, w: int, h: int, blk_w: int, blk_h: int,
                     nbh: int, nbv: int, has_ref: bool, want_recon: bool):
    """Pure fn: prediction/residual + fwd transform + quantize/write-back +
    in-loop recon for all three planes (encode_picture core,
    dsv_encoder.c:505-526)."""
    layout, coef_dims, tables = coef_geometry(subsamp, w, h, nbh, nbv)

    def f(input_img, ref_recon_img, quant, stable_blocks,
          modes, mvx, mvy, submask):
        qvals, dcs, recon_planes, preds = [], [], [], []
        for c in range(3):
            p = layout.planes[c]
            cw, ch = coef_dims[c]
            src_ext = fr.plane_view_ext(input_img, layout, c, cw - p.w)
            if has_ref:
                ref_plane = fr.plane_view(ref_recon_img, layout, c)
                pred = bmc.compensate_plane(
                    ref_recon_img, ref_plane, layout, c, blk_w, blk_h,
                    nbh, nbv, modes, mvx, mvy, submask)
                core = bmc.sub_residual(src_ext[:p.h, :p.w], pred)
                preds.append(pred)
            else:
                core = src_ext[:p.h, :p.w]
            coefs = jnp.zeros((ch, cw), jnp.int32)
            coefs = coefs.at[:p.h, :p.w].set(core.astype(jnp.int32) - 128)
            if cw > p.w:
                # p2sbc reads the replicated border column (original edge)
                edge = src_ext[:p.h, p.w:cw].astype(jnp.int32) - 128
                coefs = coefs.at[:p.h, p.w:cw].set(edge)
            coefs = sbt.fwd_sbt(coefs, is_p=has_ref)
            qv, wb = hzcc.encode_plane_core(coefs, quant, has_ref, c,
                                            stable_blocks, tables[c])
            qvals.append(qv)
            dcs.append(coefs[0, 0])
            if want_recon:
                rec = sbt.inv_sbt(wb, quant, is_p=has_ref, is_luma=(c == 0))
                rp = sbt.coefs_to_plane(rec)[:p.h, :p.w]
                if has_ref:
                    rp = bmc.add_residual(preds[c], rp)
                recon_planes.append(rp)
        recon_img = (fr.image_from_planes(layout, recon_planes)
                     if want_recon else jnp.int32(0))
        return qvals, dcs, recon_img

    return f


@lru_cache(maxsize=16)
def _jit_encode_core(subsamp: int, w: int, h: int, blk_w: int, blk_h: int,
                     nbh: int, nbv: int, has_ref: bool, want_recon: bool):
    return jax.jit(make_encode_core(subsamp, w, h, blk_w, blk_h, nbh, nbv,
                                    has_ref, want_recon))


def make_encode_core_traced(subsamp: int, w: int, h: int, blk_w: int,
                            blk_h: int, nbh: int, nbv: int,
                            tile_hook=None):
    """Pure fn like make_encode_core but with is_p as a traced operand
    and recon always produced: a single compiled core serves both I and
    P frames in the GOP scan (parallel/gop.py). Computing both level-1
    transforms and selecting is far cheaper than duplicating the whole
    core under a vmapped lax.cond (which executes both branches anyway).

    tile_hook, if given, is `hook(cw, ch) -> constrain` producing a
    per-level sharding-constraint fn for ops.sbt — the gop×tile 2-D mesh
    path (parallel/gop.py): each plane's subband transforms run
    column-sharded over the mesh's 'tile' axis with SPMD-inserted halo
    exchanges, numerically identical to the unsharded program.
    """
    layout, coef_dims, tables = coef_geometry(subsamp, w, h, nbh, nbv)

    def f(input_img, ref_recon_img, is_p, quant, stable_blocks,
          modes, mvx, mvy, submask):
        qvals, dcs, recon_planes = [], [], []
        for c in range(3):
            p = layout.planes[c]
            cw, ch = coef_dims[c]
            con = tile_hook(cw, ch) if tile_hook is not None else None
            src_ext = fr.plane_view_ext(input_img, layout, c, cw - p.w)
            ref_plane = fr.plane_view(ref_recon_img, layout, c)
            with jax.named_scope("dsv_mc"):
                pred = bmc.compensate_plane(
                    ref_recon_img, ref_plane, layout, c, blk_w, blk_h,
                    nbh, nbv, modes, mvx, mvy, submask)
            src_core = src_ext[:p.h, :p.w]
            core = jnp.where(is_p, bmc.sub_residual(src_core, pred),
                             src_core)
            coefs = jnp.zeros((ch, cw), jnp.int32)
            coefs = coefs.at[:p.h, :p.w].set(core.astype(jnp.int32) - 128)
            if cw > p.w:
                # p2sbc reads the replicated border column (original edge)
                edge = src_ext[:p.h, p.w:cw].astype(jnp.int32) - 128
                coefs = coefs.at[:p.h, p.w:cw].set(edge)
            coefs = sbt.fwd_sbt(coefs, is_p, constrain=con)
            qv, wb = hzcc.encode_plane_core(coefs, quant, is_p, c,
                                            stable_blocks, tables[c])
            qvals.append(qv)
            dcs.append(coefs[0, 0])
            rec = sbt.inv_sbt(wb, quant, is_p, is_luma=(c == 0),
                              constrain=con)
            rp = sbt.coefs_to_plane(rec)[:p.h, :p.w]
            rp = jnp.where(is_p, bmc.add_residual(pred, rp), rp)
            recon_planes.append(rp)
        return qvals, dcs, fr.image_from_planes(layout, recon_planes)

    return f


def pack_picture(fnum: int, blk_w: int, blk_h: int, stable: np.ndarray,
                 has_ref: bool, is_ref: bool, mv: dict | None, quant: int,
                 qvals3, dcs3, nbh: int, nbv: int) -> bytearray:
    """Host-side picture packet assembly (encode_picture,
    dsv_encoder.c:463-536). qvals3/dcs3: per-plane traversal-ordered
    quantized values + raw DCs from the device encode core. The whole
    packet (stability ZBRLE, motion substreams, plane symbol streams) is
    assembled in one native call (native/dsvbits.cpp dsv1n_pack_picture)."""
    planes = []
    for ci in range(3):
        q3 = qvals3[ci]
        if isinstance(q3, tuple):
            runs, vals = q3
        else:
            runs, vals = hzcc.runs_from_qvals(np.asarray(q3))
        planes.append((runs, vals, int(dcs3[ci])))
    return bits.pack_picture(
        FOURCC, VERSION_MINOR, make_pt(is_ref, has_ref), fnum, blk_w, blk_h,
        nbh, nbv, stable, has_ref,
        mv["mode"].reshape(-1) if has_ref else None,
        mv["mvx"].reshape(-1) if has_ref else None,
        mv["mvy"].reshape(-1) if has_ref else None,
        mv["submask"].reshape(-1) if has_ref else None,
        quant, MAX_QP_BITS, planes)


def quality2quant_abr(st, cfg, meta, is_p: bool, forced_intra: bool) -> int:
    """ABR branch of quality2quant (dsv_encoder.c:70-168) over mutable
    rate-control state `st` (attrs: rc_quant, bpf_avg, avg_P_frame_q,
    last_P_frame_over, back_into_range). Returns the chosen quality and
    updates st.rc_quant. Shared by the sequential per-frame encoder and
    the GOP-granular parallel ABR (parallel/gop.py)."""
    q = st.rc_quant
    fps = (meta.fps_num << 5) // meta.fps_den or 1
    needed_bpf = ((cfg.bitrate << 5) // fps) >> 3
    bpf = st.bpf_avg or needed_bpf
    dir_ = -1 if (bpf - needed_bpf) > 0 else 1
    delta = (abs(bpf - needed_bpf) << 9) // needed_bpf
    if dir_ == 1:
        delta *= 2
    nudged = False
    if cfg.rc_high_motion_nudge:
        if is_p:
            if st.last_P_frame_over:
                delta = (delta + 1) * 2
                dir_ = -1
                nudged = True
            elif st.back_into_range:
                delta = (delta + 1) * 2
                dir_ = 1
                nudged = True
        elif st.back_into_range:
            delta = (delta + 1) * 2
            dir_ = 1
            nudged = True
    delta = (q * delta) >> 9
    cfg.max_q_step = max(1, min(cfg.max_q_step, MAX_QUALITY))
    cap = cfg.max_q_step * 16 if nudged else cfg.max_q_step
    delta = min(delta, cap)
    q += delta * dir_
    low_p = st.avg_P_frame_q - quality_percent(4)
    low_p = max(cfg.min_quality, min(low_p, cfg.max_quality))
    minq = low_p if is_p else cfg.min_I_frame_quality
    if forced_intra:
        if q < quality_percent(60):
            q += quality_percent(15)
        elif q < quality_percent(70):
            q += quality_percent(8)
        elif q < quality_percent(75):
            q += quality_percent(3)
        q = max(0, min(q, cfg.max_quality - quality_percent(5)))
    q = max(minq, min(q, cfg.max_quality))
    q = max(0, min(q, MAX_QUALITY))
    st.rc_quant = q
    return q


def rc_stats_update_abr(st, cfg, meta, is_p: bool, used_quality: int,
                        pic_len: int):
    """ABR statistics update (dsv_enc, dsv_encoder.c:816-848) over
    mutable state `st` (attrs: bpf_total, bpf_reset, bpf_avg,
    total_P_frame_q, avg_P_frame_q, last_P_frame_over,
    back_into_range)."""
    st.bpf_total += pic_len
    st.bpf_reset += 1
    if is_p:
        st.total_P_frame_q += used_quality
        st.avg_P_frame_q = st.total_P_frame_q // st.bpf_reset
        fps = (meta.fps_num << 5) // meta.fps_den or 1
        needed_bpf = ((cfg.bitrate << 5) // fps) >> 3
        went_under = pic_len < (needed_bpf * 3 // 4)
        needed_bpf = needed_bpf * 7 // 8
        went_over = pic_len > needed_bpf
        st.back_into_range = int(st.last_P_frame_over and went_under)
        st.last_P_frame_over = int(went_over)
    else:
        st.last_P_frame_over = 0
        st.back_into_range = 0
    st.bpf_avg = st.bpf_total // st.bpf_reset
    if st.bpf_reset >= BPF_RESET:
        st.bpf_total = st.bpf_avg
        st.total_P_frame_q //= st.bpf_reset
        st.bpf_reset = 1


class Encoder:
    """Mirrors the reference encoder API (dsv_encoder.h:112-121)."""

    def __init__(self, meta: Metadata, config: EncoderConfig | None = None):
        self.meta = meta
        self.cfg = config or EncoderConfig()
        c = self.cfg
        # dynamic state (dsv_encoder.h:83-110)
        self.rc_quant = 0
        self.bpf_total = 0
        self.bpf_reset = 0
        self.bpf_avg = 0
        self.total_P_frame_q = 0
        self.avg_P_frame_q = 0
        self.last_P_frame_over = 0
        self.back_into_range = 0
        self.next_fnum = 0
        self.prev_gop = -1
        self.prev_avg_luma = 0
        self.refresh_ctr = 0
        self.prev_link = 0
        self._force_meta = False
        self.stability = None       # (nblk, 2) int16 accumulators
        self.stable_blocks = None   # (nblk,) uint8
        self._ref_recon = None      # device image (MC reference)
        self._ref_pyr = None        # list of device images (HME reference)
        self._levels = c.pyramid_levels
        # geometry
        w, h = meta.width, meta.height
        self.blk_w = max(MIN_BLOCK_SIZE,
                         min(size4dim(w) & ~7, MAX_BLOCK_SIZE))
        self.blk_h = max(MIN_BLOCK_SIZE,
                         min(size4dim(h) & ~7, MAX_BLOCK_SIZE))
        self.nbh = div_round(w, self.blk_w)
        self.nbv = div_round(h, self.blk_h)

    def start(self):
        """dsv_enc_start (dsv_encoder.c:724-734)."""
        c = self.cfg
        c.quality = max(0, min(c.quality, MAX_QUALITY))
        if c.rc_mode != RATE_CONTROL_CRF:
            self.rc_quant = c.quality
            self.avg_P_frame_q = c.quality * 4 // 5
        self._force_meta = True

    def force_metadata(self):
        """Force a metadata re-emit (and therefore a GOP restart) on the
        next encoded frame — dsv_enc_force_metadata (dsv_encoder.h:115,
        dsv_encoder.c:760-763). The next frame becomes a GOP start: the
        metadata packet precedes its picture and the frame codes intra,
        exactly like the reference's gop_start path
        (dsv_encoder.c:624-628)."""
        self._force_meta = True

    # ------------------------------------------------------------- RC
    def _quality2quant(self, is_p: bool, forced_intra: bool) -> int:
        """quality2quant (dsv_encoder.c:70-168)."""
        c = self.cfg
        if c.rc_mode != RATE_CONTROL_CRF:
            q = quality2quant_abr(self, c, self.meta, is_p, forced_intra)
        else:
            q = c.quality
            self.rc_quant = q
        return quant_of_quality(q)

    # ------------------------------------------------- stability tracking
    def _stable_blocks_update(self, is_p: bool, mv: dict | None) -> np.ndarray:
        """encode_stable_blocks accumulator logic (dsv_encoder.c:329-400)."""
        nblk = self.nbh * self.nbv
        if self.stability is None:
            self.stability = np.zeros((nblk, 2), np.int16)
            self.stable_blocks = np.zeros(nblk, np.uint8)
        if self.refresh_ctr >= self.cfg.stable_refresh:
            self.refresh_ctr = 0
            self.stability[:] = 0
        avgdiv = max(self.refresh_ctr, 1)
        sx = self.stability[:, 0].astype(np.int32)
        sy = self.stability[:, 1].astype(np.int32)
        if is_p:
            modes = mv["mode"].reshape(-1)
            mvx = mv["mvx"].reshape(-1)
            mvy = mv["mvy"].reshape(-1)
            inter = modes == MODE_INTER
            sx = np.where(inter, sx + (np.abs(mvx) >> 2), sx).astype(np.int16)
            sy = np.where(inter, sy + (np.abs(mvy) >> 2), sy).astype(np.int16)
            ax = np.sign(sx) * (np.abs(sx.astype(np.int32)) // avgdiv)
            ay = np.sign(sy) * (np.abs(sy.astype(np.int32)) // avgdiv)
            lo = (mv["lo_tex"].reshape(-1) != 0) | (mv["lo_var"].reshape(-1) != 0)
            stable = (mv["high_detail"].reshape(-1) != 0)
            stable |= (ax == 0) & (ay == 0) & ~lo
            stable &= inter
            intra_blk = ~inter
            sx = np.where(lo, 0x3FFF, sx).astype(np.int16)
            sy = np.where(lo, 0x3FFF, sy).astype(np.int16)
        else:
            ax = np.sign(sx) * (np.abs(sx) // avgdiv)
            ay = np.sign(sy) * (np.abs(sy) // avgdiv)
            stable = (ax == 0) & (ay == 0)
            intra_blk = np.zeros(nblk, bool)
        self.stability[:, 0] = sx
        self.stability[:, 1] = sy
        self.stable_blocks = (stable.astype(np.uint8)
                              | (intra_blk.astype(np.uint8) << 1))
        return self.stable_blocks

    # ------------------------------------------------------------ encode
    def encode(self, planes):
        """Encode one frame; returns list of packet bytearrays (dsv_enc)."""
        meta, c = self.meta, self.cfg
        w, h = meta.width, meta.height
        fnum = self.next_fnum
        self.next_fnum += 1

        if self._levels == 0:
            self._levels = auto_pyramid_levels(w, h, self.nbh, self.nbv)
        levels = self._levels if c.gop != GOP_INTRA else 0

        from ..ops.opt import blob_split

        gop_start = self._force_meta or (self.prev_gop + c.gop) <= fnum
        if gop_start:
            self.prev_gop = fnum
            self._force_meta = False

        packed = fr.np_pack_planes(planes)  # one coalesced H2D per frame
        mv = None
        maybe_p = (c.gop != GOP_INTRA and not gop_start
                   and self._ref_pyr is not None)
        if maybe_p:
            # fused prep + HME: one dispatch, one blob fetch. HME runs
            # before the SCD verdict is known — wasted only on actual
            # scene cuts, byte-identical either way (mv is discarded).
            run, box = _jit_prep_hme(meta.subsamp, w, h, self.blk_w,
                                     self.blk_h, self.nbh, self.nbv, levels,
                                     c.effort)
            imgs, blob = run(packed, tuple(self._ref_pyr))
            o = blob_split(jax.device_get(blob), box)
            al = int(o.pop("al")[0])
            mv = {k: v[0] for k, v in o.items()}
        else:
            prep = _jit_prep(meta.subsamp, w, h, levels)
            imgs, al_d = prep(packed)
            al = int(al_d)

        if c.gop == GOP_INTRA:
            is_ref = False
            has_ref = False
            forced_intra = False
        else:
            is_ref = True
            has_ref = not gop_start
            forced_intra = False
            if c.do_scd:
                if abs(self.prev_avg_luma - al) > c.scene_change_delta:
                    has_ref = False
                    forced_intra = True
                self.prev_avg_luma = al

        if has_ref and int(mv["intra_pct"]) > c.intra_pct_thresh:
            has_ref = False
            forced_intra = True
        if not has_ref:
            mv = None

        quant = self._quality2quant(has_ref, forced_intra)
        stable = self._stable_blocks_update(has_ref, mv)

        # device: prediction/residual + transforms + quantization + recon,
        # outputs compacted and blob-coalesced (one D2H fetch)
        want_recon = is_ref and c.gop != GOP_INTRA
        core, cbox = _jit_core_compact(meta.subsamp, w, h, self.blk_w,
                                       self.blk_h, self.nbh, self.nbv,
                                       has_ref, want_recon,
                                       hzcc.sparse_cap_div(quant))
        nblk = self.nbh * self.nbv
        smalls = np.empty(1 + 5 * nblk, np.int32)
        smalls[0] = quant
        smalls[1:1 + nblk] = stable
        if has_ref:
            for k, name in enumerate(("mode", "mvx", "mvy", "submask")):
                smalls[1 + (k + 1) * nblk:1 + (k + 2) * nblk] = \
                    mv[name].reshape(-1)
        else:
            smalls[1 + nblk:] = 0
        ref_arg = self._ref_recon if has_ref else jnp.int32(0)
        blob, recon_img = core(imgs[0], ref_arg, smalls)
        o = blob_split(jax.device_get(blob), cbox)
        dcs = o["dc"][0]
        qvals = self._uncompact(o["comp"], has_ref, imgs, ref_arg, smalls)

        # host: picture packet assembly (encode_picture, dsv_encoder.c:463-536)
        picture = pack_picture(fnum, self.blk_w, self.blk_h, stable, has_ref,
                               is_ref, mv, quant, qvals, dcs,
                               self.nbh, self.nbv)

        if want_recon:
            self._ref_recon = recon_img
            self._ref_pyr = imgs

        packets = []
        if gop_start:
            packets.append(encode_metadata_packet(meta))
        packets.append(picture)

        if has_ref:
            self.refresh_ctr += 1
        self._rc_stats_update(has_ref, len(picture))
        set_link_offsets(picture, self.prev_link, len(picture))
        self.prev_link = len(picture)
        return packets

    def _uncompact(self, comp, has_ref, imgs, ref_arg, smalls):
        """Compacted device outputs -> per-plane (runs, vals) symbol
        tuples; rare cap overflows re-run the dense int32 core."""
        from .. import bits as native_bits
        if has_ref:
            ovf = any(bool(comp[ci][3][0]) for ci in range(3))
        else:
            ovf = any(int(comp[ci][3][0]) > 0 for ci in range(3))
        if ovf:
            meta = self.meta
            nblk = self.nbh * self.nbv
            core = _jit_encode_core(meta.subsamp, meta.width, meta.height,
                                    self.blk_w, self.blk_h, self.nbh,
                                    self.nbv, has_ref, False)
            margs = tuple(smalls[1 + (k + 1) * nblk:1 + (k + 2) * nblk]
                          for k in range(4))
            qv, _dcs, _ = core(imgs[0], ref_arg, jnp.int32(int(smalls[0])),
                               jnp.asarray(smalls[1:1 + nblk], jnp.uint8),
                               *margs)
            return [np.asarray(q) for q in qv]
        out = []
        for ci in range(3):
            if has_ref:
                runs, vals, cnt, _ = comp[ci]
                n = int(cnt[0])
                out.append((runs[0][:n].astype(np.uint32),
                            vals[0][:n].astype(np.int32)))
            else:
                q8, pos, vals, _ = comp[ci]
                out.append(native_bits.runs_from_dense8(
                    q8[0], pos[0], vals[0]))
        return out

    def _rc_stats_update(self, is_p: bool, pic_len: int):
        """ABR statistics (dsv_enc, dsv_encoder.c:816-848)."""
        if self.cfg.rc_mode == RATE_CONTROL_CRF:
            return
        rc_stats_update_abr(self, self.cfg, self.meta, is_p, self.rc_quant,
                            pic_len)

    def end_of_stream(self) -> bytearray:
        """dsv_enc_end_of_stream (dsv_encoder.c:766-778)."""
        pkt = encode_eos_packet(self.prev_link)
        self.prev_link = 0
        return pkt

    # ------------------------------------------------ checkpoint / resume
    _STATE_SCALARS = (
        "rc_quant", "bpf_total", "bpf_reset", "bpf_avg", "total_P_frame_q",
        "avg_P_frame_q", "last_P_frame_over", "back_into_range", "next_fnum",
        "prev_gop", "prev_avg_luma", "refresh_ctr", "prev_link",
        "_force_meta", "_levels")

    def state_dict(self) -> dict:
        """Complete inter-frame state for resumable encode: the DSV_ENCODER
        scalars + stability accumulators + recon/pyramid reference frames
        (dsv_encoder.h:58-110; SURVEY.md §5 checkpoint/resume). Everything
        is host data — safe to pickle/ship to another host."""
        s = {k: getattr(self, k) for k in self._STATE_SCALARS}
        s["stability"] = None if self.stability is None else self.stability.copy()
        s["stable_blocks"] = (None if self.stable_blocks is None
                              else self.stable_blocks.copy())
        s["ref_recon"] = (None if self._ref_recon is None
                          else np.asarray(self._ref_recon))
        s["ref_pyr"] = (None if self._ref_pyr is None
                        else [np.asarray(x) for x in self._ref_pyr])
        return s

    def load_state_dict(self, s: dict):
        """Resume from state_dict(); the continuation is byte-identical to
        an uninterrupted encode (tested)."""
        for k in self._STATE_SCALARS:
            setattr(self, k, s[k])
        self.stability = None if s["stability"] is None else s["stability"].copy()
        self.stable_blocks = (None if s["stable_blocks"] is None
                              else s["stable_blocks"].copy())
        self._ref_recon = (None if s["ref_recon"] is None
                           else jnp.asarray(s["ref_recon"]))
        self._ref_pyr = (None if s["ref_pyr"] is None
                         else [jnp.asarray(x) for x in s["ref_pyr"]])

    def encode_stream(self, frames) -> bytes:
        """Encode an iterable of (y, u, v) frames into a full .dsv stream."""
        out = bytearray()
        for planes in frames:
            for pkt in self.encode(planes):
                out += pkt
        out += self.end_of_stream()
        return bytes(out)
