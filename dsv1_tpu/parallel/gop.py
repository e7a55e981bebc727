"""GOP-parallel device encode path.

Design (SURVEY.md §5/§7): a closed GOP's frames are serially dependent
through the reconstructed reference frame (dsv_encoder.c:639-647,665-674),
so one GOP = one device-resident `lax.scan` whose carry is exactly the
reference's inter-frame state: recon frame + HME pyramid + stability
accumulators + refresh counter + previous average luma (DSV_ENCODER,
dsv_encoder.h:83-110). GOPs are independent given the per-GOP metadata
re-emit, so the scan is vmapped over a leading GOP axis and sharded over
mesh axis 'gop' — data parallelism with zero collectives on the frame
path; only the host-side packet link fixup (dsv_encoder.c:170-192)
is serial, and it is O(bytes).

Rate control: this path implements CRF (constant quality -> constant
quant, quality2quant tail at dsv_encoder.c:165), which makes every GOP's
device math independent of packed byte counts. ABR feedback
(dsv_encoder.c:70-163) needs the packed size of frame t-1 and therefore
stays on the sequential host path (models/encoder.py).

Byte-exactness: the reference's stability accumulators
(dsv_encoder.h:101-106) are the only encoder state that crosses GOP
boundaries. GOPs are encoded optimistically with zero-initialised
accumulators — exact whenever the reference would reset at the GOP's I
frame (refresh_ctr >= stable_refresh there, the steady state for the CLI
default stable_refresh == gop-1, dsv_main.c:487-489). Exactness for the
remaining cases (a mid-GOP forced-intra frame suppresses the
refresh-counter increment; stable_refresh not dividing gop-1) comes from
a host-side replay: the stability chain depends only on HME outputs and
has_ref verdicts — never on the recon chain — so the host replays it in
numpy from the fetched motion fields (_StabReplay), detects GOPs whose
zero-init assumption was wrong, and re-dispatches just those chunks with
the true per-GOP accumulator state. Cross-GOP SCD state is irrelevant
here: a GOP's first frame is statically intra, so the predecessor's
average luma cannot change any decision.
"""

import math
import os
from collections import Counter
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..constants import (FOURCC, GOP_INTRA, MAX_BLOCK_SIZE, MAX_QP_BITS,
                         MAX_QUALITY, MIN_BLOCK_SIZE, MODE_INTER,
                         RATE_CONTROL_CRF, VERSION_MINOR, div_round,
                         quant_of_quality)
from ..models.bitstream import (encode_eos_packet, encode_metadata_packet,
                                set_link_offsets)
from ..models.encoder import (EncoderConfig, _pyr_layouts,
                              auto_pyramid_levels, coef_geometry,
                              make_encode_core, make_encode_core_traced,
                              make_prep, pack_picture, size4dim)
from ..models.metadata import Metadata
from ..ops import frame as fr
from ..ops.hme import hme as hme_run
from ..ops.hzcc import compact_dense_i as _compact_dense_i
from ..ops.hzcc import compact_sparse_p as _compact_sparse_p
from ..ops.hzcc import sparse_cap_div as hzcc_cap_div
from ..ops import piclen as _piclen
from ..ops import rc as _rc
from ..ops.opt import blob_concat as _blob_concat
from ..ops.opt import blob_split as _blob_split


# Host-side event counts of the encode loops, read by chip_smoke.py and
# the tests: "dense_redo" (a chunk re-run with dense outputs after a
# compaction cap overflow) and "stab_fix" (a chunk re-run with the true
# stability-accumulator state, see _StabReplay).
EVENTS: Counter = Counter()


def crf_quant(quality: int) -> int:
    """quality2quant CRF tail (dsv_encoder.c:165)."""
    return quant_of_quality(quality)


# packed planar frame helpers shared with the sequential encoder
_split_planes = fr.split_packed_planes
plane_sizes = fr.plane_sizes


def block_geometry(w: int, h: int):
    blk_w = max(MIN_BLOCK_SIZE, min(size4dim(w) & ~7, MAX_BLOCK_SIZE))
    blk_h = max(MIN_BLOCK_SIZE, min(size4dim(h) & ~7, MAX_BLOCK_SIZE))
    return blk_w, blk_h, div_round(w, blk_w), div_round(h, blk_h)


def _wrap16(x):
    """int16 two's-complement wrap on int32 values (the reference stores
    the accumulators as int16, dsv_encoder.h:101-106). Kept in int32 on
    device: an earlier backend faulted on sub-32-bit scan carries."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _stable_update(stability, refresh_ctr, is_p, mv, stable_refresh: int):
    """Device mirror of the stability accumulator logic
    (encode_stable_blocks, dsv_encoder.c:329-400). int16 wrap semantics
    on an int32 (nblk, 2) carry.

    Returns (stability', refresh_ctr', stable_blocks u8 bit0=stable
    bit1=intra)."""
    reset = refresh_ctr >= stable_refresh
    refresh_ctr = jnp.where(reset, 0, refresh_ctr)
    stability = jnp.where(reset, 0, stability)
    avgdiv = jnp.maximum(refresh_ctr, 1)
    sx0, sy0 = stability[:, 0], stability[:, 1]
    mode = mv["mode"].reshape(-1)
    inter = mode == MODE_INTER
    # P branch: accumulate quarter-pel magnitudes on inter blocks
    sxp = _wrap16(jnp.where(inter,
                            sx0 + (jnp.abs(mv["mvx"].reshape(-1)) >> 2),
                            sx0))
    syp = _wrap16(jnp.where(inter,
                            sy0 + (jnp.abs(mv["mvy"].reshape(-1)) >> 2),
                            sy0))
    axp = jnp.sign(sxp) * (jnp.abs(sxp) // avgdiv)
    ayp = jnp.sign(syp) * (jnp.abs(syp) // avgdiv)
    lo = (mv["lo_tex"].reshape(-1) != 0) | (mv["lo_var"].reshape(-1) != 0)
    stable_p = (mv["high_detail"].reshape(-1) != 0) \
        | ((axp == 0) & (ayp == 0) & ~lo)
    stable_p &= inter
    sxp = jnp.where(lo, 0x3FFF, sxp)
    syp = jnp.where(lo, 0x3FFF, syp)
    # I branch: accumulators untouched
    axi = jnp.sign(sx0) * (jnp.abs(sx0) // avgdiv)
    ayi = jnp.sign(sy0) * (jnp.abs(sy0) // avgdiv)
    stable_i = (axi == 0) & (ayi == 0)

    stable = jnp.where(is_p, stable_p, stable_i)
    intra_blk = jnp.where(is_p, ~inter, False)
    stability = jnp.where(is_p, jnp.stack([sxp, syp], axis=1), stability)
    stable_blocks = (stable.astype(jnp.uint8)
                     | (intra_blk.astype(jnp.uint8) << 1))
    return stability, refresh_ctr, stable_blocks


def _np_wrap16(x):
    return ((x.astype(np.int64) + 0x8000) & 0xFFFF) - 0x8000


class _StabReplay:
    """Host mirror of the cross-GOP stability accumulator chain
    (encode_stable_blocks state, dsv_encoder.c:345-408 + the refresh
    increment at dsv_encoder.c:813).

    The chain depends only on HME motion fields and the has_ref verdicts
    — both functions of the *input* frames, never of the recon chain or
    the quantizer — so the device outputs feeding it are identical
    whatever accumulator init the device ran with. That makes optimistic
    zero-init encodes verifiable after the fact: `gop_init()` yields the
    true state each GOP's I frame sees, and a GOP needs re-encoding with
    that state iff the reference would NOT reset at its I frame
    (0 < refresh_ctr < stable_refresh; a reset erases any init
    difference, and ctr == 0 implies zeroed accumulators)."""

    def __init__(self, nblk: int, stable_refresh: int,
                 init: tuple | None = None):
        self.sr = stable_refresh
        if init is not None:
            self.stab = np.array(init[0], np.int32).reshape(nblk, 2)
            self.ctr = int(init[1])
        else:
            self.stab = np.zeros((nblk, 2), np.int32)
            self.ctr = 0

    def gop_init(self):
        """(stability, refresh_ctr) entering the next frame, and whether
        a GOP starting here needs the true init (zero-init invalid)."""
        return self.stab.copy(), self.ctr, 0 < self.ctr < self.sr

    def _maybe_reset(self):
        if self.ctr >= self.sr:
            self.ctr = 0
            self.stab[:] = 0

    def step_i(self):
        """I / forced-intra frame: reset check only, no increment."""
        self._maybe_reset()

    def step_p(self, mode, mvx, mvy, mvflags):
        """P frame: accumulate quarter-pel magnitudes on inter blocks,
        lo_tex/lo_var override, then the refresh increment."""
        self._maybe_reset()
        inter = mode.reshape(-1) == MODE_INTER
        ax = np.abs(mvx.reshape(-1).astype(np.int32)) >> 2
        ay = np.abs(mvy.reshape(-1).astype(np.int32)) >> 2
        self.stab[:, 0] = _np_wrap16(
            np.where(inter, self.stab[:, 0] + ax, self.stab[:, 0]))
        self.stab[:, 1] = _np_wrap16(
            np.where(inter, self.stab[:, 1] + ay, self.stab[:, 1]))
        lo = (mvflags.reshape(-1) & 3) != 0
        self.stab[:, 0] = np.where(lo, 0x3FFF, self.stab[:, 0])
        self.stab[:, 1] = np.where(lo, 0x3FFF, self.stab[:, 1])
        self.ctr += 1

    def state(self):
        return self.stab.copy(), self.ctr


def _make_tile_hook(mesh: Mesh, axis: str = "tile"):
    """Per-plane factory of per-level sharding-constraint fns for the
    gop×tile 2-D mesh (SURVEY.md §5 tile axis): fine subband levels stay
    column-sharded over `axis` (the Haar is 2x2-local, the B4T's 4-tap
    halo becomes an SPMD collective-permute), the tiny coarse tail is
    replicated — the same policy as parallel/tile.py, applied inside the
    batched GOP pipeline via lax.with_sharding_constraint (which
    composes under vmap/scan: batch dims stay unconstrained)."""
    from .tile import _replicate_level
    from ..ops import sbt as _sbt
    D = mesh.shape[axis]
    U = PartitionSpec.UNCONSTRAINED

    def hook(cw: int, ch: int):
        rep = _replicate_level(cw, ch, _sbt.nlevels(cw, ch), D)

        def con(a, lvl: int):
            tail = axis if lvl < rep else None
            spec = PartitionSpec(*([U] * (a.ndim - 1)), tail)
            return lax.with_sharding_constraint(
                a, NamedSharding(mesh, spec))

        return con

    return hook


@lru_cache(maxsize=8)
def build_gop_encoder(subsamp: int, w: int, h: int, G: int, quality: int,
                      do_scd: bool = True, scd_delta: int = 4,
                      intra_thresh: int = 50, stable_refresh: int = 0,
                      pyramid_levels: int = 0, compact: int = 1024,
                      effort: int = 0, rc_key: tuple | None = None,
                      tile_key: int | None = None,
                      cap_quality: int | None = None):
    """Pure fn encoding one closed CRF GOP of G frames on device.

    f(y[G,h,w]u8, u, v, prev_al0 i32, stab0[nblk,2]i32, refresh0 i32)
      -> (per-frame outputs dict stacked over G, final (stab, refresh, al))
    vmap over a leading GOP axis for multi-GOP batches.

    The GOP's I frame is unrolled out of the scan: its has_ref is a
    compile-time False, so XLA folds away motion estimation, prediction
    and the dual level-1 transform select for it.

    compact != 0 shrinks the dominant device->host transfer: the I
    frame's quantized planes return as dense int8 plus an LL-region
    exception list (intra planes are dense but values are small outside
    LL), while each P frame's planes return
    as capped (position, value) nonzero lists (P planes are sparse but
    can hold large values). Overflow of either cap is counted and the
    caller re-runs that batch with a compact=0 (dense int32) variant.
    """
    blk_w, blk_h, nbh, nbv = block_geometry(w, h)
    levels = pyramid_levels or auto_pyramid_levels(w, h, nbh, nbv)
    stable_refresh = stable_refresh or max(1, min(G - 1, 14))
    layouts = list(_pyr_layouts(subsamp, w, h, levels))
    prep = make_prep(subsamp, w, h, levels)
    tile_hook = (_make_tile_hook(_MESHES[tile_key])
                 if tile_key is not None else None)
    core = make_encode_core_traced(subsamp, w, h, blk_w, blk_h, nbh, nbv,
                                   tile_hook)
    ll_sizes = [int(t.seg_bounds[1])
                for t in coef_geometry(subsamp, w, h, nbh, nbv)[2]]

    def zero_mv():
        z = jnp.zeros((nbv, nbh), jnp.int32)
        return {"mode": z, "mvx": z, "mvy": z, "submask": z,
                "lo_tex": z, "lo_var": z, "high_detail": z,
                "nintra": jnp.int32(0), "intra_pct": jnp.int32(0)}

    def encode_frame(is_p, quant_j, ref_recon, stability, refresh_ctr,
                     img0, mv, compactor, want_len: bool = False,
                     maybe_p: bool = True):
        """Shared I/P frame tail: stability accumulators + encode core.
        want_len additionally computes the exact packed byte size of the
        picture on device (ops/piclen.py) — the rate-law feedback for the
        in-scan ABR path."""
        stability, refresh_ctr, stable_blocks = _stable_update(
            stability, refresh_ctr, is_p, mv, stable_refresh)
        margs = (mv["mode"].reshape(-1), mv["mvx"].reshape(-1),
                 mv["mvy"].reshape(-1), mv["submask"].reshape(-1))
        qvals, dcs, recon = core(img0, ref_recon, is_p, quant_j,
                                 stable_blocks, *margs)
        refresh_ctr = refresh_ctr + is_p.astype(jnp.int32)
        out = {
            "dc": jnp.stack([jnp.asarray(d, jnp.int32) for d in dcs]),
            # narrow dtypes for the D2H copy: modes/submasks are 0..15,
            # MVs are int16 in the reference (dsv.h DSV_MV)
            "mode": mv["mode"].astype(jnp.int8),
            "mvx": mv["mvx"].astype(jnp.int16),
            "mvy": mv["mvy"].astype(jnp.int16),
            "submask": mv["submask"].astype(jnp.int8),
            "stable": stable_blocks,
            "has_ref": is_p,
        }
        if want_len:
            out["pic_len"] = _piclen.picture_len(
                blk_w, blk_h, nbh, nbv, MAX_QP_BITS, stable_blocks, is_p,
                *margs, qvals, dcs, maybe_p=maybe_p)
        if compactor is None:
            out["qvals"] = tuple(qvals)
        else:
            out[compactor[0]] = compactor[1](qvals)
        return recon, stability, refresh_ctr, out

    compact_i_tagged = ("qcomp_i", lambda qvals: tuple(
        _compact_dense_i(qv, ll_n) for qv, ll_n in zip(qvals, ll_sizes))) \
        if compact else None
    # sparse cap sized to the operating point (tools/overflow_sweep.py):
    # high quality -> denser P planes -> wider cap, so the dense-redo
    # fallback stays rare. ABR moves quality at runtime; the start
    # quality picks the class and the fallback covers excursions.
    # sized to the highest quality the encode can reach: under ABR the
    # runtime quality can exceed the start quality, and an undersized
    # cap pays the dense re-encode on every chunk (cap_quality = the
    # rate law's upper bound, cfg.max_quality; None = CRF, fixed)
    cap_div = hzcc_cap_div(quant_of_quality(
        quality if cap_quality is None else max(quality, cap_quality)))
    compact_p_tagged = ("qcomp_p", lambda qvals: tuple(
        _compact_sparse_p(qv, cap_div) for qv in qvals)) \
        if compact else None

    def compact_hoisted(out_i, outs_p):
        """Post-scan compaction for the vmapped CRF batch path.

        Sized-nonzero compaction lowered badly under vmap inside the
        frame scan on an earlier backend; the scan therefore emits dense
        qvals and each plane is compacted afterwards by a lax.map of
        UNBATCHED calls. The extra device memory for the stacked dense
        qvals is G x plane int32 (~150 MB at 1080p gop12)."""
        qv_i = out_i.pop("qvals")  # tuple of (C, n_c)
        out_i["qcomp_i"] = tuple(
            lax.map(lambda q, ll=ll_n: _compact_dense_i(q, ll), qv)
            for qv, ll_n in zip(qv_i, ll_sizes))
        if outs_p is not None:
            qv_p = outs_p.pop("qvals")  # tuple of (C, G-1, n_c)
            comp = []
            for qv in qv_p:
                Cb, Gm1 = qv.shape[:2]
                res = lax.map(lambda q: _compact_sparse_p(q, cap_div),
                              qv.reshape(Cb * Gm1, -1))
                comp.append(jax.tree_util.tree_map(
                    lambda a: a.reshape(Cb, Gm1, *a.shape[1:]), res))
            outs_p["qcomp_p"] = tuple(comp)
        return out_i, outs_p

    def motion(packed):
        """Input-only path shared by the CRF and exact-ABR batch runners
        (hoisted out of the recon scan): prep/pyramids, HME over all
        C*(G-1) P frames, SCD (dsv_encoder.c:538-554) and forced-intra
        promotion (dsv_encoder.c:219-254) verdicts. Depends only on
        consecutive *input* frames, never on the recon chain or quant."""
        C = packed.shape[0]
        B = C * G
        y, u, v = _split_planes(packed.reshape(B, -1), subsamp, w, h)

        def prep_one(a, b, c):
            return prep((a, b, c))

        imgs_all, al_all = jax.vmap(prep_one)(y, u, v)
        al_all = al_all.reshape(C, G)
        if G == 1:
            return imgs_all, al_all, None, None

        def tails(a):
            # (C*G, n) -> P-frame (src, ref) pairs flattened to C*(G-1)
            s = a.reshape(C, G, -1)
            return (s[:, 1:].reshape(C * (G - 1), -1),
                    s[:, :-1].reshape(C * (G - 1), -1))

        pairs = [tails(a) for a in imgs_all]

        def hme_t(sr):
            return hme_run(list(sr[0]), list(sr[1]), layouts,
                           blk_w, blk_h, nbh, nbv, subsamp, levels,
                           effort=effort)

        F = max(1, min(C * (G - 1), (6 << 20) // max(w * h, 1)))
        with jax.named_scope("dsv_hme"):
            mv_all = lax.map(hme_t,
                             (tuple(p[0] for p in pairs),
                              tuple(p[1] for p in pairs)),
                             batch_size=F)
        mv_all = {k: a.reshape((C, G - 1) + a.shape[1:])
                  for k, a in mv_all.items()}
        has_ref_all = mv_all["intra_pct"] <= intra_thresh
        if do_scd:
            has_ref_all &= (jnp.abs(al_all[:, 1:] - al_all[:, :-1])
                            <= scd_delta)
        return imgs_all, al_all, mv_all, has_ref_all

    def run_batch(packed, prev_al0, stab0, refresh0, quants):
        """Batched over a leading GOP axis C: packed is (C, G, fsz) u8
        planar frames (one coalesced H2D transfer per chunk); quants is
        (C, 2) int32 [I-frame quant, P-frame quant] per GOP — constant
        in CRF, per-GOP values under GOP-granular ABR.

        The motion path is hoisted out of the scan (see motion());
        only the genuinely serial part — the in-loop recon chain through
        prediction (dsv_encoder.c:639-674) and the stability accumulators
        — remains a lax.scan (vmapped over C)."""
        C = packed.shape[0]
        with jax.named_scope("dsv_motion"):
            imgs_all, al_all, mv_all, has_ref_all = motion(packed)

        # vmap at batch 1 still lowers through XLA's *batched* gather/
        # scatter/select variants; C == 1 is the norm for >= 1080p
        # chunks, so run the frame functions unbatched and re-add the
        # axis
        if C == 1:
            def bvmap(f):
                def g(*a):
                    sq = jax.tree_util.tree_map(
                        lambda x: jnp.squeeze(x, 0), tuple(a))
                    out = f(*sq)
                    return jax.tree_util.tree_map(lambda y: y[None], out)
                return g
        else:
            bvmap = jax.vmap

        # GOP start: statically intra — XLA folds away its motion path
        qi, qp = quants[:, 0], quants[:, 1]
        imgs0 = imgs_all[0].reshape(C, G, -1)
        zmv = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (C,) + a.shape), zero_mv())

        def frame_i(q1, st, rc, im, mv1):
            # compaction hoisted out of the vmap (see compact_hoisted)
            return encode_frame(jnp.bool_(False), q1,
                                fr.alloc_image(layouts[0]), st, rc, im, mv1,
                                None)

        recon, stability, refresh_ctr, out_i = bvmap(frame_i)(
            qi, stab0, refresh0, imgs0[:, 0], zmv)

        if G > 1:
            def step(carry, x):
                ref_recon, stability, refresh_ctr = carry

                def frame_p(q1, rr, st, rc, im, mv1, hr):
                    return encode_frame(hr, q1, rr, st, rc, im, mv1, None)

                recon, stability, refresh_ctr, out = bvmap(frame_p)(
                    qp, ref_recon, stability, refresh_ctr, *x)
                return (recon, stability, refresh_ctr), out

            xs_mv = {k: jnp.moveaxis(mv_all[k], 0, 1) for k in
                     ("mode", "mvx", "mvy", "submask", "lo_tex", "lo_var",
                      "high_detail")}
            with jax.named_scope("dsv_recon_scan"):
                (_, stability, refresh_ctr), outs_p = lax.scan(
                    step, (recon, stability, refresh_ctr),
                    (jnp.moveaxis(imgs0[:, 1:], 0, 1), xs_mv,
                     jnp.moveaxis(has_ref_all, 0, 1)))
            # scan stacks outputs frame-major; callers index [gop, frame]
            outs_p = jax.tree_util.tree_map(
                lambda a: jnp.moveaxis(a, 0, 1), outs_p)
            # packed HVS flags for the host's stability-chain replay
            # (_StabReplay): bit0 lo_tex, bit1 lo_var, bit2 high_detail
            outs_p["mvflags"] = (
                (mv_all["lo_tex"] != 0).astype(jnp.uint8)
                | ((mv_all["lo_var"] != 0).astype(jnp.uint8) << 1)
                | ((mv_all["high_detail"] != 0).astype(jnp.uint8) << 2))
        else:
            outs_p = None
        if compact:
            with jax.named_scope("dsv_compact"):
                out_i, outs_p = compact_hoisted(out_i, outs_p)
        return (out_i, outs_p), (stability, refresh_ctr, al_all[:, -1])

    # The whole output pytree is coalesced on device into ONE byte blob
    # per chunk (narrow dtypes bitcast to int8), one D2H fetch; the host
    # fetches a single array and re-slices (layout is static per
    # geometry, captured at trace).
    layout_box = {}

    def run_blobs(packed, prev_al0, stab0, refresh0, quants):
        tree = run_batch(packed, prev_al0, stab0, refresh0, quants)
        return _blob_concat(tree, packed.shape[0], layout_box)

    def unpack(blob):
        """Host side: byte blob (already device_get) -> output pytree."""
        return _blob_split(blob, layout_box)

    def run(packed, prev_al0, stab0, refresh0):
        """Single-GOP convenience wrapper (driver compile check)."""
        q1 = jnp.full((1, 2), crf_quant(quality), jnp.int32)
        return run_blobs(packed[None], prev_al0[None], stab0[None],
                         refresh0[None], q1)

    run.batch = run_blobs
    run.unpack = unpack

    if rc_key is not None:
        # ------------------------------------------------ exact ABR scan
        # The reference's per-frame ABR law (dsv_encoder.c:70-168,
        # 816-848) runs INSIDE the device scan: ops/piclen.py computes
        # each picture's exact packed byte size from the quantized
        # tensors, ops/rc.py applies the law, and the quality chain —
        # the one thing that normally forces a host round trip per frame
        # — never leaves the chip. GOPs are serially dependent through
        # the rate state, so the chunk runs as one outer scan over GOPs
        # (the motion path stays hoisted and batched); byte-identical to
        # the sequential per-frame ABR encoder by construction.
        from types import SimpleNamespace
        (_br, _fn, _fd, _mqs, _mnq, _mxq, _miq, _hmn) = rc_key
        qfn, sfn = _rc.make_abr_law(
            SimpleNamespace(bitrate=_br, max_q_step=_mqs, min_quality=_mnq,
                            max_quality=_mxq, min_I_frame_quality=_miq,
                            rc_high_motion_nudge=_hmn),
            SimpleNamespace(fps_num=_fn, fps_den=_fd))

        def run_batch_abr(packed, stab0, refresh0, rc0, prev_al0):
            """packed (C, G, fsz) u8; stab0 (nblk, 2) i32; refresh0 ()
            i32; rc0 (8,) i32 (ops/rc.py state layout); prev_al0 () i32
            (previous frame's average luma — carried because a GOP-start
            frame whose SCD delta trips counts as *forced* intra for the
            rate law, dsv_encoder.c:538-554 + 133-141, incl. frame 0
            against the zero-initialised prev_avg_luma). Returns
            ((out_i, outs_p), carry) with per-frame 'quant' outputs for
            the host packer."""
            C = packed.shape[0]
            with jax.named_scope("dsv_motion"):
                imgs_all, al_all, mv_all, has_ref_all = motion(packed)
            imgs0 = imgs_all[0].reshape(C, G, -1)
            zmv1 = zero_mv()

            def gop_step(carry, x):
                stability, refresh_ctr, rcst, prev_al = carry
                im_g, al_g, mv_g, hr_g = x
                if do_scd:
                    fi_i = jnp.abs(al_g[0] - prev_al) > scd_delta
                    prev_al = al_g[-1]
                else:
                    fi_i = jnp.bool_(False)
                q_i, rcst = qfn(rcst, jnp.bool_(False), fi_i)
                quant_i = quant_of_quality(q_i)
                recon, stability, refresh_ctr, out_i = encode_frame(
                    jnp.bool_(False), quant_i, fr.alloc_image(layouts[0]),
                    stability, refresh_ctr, im_g[0], zmv1,
                    compact_i_tagged, want_len=True, maybe_p=False)
                rcst = sfn(rcst, jnp.bool_(False), q_i, out_i["pic_len"])
                out_i["quant"] = quant_i

                def pstep(pc, px):
                    ref_recon, stability, refresh_ctr, rcst = pc
                    im, mv1, hr = px
                    # a P slot that lost has_ref is a forced-intra frame
                    # (SCD / intra%% promotion): the law boosts quality
                    # for it (dsv_encoder.c:133-141)
                    q_p, rcst = qfn(rcst, hr, ~hr)
                    quant_p = quant_of_quality(q_p)
                    recon, stability, refresh_ctr, out = encode_frame(
                        hr, quant_p, ref_recon, stability, refresh_ctr,
                        im, mv1, compact_p_tagged, want_len=True)
                    rcst = sfn(rcst, hr, q_p, out["pic_len"])
                    out["quant"] = quant_p
                    return (recon, stability, refresh_ctr, rcst), out

                if G > 1:
                    (_, stability, refresh_ctr, rcst), outs_p = lax.scan(
                        pstep, (recon, stability, refresh_ctr, rcst),
                        (im_g[1:], mv_g, hr_g))
                else:
                    outs_p = None
                return (stability, refresh_ctr, rcst, prev_al), (out_i,
                                                                 outs_p)

            init = (stab0, refresh0, rc0, prev_al0)
            if G > 1:
                mv_xs = {k: mv_all[k] for k in
                         ("mode", "mvx", "mvy", "submask", "lo_tex",
                          "lo_var", "high_detail")}
                carry, outs = lax.scan(gop_step, init,
                                       (imgs0, al_all, mv_xs, has_ref_all))
            else:
                def gop_step1(carry, x):
                    im_g, al_g = x
                    return gop_step(carry, (im_g, al_g, None, None))

                carry, outs = lax.scan(gop_step1, init, (imgs0, al_all))
            return outs, carry

        layout_box_abr = {}

        def run_blobs_abr(packed, stab0, refresh0, rc0, prev_al0):
            tree, carry = run_batch_abr(packed, stab0, refresh0, rc0,
                                        prev_al0)
            return (_blob_concat(tree, packed.shape[0], layout_box_abr),
                    carry)

        def unpack_abr(blob):
            return _blob_split(blob, layout_box_abr)

        run.batch_abr = run_blobs_abr
        run.unpack_abr = unpack_abr
    return run


@lru_cache(maxsize=8)
def build_intra_encoder(subsamp: int, w: int, h: int, quality: int,
                        compact: int = 1024):
    """Pure fn for one intra-only frame (gop 0): no ME, no recon, all
    blocks stable (the zeroed accumulators make every block stable,
    dsv_encoder.c:383-393). compact != 0 returns planes as dense int8 +
    LL exception lists (like the GOP path's I frames) to shrink the
    D2H transfer."""
    blk_w, blk_h, nbh, nbv = block_geometry(w, h)
    prep = make_prep(subsamp, w, h, 0)
    core_i = make_encode_core(subsamp, w, h, blk_w, blk_h, nbh, nbv,
                              has_ref=False, want_recon=False)
    quant = crf_quant(quality)
    nblk = nbh * nbv
    ll_sizes = [int(t.seg_bounds[1])
                for t in coef_geometry(subsamp, w, h, nbh, nbv)[2]]

    def run_dense(packed):
        imgs, _ = prep(_split_planes(packed, subsamp, w, h))
        stable = jnp.ones(nblk, jnp.uint8)
        z = jnp.zeros(nblk, jnp.int32)
        qvals, dcs, _ = core_i(imgs[0], jnp.int32(0), jnp.int32(quant),
                               stable, z, z, z, z)
        return {"dc": jnp.stack([jnp.asarray(d, jnp.int32) for d in dcs]),
                "qvals": tuple(qvals)}

    def run(packed):
        """One frame. Compaction outside the core for vmap composability
        (sized-nonzero lowers badly under vmap; see compact_hoisted)."""
        out = run_dense(packed)
        if compact:
            qvals = out.pop("qvals")
            out["qcomp_i"] = tuple(
                _compact_dense_i(qv, ll_n)
                for qv, ll_n in zip(qvals, ll_sizes))
        return out

    def run_batch(packed):
        """(K, fsz) frames: vmapped core + lax.map'ed (unbatched)
        compaction — the fast path for the gop-0 chunk pipeline."""
        out = jax.vmap(run_dense)(packed)
        if compact:
            qvals = out.pop("qvals")
            out["qcomp_i"] = tuple(
                lax.map(lambda q, ll=ll_n: _compact_dense_i(q, ll), qv)
                for qv, ll_n in zip(qvals, ll_sizes))
        return out

    run.batch = run_batch
    return run


class _FrameChunk:
    __slots__ = ("packed", "start", "n_real")

    def __init__(self, packed, start, n_real):
        self.packed = packed  # (k, fsz) uint8, raw planar frame bytes
        self.start, self.n_real = start, n_real


def _env_int(name: str, default: int) -> int:
    """Runtime-read perf knob (read per call, so tests/profilers can
    flip it without reimporting)."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:  # pragma: no cover
        return default


def _pipelined(reader: "_ChunkReader", k: int, dispatch, depth_fn=None):
    """Prefetch pipeline: keep `DSV1_PREFETCH` (default 2) chunks
    dispatched ahead of the one being host-packed, so the H2D upload +
    device compute + D2H of later chunks overlap host packing
    of the current one. Dispatch is fully async (jit call + D2H enqueue
    return immediately); the only blocking point is the consumer's
    device_get. Yields (chunk, dispatched) in order.

    depth_fn overrides the in-flight depth per refill — consulted after
    each yield, so a rate controller can hold the pipeline shallow until
    its first byte-count feedback exists (GOP-granular ABR)."""
    get_depth = depth_fn or (lambda: _env_int("DSV1_PREFETCH", 2))
    inflight = []
    done = False
    while True:
        while not done and len(inflight) < max(1, get_depth()):
            nxt = reader.next_chunk(k)
            if nxt is None:
                done = True
                break
            inflight.append((nxt, dispatch(nxt)))
        if not inflight:
            return
        yield inflight.pop(0)


_H2D_POOL = None


def _stage_h2d(arrs, sharding=None):
    """Explicitly enqueue H2D transfers for a chunk's input arrays.

    DSV1_H2D_STREAMS = 0 (default): pass numpy through and let the jit
    call transfer implicitly. 1: one explicit async device_put per
    array. S > 1: uint8 arrays (the bulk frame bytes) are flattened and
    split into up to S contiguous slices — at least 256KB each, so the
    per-transfer overhead stays amortized — and device_put from S
    threads; if the device link gives each transfer its own stream,
    this multiplies effective H2D bandwidth. Slices are re-joined by an
    on-device concatenate + reshape; non-uint8 arrays always go up as a
    single device_put.
    With a mesh sharding the arrays go up as one sharded device_put
    (stream splitting would fight the shard layout)."""
    streams = _env_int("DSV1_H2D_STREAMS", 0)
    if streams <= 0 and sharding is None:
        return arrs
    if streams <= 1 or sharding is not None:
        return [jax.device_put(a, sharding) for a in arrs]
    global _H2D_POOL
    if _H2D_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _H2D_POOL = ThreadPoolExecutor(max_workers=32)
    out = []
    for a in arrs:
        if a.dtype != np.uint8:  # only the bulk u8 frame bytes split
            out.append(jax.device_put(a))
            continue
        # split a flat view (not axis 0, whose extent may be tiny —
        # e.g. 4 GOP rows) so the requested stream count is honored;
        # floor 256KB per slice keeps per-transfer overhead amortized
        # (DSV1_H2D_SLICE_FLOOR overrides, mainly for tests)
        flat = np.ascontiguousarray(a).reshape(-1)
        floor = max(1, _env_int("DSV1_H2D_SLICE_FLOOR", 256 << 10))
        n = min(streams, max(1, flat.size // floor))
        futs = [_H2D_POOL.submit(jax.device_put, s)
                for s in np.array_split(flat, n)]
        out.append(jnp.concatenate([f.result() for f in futs])
                   .reshape(a.shape))
    return out


class _ChunkReader:
    """Pulls (y, u, v) frames from any iterable in fixed-size chunks,
    padding a short tail by repeating the last real frame (padded
    outputs are dropped at packing time). Lets the GOP-parallel encoder
    stream arbitrarily long inputs with two chunks of frames in memory
    instead of materializing the whole clip."""

    def __init__(self, frames):
        self._it = iter(frames)
        self._last = None
        self._pos = 0

    def next_chunk(self, k: int) -> _FrameChunk | None:
        packed = None
        n_real = 0
        start = self._pos
        for i in range(k):
            f = next(self._it, None)
            if f is not None:
                self._last = f
                n_real += 1
            elif n_real == 0:
                return None  # no frames left at all
            elif self._last is None:  # pragma: no cover
                return None
            else:
                f = self._last
            # pack to raw planar file byte order (dsv.c:98-170): the
            # whole chunk goes to the device as one contiguous transfer
            y, u, v = (np.asarray(p, np.uint8) for p in f[:3])
            if packed is None:
                packed = np.empty((k, y.size + u.size + v.size), np.uint8)
            row = packed[i]
            row[:y.size] = y.ravel()
            row[y.size:y.size + u.size] = u.ravel()
            row[y.size + u.size:] = v.ravel()
        self._pos += n_real
        return _FrameChunk(packed, start, n_real)


class _AbrState:
    """GOP-granular ABR controller for the parallel encoder.

    The reference's per-frame law (dsv_encoder.c:70-168) moves quality a
    bounded step per *observation*; at GOP granularity that converges far
    too slowly for the codec's steep rate-quality curve (measured: a 10%
    quality drop can shrink P frames 30x). Instead this controller fits
    the curve directly: each completed GOP contributes a measurement
    (quality -> ln bytes/frame) and the next GOP's quality comes from
    secant interpolation toward the target bytes/frame, with a damped
    default slope before two points exist. Spec-valid by construction;
    NOT byte-identical to the sequential per-frame ABR (use
    models.encoder.Encoder for reference-exact ABR bytes)."""

    # default d(ln bytes)/d(quality) before two measurements exist —
    # deliberately steep (small moves) to avoid first-step overshoot
    _SLOPE0 = 0.008
    _MAX_STEP = 150  # per-GOP quality move bound (scale 0..2047)
    _DAMP = 0.7      # fraction of the model step to take: decisions are
    #                  made 1-2 chunks ahead of feedback (pipeline), so
    #                  undamped steps zigzag on stale measurements

    def __init__(self, cfg: EncoderConfig, meta: Metadata):
        self.cfg, self.meta = cfg, meta
        self.q = max(0, min(cfg.quality, MAX_QUALITY))
        fps = (meta.fps_num << 5) // meta.fps_den or 1
        # aim at 7/8 of nominal like the reference's over-target
        # hysteresis (dsv_encoder.c:833): the start transient and model
        # noise then keep short clips under, not over, the stated rate
        self.target_bpf = max(1, (((cfg.bitrate << 5) // fps) >> 3)
                              * 7 // 8)
        self.pts: list = []  # (quality, ln mean-bytes-per-frame)

    def _clamp(self, q: int) -> int:
        q = max(self.cfg.min_quality, min(q, self.cfg.max_quality))
        return max(0, min(q, MAX_QUALITY))

    def _next_q(self) -> int:
        lt = math.log(self.target_bpf)
        if not self.pts:
            return self.q
        q1, lb1 = self.pts[-1]
        # slope from a least-squares fit over the retained points
        # (up to 3) — smoother than a raw secant on noisy measurements
        qs = [p[0] for p in self.pts]
        lbs = [p[1] for p in self.pts]
        n = len(qs)
        slope = self._SLOPE0
        if n >= 2:
            mq = sum(qs) / n
            ml = sum(lbs) / n
            den = sum((a - mq) ** 2 for a in qs)
            if den > 0:
                est = sum((a - mq) * (b - ml)
                          for a, b in zip(qs, lbs)) / den
                if est > 1e-4:  # require the physical monotone direction
                    slope = est
        step = self._DAMP * (lt - lb1) / slope
        step = max(-self._MAX_STEP, min(self._MAX_STEP, step))
        return self._clamp(int(q1 + step))

    def gop_quants(self, n_gops: int, chunk: int, G: int):
        """(chunk, 2) [I, P] quants + qualities for the next n_gops GOPs
        (padded rows repeat the last real GOP; they are dropped at pack
        time). GOPs within one chunk share the same quality — no new
        measurements arrive between them. The I frame gets the
        min_I_frame_quality floor (dsv_encoder.c:133)."""
        self.q = self._next_q()
        quals = np.zeros((chunk, 2), np.int32)
        quals[:, 0] = max(self.q, self.cfg.min_I_frame_quality)
        quals[:, 1] = self.q
        return quant_of_quality(quals).astype(np.int32), quals

    def gop_done(self, quality: int, gop_bytes: int, n_frames: int):
        """Feed one completed GOP's measured size."""
        lb = math.log(max(gop_bytes, 1) / max(n_frames, 1))
        self.pts.append((int(quality), lb))
        del self.pts[:-3]


def gop_mesh(devices=None, axis: str = "gop") -> Mesh:
    """1-D device mesh over the GOP axis (SURVEY.md §5: GOP axis -> data
    parallelism; per-GOP recon chains stay device-local)."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def gop_tile_mesh(n_gop: int, n_tile: int, devices=None) -> Mesh:
    """2-D (gop × tile) device mesh: GOPs data-parallel over 'gop',
    each GOP's frames column-sharded over 'tile' inside the subband
    transforms (SURVEY.md §5: the two scaling axes composed; the tile
    axis carries the halo collectives). Intended for frames above ~720p,
    where a single frame's transform work is large enough to split."""
    devices = list(devices if devices is not None else jax.devices())
    if n_gop * n_tile > len(devices):
        raise ValueError(f"need {n_gop * n_tile} devices, "
                         f"have {len(devices)}")
    return Mesh(np.asarray(devices[:n_gop * n_tile]).reshape(
        n_gop, n_tile), ("gop", "tile"))


@lru_cache(maxsize=8)
def _jit_batched(subsamp, w, h, G, quality, do_scd, scd_delta, intra_thresh,
                 stable_refresh, pyramid_levels, mesh_key, compact=1024,
                 effort=0, cap_quality=None):
    if mesh_key is not None and "tile" in _MESHES[mesh_key].axis_names:
        # gop×tile 2-D mesh: GSPMD partitioning end-to-end — the GOP
        # batch axis is sharded over 'gop' (committed inputs carry it),
        # and per-level constraints inside the subband transforms
        # (_make_tile_hook) column-shard each frame over 'tile' with
        # XLA-inserted halo exchanges. Numerics are identical to the
        # unsharded program by SPMD semantics (byte-equality tested).
        run = build_gop_encoder(subsamp, w, h, G, quality, do_scd,
                                scd_delta, intra_thresh, stable_refresh,
                                pyramid_levels, compact, effort,
                                tile_key=mesh_key, cap_quality=cap_quality)
        return jax.jit(run.batch), run.unpack
    run = build_gop_encoder(subsamp, w, h, G, quality, do_scd, scd_delta,
                            intra_thresh, stable_refresh, pyramid_levels,
                            compact, effort, cap_quality=cap_quality)
    if mesh_key is None:
        return jax.jit(run.batch), run.unpack
    # per-device closed-GOP batches: shard_map so each device runs its own
    # scan with zero collectives on the frame path
    mesh = _MESHES[mesh_key]
    p = PartitionSpec("gop")
    smapped = jax.shard_map(run.batch, mesh=mesh, in_specs=(p,) * 5,
                            out_specs=p, check_vma=False)
    return jax.jit(smapped), run.unpack


_MESHES: dict = {}


def _rc_key(cfg: EncoderConfig, meta: Metadata) -> tuple:
    """Static rate-law parameters (hashable lru key for the builder)."""
    return (cfg.bitrate, meta.fps_num, meta.fps_den, cfg.max_q_step,
            cfg.min_quality, cfg.max_quality, cfg.min_I_frame_quality,
            bool(cfg.rc_high_motion_nudge))


@lru_cache(maxsize=8)
def _jit_batched_abr(subsamp, w, h, G, quality, do_scd, scd_delta,
                     intra_thresh, stable_refresh, pyramid_levels, rc_key,
                     compact=1024, effort=0):
    run = build_gop_encoder(subsamp, w, h, G, quality, do_scd, scd_delta,
                            intra_thresh, stable_refresh, pyramid_levels,
                            compact, effort, rc_key,
                            cap_quality=rc_key[5])  # cfg.max_quality
    return jax.jit(run.batch_abr), run.unpack_abr


def _encode_abr_exact(reader: "_ChunkReader", meta: Metadata,
                      cfg: EncoderConfig, N: int, gops_per_device: int,
                      _fnum_base: int, _emit_eos: bool) -> bytes:
    """Per-frame ABR at device-scan speed, byte-identical to the
    sequential encoder (models/encoder.py) and therefore to the
    reference's ABR law (dsv_encoder.c:70-168, 816-848).

    The rate state, stability accumulators and refresh counter live on
    device and thread from one chunk dispatch to the next as data
    dependencies — dispatches stay fully async (the H2D upload of chunk
    k+1 overlaps the scan of chunk k); the host only fetches output
    blobs for entropy packing. Per-frame quants come back with the blob
    and feed the native chunk packer.

    DSV1_CHECK_PICLEN=1 additionally cross-checks every device-computed
    picture length against the packed bytes (used by tests)."""
    from .. import bits
    w, h, subsamp = meta.width, meta.height, meta.subsamp
    blk_w, blk_h, nbh, nbv = block_geometry(w, h)
    G = cfg.gop
    ngops_known = div_round(N, G) if N else 0
    per_dev = gops_per_device or _env_int("DSV1_GOPS_PER_DEVICE", 0) or max(
        1, min(4, (4 * 352 * 288 * 12) // max(G * w * h, 1),
               ngops_known or (1 << 30)))
    chunk = per_dev
    rck = _rc_key(cfg, meta)

    def jit_abr(compact):
        return _jit_batched_abr(subsamp, w, h, G, cfg.quality, cfg.do_scd,
                                cfg.scene_change_delta,
                                cfg.intra_pct_thresh, cfg.stable_refresh,
                                cfg.pyramid_levels, rck, compact,
                                cfg.effort)

    fn, unpack = jit_abr(1024)
    nblk = nbh * nbv
    carry_cell = [tuple(jax.device_put(a) for a in (
        np.zeros((nblk, 2), np.int32), np.asarray(0, np.int32),
        _rc.init_state(cfg.quality), np.asarray(0, np.int32)))]

    def dispatch(c):
        (pk,) = _stage_h2d([c.packed.reshape(chunk, G, -1)])
        cin = carry_cell[0]
        blob, cout = fn(pk, *cin)
        carry_cell[0] = cout
        blob.copy_to_host_async()
        return pk, blob, cin

    out = bytearray()
    prev_link = 0
    meta_pkt = bytes(encode_metadata_packet(meta))
    check_len = _env_int("DSV1_CHECK_PICLEN", 0)

    for ck, (pk, blob, cin) in _pipelined(reader, chunk * G, dispatch):
        s = ck.start // G
        N_cut = ck.start + ck.n_real
        ngops = s + div_round(ck.n_real, G)
        out_i, outs_p = unpack(jax.device_get(blob))
        overflow = any(np.any(out_i["qcomp_i"][c][3] > 0) for c in range(3))
        if outs_p is not None:
            overflow |= any(np.any(outs_p["qcomp_p"][c][3])
                            for c in range(3))
        if overflow:
            # rare compaction-cap overflow: redo the chunk densely with
            # the SAME carry-in (rate/stability outputs are identical —
            # compaction never feeds the law); downstream dispatches
            # already chained off the compact run's carry, which is valid
            EVENTS["dense_redo"] += 1
            fnf, unpackf = jit_abr(0)
            blob_f, _ = fnf(pk, *cin)
            out_i, outs_p = unpackf(jax.device_get(blob_f))
        quants_cg = np.empty((chunk, G), np.int32)
        quants_cg[:, 0] = out_i["quant"]
        if G > 1:
            quants_cg[:, 1:] = outs_p["quant"]

        if "qcomp_i" in out_i:
            if outs_p is not None:
                pr = [outs_p["qcomp_p"][c][0] for c in range(3)]
                pv = [outs_p["qcomp_p"][c][1] for c in range(3)]
                pc = [outs_p["qcomp_p"][c][2] for c in range(3)]
                pdc, phr = outs_p["dc"], outs_p["has_ref"]
                pmo, pmx = outs_p["mode"], outs_p["mvx"]
                pmy, psu = outs_p["mvy"], outs_p["submask"]
                pst = outs_p["stable"]
            else:
                z16 = np.zeros((chunk, 0, 1), np.uint16)
                pr, pv = [z16] * 3, [z16.view(np.int16)] * 3
                pc = [np.zeros((chunk, 0), np.int32)] * 3
                pdc = np.zeros((chunk, 0, 3), np.int32)
                phr = np.zeros((chunk, 0), np.uint8)
                pmo = psu = np.zeros((chunk, 0, 1), np.uint8)
                pmx = pmy = np.zeros((chunk, 0, 1), np.int16)
                pst = np.zeros((chunk, 0, 1), np.uint8)
            pkt, new_link = bits.pack_chunk(
                FOURCC, VERSION_MINOR, blk_w, blk_h, nbh, nbv,
                quants_cg, MAX_QP_BITS, meta_pkt, chunk, G, s, ngops,
                N_cut, _fnum_base, 1,
                [out_i["qcomp_i"][c][0] for c in range(3)],
                [out_i["qcomp_i"][c][1] for c in range(3)],
                [out_i["qcomp_i"][c][2] for c in range(3)],
                out_i["dc"], out_i["stable"],
                pr, pv, pc, pdc, phr, pmo, pmx, pmy, psu, pst, prev_link)
            if check_len:
                _assert_piclens(pkt, out_i, outs_p, len(meta_pkt), chunk,
                                G, s, ngops, N_cut)
            prev_link = new_link
            out.extend(pkt)
            continue

        # dense fallback packing (python per-picture path)
        for gl in range(chunk):
            g = s + gl
            if g >= ngops:
                break
            out.extend(meta_pkt)
            for i in range(G):
                fnum = g * G + i
                if fnum >= N_cut:
                    break
                o = out_i if i == 0 else outs_p

                def fld(name):
                    return o[name][gl] if i == 0 else o[name][gl, i - 1]

                has_ref = bool(fld("has_ref")) if i else False
                mv = ({k: fld(k) for k in ("mode", "mvx", "mvy", "submask")}
                      if has_ref else None)
                qv = [o["qvals"][c][gl] if i == 0 else o["qvals"][c][gl,
                                                                     i - 1]
                      for c in range(3)]
                pic = pack_picture(_fnum_base + fnum, blk_w, blk_h,
                                   fld("stable"), has_ref, True, mv,
                                   int(quants_cg[gl, i]), qv, fld("dc"),
                                   nbh, nbv)
                if check_len:
                    dev_len = int(out_i["pic_len"][gl] if i == 0
                                  else outs_p["pic_len"][gl, i - 1])
                    assert dev_len == len(pic), (fnum, dev_len, len(pic))
                set_link_offsets(pic, prev_link, len(pic))
                prev_link = len(pic)
                out.extend(pic)
    if _emit_eos:
        out.extend(encode_eos_packet(prev_link))
    return bytes(out)


def _assert_piclens(pkt_bytes, out_i, outs_p, meta_len, chunk, G, s,
                    ngops, N_cut):
    """Walk the packed chunk's link chain and compare every picture's
    byte length against the device-computed pic_len (test hook)."""
    off = 0
    for gl in range(chunk):
        if s + gl >= ngops:
            break
        off += meta_len
        for i in range(G):
            if (s + gl) * G + i >= N_cut:
                break
            plen = int.from_bytes(pkt_bytes[off + 10:off + 14], "big")
            dev = int(out_i["pic_len"][gl] if i == 0
                      else outs_p["pic_len"][gl, i - 1])
            assert dev == plen, ((s + gl) * G + i, dev, plen)
            off += plen


def encode_stream_gops(frames, meta: Metadata,
                       cfg: EncoderConfig | None = None,
                       mesh: Mesh | None = None,
                       gops_per_device: int = 0, *,
                       abr_mode: str = "exact",
                       _fnum_base: int = 0, _emit_eos: bool = True,
                       _return_state: bool = False,
                       _stab_init: tuple | None = None):
    """Encode frames into a full .dsv stream, GOPs in parallel.

    frames: sequence of (y, u, v) uint8 planar arrays. CRF is
    byte-identical to the sequential encoder for any gop/stable_refresh
    combination (optimistic zero-init + stability-chain replay, module
    docstring). ABR with abr_mode="exact" (default) runs the reference's
    per-frame rate law *inside* the device scan — the packed size of
    every picture is computed on device (ops/piclen.py) and fed to the
    law (ops/rc.py), so streams are byte-identical to the sequential
    per-frame ABR encoder with zero per-frame host round trips; the rate
    chain is serial, so this mode is single-device. abr_mode="gop" uses
    GOP-granular rate feedback (_AbrState): spec-valid, on-target and
    mesh-shardable, but not byte-identical to per-frame ABR.

    The underscore kwargs serve the multi-host shard path
    (parallel/multihost.py): a global frame-number offset, EOS
    suppression for partial streams, an initial stability-accumulator
    state for shards that don't start at a refresh boundary, and
    (stream, last_picture_len, stability_state) return for O(1) link
    fixup + state threading at mux time.
    """
    cfg = cfg or EncoderConfig()
    if mesh is not None and "tile" in mesh.axis_names \
            and "gop" not in mesh.axis_names:
        # a tile-only mesh would route into the gop×tile branch and die
        # later in an opaque NamedSharding(PartitionSpec('gop')) error;
        # the composed 2-D path needs both axes (gop_tile_mesh). For
        # plane-level tile sharding use parallel.tile directly.
        raise ValueError("mesh has a 'tile' axis but no 'gop' axis; "
                         "build it with gop_tile_mesh(n_gop, n_tile)")
    abr = cfg.rc_mode != RATE_CONTROL_CRF
    if abr and cfg.gop == GOP_INTRA:
        raise ValueError("GOP-parallel ABR needs gop > 0; "
                         "use models.encoder.Encoder")
    if cfg.gop != GOP_INTRA and cfg.gop > 4096:
        # a GOP is one device-resident scan of length gop-1; effectively
        # infinite GOPs (DSV_GOP_INF = INT_MAX) belong on the sequential
        # encoder, not a 2^31-step compiled scan
        raise ValueError("GOP too long for the device-resident scan; "
                         "use models.encoder.Encoder")
    if abr and abr_mode == "exact":
        if mesh is not None or _return_state:
            raise ValueError(
                "exact per-frame ABR is a serial rate chain (single "
                "device); use abr_mode='gop' for meshes / shard state")
        N0 = len(frames) if hasattr(frames, "__len__") else 0
        return _encode_abr_exact(_ChunkReader(frames), meta, cfg, N0,
                                 gops_per_device, _fnum_base, _emit_eos)
    w, h, subsamp = meta.width, meta.height, meta.subsamp
    # known length (sequence) tightens chunk sizing; iterators/generators
    # stream with constant memory (two chunks in flight)
    N = len(frames) if hasattr(frames, "__len__") else 0
    reader = _ChunkReader(frames)
    quant = crf_quant(cfg.quality)
    blk_w, blk_h, nbh, nbv = block_geometry(w, h)
    out = bytearray()
    prev_link = 0

    # Only pictures participate in the prev/next link chain; metadata
    # packets keep prev=0 (mirrors the golden-verified sequential path,
    # dsv_enc at dsv_encoder.c:804-813).
    def emit_pic(pkt: bytearray):
        nonlocal prev_link
        set_link_offsets(pkt, prev_link, len(pkt))
        prev_link = len(pkt)
        out.extend(pkt)

    if cfg.gop == GOP_INTRA:
        # gop 0: every frame is a GOP start -> metadata re-emitted before
        # every picture (dsv_encoder.c:624-652), pt has is_ref=0. Chunked
        # + blob-coalesced + native chunk packing like the GOP path;
        # frames stream through with two chunks in flight.
        from .. import bits
        layout_box = {}
        run1 = build_intra_encoder(subsamp, w, h, cfg.quality)

        def batch_run(packed):
            return _blob_concat(run1.batch(packed), packed.shape[0],
                                layout_box)

        vrun = jax.jit(batch_run)
        chunkf = max(1, min(64, (8 << 20) // max(w * h, 1), N or (1 << 30)))
        meta_pkt = bytes(encode_metadata_packet(meta))
        nblk = nbh * nbv

        def dispatch_i(c):
            (pk,) = _stage_h2d([c.packed])
            blob = vrun(pk)
            blob.copy_to_host_async()
            return blob

        for c, blob in _pipelined(reader, chunkf, dispatch_i):
            s = c.start
            o = _blob_split(jax.device_get(blob), layout_box)
            if any(np.any(o["qcomp_i"][ci][3] > 0) for ci in range(3)):
                # rare huge-LL overflow: redo this chunk densely
                EVENTS["dense_redo"] += 1
                box_f = {}
                run_f = build_intra_encoder(subsamp, w, h, cfg.quality, 0)

                def batch_f(packed):
                    return _blob_concat(run_f.batch(packed),
                                        packed.shape[0], box_f)

                o = _blob_split(jax.device_get(jax.jit(batch_f)(c.packed)),
                                box_f)
                stable = np.ones(nblk, np.uint8)
                for i in range(s, s + c.n_real):
                    out.extend(meta_pkt)
                    qv = [o["qvals"][ci][i - s] for ci in range(3)]
                    emit_pic(pack_picture(_fnum_base + i, blk_w, blk_h,
                                          stable, False, False, None, quant,
                                          qv, o["dc"][i - s], nbh, nbv))
                continue
            z16 = np.zeros((chunkf, 0, 1), np.uint16)
            nf_cut = s + c.n_real  # global cutoff: drops padded tail rows
            pkt, prev_link = bits.pack_chunk(
                FOURCC, VERSION_MINOR, blk_w, blk_h, nbh, nbv, quant,
                MAX_QP_BITS, meta_pkt, chunkf, 1, s, nf_cut, nf_cut,
                _fnum_base, 0,
                [o["qcomp_i"][ci][0] for ci in range(3)],
                [o["qcomp_i"][ci][1] for ci in range(3)],
                [o["qcomp_i"][ci][2] for ci in range(3)],
                o["dc"], np.ones((chunkf, nblk), np.uint8),
                [z16] * 3, [z16.view(np.int16)] * 3,
                [np.zeros((chunkf, 0), np.int32)] * 3,
                np.zeros((chunkf, 0, 3), np.int32),
                np.zeros((chunkf, 0), np.uint8),
                np.zeros((chunkf, 0, 1), np.uint8),
                np.zeros((chunkf, 0, 1), np.int16),
                np.zeros((chunkf, 0, 1), np.int16),
                np.zeros((chunkf, 0, 1), np.uint8),
                np.zeros((chunkf, 0, 1), np.uint8), prev_link)
            out.extend(pkt)
        if _emit_eos:
            out.extend(encode_eos_packet(prev_link))
        if _return_state:
            # gop 0 has no P frames: the stability chain never moves
            return bytes(out), prev_link, (np.zeros((nbh * nbv, 2),
                                                    np.int32), 0)
        return bytes(out)

    G = cfg.gop
    levels = cfg.pyramid_levels or auto_pyramid_levels(w, h, nbh, nbv)
    ngops_known = div_round(N, G) if N else 0
    # Chunk the GOP batch and keep two chunks in flight so host-side
    # D2H transfer + entropy packing of chunk k overlap device compute
    # of chunk k+1 (JAX dispatch is async; device_get of a finished
    # chunk runs while the next executable computes). Frames stream
    # through the reader, so memory stays bounded at two chunks.
    # Per-device GOP batch sized by pixel budget (one 1080p GOP per
    # device), capped at 4 GOPs; whether wider batches pay on an 80 GB
    # card is open.
    per_dev = gops_per_device or _env_int("DSV1_GOPS_PER_DEVICE", 0) or max(
        1, min(4, (4 * 352 * 288 * 12) // max(G * w * h, 1),
               ngops_known or (1 << 30)))
    if abr and not gops_per_device:
        per_dev = 1  # rate feedback per GOP beats batch width
    if mesh is not None:
        # gop×tile meshes batch per gop-row (each GOP's frame work is
        # split over the tile axis, not replicated per device)
        nd = mesh.shape.get("gop", mesh.devices.size)
        chunk = per_dev * nd
        key = id(mesh)
        _MESHES[key] = mesh
    else:
        chunk = per_dev
        key = None

    in_sharding = (NamedSharding(mesh, PartitionSpec("gop"))
                   if mesh is not None else None)
    # Cross-GOP SCD state is irrelevant in CRF: every GOP's first frame
    # is statically intra (gop start), so the previous GOP's average luma
    # cannot change any within-GOP decision (check_scene_change,
    # dsv_encoder.c:538-554, only gates has_ref of P frames). prev_al0
    # stays in the traced signature for cache stability but is zero —
    # uploaded ONCE and reused by every chunk.
    prev_al, stab0, refresh0 = (
        jax.device_put(a, in_sharding)
        for a in (np.zeros(chunk, np.int32),
                  np.zeros((chunk, nbh * nbv, 2), np.int32),
                  np.zeros(chunk, np.int32)))
    fn, unpack = _jit_batched(subsamp, w, h, G, cfg.quality, cfg.do_scd,
                              cfg.scene_change_delta, cfg.intra_pct_thresh,
                              cfg.stable_refresh, cfg.pyramid_levels, key,
                              effort=cfg.effort,
                              cap_quality=cfg.max_quality if abr else None)
    if abr:
        rc = _AbrState(cfg, meta)
        chunk_q: dict = {}
    else:
        quants_dev = jax.device_put(np.full((chunk, 2), quant, np.int32),
                                    in_sharding)

    def dispatch(c, f=None, init=None):
        if abr:
            # quants assigned once per chunk at first dispatch (the
            # dense-overflow redo reuses them), in stream order
            if c.start not in chunk_q:
                chunk_q[c.start] = rc.gop_quants(div_round(c.n_real, G),
                                                 chunk, G)
            quants = chunk_q[c.start][0]
        else:
            quants = quants_dev
        if init is None:
            st0, rc0 = stab0, refresh0
        else:  # stability-chain fix: true per-GOP accumulator state
            st0 = jax.device_put(init[0], in_sharding)
            rc0 = jax.device_put(init[1], in_sharding)
        (pk,) = _stage_h2d([c.packed.reshape(chunk, G, -1)], in_sharding)
        blob = (f or fn)(pk, prev_al, st0, rc0, quants)
        # enqueue D2H right behind the compute so the transfer of
        # chunk k overlaps host packing of chunk k-1
        blob.copy_to_host_async()
        return blob

    meta_pkt = bytes(encode_metadata_packet(meta))

    # ABR: hold the pipeline to depth 1 until the rate model has
    # measurements, then open it up (bounded start-of-stream overshoot)
    depth_fn = ((lambda: 1 if len(rc.pts) < 2
                 else _env_int("DSV1_PREFETCH", 2)) if abr else None)
    calibrated = not abr
    nblk = nbh * nbv
    sr_eff = cfg.stable_refresh or max(1, min(G - 1, 14))
    replay = _StabReplay(nblk, sr_eff, _stab_init)
    for ck, blob in _pipelined(reader, chunk * G, dispatch, depth_fn):
        s = ck.start // G            # chunk's first gop index
        N_cut = ck.start + ck.n_real  # global frame cutoff for this chunk
        ngops = s + div_round(ck.n_real, G)

        def materialize(b, init=None):
            (oi, op), _ = unpack(jax.device_get(b))
            if "qcomp_i" in oi:
                overflow = any(np.any(oi["qcomp_i"][c][3] > 0)
                               for c in range(3))
                if op is not None:
                    overflow |= any(np.any(op["qcomp_p"][c][3])
                                    for c in range(3))
                if overflow:
                    # rare (dense P planes / huge LL): redo batch densely
                    EVENTS["dense_redo"] += 1
                    full, unpack_f = _jit_batched(
                        subsamp, w, h, G, cfg.quality, cfg.do_scd,
                        cfg.scene_change_delta, cfg.intra_pct_thresh,
                        cfg.stable_refresh, cfg.pyramid_levels, key, 0,
                        effort=cfg.effort)
                    (oi, op), _ = unpack_f(
                        jax.device_get(dispatch(ck, full, init)))
            return oi, op

        out_i, outs_p = materialize(blob)

        # Stability-chain verification (module docstring): replay the
        # cross-GOP accumulator chain from the fetched motion fields
        # (init-independent), then re-encode the chunk with the true
        # per-GOP state iff any GOP's optimistic zero-init was invalid
        # (the reference would not reset at its I frame — mid-GOP
        # forced-intra, or stable_refresh not dividing gop-1).
        fix_init = None
        if G > 1:
            inits_s = np.zeros((chunk, nblk, 2), np.int32)
            inits_c = np.zeros(chunk, np.int32)
            needs_fix = False
            for gl in range(chunk):
                if s + gl >= ngops:
                    break
                st_g, ctr_g, bad = replay.gop_init()
                inits_s[gl], inits_c[gl] = st_g, ctr_g
                needs_fix |= bad
                replay.step_i()  # GOP start: statically intra
                for i in range(1, G):
                    if (s + gl) * G + i >= N_cut:
                        break
                    if outs_p["has_ref"][gl, i - 1]:
                        replay.step_p(outs_p["mode"][gl, i - 1],
                                      outs_p["mvx"][gl, i - 1],
                                      outs_p["mvy"][gl, i - 1],
                                      outs_p["mvflags"][gl, i - 1])
                    else:
                        replay.step_i()
            if needs_fix:
                EVENTS["stab_fix"] += 1
                fix_init = (inits_s, inits_c)
                out_i, outs_p = materialize(
                    dispatch(ck, init=fix_init), fix_init)

        if "qcomp_i" in out_i:
            # fast path: one native call assembles the whole chunk's
            # packets (metadata re-emit, pictures, link chain)
            from .. import bits

            def pack_fast(quants_arg, pl):
                if outs_p is not None:
                    pr = [outs_p["qcomp_p"][c][0] for c in range(3)]
                    pv = [outs_p["qcomp_p"][c][1] for c in range(3)]
                    pc = [outs_p["qcomp_p"][c][2] for c in range(3)]
                    pdc, phr = outs_p["dc"], outs_p["has_ref"]
                    pmo, pmx = outs_p["mode"], outs_p["mvx"]
                    pmy, psu = outs_p["mvy"], outs_p["submask"]
                    pst = outs_p["stable"]
                else:
                    z16 = np.zeros((chunk, 0, 1), np.uint16)
                    pr = [z16] * 3
                    pv = [z16.view(np.int16)] * 3
                    pc = [np.zeros((chunk, 0), np.int32)] * 3
                    pdc = np.zeros((chunk, 0, 3), np.int32)
                    phr = np.zeros((chunk, 0), np.uint8)
                    pmo = psu = np.zeros((chunk, 0, 1), np.uint8)
                    pmx = pmy = np.zeros((chunk, 0, 1), np.int16)
                    pst = np.zeros((chunk, 0, 1), np.uint8)
                return bits.pack_chunk(
                    FOURCC, VERSION_MINOR, blk_w, blk_h, nbh, nbv,
                    quants_arg, MAX_QP_BITS, meta_pkt, chunk, G, s, ngops,
                    N_cut, _fnum_base, 1,
                    [out_i["qcomp_i"][c][0] for c in range(3)],
                    [out_i["qcomp_i"][c][1] for c in range(3)],
                    [out_i["qcomp_i"][c][2] for c in range(3)],
                    out_i["dc"], out_i["stable"],
                    pr, pv, pc, pdc, phr, pmo, pmx, pmy, psu, pst, pl)

            def feed_stats(pkt_bytes, quals):
                # per-picture sizes from the link-offset chain
                # (big-endian u32 at byte 10 of each picture packet),
                # aggregated per GOP for the rate model
                off = 0
                for gl in range(chunk):
                    if s + gl >= ngops:
                        break
                    off += len(meta_pkt)
                    acc = nf_g = 0
                    for i in range(G):
                        if (s + gl) * G + i >= N_cut:
                            break
                        plen = int.from_bytes(
                            pkt_bytes[off + 10:off + 14], "big")
                        acc += plen
                        nf_g += 1
                        off += plen
                    rc.gop_done(int(quals[gl, 1]), acc, nf_g)

            if not calibrated:
                # two-pass stream start: the controller has no rate
                # measurement yet, so the first chunk's real size is
                # measured with a trial pack (one (quality, bytes)
                # point), the start quality is corrected, and the chunk
                # re-encodes; only the corrected encode reaches the
                # stream (its measurement is the model's second point).
                calibrated = True
                qn_t, ql_t = chunk_q.pop(ck.start)
                trial, _ = pack_fast(qn_t, prev_link)
                feed_stats(trial, ql_t)
                chunk_q[ck.start] = rc.gop_quants(div_round(ck.n_real, G),
                                                  chunk, G)
                out_i, outs_p = materialize(
                    dispatch(ck, init=fix_init), fix_init)

            if "qcomp_i" in out_i:
                pkt, prev_link = pack_fast(
                    chunk_q[ck.start][0] if abr else quant, prev_link)
                out.extend(pkt)
                if abr:
                    _, quals = chunk_q.pop(ck.start)
                    feed_stats(pkt, quals)
                continue
            # (re-encode fell back to dense qvals: use the python
            # packer below like any dense chunk)

        def frame_out(i):
            return out_i if i == 0 else outs_p

        def field(gl, i, name):
            o = frame_out(i)
            return o[name][gl] if i == 0 else o[name][gl, i - 1]

        def plane_q(gl, i, c):
            o = frame_out(i)
            if "qvals" in o:
                return o["qvals"][c][gl] if i == 0 else o["qvals"][c][gl,
                                                                      i - 1]
            if i == 0:
                q8, pos, vals, _ = o["qcomp_i"][c]
                qv = q8[gl].astype(np.int32)
                p = pos[gl]
                sel = p < qv.size
                qv[p[sel]] = vals[gl][sel]
                return qv
            runs, vals, cnt, _ = o["qcomp_p"][c]
            n_ = int(cnt[gl, i - 1])
            return (runs[gl, i - 1][:n_].astype(np.uint32),
                    vals[gl, i - 1][:n_].astype(np.int32))

        quals_f = chunk_q.pop(ck.start) if abr else None
        for gl in range(chunk):
            g = s + gl
            if g >= ngops:
                break
            out.extend(encode_metadata_packet(meta))
            acc = nf_g = 0
            for i in range(G):
                fnum = g * G + i
                if fnum >= N_cut:
                    break
                has_ref = bool(field(gl, i, "has_ref"))
                mv = {k: field(gl, i, k) for k in
                      ("mode", "mvx", "mvy", "submask")} if has_ref else None
                qv = [plane_q(gl, i, c) for c in range(3)]
                q_use = (int(quals_f[0][gl, 1 if i else 0]) if abr
                         else quant)
                pic = pack_picture(_fnum_base + fnum, blk_w, blk_h,
                                   field(gl, i, "stable"), has_ref, True,
                                   mv, q_use, qv, field(gl, i, "dc"),
                                   nbh, nbv)
                emit_pic(pic)
                acc += len(pic)
                nf_g += 1
            if abr:
                rc.gop_done(int(quals_f[1][gl, 1]), acc, nf_g)
    if _emit_eos:
        out.extend(encode_eos_packet(prev_link))
    if _return_state:
        return bytes(out), prev_link, replay.state()
    return bytes(out)
