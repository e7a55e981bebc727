"""Hierarchical zero-coefficient coding (HZCC): quantization + run coding.

DSV1 codes each plane as one run-length stream over a fixed traversal: the
LL region (a ceil(w/8) x ceil(h/8) raster holding all coarse levels) followed
by the three finest levels' LH/HL/HH subbands (reference hzcc.c:29-48,
137-293). Quantization is adaptive per block: intra blocks get q/4, stable
blocks q/2 (hzcc.c:59-74), and the finest level uses power-of-two shift
quantization with stable blocks held at high quality (hzcc.c:114-135).
The encoder overwrites coefficients with their dequantized values as it
codes — the in-loop reconstruction (hzcc.c:174,227,262).

Design: the traversal becomes a static permutation table; the
entire quantize + write-back pass is one vectorized gather -> quant ->
scatter on device (band-sequential only when ceil-rounded band boundaries
overlap, which the table builder detects). The serial (run, value) symbol
stream is derived from the quantized traversal array by nonzero-compaction;
dequantization on decode is a vectorized scatter of parsed values.
"""

from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (BLOCK_P, CHROMA_LIMIT, MAXLVL, MINQUANT, NSUBBAND,
                         QP_I, QP_P, round_shift)
from .cint import lb2, trunc_div
from .opt import runtime
from .sbt import get_quant


@dataclass(frozen=True, eq=False)
class TraversalTables:
    """Static per-(W,H,nbh,nbv) traversal metadata."""
    perm: np.ndarray        # int32[N] flat coefficient index per position
    level: np.ndarray       # int8[N]: -1 = LL region, 0..2 = finest levels
    blk: np.ndarray         # int32[N] block index for stability lookup
    seg_bounds: np.ndarray  # int64[11] segment boundaries (LL + 9 bands)
    has_overlap: bool       # bands alias coefficients (odd ceil dims)
    n: int
    nbh: int
    nbv: int
    # per segment: (lvl, oy, ox, sh, sw, row_blk i32[sh], col_blk
    #               i32[sw]) — the traversal is a concatenation of
    # rectangular rasters, so the device encode path uses static slices
    # plus a small (sh, sw) block-index gather per band instead of a
    # 150K-element permutation gather/scatter
    segs: tuple = ()


@lru_cache(maxsize=64)
def build_tables(W: int, H: int, nbh: int, nbv: int) -> TraversalTables:
    """C.1 subband order and traversal (hzcc.c:29-48)."""
    segs = []
    sw, sh = round_shift(W, MAXLVL), round_shift(H, MAXLVL)
    segs.append((-1, 0, 0, sh, sw))
    for lvl in range(MAXLVL):
        sw, sh = round_shift(W, MAXLVL - lvl), round_shift(H, MAXLVL - lvl)
        for s in range(1, NSUBBAND):
            ox = sw if (s & 1) else 0
            oy = sh if (s & 2) else 0
            segs.append((lvl, oy, ox, sh, sw))
    perms, levels, blks, bounds, segs_out = [], [], [], [0], []
    for (lvl, oy, ox, sh, sw) in segs:
        ys, xs = np.mgrid[0:sh, 0:sw]
        perms.append(((oy + ys) * W + (ox + xs)).ravel().astype(np.int32))
        levels.append(np.full(sh * sw, lvl, np.int8))
        row_blk = col_blk = None
        if lvl >= 0:
            # 14-bit fixed-point block coordinate map (hzcc.c:59-74)
            dbx = (nbh << BLOCK_P) // sw
            dby = (nbv << BLOCK_P) // sh
            bi = (xs * dbx) >> BLOCK_P
            bj = (ys * dby) >> BLOCK_P
            blks.append((bj * nbh + bi).ravel().astype(np.int32))
            # the block map is separable: row index by y, column by x
            row_blk = bj[:, 0].astype(np.int32)
            col_blk = bi[0, :].astype(np.int32)
        else:
            blks.append(np.zeros(sh * sw, np.int32))
        bounds.append(bounds[-1] + sh * sw)
        segs_out.append((lvl, oy, ox, sh, sw, row_blk, col_blk))
    perm = np.concatenate(perms)
    overlap = np.unique(perm).size != perm.size
    return TraversalTables(
        perm=perm,
        level=np.concatenate(levels),
        blk=np.concatenate(blks),
        seg_bounds=np.asarray(bounds, np.int64),
        has_overlap=bool(overlap),
        n=int(perm.size),
        nbh=nbh,
        nbv=nbv,
        segs=tuple(segs_out),
    )


def fix_quant(q, plane_idx: int):
    """C.2 chroma quant limit (hzcc.c:50-57)."""
    q = jnp.asarray(q, jnp.int32)
    if plane_idx > 0:
        q = jnp.minimum(q, CHROMA_LIMIT)
    return q


def frame_quants(q, is_p, plane_idx: int):
    """Per-level quant parameters for one plane (is_p may be traced).

    Returns (qp_ll, qp0, qp1, qp2_shift, qp2h_shift) — the last two are
    shift amounts for the finest level (hzcc.c:199-208).
    """
    qf = fix_quant(q, plane_idx)
    qp_ll = get_quant(qf, is_p, 0)
    qp0 = qp_ll
    qp1 = get_quant(qf, is_p, 1)
    qp2 = lb2(get_quant(qf, is_p, 2))
    qp2h = jnp.clip(qp2 - jnp.where(is_p, QP_P, QP_I), 1, 24)
    return qp_ll, qp0, qp1, qp2, qp2h


def _set00(a, v):
    """Set a[0, 0] = v via an elementwise masked select.

    A scalar `at[0, 0].set` lowers to a dynamic-update-slice, which the
    XLA:CPU SPMD partitioner mis-applies at every shard's local origin
    when the array is column-sharded (observed under the tiled plane
    pipeline: row 0 of every shard's first column corrupted). The iota
    mask is elementwise, partitions correctly, and fuses for free.
    """
    H, W = a.shape
    mask = (jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
            | jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)) == 0
    return jnp.where(mask, jnp.asarray(v, a.dtype), a)


def tmq4pos(qp, stable):
    """C.2.4 TMQ_for_position (hzcc.c:63-74) + MINQUANT floor."""
    t = jnp.where((stable & 2) != 0, qp >> 2,
                  jnp.where(stable != 0, qp >> 1, qp))
    return jnp.maximum(t, MINQUANT)


def _band_stable(stable2d, row_blk, col_blk):
    """(sh, sw) stability flags of a band's coefficients: an integer
    gather of each position's block entry (no float product, so no
    matmul precision question)."""
    return jnp.take(jnp.take(stable2d, jnp.asarray(row_blk), axis=0),
                    jnp.asarray(col_blk), axis=1)


def quant_lo(v, q):
    """C.2 lower-frequency quantizer (hzcc.c:94-112)."""
    a = jnp.abs(v) << 1
    mag = trunc_div(a + 1, q << 1)
    res = jnp.where(a <= q, 0, jnp.where(v < 0, -mag, mag))
    return jnp.where(v == 0, 0, res)


def dequant_lo(v, q):
    """C.2.1 dequantize_lower_frequency (hzcc.c:120-127)."""
    m = (jnp.abs(v) * (q << 1) + q) >> 1
    return jnp.where(v < 0, -m, m)


def quant_hi(v, s):
    """C.2 highest-frequency shift quantizer (hzcc.c:114-118)."""
    a = jnp.abs(v) >> s
    return jnp.where(v < 0, -a, a)


def dequant_hi(v, s):
    """C.2.1 dequantize_highest_frequency (hzcc.c:130-135)."""
    return jnp.left_shift(v, s)


def _position_tmq(tables: TraversalTables, q, is_p: bool, plane_idx: int,
                  stable_blocks, xp=jnp):
    """Per-traversal-position quant parameter + shift-mode mask."""
    qp_ll, qp0, qp1, qp2, qp2h = frame_quants(q, is_p, plane_idx)
    lvl = xp.asarray(tables.level)
    blk = xp.asarray(tables.blk)
    if xp is jnp:
        blk = runtime(blk)  # see ops/opt.py
    stable = xp.asarray(stable_blocks, jnp.int32)[blk]
    is_hi = lvl == (MAXLVL - 1)
    tmq = xp.where(lvl == -1, qp_ll,
                   xp.where(lvl == 0, tmq4pos(qp0, stable),
                            xp.where(lvl == 1, tmq4pos(qp1, stable),
                                     xp.where(stable != 0, qp2h, qp2))))
    return tmq.astype(jnp.int32), is_hi


@partial(jax.jit, static_argnums=(3, 5))
def encode_plane_core(coefs, q, is_p, plane_idx: int, stable_blocks,
                      tables: TraversalTables):
    """Device quantize + in-loop write-back (hzcc_enc, hzcc.c:138-293).

    coefs: (H, W) int32 from fwd_sbt. Returns (qvals[N] traversal-ordered
    quantized values, recon coefs with dequantized write-back and raw DC).

    The traversal is a concatenation of rectangular band rasters, so each
    band is a static slice of the coefficient grid; the per-block adaptive
    quant map is expanded per band with a small block-index gather. Reading
    from the progressively written-back grid reproduces the reference's
    sequential band order even when odd ceil dims make bands alias
    (hzcc.c:174,227,262 write-back visible to later positions).
    """
    coefs = jnp.asarray(coefs, jnp.int32)
    H, W = coefs.shape
    dc = coefs[0, 0]
    work = _set00(coefs, 0)  # hzcc.c:171 src[0] = 0
    qp_ll, qp0, qp1, qp2, qp2h = frame_quants(q, is_p, plane_idx)
    stable2d = jnp.asarray(stable_blocks, jnp.int32) \
        .reshape(tables.nbv, tables.nbh)
    qparts = []
    for (lvl, oy, ox, sh, sw, row_blk, col_blk) in tables.segs:
        vals = work[oy:oy + sh, ox:ox + sw]
        if lvl == -1:
            qv = quant_lo(vals, qp_ll)
            wb = dequant_lo(qv, qp_ll)
        else:
            st = _band_stable(stable2d, row_blk, col_blk)
            if lvl < MAXLVL - 1:
                tmq = tmq4pos(qp0 if lvl == 0 else qp1, st)
                qv = quant_lo(vals, tmq)
                wb = dequant_lo(qv, tmq)
            else:
                s = jnp.where(st != 0, qp2h, qp2)
                qv = quant_hi(vals, s)
                wb = dequant_hi(qv, s)
        wb = jnp.where(qv == 0, 0, wb)
        work = work.at[oy:oy + sh, ox:ox + sw].set(wb)
        qparts.append(qv.reshape(-1))
    work = _set00(work, dc)  # dsv_encode_plane restores raw DC
    return jnp.concatenate(qparts), work


def dequant_plane_grid(qgrid, dc, q, is_p, plane_idx: int, stable_blocks,
                       tables: TraversalTables):
    """Device dequantize of a quantized-value grid (decode side of
    hzcc_dec, hzcc.c:296-435). qgrid: (H, W) int quantized values already
    scattered in grid order (host parse, last-wins over band aliases like
    the reference's sequential visit order); dc: raw DC. is_p/q may be
    traced. Mirrors decode_plane_scatter exactly, band by band.
    """
    qgrid = jnp.asarray(qgrid, jnp.int32)
    qp_ll, qp0, qp1, qp2, qp2h = frame_quants(q, is_p, plane_idx)
    stable2d = jnp.asarray(stable_blocks, jnp.int32) \
        .reshape(tables.nbv, tables.nbh)
    out = jnp.zeros_like(qgrid)
    for (lvl, oy, ox, sh, sw, row_blk, col_blk) in tables.segs:
        vals = qgrid[oy:oy + sh, ox:ox + sw]
        if lvl == -1:
            dq = dequant_lo(vals, qp_ll)
        else:
            st = _band_stable(stable2d, row_blk, col_blk)
            if lvl < MAXLVL - 1:
                dq = dequant_lo(vals, tmq4pos(qp0 if lvl == 0 else qp1, st))
            else:
                dq = dequant_hi(vals, jnp.where(st != 0, qp2h, qp2))
        dq = jnp.where(vals == 0, 0, dq)
        out = out.at[oy:oy + sh, ox:ox + sw].set(dq)
    return _set00(out, jnp.asarray(dc, jnp.int32))


def decode_plane_scatter(W: int, H: int, runs: np.ndarray, vals: np.ndarray,
                         q: int, is_p: bool, plane_idx: int,
                         stable_blocks: np.ndarray, dc: int,
                         tables: TraversalTables) -> np.ndarray:
    """Host-side dequantize + scatter (hzcc_dec, hzcc.c:296-435).

    Builds the (H, W) int32 coefficient array from parsed (run, value)
    symbols. numpy, exact C integer semantics.
    """
    flat = np.zeros(W * H, np.int32)
    if runs.size:
        # position of the i-th value in traversal order: sum_{j<=i} runs_j + i
        pos = np.cumsum(runs.astype(np.int64) + 1) - 1
        keep = pos < tables.n
        pos = pos[keep]
        v = vals[: runs.size][keep].astype(np.int64)
        tmq, is_hi = _np_position_tmq(tables, q, is_p, plane_idx,
                                      stable_blocks)
        t = tmq[pos]
        hi = is_hi[pos]
        mag = (np.abs(v) * (t << 1) + t) >> 1
        dq_lo = np.where(v < 0, -mag, mag)
        dq_hi = v << t
        dq = np.where(hi, dq_hi, dq_lo).astype(np.int32)
        # duplicate flat indices (band overlap): numpy assignment is
        # last-wins in traversal order, matching the reference visit order
        flat[tables.perm[pos]] = dq
    flat[0] = dc
    return flat.reshape(H, W)


def _np_position_tmq(tables: TraversalTables, q: int, is_p: bool,
                     plane_idx: int, stable_blocks: np.ndarray):
    """numpy twin of _position_tmq for the host decode path."""
    qv = int(q)
    if plane_idx > 0:
        qv = min(qv, CHROMA_LIMIT)

    def gq(level):
        x = qv
        if is_p:
            x = x * 3 // 2
        if level == 1:
            x = x * 2 // 3
        elif level == 2:
            x = x * 3 // 2
        return max(x, MINQUANT)

    def _lb2(n):
        k, i = 0, 1
        while i < n:
            i <<= 1
            k += 1
        return k

    qp_ll, qp0, qp1 = gq(0), gq(0), gq(1)
    qp2 = _lb2(gq(2))
    qp2h = min(max(qp2 - (QP_P if is_p else QP_I), 1), 24)
    stable = np.asarray(stable_blocks, np.int32)[tables.blk]
    lvl = tables.level
    is_hi = lvl == (MAXLVL - 1)

    def tmq4(qp):
        return np.maximum(
            np.where((stable & 2) != 0, qp >> 2,
                     np.where(stable != 0, qp >> 1, qp)), MINQUANT)

    tmq = np.where(lvl == -1, qp_ll,
                   np.where(lvl == 0, tmq4(qp0),
                            np.where(lvl == 1, tmq4(qp1),
                                     np.where(stable != 0, qp2h, qp2))))
    return tmq.astype(np.int64), is_hi


def compact_dense_i(qv, ll_n):
    """Dense int8 + LL exception list (intra planes are dense, with
    values beyond int8 essentially only in the small LL region). Shrinks
    the D2H transfer of a quantized intra plane ~4x; overflow of the
    exception cap is counted so callers can fall back to dense int32."""
    q8 = jnp.clip(qv, -128, 127).astype(jnp.int8)
    ll = qv[:ll_n]
    big_ll = jnp.abs(ll) > 127
    K = min(256, ll_n)
    # fill points past the whole plane so the host filter
    # (pos < plane size) drops padding entries
    pos = jnp.nonzero(big_ll, size=K, fill_value=qv.shape[0])[0] \
        .astype(jnp.int32)
    vs = jnp.where(pos < ll_n, ll[jnp.clip(pos, 0, ll_n - 1)], 0)
    nbig = (jnp.sum((jnp.abs(qv[ll_n:]) > 127).astype(jnp.int32))
            + jnp.maximum(jnp.sum(big_ll.astype(jnp.int32)) - K, 0))
    return q8, pos, vs, nbig


def sparse_cap_div(quant: int) -> int:
    """Cap divisor for compact_sparse_p as a function of the operating
    quant. Measured on the bench corpus (tools/overflow_sweep.py, CIF
    gop12): P-plane nonzero density stays under 0.35% of coefficients
    for quant >= 210 (quality <= 90%) but jumps to ~2% at quant 108
    (quality 95%), overflowing the default n/128 cap on 47/66 planes —
    each overflow re-runs the whole chunk densely. Widening the cap at
    high quality trades a bigger (but still small) D2H transfer for
    never paying the 2x re-encode."""
    if quant < 160:
        return 16   # 6.25% cap vs ~2% measured peak
    if quant < 256:
        return 32   # 3.1% cap vs 0.35% measured peak
    return 256      # 0.39% cap vs 0.21% measured peak (qp <= 85);
    #                 compaction cost scales with the cap (the k-th-
    #                 nonzero search is K queries x log2(n) gathers)


def compact_sparse_p(qv, cap_div: int = 256):
    """Capped (zero-run, value) nonzero list (P planes are sparse).

    cumsum + searchsorted instead of top_k: the k-th nonzero's position
    is the first index where the running nonzero count reaches k, so a
    batched binary search over the cumsum gives all K positions — no
    sort. This replaces top_k's full O(n) pair sort with one cumsum
    plus K x log2(n) search gathers; identical outputs (verified
    elementwise vs the top_k form). Runs and values ship as 16-bit to
    halve the D2H copy; range overflow falls back to the dense path
    like cap overflow.
    cap_div: cap = n/cap_div (sparse_cap_div picks it from the quant)."""
    n = qv.shape[0]
    K = min(n, max(256, n // cap_div))
    nz = qv != 0
    c = jnp.cumsum(nz.astype(jnp.int32))
    cnt = c[-1]
    pos = jnp.searchsorted(c, jnp.arange(1, K + 1, dtype=jnp.int32),
                           side="left").astype(jnp.int32)
    pos = jnp.where(jnp.arange(K) < cnt, pos, n)
    vs = jnp.where(pos < n, qv[jnp.clip(pos, 0, n - 1)], 0)
    prev = jnp.concatenate([jnp.full((1,), -1, pos.dtype), pos[:-1]])
    runs = pos - prev - 1
    valid = jnp.arange(K) < cnt
    ovf = ((cnt > K)
           | (jnp.max(jnp.where(valid, runs, 0)) > 0xFFFE)
           | (jnp.max(jnp.where(valid, jnp.abs(vs), 0)) > 0x7FFF))
    return (runs.astype(jnp.uint16), vs.astype(jnp.int16), cnt, ovf)


def runs_from_qvals(qvals: np.ndarray):
    """Extract the (runs, values) symbol stream from quantized traversal
    values (the encoder side of hzcc.c:176-283)."""
    nz = np.flatnonzero(qvals)
    if nz.size == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.int32)
    prev = np.concatenate(([-1], nz[:-1]))
    runs = (nz - prev - 1).astype(np.uint32)
    return runs, qvals[nz].astype(np.int32)
