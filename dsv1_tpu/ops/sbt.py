"""Subband (wavelet) transforms — integer-exact, fully vectorized.

DSV1 uses a full multiresolution decomposition down to 1px: per level a 2D
Haar into LL/LH/HL/HH quadrants (reference sbt.c:267-349) with truncating
4/5 LL scaling on selected levels, plus a biorthogonal 4-tap transform (B4T)
for level 1 of intra frames (sbt.c:90-265). The inverse for luma applies a
smoothing filter that nudges LH/HL toward the local LL gradient bounded by
±hqp (sbt.c:437-574).

Design: the reference's in-place scalar loops with a global temp buffer
become pure functions over (H, W) int32 arrays, but — unlike the in-place
C — the decomposition CARRIES the active LL region between levels instead
of updating the top-left corner of the full array. In-place quadrant
updates (`at[...].set` on strided views) lower to strided scatters, while
the same math as strided `lax.slice` reads + concatenate assembly is
plain dense data movement. So:

- forward: each level deinterleaves the carried region with stride-2
  slices, emits (LH, HL, HH) pieces, and carries LL; the canonical
  quadrant-layout array (what HZCC traverses) is assembled once at the
  end from the pieces by pure concatenation.
- inverse: the carried region starts at the deepest LL and is rebuilt
  level by level; band pieces are contiguous slices of the *original*
  input (the in-place algorithm never writes a level's bands before
  reading them, so the original array holds exactly what the C reads),
  and the 2x2 interleave is a stack+reshape, not a strided scatter.

Odd dimensions are handled by edge-replication (forward) and zero-padding
(inverse), which reproduces the reference's odd-row/col special cases
exactly. The carried-region recursion is exact because the active region
of level i equals level i-1's LL quadrant: round_shift(W, i-1) dims.

Bit-exactness notes:
- C truncating division via lax.div (ops/cint.py), validated against the C.
- The filtered inverse reads LL neighbours across quadrant boundaries
  (sbt.c:480-510 reads spLL[idx+1] past the LL quadrant); those reads come
  from the original input array (see above), matching the in-place state.
- B4T is implemented for even dimensions (all real video sizes; the
  reference's odd-dim B4T writes a gap at index n//2+1 that reads stale
  temp-buffer memory — undefined behavior we do not reproduce).
"""

import numpy as np

import jax.numpy as jnp
from jax import lax

from ..constants import MAXLVL, MINQUANT, QP_I, QP_P, round_shift
from .cint import lb2, lb2_static, round2, round4, round8, trunc_div

# ±1 column-pairing matrix for _col_pairs: output lanes 0..63 are the
# per-128-block pair SUMS (cols 2k + 2k+1), lanes 64..127 the DIFFS
_COLM = np.zeros((128, 128), np.float32)
for _k in range(64):
    _COLM[2 * _k, _k] = _COLM[2 * _k + 1, _k] = 1.0
    _COLM[2 * _k, 64 + _k] = 1.0
    _COLM[2 * _k + 1, 64 + _k] = -1.0

# 0/1 deinterleave matrix for _col_phases: lanes 0..63 select the EVEN
# column of each pair, lanes 64..127 the ODD column
_COLP = np.zeros((128, 128), np.float32)
for _k in range(64):
    _COLP[2 * _k, _k] = 1.0
    _COLP[2 * _k + 1, 64 + _k] = 1.0


def _col_phases(a):
    """(even, odd) column phases via one f32 contraction against a 0/1
    matrix (same exactness bound as _col_pairs)."""
    r, n = a.shape
    wp = -(-n // 128) * 128
    if wp != n:
        a = jnp.pad(a, ((0, 0), (0, wp - n)))
    t = a.reshape(r, wp // 128, 128).astype(jnp.float32)
    out = jnp.einsum("hbw,wk->hbk", t, jnp.asarray(_COLP),
                     preferred_element_type=jnp.float32,
                     precision=lax.Precision.HIGHEST).astype(jnp.int32)
    even = out[:, :, :64].reshape(r, wp // 2)
    odd = out[:, :, 64:].reshape(r, wp // 2)
    return even[:, :n // 2], odd[:, :n // 2]


def _col_pairs(rp):
    """(sum, diff) of adjacent column pairs via one f32 contraction.

    One einsum against the static ±1 matrix produces both halves in
    place of two column-strided slices (whether this beats the strided
    form on a GPU is an open measurement). Exact: inputs are integers
    (pixel-derived coefficients stay well under 2^24 at every level
    that takes this path — |coef| <= 255 entering level 1, growing
    ~x3.2/level under the 4/5 LL scaling), products are ±1-weighted,
    f32 represents all integers < 2^24 exactly, and HIGHEST precision
    keeps full f32 products (no TF32 or bf16 passes).

    rp: (he, we) int32, we even. Returns (s, d) of shape (he, we//2).
    """
    he, we = rp.shape
    wp = -(-we // 128) * 128
    if wp != we:
        rp = jnp.pad(rp, ((0, 0), (0, wp - we)))
    a = rp.reshape(he, wp // 128, 128).astype(jnp.float32)
    # HIGHEST precision: a lower-precision f32 matmul (TF32 on a GPU,
    # bf16 passes elsewhere) rounds large integer sums
    out = jnp.einsum("hbw,wk->hbk", a, jnp.asarray(_COLM),
                     preferred_element_type=jnp.float32,
                     precision=lax.Precision.HIGHEST).astype(jnp.int32)
    s = out[:, :, :64].reshape(he, wp // 2)
    d = out[:, :, 64:].reshape(he, wp // 2)
    return s[:, :we // 2], d[:, :we // 2]


def _slice2r(a, r0: int):
    """Stride-2 row extraction (a row-strided slice; see _slice2)."""
    he, we = a.shape
    return lax.slice(a, (r0, 0), (he, we), (2, 1))


def _slice2(a, r0: int, c0: int):
    """Stride-2 phase extraction via lax.slice.

    `a[r0::2, c0::2]` getitem lowers to a full elementwise GATHER (one
    (h/2, w/2, 2) index tensor per phase); lax.slice is a strided copy.
    a must have even dims.
    """
    he, we = a.shape
    return lax.slice(a, (r0, c0), (he, we), (2, 2))


def nlevels(w: int, h: int) -> int:
    """C.3.3 num_levels (sbt.c:616-628)."""
    return lb2_static(max(w, h))


def get_quant(q, is_p, level):
    """C.2.2 get_quant_lower_frequency (hzcc.c:77-92). q and is_p may be
    traced (a python-bool is_p constant-folds to the same HLO)."""
    q = jnp.asarray(q, jnp.int32)
    q = jnp.where(is_p, trunc_div(q * 3, 2), q)
    if isinstance(level, int):
        if level == 1:
            q = trunc_div(q * 2, 3)
        elif level == 2:
            q = trunc_div(q * 3, 2)
    else:
        q = jnp.where(level == 1, trunc_div(q * 2, 3),
                      jnp.where(level == 2, trunc_div(q * 3, 2), q))
    return jnp.maximum(q, MINQUANT)


def _pad_even(r, ws: int, hs: int):
    """Edge-replicate to even dims (reproduces the C oddw/oddh branches)."""
    if ws & 1:
        r = jnp.concatenate([r, r[:, -1:]], axis=1)
    if hs & 1:
        r = jnp.concatenate([r, r[-1:, :]], axis=0)
    return r


def _quad_dims(W: int, H: int, lvl: int):
    """Active region + quadrant dims at a level (sbt.c:630-651)."""
    ws = round_shift(W, lvl - 1)
    hs = round_shift(H, lvl - 1)
    return ws, hs, (ws + 1) // 2, (hs + 1) // 2, ws // 2, hs // 2


def _haar_fwd_region(r, lvl: int, is_i):
    """C.3.1.2 Haar forward on the carried region (sbt.c:267-349).

    r: (hs, ws) int32. Returns the four quadrant pieces at their
    canonical (trimmed) shapes: LL (ch,cw), LH (ch,fw), HL (fh,cw),
    HH (fh,fw). is_i may be traced.
    """
    hs, ws = r.shape
    cw, ch = (ws + 1) // 2, (hs + 1) // 2
    fw, fh = ws // 2, hs // 2
    rp = _pad_even(r, ws, hs)
    if ws >= 256:
        # large levels: column pairing as a matrix contraction (see
        # _col_pairs), rows via row-strided slices
        cs, cd = _col_pairs(rp)
        s0, s1 = _slice2r(cs, 0), _slice2r(cs, 1)
        d0, d1 = _slice2r(cd, 0), _slice2r(cd, 1)
        LL = s0 + s1
        LHf = d0 + d1
        HLf = s0 - s1
        HHf = d0 - d1
    else:
        x0 = _slice2(rp, 0, 0)
        x1 = _slice2(rp, 0, 1)
        x2 = _slice2(rp, 1, 0)
        x3 = _slice2(rp, 1, 1)
        LL = x0 + x1 + x2 + x3
        LHf = x0 - x1 + x2 - x3
        HLf = x0 + x1 - x2 - x3
        HHf = x0 - x1 - x2 + x3
    if lvl > 1:  # LVL_TEST (sbt.c:22)
        LL = trunc_div(LL * 4, 5)  # FWD_SCALE
    elif isinstance(is_i, bool):
        LL = trunc_div(LL * 4, 5) if is_i else LL
    else:
        LL = jnp.where(is_i, trunc_div(LL * 4, 5), LL)
    return LL, LHf[:, :fw], HLf[:fh, :], HHf[:fh, :fw]


def _assemble(LL, LH, HL, HH):
    """Pack quadrant pieces into the level's in-place region layout."""
    top = jnp.concatenate([LL, LH], axis=1)
    if HL.shape[0] == 0:
        return top
    return jnp.concatenate([top, jnp.concatenate([HL, HH], axis=1)],
                           axis=0)


def _interleave2x2(a00, a01, a10, a11):
    """2x2 phase interleave via stack+reshape (no strided scatter)."""
    ch, cw = a00.shape
    ev = jnp.stack([a00, a01], axis=2).reshape(ch, 2 * cw)
    od = jnp.stack([a10, a11], axis=2).reshape(ch, 2 * cw)
    return jnp.concatenate([ev[:, None, :], od[:, None, :]],
                           axis=1).reshape(2 * ch, 2 * cw)


def _b4t_fwd_axis(a, axis: int):
    """C.3.2.1 forward B4T along an axis (even length; sbt.c:90-126)."""
    if axis == 0:
        # native row form — no transpose of the plane; row phases are
        # row-strided slices
        n = a.shape[0]
        assert n % 2 == 0, "B4T requires even dimensions"
        even = _slice2r(a, 0)
        odd = _slice2r(a, 1)
        x0 = jnp.concatenate([odd[:1], odd[:-1]], axis=0)
        x3 = jnp.concatenate([even[1:], odd[-1:]], axis=0)
        L = round2(3 * (even + odd) - x0 - x3)
        H = round2(x0 - 3 * even + 3 * odd - x3)
        return jnp.concatenate([L, H], axis=0)
    r, n = a.shape
    assert n % 2 == 0, "B4T requires even dimensions"
    if n >= 256:
        even, odd = _col_phases(a)  # matrix deinterleave (_col_pairs)
    else:
        even = lax.slice(a, (0, 0), (r, n), (1, 2))
        odd = lax.slice(a, (0, 1), (r, n), (1, 2))
    x0 = jnp.concatenate([odd[:, :1], odd[:, :-1]], axis=1)
    x1 = even
    x2 = odd
    x3 = jnp.concatenate([even[:, 1:], odd[:, -1:]], axis=1)
    L = round2(3 * (x1 + x2) - x0 - x3)
    H = round2(x0 - 3 * x1 + 3 * x2 - x3)
    return jnp.concatenate([L, H], axis=1)


def _b4t_inv_axis(a, axis: int):
    """C.3.2.2 inverse B4T along an axis (even length; sbt.c:128-163)."""
    if axis == 0:
        # native row form (no transpose — see _b4t_fwd_axis)
        n = a.shape[0]
        assert n % 2 == 0, "B4T requires even dimensions"
        m = n // 2
        L = a[:m]
        H = a[m:]
        Lp = jnp.concatenate([L[:1], L[:-1]], axis=0)
        Hp = jnp.concatenate([H[:1], H[:-1]], axis=0)
        Ln = jnp.concatenate([L[1:], L[-1:]], axis=0)
        Hn = jnp.concatenate([H[1:], H[-1:]], axis=0)
        evens = round8(Lp + 3 * L + Hp - 3 * H)
        odds = round8(3 * L + Ln + 3 * H - Hn)
        return jnp.stack([evens, odds], axis=1).reshape(n, a.shape[1])
    n = a.shape[1]
    assert n % 2 == 0, "B4T requires even dimensions"
    m = n // 2
    L = a[:, :m]
    H = a[:, m:]
    Lp = jnp.concatenate([L[:, :1], L[:, :-1]], axis=1)
    Hp = jnp.concatenate([H[:, :1], H[:, :-1]], axis=1)
    Ln = jnp.concatenate([L[:, 1:], L[:, -1:]], axis=1)
    Hn = jnp.concatenate([H[:, 1:], H[:, -1:]], axis=1)
    evens = round8(Lp + 3 * L + Hp - 3 * H)
    odds = round8(3 * L + Ln + 3 * H - Hn)
    # lane-interleave evens/odds: (r, m, 2) -> (r, n)
    return jnp.stack([evens, odds], axis=2).reshape(a.shape[0], n)


def _b4t_fwd_2d(a):
    """fwd_b4t_2d (sbt.c:240-251): rows then columns."""
    return _b4t_fwd_axis(_b4t_fwd_axis(a, 1), 0)


def _b4t_inv_2d(a):
    """inv_b4t_2d (sbt.c:253-265): columns then rows."""
    return _b4t_inv_axis(_b4t_inv_axis(a, 0), 1)


def fwd_sbt(coefs, is_p, constrain=None):
    """dsv_fwd_sbt (sbt.c:630-651) on centered int32 coefs of shape (H, W).

    is_p may be traced: level 1 then computes both B4T (intra) and Haar
    and selects — one extra level of work, which lets a whole GOP scan
    share a single compiled core for I and P frames (parallel/gop.py).

    constrain, if given, is `f(a, level) -> a` applied to the carried
    region before and after each level — the tile-sharding hook
    (parallel/gop.py gop×tile mesh): it pins fine levels column-sharded
    and the coarse tail replicated, so XLA's SPMD partitioner inserts
    the B4T/Haar halo exchanges.
    """
    H, W = coefs.shape
    lvls = nlevels(W, H)
    cur = jnp.asarray(coefs, jnp.int32)
    pieces = [None] * (lvls + 1)
    for i in range(1, lvls + 1):
        if constrain is not None:
            cur = constrain(cur, i)
        if i == 1:
            static = isinstance(is_p, bool)
            if static and is_p:
                LL, LH, HL, HH = _haar_fwd_region(cur, 1, False)
            elif static:
                b = _b4t_fwd_2d(cur)
                ch, cw = (H + 1) // 2, (W + 1) // 2
                LL, LH = b[:ch, :cw], b[:ch, cw:]
                HL, HH = b[ch:, :cw], b[ch:, cw:]
            else:
                hLL, hLH, hHL, hHH = _haar_fwd_region(cur, 1, ~is_p)
                b = _b4t_fwd_2d(cur)
                ch, cw = (H + 1) // 2, (W + 1) // 2
                LL = jnp.where(is_p, hLL, b[:ch, :cw])
                LH = jnp.where(is_p, hLH, b[:ch, cw:])
                HL = jnp.where(is_p, hHL, b[ch:, :cw])
                HH = jnp.where(is_p, hHH, b[ch:, cw:])
        else:
            LL, LH, HL, HH = _haar_fwd_region(cur, i, True)
        pieces[i] = (LH, HL, HH)
        cur = LL
        if constrain is not None:
            cur = constrain(cur, i)
    for i in range(lvls, 0, -1):
        cur = _assemble(cur, *pieces[i])
    return cur


def _hqp_for_level(q, is_p, i: int):
    """C.3.1.4 get_HQP (sbt.c:667-696). Returns traced int32."""
    llq = trunc_div(get_quant(q, is_p, 0), 2)
    if i > 3:
        return llq
    hqp = get_quant(q, is_p, MAXLVL - i)
    if i == 1:
        hqp = lb2(hqp)
        hqp = jnp.clip(hqp - jnp.where(is_p, QP_P, QP_I), 1, 24)
        hqp = jnp.left_shift(jnp.int32(1), hqp)
        hqp = hqp >> 1
    return trunc_div(hqp, 2)


def _haar_inv_region(cur, lh_col, hl_row, LH, HL, HH, ws: int, hs: int,
                     lvl: int, is_i, filtered: bool = False, hqp=None):
    """C.3.1.3/C.3.1.4 Haar inverse, one level (sbt.c:351-574), on the
    carried LL region.

    cur: raw (pre-inv-scale) LL values, (ch, cw) — the reconstruction of
    the deeper levels. lh_col (ch, 1) / hl_row (1, cw): the first LH
    column / HL row from the ORIGINAL coef array — the filtered inverse's
    cross-quadrant neighbour reads (sbt.c:480-510). LH/HL/HH: the level's
    band pieces zero-padded to (ch, cw). is_i may be traced.
    """
    ch, cw = cur.shape
    fw, fh = ws // 2, hs // 2

    if lvl > 1:
        def inv_scale(v):
            return trunc_div(v * 5, 4)
    elif isinstance(is_i, bool):
        if is_i:
            def inv_scale(v):
                return trunc_div(v * 5, 4)
        else:
            def inv_scale(v):
                return v
    else:
        def inv_scale(v):
            return jnp.where(is_i, trunc_div(v * 5, 4), v)

    LL = inv_scale(cur)

    if filtered:
        # C.3.1.4: nudge LH along x using LL left/right neighbours, HL
        # along y. Neighbour reads deliberately cross the quadrant
        # boundary like the C (the +1 neighbour at the LL edge is the
        # band's first column/row). The oddw/oddh tail row/column is
        # emitted by the C's dedicated odd branches (sbt.c:534-572)
        # which never nudge — exclude both axes.
        lp = inv_scale(jnp.concatenate([cur[:, :1], cur[:, :cw - 1]],
                                       axis=1))
        ln = inv_scale(jnp.concatenate([cur[:, 1:], lh_col], axis=1))
        col = jnp.arange(cw)
        row = jnp.arange(ch)
        in_x = ((col >= 1) & (col <= fw - 1))[None, :] \
            & (row <= fh - 1)[:, None]

        def nudge(LLv, lo, hi, band, mask):
            mx = LLv - hi
            mn = lo - LLv
            mn2 = jnp.minimum(mn, mx)
            mx2 = jnp.maximum(mn, mx)
            mx3 = jnp.minimum(mx2, 0)
            mn3 = jnp.maximum(mn2, 0)
            t = round4(lo - hi)
            nd = round2(jnp.clip(t, mx3, mn3) - (band * 2))
            nd = jnp.clip(nd, -hqp, hqp)
            return jnp.where(mask & (mx3 != mn3), band + nd, band)

        LH = nudge(LL, lp, ln, LH, in_x)

        up = inv_scale(jnp.concatenate([cur[:1, :], cur[:ch - 1, :]],
                                       axis=0))
        dn = inv_scale(jnp.concatenate([cur[1:, :], hl_row], axis=0))
        in_y = ((row >= 1) & (row <= fh - 1))[:, None] \
            & (col <= fw - 1)[None, :]
        HL = nudge(LL, up, dn, HL, in_y)

    a00 = trunc_div(LL + LH + HL + HH, 4)
    a01 = trunc_div(LL - LH + HL - HH, 4)
    a10 = trunc_div(LL + LH - HL - HH, 4)
    a11 = trunc_div(LL - LH - HL + HH, 4)
    out = _interleave2x2(a00, a01, a10, a11)
    return out[:hs, :ws]


def inv_sbt(coefs, q, is_p, is_luma: bool, constrain=None):
    """dsv_inv_sbt (sbt.c:653-714) on int32 coefs; q and is_p may be
    traced (level 1 computes both inverse transforms and selects when
    is_p is traced). constrain: per-level sharding hook (see fwd_sbt)."""
    H, W = coefs.shape
    lvls = nlevels(W, H)
    a = jnp.asarray(coefs, jnp.int32)
    if constrain is not None:
        # pin the band source once: every level's band pieces are read
        # from `a`, so give it the finest-level (column-sharded) layout
        a = constrain(a, 1)
    _, _, cwl, chl, _, _ = _quad_dims(W, H, lvls)
    cur = a[:chl, :cwl]
    for i in range(lvls, 0, -1):
        ws, hs, cw, ch, fw, fh = _quad_dims(W, H, i)
        if constrain is not None:
            cur = constrain(cur, i)
        hqp = _hqp_for_level(q, is_p, i) if is_luma else None
        LHr = a[0:ch, cw:cw + fw]
        HLr = a[ch:ch + fh, 0:cw]
        LH = jnp.pad(LHr, ((0, 0), (0, cw - fw)))
        HL = jnp.pad(HLr, ((0, ch - fh), (0, 0)))
        HH = jnp.pad(a[ch:ch + fh, cw:cw + fw],
                     ((0, ch - fh), (0, cw - fw)))
        # cross-quadrant neighbour reads: col cw / row ch of the
        # in-place array == original input (bands are read before any
        # finer level writes there — there are no writes at all here)
        lh_col = a[0:ch, cw:cw + 1]
        hl_row = a[ch:ch + 1, 0:cw]
        if i > 1:
            cur = _haar_inv_region(cur, lh_col, hl_row, LH, HL, HH,
                                   ws, hs, i, True, filtered=is_luma,
                                   hqp=hqp)
        else:
            static = isinstance(is_p, bool)
            if static and is_p:
                cur = _haar_inv_region(cur, lh_col, hl_row, LH, HL, HH,
                                       ws, hs, 1, False,
                                       filtered=is_luma, hqp=hqp)
            else:
                # B4T reads the raw (unpadded) bands; assemble the
                # level-1 in-place state: reconstructed LL corner +
                # the original bottom band rows (even dims in the B4T
                # regime, so ch == fh and cw == fw)
                full = jnp.concatenate(
                    [jnp.concatenate([cur, LHr], axis=1),
                     a[ch:hs, 0:ws]], axis=0)
                b = _b4t_inv_2d(full)
                if static:
                    cur = b
                else:
                    h = _haar_inv_region(cur, lh_col, hl_row, LH, HL, HH,
                                         ws, hs, 1, ~is_p,
                                         filtered=is_luma, hqp=hqp)
                    cur = jnp.where(is_p, h, b)
        if constrain is not None:
            cur = constrain(cur, i)
    return cur


def plane_to_coefs(plane_u8):
    """p2sbc (sbt.c:576-592): center pixels around zero as int32."""
    return plane_u8.astype(jnp.int32) - 128


def coefs_to_plane(coefs):
    """sbc2int (C.3.3, sbt.c:594-614): +128 and clamp to u8."""
    return jnp.clip(coefs + 128, 0, 255).astype(jnp.uint8)
