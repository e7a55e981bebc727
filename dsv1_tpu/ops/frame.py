"""Frame memory model: C-layout flat images on device.

The reference stores a frame as one contiguous allocation: three planes,
each with a 16-byte-rounded stride and an optional 64px replicated border
(reference frame.c:63-120, border fill frame.c:263-295). Motion-compensation
filter taps deliberately read a few bytes past row/plane edges, which in the
reference lands in adjacent rows/planes of the same allocation.

Design: we keep the *same* flat layout as a device uint8 array
("C memory image"). All MC reads become flat-index gathers, so edge
behavior matches the reference bit-for-bit with zero special cases. Plane
views are static reshapes; border extension is a vectorized pad.
"""

from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (FRAME_BORDER, format_h_shift, format_v_shift,
                         round_pow2, round_shift)


@dataclass(frozen=True, eq=False)
class PlaneGeom:
    offset: int   # flat index of pixel (0, 0)
    stride: int
    w: int
    h: int
    ext: int      # border size (0 or 64)


@dataclass(frozen=True, eq=False)
class FrameLayout:
    subsamp: int
    width: int
    height: int
    border: bool
    planes: tuple  # (PlaneGeom, PlaneGeom, PlaneGeom)
    total: int     # total flat size
    margin: int    # tail guard so filter taps never index past the array


@lru_cache(maxsize=64)
def make_layout(subsamp: int, width: int, height: int,
                border: bool) -> FrameLayout:
    """Mirrors dsv_mk_frame geometry (frame.c:63-120)."""
    ext = FRAME_BORDER if border else 0
    hs, vs = format_h_shift(subsamp), format_v_shift(subsamp)
    cw, ch = round_shift(width, hs), round_shift(height, vs)
    planes = []
    base = 0
    for (w, h) in ((width, height), (cw, ch), (cw, ch)):
        # 256-byte stride alignment (the reference uses 16, frame.c:63;
        # our device layout is internal): span_gather gathers 128-byte
        # chunks when they divide the stride (ops/opt.py _chunk_width),
        # where a 16-byte-aligned chroma stride would give 64-wide ones
        # (whether the wider alignment pays on a GPU is open).
        stride = round_pow2(w + ext * 2, 8)
        length = stride * (h + ext * 2)
        planes.append(PlaneGeom(offset=base + stride * ext + ext,
                                stride=stride, w=w, h=h, ext=ext))
        base += length
    # head/tail margins: vertical filter taps reach up to 2 rows past the
    # border; C reads whatever memory is adjacent — we pin it to zeros.
    margin = max(p.stride for p in planes) * 4
    return FrameLayout(subsamp=subsamp, width=width, height=height,
                       border=border, planes=tuple(planes),
                       total=base, margin=margin)


def alloc_image(layout: FrameLayout):
    """Zeroed flat image (calloc semantics) with guard margins."""
    return jnp.zeros(layout.total + 2 * layout.margin, jnp.uint8)


def plane_view(img, layout: FrameLayout, c: int):
    """(h, w) view of a plane's core pixels."""
    p = layout.planes[c]
    start = layout.margin + p.offset - p.stride * p.ext - p.ext
    seg = jnp.reshape(
        img[start:start + p.stride * (p.h + 2 * p.ext)],
        (p.h + 2 * p.ext, p.stride))
    return seg[p.ext:p.ext + p.h, p.ext:p.ext + p.w]


def plane_view_ext(img, layout: FrameLayout, c: int, pad: int):
    """(h+pad, w+pad) view including `pad` border pixels right/below."""
    p = layout.planes[c]
    start = layout.margin + p.offset - p.stride * p.ext - p.ext
    seg = jnp.reshape(
        img[start:start + p.stride * (p.h + 2 * p.ext)],
        (p.h + 2 * p.ext, p.stride))
    return seg[p.ext:p.ext + p.h + pad, p.ext:p.ext + p.w + pad]


def set_plane(img, layout: FrameLayout, c: int, plane2d):
    """Write a (h, w) uint8 plane into the image core."""
    p = layout.planes[c]
    start = layout.margin + p.offset - p.stride * p.ext - p.ext
    seg = jnp.reshape(
        img[start:start + p.stride * (p.h + 2 * p.ext)],
        (p.h + 2 * p.ext, p.stride))
    seg = seg.at[p.ext:p.ext + p.h, p.ext:p.ext + p.w].set(
        plane2d.astype(jnp.uint8))
    return img.at[start:start + p.stride * (p.h + 2 * p.ext)].set(
        seg.reshape(-1))


def extend_plane(img, layout: FrameLayout, c: int):
    """Replicated border extension (dsv_extend_frame, frame.c:263-295)."""
    p = layout.planes[c]
    if p.ext == 0:
        return img
    e = p.ext
    start = layout.margin + p.offset - p.stride * e - e
    nrows = p.h + 2 * e
    seg = jnp.reshape(img[start:start + p.stride * nrows], (nrows, p.stride))
    core = seg[e:e + p.h, e:e + p.w]
    left = jnp.repeat(core[:, :1], e, axis=1)
    right = jnp.repeat(core[:, -1:], e, axis=1)
    rows = jnp.concatenate([left, core, right], axis=1)
    if p.stride > p.w + 2 * e:
        rows = jnp.pad(rows, ((0, 0), (0, p.stride - p.w - 2 * e)))
    top = jnp.repeat(rows[:1], e, axis=0)
    bot = jnp.repeat(rows[-1:], e, axis=0)
    full = jnp.concatenate([top, rows, bot], axis=0)
    return img.at[start:start + p.stride * nrows].set(full.reshape(-1))


def extend_frame(img, layout: FrameLayout):
    for c in range(3):
        img = extend_plane(img, layout, c)
    return img


def _ext_plane_rows(plane2d, p: PlaneGeom):
    """One plane's full row block: edge-replicated border + zero stride
    tail, flattened (equivalent to set_plane + extend_plane)."""
    full = plane2d.astype(jnp.uint8)
    if p.ext:
        full = jnp.pad(full, ((p.ext, p.ext), (p.ext, p.ext)), mode="edge")
    tail = p.stride - full.shape[1]
    if tail:
        full = jnp.pad(full, ((0, 0), (0, tail)))
    return full.reshape(-1)


def image_from_planes(layout: FrameLayout, planes):
    """Build an extended image from three (h, w) planes as one concat
    (plane row blocks are contiguous in the flat layout)."""
    segs = [jnp.zeros(layout.margin, jnp.uint8)]
    for c in range(3):
        segs.append(_ext_plane_rows(planes[c], layout.planes[c]))
    segs.append(jnp.zeros(layout.margin, jnp.uint8))
    return jnp.concatenate(segs)


def image_from_luma(layout: FrameLayout, luma):
    """Extended image with only the luma plane populated (pyramid levels:
    chroma stays zero like the reference's calloc'd pyramid frames)."""
    p0 = layout.planes[0]
    rest = layout.total - p0.stride * (p0.h + 2 * p0.ext)
    return jnp.concatenate([
        jnp.zeros(layout.margin, jnp.uint8),
        _ext_plane_rows(luma, p0),
        jnp.zeros(rest + layout.margin, jnp.uint8),
    ])


def flat_base(layout: FrameLayout, c: int):
    """Flat index (into the margined array) of plane c's pixel (0, 0)."""
    return layout.margin + layout.planes[c].offset


def ds2x_luma(plane2d, dw: int, dh: int):
    """2x2 box-filter luma downsample (dsv_ds2x_frame_luma, frame.c:240-261).

    plane2d must be the *extended* luma view large enough for 2*dh, 2*dw
    reads (odd source dims read one row/col into the border).
    """
    a = plane2d.astype(jnp.int32)
    # lax.slice, not strided getitem: `a[r0::2, c0::2]` lowers to a full
    # elementwise gather (see ops/sbt.py _slice2).
    # All four phases share limit (2dh, 2dw): from start 1 the stride-2
    # count ceil((2d-1)/2) == d, identical indices to the C loop.
    lim = (2 * dh, 2 * dw)
    if 2 * dw >= 256:
        # column pairs as a matrix contraction (ops/opt.py
        # col_block_dot) instead of column-strided phase slices, rows via
        # row-strided slices
        from .opt import PAIR_SUM64, col_block_dot
        reg = jax.lax.slice(a, (0, 0), lim)
        cs = col_block_dot(reg, PAIR_SUM64).reshape(2 * dh, -1)[:, :dw]
        r0 = jax.lax.slice(cs, (0, 0), (2 * dh, dw), (2, 1))
        r1 = jax.lax.slice(cs, (1, 0), (2 * dh, dw), (2, 1))
        return ((r0 + r1 + 2) >> 2).astype(jnp.uint8)
    p1 = jax.lax.slice(a, (0, 0), lim, (2, 2))
    p2 = jax.lax.slice(a, (0, 1), lim, (2, 2))
    p3 = jax.lax.slice(a, (1, 0), lim, (2, 2))
    p4 = jax.lax.slice(a, (1, 1), lim, (2, 2))
    return ((p1 + p2 + p3 + p4 + 2) >> 2).astype(jnp.uint8)


def avg_luma(plane2d):
    """dsv_frame_avg_luma (frame.c:223-238): truncating mean.

    uint32 sum is exact up to 4K planes (255 * 8.3M < 2^32)."""
    a = plane2d.astype(jnp.uint32)
    n = jnp.uint32(plane2d.shape[0] * plane2d.shape[1])
    return (jnp.sum(a) // n).astype(jnp.int32)


def plane_sizes(subsamp: int, w: int, h: int):
    """(luma, chroma) element counts of one packed planar frame."""
    from ..constants import format_h_shift, format_v_shift, round_shift
    cw = round_shift(w, format_h_shift(subsamp))
    ch = round_shift(h, format_v_shift(subsamp))
    return w * h, cw * ch, cw, ch


def split_packed_planes(packed, subsamp: int, w: int, h: int):
    """Device side: (..., fsz) packed planar uint8 -> (y, u, v).

    Input frames go host->device as ONE packed byte array instead of
    three (y, u, v) arrays, one transfer per chunk, mirroring the D2H
    blob (ops/opt.py:blob_concat). The byte order
    is the raw planar YUV file order (dsv.c:98-170)."""
    ysz, csz, cw, ch = plane_sizes(subsamp, w, h)
    lead = packed.shape[:-1]
    return (packed[..., :ysz].reshape(lead + (h, w)),
            packed[..., ysz:ysz + csz].reshape(lead + (ch, cw)),
            packed[..., ysz + csz:ysz + 2 * csz].reshape(lead + (ch, cw)))


def np_pack_planes(planes) -> np.ndarray:
    """Host side: (y, u, v) -> one (fsz,) uint8 planar byte array."""
    return np.concatenate([np.asarray(p, np.uint8).ravel()
                           for p in planes[:3]])


def np_yuv_split(data: np.ndarray, subsamp: int, w: int, h: int):
    """Split a planar YUV frame byte buffer into three (h, w) arrays."""
    hs, vs = format_h_shift(subsamp), format_v_shift(subsamp)
    cw, ch = round_shift(w, hs), round_shift(h, vs)
    y = data[: w * h].reshape(h, w)
    u = data[w * h: w * h + cw * ch].reshape(ch, cw)
    v = data[w * h + cw * ch: w * h + 2 * cw * ch].reshape(ch, cw)
    return y, u, v
