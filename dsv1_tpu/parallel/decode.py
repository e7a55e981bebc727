"""GOP-parallel device decode path.

Mirror of the encode design (parallel/gop.py): a closed chain of pictures
(an I frame and its dependent P frames) is serially coupled through the
reference frame (dsv_decoder.c:422-456), so one chain = one device
`lax.scan`; independent chains batch along a vmapped leading axis and
shard over mesh axis 'gop'.

Split of labor per picture:
- host (native/dsvbits.cpp + numpy): packet demux, header fields,
  stability ZBRLE, motion substreams with the raster MV predictor
  (dsv_decoder.c:73-145), HZCC symbol parse, and the grid scatter of
  quantized values (last-wins over band aliases, matching the
  reference's sequential visit order);
- device: per-band dequantization, inverse subband transforms, whole-
  plane half-pel motion compensation and residual add — all inside the
  scan, with is_p as a traced operand (one compiled step for I and P).

Quantized symbol values upload as int32: the coarse LL values of large
frames exceed int16 (1080p streams do), and the symbol lists are small
next to the frames.
"""

from collections import Counter
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from ..constants import (MAX_QP_BITS, MIN_BLOCK_SIZE, MAX_BLOCK_SIZE,
                         PT_EOS, PT_META, div_round, pt_is_pic, pt_is_ref)
from .. import bits
from ..models.bitstream import iter_packets, parse_metadata, parse_packet_hdr
from ..models.encoder import coef_geometry
from ..models.metadata import Metadata
from ..ops import bmc, frame as fr, hzcc, sbt


# Streams decoded per path, read by chip_smoke.py and the tests:
# "batched" (chains scanned on device) or "sequential_fallback"
# (models/decoder.py, for streams the batched path cannot express).
EVENTS: Counter = Counter()


@lru_cache(maxsize=8)
def build_gop_decoder(subsamp: int, w: int, h: int, L: int,
                      blk_w: int, blk_h: int):
    """Pure fn decoding one chain of L pictures on device.

    f(sidx [Ksym] i32, sval [Ksym] i32, dcs [L,3] i32, quants [L] i32,
      is_p [L] bool, stable [L,nblk] u8, modes/mvx/mvy/submask [L,nblk])
      -> planes tuple of 3 [L,h,w] u8

    sidx/sval: the chain's quantized symbols as one flat sparse list in
    chain-local coordinates pic*N + plane_offset + grid_index (N = total
    coefficients per picture over the 3 planes), padded with the
    out-of-bounds index L*N (dropped by the device scatter). The coded
    size of a chain is ~100-1000x smaller than its dense grids, so
    shipping symbols and scattering on device removes the dominant H2D
    volume of the decode path (87 MB -> ~0.6 MB for the CIF bench
    stream; reference decode hot path dsv_decoder.c:286-472)."""
    nbh = div_round(w, blk_w)
    nbv = div_round(h, blk_h)
    layout, coef_dims, tables = coef_geometry(subsamp, w, h, nbh, nbv)
    nper = [ch * cw for (cw, ch) in coef_dims]
    N = sum(nper)
    offs = [0, nper[0], nper[0] + nper[1]]

    def step(ref_img, xs):
        qflat, dcs, quant, is_p, is_ref, stable, modes, mvx, mvy, \
            submask = xs
        outs = []
        for c in range(3):
            p = layout.planes[c]
            cw, ch = coef_dims[c]
            qgrid = qflat[offs[c]:offs[c] + nper[c]].reshape(ch, cw)
            coefs = hzcc.dequant_plane_grid(
                qgrid, dcs[c], quant, is_p, c, stable, tables[c])
            rec = sbt.inv_sbt(coefs, quant, is_p, is_luma=(c == 0))
            rp = sbt.coefs_to_plane(rec)[:p.h, :p.w]
            ref_plane = fr.plane_view(ref_img, layout, c)
            pred = bmc.compensate_plane(
                ref_img, ref_plane, layout, c, blk_w, blk_h, nbh, nbv,
                modes, mvx, mvy, submask)
            outs.append(jnp.where(is_p, bmc.add_residual(pred, rp), rp))
        new_img = fr.image_from_planes(layout, outs)
        # ref retention (dsv_decoder.c:438-456): only is_ref pictures
        # replace the reference
        new_img = jnp.where(is_ref, new_img, ref_img)
        return new_img, tuple(outs)

    def run(sidx, sval, dcs, quants, is_p, is_ref, stable,
            modes, mvx, mvy, submask):
        # one scatter materializes every picture's dense grids; padding
        # indices land at L*N and are dropped
        qdense = jnp.zeros((L * N,), jnp.int32) \
            .at[sidx].set(sval, mode="drop").reshape(L, N)
        carry0 = fr.alloc_image(layout)
        xs = (qdense, dcs, quants, is_p, is_ref, stable,
              modes, mvx, mvy, submask)
        _, outs = lax.scan(step, carry0, xs)
        return outs

    return run


@lru_cache(maxsize=8)
def _jit_batched_dec(subsamp, w, h, L, blk_w, blk_h, mesh_key, in_specs):
    """Blob-coalesced batched decoder: ONE (chunk, nbytes) u8 upload per
    chunk (split/retyped on device, ops/opt.py:blob_split_device) and
    ONE byte-blob fetch of the decoded planes (blob_concat), instead of
    12 uploads + 3 fetches per chunk."""
    from ..ops.opt import blob_concat, blob_split_device
    run = build_gop_decoder(subsamp, w, h, L, blk_w, blk_h)
    vrun = jax.vmap(run)
    layout_box = {}

    def blob_run(blob):
        outs = vrun(*blob_split_device(blob, in_specs))
        return blob_concat(outs, blob.shape[0], layout_box)

    if mesh_key is None:
        return jax.jit(blob_run), layout_box
    mesh = _MESHES[mesh_key]
    shard = NamedSharding(mesh, PartitionSpec("gop"))
    return (jax.jit(blob_run, in_shardings=shard, out_shardings=shard),
            layout_box)


_MESHES: dict = {}


@lru_cache(maxsize=16)
def _plane_caps(subsamp: int, w: int, h: int):
    """Per-plane traversal sizes (symbol caps) — independent of the
    block grid, so computable before the packet's block dims are read."""
    _, _, tables = coef_geometry(subsamp, w, h, 1, 1)
    return tuple(t.n for t in tables)


def _parse_picture(data: bytes, meta: Metadata):
    """Host parse of one picture packet -> dict (dsv_decoder.c:286-412).

    One native call (dsv1n_parse_picture) parses the header fields, the
    stability ZBRLE, the motion substreams (raster MV predictor) and the
    three HZCC symbol streams; numpy scatters the quantized values into
    grid order (last-wins over band aliases, matching the reference's
    sequential visit order)."""
    pkt_type = parse_packet_hdr(data)
    hdr, stable, modes, mvx, mvy, submask, planes = bits.parse_picture(
        data, meta.width, meta.height, MAX_QP_BITS,
        MIN_BLOCK_SIZE, MAX_BLOCK_SIZE,
        _plane_caps(meta.subsamp, meta.width, meta.height))
    nbh, nbv = hdr["nbh"], hdr["nbv"]
    _, coef_dims, tables = coef_geometry(meta.subsamp, meta.width,
                                         meta.height, nbh, nbv)
    sidx, sval, dcs = [], [], []
    for c in range(3):
        cw, ch = coef_dims[c]
        dc, runs, vals, plen = planes[c]
        if plen <= 0 or plen > cw * ch * 4 * 2:
            raise ValueError("bad plane length")
        if runs.size:
            pos = np.cumsum(runs.astype(np.int64) + 1) - 1
            keep = pos < tables[c].n
            v = vals[:runs.size][keep]
            idx = tables[c].perm[pos[keep]].astype(np.int32)
            # resolve band aliases last-wins here (reference visit
            # order), so the deferred grid scatter is duplicate-free
            u, last_rev = np.unique(idx[::-1], return_index=True)
            sidx.append(u)
            sval.append(v.astype(np.int32)[::-1][last_rev])
        else:
            sidx.append(np.zeros(0, np.int32))
            sval.append(np.zeros(0, np.int32))
        dcs.append(dc)
    # grids are scattered lazily at device-batch time (qgrid_of):
    # keeping symbols instead of dense (ch, cw) int16 grids bounds the
    # whole-stream parse memory by the coded size, not the frame size
    return dict(fno=hdr["fno"], blk_w=hdr["blk_w"], blk_h=hdr["blk_h"],
                has_ref=hdr["has_ref"], is_ref=pt_is_ref(pkt_type),
                quant=hdr["quant"], stable=stable, modes=modes, mvx=mvx,
                mvy=mvy, submask=submask, sidx=sidx, sval=sval,
                dcs=np.asarray(dcs, np.int32))


def decode_stream_gops(stream: bytes, mesh: Mesh | None = None):
    """Decode a .dsv stream with chains of pictures batched on device.

    Returns (metadata, [(fno, [y, u, v]), ...] in stream order). Falls
    back to the sequential decoder for streams the batched path cannot
    express (no metadata, mid-stream geometry change).
    """
    meta_box = {}
    frames = list(iter_decode_gops(stream, mesh, _meta_box=meta_box))
    return meta_box.get("meta"), frames


def _plan_stream(meta, frames, mesh: Mesh | None):
    """Chunking plan + jitted decoder for a parsed picture list.

    Shared by iter_decode_gops and the bench's device-only decode metric
    (bench.py), so both measure the exact shipped executable. Returns
    (fn, layout_box, pack_chunk, chains, chunk, nc, npad, in_specs)."""
    # split into chains: every no-ref picture starts one
    chains = []
    for i, f in enumerate(frames):
        if not f["has_ref"] or not chains:
            chains.append([i])
        else:
            chains[-1].append(i)
    L = max(len(c) for c in chains)
    blk_w, blk_h = frames[0]["blk_w"], frames[0]["blk_h"]
    nblk = frames[0]["stable"].size
    w, h, subsamp = meta.width, meta.height, meta.subsamp
    _, coef_dims, _ = coef_geometry(subsamp, w, h,
                                    div_round(w, blk_w), div_round(h, blk_h))
    nper = [ch * cw for (cw, ch) in coef_dims]
    N = sum(nper)
    plane_off = np.asarray([0, nper[0], nper[0] + nper[1]], np.int64)

    # chain-flat symbol capacity: bucket the max chain total to limit
    # recompiles across streams (power-of-two, floor 256)
    chain_syms = [sum(frames[fi]["sidx"][c].size
                      for fi in ch_ for c in range(3)) for ch_ in chains]
    Ksym = 256
    while Ksym < max(chain_syms):
        Ksym *= 2

    per_dev = max(1, min(4, (4 * 352 * 288 * 12) // max(L * w * h, 1),
                         len(chains)))
    if mesh is not None:
        chunk = per_dev * mesh.devices.size
        key = id(mesh)
        _MESHES[key] = mesh
    else:
        chunk = per_dev
        key = None
    in_specs = (
        (np.dtype(np.int32).str, (chunk, Ksym)),
        (np.dtype(np.int32).str, (chunk, Ksym)),
        (np.dtype(np.int32).str, (chunk, L, 3)),
        (np.dtype(np.int32).str, (chunk, L)),
        (np.dtype(np.bool_).str, (chunk, L)),
        (np.dtype(np.bool_).str, (chunk, L)),
        (np.dtype(np.uint8).str, (chunk, L, nblk)))
    in_specs += ((np.dtype(np.int32).str, (chunk, L, nblk)),) * 4
    fn, layout_box = _jit_batched_dec(subsamp, w, h, L, blk_w, blk_h, key,
                                      in_specs)

    nc = len(chains)
    npad = div_round(nc, chunk) * chunk

    def pack_chunk(s):
        # padding slots point past the chain's grids (L*N): the device
        # scatter drops them (mode='drop')
        sidx = np.full((chunk, Ksym), L * N, np.int32)
        sval = np.zeros((chunk, Ksym), np.int32)
        dcs = np.zeros((chunk, L, 3), np.int32)
        quants = np.zeros((chunk, L), np.int32)
        is_p = np.zeros((chunk, L), bool)
        is_ref = np.zeros((chunk, L), bool)
        stable = np.zeros((chunk, L, nblk), np.uint8)
        mo = np.zeros((chunk, L, nblk), np.int32)
        mx = np.zeros((chunk, L, nblk), np.int32)
        my = np.zeros((chunk, L, nblk), np.int32)
        sb = np.zeros((chunk, L, nblk), np.int32)
        for cl in range(chunk):
            ci = s + cl
            if ci >= nc:
                break
            pos = 0
            for k, fi in enumerate(chains[ci]):
                f = frames[fi]
                for c in range(3):
                    n_ = f["sidx"][c].size
                    sidx[cl, pos:pos + n_] = (k * N + plane_off[c]
                                              + f["sidx"][c])
                    sval[cl, pos:pos + n_] = f["sval"][c]
                    pos += n_
                dcs[cl, k] = f["dcs"]
                quants[cl, k] = f["quant"]
                is_p[cl, k] = f["has_ref"]
                is_ref[cl, k] = f["is_ref"]
                stable[cl, k] = f["stable"]
                mo[cl, k] = f["modes"]
                mx[cl, k] = f["mvx"]
                my[cl, k] = f["mvy"]
                sb[cl, k] = f["submask"]
        return (sidx, sval, dcs, quants, is_p, is_ref, stable,
                mo, mx, my, sb)

    return fn, layout_box, pack_chunk, chains, chunk, nc, npad, in_specs


def bench_device_chunk(stream: bytes):
    """(jitted decode fn, first chunk's packed blob, frames in chunk) —
    the device-only decode metric hook for bench.py: the exact shipped
    executable, timed on device-resident input up to block_until_ready
    like the encode device metric."""
    from ..ops.opt import blob_concat_np

    meta = None
    frames = []
    for _t, pkt in iter_packets(stream):
        t = parse_packet_hdr(pkt)
        if t == PT_META:
            meta = parse_metadata(pkt)
        elif t == PT_EOS:
            break
        elif pt_is_pic(t) and meta is not None:
            frames.append(_parse_picture(pkt, meta))
    fn, _lb, pack_chunk, chains, chunk, nc, _np_, _specs = \
        _plan_stream(meta, frames, None)
    blob_np, _ = blob_concat_np(pack_chunk(0))
    nf = sum(len(chains[ci]) for ci in range(min(chunk, nc)))
    return fn, blob_np, nf


def iter_decode_gops(stream: bytes, mesh: Mesh | None = None, *,
                     _meta_box: dict | None = None):
    """Generator variant of decode_stream_gops: yields (fno, [y, u, v])
    in stream order while holding only one device chunk of decoded
    frames (plus the parsed symbol lists) in memory."""
    meta = None
    frames = []
    for _t, pkt in iter_packets(stream):
        try:
            t = parse_packet_hdr(pkt)
            if t == PT_META:
                meta = parse_metadata(pkt)
            elif t == PT_EOS:
                break
            elif pt_is_pic(t) and meta is not None:
                frames.append(_parse_picture(pkt, meta))
        except (ValueError, IndexError):
            # corrupt or truncated packet: skip it, like the reference's
            # in-stream guards (hzcc.c:337-339, dsv_decoder.c:398-401)
            continue
    if _meta_box is not None:
        _meta_box["meta"] = meta
    if meta is None or not frames:
        return
    if len({(f["blk_w"], f["blk_h"]) for f in frames}) != 1:
        from ..models.decoder import Decoder
        EVENTS["sequential_fallback"] += 1
        dec = Decoder()
        yield from dec.decode_stream(stream)
        return

    fn, layout_box, pack_chunk, chains, chunk, nc, npad, in_specs = \
        _plan_stream(meta, frames, mesh)
    EVENTS["batched"] += 1

    from ..ops.opt import blob_concat_np
    from ..ops.opt import blob_split as _blob_split

    def dispatch_chunk(s):
        blob_np, specs = blob_concat_np(pack_chunk(s))
        assert specs == in_specs
        b = fn(blob_np)
        b.copy_to_host_async()
        return b

    starts = list(range(0, npad, chunk))
    inflight = {}
    if starts:
        inflight[starts[0]] = dispatch_chunk(starts[0])
    for si, s in enumerate(starts):
        if si + 1 < len(starts):
            inflight[starts[si + 1]] = dispatch_chunk(starts[si + 1])
        outs = _blob_split(jax.device_get(inflight.pop(s)), layout_box)
        for cl in range(chunk):
            ci = s + cl
            if ci >= nc:
                break
            for k, fi in enumerate(chains[ci]):
                yield (frames[fi]["fno"],
                       [outs[c][cl, k] for c in range(3)])
                frames[fi] = None  # free symbols as we go
