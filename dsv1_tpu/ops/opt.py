"""XLA lowering helpers: transfer coalescing and gather/contraction forms."""

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

_BLOB_NPDT = {"8": np.int8, "16": np.int16, "32": np.int32}
_BLOB_W = {"8": 1, "16": 2, "32": 4}


def blob_concat(tree, C, layout_box):
    """Device side: coalesce an output pytree of (C, ...)-batched arrays
    into one (C, nbytes) int8 blob (narrow dtypes bitcast to int8) so the
    host pays a single D2H fetch per dispatch instead of one per leaf.
    The static layout is recorded in layout_box at trace time."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    specs, parts = [], []
    for a in leaves:
        a2 = a.reshape(C, -1)
        if a.dtype in (jnp.int8, jnp.uint8, jnp.bool_):
            kind = "8"
            b = a2.astype(jnp.int8)
        elif a.dtype in (jnp.int16, jnp.uint16):
            kind = "16"
            b = lax.bitcast_convert_type(
                a2.astype(jnp.int16), jnp.int8).reshape(C, -1)
        else:
            kind = "32"
            b = lax.bitcast_convert_type(
                a2.astype(jnp.int32), jnp.int8).reshape(C, -1)
        specs.append((kind, a.dtype, a.shape, a2.shape[1]))
        parts.append(b)
    layout_box["specs"] = specs
    layout_box["treedef"] = treedef
    return jnp.concatenate(parts, axis=1)


def blob_split(blob, layout_box):
    """Host side: byte blob (already device_get) -> output pytree."""
    buf = np.asarray(blob)
    off = 0
    leaves = []
    for kind, dtype, shape, ncols in layout_box["specs"]:
        nb_ = ncols * _BLOB_W[kind]
        seg = np.ascontiguousarray(buf[:, off:off + nb_]) \
            .view(_BLOB_NPDT[kind])
        off += nb_
        # leading dim from the blob, not the recorded shape: under
        # shard_map the trace sees per-shard batches; unsigned dtypes
        # round-trip bit-exactly through the signed astype (mod 2^n)
        leaves.append(seg.reshape((seg.shape[0],) + shape[1:])
                      .astype(dtype))
    return jax.tree_util.tree_unflatten(layout_box["treedef"], leaves)


def blob_concat_np(arrs):
    """Host mirror of blob_concat for the H2D direction: batched numpy
    arrays (C, ...) -> ((C, nbytes) uint8, specs). One coalesced upload
    instead of one per array; blob_split_device re-types on device."""
    specs, parts = [], []
    for a in arrs:
        a = np.ascontiguousarray(a)
        specs.append((a.dtype.str, a.shape))
        parts.append(a.reshape(a.shape[0], -1).view(np.uint8))
    return np.concatenate(parts, axis=1), tuple(specs)


def blob_split_device(blob, specs):
    """Device side: (C, nbytes) uint8 -> typed arrays per specs (the
    trace-time static layout from blob_concat_np). Byte order matches
    numpy's native little-endian view (same convention as blob_concat's
    D2H direction, golden-tested)."""
    C = blob.shape[0]
    out = []
    off = 0
    for dstr, shape in specs:
        dt = np.dtype(dstr)
        n = int(np.prod(shape[1:], dtype=np.int64))
        seg = blob[:, off:off + n * dt.itemsize]
        off += n * dt.itemsize
        if dt == np.bool_:
            a = (seg != 0).reshape((C,) + shape[1:])
        elif dt.itemsize == 1:
            a = lax.bitcast_convert_type(seg, dt).reshape((C,) + shape[1:])
        else:
            a = lax.bitcast_convert_type(
                seg.reshape(C, n, dt.itemsize), dt).reshape((C,) + shape[1:])
        out.append(a)
    return out


# column-pair SUM matrix for col_block_dot: out lane k of a 128-col
# block = cols 2k + 2k+1 (k < 64)
PAIR_SUM64 = np.zeros((128, 64), np.float32)
for _k in range(64):
    PAIR_SUM64[2 * _k, _k] = PAIR_SUM64[2 * _k + 1, _k] = 1.0


def col_block_dot(a, M):
    """Per-128-column-block contraction with a static (128, K) matrix.

    A matrix form of column-phase work (pair sums/diffs,
    deinterleaves): one einsum against a +-1/0 matrix does all phases
    in one pass instead of one column-strided slice per phase (whether
    it beats the strided form on a GPU is an open measurement). Exact
    for integer inputs: products are +-1-weighted, f32 represents
    integers < 2^24 exactly, and HIGHEST precision keeps full f32
    products (a TF32 or bf16-pass product rounds large sums).

    a: (r, n) int. Returns (r, nblocks, K) int32; block b lane k =
    dot(a[:, 128b:128b+128], M[:, k]).
    """
    r, n = a.shape
    wp = -(-n // 128) * 128
    if wp != n:
        a = jnp.pad(a, ((0, 0), (0, wp - n)))
    t = a.reshape(r, wp // 128, 128).astype(jnp.float32)
    return jnp.einsum("hbw,wk->hbk", t, jnp.asarray(M),
                      preferred_element_type=jnp.float32,
                      precision=lax.Precision.HIGHEST).astype(jnp.int32)


def runtime(*xs):
    """Mark index arrays as runtime values to defeat constant folding.

    An earlier backend lowered gathers/scatters whose index operand is a
    compile-time constant through a slow path. Wrapping the indices in
    an optimization barrier keeps them as materialized runtime values,
    so the dynamic-gather lowering is used. A barrier on an
    already-runtime value is free, so call sites apply it
    unconditionally (whether it still pays is an open measurement).
    """
    out = lax.optimization_barrier(xs)
    return out[0] if len(xs) == 1 else out


def _chunk_width(S: int) -> int:
    """Largest power-of-two divisor of the row stride, capped at 128.
    Strides are 16-byte aligned (frame.c:63), so this is >= 16; bigger
    chunks mean fewer gather rows with longer contiguous slices."""
    cw = 16
    while cw < 128 and S % (cw * 2) == 0:
        cw *= 2
    return cw


def span_gather(flat, row_start, BW: int, S: int):
    """Gather BW contiguous bytes at each flat byte offset in row_start.

    row_start: (nb, BH) non-negative flat offsets into a row-structured
    uint8 buffer with 16-byte-aligned row length S. The gather is shaped
    so its minor dimension is a contiguous slice rather than one index
    per element: (1) view the flat buffer as 16-byte chunks and
    outer-dim-gather the k chunks covering each span (reads cross row
    boundaries through flat memory exactly like the reference's
    bounds-check-free C reads, e.g. hme.c:526-541), then (2) align
    columns with a small one-hot contraction — exact at any matmul
    precision, since u8 values and one-hot weights are exact in bf16
    and each output sums one nonzero product in f32. The k*16 one-hot
    stays tiny at any resolution (a stride-wide variant needs a
    2S-column one-hot: 0.5 GB/window at 1080p).

    All rows of a span share the same intra-chunk offset (row_start rows
    differ by multiples of S, and 16 | S), so the one-hot is built per
    span from row 0.
    """
    CW = _chunk_width(S)
    k = (BW - 1) // CW + 2
    nch = flat.shape[0] // CW
    chunks2d = flat[:nch * CW].reshape(nch, CW)
    c0 = row_start // CW                           # (nb, BH)
    idx = jnp.clip(c0[:, :, None] + jnp.arange(k)[None, None, :],
                   0, nch - 1)
    slab = chunks2d[idx].reshape(row_start.shape[0], row_start.shape[1],
                                 k * CW)           # (nb, BH, k*CW)
    o = row_start[:, 0] % CW                       # (nb,)
    sel = (o[:, None, None] + jnp.arange(BW)[None, :, None]
           == jnp.arange(k * CW)[None, None, :])   # (nb, BW, k*CW)
    win = jnp.einsum("nrc,nwc->nrw", slab.astype(jnp.bfloat16),
                     sel.astype(jnp.bfloat16),
                     preferred_element_type=jnp.float32)
    # barrier the result: without it XLA fuses the chunk gather into
    # downstream consumers, which scalarized it inside the fusion loop
    # on an earlier backend
    return runtime(win.astype(jnp.uint8))
