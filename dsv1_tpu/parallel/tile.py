"""Subband-tile sharding: intra-frame parallelism for large frames.

SURVEY.md §5: besides the GOP axis (parallel/gop.py) the codec's third
scaling axis is tiles *within* a frame — blocks are independent in
ME/MC/quant, and the subband transform couples tiles only through short
halos: the B4T is 4-tap (2-px halo, reference sbt.c:90-126), the
smoothing inverse filter reads ±1 LL sample (sbt.c:480-510), and the
plain Haar is 2x2-block local (sbt.c:267-349). Only the coarse levels of
the full decomposition couple a frame globally, and they are tiny
(<= (W/2^K) x (H/2^K) after K tiled levels) — the classic recipe is to
shard the fine levels and replicate the coarse tail.

Realization: frames are column-sharded over a 1-D 'tile'
device mesh (columns, because the packed quadrant layout keeps every
band's columns contiguous per tile, so a level's bands stay aligned to
the shard axis). The transform itself is the *same* integer-exact level
code as ops/sbt.py — jitted with `jax.sharding.NamedSharding` in/out
specs; XLA's SPMD partitioner propagates the sharding through each
level's strided slices and inserts the halo exchanges (collective-
permute of the 1-2 boundary columns) and the coarse-level gathers
automatically. That is the "annotate shardings, let XLA insert
collectives" design — no hand-written NCCL-analog, and bit-exactness is
inherited from the unsharded kernels (tested on an 8-device mesh).

The full tiled plane pipeline (fwd SBT -> adaptive quant + write-back ->
filtered inverse SBT, i.e. encode_picture's per-plane core,
dsv_encoder.c:505-526) is exposed as `encode_plane_tiled`.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import round_shift
from ..ops import hzcc, sbt


def tile_mesh(devices=None, axis: str = "tile") -> Mesh:
    """1-D device mesh over the intra-frame tile axis."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


_MESHES: dict = {}


def _sharding(mesh_key, axis, *, col: bool = True):
    mesh = _MESHES[mesh_key]
    return NamedSharding(mesh, P(None, axis) if col else P())


def _replicate_level(W: int, H: int, levels: int, D: int) -> int:
    """First level whose region is computed replicated instead of
    sharded: where the region width stops dividing evenly (odd dims
    no longer partition) or drops below 16 columns per device — the
    coarse tail is tiny, SURVEY.md §5: "replicate them rather than
    shard"."""
    for lvl in range(1, levels + 1):
        ws = round_shift(W, lvl - 1)
        if ws & 1 or ws < 16 * D:
            return lvl
    return levels + 1


def _mk_constrain(shard, repl, rep_lvl: int):
    """Per-level sharding-constraint hook for ops.sbt's carried-region
    transforms: fine levels stay column-sharded (Haar is 2x2-local; the
    B4T's 4-tap halo becomes a collective-permute under SPMD), the
    coarse tail from rep_lvl on is replicated. Applied to the carried
    region before and after each level's compute (ops/sbt.py)."""
    def con(a, lvl: int):
        return lax.with_sharding_constraint(
            a, repl if lvl >= rep_lvl else shard)

    return con


def _fwd_levels(a, W: int, H: int, is_p: bool, shard, repl, rep_lvl: int):
    """dsv_fwd_sbt's level loop (sbt.c:630-651), column-sharded."""
    return sbt.fwd_sbt(jnp.asarray(a, jnp.int32), is_p,
                       constrain=_mk_constrain(shard, repl, rep_lvl))


def _inv_levels(a, W: int, H: int, q, is_p: bool, is_luma: bool,
                shard, repl, rep_lvl: int):
    """dsv_inv_sbt's level loop (sbt.c:653-714), column-sharded."""
    return sbt.inv_sbt(jnp.asarray(a, jnp.int32), q, is_p, is_luma,
                       constrain=_mk_constrain(shard, repl, rep_lvl))


@lru_cache(maxsize=32)
def _jit_fwd(H: int, W: int, is_p: bool, mesh_key: int, axis: str):
    s = _sharding(mesh_key, axis)
    r = _sharding(mesh_key, axis, col=False)
    rl = _replicate_level(W, H, sbt.nlevels(W, H),
                          _MESHES[mesh_key].devices.size)

    def f(coefs):
        return _fwd_levels(jnp.asarray(coefs, jnp.int32), W, H, is_p,
                           s, r, rl)

    return jax.jit(f, in_shardings=s, out_shardings=s)


@lru_cache(maxsize=32)
def _jit_inv(H: int, W: int, is_p: bool, is_luma: bool, mesh_key: int,
             axis: str):
    s = _sharding(mesh_key, axis)
    r = _sharding(mesh_key, axis, col=False)
    rl = _replicate_level(W, H, sbt.nlevels(W, H),
                          _MESHES[mesh_key].devices.size)

    def f(coefs, q):
        return _inv_levels(jnp.asarray(coefs, jnp.int32), W, H, q, is_p,
                           is_luma, s, r, rl)

    return jax.jit(f, in_shardings=(s, r), out_shardings=s)


@lru_cache(maxsize=32)
def _jit_plane(H: int, W: int, is_p: bool, plane_idx: int, nbh: int,
               nbv: int, mesh_key: int, axis: str):
    tables = hzcc.build_tables(W, H, nbh, nbv)
    s = _sharding(mesh_key, axis)
    r = _sharding(mesh_key, axis, col=False)
    rl = _replicate_level(W, H, sbt.nlevels(W, H),
                          _MESHES[mesh_key].devices.size)

    def f(coefs, q, stable_blocks):
        a = _fwd_levels(jnp.asarray(coefs, jnp.int32), W, H, is_p, s, r, rl)
        qv, wb = hzcc.encode_plane_core(a, q, is_p, plane_idx,
                                        stable_blocks, tables)
        rec = _inv_levels(wb, W, H, q, is_p, is_luma=(plane_idx == 0),
                          shard=s, repl=r, rep_lvl=rl)
        return qv, a[0, 0], rec

    return jax.jit(f, in_shardings=(s, r, r),
                   out_shardings=(r, r, s))


def _key(mesh: Mesh, axis: str) -> int:
    k = id(mesh)
    _MESHES[k] = mesh
    return k


def fwd_sbt_tiled(coefs, is_p: bool, mesh: Mesh, axis: str = "tile"):
    """dsv_fwd_sbt over a column-sharded frame (bit-exact vs ops.sbt)."""
    H, W = coefs.shape
    return _jit_fwd(H, W, bool(is_p), _key(mesh, axis), axis)(coefs)


def inv_sbt_tiled(coefs, q, is_p: bool, is_luma: bool, mesh: Mesh,
                  axis: str = "tile"):
    """dsv_inv_sbt over a column-sharded frame (bit-exact vs ops.sbt)."""
    H, W = coefs.shape
    return _jit_inv(H, W, bool(is_p), bool(is_luma),
                    _key(mesh, axis), axis)(coefs, jnp.int32(q))


def encode_plane_tiled(coefs, q, is_p: bool, plane_idx: int, stable_blocks,
                       nbh: int, nbv: int, mesh: Mesh, axis: str = "tile"):
    """Tiled per-plane encode core: forward SBT + adaptive quantization
    with in-loop write-back + (filtered) inverse SBT, the contents of
    encode_picture's plane loop (dsv_encoder.c:505-526). Returns
    (traversal-ordered quantized values, raw DC, recon coefs); the
    quantized stream and DC are replicated outputs (they feed the serial
    entropy packer), the recon stays column-sharded for the next frame.
    """
    H, W = coefs.shape
    fn = _jit_plane(H, W, bool(is_p), int(plane_idx), int(nbh), int(nbv),
                    _key(mesh, axis), axis)
    return fn(coefs, jnp.int32(q), jnp.asarray(stable_blocks))
