"""Subband-tile sharding (parallel/tile.py): bit-exactness of the
column-sharded transforms + plane core vs the single-device kernels, with
inputs actually laid out across the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from dsv1_tpu.ops import hzcc, sbt
from dsv1_tpu.parallel.tile import (encode_plane_tiled, fwd_sbt_tiled,
                                    inv_sbt_tiled, tile_mesh)


def _rand_coefs(h, w, seed, lo=-160, hi=160):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (h, w)).astype(np.int32)


def _shard(a, mesh):
    return jax.device_put(a, NamedSharding(mesh, P(None, "tile")))


@pytest.mark.parametrize("w,h", [(256, 192), (352, 288), (1920, 1080)])
@pytest.mark.parametrize("is_p", [False, True])
def test_fwd_sbt_tiled_bit_exact(w, h, is_p):
    mesh = tile_mesh()
    a = _rand_coefs(h, w, seed=w + is_p)
    ref = np.asarray(jax.jit(lambda x: sbt.fwd_sbt(x, is_p))(a))
    out = fwd_sbt_tiled(_shard(a, mesh), is_p, mesh)
    # the output really is distributed over the tile axis
    assert len(out.sharding.device_set) == len(mesh.devices)
    np.testing.assert_array_equal(np.asarray(out), ref)


@pytest.mark.parametrize("w,h", [(256, 192), (1920, 1080)])
@pytest.mark.parametrize("is_p", [False, True])
@pytest.mark.parametrize("quant", [137, 1024])
def test_inv_sbt_tiled_bit_exact(w, h, is_p, quant):
    mesh = tile_mesh()
    a = _rand_coefs(h, w, seed=3 * w + is_p + quant)
    ref = np.asarray(jax.jit(
        lambda x: sbt.inv_sbt(x, jnp.int32(quant), is_p, True))(a))
    out = inv_sbt_tiled(_shard(a, mesh), quant, is_p, True, mesh)
    np.testing.assert_array_equal(np.asarray(out), ref)


@pytest.mark.parametrize("is_p", [False, True])
def test_encode_plane_tiled_matches_core(is_p):
    w, h, nbh, nbv = 352, 288, 22, 18
    mesh = tile_mesh()
    tables = hzcc.build_tables(w, h, nbh, nbv)
    a = _rand_coefs(h, w, seed=9 + is_p, lo=-128, hi=128)
    rng = np.random.default_rng(5)
    stable = rng.integers(0, 4, nbh * nbv).astype(np.uint8)
    q = 512

    def ref_fn(x, qq, st):
        aa = sbt.fwd_sbt(x, is_p)
        qv, wb = hzcc.encode_plane_core(aa, qq, is_p, 0, st, tables)
        rec = sbt.inv_sbt(wb, qq, is_p, is_luma=True)
        return qv, aa[0, 0], rec

    qv_r, dc_r, rec_r = jax.jit(ref_fn)(a, jnp.int32(q), stable)
    qv_t, dc_t, rec_t = encode_plane_tiled(_shard(a, mesh), q, is_p, 0,
                                           stable, nbh, nbv, mesh)
    np.testing.assert_array_equal(np.asarray(qv_t), np.asarray(qv_r))
    assert int(dc_t) == int(dc_r)
    np.testing.assert_array_equal(np.asarray(rec_t), np.asarray(rec_r))


# ---------------------------------------------------------------- 2-D mesh
def _clip(w, h, n, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 200, (h, w), dtype=np.uint8)
    frames = []
    for i in range(n):
        y = np.clip(np.roll(base, 2 * i, axis=1).astype(np.int32)
                    + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.uint8)
        u = rng.integers(100, 140, (h // 2, w // 2), dtype=np.uint8)
        v = rng.integers(100, 140, (h // 2, w // 2), dtype=np.uint8)
        frames.append((y, u, v))
    return frames


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_gop_tile_mesh_encode_byte_identical(shape):
    """Full GOP-parallel encode over a 2-D (gop × tile) mesh: frames
    column-sharded inside the subband transforms (SPMD halo exchanges),
    GOPs data-parallel — byte-identical to the single-device stream."""
    from dsv1_tpu.constants import RATE_CONTROL_CRF, SUBSAMP_420, \
        quality_percent
    from dsv1_tpu.models.encoder import EncoderConfig
    from dsv1_tpu.models.metadata import Metadata
    from dsv1_tpu.parallel import encode_stream_gops, gop_tile_mesh

    w, h, G = 352, 288, 3
    frames = _clip(w, h, 2 * G)
    meta = Metadata(w, h, SUBSAMP_420)
    cfg = EncoderConfig(quality=quality_percent(85), gop=G,
                        rc_mode=RATE_CONTROL_CRF, stable_refresh=G - 1)
    mesh = gop_tile_mesh(*shape)
    tiled = encode_stream_gops(frames, meta, cfg, mesh=mesh)
    single = encode_stream_gops(frames, meta, cfg)
    assert tiled == single


@pytest.mark.skipif(not __import__("os").environ.get("DSV1_SLOW_TESTS"),
                    reason="~7 min on CPU; set DSV1_SLOW_TESTS=1")
def test_gop_tile_mesh_1080p_byte_identical():
    """1080p tiled encode byte-identity (the tile axis at its real
    operating point; run explicitly, too slow for the
    default CPU suite)."""
    from dsv1_tpu.constants import RATE_CONTROL_CRF, SUBSAMP_420, \
        quality_percent
    from dsv1_tpu.models.encoder import EncoderConfig
    from dsv1_tpu.models.metadata import Metadata
    from dsv1_tpu.parallel import encode_stream_gops, gop_tile_mesh

    w, h, G = 1920, 1080, 2
    frames = _clip(w, h, G, seed=17)
    meta = Metadata(w, h, SUBSAMP_420)
    cfg = EncoderConfig(quality=quality_percent(85), gop=G,
                        rc_mode=RATE_CONTROL_CRF, stable_refresh=G - 1)
    mesh = gop_tile_mesh(1, 8)
    tiled = encode_stream_gops(frames, meta, cfg, mesh=mesh)
    single = encode_stream_gops(frames, meta, cfg)
    assert tiled == single


def test_gop_tile_mesh_720p_byte_identical():
    """Large-frame (1280x720, the tile axis's target regime) single-GOP
    encode on a (1 gop × 8 tile) mesh == single-device bytes."""
    from dsv1_tpu.constants import RATE_CONTROL_CRF, SUBSAMP_420, \
        quality_percent
    from dsv1_tpu.models.encoder import EncoderConfig
    from dsv1_tpu.models.metadata import Metadata
    from dsv1_tpu.parallel import encode_stream_gops, gop_tile_mesh

    w, h, G = 1280, 720, 2
    frames = _clip(w, h, G, seed=13)
    meta = Metadata(w, h, SUBSAMP_420)
    cfg = EncoderConfig(quality=quality_percent(85), gop=G,
                        rc_mode=RATE_CONTROL_CRF, stable_refresh=G - 1)
    mesh = gop_tile_mesh(1, 8)
    tiled = encode_stream_gops(frames, meta, cfg, mesh=mesh)
    single = encode_stream_gops(frames, meta, cfg)
    assert tiled == single


@pytest.mark.skipif(not __import__("os").environ.get("DSV1_SLOW_TESTS"),
                    reason="4K on CPU; set DSV1_SLOW_TESTS=1")
def test_gop_mesh_4k_byte_identical():
    """4K GOP-sharded encode byte-identity (BASELINE config 5's
    resolution on the virtual mesh; the real-hardware 4K byte-identity
    vs the reference binary runs in bench.py). Two 2-frame GOPs so the
    CPU path stays minutes-fast."""
    import numpy as np

    from dsv1_tpu.constants import RATE_CONTROL_CRF, SUBSAMP_420, \
        quality_percent
    from dsv1_tpu.models.encoder import EncoderConfig
    from dsv1_tpu.models.metadata import Metadata
    from dsv1_tpu.parallel import encode_stream_gops, gop_mesh
    import jax

    w, h, G = 3840, 2160, 2
    rng = np.random.default_rng(5)
    base = rng.integers(0, 200, (h, w), dtype=np.uint8)
    frames = []
    for i in range(2 * G):
        y = np.clip(np.roll(base, 3 * i, axis=1).astype(np.int32)
                    + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.uint8)
        frames.append((y, np.full((h // 2, w // 2), 120, np.uint8),
                       np.full((h // 2, w // 2), 133, np.uint8)))
    meta = Metadata(w, h, SUBSAMP_420)
    cfg = EncoderConfig(quality=quality_percent(85), gop=G,
                        rc_mode=RATE_CONTROL_CRF, stable_refresh=G - 1)
    mesh = gop_mesh(jax.devices()[:2])
    sharded = encode_stream_gops(frames, meta, cfg, mesh=mesh)
    single = encode_stream_gops(frames, meta, cfg)
    assert sharded == single
