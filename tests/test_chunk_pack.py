"""Native whole-chunk packet assembly (bits.pack_chunk): the GOP-parallel
and intra-only fast paths must stay byte-identical to the sequential
encoder across chunk-edge cases — tail GOPs, G=1, gop0, and the dense
fallback when the sparse compaction caps overflow."""

import numpy as np
import pytest

from dsv1_tpu.constants import (GOP_INTRA, RATE_CONTROL_CRF, SUBSAMP_420,
                                quality_percent)
from dsv1_tpu.models.encoder import Encoder, EncoderConfig
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.ops.frame import np_yuv_split
from dsv1_tpu.parallel import encode_stream_gops
from dsv1_tpu.utils.yuv import frame_size

from . import corpus

W, H, SUB = 96, 64, SUBSAMP_420


def _frames(n, seed=3):
    yuv = corpus.make_clip(W, H, SUB, n, seed=seed)
    fsz = frame_size(W, H, SUB)
    return [np_yuv_split(np.frombuffer(yuv[i * fsz:(i + 1) * fsz], np.uint8),
                         SUB, W, H) for i in range(n)]


def _seq(frames, cfg):
    enc = Encoder(Metadata(W, H, SUB), cfg)
    enc.start()
    return enc.encode_stream(frames)


@pytest.mark.parametrize("gop,n", [(4, 13), (1, 5), (4, 4)])
def test_chunk_pack_matches_sequential(gop, n):
    frames = _frames(n)
    cfg = EncoderConfig(quality=quality_percent(85), gop=gop,
                        rc_mode=RATE_CONTROL_CRF,
                        stable_refresh=max(1, gop - 1))
    assert _seq(frames, cfg) == \
        encode_stream_gops(frames, Metadata(W, H, SUB), cfg)


def test_chunk_pack_gop0_matches_sequential():
    frames = _frames(7, seed=5)
    cfg = EncoderConfig(quality=quality_percent(85), gop=GOP_INTRA,
                        rc_mode=RATE_CONTROL_CRF)
    assert _seq(frames, cfg) == \
        encode_stream_gops(frames, Metadata(W, H, SUB), cfg)


def test_dense_fallback_on_compaction_overflow():
    """A mid-GOP scene cut forces an intra frame whose planes are dense;
    its nonzero count blows the sparse P cap, which must trigger the
    dense re-run path (parallel/gop.py) and still match the sequential
    encoder byte for byte."""
    rng = np.random.default_rng(11)
    flat = [(np.full((H, W), 60, np.uint8),
             np.full((H // 2, W // 2), 128, np.uint8),
             np.full((H // 2, W // 2), 128, np.uint8)) for _ in range(2)]
    noisy = [(rng.integers(0, 256, (H, W), dtype=np.uint8),
              rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8),
              rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8))
             for _ in range(2)]
    frames = flat + noisy  # cut at frame 2, inside the single gop-4 GOP
    cfg = EncoderConfig(quality=quality_percent(95), gop=4,
                        rc_mode=RATE_CONTROL_CRF, stable_refresh=3)
    from dsv1_tpu.parallel import gop
    redos = gop.EVENTS["dense_redo"]
    assert _seq(frames, cfg) == \
        encode_stream_gops(frames, Metadata(W, H, SUB), cfg)
    assert gop.EVENTS["dense_redo"] > redos


@pytest.mark.parametrize("gop,n", [(4, 13), (GOP_INTRA, 7)])
def test_streaming_iterator_matches_list(gop, n):
    """encode_stream_gops streams from any iterable with constant
    memory; a generator input must produce the identical stream."""
    frames = _frames(n, seed=6)
    cfg = EncoderConfig(quality=quality_percent(85), gop=gop,
                        rc_mode=RATE_CONTROL_CRF,
                        stable_refresh=max(1, gop - 1))
    meta = Metadata(W, H, SUB)
    from_list = encode_stream_gops(frames, meta, cfg)
    from_gen = encode_stream_gops((f for f in frames), meta, cfg)
    assert from_gen == from_list
