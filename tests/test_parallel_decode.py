"""GOP-parallel decode: must be bit-exact against the reference decoder
for reference-encoded streams, and match the sequential decoder."""

import jax
import numpy as np
import pytest

from dsv1_tpu.constants import SUBSAMP_420, SUBSAMP_422
from dsv1_tpu.models.decoder import Decoder
from dsv1_tpu.parallel import decode_stream_gops
from dsv1_tpu.parallel.gop import gop_mesh
from dsv1_tpu.utils.yuv import frame_size

from . import corpus


def _planar(planes):
    return b"".join(np.asarray(p).tobytes() for p in planes)


@pytest.mark.parametrize("subsamp,gop", [(SUBSAMP_420, 4), (SUBSAMP_422, 0)])
def test_parallel_decode_bit_exact(tmp_path, subsamp, gop):
    w, h, nframes = 96, 80, 9
    yuv = corpus.make_clip(w, h, subsamp, nframes, seed=21)
    stream = corpus.ref_encode(yuv, w, h, subsamp, nframes, tmp_path,
                               gop=gop, qp=70)
    golden = corpus.ref_decode(stream, tmp_path)
    meta, frames = decode_stream_gops(stream)
    assert len(frames) == nframes
    out = b"".join(_planar(planes)
                   for _, planes in sorted(frames, key=lambda t: t[0]))
    assert out == golden


def test_parallel_decode_matches_sequential(tmp_path):
    w, h, subsamp, nframes = 96, 80, SUBSAMP_420, 10
    yuv = corpus.make_clip(w, h, subsamp, nframes, seed=22)
    stream = corpus.ref_encode(yuv, w, h, subsamp, nframes, tmp_path,
                               gop=5, qp=80)
    seq = Decoder()
    seq_out = [(fno, _planar(p)) for fno, p in seq.decode_stream(stream)]
    _, frames = decode_stream_gops(stream)
    par_out = [(fno, _planar(p)) for fno, p in frames]
    assert par_out == seq_out


def test_parallel_decode_sharded(tmp_path):
    w, h, subsamp, nframes = 96, 80, SUBSAMP_420, 12
    yuv = corpus.make_clip(w, h, subsamp, nframes, seed=23)
    stream = corpus.ref_encode(yuv, w, h, subsamp, nframes, tmp_path,
                               gop=3, qp=75)
    golden = corpus.ref_decode(stream, tmp_path)
    mesh = gop_mesh(jax.devices())
    _, frames = decode_stream_gops(stream, mesh=mesh)
    out = b"".join(_planar(p)
                   for _, p in sorted(frames, key=lambda t: t[0]))
    assert out == golden


def test_parallel_decode_symbols_beyond_int16():
    """Coarse LL values above 32767 (quality 100 here; 1080p streams at
    qp 85 too) stay on the batched device path and decode exactly like
    the sequential decoder."""
    from dsv1_tpu.constants import RATE_CONTROL_CRF, quality_percent
    from dsv1_tpu.models.encoder import EncoderConfig
    from dsv1_tpu.models.metadata import Metadata
    from dsv1_tpu.parallel import decode as pdec
    from dsv1_tpu.parallel import encode_stream_gops
    from dsv1_tpu.utils import parity

    w, h = 256, 192
    frames = corpus.make_clip_frames(w, h, SUBSAMP_420, 4, seed=5)
    cfg = EncoderConfig(quality=quality_percent(100), gop=2,
                        rc_mode=RATE_CONTROL_CRF, stable_refresh=1)
    stream = encode_stream_gops(frames, Metadata(w, h, SUBSAMP_420), cfg)
    before = dict(pdec.EVENTS)
    _, got = decode_stream_gops(stream)
    assert pdec.EVENTS["batched"] == before.get("batched", 0) + 1
    assert pdec.EVENTS["sequential_fallback"] == \
        before.get("sequential_fallback", 0)
    assert parity.same_decode(got, parity.reference_decode(stream))
