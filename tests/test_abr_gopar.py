"""GOP-parallel ABR: rate feedback at GOP granularity (parallel/gop.py
_AbrState). Streams are spec-valid and must land near the bitrate
target; bytes legitimately differ from the sequential per-frame ABR
(which remains the reference-exact path, tested in test_cli)."""

import numpy as np

from dsv1_tpu.constants import (RATE_CONTROL_ABR, SUBSAMP_420,
                                quality_percent)
from dsv1_tpu.models.encoder import Encoder, EncoderConfig
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.ops.frame import np_yuv_split
from dsv1_tpu.parallel import encode_stream_gops
from dsv1_tpu.utils.yuv import frame_size

from . import corpus

W, H, G, NF = 96, 80, 4, 24


def _setup():
    yuv = corpus.make_clip(W, H, SUBSAMP_420, NF, seed=13)
    fsz = frame_size(W, H, SUBSAMP_420)
    frames = [np_yuv_split(np.frombuffer(yuv[i * fsz:(i + 1) * fsz],
                                         np.uint8), SUBSAMP_420, W, H)
              for i in range(NF)]
    return yuv, frames, Metadata(W, H, SUBSAMP_420)


def _cfg(kbps):
    return EncoderConfig(quality=min(quality_percent(85) * 3 // 2, 2047),
                         gop=G, rc_mode=RATE_CONTROL_ABR,
                         bitrate=kbps * 1024, stable_refresh=G - 1,
                         max_quality=quality_percent(100))


def test_gopar_abr_reference_decodable_and_on_target(tmp_path):
    yuv, frames, meta = _setup()
    kbps = 300
    stream = encode_stream_gops(frames, meta, _cfg(kbps), abr_mode="gop")
    dec = corpus.ref_decode(stream, tmp_path)
    assert len(dec) == len(yuv)
    # achieved rate lands in a sane band around the target (short clip,
    # GOP-granular feedback: allow a generous window)
    achieved = len(stream) * 8 * 30 / NF  # bits/s at 30fps
    assert achieved < kbps * 1024 * 1.6
    assert achieved > kbps * 1024 * 0.3


def test_gopar_abr_quality_near_sequential(tmp_path):
    """The GOP-granular controller should not give up meaningful quality
    vs the per-frame reference law at the same target."""
    yuv, frames, meta = _setup()
    src = np.frombuffer(yuv, np.uint8).astype(np.float64)

    def psnr(stream):
        d = np.frombuffer(corpus.ref_decode(stream, tmp_path),
                          np.uint8).astype(np.float64)
        return 10 * np.log10(255.0 ** 2 / np.mean((d - src) ** 2))

    cfg = _cfg(300)
    enc = Encoder(meta, cfg)
    enc.start()
    p_seq = psnr(enc.encode_stream(frames))
    p_par = psnr(encode_stream_gops(frames, meta, _cfg(300),
                                    abr_mode="gop"))
    assert p_par > p_seq - 2.0


@__import__("pytest").mark.skipif(
    not __import__("os").environ.get("DSV1_SLOW_TESTS"),
    reason="300-frame clip (~minutes on CPU); set DSV1_SLOW_TESTS=1")
def test_gopar_abr_long_clip_rate_and_quality_bounds(tmp_path):
    """Quantitative bounds over a long clip: the
    GOP-granular controller must land within +/-10% of the nominal
    bitrate and within 0.3 dB of the per-frame reference ABR law's PSNR
    at the same target. 300 frames at 128x96 keeps CPU time bounded;
    the rate law is geometry-independent (bytes-per-frame feedback,
    dsv_encoder.c:70-168,816-848)."""
    w, h, nf, gop, kbps = 128, 96, 300, 12, 400
    yuv = corpus.make_rich_clip(w, h, SUBSAMP_420, nf, seed=17)
    fsz = frame_size(w, h, SUBSAMP_420)
    frames = [np_yuv_split(np.frombuffer(yuv[i * fsz:(i + 1) * fsz],
                                         np.uint8), SUBSAMP_420, w, h)
              for i in range(nf)]
    meta = Metadata(w, h, SUBSAMP_420)

    def cfg():
        return EncoderConfig(
            quality=min(quality_percent(85) * 3 // 2, 2047), gop=gop,
            rc_mode=RATE_CONTROL_ABR, bitrate=kbps * 1024,
            stable_refresh=gop - 1, max_quality=quality_percent(100))

    src = np.frombuffer(yuv, np.uint8).astype(np.float64)

    def psnr(stream):
        d = np.frombuffer(corpus.ref_decode(stream, tmp_path),
                          np.uint8).astype(np.float64)
        return 10 * np.log10(255.0 ** 2 / np.mean((d - src) ** 2))

    gopar = encode_stream_gops(frames, meta, cfg(), abr_mode="gop")
    achieved = len(gopar) * 8 * 30 / nf
    # the reference law itself aims at 7/8 of nominal with over-target
    # hysteresis (dsv_encoder.c:816-848): measure both against nominal
    assert abs(achieved - kbps * 1024) <= kbps * 1024 * 0.10, (
        f"gopabr rate {achieved/1024:.0f} kbps vs nominal {kbps}")

    enc = Encoder(meta, cfg())
    enc.start()
    seq = enc.encode_stream(frames)
    assert psnr(gopar) >= psnr(seq) - 0.3
