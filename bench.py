"""Benchmark: encode and decode frames/s at the reference's headline
operating point (gop 12, qp 85 CRF — reference README.md:25-33) on one
GPU.

Emits one JSON line per metric:

  encode_fps_1080p_gop12_qp85         e2e 1080p encode (frames in -> .dsv)
  device_fps_1080p_gop12_qp85         1080p encode chunk executable alone
  decode_fps_1080p_gop12_qp85         e2e 1080p decode (.dsv -> frames)
  device_decode_fps_1080p_gop12_qp85  1080p decode chunk executable alone
  device_fps_4k_gop12_qp85            4K encode chunk executable alone
  decode_fps_cif_gop12_qp85           e2e CIF decode
  device_decode_fps_cif_gop12_qp85    CIF decode chunk executable alone
  device_fps_cif_gop12_qp85           CIF encode chunk executable alone
  encode_fps_cif_gop12_qp85           e2e CIF encode (last line)

Every line names the device (platform, device_kind, count). The e2e
points carry "parity": the first GOP's stream byte-compared, and its
decode pixel-compared, with the sequential codec on the CPU
(dsv1_tpu/utils/parity.py). Device-only points run the shipped chunk
executable on device-resident input, each call ending in
block_until_ready. The benchmark needs a GPU and fails without one.
"""

import json
import sys
import time

import numpy as np

G = 12
SEED = 11
REF_FRAMES = G  # frames compared with the CPU reference per cell


def _device():
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        raise SystemExit(2)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _mk_point(w, h, n_frames, label):
    """Corpus + config for one operating point."""
    from tests import corpus
    from dsv1_tpu.constants import (RATE_CONTROL_CRF, SUBSAMP_420,
                                    quality_percent)
    from dsv1_tpu.models.encoder import EncoderConfig
    from dsv1_tpu.models.metadata import Metadata
    from dsv1_tpu.ops.frame import np_yuv_split
    from dsv1_tpu.utils.yuv import frame_size

    yuv = corpus.make_clip(w, h, SUBSAMP_420, n_frames, seed=SEED)
    fsz = frame_size(w, h, SUBSAMP_420)
    frames = [np_yuv_split(np.frombuffer(yuv[i * fsz:(i + 1) * fsz],
                                         np.uint8), SUBSAMP_420, w, h)
              for i in range(n_frames)]
    meta = Metadata(w, h, SUBSAMP_420)
    cfg = EncoderConfig(quality=quality_percent(85), gop=G,
                        rc_mode=RATE_CONTROL_CRF, stable_refresh=G - 1)
    return {"w": w, "h": h, "n": n_frames, "frames": frames, "meta": meta,
            "cfg": cfg, "label": label}


def _parity(pt):
    """First GOP: device stream == CPU sequential stream, and device
    decode == CPU sequential decode."""
    from dsv1_tpu.parallel import decode_stream_gops, encode_stream_gops
    from dsv1_tpu.utils import parity

    frames = pt["frames"][:REF_FRAMES]
    stream = encode_stream_gops(frames, pt["meta"], pt["cfg"])
    if stream != parity.reference_encode(frames, pt["meta"], pt["cfg"]):
        return False
    _, dec = decode_stream_gops(stream)
    return parity.same_decode(dec, parity.reference_decode(stream))


def _fps(fn, n_frames, reps):
    """Frames/s over `reps` calls of fn (each ending on the host or in
    block_until_ready), after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return n_frames * reps / (time.perf_counter() - t0)


def chunk_executable(pt, dense=False):
    """(jitted chunk fn, device-resident args, frames per call): the
    CRF chunk executable the e2e encode path dispatches or, with dense,
    the variant it re-runs a chunk with when a compaction cap
    overflows."""
    import jax
    from dsv1_tpu.ops.frame import np_pack_planes
    from dsv1_tpu.parallel.gop import (_jit_batched, block_geometry,
                                       crf_quant)

    cfg, meta = pt["cfg"], pt["meta"]
    w, h = pt["w"], pt["h"]
    _, _, nbh, nbv = block_geometry(w, h)
    fn, _unpack = _jit_batched(meta.subsamp, w, h, G, cfg.quality,
                               cfg.do_scd, cfg.scene_change_delta,
                               cfg.intra_pct_thresh, cfg.stable_refresh,
                               cfg.pyramid_levels, None,
                               **({"compact": 0} if dense else {}),
                               effort=cfg.effort)
    chunk = max(1, min(4, (4 * 352 * 288 * 12) // max(G * w * h, 1)))
    packed = np.stack([np_pack_planes(pt["frames"][i % pt["n"]])
                       for i in range(chunk * G)]).reshape(chunk, G, -1)
    args = tuple(jax.device_put(a) for a in (
        packed, np.zeros(chunk, np.int32),
        np.zeros((chunk, nbh * nbv, 2), np.int32),
        np.zeros(chunk, np.int32),
        np.full((chunk, 2), crf_quant(cfg.quality), np.int32)))
    return fn, args, chunk * G


def _device_only_fps(pt, reps=4):
    """Encode frames/s of the chunk executable the e2e path dispatches,
    on device-resident input, without host packing."""
    fn, args, frames = chunk_executable(pt)
    return _fps(lambda: fn(*args).block_until_ready(), frames, reps)


def _device_decode_fps(stream, reps=4):
    """Decode frames/s of the shipped chunk executable on
    device-resident input."""
    import jax
    from dsv1_tpu.parallel.decode import bench_device_chunk

    fn, blob_np, nf = bench_device_chunk(stream)
    blob = jax.device_put(blob_np)
    return _fps(lambda: fn(blob).block_until_ready(), nf, reps)


def main():
    device = _device()
    from dsv1_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from dsv1_tpu.parallel import decode_stream_gops, encode_stream_gops

    def metric(name, fps, parity=None):
        m = {"metric": name, "value": fps, "unit": "frames/s",
             "device": device}
        if parity is not None:
            m["parity"] = bool(parity)
        print(json.dumps(m), flush=True)

    def e2e_encode(pt, reps):
        out = {}

        def run():
            out["s"] = encode_stream_gops(pt["frames"], pt["meta"],
                                          pt["cfg"])
        return _fps(run, pt["n"], reps), out["s"]

    def e2e_decode(stream, n, reps):
        return _fps(lambda: decode_stream_gops(stream), n, reps)

    cif = _mk_point(352, 288, 288, "cif")
    hd = _mk_point(1920, 1080, 48, "1080p")
    efps_hd, stream_hd = e2e_encode(hd, 2)
    par_hd = _parity(hd)
    metric("encode_fps_1080p_gop12_qp85", efps_hd, par_hd)
    metric("device_fps_1080p_gop12_qp85", _device_only_fps(hd))
    metric("decode_fps_1080p_gop12_qp85",
           e2e_decode(stream_hd, hd["n"], 2), par_hd)
    metric("device_decode_fps_1080p_gop12_qp85",
           _device_decode_fps(stream_hd))
    del hd, stream_hd

    uhd = _mk_point(3840, 2160, 12, "4k")
    metric("device_fps_4k_gop12_qp85", _device_only_fps(uhd))
    del uhd

    efps_cif, stream_cif = e2e_encode(cif, 3)
    par_cif = _parity(cif)
    metric("decode_fps_cif_gop12_qp85",
           e2e_decode(stream_cif, cif["n"], 3), par_cif)
    metric("device_decode_fps_cif_gop12_qp85",
           _device_decode_fps(stream_cif))
    metric("device_fps_cif_gop12_qp85", _device_only_fps(cif))
    metric("encode_fps_cif_gop12_qp85", efps_cif, par_cif)


if __name__ == "__main__":
    main()
