"""Quality benchmark at the reference's headline operating point:
CIF-class clip, ABR at a fixed bitrate (reference README.md:25-33 uses
CIF @30fps gop12 qp85 ABR 1100 kbps). Compares PSNR and stream size of

  - the reference C encoder (cc -O3),
  - ours at parity settings (byte-identical by construction, asserted),
  - ours with -effort (beyond-reference motion search, spec-valid).

All streams are decoded with the *reference* binary, so PSNR is measured
through the normative decoder. Prints one JSON line per row.

Usage: python tools/quality_bench.py [frames] [width height] [corpus]
(defaults 96 frames at 176x144 — QCIF keeps a CPU run tractable;
pass `288 352 288 rich` on a GPU for the full headline point on
the realistic-motion corpus: global pan + crossing occluders + static
textured strip, tests/corpus.py make_rich_clip)
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    nf = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    w, h = ((int(sys.argv[2]), int(sys.argv[3])) if len(sys.argv) > 3
            else (176, 144))
    from tests import corpus, oracle
    from dsv1_tpu.constants import (RATE_CONTROL_ABR, SUBSAMP_420,
                                    quality_percent)
    from dsv1_tpu.models.encoder import Encoder, EncoderConfig
    from dsv1_tpu.models.metadata import Metadata
    from dsv1_tpu.ops.frame import np_yuv_split
    from dsv1_tpu.utils.yuv import frame_size

    G, kbps = 12, 1100
    rich = len(sys.argv) > 4 and sys.argv[4] == "rich"
    mk = corpus.make_rich_clip if rich else corpus.make_clip
    yuv = mk(w, h, SUBSAMP_420, nf, seed=11)
    fsz = frame_size(w, h, SUBSAMP_420)
    frames = [np_yuv_split(np.frombuffer(yuv[i * fsz:(i + 1) * fsz],
                                         np.uint8), SUBSAMP_420, w, h)
              for i in range(nf)]
    meta = Metadata(w, h, SUBSAMP_420)
    src = np.frombuffer(yuv, np.uint8).astype(np.float64)
    tmp = Path("/tmp/dsv1_qbench")
    tmp.mkdir(exist_ok=True)

    def psnr(dec: bytes) -> float:
        d = np.frombuffer(dec, np.uint8).astype(np.float64)
        return 10 * np.log10(255.0 ** 2 / np.mean((d - src) ** 2))

    def report(name, stream):
        dec = corpus.ref_decode(stream, tmp)
        bps = len(stream) * 8 * 30 // nf
        print(json.dumps({
            "config": name, "bytes": len(stream),
            "kbps_at_30fps": round(bps / 1000, 1),
            "psnr_db": round(psnr(dec), 3)}), flush=True)
        return len(stream)

    # reference encoder, ABR 1100 kbps (CLI rc_mode0 = ABR)
    oracle.build_oracle()
    ref = corpus.ref_encode(yuv, w, h, SUBSAMP_420, nf, tmp, gop=G, qp=85,
                            rc_mode=0, kbps=kbps, stabref=G - 1)
    report("reference_abr1100", ref)

    # ours: same ABR pairing (CLI maps qp*3/2 pre-boost, dsv_main.c:476-478)
    q = min(quality_percent(85) * 3 // 2, 2047)
    for eff in (0, 2):
        # CLI-default pairing (dsv_main.c:127-133): maxqp 100% (the
        # library default is 95%)
        cfg = EncoderConfig(quality=q, gop=G, rc_mode=RATE_CONTROL_ABR,
                            bitrate=kbps * 1024, stable_refresh=G - 1,
                            max_quality=quality_percent(100), effort=eff)
        enc = Encoder(meta, cfg)
        enc.start()
        t0 = time.perf_counter()
        stream = enc.encode_stream(frames)
        dt = time.perf_counter() - t0
        report(f"ours_abr1100_effort{eff}", stream)
        print(f"# encode {nf / dt:.1f} fps", flush=True)
        if eff == 0:
            assert stream == ref, "parity ABR stream must be byte-identical"

    # GOP-parallel ABR (secant rate model, GOPs encode in parallel)
    from dsv1_tpu.parallel import encode_stream_gops
    cfg = EncoderConfig(quality=q, gop=G, rc_mode=RATE_CONTROL_ABR,
                        bitrate=kbps * 1024, stable_refresh=G - 1,
                        max_quality=quality_percent(100))
    t0 = time.perf_counter()
    stream = encode_stream_gops(frames, meta, cfg)
    dt = time.perf_counter() - t0
    report("ours_abr1100_gopar", stream)
    print(f"# encode {nf / dt:.1f} fps", flush=True)


if __name__ == "__main__":
    main()
