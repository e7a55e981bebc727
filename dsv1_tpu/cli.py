"""dsv1-tpu command-line driver.

Same interface as the reference CLI (dsv_main.c:94-150): `e|d` mode with
-prefixvalue options, declarative parameter tables with min/max/converter,
and the reference's CLI-level behaviors: ABR default rate control with the
0=ABR/1=CRF mapping (dsv_main.c:58-68), auto bitrate estimation, the 3/2 ABR
quality pre-boost (dsv_main.c:476-478), and stabref auto = clamp(gop-1,1,14).
"""

import sys
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from . import constants as C
from .models.decoder import DEC_EOS, DEC_GOT_META, DEC_OK, Decoder
from .utils import log
from .models.encoder import Encoder, EncoderConfig
from .models.metadata import Metadata
from .utils.bitrate import estimate_bitrate
from .utils.chroma import conv422to420, conv444to422
from .utils.yuv import read_frame, write_frame

HEADER = "DSV1 codec (JAX, reference-compatible)\n"

AUTO_BITRATE = 0
INP_FMTS = {0: C.SUBSAMP_444, 1: C.SUBSAMP_422, 2: C.SUBSAMP_420,
            3: C.SUBSAMP_411}


def pct_to_qual(v):
    return C.MAX_QUALITY * v // 100


@dataclass
class Param:
    prefix: str
    value: int
    vmin: int
    vmax: int
    convert: Optional[Callable[[int], int]]
    desc: str


def enc_params():
    M = 2**31 - 1
    return [
        Param("qp", pct_to_qual(85), 0, 100, pct_to_qual,
              "quality percent. 85 = default"),
        Param("w", 352, 16, 1 << 24, None, "width of input video"),
        Param("h", 288, 16, 1 << 24, None, "height of input video"),
        Param("gop", 12, 0, M, None,
              "Group Of Pictures length. 0 = intra only, 12 = default"),
        Param("fmt", C.SUBSAMP_420, 0, 3, lambda v: INP_FMTS.get(v, C.SUBSAMP_420),
              "chroma subsampling: 0=444 1=422 2=420 3=411. 2 = default"),
        Param("nfr", -1, -1, M, None, "number of frames (-1 = all)"),
        Param("sfr", 0, 0, M, None, "start frame number"),
        Param("fps_num", 30, 1, 1 << 24, None, "fps numerator"),
        Param("fps_den", 1, 1, 1 << 24, None, "fps denominator"),
        Param("aspect_num", 1, 1, 1 << 24, None, "aspect numerator"),
        Param("aspect_den", 1, 1, 1 << 24, None, "aspect denominator"),
        Param("ipct", 50, 0, 100, None,
              "intra block % threshold for I-frame promotion"),
        Param("pyrlevels", 0, 0, C.MAX_PYRAMID_LEVELS, None,
              "HME pyramid levels (0 = auto)"),
        Param("rc_mode", C.RATE_CONTROL_ABR, 0, 1,
              lambda v: C.RATE_CONTROL_CRF if v == 1 else C.RATE_CONTROL_ABR,
              "rate control: 0 = ABR, 1 = CRF. 0 = default"),
        Param("rc_hmnudge", 1, 0, 1, None, "high-motion RC nudge"),
        Param("kbps", AUTO_BITRATE, AUTO_BITRATE, M, lambda v: v * 1024,
              "ABR bitrate kbps (0 = auto-estimate)"),
        Param("maxqstep", C.MAX_QUALITY * 1 // 200, 1, C.MAX_QUALITY, None,
              "max ABR quality step"),
        Param("minqp", pct_to_qual(1), 0, 100, pct_to_qual, "min quality %"),
        Param("maxqp", pct_to_qual(100), 0, 100, pct_to_qual, "max quality %"),
        Param("iminqp", pct_to_qual(5), 0, 100, pct_to_qual,
              "min I-frame quality %"),
        Param("stabref", 0, 0, M, None,
              "stability refresh period (0 = auto)"),
        Param("scd", 1, 0, 1, None, "scene change detection"),
        Param("schdelta", 4, 0, 256, None, "scene change luma delta"),
        Param("gopar", 1, 0, 1, None,
              "GOP-parallel device encode (CRF only). 1 = default"),
        Param("effort", 0, 0, 3, None,
              "motion search effort beyond the reference (exhaustive "
              "+-2*effort full-pel window). 0 = reference parity"),
        Param("gopabr", 0, 0, 1, None,
              "GOP-granular ABR rate feedback (mesh-shardable, not "
              "byte-identical). 0 = default: the per-frame ABR law runs "
              "inside the device scan, byte-identical to the reference"),
    ]


def dec_params():
    return [
        Param("out420p", 0, 0, 1, None, "convert output to 4:2:0"),
        Param("drawinfo", 0, 0, 7, None,
              "draw debug info: 1=stability 2=motion vecs 4=intra blocks"),
    ]


def _usage(params, mode):
    print(HEADER)
    print(f"usage: dsv1-tpu {mode} [options]")
    for p in params:
        print(f"\t-{p.prefix} : {p.desc}  [min={p.vmin}, max={p.vmax}]")
    print("\t-inp_ : REQUIRED input file")
    print("\t-out_ : REQUIRED output file")
    print("\t-y : overwrite without prompting")
    print("\t-l<n> : log level")
    print("\t-v : verbose")
    print("\t-prof_ : write a JAX profiler trace to this directory")


def _parse(argv, params):
    opts = {"inp": None, "out": None, "y": False, "v": False, "l": 2,
            "prof": None}
    table = {p.prefix: p for p in params}
    for a in argv:
        if not a.startswith("-"):
            print(f"strange argument: {a}")
            return None
        a = a[1:]
        if a == "v":
            opts["v"] = True
            continue
        if a == "y":
            opts["y"] = True
            continue
        if a.startswith("l") and a[1:].isdigit():
            opts["l"] = int(a[1:])
            log.set_level(opts["l"])
            continue
        if a.startswith("inp_"):
            opts["inp"] = a[4:]
            continue
        if a.startswith("out_"):
            opts["out"] = a[4:]
            continue
        if a.startswith("prof_"):
            opts["prof"] = a[5:]
            continue
        for pref in sorted(table, key=len, reverse=True):
            if a.startswith(pref):
                try:
                    v = int(a[len(pref):])
                except ValueError:
                    print(f"error reading argument: {pref}")
                    return None
                p = table[pref]
                v = max(p.vmin, min(v, p.vmax))
                p.value = p.convert(v) if p.convert else v
                break
        else:
            print(f"unrecognized argument: -{a}")
            return None
    return opts


def _get(params, name):
    for p in params:
        if p.prefix == name:
            return p.value
    return 0


def encoder_setup(params) -> tuple[Metadata, EncoderConfig]:
    """Stream metadata and encoder config from parsed encode params,
    with the reference CLI's derived defaults: auto bitrate, the 3/2 ABR
    quality pre-boost and stabref auto (dsv_main.c:476-489)."""
    meta = Metadata(_get(params, "w"), _get(params, "h"),
                    _get(params, "fmt"), _get(params, "fps_num"),
                    _get(params, "fps_den"), _get(params, "aspect_num"),
                    _get(params, "aspect_den"))
    gop = _get(params, "gop")
    quality = _get(params, "qp")
    rc_mode = _get(params, "rc_mode")
    kbps = _get(params, "kbps")
    if kbps == AUTO_BITRATE:
        bitrate = estimate_bitrate(quality * 100 // C.MAX_QUALITY, gop, meta)
    else:
        bitrate = kbps
    if rc_mode == C.RATE_CONTROL_ABR:
        quality = max(0, min(quality * 3 // 2, C.MAX_QUALITY))
    stabref = _get(params, "stabref")
    if stabref == 0:
        stabref = max(1, min(gop - 1, 14))
    cfg = EncoderConfig(
        quality=quality, gop=gop, do_scd=bool(_get(params, "scd")),
        rc_mode=rc_mode, rc_high_motion_nudge=bool(_get(params, "rc_hmnudge")),
        bitrate=bitrate, max_q_step=_get(params, "maxqstep"),
        min_quality=_get(params, "minqp"), max_quality=_get(params, "maxqp"),
        min_I_frame_quality=_get(params, "iminqp"),
        intra_pct_thresh=_get(params, "ipct"),
        scene_change_delta=_get(params, "schdelta"),
        stable_refresh=stabref, pyramid_levels=_get(params, "pyrlevels"),
        effort=_get(params, "effort"))
    return meta, cfg


def encode_main(argv) -> int:
    params = enc_params()
    opts = _parse(argv, params)
    if opts is None or "help" in argv:
        _usage(params, "e")
        return 1
    if not opts["inp"] or not opts["out"]:
        print("inp or out was not specified!")
        _usage(params, "e")
        return 1
    w, h = _get(params, "w"), _get(params, "h")
    subsamp = _get(params, "fmt")
    meta, cfg = encoder_setup(params)
    gop, rc_mode = cfg.gop, cfg.rc_mode
    frno = _get(params, "sfr")
    nfr = _get(params, "nfr")
    maxframe = frno + nfr if nfr > 0 else -1
    nencoded = 0
    # effectively-infinite GOPs (reference DSV_GOP_INF) run sequentially:
    # the device path compiles a scan of length gop-1. ABR runs the
    # reference's per-frame rate law inside the device scan by default
    # (byte-identical, parallel/gop.py _encode_abr_exact); -gopabr1 opts
    # into GOP-granular parallel rate control instead (spec-valid,
    # mesh-shardable, different bytes than per-frame ABR).
    par_rc = rc_mode == C.RATE_CONTROL_CRF or gop > 0
    use_par = bool(_get(params, "gopar")) and gop <= 4096 and par_rc
    abr_mode = "gop" if bool(_get(params, "gopabr")) else "exact"
    import contextlib
    prof = contextlib.nullcontext()
    if opts.get("prof"):
        from .utils.trace import profile_trace
        prof = profile_trace(opts["prof"])
    if use_par:
        # GOP-parallel device path (parallel/gop.py): CRF streams are
        # independent of packed byte counts, so whole GOPs encode as
        # device-resident scans, batched and sharded across chips.
        # Frames stream from disk chunk by chunk (constant memory); the
        # source advertises its length (from the file size) so short
        # clips keep tight device-batch shapes.
        import os
        from .utils.yuv import frame_size

        fsz = frame_size(w, h, subsamp)
        avail = max(0, os.path.getsize(opts["inp"]) // fsz - frno)
        n_total = min(avail, maxframe - frno) if maxframe > 0 else avail

        class _Frames:
            def __len__(self):
                return n_total

            def __iter__(self):
                nonlocal nencoded, frno
                with open(opts["inp"], "rb") as f:
                    while maxframe <= 0 or frno < maxframe:
                        planes = read_frame(f, frno, w, h, subsamp)
                        if planes is None:
                            break
                        if opts["v"]:
                            print(f"encoding frame {frno}", end="\r",
                                  flush=True)
                        frno += 1
                        nencoded += 1
                        yield planes

        from .parallel import encode_stream_gops
        with prof:
            out = bytearray(encode_stream_gops(_Frames(), meta, cfg,
                                               abr_mode=abr_mode))
    else:
        enc = Encoder(meta, cfg)
        enc.start()
        out = bytearray()
        with prof, open(opts["inp"], "rb") as f:
            while True:
                if maxframe > 0 and frno >= maxframe:
                    break
                planes = read_frame(f, frno, w, h, subsamp)
                if planes is None:
                    break
                if opts["v"]:
                    print(f"encoding frame {frno}", end="\r", flush=True)
                for pkt in enc.encode(planes):
                    out += pkt
                frno += 1
                nencoded += 1
            out += enc.end_of_stream()
    if opts["v"] and nencoded:
        fps = (meta.fps_num + meta.fps_den // 2) // meta.fps_den
        bpf = len(out) * 8 // nencoded
        print(f"\nencoded {len(out)} bytes @ {bpf * fps} bps, "
              f"{bpf * fps // 1024} kbps. fps = {fps}, bpf = {bpf}")
    with open(opts["out"], "wb") as f:
        f.write(bytes(out))
    return 0


def decode_main(argv) -> int:
    params = dec_params()
    opts = _parse(argv, params)
    if opts is None or "help" in argv:
        _usage(params, "d")
        return 1
    if not opts["inp"] or not opts["out"]:
        print("inp or out was not specified!")
        _usage(params, "d")
        return 1
    to420 = bool(_get(params, "out420p"))
    drawinfo = _get(params, "drawinfo")
    stream = open(opts["inp"], "rb").read()
    import contextlib
    prof = contextlib.nullcontext()
    if opts.get("prof"):
        from .utils.trace import profile_trace
        prof = profile_trace(opts["prof"])
    if drawinfo:
        # overlays need per-frame block data: sequential path
        dec = Decoder(draw_info=drawinfo)
        decoded = dec.decode_stream(stream)
        get_meta = dec.get_metadata
    else:
        # streaming: frames decode chunk-by-chunk while earlier ones are
        # written out; meta_box fills before the first frame yields
        from .parallel import iter_decode_gops
        meta_box = {}
        decoded = iter_decode_gops(stream, _meta_box=meta_box)
        get_meta = lambda: meta_box.get("meta")  # noqa: E731
    with prof, open(opts["out"], "wb") as f:
        for fno, planes in decoded:
            meta = get_meta()
            if to420 and meta.subsamp != C.SUBSAMP_420:
                y, u, v = planes
                if meta.subsamp == C.SUBSAMP_444:
                    u, v = conv444to422(u), conv444to422(v)
                if meta.subsamp in (C.SUBSAMP_444, C.SUBSAMP_422):
                    u, v = conv422to420(u), conv422to420(v)
                planes = [y, u, v]
            if opts["v"]:
                print(f"decoded frame {fno}", end="\r", flush=True)
            write_frame(f, fno, planes)
    if opts["v"]:
        print()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0][:1] not in ("e", "d"):
        print(HEADER)
        print("usage: dsv1-tpu <e|d> [options]")
        return 0
    from .utils.cache import enable_compile_cache
    enable_compile_cache()
    if argv[0][0] == "e":
        return encode_main(argv[1:])
    return decode_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
