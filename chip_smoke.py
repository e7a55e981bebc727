"""Smoke run of the codec's main paths on NVIDIA GPUs.

Drives the entry points a user calls, once each, on one GPU:

  1. CIF 4:2:0 gop12: CRF and the CLI's default exact per-frame ABR
     through encode_stream_gops;
  2. 1080p 4:2:0 gop12 CRF, 96 frames;
  3. decode_stream_gops of the phase 1 and 2 streams;
  4. the CLI in process: `e` with its defaults and `d`, on the CIF clip.

Every stream is byte-compared whole, and every decode pixel-compared
frame by frame, with the plain reference: the sequential codec on the
host CPU (dsv1_tpu/utils/parity.py). Both the first (compiling) call and
the timed steady-state call are compared. Each phase prints one JSON line: wall
seconds, compile seconds (kept apart from the steady-state run), frames
per second, peak device bytes and parity. A failed phase makes the run
exit non-zero. The last line is {"ok": true, "device": {...}}.

--four-cards runs only the multi-device phase on four GPUs: the GOP
mesh encode and decode at 1080p and the gop x tile mesh encode at
3840x2160, each compared with one card, plus every card's peak memory.

The script needs a GPU: where JAX finds none it exits non-zero and
prints no result. Usage:

    python chip_smoke.py [--four-cards]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np

from dsv1_tpu import cli
from dsv1_tpu.constants import (RATE_CONTROL_CRF, SUBSAMP_420,
                                quality_percent)
from dsv1_tpu.models.encoder import EncoderConfig
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.ops.frame import np_yuv_split
from dsv1_tpu.parallel import (decode_stream_gops, encode_stream_gops,
                               gop_mesh, gop_tile_mesh)
from dsv1_tpu.parallel import decode as _decode
from dsv1_tpu.parallel import gop as _gop
from dsv1_tpu.utils import parity
from dsv1_tpu.utils.cache import enable_compile_cache
from dsv1_tpu.utils.yuv import frame_size

# (width, height, frames)
SIZES = {"cif": (352, 288, 48), "hd": (1920, 1080, 96),
         "uhd": (3840, 2160, 24)}
GOP = 12
SEED = 11


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling (its own
    /jax/core/compile/* duration events), per thread: the listener runs
    in the thread that compiles. `backend` is XLA's share."""

    def __init__(self):
        self.total = defaultdict(float)
        self.backend = defaultdict(float)
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, secs, **_):
        if event.startswith("/jax/core/compile/"):
            tid = threading.get_ident()
            self.total[tid] += secs
            if event.endswith("backend_compile_duration"):
                self.backend[tid] += secs


CLOCK = None


def _clock():
    global CLOCK
    if CLOCK is None:
        CLOCK = CompileClock()
    return CLOCK


def timed(fn, *args, **kw):
    """(result, wall seconds, compile seconds) of one call in this
    thread; the result is on the host (bytes or numpy), so the wall
    time covers the device work."""
    clock, tid = _clock(), threading.get_ident()
    c0 = clock.total[tid]
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0, clock.total[tid] - c0


def peak_bytes(dev):
    stats = dev.memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])


def report(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec


def clip(w, h, n):
    """n frames of the synthetic test corpus (tests/corpus.py), 4:2:0."""
    from tests.corpus import make_clip
    yuv = make_clip(w, h, SUBSAMP_420, n, seed=SEED)
    fsz = frame_size(w, h, SUBSAMP_420)
    frames = [np_yuv_split(np.frombuffer(yuv[i * fsz:(i + 1) * fsz],
                                         np.uint8), SUBSAMP_420, w, h)
              for i in range(n)]
    return yuv, frames


def crf_config():
    return EncoderConfig(quality=quality_percent(85), gop=GOP,
                         rc_mode=RATE_CONTROL_CRF, stable_refresh=GOP - 1)


def cli_default_config(w, h):
    """The CLI's encode defaults at this geometry (ABR, auto bitrate)."""
    params = cli.enc_params()
    cli._parse([f"-w{w}", f"-h{h}"], params)
    return cli.encoder_setup(params)


def decode_planes(stream, mesh=None):
    _, frames = decode_stream_gops(stream, mesh=mesh)
    return [(fno, [np.asarray(p) for p in planes])
            for fno, planes in frames]


def reference(frames, meta, cfg):
    """The CPU reference stream of these frames and its CPU decode."""
    stream = parity.reference_encode(frames, meta, cfg)
    return stream, parity.reference_decode(stream)


def _delta(events, before):
    return {k: v - before.get(k, 0) for k, v in events.items()}


def encode_record(name, job, first, ref, dev):
    """Steady-state encode (after the first call compiled), the
    compaction/stability redo counts of that one encode, and parity of
    both calls' streams with the CPU reference stream."""
    frames, meta, cfg = job
    stream, first_s, compile_s = first
    ev0 = dict(_gop.EVENTS)
    steady_stream, steady, _ = timed(encode_stream_gops, frames, meta, cfg)
    events = _delta(_gop.EVENTS, ev0)
    return report({"phase": name + "_encode", "frames": len(frames),
                   "first_call_s": first_s, "compile_s": compile_s,
                   "steady_s": steady, "fps": len(frames) / steady,
                   "bytes": len(steady_stream),
                   "dense_redo": events.get("dense_redo", 0),
                   "stab_fix": events.get("stab_fix", 0),
                   "peak_bytes_in_use": peak_bytes(dev),
                   "parity": stream == steady_stream == ref[0]})


def decode_record(name, stream, first, ref, dev):
    """Steady-state decode, the path it took (batched or the sequential
    fallback), and pixel parity of both calls' frames with the CPU
    reference decode."""
    got, first_s, compile_s = first
    ev0 = dict(_decode.EVENTS)
    steady_got, steady, _ = timed(decode_planes, stream)
    events = _delta(_decode.EVENTS, ev0)
    batched = (events.get("batched", 0) == 1
               and events.get("sequential_fallback", 0) == 0)
    same = (parity.same_decode(got, ref[1])
            and parity.same_decode(steady_got, ref[1]))
    return report({"phase": name + "_decode", "frames": len(got),
                   "first_call_s": first_s, "compile_s": compile_s,
                   "steady_s": steady, "fps": len(got) / steady,
                   "path": "batched" if batched else "sequential_fallback",
                   "peak_bytes_in_use": peak_bytes(dev),
                   "parity": same, "ok": same and batched})


def cli_phase(yuv, w, h, abr_stream, abr_decode, dev):
    """`e` with the CLI defaults and `d`, in this process."""
    with tempfile.TemporaryDirectory() as tmp:
        inp, dsv, out = (os.path.join(tmp, f) for f in
                         ("in.yuv", "out.dsv", "out.yuv"))
        with open(inp, "wb") as f:
            f.write(yuv)
        rc_e, wall_e, comp_e = timed(cli.main, [
            "e", f"-inp_{inp}", f"-out_{dsv}", f"-w{w}", f"-h{h}", "-y"])
        with open(dsv, "rb") as f:
            enc = f.read()
        rc_d, wall_d, comp_d = timed(cli.main, [
            "d", f"-inp_{dsv}", f"-out_{out}", "-y"])
        with open(out, "rb") as f:
            dec = f.read()
    return report({"phase": "cli_roundtrip", "encode_s": wall_e,
                   "decode_s": wall_d, "compile_s": comp_e + comp_d,
                   "peak_bytes_in_use": peak_bytes(dev),
                   "parity": rc_e == 0 and rc_d == 0 and enc == abr_stream
                   and dec == parity.frames_bytes(abr_decode)})


def run_one_card(sizes=SIZES):
    """Phases 1-4 on the default device. Returns the phase records.

    Compiling dominates a cold run, so the first call of each encode
    (and then of each decode) runs in its own thread, and the CPU
    references run in another; the steady-state timings and all
    comparisons follow once those threads are done, one at a time."""
    dev = jax.devices()[0]
    w, h, n = sizes["cif"]
    yuv, frames = clip(w, h, n)
    wh, hh, nh = sizes["hd"]
    _, frames_hd = clip(wh, hh, nh)
    jobs = {"cif_crf": (frames, Metadata(w, h, SUBSAMP_420), crf_config()),
            "cif_abr": (frames, *cli_default_config(w, h)),
            "hd_crf": (frames_hd, Metadata(wh, hh, SUBSAMP_420),
                       crf_config())}
    with ThreadPoolExecutor(1) as cpu, ThreadPoolExecutor(len(jobs)) as dv:
        refs = {k: cpu.submit(reference, *job) for k, job in jobs.items()}
        enc = {k: dv.submit(timed, encode_stream_gops, *job)
               for k, job in jobs.items()}
        enc = {k: fut.result() for k, fut in enc.items()}
        dec = {k: dv.submit(timed, decode_planes, e[0])
               for k, e in enc.items()}
        dec = {k: fut.result() for k, fut in dec.items()}
        refs = {k: fut.result() for k, fut in refs.items()}
    recs = [encode_record(k, jobs[k], enc[k], refs[k], dev) for k in jobs]
    recs += [decode_record(k, enc[k][0], dec[k], refs[k], dev)
             for k in jobs]
    recs.append(cli_phase(yuv, w, h, enc["cif_abr"][0], dec["cif_abr"][0],
                          dev))
    return recs


def run_four_cards(devs, sizes=SIZES):
    """The multi-device phase and its one-card comparison (the default
    device). The four encodes compile and run concurrently, each in its
    own thread, then the two decodes; each comparison is reported as
    soon as both of its sides are done."""
    wh, hh, nh = sizes["hd"]
    _, frames = clip(wh, hh, nh)
    meta, cfg = Metadata(wh, hh, SUBSAMP_420), crf_config()
    wu, hu, nu = sizes["uhd"]
    _, frames_u = clip(wu, hu, nu)
    meta_u = Metadata(wu, hu, SUBSAMP_420)
    mesh, tile_mesh = gop_mesh(devs), gop_tile_mesh(2, 2, devs)
    recs = []
    with ThreadPoolExecutor(4) as pool:
        hd1, hd4, u1, u4 = (
            pool.submit(timed, encode_stream_gops, f, m, cfg, mesh=mh)
            for f, m, mh in ((frames, meta, None), (frames, meta, mesh),
                             (frames_u, meta_u, None),
                             (frames_u, meta_u, tile_mesh)))
        hd1, hd4 = hd1.result(), hd4.result()
        recs.append(report({"phase": "hd_gop_mesh_encode", "frames": nh,
                            "first_call_s": hd4[1], "compile_s": hd4[2],
                            "one_card_first_call_s": hd1[1],
                            "parity": hd4[0] == hd1[0]}))
        d1, d4 = (pool.submit(timed, decode_planes, s_, mh)
                  for s_, mh in ((hd1[0], None), (hd4[0], mesh)))
        d1, d4 = d1.result(), d4.result()
        recs.append(report({"phase": "hd_gop_mesh_decode",
                            "frames": len(d4[0]), "first_call_s": d4[1],
                            "compile_s": d4[2],
                            "parity": parity.same_decode(d4[0], d1[0])}))
        u1, u4 = u1.result(), u4.result()
        recs.append(report({"phase": "uhd_gop_tile_encode", "frames": nu,
                            "first_call_s": u4[1], "compile_s": u4[2],
                            "one_card_first_call_s": u1[1],
                            "parity": u4[0] == u1[0]}))
    # every card held part of the work (None: a host device keeps no
    # memory statistics)
    peaks = [peak_bytes(d) for d in devs]
    recs.append(report({"phase": "four_card_memory",
                        "peak_bytes_in_use": peaks,
                        "parity": all(p is None or p > 0 for p in peaks)}))
    return recs


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip() or f"nvidia-smi: {r.stderr.strip()}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devs) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX found {len(devs)}",
              file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    enable_compile_cache()
    t0 = time.perf_counter()
    recs = (run_four_cards(devs[:4]) if args.four_cards
            else run_one_card())
    failed = [r["phase"] for r in recs if not r.get("ok", r["parity"])]
    print(json.dumps({"phases": len(recs), "failed": failed,
                      "total_s": time.perf_counter() - t0,
                      "backend_compile_s": sum(_clock().backend.values()),
                      "xla_flags": os.environ.get("XLA_FLAGS", "")}),
          flush=True)
    if failed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": need}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
