"""Device-time breakdown of one GOP encode chunk from a profiler trace.

Builds the CRF chunk executable that encode_stream_gops dispatches
(parallel/gop.py _jit_batched) at the given geometry, or with --dense
the dense variant it re-runs a chunk with when a compaction cap
overflows (gop.EVENTS "dense_redo"), runs it on
device-resident input, traces `--reps` calls with jax.profiler, and
attributes every device kernel to the codec's named scopes through the
optimized HLO's op_name metadata:

  dsv_mc          motion compensation (bmc.compensate_plane, recon scan)
  dsv_hme         hierarchical motion estimation (inside dsv_motion)
  dsv_motion      the rest of the input-only path (prep, pyramids, SCD)
  dsv_recon_scan  the rest of the recon scan (transforms, quant, recon)
  dsv_compact     output compaction
  other           everything else (I frame, blob packing, ...)

XLA's command buffers (CUDA graphs) are turned off in this process so
that every kernel shows in the trace under its own HLO name; the wall
time is therefore that of the unbatched launches, which may differ from
the shipped executable's. Prints one JSON line: wall seconds per chunk
(host clock, untraced, ending in block_until_ready), kernel seconds per
chunk, and each scope's kernel seconds and share. `--out FILE` also
writes the full reduction there, with the trace's plane and line names.

Usage: python tools/trace_chunk.py [--w 1920] [--h 1080] [--reps 3]
                                   [--dense] [--out FILE]
"""

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SCOPES = ("dsv_mc", "dsv_hme", "dsv_motion", "dsv_recon_scan",
          "dsv_compact")


def hlo_op_names(hlo_text: str) -> dict:
    """Instruction name -> op_name metadata; a fusion without its own
    metadata takes its called computation's root op_name."""
    names, calls, roots = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        s = line.strip()
        if s.endswith("{") and " = " not in s:
            head = s.split()
            comp = (head[1] if head[0] == "ENTRY" else head[0]).lstrip("%")
            continue
        m = re.match(r"(ROOT )?%(\S+) = ", s)
        if not m:
            continue
        on = re.search(r'op_name="([^"]*)"', s)
        called = re.search(r"calls=%([\w.\-]+)", s)
        if on:
            names[m.group(2)] = on.group(1)
            if m.group(1):
                roots[comp] = on.group(1)
        if called:
            calls[m.group(2)] = called.group(1)
    return {k: names.get(k) or roots.get(calls.get(k), "")
            for k in set(names) | set(calls)}


def scope_of(op_name: str) -> str:
    """Innermost-first scope match; transforms wrap scope names, as in
    'vmap(dsv_mc)/...'."""
    for s in SCOPES:
        if re.search(rf"(?<!\w){s}(?!\w)", op_name):
            return s
    return "other"


def reduce_trace(xplane_path: str, op_names: dict, reps: int) -> dict:
    """Kernel seconds per chunk, in total and per scope, from the
    device planes' stream lines (on a host-only trace: the events that
    name an HLO op)."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(xplane_path)
    planes = list(pd.planes)
    inventory = {pl.name: [ln.name for ln in pl.lines] for pl in planes}
    dev_planes = [pl for pl in planes if pl.name.startswith("/device:")]
    per_scope, unmapped = defaultdict(float), set()
    total = 0.0
    for plane in dev_planes or planes:
        lines = list(plane.lines)
        if dev_planes:
            streams = [ln for ln in lines if ln.name.startswith("Stream")]
            lines = streams or [ln for ln in lines if ln.name == "XLA Ops"]
        for ln in lines:
            for ev in ln.events:
                stats = {k: v for k, v in ev.stats}
                if not dev_planes and "hlo_op" not in stats:
                    continue
                op = str(stats.get("hlo_op", ev.name))
                name = op_names.get(op)
                if name is None:
                    unmapped.add(op)
                    name = ""
                secs = ev.duration_ns * 1e-9 / reps
                per_scope[scope_of(name)] += secs
                total += secs
    return {"kernel_s": total,
            "scopes": {k: {"kernel_s": v, "share": v / total if total
                           else None} for k, v in sorted(per_scope.items())},
            "unmapped_ops": sorted(unmapped)[:50],
            "inventory": inventory}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--w", type=int, default=1920)
    ap.add_argument("--h", type=int, default=1080)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dense", action="store_true",
                    help="trace the dense (compaction overflow) variant")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_gpu_enable_command_buffer=").strip()
    import jax
    from dsv1_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    import bench

    dev = jax.devices()[0]
    pt = bench._mk_point(args.w, args.h, bench.G, "trace")
    fn, call_args, frames = bench.chunk_executable(pt, args.dense)
    t0 = time.perf_counter()
    fn(*call_args).block_until_ready()
    first_call = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(args.reps):
        fn(*call_args).block_until_ready()
    wall = (time.perf_counter() - t0) / args.reps
    op_names = hlo_op_names(fn.lower(*call_args).compile().as_text())
    with tempfile.TemporaryDirectory() as tmp:
        with jax.profiler.trace(tmp):
            for _ in range(args.reps):
                fn(*call_args).block_until_ready()
        path = glob.glob(f"{tmp}/plugins/profile/*/*.xplane.pb")[0]
        red = reduce_trace(path, op_names, args.reps)
    summary = {"w": args.w, "h": args.h, "dense": args.dense,
               "frames_per_chunk": frames,
               "platform": dev.platform, "kind": dev.device_kind,
               "xla_flags": os.environ["XLA_FLAGS"],
               "first_call_s": first_call, "wall_s": wall,
               "kernel_s": red["kernel_s"],
               "busy_share": red["kernel_s"] / wall,
               "scopes": red["scopes"]}
    print(json.dumps(summary), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(summary, **red), indent=1))


if __name__ == "__main__":
    main()
