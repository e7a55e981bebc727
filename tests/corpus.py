"""Synthetic YUV corpus for differential testing."""

import subprocess
from pathlib import Path

import numpy as np

from dsv1_tpu.constants import format_h_shift, format_v_shift, round_shift

from . import oracle


def make_clip(w, h, subsamp, nframes, seed=0, motion=True):
    """Moving textured square over noisy gradient; returns planar bytes."""
    rng = np.random.default_rng(seed)
    hs, vs = format_h_shift(subsamp), format_v_shift(subsamp)
    cw, ch = round_shift(w, hs), round_shift(h, vs)
    frames = []
    base = (np.linspace(0, 200, w)[None, :]
            + np.linspace(0, 55, h)[:, None]).astype(np.int32)
    tex = rng.integers(-18, 18, (h, w))
    for i in range(nframes):
        y = base + tex
        if motion:
            sx, sy = (13 + 5 * i) % max(w - 24, 1), (11 + 3 * i) % max(h - 24, 1)
            y = y.copy()
            y[sy:sy + 20, sx:sx + 20] += 60
            y = np.roll(y, i, axis=1)
        y = np.clip(y + rng.integers(-4, 4, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(110 + rng.integers(-9, 9, (ch, cw)) + (i * 2), 0,
                    255).astype(np.uint8)
        v = np.clip(135 + rng.integers(-9, 9, (ch, cw)), 0, 255).astype(np.uint8)
        frames += [y.tobytes(), u.tobytes(), v.tobytes()]
    return b"".join(frames)


def make_rich_clip(w, h, subsamp, nframes, seed=0):
    """Realistic-motion corpus: global pan over a
    textured background, two textured occluders on crossing
    trajectories (occluding the background and each other), a static
    high-texture strip (exercises stability tracking), colored chroma
    on the objects, and mild sensor noise. Returns planar bytes."""
    rng = np.random.default_rng(seed)
    hs, vs = format_h_shift(subsamp), format_v_shift(subsamp)
    cw, ch = round_shift(w, hs), round_shift(h, vs)

    # background: smooth illumination + band-limited texture, panned
    gx = np.linspace(0, 170, w)[None, :] + np.linspace(0, 60, h)[:, None]
    texf = rng.integers(-30, 30, (h, w)).astype(np.float64)
    # cheap low-pass (3x3 box twice) => mid-frequency texture
    for _ in range(2):
        texf = (np.roll(texf, 1, 1) + texf + np.roll(texf, -1, 1)) / 3
        texf = (np.roll(texf, 1, 0) + texf + np.roll(texf, -1, 0)) / 3
    bg = (gx + 3.5 * texf).astype(np.int32)

    # two occluders with their own textures and chroma
    ow, oh = max(w // 6, 16), max(h // 5, 16)
    obj = [rng.integers(-25, 25, (oh, ow)) + lvl for lvl in (70, -50)]
    strip = rng.integers(-35, 35, (h // 8, w))  # static textured strip

    frames = []
    for i in range(nframes):
        # global pan: 2 px/frame horizontal, 1 px every 2 frames vertical
        y = np.roll(np.roll(bg, 2 * i, axis=1), i // 2, axis=0).copy()
        uc = np.full((h, w), 112, np.int32)
        vc = np.full((h, w), 136, np.int32)
        # occluders cross: one left-to-right, one diagonal
        pos = [((7 * i) % max(w - ow, 1), (h // 3)),
               ((w - ow - (5 * i) % max(w - ow, 1)),
                (3 * i) % max(h - oh, 1))]
        for k, (ox, oy) in enumerate(pos):
            y[oy:oy + oh, ox:ox + ow] = 128 + obj[k]
            uc[oy:oy + oh, ox:ox + ow] = 90 if k == 0 else 150
            vc[oy:oy + oh, ox:ox + ow] = 160 if k == 0 else 105
        y[-strip.shape[0]:, :] = 120 + strip  # static strip (no motion)
        y = np.clip(y + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(uc[::(1 << vs), ::(1 << hs)][:ch, :cw]
                    + rng.integers(-2, 3, (ch, cw)), 0, 255).astype(np.uint8)
        v = np.clip(vc[::(1 << vs), ::(1 << hs)][:ch, :cw]
                    + rng.integers(-2, 3, (ch, cw)), 0, 255).astype(np.uint8)
        frames += [y.tobytes(), u.tobytes(), v.tobytes()]
    return b"".join(frames)


def make_clip_frames(w, h, subsamp, nframes, seed=0, cut_at=-1):
    """make_clip as a list of (y, u, v) planar arrays; cut_at >= 0
    inverts luma from that frame on (a hard scene cut that forces
    intra)."""
    from dsv1_tpu.ops.frame import np_yuv_split
    from dsv1_tpu.utils.yuv import frame_size

    yuv = make_clip(w, h, subsamp, nframes, seed=seed)
    fsz = frame_size(w, h, subsamp)
    frames = []
    for i in range(nframes):
        y, u, v = np_yuv_split(
            np.frombuffer(yuv[i * fsz:(i + 1) * fsz], np.uint8),
            subsamp, w, h)
        if cut_at >= 0 and i >= cut_at:
            y = (255 - y).astype(np.uint8)
        frames.append((y, u, v))
    return frames


FMT_FLAG = {0x0: 0, 0x4: 1, 0x5: 2, 0x8: 3}  # subsamp -> CLI -fmt value


def ref_encode(yuv: bytes, w, h, subsamp, nframes, tmpdir: Path, **opts):
    """Encode with the reference binary; returns .dsv bytes."""
    oracle.build_oracle()
    inp = tmpdir / "in.yuv"
    out = tmpdir / "out.dsv"
    inp.write_bytes(yuv)
    args = [str(oracle.BIN), "e", f"-inp_{inp}", f"-out_{out}",
            f"-w{w}", f"-h{h}", f"-fmt{FMT_FLAG[subsamp]}",
            f"-nfr{nframes}", "-y"]
    for k, v in opts.items():
        args.append(f"-{k}{v}")
    subprocess.run(args, check=True, capture_output=True)
    return out.read_bytes()


def ref_decode(dsv: bytes, tmpdir: Path, **opts) -> bytes:
    oracle.build_oracle()
    inp = tmpdir / "in.dsv"
    out = tmpdir / "out.yuv"
    inp.write_bytes(dsv)
    args = [str(oracle.BIN), "d", f"-inp_{inp}", f"-out_{out}", "-y"]
    for k, v in opts.items():
        args.append(f"-{k}{v}")
    subprocess.run(args, check=True, capture_output=True)
    return out.read_bytes()
