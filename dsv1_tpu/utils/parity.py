"""The plain reference for byte and pixel identity.

The in-repo sequential codec (models/encoder.py, models/decoder.py) run
on the host CPU: one frame at a time, no GOP batching, no scan, no
compaction or chunk packing, and none of the accelerator's numerics. A
stream from the device paths must equal its bytes, and a device decode
must equal its pixels. Shared by chip_smoke.py and bench.py.
"""

import jax
import numpy as np

from ..models.decoder import Decoder
from ..models.encoder import Encoder


def cpu_device():
    return jax.devices("cpu")[0]


def reference_encode(frames, meta, cfg) -> bytes:
    """Sequential encode of (y, u, v) frames on the CPU."""
    with jax.default_device(cpu_device()):
        enc = Encoder(meta, cfg)
        enc.start()
        out = bytearray()
        for f in frames:
            for pkt in enc.encode(f):
                out += pkt
        out += enc.end_of_stream()
    return bytes(out)


def reference_decode(stream: bytes, max_frames: int | None = None):
    """Sequential decode on the CPU -> [(fno, [y, u, v]), ...]."""
    out = []
    with jax.default_device(cpu_device()):
        for fno, planes in Decoder().decode_stream(stream):
            out.append((fno, [np.asarray(p) for p in planes]))
            if max_frames is not None and len(out) >= max_frames:
                break
    return out


def frames_bytes(decoded) -> bytes:
    """Raw planar bytes of decoded frames in order, as the CLI writes
    them (utils/yuv.py write_frame)."""
    return b"".join(np.asarray(p, np.uint8).tobytes()
                    for _, planes in decoded for p in planes)


def same_decode(a, b) -> bool:
    """Two decodes agree: frame numbers and every pixel."""
    return (len(a) == len(b)
            and all(fa == fb for (fa, _), (fb, _) in zip(a, b))
            and frames_bytes(a) == frames_bytes(b))
