"""dsv1_tpu — the DSV1 video codec in JAX.

Brand-new implementation (JAX/XLA) of the DSV1 subband video codec with
the full capability set of the reference C implementation
(LMP88959/Digital-Subband-Video-1): full-decomposition Haar/B4T wavelet
transforms, hierarchical motion estimation, half-pel block motion compensation,
stability-tracked adaptive quantization with hierarchical zero-coefficient
coding, interleaved exp-Golomb bitstreams, 4:4:4/4:2:2/4:2:0/4:1:1 chroma,
CRF/ABR rate control and scene-change detection.

The decoder is bit-exact against the reference decoder; the encoder emits
spec-valid DSV1 streams. All per-pixel/per-coefficient math runs as
integer-exact JAX ops on the accelerator (an NVIDIA GPU); serial
byte/bit-level work is vectorized (prefix-sum bit packing) or handled by a
small native C++ layer.
"""

from .constants import (
    SUBSAMP_444, SUBSAMP_422, SUBSAMP_420, SUBSAMP_411,
    MAX_QUALITY, quality_percent,
)
from .models.metadata import Metadata

__all__ = [
    "SUBSAMP_444", "SUBSAMP_422", "SUBSAMP_420", "SUBSAMP_411",
    "MAX_QUALITY", "quality_percent", "Metadata",
    "Encoder", "EncoderConfig", "Decoder",
    "encode_stream_gops", "decode_stream_gops",
]

_LAZY = {
    "Encoder": ("dsv1_tpu.models.encoder", "Encoder"),
    "EncoderConfig": ("dsv1_tpu.models.encoder", "EncoderConfig"),
    "Decoder": ("dsv1_tpu.models.decoder", "Decoder"),
    "encode_stream_gops": ("dsv1_tpu.parallel", "encode_stream_gops"),
    "decode_stream_gops": ("dsv1_tpu.parallel", "decode_stream_gops"),
}


def __getattr__(name):
    """Lazy top-level API (keeps `import dsv1_tpu` light)."""
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'dsv1_tpu' has no attribute {name!r}")


__version__ = "0.1.0"
