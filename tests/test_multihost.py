"""Multi-host GOP sharding (parallel/multihost.py): per-shard encodes of
contiguous GOP ranges, muxed with O(1) boundary link patches, must be
byte-identical to the single-host GOP-parallel encode — which is itself
byte-identical to the sequential encoder (test_chunk_pack)."""

import os

import numpy as np
import pytest

from dsv1_tpu.constants import (GOP_INTRA, RATE_CONTROL_CRF, SUBSAMP_420,
                                quality_percent)
from dsv1_tpu.models.encoder import EncoderConfig
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.ops.frame import np_yuv_split
from dsv1_tpu.parallel import (encode_stream_gops, encode_stream_multihost,
                               shard_ranges)
from dsv1_tpu.utils.yuv import frame_size

from . import corpus

W, H, SUB = 96, 64, SUBSAMP_420


def _frames(n, seed=21):
    yuv = corpus.make_clip(W, H, SUB, n, seed=seed)
    fsz = frame_size(W, H, SUB)
    return [np_yuv_split(np.frombuffer(yuv[i * fsz:(i + 1) * fsz], np.uint8),
                         SUB, W, H) for i in range(n)]


def test_shard_ranges_cover_and_align():
    for n, gop, s in [(25, 4, 3), (8, 4, 5), (10, GOP_INTRA, 2), (7, 3, 2)]:
        rng = shard_ranges(n, gop, s)
        covered = sum(nf for _, _, nf in rng)
        assert covered == n
        G = max(gop, 1) if gop != GOP_INTRA else 1
        for g0, f0, _nf in rng:
            assert f0 == g0 * G


@pytest.mark.parametrize("n,gop,shards", [(14, 4, 2), (16, 4, 3)])
def test_multihost_mux_matches_single_host(n, gop, shards):
    frames = _frames(n)
    meta = Metadata(W, H, SUB)
    cfg = EncoderConfig(quality=quality_percent(85), gop=gop,
                        rc_mode=RATE_CONTROL_CRF, stable_refresh=gop - 1)
    single = encode_stream_gops(frames, meta, cfg)
    multi = encode_stream_multihost(frames, meta, cfg, n_shards=shards)
    assert multi == single


def test_multihost_gop0():
    frames = _frames(6, seed=9)
    meta = Metadata(W, H, SUB)
    cfg = EncoderConfig(quality=quality_percent(85), gop=GOP_INTRA,
                        rc_mode=RATE_CONTROL_CRF)
    single = encode_stream_gops(frames, meta, cfg)
    multi = encode_stream_multihost(frames, meta, cfg, n_shards=2)
    assert multi == single


def test_multihost_dense_fallback_keeps_global_frame_numbers():
    """A shard that hits the compaction-overflow dense fallback must
    still emit global frame numbers (regression: the fallback packer
    dropped _fnum_base, numbering the second shard's frames from 0)."""
    rng = np.random.default_rng(11)
    flat = [(np.full((H, W), 60, np.uint8),
             np.full((H // 2, W // 2), 128, np.uint8),
             np.full((H // 2, W // 2), 128, np.uint8)) for _ in range(6)]
    noisy = [(rng.integers(0, 256, (H, W), dtype=np.uint8),
              rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8),
              rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8))
             for _ in range(2)]
    # scene cut inside the SECOND shard's GOP -> that shard's chunk
    # takes the dense fallback with a nonzero _fnum_base
    frames = flat + noisy
    meta = Metadata(W, H, SUB)
    cfg = EncoderConfig(quality=quality_percent(95), gop=4,
                        rc_mode=RATE_CONTROL_CRF, stable_refresh=3)
    single = encode_stream_gops(frames, meta, cfg)
    multi = encode_stream_multihost(frames, meta, cfg, n_shards=2)
    assert multi == single


@pytest.mark.skipif(not os.environ.get("DSV1_SLOW_TESTS"),
                    reason="~4 min (2 OS processes); set DSV1_SLOW_TESTS=1")
def test_two_real_processes_jax_distributed(tmp_path):
    """The REAL multi-process flow: two separate OS
    processes through jax.distributed.initialize, shard exchange +
    stability handshake over the distributed backend's allgather, mux on
    rank 0 — byte-identical to the sequential encoder. The corpus has a
    hard scene cut inside shard 0's last GOP so the shard boundary does
    NOT land on a stability refresh: rank 1 must take the handshake's
    re-encode leg.

    Slow tier (the Gloo context is established by a warm-up allgather
    right after jax.distributed.initialize, so rank skew during the
    encode phase does not trip Gloo's 30 s rendezvous deadline; see
    parallel/multihost.py run_distributed_shard)."""
    import json
    import socket
    import subprocess
    import sys
    from pathlib import Path

    w, h, n, gop, qp, cut = 48, 32, 12, 3, 85, 4
    out = tmp_path / "mp.dsv"
    timing = tmp_path / "timing.json"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # plain 1-device CPU per process
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests._mp_worker", str(r), "2", str(port),
         str(w), str(h), str(n), str(gop), str(qp), str(cut),
         str(out), str(timing)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err.decode()[-2000:]

    frames = corpus.make_clip_frames(w, h, SUB, n, seed=31, cut_at=cut)
    meta = Metadata(w, h, SUB)
    cfg = EncoderConfig(quality=quality_percent(qp), gop=gop,
                        rc_mode=RATE_CONTROL_CRF, stable_refresh=gop - 1)
    from dsv1_tpu.models.encoder import Encoder
    enc = Encoder(meta, cfg)
    enc.start()
    seq = enc.encode_stream(frames)
    assert out.read_bytes() == seq
    # the scene cut must have forced the handshake's re-encode leg
    t1 = json.loads((tmp_path / "timing.json.1").read_text())
    assert t1["handshake_rounds"] >= 1


def test_rank_cards_one_card_per_rank(monkeypatch):
    """Every rank opens the one card at the launcher's local rank among
    the cards it can see; with no local rank set the choice is left to
    JAX."""
    from dsv1_tpu.parallel import multihost

    for v in multihost._LOCAL_RANK_VARS + ("CUDA_VISIBLE_DEVICES",):
        monkeypatch.delenv(v, raising=False)
    assert multihost.rank_cards() is None
    for v in multihost._LOCAL_RANK_VARS:
        for r in range(4):
            monkeypatch.setenv(v, str(r))
            assert multihost.rank_cards() == [r]
        monkeypatch.delenv(v)
    # the launcher gave this rank one card of its own: index 0
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    monkeypatch.setenv("SLURM_LOCALID", "3")
    assert multihost.rank_cards() == [0]
    # indices count the visible cards, not the host's
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    assert multihost.rank_cards() == [3]
    monkeypatch.setenv("SLURM_LOCALID", "5")
    assert multihost.rank_cards() == [1]
