"""Multi-host GOP-sharded encode (SURVEY.md §5, BASELINE config 5).

Closed GOPs with per-GOP metadata re-emit (reference dsv_encoder.c:624-652)
make GOP ranges fully independent under CRF: each host encodes a contiguous
slice of GOPs against only its own frames, and the only cross-host state is
the packet prev-link of the shard boundary picture (dsv_encoder.c:170-192)
— an O(1) patch per boundary at mux time. The muxed stream is byte-identical
to a single-host encode of the whole sequence (tested).

Usage (one process per host):

    jax.distributed.initialize(...)           # standard JAX multi-process
    shard = encode_shard(my_frames, meta, cfg,
                         first_gop=my_first_gop, total_frames=N)
    # gather EncodedShard parts on host 0 (any transport), then:
    stream = mux_shards(parts, meta)

`shard_ranges` splits a sequence into per-host GOP ranges;
`encode_stream_multihost` runs the whole flow in one process (test/driver
convenience — the per-shard encodes are what each host would run).
"""

import os
from dataclasses import dataclass

from ..constants import GOP_INTRA, RATE_CONTROL_CRF, div_round
from ..models.bitstream import encode_eos_packet
from ..models.encoder import EncoderConfig
from ..models.metadata import Metadata
from .gop import encode_stream_gops

# byte offset of the prev-link field in a packet header (B.1)
_PREV_OFF = 6


@dataclass
class EncodedShard:
    """One host's partial stream: its GOP range's packets, no EOS."""
    data: bytes
    last_pic_len: int   # prev-link seed for the next shard's first picture
    first_gop: int
    # final stability-accumulator state ((nblk, 2) int32, refresh_ctr) —
    # the next shard's stab_init for byte-exactness when the boundary
    # doesn't land on a stability refresh (parallel/gop.py _StabReplay)
    stab_final: tuple | None = None


def shard_ranges(n_frames: int, gop: int, n_shards: int):
    """Split n_frames into n_shards contiguous GOP ranges.

    Returns [(first_gop, first_frame, n_frames_in_shard)] — empty shards
    (more hosts than GOPs) get zero frames.
    """
    G = max(gop, 1) if gop != GOP_INTRA else 1
    ngops = div_round(n_frames, G)
    per = div_round(ngops, n_shards)
    out = []
    for s in range(n_shards):
        g0 = min(s * per, ngops)
        g1 = min(g0 + per, ngops)
        f0 = g0 * G
        f1 = min(g1 * G, n_frames)
        out.append((g0, f0, max(f1 - f0, 0)))
    return out


def encode_shard(frames, meta: Metadata, cfg: EncoderConfig,
                 first_gop: int, mesh=None,
                 gops_per_device: int = 0,
                 stab_init: tuple | None = None) -> EncodedShard:
    """Encode one host's GOP slice. frames must start at a GOP boundary
    (frame number first_gop * cfg.gop). CRF only, like the GOP-parallel
    path it wraps.

    stab_init: the previous shard's EncodedShard.stab_final. With it the
    shard is byte-identical to its slice of a single-host encode in all
    cases; without it (concurrent hosts encoding optimistically) the
    shard assumes its first GOP starts at a stability refresh — exact
    whenever stable_refresh divides into the shard boundary's P-frame
    count (the steady state for the CLI default stable_refresh = gop-1,
    broken only by a forced-intra frame in the predecessor's last
    refresh window)."""
    if cfg.rc_mode != RATE_CONTROL_CRF:
        raise ValueError("multi-host GOP sharding requires CRF")
    G = max(cfg.gop, 1) if cfg.gop != GOP_INTRA else 1
    data, last, stab = encode_stream_gops(
        frames, meta, cfg, mesh=mesh, gops_per_device=gops_per_device,
        _fnum_base=first_gop * G, _emit_eos=False, _return_state=True,
        _stab_init=stab_init)
    return EncodedShard(data=data, last_pic_len=last, first_gop=first_gop,
                        stab_final=stab)


def _patch_first_prev(data: bytearray, meta_len: int, prev_link: int):
    """Patch the prev-link of the shard's first picture packet (it sits
    right after the leading metadata packet)."""
    off = meta_len + _PREV_OFF
    if len(data) >= off + 4:
        data[off:off + 4] = prev_link.to_bytes(4, "big")


def mux_shards(parts, meta: Metadata) -> bytes:
    """Concatenate per-host partial streams into one .dsv stream:
    boundary prev-link patches + final EOS packet."""
    from ..models.bitstream import encode_metadata_packet

    parts = sorted((p for p in parts if p.data), key=lambda p: p.first_gop)
    meta_len = len(encode_metadata_packet(meta))
    out = bytearray()
    prev = 0
    for p in parts:
        d = bytearray(p.data)
        _patch_first_prev(d, meta_len, prev)
        out += d
        prev = p.last_pic_len
    out += encode_eos_packet(prev)
    return bytes(out)


# launcher variables that give a process its rank among those on its
# host: torchrun-style launchers, SLURM, Open MPI
_LOCAL_RANK_VARS = ("LOCAL_RANK", "SLURM_LOCALID",
                    "OMPI_COMM_WORLD_LOCAL_RANK")


def rank_cards():
    """Local device ids for one rank: the one card at the launcher's
    local rank, counted among the cards the process can see
    (CUDA_VISIBLE_DEVICES; a launcher that gives each rank its own card
    lists one, index 0). Without this every rank on a multi-GPU host
    would open every card and reserve its memory. Where no local rank is
    set, None leaves the choice to JAX (JAX_LOCAL_DEVICE_IDS, its own
    cluster detection, or every card). The ids only restrict CUDA/ROCm
    devices, so the CPU ignores them."""
    local_rank = next((int(os.environ[v]) for v in _LOCAL_RANK_VARS
                       if os.environ.get(v, "").isdigit()), None)
    if local_rank is None:
        return None
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible:
        return [local_rank % len(visible.split(","))]
    return [local_rank]


def run_distributed_shard(coordinator: str, num_processes: int,
                          process_id: int, frames_all, meta: Metadata,
                          cfg: EncoderConfig, out_path=None):
    """One process of the REAL multi-process flow (SURVEY.md §5,
    BASELINE config 5): `jax.distributed.initialize` + allgather over the
    distributed backend for shard exchange, optimistic
    stability handshake, mux on rank 0.

    Every rank encodes its GOP range concurrently with zero-init
    stability accumulators, then ranks exchange final accumulator states
    and any rank whose predecessor did NOT end at a stability refresh
    re-encodes with the true carried state (parallel/gop.py _StabReplay
    semantics); repeated until a fixed point — at most num_processes-1
    rounds, and zero extra rounds on refresh-aligned boundaries (the CLI
    default stable_refresh = gop-1 pairing). The muxed stream is
    byte-identical to a single-process encode in all cases.

    frames_all: the full frame list (each rank encodes only its range —
    a real deployment passes only the local slice). Returns the muxed
    stream on rank 0 (also written to out_path if given), else None.
    Timing breakdown is returned via the second tuple element:
    (encode_seconds, handshake_rounds, mux_seconds) for scaling-
    efficiency reporting (the mux is the only serial work,
    dsv_encoder.c:170-192). On a GPU host each rank opens one card, the
    one at the launcher's local rank (rank_cards).
    """
    import time

    import jax
    import numpy as np

    jax.distributed.initialize(coordinator, num_processes, process_id,
                               local_device_ids=rank_cards())
    from jax.experimental import multihost_utils

    from .gop import block_geometry

    # Establish the collective (Gloo) context NOW, while every rank is
    # still synchronized from initialize(): Gloo's context creation
    # inside the first allgather has a hard ~30 s KV-rendezvous
    # deadline, and the encode phases below can skew ranks by minutes
    # (compile times differ per rank). Once the context exists,
    # subsequent collectives block on connected sockets without that
    # deadline.
    multihost_utils.process_allgather(np.zeros(1, np.int32))

    ranges = shard_ranges(len(frames_all), cfg.gop, num_processes)
    g0, f0, nf = ranges[process_id]
    nbh, nbv = block_geometry(meta.width, meta.height)[2:]
    nblk = nbh * nbv
    G = max(cfg.gop, 1) if cfg.gop != GOP_INTRA else 1
    sr = cfg.stable_refresh or max(1, min(G - 1, 14))

    t0 = time.perf_counter()
    shard = (encode_shard(frames_all[f0:f0 + nf], meta, cfg, first_gop=g0)
             if nf else None)
    enc_s = time.perf_counter() - t0

    def stab_blob(sh):
        if sh is None:
            return np.zeros(nblk * 2 + 1, np.int32)
        return np.concatenate([np.asarray(sh.stab_final[0],
                                          np.int32).reshape(-1),
                               np.asarray([sh.stab_final[1]], np.int32)])

    # optimistic handshake: fixed point over carried accumulator states
    my_init = np.zeros(nblk * 2 + 1, np.int32)
    rounds = 0
    while True:
        all_stabs = multihost_utils.process_allgather(stab_blob(shard))
        desired = np.zeros(nblk * 2 + 1, np.int32)
        if process_id > 0 and nf:
            prev = all_stabs[process_id - 1]
            if 0 < int(prev[-1]) < sr:
                desired = prev
        changed = not np.array_equal(desired, my_init)
        anyc = multihost_utils.process_allgather(
            np.asarray([changed], np.int32))
        if not anyc.any():
            break
        rounds += 1
        if changed:
            my_init = desired
            t0 = time.perf_counter()
            shard = encode_shard(
                frames_all[f0:f0 + nf], meta, cfg, first_gop=g0,
                stab_init=(my_init[:-1].reshape(nblk, 2), int(my_init[-1])))
            enc_s += time.perf_counter() - t0

    # gather the shard payloads (lengths first, then padded bytes)
    data = (np.frombuffer(shard.data, np.uint8) if shard
            else np.zeros(0, np.uint8))
    lens = multihost_utils.process_allgather(
        np.asarray([data.size, shard.last_pic_len if shard else 0],
                   np.int64))
    L = max(1, int(lens[:, 0].max()))
    padded = np.zeros(L, np.uint8)
    padded[:data.size] = data
    alldata = multihost_utils.process_allgather(padded)

    stream = None
    mux_s = 0.0
    if process_id == 0:
        t0 = time.perf_counter()
        parts = [EncodedShard(alldata[r][:int(lens[r, 0])].tobytes(),
                              int(lens[r, 1]), first_gop=ranges[r][0])
                 for r in range(num_processes) if int(lens[r, 0])]
        stream = mux_shards(parts, meta)
        mux_s = time.perf_counter() - t0
        if out_path is not None:
            with open(out_path, "wb") as f:
                f.write(stream)
    return stream, (enc_s, rounds, mux_s)


def encode_stream_multihost(frames, meta: Metadata,
                            cfg: EncoderConfig | None = None,
                            n_shards: int = 2, mesh=None) -> bytes:
    """Single-process driver for the multi-host flow: encode each shard's
    GOP range independently (exactly what each host would run), then mux.
    Byte-identical to encode_stream_gops over the whole sequence."""
    cfg = cfg or EncoderConfig()
    frames = list(frames)
    parts = []
    stab = None
    for g0, f0, nf in shard_ranges(len(frames), cfg.gop, n_shards):
        if nf == 0:
            continue
        parts.append(encode_shard(frames[f0:f0 + nf], meta, cfg,
                                  first_gop=g0, mesh=mesh, stab_init=stab))
        stab = parts[-1].stab_final
    return mux_shards(parts, meta)
