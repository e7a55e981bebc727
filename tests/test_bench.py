"""bench.py's helpers on the CPU at a tiny size: the parity check against
the sequential codec, the chunk executable the device-only points time,
and the refusal to measure without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import bench

ROOT = Path(__file__).resolve().parent.parent


def test_parity_and_chunk_executable_at_tiny_size():
    pt = bench._mk_point(48, 32, 14, "tiny")
    assert bench._parity(pt)
    fn, args, frames = bench.chunk_executable(pt)
    assert frames == 4 * bench.G  # chunk sizing caps at 4 GOPs
    blob = fn(*args)
    blob.block_until_ready()
    assert blob.shape[0] == 4


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "bench.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"metric"' not in r.stdout
    assert "no GPU" in r.stderr


def test_dense_chunk_executable_at_tiny_size():
    """The dense variant trace_chunk.py --dense times: same chunk, the
    uncompacted int32 outputs."""
    pt = bench._mk_point(48, 32, 14, "tiny")
    fn, args, frames = bench.chunk_executable(pt)
    fd, args_d, frames_d = bench.chunk_executable(pt, dense=True)
    assert frames_d == frames and fd is not fn
    compact, dense = fn(*args), fd(*args_d)
    assert dense.shape[0] == compact.shape[0] == 4
    assert dense.size > compact.size
