"""Single-file distribution (tools/make_zipapp.py): the .pyz runs the
full CLI out of the archive, including the self-building native helper
(the dsv1.h-amalgamation analog, reference dsv1.h:40-157)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from dsv1_tpu.constants import SUBSAMP_420
from dsv1_tpu.utils.yuv import frame_size

from . import corpus, oracle

ROOT = Path(__file__).resolve().parent.parent


def test_zipapp_cli_roundtrip(tmp_path):
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import make_zipapp
        pyz = make_zipapp.build(tmp_path / "dsv1.pyz")
    finally:
        sys.path.pop(0)

    w, h, n = 48, 32, 4
    yuv = corpus.make_clip(w, h, SUBSAMP_420, n, seed=2)
    inp = tmp_path / "in.yuv"
    inp.write_bytes(yuv)
    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    env["XDG_CACHE_HOME"] = str(tmp_path / "cache")
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   str(ROOT / "build" / "jax_cpu_cache"))
    out = tmp_path / "out.dsv"
    r = subprocess.run(
        [sys.executable, str(pyz), "e", f"-inp_{inp}", f"-out_{out}",
         f"-w{w}", f"-h{h}", "-fmt2", f"-nfr{n}", "-gop2", "-qp85",
         "-rc_mode1", "-y"],
        capture_output=True, text=True, env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    # the reference binary must accept the stream
    oracle.build_oracle()
    dec = tmp_path / "dec.yuv"
    r2 = subprocess.run([str(oracle.BIN), "d", f"-inp_{out}",
                         f"-out_{dec}", "-y"], capture_output=True)
    assert r2.returncode == 0
    assert len(dec.read_bytes()) == n * frame_size(w, h, SUBSAMP_420)
