"""chip_smoke.py and its parity helper (dsv1_tpu/utils/parity.py) on
the CPU at tiny sizes. The script itself needs a GPU: here it must
refuse to run. Its phases are plain functions, so the same code that
runs on the card runs here on small shapes (the four-card phase is in
test_chip_smoke_mesh.py)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke
from dsv1_tpu.constants import SUBSAMP_420
from dsv1_tpu.models.metadata import Metadata
from dsv1_tpu.parallel import decode_stream_gops, encode_stream_gops
from dsv1_tpu.utils import parity

ROOT = Path(__file__).resolve().parent.parent
TINY = {"cif": (64, 48, 24), "hd": (96, 64, 36), "uhd": (128, 96, 24)}


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_parity_helper_matches_device_paths():
    w, h = 48, 32
    _, frames = chip_smoke.clip(w, h, 14)
    meta = Metadata(w, h, SUBSAMP_420)
    cfg = chip_smoke.crf_config()
    stream = encode_stream_gops(frames, meta, cfg)
    assert parity.reference_encode(frames, meta, cfg) == stream
    ref = parity.reference_decode(stream)
    _, got = decode_stream_gops(stream)
    assert [f for f, _ in ref] == list(range(14))
    assert parity.same_decode(got, ref)
    assert parity.same_decode(parity.reference_decode(stream, 5), ref[:5])
    # one changed pixel, or one missing frame, is a mismatch
    bad = [(f, [np.array(p) for p in planes]) for f, planes in ref]
    bad[3][1][0][1, 2] ^= 1
    assert not parity.same_decode(got, bad)
    assert not parity.same_decode(got[:-1], ref)
    assert len(parity.frames_bytes(ref)) == 14 * (w * h * 3 // 2)


def test_one_card_phases_at_tiny_size(capsys):
    recs = chip_smoke.run_one_card(TINY)
    names = [r["phase"] for r in recs]
    assert names == ["cif_crf_encode", "cif_abr_encode", "hd_crf_encode",
                     "cif_crf_decode", "cif_abr_decode", "hd_crf_decode",
                     "cli_roundtrip"]
    assert all(r.get("ok", r["parity"]) for r in recs), recs
    assert all(r["path"] == "batched" for r in recs if "path" in r)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)["phase"] for ln in lines[-7:]] == names
