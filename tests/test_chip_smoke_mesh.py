"""chip_smoke.py's four-card phase on four of the virtual CPU devices
(tests/conftest.py), at tiny sizes: the GOP mesh encode and decode and
the gop x tile mesh encode, each byte-compared with one device."""

import jax

import chip_smoke

from .test_chip_smoke import TINY


def test_four_card_phase_on_virtual_devices():
    recs = chip_smoke.run_four_cards(jax.devices()[:4], TINY)
    assert [r["phase"] for r in recs] == [
        "hd_gop_mesh_encode", "hd_gop_mesh_decode", "uhd_gop_tile_encode",
        "four_card_memory"]
    assert all(r["parity"] for r in recs), recs
