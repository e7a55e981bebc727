"""Build dist/dsv1.pyz — single-file distribution of the codec.

The analog of the reference's header-only amalgamation (dsv1.h,
reference dsv1.h:40-157): one artifact a user can ship and run with just
a Python + JAX environment. The native bit-serial helper self-builds on
first use from package data into ~/.cache/dsv1_tpu (bits/__init__.py).

Usage:  python tools/make_zipapp.py
        python dist/dsv1.pyz e -inp_in.yuv -out_out.dsv -w352 -h288 ...
"""
import shutil
import tempfile
import zipapp
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def build(out: Path | None = None) -> Path:
    out = out or ROOT / "dist" / "dsv1.pyz"
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        stage = Path(td)
        shutil.copytree(ROOT / "dsv1_tpu", stage / "dsv1_tpu",
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      "*.so", "Makefile"))
        (stage / "__main__.py").write_text(
            "import sys\nfrom dsv1_tpu.cli import main\n"
            "sys.exit(main())\n")
        zipapp.create_archive(stage, out, interpreter="/usr/bin/env python3")
    return out


if __name__ == "__main__":
    print(build())
