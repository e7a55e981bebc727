"""The compile-cache rule (dsv1_tpu/utils/cache.py): the environment
variable wins; otherwise build/jax_cache in the checkout."""

import os
import subprocess
import sys
from pathlib import Path

from dsv1_tpu.utils import cache

ROOT = Path(__file__).resolve().parent.parent


def test_env_var_names_the_cache(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV, str(tmp_path / "c"))
    assert cache.cache_dir() == str(tmp_path / "c")


def test_default_cache_is_in_the_checkout(monkeypatch):
    monkeypatch.delenv(cache.ENV, raising=False)
    assert cache.cache_dir() == str(ROOT / "build" / "jax_cache")
    assert (Path(cache.cache_dir()).parent.parent / "dsv1_tpu").is_dir()


def test_compiles_land_in_the_env_dir(tmp_path):
    """A fresh process with the variable set writes its compiled
    program there."""
    target = tmp_path / "cache"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(target))
    code = ("import jax, jax.numpy as jnp\n"
            "from dsv1_tpu.utils.cache import enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "jax.jit(lambda x: jnp.cumsum(x * 7 + 3))(jnp.arange(37))"
            ".block_until_ready()\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == str(target)
    assert any(target.iterdir())


def test_native_library_builds_once_under_threads(tmp_path):
    """Threads that all find the native library missing (a fresh
    checkout, first calls from several threads) each build it and
    rename it into place without tripping over one another; the name
    is keyed by the source's content hash."""
    import hashlib
    import threading

    from dsv1_tpu import bits

    src_text = bits._SRC.read_text()
    out, errs = [], []

    def build():
        try:
            out.append(bits._built(src_text, tmp_path, bits._SRC))
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    tag = hashlib.sha256(src_text.encode()).hexdigest()[:16]
    assert set(out) == {tmp_path / f"libdsvbits-{tag}.so"}
    assert [p.name for p in tmp_path.iterdir()] == [out[0].name]
