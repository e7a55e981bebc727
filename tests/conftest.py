"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Env must be set before the first jax *backend initialization* in the test
process (imports are fine; XLA_FLAGS and the compilation cache are read
lazily when the backend is created).
"""

import os
from pathlib import Path

# force, not setdefault: the tests run on the virtual CPU mesh even on a
# machine whose default JAX platform is a GPU
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent compilation cache: the big GOP-scan graphs take tens of
# seconds to compile on CPU and the CLI tests pay it again in every
# subprocess (the env propagates there via os.environ.copy()).
_CACHE_DIR = str(Path(__file__).resolve().parent.parent / "build"
                 / "jax_cpu_cache")
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", _CACHE_DIR)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.environ["JAX_COMPILATION_CACHE_DIR"])

# Persist every compile (default thresholds skip sub-second compiles,
# so most graphs recompiled on every run — slow on this 1-core host).
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

# XLA:CPU's thunk runtime mmaps a 3-mapping JIT region per *kernel*; a
# full-suite process accumulates ~60k mappings and then segfaults inside
# the next compile when mmap hits vm.max_map_count (65530, measured).
# Dropping executables at module boundaries keeps the count bounded;
# re-JIT afterwards is a fast persistent-cache deserialization.
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_mappings():
    yield
    jax.clear_caches()


# --- smoke tier: `pytest -m smoke` (<60 s) runs one golden test per
# kernel plus one e2e byte-identity, for fast parity checks between
# full-suite runs. Parametrized tests contribute only their first
# collected variant so the tier stays small.
_SMOKE = {
    "test_trunc_div_matches_c",        # C integer semantics (ops/cint.py)
    "test_ueg_codes_match_reference",  # exp-Golomb codes (ops/golomb.py)
    "test_fwd_sbt_p_frames",           # Haar forward (ops/sbt.py)
    "test_inv_sbt_luma_filtered",      # filtered inverse (ops/sbt.py)
    "test_encode_plane_matches_reference",  # quant+HZCC (ops/hzcc.py)
    "test_hme_matches_reference",      # motion estimation (ops/hme.py)
    "test_encoder_gop_crf",            # e2e byte-identity vs reference
    "test_decode_420",                 # bit-exact decode vs reference
    "test_gop_parallel_matches_sequential",  # device GOP path parity
}


def pytest_collection_modifyitems(config, items):
    seen = set()
    for it in items:
        base = it.name.split("[")[0]
        if base in _SMOKE and base not in seen:
            seen.add(base)
            it.add_marker(pytest.mark.smoke)
