"""Measure the compaction-overflow cliff.

The GOP-parallel path ships quantized planes device-to-host in
compacted form: P planes as capped (run, value) nonzero lists, intra
planes as dense int8 + a capped LL exception list (ops/hzcc.py).
Overflowing a cap re-runs the whole chunk densely — fine if rare, a 2x
compute tax if routine. This sweep records, per qp on the bench corpus
(tests/corpus.make_clip, CIF gop12):

  - the max/mean nonzero density of P planes vs the sparse cap
  - the intra LL exception counts vs the dense-i cap
  - the resulting overflow rate per frame

Output: a markdown table + the measured density
quantiles that size the adaptive cap (ops/hzcc.py sparse_cap).

Run on CPU: JAX_PLATFORMS=cpu python tools/overflow_sweep.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def main():
    import jax
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(os.path.dirname(os.path.dirname(
                          os.path.abspath(__file__))), "build",
                          "jax_cpu_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    from tests import corpus
    from dsv1_tpu.constants import SUBSAMP_420, quality_percent
    from dsv1_tpu.ops.frame import np_yuv_split
    from dsv1_tpu.parallel.gop import block_geometry, build_gop_encoder, \
        crf_quant
    from dsv1_tpu.utils.yuv import frame_size

    w, h, G, N = 352, 288, 12, 24
    yuv = corpus.make_clip(w, h, SUBSAMP_420, N, seed=11)
    fsz = frame_size(w, h, SUBSAMP_420)
    frames = [np_yuv_split(np.frombuffer(yuv[i * fsz:(i + 1) * fsz],
                                         np.uint8), SUBSAMP_420, w, h)
              for i in range(N)]
    packed = np.stack([np.concatenate([np.asarray(p, np.uint8).ravel()
                                       for p in f]) for f in frames])
    C = N // G
    packed = packed.reshape(C, G, -1)
    _, _, nbh, nbv = block_geometry(w, h)

    # quality is a static build arg only for the single-GOP convenience
    # wrapper; run.batch takes quants at RUNTIME — one compile total
    run = build_gop_encoder(SUBSAMP_420, w, h, G, quality_percent(85),
                            stable_refresh=G - 1, compact=0)
    fn = jax.jit(run.batch)
    print("| qp | quant | P nz density max (mean) | sparse cap ovf | "
          "LL exc max | dense-i ovf |")
    print("|---|---|---|---|---|---|")
    for qp in (20, 30, 40, 50, 60, 70, 80, 85, 90, 95):
        quality = quality_percent(qp)
        quants = np.full((C, 2), crf_quant(quality), np.int32)
        blob = fn(packed, np.zeros(C, np.int32),
                  np.zeros((C, nbh * nbv, 2), np.int32),
                  np.zeros(C, np.int32), quants)
        (out_i, outs_p), _ = run.unpack(jax.device_get(blob))
        dens, ovf_s, ll_exc, ovf_d = [], 0, 0, 0
        n_p = n_i = 0
        for c in range(3):
            qv = np.asarray(outs_p["qvals"][c])      # (C, G-1, n)
            n = qv.shape[-1]
            cap = min(n, max(256, n // 128))
            nz = (qv != 0).sum(axis=-1)
            dens.append(nz / n)
            ovf_s += (nz > cap).sum()
            n_p += nz.size
            qi = np.asarray(out_i["qvals"][c])       # (C, n)
            from dsv1_tpu.models.encoder import coef_geometry
            ll_n = int(coef_geometry(SUBSAMP_420, w, h, nbh, nbv)[2][c]
                       .seg_bounds[1])
            # mirror compact_dense_i's fallback condition exactly:
            # ANY |q|>127 outside LL overflows, and LL exceptions only
            # up to the K=min(256, ll_n) cap fit the exception list
            big_ll = (np.abs(qi[:, :ll_n]) > 127).sum(axis=-1)
            big_hi = (np.abs(qi[:, ll_n:]) > 127).sum(axis=-1)
            ll_exc = max(ll_exc, int(big_ll.max()))
            K = min(256, ll_n)
            ovf_d += ((big_hi > 0) | (big_ll > K)).sum()
            n_i += qi.shape[0]
        dens = np.concatenate([d.ravel() for d in dens])
        print(f"| {qp} | {crf_quant(quality)} | "
              f"{dens.max():.4f} ({dens.mean():.4f}) | "
              f"{ovf_s}/{n_p} | {ll_exc} | {ovf_d}/{n_i} |")
        build_gop_encoder.cache_clear()
        jax.clear_caches()


if __name__ == "__main__":
    main()
