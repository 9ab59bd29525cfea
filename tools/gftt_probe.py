"""GFTT cost split on the chip: response / +topk / NMS rounds / full."""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import jax
import jax.numpy as jnp
import numpy as np

from video_stab_tpu.utils.cache import enable_compilation_cache
enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from bench import _make_pool
from video_stab_tpu.ops.color import bgr_to_gray
from video_stab_tpu.ops.features import (_dilate3x3, good_features_to_track,
                                         min_eig_response)
from video_stab_tpu.ops.resize import resize_bilinear

K = 120
pool = _make_pool(1080, 1920)
ga = resize_bilinear(bgr_to_gray(jnp.asarray(pool[0], jnp.float32)), 540, 960)
ga = jax.device_put(ga)

mode = sys.argv[1] if len(sys.argv) > 1 else "full"
ncand = int(sys.argv[2]) if len(sys.argv) > 2 else 2048


def scan(g):
    def body(c, i):
        if mode == "resp":
            r = min_eig_response(c + i.astype(jnp.float32) * 0.0, 3)
            peak = r >= _dilate3x3(r)
            return c, jnp.sum(peak.astype(jnp.int32))
        if mode == "rowtopk":
            r = min_eig_response(c + i.astype(jnp.float32) * 0.0, 3)
            peak = (r >= _dilate3x3(r)) & (r > 0.01 * jnp.max(r))
            cand = jnp.where(peak, r, -1.0)
            rv, ri = jax.lax.top_k(cand, 32)          # (540, 32)
            flat_v = rv.reshape(-1)
            flat_i = (jnp.arange(cand.shape[0])[:, None] * cand.shape[1]
                      + ri).reshape(-1)
            tv, ti = jax.lax.top_k(flat_v, ncand)
            tau = tv[ncand - 1]
            rowcounts = jnp.sum(cand >= tau, axis=1)
            guard = jnp.any(rowcounts > 32)
            return c, jnp.sum(tv) + jnp.sum(flat_i[ti]) * 0.0 \
                + guard.astype(jnp.float32)
        if mode == "topk":
            r = min_eig_response(c + i.astype(jnp.float32) * 0.0, 3)
            peak = (r >= _dilate3x3(r)) & (r > 0.01 * jnp.max(r))
            cand = jnp.where(peak, r, -1.0)
            tv, ti = jax.lax.top_k(cand.reshape(-1), ncand)
            return c, jnp.sum(tv)
        pts, m = good_features_to_track(
            c + i.astype(jnp.float32) * 0.0, max_corners=200,
            quality_level=0.01, min_distance=30.0, block_size=3,
            n_candidates=ncand)
        return c, jnp.sum(m.astype(jnp.int32))
    g, ms = jax.lax.scan(body, g, jnp.arange(K, dtype=jnp.int32))
    return g, jnp.sum(ms)


fn = jax.jit(scan, donate_argnums=0)
compiled = fn.lower(ga).compile()
ga, m = compiled(ga)
float(m)
t0 = time.perf_counter()
for _ in range(3):
    ga, m = compiled(ga)
float(m)
dt = (time.perf_counter() - t0) / (3 * K) * 1e3
print(f"gftt {mode:6s} ncand={ncand} {dt:8.4f} ms", flush=True)
