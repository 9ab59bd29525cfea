"""Does LK's all-points early exit ever fire on textured content?

Times lk_track at several iteration budgets over the bench pool's frame
pairs. If time scales ~linearly with the budget, the loop is budget-bound
(a straggler point always holds it); if flat, the early exit fires.

Run: timeout 600 python tools/lk_budget_probe.py
"""
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
from video_stab_tpu.core.params import StabilizerParams
from video_stab_tpu.ops.color import bgr_to_gray
from video_stab_tpu.ops.features import good_features_to_track
from video_stab_tpu.ops.lk import lk_track
from video_stab_tpu.ops.resize import resize_bilinear

H, W = 1080, 1920
K = 240
params = StabilizerParams(smoothing_radius=15)
_pool_np = _make_pool(H, W)

grays = [resize_bilinear(bgr_to_gray(jnp.asarray(f, jnp.float32)),
                         params.analysis_height, params.analysis_width)
         for f in _pool_np]
gs = jax.device_put(jnp.stack(grays))
pts0, mask0 = good_features_to_track(
    gs[0], max_corners=params.max_corners,
    quality_level=params.quality_level,
    min_distance=params.min_distance, block_size=params.block_size)
pts0 = jax.device_put(pts0)
mask0 = jax.device_put(mask0)


def make_scan(iters):
    def scan_fn(carry):
        gs, pts = carry
        def body(c, i):
            gs, pts = c
            a = jax.lax.dynamic_index_in_dim(gs, i % 4, keepdims=False)
            b = jax.lax.dynamic_index_in_dim(gs, (i + 1) % 4,
                                             keepdims=False)
            # Track the CARRIED pts (not the pts0 constant) so the chain
            # update below is live and iterations are data-dependent —
            # otherwise LICM/overlap make the scan measure fake-fast.
            curr, st, _err = lk_track(a, b, pts, mask0, iters=iters)
            pts = pts + 1e-6 * (curr - pts)
            return (gs, pts), jnp.sum(st.astype(jnp.int32))
        c, ms = jax.lax.scan(body, (gs, pts),
                             jnp.arange(K, dtype=jnp.int32))
        return c, jnp.sum(ms)
    return scan_fn


def timed(name, fn, carry, n_iters=3):
    f = jax.jit(fn)
    compiled = f.lower(carry).compile()
    c2, m = compiled(carry)
    float(np.asarray(m).ravel()[0])
    t0 = time.perf_counter()
    for _ in range(n_iters):
        # Chain reps through the carry (TIMING RULE, warp_tile_probe.py):
        # data-independent repeats overlap on this runtime and
        # under-measure by large factors.
        c2, m = compiled(c2)
    float(np.asarray(m).ravel()[0])
    dt = (time.perf_counter() - t0) / (n_iters * K) * 1e3
    print(f"{name:28s} {dt:8.4f} ms/iter", flush=True)


for iters in (20, 12, 8, 4):
    timed(f"lk iters={iters}", make_scan(iters), (gs, pts0))

# Convergence drift check: positions at iters=20 vs 8 on one pair.
c20, s20, _ = lk_track(gs[0], gs[1], pts0, mask0, iters=20)
c8, s8, _ = lk_track(gs[0], gs[1], pts0, mask0, iters=8)
d = np.asarray(jnp.linalg.norm(c20 - c8, axis=1))
valid = np.asarray(s20 & s8)
print(f"pos drift 20->8 iters: median {np.median(d[valid]):.4f} px, "
      f"p95 {np.percentile(d[valid], 95):.4f}, max {d[valid].max():.4f}, "
      f"status match {(np.asarray(s20) == np.asarray(s8)).mean():.3f}")
