"""On-chip component breakdown of the 1080p combined step (scan-amortized).

Each config runs a K-iteration lax.scan of just one component (or the full
step) with donated carry, so per-dispatch host overhead amortizes away and
the timing reflects device compute. Run:  timeout 900 python tools/profile_step.py
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

H, W = 1080, 1920
K = 120

rng = np.random.default_rng(0)
from bench import _make_pool
_pool_np = _make_pool(H, W)
frame = jax.device_put(jnp.asarray(_pool_np[0]))


def timed(name, make_scan, carry, n_iters=3):
    fn = jax.jit(make_scan, donate_argnums=0)
    compiled = fn.lower(carry).compile()
    carry, m = compiled(carry)
    float(np.asarray(m).ravel()[0])
    t0 = time.perf_counter()
    for _ in range(n_iters):
        carry, m = compiled(carry)
    float(np.asarray(m).ravel()[0])
    dt = (time.perf_counter() - t0) / (n_iters * K) * 1e3
    print(f"{name:28s} {dt:8.4f} ms/iter", flush=True)
    return dt


# --- 1. full combined step --------------------------------------------------
from video_stab_tpu.core.params import StabilizerParams
from video_stab_tpu.core.state import stabilizer_state_init
from video_stab_tpu.core.stabilizer import (stabilizer_analyze_step_fn,
                                            stabilizer_emit_gated_fn,
                                            stabilizer_step_fn)

params = StabilizerParams(smoothing_radius=15)
pool = jax.device_put(jnp.asarray(_pool_np))


def scan_full(st):
    def body(c, i):
        f = jax.lax.dynamic_index_in_dim(pool, i % 4, keepdims=False)
        c, out, _r = stabilizer_step_fn(params, c, f)
        return c, jnp.mean(out.astype(jnp.float32))
    st, means = jax.lax.scan(body, st, jnp.arange(K, dtype=jnp.int32))
    return st, jnp.mean(means)


def scan_analyze(st):
    def body(c, i):
        f = jax.lax.dynamic_index_in_dim(pool, i % 4, keepdims=False)
        c, met = stabilizer_analyze_step_fn(params, c, f)
        return c, met["n_tracked"]
    st, ms = jax.lax.scan(body, st, jnp.arange(K, dtype=jnp.int32))
    return st, jnp.sum(ms)


def scan_emit(st):
    def body(c, i):
        c, out, _r = stabilizer_emit_gated_fn(params, c)
        # hold emit cursor back so the ring never runs dry
        c = c._replace(emit_idx=jnp.minimum(c.emit_idx, jnp.int32(4)))
        return c, jnp.mean(out.astype(jnp.float32))
    st, means = jax.lax.scan(body, st, jnp.arange(K, dtype=jnp.int32))
    return st, jnp.mean(means)


# --- 2. warp alone ----------------------------------------------------------
from video_stab_tpu.ops.warp import similarity_matrix, warp_affine_fast


def make_scan_warp(scale):
    def scan_warp(img):
        def body(c, i):
            ang = (i.astype(jnp.float32) % 7.0 - 3.0) * scale
            m = similarity_matrix(ang * 10.0, ang * 7.0, ang)
            out = warp_affine_fast(c, m)
            return out.astype(jnp.uint8), jnp.float32(0.0)
        img, _ = jax.lax.scan(body, img, jnp.arange(K, dtype=jnp.int32))
        return img, jnp.mean(img.astype(jnp.float32))
    return scan_warp

scan_warp = make_scan_warp(0.003)          # +-0.5 deg: small branch
scan_warp_large = make_scan_warp(0.0145)   # +-2.5 deg: large branch


# --- 3. LK + GFTT alone -----------------------------------------------------
from video_stab_tpu.ops.color import bgr_to_gray
from video_stab_tpu.ops.features import good_features_to_track
from video_stab_tpu.ops.lk import lk_track
from video_stab_tpu.ops.resize import resize_bilinear

ga = resize_bilinear(bgr_to_gray(frame.astype(jnp.float32)),
                     params.analysis_height, params.analysis_width)
ga = jax.device_put(ga)
gb = resize_bilinear(bgr_to_gray(jnp.asarray(_pool_np[1], jnp.float32)),
                     params.analysis_height, params.analysis_width)
gb = jax.device_put(gb)
pts0, mask0 = good_features_to_track(
    ga, max_corners=params.max_corners,
    quality_level=params.quality_level,
    min_distance=params.min_distance, block_size=params.block_size)


def scan_lk(carry):
    # Track between two DIFFERENT textured frames. The carry must CHAIN
    # (perturb pts by the result) or the whole LK body is loop-invariant
    # and XLA hoists it out of the scan, timing nothing. Chain with a
    # zero-mean epsilon so the tracked positions stay honest.
    g, g2, pts = carry
    def body(c, i):
        g, g2, pts = c
        curr, st, _err = lk_track(g, g2, pts, mask0)
        pts = pts + 1e-6 * (curr - pts)    # data dependence, ~no drift
        return (g, g2, pts), jnp.sum(st.astype(jnp.int32))
    c, ms = jax.lax.scan(body, (g, g2, pts), jnp.arange(K, dtype=jnp.int32))
    return c, jnp.sum(ms)


def scan_gftt(g):
    def body(c, i):
        pts, m = good_features_to_track(
            c, max_corners=params.max_corners,
            quality_level=params.quality_level,
            min_distance=params.min_distance, block_size=params.block_size)
        return c + 0.0 * pts[0, 0], jnp.sum(m.astype(jnp.int32))
    g, ms = jax.lax.scan(body, g, jnp.arange(K, dtype=jnp.int32))
    return g, jnp.sum(ms)


params_nodetect = StabilizerParams(smoothing_radius=15,
                                   redetect_interval=1_000_000)


def scan_analyze_nodetect(st):
    def body(c, i):
        f = jax.lax.dynamic_index_in_dim(pool, i % 4, keepdims=False)
        c, met = stabilizer_analyze_step_fn(params_nodetect, c, f)
        return c, met["n_tracked"]
    st, ms = jax.lax.scan(body, st, jnp.arange(K, dtype=jnp.int32))
    return st, jnp.sum(ms)


def scan_ransac(carry):
    from video_stab_tpu.motion.estimate import estimate_similarity_ransac
    pts, key = carry
    def body(c, i):
        pts, key = c
        key, sub = jax.random.split(key)
        t, ok, inl = estimate_similarity_ransac(
            pts, pts + 0.5, mask0, sub, threshold=5.0, n_hypotheses=500)
        return (pts + 0.0 * t[0, 0], key), jnp.sum(inl.astype(jnp.int32))
    c, ms = jax.lax.scan(body, (pts, key), jnp.arange(K, dtype=jnp.int32))
    return c, jnp.sum(ms)


grays = []
for _f in _pool_np:
    grays.append(resize_bilinear(bgr_to_gray(jnp.asarray(_f, jnp.float32)),
                                 params.analysis_height,
                                 params.analysis_width))
grays_stack = jax.device_put(jnp.stack(grays))      # (4, Ha, Wa)


def scan_lk_pairs(carry):
    """LK over the SAME frame pairs the analyze scan tracks (i%4 ->
    (i+1)%4, including the large wrap-around 3->0 shift) with real
    detected points — the in-context convergence cost."""
    gs, pts = carry
    def body(c, i):
        gs, pts = c
        a = jax.lax.dynamic_index_in_dim(gs, i % 4, keepdims=False)
        b = jax.lax.dynamic_index_in_dim(gs, (i + 1) % 4, keepdims=False)
        curr, st, _err = lk_track(a, b, pts, mask0)
        return (gs, pts), jnp.sum(st.astype(jnp.int32)) \
            + 0.0 * jnp.sum(curr)
    c, ms = jax.lax.scan(body, (gs, pts), jnp.arange(K, dtype=jnp.int32))
    return c, jnp.sum(ms)


def scan_analyze_warm(st):
    """analyze with a PROPERLY INITIALIZED state (points detected on
    frame 0) — the earlier analyze probes started from a zero state."""
    from video_stab_tpu.core.stabilizer import stabilizer_init_step_fn
    st = stabilizer_init_step_fn(params, st, jnp.asarray(_pool_np[0]))
    def body(c, i):
        f = jax.lax.dynamic_index_in_dim(pool, i % 4, keepdims=False)
        c, met = stabilizer_analyze_step_fn(params, c, f)
        return c, met["n_tracked"]
    st, ms = jax.lax.scan(body, st, jnp.arange(K, dtype=jnp.int32))
    return st, jnp.sum(ms)


def scan_gray_resize(f):
    def body(c, i):
        # i-dependent carry chain: a loop-invariant body gets hoisted out
        # of the scan by XLA LICM and measures the harness floor (the
        # 'hoisted, fake' failure the scan_lk comment documents). One
        # element flips per iteration — negligible cost, defeats LICM.
        c = c.at[0, 0, 0].set((i % 2).astype(c.dtype))
        g = resize_bilinear(bgr_to_gray(c.astype(jnp.float32)),
                            params.analysis_height, params.analysis_width)
        return c, jnp.mean(g)
    f, ms = jax.lax.scan(body, f, jnp.arange(K, dtype=jnp.int32))
    return f, jnp.mean(ms)


def scan_analyze_patched(st):
    """analyze with RANSAC stubbed to identity — isolates its in-context
    cost (run with mode=analyze_nr)."""
    import video_stab_tpu.core.stabilizer as stab_mod

    def fake_ransac(prev, curr, mask, key, threshold=5.0,
                    n_hypotheses=500):
        m = jnp.asarray([[1.0, 0.0, 0.1], [0.0, 1.0, 0.1]], jnp.float32)
        return m + 0.0 * prev[0, 0], jnp.asarray(True), mask

    orig = stab_mod.estimate_similarity_ransac
    stab_mod.estimate_similarity_ransac = fake_ransac
    try:
        def body(c, i):
            f = jax.lax.dynamic_index_in_dim(pool, i % 4, keepdims=False)
            c, met = stabilizer_analyze_step_fn(params_nodetect, c, f)
            return c, met["n_tracked"]
        st, ms = jax.lax.scan(body, st, jnp.arange(K, dtype=jnp.int32))
    finally:
        stab_mod.estimate_similarity_ransac = orig
    return st, jnp.sum(ms)


def scan_ringwrite(carry):
    """Isolated cost of the look-ahead ring DUS inside a donated scan
    carry (the frame_ring.at[n % q].set(frame) pattern)."""
    ring, n = carry
    def body(c, i):
        ring, n = c
        f = jax.lax.dynamic_index_in_dim(pool, i % 4, keepdims=False)
        ring = jax.lax.dynamic_update_index_in_dim(ring, f, n % 16, 0)
        return (ring, n + 1), jnp.float32(0.0)
    c, _ = jax.lax.scan(body, (ring, n), jnp.arange(K, dtype=jnp.int32))
    ring, n = c
    return c, jnp.sum(ring[0, 0, 0].astype(jnp.float32))


if __name__ == "__main__":
    import sys
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "warp"):
        timed("warp 1080p x3 (u8 gather)", scan_warp, jnp.array(frame))
    if which in ("all", "warp_large"):
        timed("warp large-branch", scan_warp_large, jnp.array(frame))
    if which in ("all", "lk"):
        timed("LK 200pts 2lvl 20it", scan_lk,
              (jnp.array(ga), jnp.array(gb), jnp.array(pts0)))
    if which in ("all", "gftt"):
        timed("GFTT 200", scan_gftt, jnp.array(ga))
    if which in ("all", "gray"):
        timed("gray+resize", scan_gray_resize, jnp.array(frame))
    if which in ("all", "analyze"):
        st = jax.device_put(stabilizer_state_init(params, H, W))
        timed("analyze step", scan_analyze, st)
    if which in ("all", "analyze_nod"):
        st = jax.device_put(stabilizer_state_init(params_nodetect, H, W))
        timed("analyze no-redetect", scan_analyze_nodetect, st)
    if which in ("all", "ransac"):
        import jax.random as jr
        timed("RANSAC 500x200", scan_ransac,
              (jnp.array(pts0), jr.PRNGKey(0)))
    if which == "lk_pairs":
        timed("LK in-context pairs", scan_lk_pairs,
              (jnp.array(grays_stack), jnp.array(pts0)))
    if which == "analyze_warm":
        st = jax.device_put(stabilizer_state_init(params, H, W))
        timed("analyze warm-init", scan_analyze_warm, st)
    if which == "ringwrite":
        ring0 = jnp.zeros((16, H, W, 3), jnp.uint8)
        timed("ring DUS write", scan_ringwrite,
              (jax.device_put(ring0), jnp.int32(0)))
    if which == "analyze_nr":
        st = jax.device_put(stabilizer_state_init(params_nodetect, H, W))
        timed("analyze nodet noransac", scan_analyze_patched, st)
    if which in ("all", "emit"):
        st = jax.device_put(stabilizer_state_init(params, H, W))
        # preload the ring so emit has frames
        from video_stab_tpu.core.stabilizer import stabilizer_step_fn as s
        timed("emit step (gated)", scan_emit, st)
    if which in ("all", "full"):
        st = jax.device_put(stabilizer_state_init(params, H, W))
        timed("FULL combined step", scan_full, st)
