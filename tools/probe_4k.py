"""4K component breakdown (scan-amortized) — where does the 4K step's time go?

Run: timeout 900 python tools/probe_4k.py
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

H, W = 2160, 3840
K = 60

from bench import _make_pool
_pool_np = _make_pool(H, W)

from video_stab_tpu.core.params import StabilizerParams
from video_stab_tpu.core.state import stabilizer_state_init
from video_stab_tpu.core.stabilizer import (stabilizer_analyze_step_fn,
                                            stabilizer_emit_gated_fn,
                                            stabilizer_step_fn)

params = StabilizerParams(smoothing_radius=15)
pool = jax.device_put(jnp.asarray(_pool_np))


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
        c = c._replace(emit_idx=jnp.minimum(c.emit_idx, jnp.int32(4)))
        return c, jnp.mean(out.astype(jnp.float32))
    st, means = jax.lax.scan(body, st, jnp.arange(K, dtype=jnp.int32))
    return st, jnp.mean(means)


from video_stab_tpu.ops.color import bgr_to_gray
from video_stab_tpu.ops.resize import resize_bilinear


def scan_gray(img):
    def body(c, i):
        # i-dependent carry chain (one-element flip): a loop-invariant
        # body gets LICM-hoisted and measures the harness floor.
        c = c.at[0, 0, 0].set((i % 2).astype(c.dtype))
        g = resize_bilinear(bgr_to_gray(c.astype(jnp.float32)),
                            params.analysis_height, params.analysis_width)
        return c, jnp.mean(g)
    img, ms = jax.lax.scan(body, img, jnp.arange(K, dtype=jnp.int32))
    return img, jnp.sum(ms)


from video_stab_tpu.ops.warp import similarity_matrix, warp_affine_fast


def scan_warp(img):
    def body(c, i):
        ang = (i.astype(jnp.float32) % 7.0 - 3.0) * 0.003
        m = similarity_matrix(ang * 10.0, ang * 7.0, ang)
        out = warp_affine_fast(c, m)
        return out.astype(jnp.uint8), jnp.float32(0.0)
    img, _ = jax.lax.scan(body, img, jnp.arange(K, dtype=jnp.int32))
    return img, jnp.mean(img.astype(jnp.float32))


def scan_ring(st):
    q = st.frame_ring.shape[0]
    def body(c, i):
        st_ = c
        f = jax.lax.dynamic_index_in_dim(pool, i % 4, keepdims=False)
        fr = jax.lax.dynamic_update_index_in_dim(
            st_.frame_ring, f, i % q, 0)
        return st_._replace(frame_ring=fr), jnp.float32(0.0)
    st, _ = jax.lax.scan(body, st, jnp.arange(K, dtype=jnp.int32))
    return st, jnp.mean(st.frame_ring[0].astype(jnp.float32))


st0 = stabilizer_state_init(params, H, W)
st0 = jax.device_put(st0)
timed("FULL combined step", scan_full, st0)
st0 = jax.device_put(stabilizer_state_init(params, H, W))
timed("analyze step", scan_analyze, st0)
st0 = jax.device_put(stabilizer_state_init(params, H, W))
timed("emit step (gated)", scan_emit, st0)
frame = jax.device_put(jnp.asarray(_pool_np[0]))
timed("gray+resize 4k", scan_gray, frame)
frame = jax.device_put(jnp.asarray(_pool_np[0]))   # prior scan donated it
timed("warp 4k x3 small", scan_warp, frame)
st0 = jax.device_put(stabilizer_state_init(params, H, W))
timed("ring push 4k", scan_ring, st0)
