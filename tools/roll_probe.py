"""Roll-correction stage cost split at 1080p (analysis at 0.25 scale).

K must be large enough to amortize the per-call dispatch overhead. Run
mode `floor` to see the scan harness's own floor and subtract it from any
stage number.
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

import math

from bench import _make_pool
from video_stab_tpu.core.params import RollCorrectionParams
from video_stab_tpu.core.rollcorrection import estimate_roll_angle, roll_state_init
from video_stab_tpu.ops.canny import canny_edges
from video_stab_tpu.ops.color import bgr_to_gray
from video_stab_tpu.ops.hough import hough_lines
from video_stab_tpu.ops.resize import resize_bilinear

K = 600
pool = _make_pool(1080, 1920)
params = RollCorrectionParams()
gray = resize_bilinear(bgr_to_gray(jnp.asarray(pool[0], jnp.float32)),
                       270, 480)
gray = jax.device_put(gray)
edges0 = jax.device_put(canny_edges(gray, 50.0, 150.0))

mode = sys.argv[1] if len(sys.argv) > 1 else "full"


def scan(c0):
    def body(c, i):
        if mode == "floor":
            return c, jnp.sum(c + 0.0 * i.astype(jnp.float32))
        if mode == "canny":
            e = canny_edges(c + 0.0 * i.astype(jnp.float32), 50.0, 150.0)
            return c, jnp.sum(e.astype(jnp.float32))
        if mode == "hough":
            lines, votes, m = hough_lines(
                c + 0.0 * i.astype(jnp.float32), threshold=100,
                max_lines=256,
                theta_range=(math.radians(80.0), math.radians(100.0)))
            return c, jnp.sum(votes)
        st = roll_state_init()
        st = estimate_roll_angle(
            params, st,
            (c + 0.0 * i.astype(jnp.float32)))
        return c, st.smoothed_angle
    c0, ms = jax.lax.scan(body, c0, jnp.arange(K, dtype=jnp.int32))
    return c0, jnp.sum(ms)


inp = edges0 if mode == "hough" else (
    gray if mode == "canny" else jax.device_put(
        jnp.asarray(pool[0], jnp.float32)))
fn = jax.jit(scan, donate_argnums=0)
compiled = fn.lower(inp).compile()
inp, m = compiled(inp)
float(m)
t0 = time.perf_counter()
for _ in range(3):
    inp, m = compiled(inp)
float(m)
dt = (time.perf_counter() - t0) / (3 * K) * 1e3
print(f"roll {mode:6s} {dt:8.4f} ms", flush=True)
