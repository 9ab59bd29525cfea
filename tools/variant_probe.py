"""Scan-amortized cost of stabilizer VARIANT configs at 1080p — the chain
landmine lesson: measure every shipped path, not just the default."""
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
from video_stab_tpu.core.state import stabilizer_state_init
from video_stab_tpu.core.stabilizer import stabilizer_step_fn

K = 60
H, W = 1080, 1920
pool = jax.device_put(jnp.asarray(_make_pool(H, W)))

CONFIGS = {
    "homography": dict(motion_model="homography", smoothing_radius=15),
    "canvas": dict(enable_virtual_canvas=True, smoothing_radius=15),
    "fade": dict(border_type="fade", border_size=32, smoothing_radius=15),
    "drone": dict(drone_high_freq_mode=True, smoothing_radius=15),
    "kalman": dict(smoothing_method="kalman", smoothing_radius=15),
    "cropzoom": dict(crop_n_zoom=True, border_size=32, smoothing_radius=15),
}

name = sys.argv[1]
params = StabilizerParams(**CONFIGS[name])


def scan(st):
    def body(c, i):
        f = jax.lax.dynamic_index_in_dim(pool, i % 4, keepdims=False)
        c, out, _r = stabilizer_step_fn(params, c, f)
        return c, jnp.mean(out.astype(jnp.float32))
    st, ms = jax.lax.scan(body, st, jnp.arange(K, dtype=jnp.int32))
    return st, jnp.mean(ms)


st = jax.device_put(stabilizer_state_init(params, H, W))
fn = jax.jit(scan, donate_argnums=0)
compiled = fn.lower(st).compile()
st, m = compiled(st)
float(m)
t0 = time.perf_counter()
for _ in range(3):
    st, m = compiled(st)
float(m)
dt = (time.perf_counter() - t0) / (3 * K) * 1e3
print(f"variant {name:12s} {dt:8.4f} ms/frame", flush=True)
