"""Sustained-throughput soak: 14,400 frames through the full 1080p step.

Stability artifact, not a benchmark: per-dispatch host syncs add to the
sustained ms/frame here, so it OVERSTATES compute — bench.py owns
throughput. Checks: no NaN/Inf in outputs or metrics across 60
donated-state dispatches, tracked-feature floor holds, output statistics
stay pinned.

Run:  timeout 3000 python tools/soak_probe.py
"""
import os, sys, time
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
import numpy as np
import jax, jax.numpy as jnp
from video_stab_tpu.utils.cache import enable_compilation_cache
enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
from bench import _make_pool
from video_stab_tpu.core.params import StabilizerParams
from video_stab_tpu.core.stabilizer import (stabilizer_state_init,
                                            stabilizer_analyze_step_fn,
                                            stabilizer_emit_gated_fn)
h, w, K = 1080, 1920, 240
params = StabilizerParams(smoothing_radius=15)
pool = jax.device_put(jnp.asarray(_make_pool(h, w)))

def scan_fn(st, frame_pool):
    def body(carry, i):
        frame = jax.lax.dynamic_index_in_dim(frame_pool, i % 4, keepdims=False)
        carry, met = stabilizer_analyze_step_fn(params, carry, frame)
        carry, out, _r = stabilizer_emit_gated_fn(params, carry)
        return carry, (jnp.mean(out.astype(jnp.float32)), met["n_tracked"])
    st, (means, nt) = jax.lax.scan(body, st, jnp.arange(K, dtype=jnp.int32))
    return st, (jnp.mean(means), jnp.min(nt), jnp.max(means), jnp.min(means))

f = jax.jit(scan_fn, donate_argnums=0)
st = jax.device_put(stabilizer_state_init(params, h, w))
st, m = f(st, pool); jax.block_until_ready(m)
t0 = time.perf_counter()
N = 60  # 60 x 240 = 14400 frames
for d in range(N):
    st, m = f(st, pool)
    mm = [float(x) for x in m]
    if not all(np.isfinite(mm)):
        print(f"DISPATCH {d}: NON-FINITE {mm}"); sys.exit(1)
    if d % 10 == 0:
        dt = (time.perf_counter()-t0)/((d+1)*K)*1e3
        print(f"dispatch {d:3d}: mean={mm[0]:8.3f} min_tracked={mm[1]:.0f} "
              f"out[min,max]=[{mm[3]:.1f},{mm[2]:.1f}] {dt:.3f} ms/frame", flush=True)
dt = (time.perf_counter()-t0)/(N*K)*1e3
print(f"SOAK OK: {N*K} frames, {dt:.3f} ms/frame sustained ({1e3/dt:.1f} fps)")
