"""Fit per-op fixed overhead of LK-shaped batched einsums inside lax.scan.

Each scan iteration chains M batched einsums (data-dependent) of the
interp-window shape (N=200, win=15, s=32). If time/iter ~= a + b*M with
large a or b >> the ~30 ns of MAC work, the LK while-loop is overhead-bound
and a fused (Pallas) iteration loop pays.

Run: timeout 600 python tools/lk_op_probe.py
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

N, WIN, S = 200, 15, 32
K = 4000

rng = np.random.default_rng(0)
slab = jax.device_put(jnp.asarray(rng.random((N, S, S), np.float32)))
w0 = jax.device_put(jnp.asarray(rng.random((N, WIN, S), np.float32)))


def make_scan(m):
    def scan_fn(carry):
        slab, w = carry
        def body(c, i):
            slab, w = c
            t = w
            for _ in range(m):
                # (N,win,s) x (N,s,s) -> (N,win,s): the LK interp shape.
                t = jnp.einsum("nis,nst->nit", t, slab,
                               preferred_element_type=jnp.float32)
                t = t / (jnp.max(jnp.abs(t)) + 1.0)   # data dep + renorm
            w = w + 1e-9 * t
            return (slab, w), jnp.float32(0.0)
        c, _ = jax.lax.scan(body, (slab, w), jnp.arange(K, dtype=jnp.int32))
        return c, jnp.mean(c[1])
    return scan_fn


def timed(name, fn, carry, n_iters=3):
    f = jax.jit(fn)
    compiled = f.lower(carry).compile()
    carry2, m = compiled(carry)
    float(np.asarray(m).ravel()[0])
    t0 = time.perf_counter()
    for _ in range(n_iters):
        carry2, m = compiled(carry)
    float(np.asarray(m).ravel()[0])
    dt = (time.perf_counter() - t0) / (n_iters * K) * 1e6
    print(f"{name:28s} {dt:9.3f} us/iter", flush=True)
    return dt


for m in (1, 2, 4, 8):
    timed(f"chain of {m} einsums", make_scan(m), (slab, w0))

# Same but as a while_loop (the LK body's actual control flow).
def make_while(m):
    def fn(carry):
        slab, w = carry
        def cond(c):
            i, slab, w = c
            return i < K
        def body(c):
            i, slab, w = c
            t = w
            for _ in range(m):
                t = jnp.einsum("nis,nst->nit", t, slab,
                               preferred_element_type=jnp.float32)
                t = t / (jnp.max(jnp.abs(t)) + 1.0)
            return i + 1, slab, w + 1e-9 * t
        _, slab, w = jax.lax.while_loop(cond, body, (jnp.int32(0), slab, w))
        return (slab, w), jnp.mean(w)
    return fn

for m in (1, 2, 4):
    timed(f"while chain of {m}", make_while(m), (slab, w0))
