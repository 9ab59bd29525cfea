"""Incremental O(window) trajectory filters over ring buffers.

The reference re-smooths the FULL cumulative path on every emitted frame
(src/Stabilizer.cpp:783-839 — O(N*r) per frame on the CPU) but only consumes
the smoothed value at the single emitted index. Because every smoother's
output at index i depends on a bounded window of the path (box/gaussian) or
only on the past (kalman/butterworth), the emitted values are reproduced
EXACTLY from a fixed ring buffer of recent path samples — O(window) per frame,
fully static shapes, and the whole state stays on the device.

Filter semantics replicated bit-for-bit-in-float32:
- box:      Stabilizer.cpp:1139-1172 (count-normalized clamped window; identity
            when n <= r; radius clamped to [2,8] normal / [10,50] drone mode).
- gaussian: Stabilizer.cpp:1364-1413 (ksize = max(3, ceil(6*sigma)) odd;
            reflect-101 left padding, reflect-with-edge right padding).
- kalman:   Stabilizer.cpp:1416-1458 (2-state constant-velocity forward pass,
            q = 0.01, r = 0.1, P0 = 0 — cv::KalmanFilter zero-init).
- butterworth cascade: Stabilizer.cpp:2014-2041 (repeated first-order IIR).
- adaptive radius: Stabilizer.cpp:1637-1673.
"""

from __future__ import annotations

import math

import jax.numpy as jnp


def ring_push(ring: jnp.ndarray, n: jnp.ndarray, value: jnp.ndarray) -> jnp.ndarray:
    """Store value for absolute index n at slot n % RING."""
    return ring.at[n % ring.shape[0]].set(value)


def ring_get(ring: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Fetch absolute index idx (caller guarantees idx >= n - RING)."""
    return ring[idx % ring.shape[0]]


def box_filter_emit(ring: jnp.ndarray, n_path: jnp.ndarray, emit_idx: jnp.ndarray,
                    radius: jnp.ndarray, r_max: int) -> jnp.ndarray:
    """Emitted value of the reference box filter at ``emit_idx``.

    ring: (RING, C) path ring; n_path: current path length; radius: dynamic
    (already clamped) radius; r_max: static bound on radius.
    """
    offs = jnp.arange(-r_max, r_max + 1)
    idx = emit_idx + offs
    valid = (jnp.abs(offs) <= radius) & (idx >= 0) & (idx <= n_path - 1)
    vals = ring_get(ring, jnp.clip(idx, 0, None))  # (W, C)
    w = valid.astype(ring.dtype)[:, None]
    mean = jnp.sum(vals * w, axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    # path.size() <= r -> identity (Stabilizer.cpp:1148-1150).
    return jnp.where(n_path <= radius, ring_get(ring, emit_idx), mean)


def gaussian_kernel(sigma: float) -> jnp.ndarray:
    """The reference's gaussian kernel (Stabilizer.cpp:1368-1386)."""
    ksize = max(3, int(math.ceil(6 * sigma)))
    if ksize % 2 == 0:
        ksize += 1
    c = ksize // 2
    xs = jnp.arange(ksize, dtype=jnp.float32) - c
    k = jnp.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return k / jnp.sum(k)


def gaussian_filter_emit(ring: jnp.ndarray, n_path: jnp.ndarray,
                         emit_idx: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Emitted value of the reference gaussian smoother at ``emit_idx``.

    Padding replicates Stabilizer.cpp:1391-1401: reflect-101 on the left
    (path[-m] -> path[m]) and reflect-with-edge on the right
    (path[n-1+m] -> path[n-m]).
    """
    ksize = kernel.shape[0]
    c = ksize // 2
    offs = jnp.arange(ksize) - c
    idx = emit_idx + offs
    idx = jnp.where(idx < 0, -idx, idx)
    idx = jnp.where(idx > n_path - 1, 2 * n_path - 1 - idx, idx)
    idx = jnp.clip(idx, 0, None)
    vals = ring_get(ring, idx)  # (K, C)
    return jnp.sum(vals * kernel[:, None], axis=0)


def kalman_init(z0: jnp.ndarray) -> dict:
    """Per-axis 2-state KF state for C axes. z0: (C,) first path sample."""
    c = z0.shape[0]
    return {
        "x": jnp.stack([z0, jnp.zeros_like(z0)], axis=0),       # (2, C)
        "p": jnp.zeros((2, 2, c), z0.dtype),                     # (2, 2, C)
    }


def kalman_step(state: dict, z: jnp.ndarray,
                q: float = 0.01, r: float = 0.1) -> tuple[dict, jnp.ndarray]:
    """One predict+correct step; returns filtered positions (C,)."""
    x, p = state["x"], state["p"]
    # Predict: F = [[1,1],[0,1]].
    xp = jnp.stack([x[0] + x[1], x[1]], axis=0)
    p00 = p[0, 0] + p[1, 0] + p[0, 1] + p[1, 1] + q
    p01 = p[0, 1] + p[1, 1]
    p10 = p[1, 0] + p[1, 1]
    p11 = p[1, 1] + q
    # Update: H = [1, 0].
    s = p00 + r
    k0 = p00 / s
    k1 = p10 / s
    innov = z - xp[0]
    xn = jnp.stack([xp[0] + k0 * innov, xp[1] + k1 * innov], axis=0)
    pn00 = (1.0 - k0) * p00
    pn01 = (1.0 - k0) * p01
    pn10 = p10 - k1 * p00
    pn11 = p11 - k1 * p01
    pn = jnp.stack([jnp.stack([pn00, pn01]), jnp.stack([pn10, pn11])])
    return {"x": xn, "p": pn}, xn[0]


def jitter_frequency_cutoff(jitter_frequency: str) -> float:
    """mapJitterFrequencyToCutoff (Stabilizer.cpp:2589-2602): the
    jitter_frequency param's normalized butterworth cutoff. Shared by the
    streaming emission (core/stabilizer.py) and the offline whole-path
    smoother (offline.py) so the two can't drift."""
    return {"low": 0.05, "medium": 0.1, "high": 0.25,
            "adaptive": 0.15}.get(jitter_frequency, 0.1)


def butterworth_cascade(state: jnp.ndarray, z: jnp.ndarray,
                        cutoff: float, order: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Incremental form of the reference butterworthFilter (2014-2041):
    ``order`` chained first-order IIRs y = a*x + (1-a)*y_prev.

    state: (order, C) previous outputs per cascade stage; z: (C,) new sample.
    """
    alpha = cutoff / (cutoff + 1.0)
    outs = []
    x = z
    for o in range(order):
        y = alpha * x + (1.0 - alpha) * state[o]
        outs.append(y)
        x = y
    new_state = jnp.stack(outs, axis=0)
    return new_state, x


def adaptive_radius(ring: jnp.ndarray, n_path: jnp.ndarray,
                    default_radius: int) -> jnp.ndarray:
    """calculateAdaptiveRadius (Stabilizer.cpp:1637-1673): variance of the last
    <=20 path samples, rotation variance scaled by 1000, radius =
    int(clamp(2*sqrt(var), 5, 25)); default when fewer than 10 samples."""
    window = 20
    offs = jnp.arange(window)
    start = jnp.maximum(0, n_path - window)
    idx = start + offs
    valid = idx <= n_path - 1
    vals = ring_get(ring, jnp.clip(idx, 0, None))  # (20, n_ch)
    w = valid.astype(ring.dtype)[:, None]
    count = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(vals * w, axis=0) / count
    var = jnp.sum(((vals - mean) ** 2) * w, axis=0) / count
    if ring.shape[1] == 9:
        # Log-homography path ring (row-major sl(3) flatten): translation
        # lives at [2]=l02 / [5]=l12 and rotation is the antisymmetric part
        # of the upper 2x2, (l01-l10)/2 — map those onto the reference's
        # (dx, dy, da) variance formula instead of the raw first three
        # channels (whose [2] is x-translation and would saturate the
        # 1000x rotation weighting).
        rot = (vals[:, 1] - vals[:, 3]) * 0.5
        rot_mean = jnp.sum(rot * w[:, 0]) / count
        rot_var = jnp.sum(((rot - rot_mean) ** 2) * w[:, 0]) / count
        total = jnp.sqrt(var[2] + var[5] + rot_var * 1000.0)
    else:
        total = jnp.sqrt(var[0] + var[1] + var[2] * 1000.0)
    rad = jnp.clip(total * 2.0, 5.0, 25.0).astype(jnp.int32)
    return jnp.where(n_path < 10, jnp.int32(default_radius), rad)
