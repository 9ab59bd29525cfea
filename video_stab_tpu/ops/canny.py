"""Canny edge detection.

Counterpart of cv::cuda::createCannyEdgeDetector
(reference: src/RollCorrection.cpp:54-61 — thresholds 50/150, aperture 3,
L1 gradient). Non-max suppression uses the 4-way quantized gradient
direction; hysteresis is a bounded fixpoint of dilate(strong) & weak,
keeping every shape static for jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from video_stab_tpu.ops.filters import sobel


def _shift(x: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    out = jnp.roll(x, (-dy, -dx), axis=(0, 1))
    h, w = x.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    valid = (ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
    return jnp.where(valid, out, 0.0)


@functools.partial(jax.jit, static_argnames=("hysteresis_iters", "l2_gradient"))
def canny_edges(gray: jnp.ndarray, threshold_low: float = 50.0,
                threshold_high: float = 150.0, hysteresis_iters: int = 16,
                l2_gradient: bool = False) -> jnp.ndarray:
    """Binary edge map (0/255 float32) of a (H, W) u8-domain grayscale image.

    Stays in plain XLA deliberately: XLA fuses the ~20 small elementwise
    ops at roll-analysis size; a hand-written fused front (sobel+NMS+
    thresholds in one kernel) is worth writing only if a trace asks.
    """
    gx, gy = sobel(gray)
    if l2_gradient:
        mag = jnp.sqrt(gx * gx + gy * gy)
    else:
        mag = jnp.abs(gx) + jnp.abs(gy)

    # Quantize gradient direction into 4 sectors (0, 45, 90, 135 deg).
    ax, ay = jnp.abs(gx), jnp.abs(gy)
    tan225 = 0.4142135623730951   # tan(22.5 deg)
    tan675 = 2.414213562373095    # tan(67.5 deg)
    horiz = ay <= ax * tan225                       # compare along x
    vert = ay >= ax * tan675                        # compare along y
    diag = ~(horiz | vert)
    same_sign = (gx * gy) >= 0                      # 45 deg vs 135 deg

    m_l, m_r = _shift(mag, 0, -1), _shift(mag, 0, 1)
    m_u, m_d = _shift(mag, -1, 0), _shift(mag, 1, 0)
    m_ul, m_dr = _shift(mag, -1, -1), _shift(mag, 1, 1)
    m_ur, m_dl = _shift(mag, -1, 1), _shift(mag, 1, -1)

    n1 = jnp.where(horiz, m_l, jnp.where(vert, m_u,
         jnp.where(same_sign, m_ul, m_ur)))
    n2 = jnp.where(horiz, m_r, jnp.where(vert, m_d,
         jnp.where(same_sign, m_dr, m_dl)))
    del diag
    is_max = (mag >= n1) & (mag > n2)

    strong = is_max & (mag > threshold_high)
    weak = is_max & (mag > threshold_low)
    return _hysteresis(strong.astype(jnp.float32), weak.astype(jnp.float32),
                       hysteresis_iters, gray.dtype)


def _hysteresis(strong_f: jnp.ndarray, weak_f: jnp.ndarray,
                hysteresis_iters: int, out_dtype) -> jnp.ndarray:
    """Bounded fixpoint of dilate(strong) & weak over 0/1 f32 maps.

    Each pass is a 3x3 binary dilation masked by `weak`. One reduce_window
    max IS that dilation (values are {0,1}; 'SAME' padding contributes the
    0.0 init, matching zero-masked shifts) — 1 op per pass instead of 8
    roll+mask chains.
    """
    def grow(_, s):
        grown = jax.lax.reduce_window(s, 0.0, jax.lax.max, (3, 3), (1, 1),
                                      "SAME")
        return grown * weak_f

    edges = jax.lax.fori_loop(0, hysteresis_iters, grow, strong_f)
    return jnp.where(edges > 0, 255.0, 0.0).astype(out_dtype)
