"""Virtual canvas stabilization — rebuild of the reference's
applyVirtualCanvasStabilization chain (src/Stabilizer.cpp:2066-2443).

The reference keeps a deque of 30 recent frames + transforms
(temporalFrameBuffer_, Stabilizer.cpp:2153-2167), detects empty regions by
contouring the warped frame (2214-2279) and fills them per-pixel from
motion-compensated history with seamless blending (2350-2398) — all
data-dependent host loops.

Reformulation: the frame history collapses into a RUNNING CANVAS
accumulator (scale_factor larger than the frame). Each emitted frame is
warped into canvas space; covered pixels refresh the canvas, uncovered
pixels keep their (temporally filled) history. A blurred coverage mask
provides the seamless edge blend (edge_blend_radius). Output is the
center crop at frame size — same visible behavior (jitter-free borders
filled from history), O(1) memory instead of 30 frames, and every step a
static-shape jit op.
"""

from __future__ import annotations

import jax.numpy as jnp

from video_stab_tpu.ops.filters import gaussian_blur
from video_stab_tpu.ops.warp import (BORDER_CONSTANT, invert_affine,
                                     similarity_matrix, warp_affine_fast)

# A canvas pixel whose recency weight decayed below this no longer counts
# as history (the deque-eviction analog; see virtual_canvas_apply).
_HIST_EPS = 0.05


def coverage_analytic(m: jnp.ndarray, src_h: int, src_w: int,
                      out_h: int, out_w: int) -> jnp.ndarray:
    """Closed-form bilinear coverage of an affine warp: exactly
    ``warp_affine(ones((src_h, src_w)), m)`` with a constant-0 border.

    Warping all-ones separates: out(x,y) = fx(sx) * fy(sy), where f is
    the tent ramp of in-bounds bilinear tap weight (1 in the interior,
    linear falloff over the one-pixel boundary band). Replaces a real
    1-channel warp on the canvas hot path with two fmas + mins per
    pixel. Identical to a real warp of all-ones (exactness test in
    tests/test_core.py)."""
    minv = invert_affine(m)
    ys = jnp.arange(out_h, dtype=jnp.float32)[:, None]
    xs = jnp.arange(out_w, dtype=jnp.float32)[None, :]
    sx = minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]
    sy = minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]
    fx = jnp.clip(jnp.minimum(sx + 1.0, float(src_w) - sx), 0.0, 1.0)
    fy = jnp.clip(jnp.minimum(sy + 1.0, float(src_h) - sy), 0.0, 1.0)
    return fx * fy


def canvas_shape(params, height: int, width: int) -> tuple[int, int]:
    """Static allocation size. With adaptive_canvas_size the allocation
    covers the LARGEST admissible scale (max_canvas_scale,
    Stabilizer.cpp:2305 clamp) and the runtime-chosen active scale masks a
    central window of it — static shapes under jit."""
    s = params.canvas_scale_factor
    if getattr(params, "adaptive_canvas_size", False):
        s = max(s, params.max_canvas_scale)
    return int(round(height * s)), int(round(width * s))


def adaptive_canvas_scale(params, trans_ring: jnp.ndarray,
                          n_path: jnp.ndarray,
                          prev_scale: jnp.ndarray) -> jnp.ndarray:
    """Active canvas scale — calculateOptimalCanvasSize
    (Stabilizer.cpp:2281-2306): max translation magnitude over the last
    <=30 transforms, mapped to scale = csf + (max(1, maxMotion/50) - 1)*0.5,
    clamped to [min_canvas_scale, max_canvas_scale]. Like the reference
    (which only re-computes when the canvas is re-created, 2071-2077) the
    scale FREEZES after the first canvas use: prev_scale > 0 keeps it."""
    if not getattr(params, "adaptive_canvas_size", False):
        return jnp.float32(params.canvas_scale_factor)
    window = 30
    offs = jnp.arange(window)
    start = jnp.maximum(0, n_path - window)
    idx = start + offs
    valid = (idx <= n_path - 1).astype(jnp.float32)
    ring = trans_ring.shape[0]
    vals = trans_ring[jnp.clip(idx, 0, None) % ring]          # (30, C)
    mag = jnp.sqrt(vals[:, 0] ** 2 + vals[:, 1] ** 2) * valid
    max_motion = jnp.max(mag)
    factor = jnp.maximum(1.0, max_motion / 50.0)
    scale = params.canvas_scale_factor + (factor - 1.0) * 0.5
    scale = jnp.clip(scale, params.min_canvas_scale,
                     params.max_canvas_scale)
    return jnp.where(prev_scale > 0.0, prev_scale,
                     scale).astype(jnp.float32)


def canvas_init_value(params, height: int, width: int):
    hc, wc = canvas_shape(params, height, width)
    return (jnp.zeros((hc, wc, 3), jnp.float32),
            jnp.zeros((hc, wc), jnp.float32))


def virtual_canvas_apply(params, canvas: jnp.ndarray, weight: jnp.ndarray,
                         frame_f32: jnp.ndarray, correction: jnp.ndarray,
                         active_scale=None,
                         ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One canvas update + composite.

    frame_f32: (H, W, 3); correction: (3,) stabilizing (dx, dy, da).
    active_scale: optional traced scalar — the adaptive canvas scale
    (adaptive_canvas_scale); history outside the central
    (H*scale, W*scale) window is masked off, reproducing the reference's
    smaller-canvas semantics on the statically-allocated array.
    Returns (new_canvas, new_weight, out_frame (H, W, 3)).
    """
    h, w = frame_f32.shape[:2]
    hc, wc = canvas.shape[:2]
    oy = (hc - h) / 2.0
    ox = (wc - w) / 2.0

    m = similarity_matrix(correction[0] + ox, correction[1] + oy,
                          correction[2])
    # The content warp is the u8 gather warp straight into canvas space
    # (the queued frame holds integer u8 values, and the reference warps
    # CV_8U mats too): exact for any correction, so every pixel the
    # coverage marks holds content. The coverage "warp" of all-ones is the
    # closed-form tent product.
    warped = warp_affine_fast(frame_f32, m, out_h=hc, out_w=wc,
                              border_mode=BORDER_CONSTANT)
    coverage = coverage_analytic(m, h, w, hc, wc)

    # Canvas refresh: covered pixels adopt the new frame (weighted by
    # canvas_blend_weight against history for temporal smoothness); empty
    # pixels keep history (the "temporal fill"). The weight doubles as a
    # RECENCY track: it decays so that an un-refreshed pixel falls below
    # the history threshold after ~temporal_buffer_size frames — the
    # running-canvas analog of the reference's 30-frame history deque
    # eviction (temporalFrameBuffer_, Stabilizer.cpp:2153-2167).
    bw = params.canvas_blend_weight
    tbs = max(1, int(getattr(params, "temporal_buffer_size", 30)))
    decay = _HIST_EPS ** (1.0 / tbs)
    has_hist = weight > _HIST_EPS
    cov3 = coverage[:, :, None]
    refreshed = jnp.where(
        has_hist[:, :, None],
        bw * warped + (1.0 - bw) * canvas,
        warped)
    new_canvas = cov3 * refreshed + (1.0 - cov3) * canvas
    new_weight = jnp.maximum(weight * decay, coverage)

    if active_scale is not None:
        # Adaptive active window: history may not live outside the central
        # (h*scale, w*scale) rect — the statically-allocated canvas
        # behaves exactly like the smaller one the reference would have
        # created (content reaching past it is dropped, not banked).
        # Compare PIXEL CENTERS (+0.5) against the window half-extents:
        # corner coordinates against the rounded allocation (hc = round
        # (h*s) can exceed h*s) would permanently zero one border
        # row/column asymmetrically; with centers the mask is an exact
        # no-op at active_scale == allocation scale.
        ys = jnp.arange(hc, dtype=jnp.float32)[:, None] + 0.5
        xs = jnp.arange(wc, dtype=jnp.float32)[None, :] + 0.5
        half_h = active_scale * h / 2.0
        half_w = active_scale * w / 2.0
        act = ((jnp.abs(ys - hc / 2.0) <= half_h)
               & (jnp.abs(xs - wc / 2.0) <= half_w))
        new_weight = jnp.where(act, new_weight, 0.0)
        new_canvas = jnp.where(act[:, :, None], new_canvas, 0.0)

    # Seamless composite for the OUTPUT: blurred coverage as the blend alpha
    # (the reference's edge-radius blend, Stabilizer.cpp:2350-2398).
    sigma = max(params.edge_blend_radius / 3.0, 0.5)
    alpha = jnp.clip(gaussian_blur(coverage, sigma), 0.0, 1.0)
    hist_valid = (weight > _HIST_EPS).astype(jnp.float32)
    # Where history exists, blend; where it doesn't, show the frame as-is.
    a = alpha + (1.0 - alpha) * (1.0 - hist_valid)
    composite = a[:, :, None] * warped + \
        (1.0 - a)[:, :, None] * canvas

    y0 = int(round(oy))
    x0 = int(round(ox))
    out = composite[y0:y0 + h, x0:x0 + w]
    return new_canvas, new_weight, out
