"""Auto zoom-crop — rebuild of vs::AutoZoomCrop
(src/AutoZoomCrop.cpp, include/video/AutoZoomCrop.h:15).

Removes the black corners a roll rotation introduces: build a content mask
(threshold + morphological close, AutoZoomCrop.cpp:120-139), find the largest
interior rectangle via the reference's iterative border-shrink
(checkInteriorExterior, AutoZoomCrop.cpp:10-80, 189-204), re-center to the
original aspect ratio (206-220), then crop + resize in ONE warp_affine with a
dynamic crop rect but static output shape (the static-shape replacement for
the reference's CPU findContours + GPU crop + warp resize, 141-282).

The reference selects the largest contour before the shrink loop; after the
morphological close the content region of a rotated frame is a single
component, so the shrink runs directly on the content mask here (documented
deviation — avoids data-dependent connected components on the device).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from video_stab_tpu.core.params import AutoZoomCropParams
from video_stab_tpu.ops.color import bgr_to_gray, saturate_u8
from video_stab_tpu.ops.filters import morph_close, threshold_binary
from video_stab_tpu.ops.resize import resample_axis_aligned


def interior_rect(mask: jnp.ndarray, max_iters: Optional[int] = None,
                  ) -> jnp.ndarray:
    """Largest interior rectangle of a binary content mask by iterative
    border shrinking (AutoZoomCrop.cpp:189-204 semantics).

    mask: (H, W) float (0 / >0). Returns (4,) int32 [x0, y0, x1, y1]
    (inclusive corners).
    """
    h, w = mask.shape
    content = mask > 0
    any_row = jnp.any(content, axis=1)
    any_col = jnp.any(content, axis=0)
    ys = jnp.arange(h)
    xs = jnp.arange(w)
    y0 = jnp.min(jnp.where(any_row, ys, h)).astype(jnp.int32)
    y1 = jnp.max(jnp.where(any_row, ys, -1)).astype(jnp.int32)
    x0 = jnp.min(jnp.where(any_col, xs, w)).astype(jnp.int32)
    x1 = jnp.max(jnp.where(any_col, xs, -1)).astype(jnp.int32)
    holes = (~content).astype(jnp.float32)

    if max_iters is None:
        max_iters = h + w

    def count_edge_holes(rect):
        rx0, ry0, rx1, ry1 = rect[0], rect[1], rect[2], rect[3]
        in_x = ((xs >= rx0) & (xs <= rx1)).astype(jnp.float32)
        in_y = ((ys >= ry0) & (ys <= ry1)).astype(jnp.float32)
        c_top = jnp.sum(holes[ry0] * in_x)
        c_bottom = jnp.sum(holes[ry1] * in_x)
        c_left = jnp.sum(holes[:, rx0] * in_y)
        c_right = jnp.sum(holes[:, rx1] * in_y)
        return c_top, c_bottom, c_left, c_right

    def cond(carry):
        rect, it = carry
        ct, cb, cl, cr = count_edge_holes(rect)
        unfinished = (ct + cb + cl + cr) > 0
        valid = (rect[0] < rect[2]) & (rect[1] < rect[3])
        return unfinished & valid & (it < max_iters)

    def body(carry):
        rect, it = carry
        ct, cb, cl, cr = count_edge_holes(rect)
        # Border-shrink decision tree (checkInteriorExterior, 56-77).
        top = (ct > cb) & (ct > cl) & (ct > cr)
        bottom = (~(ct > cb)) & (cb > cl) & (cb > cr)
        left = (cl >= cr) & (cl >= cb) & (cl >= ct)
        right = (~(cl >= cr)) & (cr >= ct) & (cr >= cb)
        # Guarantee progress even when the counts tie everywhere.
        none = ~(top | bottom | left | right)
        shrink_any = none & ((ct + cb + cl + cr) > 0)
        new_rect = jnp.stack([
            rect[0] + (left | (shrink_any & (cl > 0))).astype(jnp.int32),
            rect[1] + (top | (shrink_any & (ct > 0))).astype(jnp.int32),
            rect[2] - (right | (shrink_any & (cr > 0))).astype(jnp.int32),
            rect[3] - (bottom | (shrink_any & (cb > 0))).astype(jnp.int32),
        ])
        return new_rect, it + 1

    rect0 = jnp.stack([x0, y0, x1, y1])
    rect, _ = jax.lax.while_loop(cond, body, (rect0, jnp.int32(0)))
    return rect


def auto_zoom_crop_f32(params: AutoZoomCropParams, frame: jnp.ndarray,
                       keep_input_size: Optional[bool] = None) -> jnp.ndarray:
    """Auto-zoom-crop of one f32 frame (AutoZoomCrop.cpp:102-283) — the
    composable pure function (used by the fused chain, core/chain.py, where
    the frame is already f32 on-chip and the output size must stay static)."""
    h, w = frame.shape[:2]
    if keep_input_size is None:
        keep_input_size = params.keep_input_size
    gray = bgr_to_gray(frame)
    content = threshold_binary(gray, params.content_threshold, 255.0)
    content = morph_close(content, params.morph_kernel)

    rect = interior_rect(content)
    x0 = rect[0].astype(jnp.float32)
    y0 = rect[1].astype(jnp.float32)
    rw = jnp.maximum((rect[2] - rect[0]).astype(jnp.float32), 1.0)
    rh = jnp.maximum((rect[3] - rect[1]).astype(jnp.float32), 1.0)

    # Re-center to the original aspect ratio (AutoZoomCrop.cpp:206-220).
    ar = w / h
    new_w = rh * ar
    cx = x0 + rw * 0.5
    nx0 = cx - new_w * 0.5
    nx0 = jnp.clip(nx0, 0.0, jnp.maximum(w - new_w, 0.0))
    new_w = jnp.minimum(new_w, jnp.float32(w))

    out_h = h if keep_input_size else params.out_height
    out_w = w if keep_input_size else params.out_width

    # Crop + resize fused as one inverse-map axis-aligned sample: output
    # pixel (x, y) reads source (nx0 + x*new_w/out_w, y0 + y*rh/out_h).
    # The rect is data-dependent (traced), so the sample runs as two
    # on-device interpolation-matrix matmuls (ops/resize.py
    # resample_axis_aligned) — matmuls instead of a 2-D gather.
    sx = new_w / out_w
    sy = rh / out_h
    out = resample_axis_aligned(frame, y0, sy, nx0, sx, out_h, out_w)

    # No-content fallback: pass the frame through resized (the reference
    # returns the original, AutoZoomCrop.cpp:149-152).
    has_content = jnp.any(content > 0)
    fallback = resample_axis_aligned(
        frame, jnp.float32(0.0), jnp.float32(h / out_h),
        jnp.float32(0.0), jnp.float32(w / out_w), out_h, out_w)
    out = jnp.where(has_content, out, fallback)
    return out


@functools.partial(jax.jit, static_argnums=0)
def auto_zoom_crop_step(params: AutoZoomCropParams, frame_u8: jnp.ndarray,
                        ) -> jnp.ndarray:
    """Full auto-zoom-crop of one u8 frame (AutoZoomCrop.cpp:102-283)."""
    return saturate_u8(auto_zoom_crop_f32(params, frame_u8.astype(jnp.float32)))


class AutoZoomCrop:
    """vs::AutoZoomCrop equivalent (static call surface, AutoZoomCrop.h:15)."""

    def __init__(self, params: Optional[AutoZoomCropParams] = None, **kw):
        if params is None:
            params = AutoZoomCropParams(**kw)
        elif kw:
            raise ValueError("pass either params or keyword overrides")
        self.params = params

    def auto_zoom_crop(self, frame) -> np.ndarray:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        return np.asarray(auto_zoom_crop_step(self.params, frame))

    @staticmethod
    def apply(frame, params: Optional[AutoZoomCropParams] = None) -> np.ndarray:
        params = params or AutoZoomCropParams()
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        return np.asarray(auto_zoom_crop_step(params, frame))
